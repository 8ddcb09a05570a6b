"""Basel Face Model (3DMM) linear blend and SH-lit rendering (counterpart of
``speech2lip_tpu/preprocess/face_3dmm.py``).

The 3DMM of the tracker: identity / expression / texture bases, the
pinhole with negated x (``proj_pts``), the 68 landmarks with their
pose-dependent jaw contour, vertex normals, 9-term spherical-harmonics
lighting, and the mesh renderer on the tile rasterizer
(``ops/rasterize``).

Assets: ``3DMM_info.npy`` / ``keys_info.npy`` / ``topology_info.npy``
(derived from the Basel Face Model, user-supplied); ``synthetic_assets``
builds a random model with the same schema, with numpy and scipy.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from speech2lip_tpu_torch.ops.geometry import euler2rot
from speech2lip_tpu_torch.ops.rasterize import (interpolate_attributes,
                                                rasterize)


class BFMAssets(NamedTuple):
    base_id: torch.Tensor    # [id_dim, 3V]
    base_exp: torch.Tensor   # [exp_dim, 3V]
    mu: torch.Tensor         # [3V] (mean-centred per axis, /1e5)
    base_tex: torch.Tensor   # [tex_dim, 3V]
    mu_tex: torch.Tensor     # [3V]
    sig_id: torch.Tensor     # [id_dim]
    sig_exp: torch.Tensor    # [exp_dim]
    sig_tex: torch.Tensor    # [tex_dim]
    keyinds: torch.Tensor        # [68] landmark vertex ids
    left_contour: torch.Tensor   # [8, C] candidate contour vertex ids
    right_contour: torch.Tensor  # [8, C]
    tris: torch.Tensor           # [F, 3]
    vert_tris: torch.Tensor      # [V, T] triangles adjacent to each vertex
    point_num: int


def assets_to(assets: BFMAssets, device) -> BFMAssets:
    """The assets' tensors on ``device``."""
    return BFMAssets(*[t.to(device) if isinstance(t, torch.Tensor) else t
                       for t in assets])


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _i64(x, device):
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


def load_assets(modelpath: str, id_dim: int = 100, exp_dim: int = 79,
                tex_dim: int = 100, device="cpu") -> BFMAssets:
    """The reference's three asset files, as the JAX package reads them."""
    info = np.load(os.path.join(modelpath, "3DMM_info.npy"),
                   allow_pickle=True).item()
    mu = (info["mu_shape"] + info["mu_exp"]).reshape(-1, 3)
    mu = mu - mu.mean(axis=0, keepdims=True)
    keys = np.load(os.path.join(modelpath, "keys_info.npy"),
                   allow_pickle=True).item()
    topo = np.load(os.path.join(modelpath, "topology_info.npy"),
                   allow_pickle=True).item()
    return BFMAssets(
        base_id=_f32(info["b_shape"][:id_dim] / 1e5, device),
        base_exp=_f32(info["b_exp"][:exp_dim] / 1e5, device),
        mu=_f32(mu.reshape(-1) / 1e5, device),
        base_tex=_f32(info["b_tex"][:tex_dim], device),
        mu_tex=_f32(info["mu_tex"], device),
        sig_id=_f32(info["sig_shape"][:id_dim], device),
        sig_exp=_f32(info["sig_exp"][:exp_dim], device),
        sig_tex=_f32(info["sig_tex"][:tex_dim], device),
        keyinds=_i64(keys["keyinds"], device),
        left_contour=_i64(keys["left_contour"], device),
        right_contour=_i64(keys["right_contour"], device),
        tris=_i64(topo["tris"], device),
        vert_tris=_i64(topo["vert_tris"], device),
        point_num=mu.shape[0])


def synthetic_assets(n_verts: int = 400, id_dim: int = 10, exp_dim: int = 7,
                     tex_dim: int = 10, seed: int = 0,
                     device="cpu") -> BFMAssets:
    """Random BFM-schema assets: the convex hull of points on the unit
    sphere.  The same seed gives the JAX package's arrays."""
    from scipy.spatial import ConvexHull

    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n_verts, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    tris = ConvexHull(pts).simplices.astype(np.int32)
    # per-vertex adjacency, each row padded to the widest by repetition
    adj = [[] for _ in range(n_verts)]
    for t, (a, b, c) in enumerate(tris):
        adj[a].append(t)
        adj[b].append(t)
        adj[c].append(t)
    width = max(1, max(len(a) for a in adj))
    vert_tris = np.zeros((n_verts, width), np.int32)
    for i, a in enumerate(adj):
        a = a or [0]
        vert_tris[i] = (a * width)[:width]
    n3 = n_verts * 3
    return BFMAssets(
        base_id=_f32(rng.standard_normal((id_dim, n3)) * 0.01, device),
        base_exp=_f32(rng.standard_normal((exp_dim, n3)) * 0.01, device),
        mu=_f32(pts.reshape(-1), device),
        base_tex=_f32(rng.standard_normal((tex_dim, n3)) * 5, device),
        mu_tex=_f32(np.full(n3, 128.0), device),
        sig_id=_f32(np.ones(id_dim), device),
        sig_exp=_f32(np.ones(exp_dim), device),
        sig_tex=_f32(np.ones(tex_dim), device),
        keyinds=_i64(rng.choice(n_verts, 68, replace=False), device),
        left_contour=_i64(rng.choice(n_verts, (8, 5), replace=True), device),
        right_contour=_i64(rng.choice(n_verts, (8, 5), replace=True),
                           device),
        tris=_i64(tris, device), vert_tris=_i64(vert_tris, device),
        point_num=n_verts)


def save_reference_schema(assets: BFMAssets, out_dir: str):
    """Write the assets as the reference's three ``.npy`` files (the
    schema ``load_assets`` reads), with ``rigid_ids`` the first 20
    landmark vertices."""
    os.makedirs(out_dir, exist_ok=True)
    a = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in assets._asdict().items()}
    np.save(os.path.join(out_dir, "3DMM_info.npy"), {
        "b_shape": a["base_id"] * 1e5, "b_exp": a["base_exp"] * 1e5,
        "mu_shape": a["mu"] * 1e5,
        "mu_exp": np.zeros(a["point_num"] * 3, np.float32),
        "b_tex": a["base_tex"], "mu_tex": a["mu_tex"],
        "sig_shape": a["sig_id"], "sig_exp": a["sig_exp"],
        "sig_tex": a["sig_tex"]}, allow_pickle=True)
    np.save(os.path.join(out_dir, "keys_info.npy"), {
        "keyinds": a["keyinds"].astype(np.int32),
        "left_contour": a["left_contour"].astype(np.int32),
        "right_contour": a["right_contour"].astype(np.int32),
        "rigid_ids": a["keyinds"][:20].astype(np.int32)}, allow_pickle=True)
    np.save(os.path.join(out_dir, "topology_info.npy"), {
        "tris": a["tris"].astype(np.int32),
        "vert_tris": a["vert_tris"].astype(np.int32)}, allow_pickle=True)


# -- linear blend and projection ---------------------------------------------

def forward_geo(assets: BFMAssets, id_para, exp_para):
    """[B, id] x [B, exp] -> [B, V, 3] geometry."""
    geo = ((id_para * assets.sig_id) @ assets.base_id
           + (exp_para * assets.sig_exp) @ assets.base_exp + assets.mu)
    return geo.reshape(id_para.shape[0], assets.point_num, 3)


def forward_tex(assets: BFMAssets, tex_para):
    tex = (tex_para * assets.sig_tex) @ assets.base_tex + assets.mu_tex
    return tex.reshape(tex_para.shape[0], assets.point_num, 3)


def rot_trans_pts(geometry, rot, trans):
    """[B, V, 3], [B, 3, 3], [B, 3] -> camera-space points."""
    return torch.einsum("bij,bvj->bvi", rot, geometry) + trans[:, None, :]


def proj_pts(rott_geo, focal: float, cxy):
    """Pinhole with negated x: (-f X/Z + cx, f Y/Z + cy, Z)."""
    x, y, z = rott_geo[..., 0], rott_geo[..., 1], rott_geo[..., 2]
    px = -focal * x / z + cxy[0]
    py = focal * y / z + cxy[1]
    return torch.stack([px, py, z], dim=-1)


def forward_transform(geometry, euler, trans, focal: float, cxy):
    return proj_pts(rot_trans_pts(geometry, euler2rot(euler), trans), focal,
                    cxy)


def forward_geo_sub(assets: BFMAssets, id_para, exp_para, vert_ids):
    """Geometry restricted to the vertices ``vert_ids``."""
    sel = (3 * vert_ids[:, None]
           + torch.arange(3, device=vert_ids.device)[None, :]).reshape(-1)
    geo = ((id_para * assets.sig_id) @ assets.base_id[:, sel]
           + (exp_para * assets.sig_exp) @ assets.base_exp[:, sel]
           + assets.mu[sel])
    return geo.reshape(id_para.shape[0], vert_ids.shape[0], 3)


def get_3dlandmarks(assets: BFMAssets, id_para, exp_para, euler, trans,
                    focal: float, cxy):
    """68 3-D landmarks; jaw-contour points 0-7 and 9-16 pick, per pose,
    the candidate vertex with the least (left) or greatest (right)
    projected x."""
    b = id_para.shape[0]
    lands = forward_geo_sub(assets, id_para, exp_para, assets.keyinds)

    def contour(cands, take_min):
        geo = forward_geo_sub(assets, id_para, exp_para, cands.reshape(-1))
        proj_x = forward_transform(geo, euler, trans, focal, cxy)[..., 0]
        proj_x = proj_x.reshape(b, 8, -1)
        pick = (torch.argmin(proj_x, dim=2) if take_min
                else torch.argmax(proj_x, dim=2))          # [B, 8]
        geo = geo.reshape(b, 8, -1, 3)
        return torch.take_along_dim(
            geo, pick[:, :, None, None], dim=2)[:, :, 0, :]

    left = contour(assets.left_contour, take_min=True)
    right = contour(assets.right_contour, take_min=False)
    return torch.cat([left, lands[:, 8:9], right, lands[:, 17:]], dim=1)


# -- normals and SH lighting ---------------------------------------------------

def vertex_normals(geometry, tris, vert_tris):
    """[B, V, 3] -> per-vertex normals, the sum of the adjacent faces'."""
    # index_select, whose backward adds by atomics (see
    # ops/rasterize.gather_rows)
    v0, v1, v2 = (geometry.index_select(1, tris[:, i]) for i in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    fn = fn / torch.clamp_min(torch.linalg.norm(fn, dim=-1, keepdim=True),
                              1e-12)
    vn = fn.index_select(1, vert_tris.reshape(-1)).reshape(
        fn.shape[0], *vert_tris.shape, 3).sum(dim=2)
    return vn / torch.clamp_min(torch.linalg.norm(vn, dim=-1, keepdim=True),
                                1e-12)


def sh_illumination(texture, normals, gamma):
    """9-term SH lighting.  texture, normals: [B, V, 3]; gamma: [B, 27]."""
    b = texture.shape[0]
    g = gamma.reshape(b, 3, 9)
    g = torch.cat([g[:, :, :1] + 0.8, g[:, :, 1:]], dim=2)
    g = g.transpose(1, 2)                                   # [B, 9, 3]

    a0 = np.pi
    a1 = float(2 * np.pi / np.sqrt(3.0))
    a2 = float(2 * np.pi / np.sqrt(8.0))
    c0 = float(1 / np.sqrt(4 * np.pi))
    c1 = float(np.sqrt(3.0) / np.sqrt(4 * np.pi))
    c2 = float(3 * np.sqrt(5.0) / np.sqrt(12 * np.pi))
    d0 = float(0.5 / np.sqrt(3.0))

    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    h = torch.stack([
        torch.full_like(nx, float(np.float32(a0 * c0))),
        -a1 * c1 * ny,
        a1 * c1 * nz,
        -a1 * c1 * nx,
        a2 * c2 * nx * ny,
        -a2 * c2 * ny * nz,
        a2 * c2 * d0 * (3 * nz ** 2 - 1),
        -a2 * c2 * nx * nz,
        a2 * c2 * 0.5 * (nx ** 2 - ny ** 2),
    ], dim=-1)                                              # [B, V, 9]
    lighting = torch.einsum("bvn,bnc->bvc", h, g)
    return texture * lighting


def camera_pixels(rott_geometry, focal: float, height: int, width: int):
    """Posed points -> rasterizer input (x_px, y_px, depth): the BFM camera
    looks down -z, so the depth is -Z."""
    pix = proj_pts(rott_geometry, focal, (width / 2.0, height / 2.0))
    return pix * torch.tensor([1.0, 1.0, -1.0], dtype=pix.dtype,
                              device=pix.device)


def render_mesh(assets: BFMAssets, rott_geometry, texture, gamma,
                focal: float, height: int, width: int, **raster_kwargs):
    """SH-lit hard render of the posed meshes [B, V, 3]: returns images
    [B, H, W, 3] in [0, 255] and the batched fragments.  Differentiable in
    texture, lighting and (through the shading values) geometry at fixed
    rasterized correspondences."""
    normals = vertex_normals(rott_geometry, assets.tris, assets.vert_tris)
    colors = sh_illumination(texture, normals, gamma)
    pix = camera_pixels(rott_geometry, focal, height, width)
    frag = rasterize(pix, assets.tris, height, width, **raster_kwargs)
    img = interpolate_attributes(frag, assets.tris, colors)
    return torch.clamp(img, 0.0, 255.0), frag
