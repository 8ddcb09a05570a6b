"""Tile-binned triangle rasterizer (counterpart of
``speech2lip_tpu/ops/rasterize.py``), in PyTorch tensor ops.

The design is the JAX package's, kept so that the same faces win:
1. faces -> screen-space bounding boxes -> up to expand x expand covered
   tiles each;
2. (tile, face) pairs stably sorted by tile id;
3. per tile: barycentric inside-tests of at most ``max_faces_per_tile``
   faces against the tile's pixels, then the nearest z by a first-index
   argmin.  Faces past a full bin are dropped and counted (``overflow``);
4. gradients do not flow through rasterization: shading re-derives the
   barycentrics at the fixed pixel-to-face map (``recompute_barycentrics``)
   and blends vertex attributes there (``interpolate_attributes``).

Verts are in pixel coordinates (x right, y down) with z the camera depth
(nearest = smallest z > z_near); z interpolates linearly in screen space.
``rasterize`` takes one mesh [V, 3] or a batch [B, V, 3] of poses of the
same triangles; a batch runs its frames' tiles together, ``chunk`` tiles a
step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Fragments(NamedTuple):
    pix_to_face: torch.Tensor  # [(B,) H, W] int64, -1 = background
    bary: torch.Tensor         # [(B,) H, W, 3] float32
    zbuf: torch.Tensor         # [(B,) H, W] float32, +inf = background
    # (tile, face) pairs dropped because a tile's bin held more than
    # max_faces_per_tile faces: a 0-d int64 tensor, or [B] for a batch
    overflow: torch.Tensor = 0


def _edge(ax, ay, bx, by, px, py):
    return (px - ax) * (by - ay) - (py - ay) * (bx - ax)


@torch.no_grad()
def rasterize(verts: torch.Tensor, tris: torch.Tensor, height: int,
              width: int, tile: int = 16, max_faces_per_tile: int = 128,
              expand: int = 4, chunk: int = 512,
              z_near: float = 1e-4) -> Fragments:
    """Rasterize a triangle mesh to per-pixel face ids and barycentrics.

    Args:
      verts: [V, 3] or [B, V, 3] (x_px, y_px, z_cam).
      tris:  [F, 3] int vertex indices.
      tile: square tile edge in pixels (the image is padded up to whole
        tiles).
      max_faces_per_tile: faces tested per tile, K; a fuller bin drops the
        faces past its first K in the stable tile order, and counts them in
        ``overflow``.
      expand: tiles per axis a face's bounding box may cover (a bigger face
        is clamped).
      chunk: tiles (of all frames) rasterized per step, the memory dial:
        each step holds about ten [chunk, tile^2, K] float32 tensors.  The
        result does not depend on it.
    """
    batched = verts.dim() == 3
    v = (verts if batched else verts[None]).float()
    dev = v.device
    f = tris.to(dev).long()
    nb, n_faces = v.shape[0], f.shape[0]
    tiles_x = -(-width // tile)
    tiles_y = -(-height // tile)
    n_tiles = tiles_x * tiles_y
    k = max_faces_per_tile

    v0, v1, v2 = v[:, f[:, 0]], v[:, f[:, 1]], v[:, f[:, 2]]   # [B, F, 3]

    # face -> tile bins
    min_x = torch.minimum(torch.minimum(v0[..., 0], v1[..., 0]), v2[..., 0])
    max_x = torch.maximum(torch.maximum(v0[..., 0], v1[..., 0]), v2[..., 0])
    min_y = torch.minimum(torch.minimum(v0[..., 1], v1[..., 1]), v2[..., 1])
    max_y = torch.maximum(torch.maximum(v0[..., 1], v1[..., 1]), v2[..., 1])
    behind = ((v0[..., 2] <= z_near) | (v1[..., 2] <= z_near)
              | (v2[..., 2] <= z_near))
    offscreen = ((max_x < 0) | (min_x > width - 1) | (max_y < 0)
                 | (min_y > height - 1))
    dead = behind | offscreen

    def tile_of(c, n):
        return torch.clamp(torch.floor(c / tile), 0, n - 1).long()

    tx0, tx1 = tile_of(min_x, tiles_x), tile_of(max_x, tiles_x)
    ty0, ty1 = tile_of(min_y, tiles_y), tile_of(max_y, tiles_y)
    di = torch.arange(expand, device=dev)
    gx = tx0[..., None] + di                         # [B, F, E]
    gy = ty0[..., None] + di
    valid = ((gy <= ty1[..., None])[..., :, None]
             & (gx <= tx1[..., None])[..., None, :]
             & ~dead[..., None, None])               # [B, F, E, E]
    tile_ids = gy[..., :, None] * tiles_x + gx[..., None, :]
    tile_ids = torch.where(valid, tile_ids, n_tiles).reshape(nb, -1)

    # one stable sort per frame: within a tile the faces keep their order,
    # which fixes the faces a full bin drops and the winner of a z tie
    sorted_tiles, order = torch.sort(tile_ids, dim=1, stable=True)
    sorted_faces = order // (expand * expand)
    bins = torch.arange(n_tiles + 1, device=dev).expand(nb, -1).contiguous()
    edges = torch.searchsorted(sorted_tiles, bins)   # [B, n_tiles + 1]
    starts = edges[:, :-1]
    overflow = torch.clamp(edges[:, 1:] - starts - k, min=0).sum(1)
    # K sentinel entries (tile id n_tiles) past the end, so that every bin
    # reads a full window of K: the same faces as the JAX package's window,
    # whose start clamps at len - K
    sorted_tiles = torch.cat(
        [sorted_tiles, torch.full((nb, k), n_tiles, device=dev,
                                  dtype=sorted_tiles.dtype)], 1)
    sorted_faces = torch.cat(
        [sorted_faces, torch.zeros((nb, k), device=dev,
                                   dtype=sorted_faces.dtype)], 1)

    p = tile * tile
    base = torch.arange(tile, dtype=torch.float32, device=dev)
    pyy = base[:, None].expand(tile, tile).reshape(-1)      # [P]
    pxx = base[None, :].expand(tile, tile).reshape(-1)
    kk = torch.arange(k, device=dev)
    total = nb * n_tiles
    face_out = torch.empty((total, p), dtype=torch.long, device=dev)
    bary_out = torch.empty((total, p, 3), dtype=torch.float32, device=dev)
    z_out = torch.empty((total, p), dtype=torch.float32, device=dev)
    step = max(1, int(chunk))
    for s in range(0, total, step):
        ids = torch.arange(s, min(s + step, total), device=dev)
        b_idx, t_idx = ids // n_tiles, ids % n_tiles
        win = starts[b_idx, t_idx][:, None] + kk             # [C, K]
        faces_k = sorted_faces[b_idx[:, None], win]
        alive = sorted_tiles[b_idx[:, None], win] == t_idx[:, None]
        a = v0[b_idx[:, None], faces_k]                       # [C, K, 3]
        b = v1[b_idx[:, None], faces_k]
        c = v2[b_idx[:, None], faces_k]
        ty, tx = t_idx // tiles_x, t_idx % tiles_x
        px = (tx * tile).float()[:, None] + pxx               # [C, P]
        py = (ty * tile).float()[:, None] + pyy
        px, py = px[:, :, None], py[:, :, None]
        ax, ay, az = a[:, None, :, 0], a[:, None, :, 1], a[:, None, :, 2]
        bx, by, bz = b[:, None, :, 0], b[:, None, :, 1], b[:, None, :, 2]
        cx, cy, cz = c[:, None, :, 0], c[:, None, :, 1], c[:, None, :, 2]
        w0 = _edge(bx, by, cx, cy, px, py)                    # [C, P, K]
        w1 = _edge(cx, cy, ax, ay, px, py)
        w2 = _edge(ax, ay, bx, by, px, py)
        area = _edge(ax, ay, bx, by, cx, cy)                  # [C, 1, K]
        denom = torch.where(area.abs() < 1e-12, torch.ones_like(area), area)
        b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
        inside = ((b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (area.abs() > 1e-12)
                  & alive[:, None, :])
        z = b0 * az + b1 * bz + b2 * cz
        z = torch.where(inside & (z > z_near), z,
                        torch.full_like(z, float("inf")))
        best = torch.argmin(z, dim=2, keepdim=True)           # [C, P, 1]
        zbest = torch.gather(z, 2, best)[..., 0]
        hit = torch.isfinite(zbest)
        fid = torch.gather(faces_k, 1, best[..., 0])
        face_out[ids] = torch.where(hit, fid, torch.full_like(fid, -1))
        bary = torch.cat([torch.gather(t, 2, best) for t in (b0, b1, b2)], -1)
        bary_out[ids] = torch.where(hit[..., None], bary,
                                    torch.zeros_like(bary))
        z_out[ids] = zbest      # +inf where nothing was hit

    def image(t, *tail):
        t = t.reshape(nb, tiles_y, tiles_x, tile, tile, *tail)
        t = t.transpose(2, 3).reshape(nb, tiles_y * tile, tiles_x * tile,
                                      *tail)
        t = t[:, :height, :width]
        return t if batched else t[0]

    return Fragments(image(face_out), image(bary_out, 3), image(z_out),
                     overflow if batched else overflow[0])


def check_raster_budget(verts, tris, height: int, width: int,
                        **raster_kwargs) -> int:
    """Rasterize once and return the dropped-face count (0 = the budget
    holds).  A nonzero count means ``max_faces_per_tile`` is too small for
    the mesh's density: depths and visibility would be silently wrong."""
    frag = rasterize(torch.as_tensor(verts), torch.as_tensor(tris), height,
                     width, **raster_kwargs)
    return int(frag.overflow.sum())


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [V, C] at ``idx`` [...], or of each frame's
    ``table`` [B, V, C] at ``idx`` [B, ...] -> [..., C].  An
    ``index_select``, whose backward adds into the table by atomics; the
    backward of advanced indexing sorts the indices and serialises the
    repeats, which on the card costs ~40 ms a 4-frame chunk at 500^2."""
    c = table.shape[-1]
    if table.dim() == 2:
        return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, c)
    b, v = table.shape[:2]
    off = (torch.arange(b, device=idx.device) * v).reshape(
        b, *([1] * (idx.dim() - 1)))
    return table.reshape(b * v, c).index_select(
        0, (idx + off).reshape(-1)).reshape(*idx.shape, c)


def _corners(verts: torch.Tensor, fv: torch.Tensor):
    """The three corners of each pixel's face: verts [V, 3] or [B, V, 3],
    fv [(B,) H, W, 3] vertex ids -> three [(B,) H, W, 3] tensors."""
    return tuple(gather_rows(verts, fv[..., i]) for i in range(3))


def recompute_barycentrics(pix_to_face: torch.Tensor, verts: torch.Tensor,
                           tris: torch.Tensor) -> torch.Tensor:
    """Barycentrics [(B,) H, W, 3] of each pixel in its face of the fixed
    map ``pix_to_face``, re-derived from the current ``verts`` so that
    gradients reach the vertex positions."""
    h, w = pix_to_face.shape[-2:]
    face = torch.clamp(pix_to_face, min=0)
    a, b, c = _corners(verts, tris.to(face.device).long()[face])
    px = torch.arange(w, dtype=verts.dtype, device=verts.device)[None, :]
    py = torch.arange(h, dtype=verts.dtype, device=verts.device)[:, None]
    px, py = px.expand(h, w), py.expand(h, w)
    w0 = _edge(b[..., 0], b[..., 1], c[..., 0], c[..., 1], px, py)
    w1 = _edge(c[..., 0], c[..., 1], a[..., 0], a[..., 1], px, py)
    w2 = _edge(a[..., 0], a[..., 1], b[..., 0], b[..., 1], px, py)
    area = _edge(a[..., 0], a[..., 1], b[..., 0], b[..., 1], c[..., 0],
                 c[..., 1])
    denom = torch.where(area.abs() < 1e-12, torch.ones_like(area), area)
    return torch.stack([w0, w1, w2], -1) / denom[..., None]


def interpolate_attributes(frag: Fragments, tris: torch.Tensor,
                           vert_attrs: torch.Tensor,
                           background=0.0) -> torch.Tensor:
    """Per-pixel barycentric blend of vertex attributes [V, C] (or
    [B, V, C] for batched fragments) at the rasterized correspondences;
    ``background`` where no face was hit.  Gradients reach ``vert_attrs``."""
    face = torch.clamp(frag.pix_to_face, min=0)
    fv = tris.to(face.device).long()[face]              # [(B,) H, W, 3]
    attrs = torch.stack(_corners(vert_attrs, fv), -2)    # [..., 3, C]
    out = torch.sum(frag.bary[..., None] * attrs, dim=-2)
    hit = (frag.pix_to_face >= 0)[..., None]
    return torch.where(hit, out, torch.as_tensor(background, dtype=out.dtype,
                                                 device=out.device))
