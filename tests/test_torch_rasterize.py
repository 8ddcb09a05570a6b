"""The port's tile rasterizer against the JAX package's, on meshes made from
a numpy seed.

Tolerances: ``pix_to_face`` equal on the JAX tests' meshes and on >= 99.9%
of the pixels of random ones (a pixel on a shared edge may round to the
other face); barycentrics and depth within 1e-5 where the ids agree; the
overflow count equal.  The differentiable shading's values and gradients
(``recompute_barycentrics``, ``interpolate_attributes``) within 1e-5 of
``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.ops import rasterize as jr
from speech2lip_tpu_torch.ops import rasterize as tr

torch.set_num_threads(2)


def _random_mesh(seed, h, w, n_verts, n_faces):
    rng = np.random.default_rng(seed)
    verts = np.stack([rng.uniform(0, w, n_verts), rng.uniform(0, h, n_verts),
                      rng.uniform(0.5, 3.0, n_verts)], -1).astype(np.float32)
    return verts, rng.integers(0, n_verts, (n_faces, 3)).astype(np.int32)


def _both(verts, tris, h, w, **kw):
    fj = jr.rasterize(jnp.asarray(verts), jnp.asarray(tris), h, w, **kw)
    kw.pop("chunk", None)
    ft = tr.rasterize(torch.from_numpy(verts), torch.from_numpy(tris), h, w,
                      chunk=7, **kw)
    return fj, ft


def _agree(fj, ft, min_share):
    pj, pt = np.asarray(fj.pix_to_face), ft.pix_to_face.numpy()
    same = pj == pt
    assert same.mean() >= min_share, same.mean()
    np.testing.assert_allclose(ft.bary.numpy()[same],
                               np.asarray(fj.bary)[same], atol=1e-5)
    zj, zt = np.asarray(fj.zbuf), ft.zbuf.numpy()
    assert (np.isinf(zj) == np.isinf(zt))[same].all()
    hit = same & np.isfinite(zj)
    np.testing.assert_allclose(zt[hit], zj[hit], atol=1e-5)
    assert int(ft.overflow) == int(fj.overflow)


def test_single_triangle_matches_jax():
    verts = np.float32([[2.0, 2.0, 1.0], [13.0, 2.0, 1.0], [2.0, 13.0, 1.0]])
    tris = np.int32([[0, 1, 2]])
    fj, ft = _both(verts, tris, 16, 16, tile=8, max_faces_per_tile=8,
                   chunk=2)
    _agree(fj, ft, 1.0)
    assert ft.pix_to_face[3, 3] == 0 and ft.pix_to_face[14, 14] == -1


@pytest.mark.parametrize("seed,h,w,tile,k", [(0, 32, 32, 8, 40),
                                             (1, 64, 48, 16, 128),
                                             (2, 50, 70, 16, 64)])
def test_random_meshes_match_jax(seed, h, w, tile, k):
    verts, tris = _random_mesh(seed, h, w, 60, 120)
    fj, ft = _both(verts, tris, h, w, tile=tile, max_faces_per_tile=k,
                   expand=4, chunk=4)
    _agree(fj, ft, 0.999)


def test_full_bins_drop_the_same_faces():
    """Bins past max_faces_per_tile: the stable sort keeps the same first K
    faces of each tile, so the overflow and the ids are the JAX package's."""
    verts, tris = _random_mesh(3, 64, 64, 80, 400)
    fj, ft = _both(verts, tris, 64, 64, tile=16, max_faces_per_tile=8,
                   chunk=4)
    assert int(fj.overflow) > 0
    _agree(fj, ft, 1.0)


def test_coincident_faces_overflow_and_ties():
    """Eight stacked triangles, K = 2 and K = 8 (the JAX test's mesh)."""
    verts, tris = [], []
    for i in range(8):
        z = 1.0 + 0.1 * i
        verts += [[2.0, 2.0, z], [6.0, 2.0, z], [2.0, 6.0, z]]
        tris.append([3 * i, 3 * i + 1, 3 * i + 2])
    verts, tris = np.float32(verts), np.int32(tris)
    for k, drops in ((2, 6), (8, 0)):
        fj, ft = _both(verts, tris, 8, 8, tile=8, max_faces_per_tile=k)
        assert int(ft.overflow) == drops
        _agree(fj, ft, 1.0)
    assert tr.check_raster_budget(verts, tris, 8, 8, tile=8,
                                  max_faces_per_tile=2) == 6


def test_batch_equals_frames():
    verts, tris = _random_mesh(4, 40, 40, 50, 90)
    batch = np.stack([verts, verts + np.float32([1.5, -2.0, 0.1])])
    fb = tr.rasterize(torch.from_numpy(batch), torch.from_numpy(tris), 40, 40,
                      max_faces_per_tile=16, chunk=3)
    for i in range(2):
        f1 = tr.rasterize(torch.from_numpy(batch[i]), torch.from_numpy(tris),
                          40, 40, max_faces_per_tile=16)
        assert torch.equal(fb.pix_to_face[i], f1.pix_to_face)
        assert torch.equal(fb.bary[i], f1.bary)
        assert int(fb.overflow[i]) == int(f1.overflow)


def test_shading_values_and_gradients_match_jax():
    rng = np.random.default_rng(5)
    verts, tris = _random_mesh(5, 32, 32, 40, 60)
    attrs = rng.standard_normal((40, 4)).astype(np.float32)
    fj, ft = _both(verts, tris, 32, 32, max_faces_per_tile=64, chunk=4)
    p2f = np.asarray(fj.pix_to_face)
    assert (p2f == ft.pix_to_face.numpy()).all()
    target = rng.standard_normal((32, 32, 4)).astype(np.float32)

    def jloss(v, a):
        bary = jr.recompute_barycentrics(jnp.asarray(p2f), v,
                                         jnp.asarray(tris))
        frag = jr.Fragments(jnp.asarray(p2f), bary, fj.zbuf)
        img = jr.interpolate_attributes(frag, jnp.asarray(tris), a)
        return jnp.sum((img - target) ** 2), img

    (lj, img_j), (gvj, gaj) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(verts),
                                             jnp.asarray(attrs))
    v = torch.from_numpy(verts).requires_grad_(True)
    a = torch.from_numpy(attrs).requires_grad_(True)
    bary = tr.recompute_barycentrics(ft.pix_to_face, v,
                                     torch.from_numpy(tris))
    img_t = tr.interpolate_attributes(
        tr.Fragments(ft.pix_to_face, bary, ft.zbuf), torch.from_numpy(tris),
        a)
    lt = torch.sum((img_t - torch.from_numpy(target)) ** 2)
    gvt, gat = torch.autograd.grad(lt, [v, a])
    np.testing.assert_allclose(img_t.detach().numpy(), np.asarray(img_j),
                               atol=1e-5)
    for got, want in ((gvt, gvj), (gat, gaj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-5)
