"""The training slice's ops (speech2lip_tpu_torch.ops: coords, nn,
grid_sample, geometry) against the JAX package's, one function at a time.

Same inputs, made from a seed with numpy, go through both packages on the
CPU in float32; gradients go through torch autograd and ``jax.grad`` with
the same cotangent.  Errors are max|diff| relative to max|reference|;
tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.ops import coords as jcoords
from speech2lip_tpu.ops import geometry as jgeo
from speech2lip_tpu.ops import grid_sample as jgs
from speech2lip_tpu.ops import nn as jnn
from speech2lip_tpu_torch.ops import coords as tcoords
from speech2lip_tpu_torch.ops import geometry as tgeo
from speech2lip_tpu_torch.ops import grid_sample as tgs
from speech2lip_tpu_torch.ops import nn as tnn

torch.set_num_threads(2)

# float32, same formulas; only the order of sums (and, in the geometry,
# of 4x4 inverses and products) differs
TOL = 1e-5
GRAD_TOL = 1e-4


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x, np.float32))
    return t.requires_grad_(True) if grad else t


def _rel(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    return float(np.max(np.abs(got - ref))) / max(1e-6,
                                                  float(np.max(np.abs(ref))))


def _grads(jfn, tfn, args, cot):
    """(torch grads, jax grads) of sum(fn(*args) * cot) for every arg."""
    targs = [_t(a, grad=True) for a in args]
    (tfn(*targs) * _t(cot)).sum().backward()
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * cot),
                  argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    return [a.grad for a in targs], jg


def test_ensemble_coords_matches_jax():
    rng = np.random.default_rng(0)
    w, h = 24, 16
    coords = rng.uniform(0, 1, (w * h, 2)).astype(np.float32)
    coords[:3] = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0]]  # clamped corners
    eps = rng.uniform(0, 0.25 / h, 3).astype(np.float32)
    js, jw = jax.vmap(lambda e: jcoords.ensemble_coords(
        jnp.asarray(coords), w, h, e))(jnp.asarray(eps))
    ts, tw = tcoords.ensemble_coords(_t(coords), w, h, _t(eps))
    assert _rel(ts, js) < TOL
    assert _rel(tw, jw) < TOL


def test_batchnorm_train_matches_jax():
    """Batch statistics (biased variance), running update with the
    unbiased variance at momentum 0.1, and the gradients through both."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 6, 4)) * 2 + 0.5).astype(np.float32)
    params = {"scale": rng.uniform(0.8, 1.2, 4).astype(np.float32),
              "bias": rng.uniform(-0.1, 0.1, 4).astype(np.float32)}
    state = {"mean": rng.uniform(-0.1, 0.1, 4).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 4).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    ref, rstate = jnn.batchnorm(jp, js, jnp.asarray(x), train=True)
    tp = {k: _t(v, grad=True) for k, v in params.items()}
    tx = _t(x, grad=True)
    got, new = tnn.batchnorm_train(tp, {k: _t(v) for k, v in state.items()},
                                   tx)
    assert _rel(got, ref) < TOL
    for k in ("mean", "var"):
        assert not new[k].requires_grad
        assert _rel(new[k], rstate[k]) < TOL
    cot = rng.standard_normal(x.shape).astype(np.float32)
    (got * _t(cot)).sum().backward()
    jgx, jgp = jax.grad(lambda xx, pp: jnp.sum(
        jnn.batchnorm(pp, js, xx, train=True)[0] * cot), argnums=(0, 1))(
        jnp.asarray(x), jp)
    assert _rel(tx.grad, jgx) < GRAD_TOL
    for k in ("scale", "bias"):
        assert _rel(tp[k].grad, jgp[k]) < GRAD_TOL


# (kernel, stride, padding) of the LPIPS AlexNet and SyncNet convs
CONV_CASES = [((11, 11), 4, 2), ((5, 5), 1, 2), ((5, 5), (1, 2), 1),
              ((3, 3), (2, 2), 1), ((3, 3), 1, 0)]


@pytest.mark.parametrize("kernel,stride,padding", CONV_CASES)
def test_strided_conv2d_matches_jax(kernel, stride, padding):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 23, 27, 3)).astype(np.float32)
    w = (rng.standard_normal((*kernel, 3, 5)) * 0.2).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ref = jnn.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(x), stride=stride, padding=padding)
    got = tnn.conv2d({"w": _t(w), "b": _t(b)}, _t(x), stride=stride,
                     padding=padding)
    assert _rel(got, ref) < TOL


@pytest.mark.parametrize("size", [(27, 31), (13, 13)])
def test_maxpool_3x3_stride2_matches_jax(size):
    x = np.random.default_rng(3).standard_normal(
        (2, *size, 4)).astype(np.float32)
    ref = jnn.maxpool2d(jnp.asarray(x), 3, 2)
    assert _rel(tnn.maxpool2d(_t(x), 3, 2), ref) == 0.0


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_grid_sample_value_and_grads_match_jax(mode):
    """Points spill past the image on every side, so border padding and
    the zero-gradient clamp are both exercised."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (2, 9, 11, 3)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (2, 5, 7, 2)).astype(np.float32)
    cot = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    jfn = lambda i, g: jgs.grid_sample(i, g, padding_mode=mode)
    tfn = lambda i, g: tgs.grid_sample(i, g, padding_mode=mode)
    assert _rel(tfn(_t(img), _t(grid)),
                jfn(jnp.asarray(img), jnp.asarray(grid))) < TOL
    got, ref = _grads(jfn, tfn, (img, grid), cot)
    for a, r in zip(got, ref):
        assert _rel(a, r) < GRAD_TOL
    with pytest.raises(ValueError):
        tgs.grid_sample(_t(img), _t(grid), padding_mode="reflection")


def test_grid_sample_onehot_border_matches_jax():
    rng = np.random.default_rng(5)
    src = rng.uniform(0, 1, (2, 10, 13, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 40, 2)).astype(np.float32)
    cot = rng.standard_normal((2, 40, 3)).astype(np.float32)
    ref = jgs.grid_sample_onehot_border(jnp.asarray(src), jnp.asarray(grid))
    assert _rel(tgs.grid_sample_onehot_border(_t(src), _t(grid)), ref) < TOL
    # border semantics: the same values as the full grid_sample
    full = tgs.grid_sample(_t(src), _t(grid)[:, :, None], "border")[:, :, 0]
    assert _rel(full, ref) < TOL
    got, jg = _grads(jgs.grid_sample_onehot_border,
                     tgs.grid_sample_onehot_border, (src, grid), cot)
    for a, r in zip(got, jg):
        assert _rel(a, r) < GRAD_TOL


def test_grid_sample_onehot_is_differentiable_like_jax():
    """The crop sampler's gradients on interior points (the only points
    its contract covers), for the source and the grid."""
    rng = np.random.default_rng(6)
    b, hs, ws, h, w, y_off, x_off = 2, 12, 16, 40, 50, 10, 20
    src = rng.uniform(0, 1, (b, hs, ws, 3)).astype(np.float32)
    gx = rng.uniform((x_off + 2) / w * 2 - 1, (x_off + ws - 3) / w * 2 - 1,
                     (b, 60))
    gy = rng.uniform((y_off + 2) / h * 2 - 1, (y_off + hs - 3) / h * 2 - 1,
                     (b, 60))
    grid = np.stack([gx, gy], -1).astype(np.float32)
    cot = rng.standard_normal((b, 60, 3)).astype(np.float32)
    got, ref = _grads(
        lambda s, g: jgs.grid_sample_onehot(s, g, y_off, x_off, h, w),
        lambda s, g: tgs.grid_sample_onehot(s, g, y_off, x_off, h, w),
        (src, grid), cot)
    for a, r in zip(got, ref):
        assert _rel(a, r) < GRAD_TOL


def _poses(b=2, h=12, w=14):
    """Observed and canonical poses near the synthetic data's (camera 2
    units away), a depth map around 2, and the intrinsics."""
    rng = np.random.default_rng(7)
    euler = (0.05 * rng.standard_normal((b, 3))).astype(np.float32)
    trans = (0.05 * rng.standard_normal((b, 3))).astype(np.float32)
    trans[:, 2] += 2.0
    ceuler = (0.02 * rng.standard_normal((b, 3))).astype(np.float32)
    ctrans = np.tile(np.array([[0.0, 0.0, 2.0]], np.float32), (b, 1))
    depth = rng.uniform(1.8, 2.2, (h, w)).astype(np.float32)
    return ceuler, ctrans, euler, trans, depth, 2.0 * w


def test_pose_geometry_matches_jax():
    ceuler, ctrans, euler, trans, depth, focal = _poses()
    h, w = depth.shape
    k = tgeo.intrinsics(focal, h, w)
    assert np.array_equal(k, jgeo.intrinsics(focal, h, w))
    assert _rel(tgeo.euler2rot(_t(euler)),
                jgeo.euler2rot(jnp.asarray(euler))) < TOL
    assert _rel(tgeo.pose_matrix(_t(euler), _t(trans)),
                jgeo.pose_matrix(jnp.asarray(euler), jnp.asarray(trans))
                ) < TOL
    args = [ceuler, ctrans, euler, trans]
    assert _rel(tgeo.rel_pose_obs2can(*map(_t, args)),
                jgeo.rel_pose_obs2can(*map(jnp.asarray, args))) < TOL
    inv_k = np.linalg.inv(k)
    assert _rel(tgeo.backproject_depth(_t(depth), _t(inv_k)),
                jgeo.backproject_depth(jnp.asarray(depth),
                                       jnp.asarray(inv_k))) < TOL


def test_warp_grids_match_jax():
    """project_3d, and its crop and points restrictions, per pose."""
    ceuler, ctrans, euler, trans, depth, focal = _poses()
    h, w = depth.shape
    k = tgeo.intrinsics(focal, h, w)
    inv_k = np.linalg.inv(k).astype(np.float32)
    rel = jgeo.rel_pose_obs2can(*map(jnp.asarray,
                                     (ceuler, ctrans, euler, trans)))
    trel = _t(np.asarray(rel))
    jk, jinv, jdepth = map(jnp.asarray, (k, inv_k, depth))
    pts = jgeo.backproject_depth(jdepth, jinv)
    jgrid, jz = jax.vmap(lambda t: jgeo.project_3d(pts, jk, t, h, w))(rel)
    tgrid, tz = tgeo.project_3d(_t(np.asarray(pts)), _t(k), trel, h, w)
    assert _rel(tgrid, jgrid) < TOL and _rel(tz, jz) < TOL

    box = (2, 11, 3, 10)   # x0, x1, y0, y1
    ref = jax.vmap(lambda t: jgeo.warp_grid_crop(jdepth, t, jk, jinv, box,
                                                 h, w))(rel)
    got = tgeo.warp_grid_crop(_t(depth), trel, _t(k), _t(inv_k), box, h, w)
    assert _rel(got, ref) < TOL
    assert _rel(got, tgrid[:, 3:10, 2:11]) < TOL   # the full grid's crop

    rng = np.random.default_rng(8)
    xs = rng.integers(0, w, 25)
    ys = rng.integers(0, h, 25)
    dp = depth[ys, xs]
    ref = jax.vmap(lambda t: jgeo.warp_grid_points(
        jnp.asarray(dp), jnp.asarray(xs), jnp.asarray(ys), t, jk, jinv, h,
        w))(rel)
    got = tgeo.warp_grid_points(_t(dp), torch.from_numpy(xs),
                                torch.from_numpy(ys), trel, _t(k),
                                _t(inv_k), h, w)
    assert _rel(got, ref) < TOL


def test_inverse_warp_value_and_depth_grad_match_jax():
    """The canonical-depth loss's full-frame warp (border padding) and its
    gradient with respect to the learned depth."""
    ceuler, ctrans, euler, trans, depth, focal = _poses()
    h, w = depth.shape
    k = tgeo.intrinsics(focal, h, w)
    inv_k = np.linalg.inv(k).astype(np.float32)
    rng = np.random.default_rng(9)
    src = rng.uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    cot = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    rel = np.asarray(jgeo.rel_pose_obs2can(
        *map(jnp.asarray, (ceuler, ctrans, euler, trans))))
    jk, jinv = jnp.asarray(k), jnp.asarray(inv_k)

    def jfn(s, d):
        return jax.vmap(lambda si, t: jgeo.inverse_warp(si, d, t, jk,
                                                        jinv)[0])(
            s, jnp.asarray(rel))

    ref, jz = jax.vmap(lambda si, t: jgeo.inverse_warp(
        si, jnp.asarray(depth), t, jk, jinv))(jnp.asarray(src),
                                              jnp.asarray(rel))
    got, tz = tgeo.inverse_warp(_t(src), _t(depth), _t(rel), _t(k),
                                _t(inv_k))
    assert _rel(got, ref) < TOL and _rel(tz, jz) < TOL
    got, jg = _grads(
        jfn, lambda s, d: tgeo.inverse_warp(s, d, _t(rel), _t(k),
                                            _t(inv_k))[0],
        (src, depth), cot)
    for a, r in zip(got, jg):
        assert _rel(a, r) < GRAD_TOL


@pytest.mark.parametrize("shape,out", [((2, 40, 52, 3), (16, 16)),
                                       ((2, 10, 16, 3), (16, 16)),
                                       ((1, 96, 70, 3), (96, 96))])
def test_resize_linear_matches_jax_image_resize(shape, out):
    """The sync stage's crop resize: ``jax.image.resize(..., "linear")``
    antialiases when it downscales; the port builds the same matrices."""
    rng = np.random.default_rng(10)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    cot = rng.standard_normal((shape[0], *out, 3)).astype(np.float32)
    jfn = lambda a: jax.image.resize(a, (shape[0], *out, 3), "linear")
    tfn = lambda a: tnn.resize_linear(a, *out)
    assert _rel(tfn(_t(x)), jfn(jnp.asarray(x))) < TOL
    got, ref = _grads(jfn, tfn, (x,), cot)
    assert _rel(got[0], ref[0]) < GRAD_TOL
