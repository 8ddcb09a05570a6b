"""Plain versions of the port's kernels (K1 fused_mlp, K2 window_sample,
K3 fused_block) against the JAX package, on the CPU in float32.

The wrappers given CPU tensors run these plain versions, and leave their
launch counters at 0; the CUDA kernels themselves are held against the
plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech2lip_tpu.ops.pallas.window_sample as jws
from speech2lip_tpu.core.config import default_config
from speech2lip_tpu.models import talking_face as jtf
from speech2lip_tpu.models import unet_light as junet
from speech2lip_tpu.ops import nn as jnn
from speech2lip_tpu.ops.coords import get_coords as jget_coords
from speech2lip_tpu.ops.embedders import fourier_embed as jfourier
from speech2lip_tpu.ops.grid_sample import grid_sample_onehot as jonehot
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.models import unet_light as tunet
from speech2lip_tpu_torch.ops.kernels import fused_block as kfb
from speech2lip_tpu_torch.ops.kernels import fused_mlp as kmlp
from speech2lip_tpu_torch.ops.kernels import window_sample as kws
from speech2lip_tpu_torch.ops.kernels.conv_block import fold_bn

torch.set_num_threads(2)


def _np(x):
    return np.asarray(x, np.float32)


def _err(got, ref):
    got = got.detach().float().numpy() if torch.is_tensor(got) else _np(got)
    ref = _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)))


def _tf_params(seed=0):
    cfg = default_config()
    cfg["model"]["canonical_depth_height"] = 8
    cfg["model"]["canonical_depth_width"] = 8
    return jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), cfg))


def unet_params(base, seed=0):
    """JAX U-Net init with a random eval BatchNorm (so folding matters)."""
    p, s = jax.tree.map(np.asarray, junet.init(jax.random.PRNGKey(seed),
                                               base=base))
    rng = np.random.default_rng(seed)
    for name in ("inc", "down1", "down2", "up1", "up2"):
        for bn in ("bn1", "bn2"):
            c = p[name][bn]["scale"].shape[0]
            p[name][bn] = {
                "scale": rng.uniform(0.8, 1.6, c).astype(np.float32),
                "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32)}
            s[name][bn] = {
                "mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return p, s


def _mlp_args(tp, base, skip, uv):
    trunk = tp["trunk"]
    return (uv, (tp["fc_uv"]["b"] + base).contiguous(),
            (tp["fc_uv_skip"]["b"] + skip).contiguous(), tp["fc_uv"]["w"],
            tp["fc_uv_skip"]["w"], [l["w"] for l in trunk],
            [l["b"] for l in trunk], tp["output"]["w"], tp["output"]["b"])


def test_fused_mlp_plain_matches_jax_trunk():
    jp = _tf_params()
    u = weights.from_jax(jp, *unet_params(16))
    rng = np.random.default_rng(0)
    b, lh, lw = 2, 16, 24
    base = rng.standard_normal((b, 256)).astype(np.float32)
    skip = rng.standard_normal((b, 256)).astype(np.float32)
    uv = jfourier(jget_coords(lw, lh), 10)                      # [N, 42]
    ref = jtf.mlp_trunk(jp, uv[None], jnp.asarray(base)[:, None],
                        jnp.asarray(skip)[:, None])
    args = _mlp_args(u[0], torch.from_numpy(base), torch.from_numpy(skip),
                     torch.from_numpy(np.array(uv, np.float32)))
    before = kmlp.launches
    got = kmlp.fused_mlp(*args)
    assert kmlp.launches == before == 0
    assert got.dtype == torch.float32 and got.shape == (b, lh * lw, 3)
    # float32; bias folding and summation order differ over 9 layers
    assert _err(got, ref) < 2e-5
    assert _err(kmlp.fused_mlp_plain(*args), ref) < 2e-5


@pytest.mark.parametrize("use_kernels", [False, True])
def test_render_pixels_matches_jax(use_kernels):
    """K1b: one frame's pixels, the 4-offset ensemble folded into the rows
    (``use_kernels`` routes the trunk through K1 with one frame)."""
    from speech2lip_tpu_torch.models import talking_face as ttf
    jp = _tf_params()
    tp = weights.from_jax(jp, *unet_params(16))[0]
    rng = np.random.default_rng(3)
    coords = rng.uniform(0, 1, (4, 96, 2)).astype(np.float32)
    code = rng.standard_normal((1, 64)).astype(np.float32)
    ref = jtf.render_pixels(jp, jnp.asarray(coords), jnp.asarray(code), 7.0)
    before = kmlp.launches
    got = ttf.render_pixels(tp, torch.from_numpy(coords),
                            torch.from_numpy(code), 7.0,
                            use_kernels=use_kernels)
    assert kmlp.launches == before
    # float32; bias folding and summation order differ over 9 layers
    assert _err(got, ref) < 2e-5


@pytest.fixture
def interp(monkeypatch):
    monkeypatch.setattr(jws, "INTERPRET", True)
    jws.window_sample.clear_cache()
    yield
    jws.window_sample.clear_cache()


def test_window_sample_plain_matches_pallas_interpret(interp):
    rng = np.random.default_rng(1)
    b, hs, ws, p, h, w, y_off, x_off = 2, 22, 38, 400, 100, 120, 40, 40
    src = rng.uniform(0, 1, (b, hs, ws, 3)).astype(np.float32)
    # points inside, at the edge of and outside the crop
    gx = rng.uniform((x_off - 4) / w * 2 - 1, (x_off + ws + 4) / w * 2 - 1,
                     (b, p))
    gy = rng.uniform((y_off - 4) / h * 2 - 1, (y_off + hs + 4) / h * 2 - 1,
                     (b, p))
    grid = np.stack([gx, gy], -1).astype(np.float32)
    ref = jws.window_sample(jnp.asarray(src), jnp.asarray(grid), y_off, x_off,
                            h, w, tile=256)
    before = kws.launches
    got = kws.window_sample(torch.from_numpy(src), torch.from_numpy(grid),
                            y_off, x_off, h, w)
    assert kws.launches == before == 0
    # float32 hat weights; the Pallas kernel contracts them as a matmul
    assert _err(got, ref) < 1e-5
    inside = ((gx >= (x_off + 1) / w * 2 - 1) & (gx <= (x_off + ws - 2) / w * 2 - 1)
              & (gy >= (y_off + 1) / h * 2 - 1) & (gy <= (y_off + hs - 2) / h * 2 - 1))
    assert inside.any() and (~inside).any()
    oh = jonehot(jnp.asarray(src), jnp.asarray(grid), y_off, x_off, h, w)
    assert _err(got.numpy()[inside], _np(oh)[inside]) < 1e-5


def _jblock(p, s, x):
    y, _ = junet._double_conv(p, s, x, False)
    return y


def _fused_args(u, s, name):
    p, st = u[name], s[name]
    s1, b1 = fold_bn(p["bn1"], st["bn1"])
    s2, b2 = fold_bn(p["bn2"], st["bn2"])
    return p["conv1"]["w"], s1, b1, p["conv2"]["w"], s2, b2


def test_fused_block_plain_matches_jax_stages():
    jp, js = unet_params(64)
    _, up, us = weights.from_jax(_tf_params(), jp, js)
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (2, 20, 24, 3)).astype(np.float32)
    jx1 = _jblock(jp["inc"], js["inc"], jnp.asarray(x))
    before = kfb.launches
    x1, x1p = kfb.fused_block(torch.from_numpy(x), *_fused_args(up, us, "inc"),
                              pool=True)
    # float32 3x3 convs; BN folded in a different order than JAX applies it
    assert _err(x1, jx1) < 1e-4
    assert _err(x1p, jnn.maxpool2d(jx1)) < 1e-4

    # up1: concat(x2 [10x12, 128], align-corners up2x(x3 [5x6, 128]))
    x2 = rng.uniform(0, 1, (2, 10, 12, 128)).astype(np.float32)
    x3 = rng.uniform(0, 1, (2, 5, 6, 128)).astype(np.float32)
    jin = jnp.concatenate([jnp.asarray(x2), jnn.upsample_bilinear(
        jnp.asarray(x3), 10, 12)], axis=-1)
    got = kfb.fused_block(torch.from_numpy(x2), *_fused_args(up, us, "up1"),
                          up=torch.from_numpy(x3))
    assert _err(got, _jblock(jp["up1"], js["up1"], jin)) < 1e-4
    assert kfb.launches == before == 0


@pytest.mark.parametrize("size", [(32, 32), (20, 28)])
def test_unet_matches_jax_apply(size):
    jp, js = unet_params(16)
    _, up, us = weights.from_jax(_tf_params(), jp, js)
    x = np.random.default_rng(3).uniform(0, 1, (2, *size, 3)).astype(
        np.float32)
    ref, _ = junet.apply(jp, js, jnp.asarray(x), train=False)
    xt = torch.from_numpy(x)
    assert _err(tunet.apply(up, us, xt)[0], ref) < 1e-4
    # the kernel U-Net computes the same function (exact-2x align-corners
    # upsampling at H, W multiples of 4)
    assert _err(tunet.apply_infer_fused(up, us, xt), ref) < 1e-4


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


def test_weight_bridge_layouts():
    jp = _tf_params()
    jup, jus = unet_params(64)
    got = weights.from_jax(jp, jup, jus, dtype=torch.bfloat16)
    # the training step learns the canonical depth: the bridge keeps it
    assert got[0]["canonical_depth"].shape == (8, 8)
    assert got[0]["trunk"][5]["w"].shape == (512, 256)
    assert got[1]["up1"]["conv1"]["w"].dtype == torch.bfloat16
    # parameters made from a seed have the bridge's exact tree and shapes,
    # the depth at the configured 500x500 (the JAX tree above is cut to 8x8)
    made = weights.random_params(0, dtype=torch.bfloat16)
    assert made[0].pop("canonical_depth").shape == (500, 500)
    got[0].pop("canonical_depth")
    assert [_shapes(t) for t in made] == [_shapes(t) for t in got]
    # a torch-layout (OIHW) conv kernel or a transposed linear is refused
    bad = jax.tree.map(lambda x: x, jup)
    bad["inc"]["conv1"]["w"] = np.transpose(jup["inc"]["conv1"]["w"],
                                            (3, 2, 0, 1))
    with pytest.raises(ValueError):
        weights.from_jax(jp, bad, jus)
    badp = dict(jp, output={"w": jp["output"]["w"].T, "b": jp["output"]["b"]})
    with pytest.raises(ValueError):
        weights.from_jax(badp, jup, jus)
