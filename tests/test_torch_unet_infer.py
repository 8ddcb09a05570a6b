"""The U-Net's inference kernels K4 (conv3x3_hcw), K5 (double_conv_hcw) and
K6 (conv3x3_infer / double_conv_infer), and the entry points that run them,
against the JAX package on the CPU in float32.

The JAX kernels run in Pallas interpret mode; the port's wrappers, given
CPU tensors, run their plain versions and launch nothing.  The JAX HCW
kernels take a haloed [B, H, C, W] layout: the tests pad into it and
compare its data region, transposed to NHWC.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from speech2lip_tpu.models import unet_light as junet
from speech2lip_tpu.ops.pallas import conv_block as jcb
from speech2lip_tpu.ops.pallas import conv_hcw as jch
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.models import unet_light as tunet
from speech2lip_tpu_torch.ops import nn as tnn
from speech2lip_tpu_torch.ops.kernels import conv_block as kcb
from speech2lip_tpu_torch.ops.kernels import conv_hcw as kch
from test_torch_kernels import _tf_params, unet_params

torch.set_num_threads(2)

# float32 convs on both sides, summed in another order (the JAX kernels
# contract at HIGHEST precision): max|diff| / max(1, max|ref|), measured
# <= 2e-6 here
TOL = 1e-5


def _err(got, ref):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.max(np.abs(got - ref))) / max(1.0, float(np.abs(ref).max()))


def _conv_inputs(rng, b, h, w, cin, cout):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    s = (rng.standard_normal(cout) * 0.5 + 1).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, wt, s, bias


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _counts():
    return (kch.conv3x3_launches, kch.double_conv_launches, kcb.launches)


@pytest.fixture(scope="module")
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("b,h,w,cin,cout,relu", [
    (1, 40, 24, 3, 16, True), (2, 37, 30, 8, 12, True),
    (2, 37, 30, 8, 12, False)])
def test_conv3x3_infer_matches_pallas(interpret, b, h, w, cin, cout, relu):
    """K6 at tests/test_pallas_conv.py's shapes, any Cout."""
    x, wt, s, bias = _conv_inputs(np.random.default_rng(h), b, h, w, cin,
                                  cout)
    ref = jcb.conv3x3_infer(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(s),
                            jnp.asarray(bias), row_tile=8, relu=relu)
    before = _counts()
    got = kcb.conv3x3_infer(*_t(x, wt, s, bias), relu=relu)
    assert _err(got, ref) < TOL
    assert _counts() == before == (0, 0, 0)


def test_double_conv_infer_matches_pallas(interpret):
    rng = np.random.default_rng(7)
    x, w1, s1, b1 = _conv_inputs(rng, 1, 40, 24, 3, 16)
    _, w2, s2, b2 = _conv_inputs(rng, 1, 1, 1, 16, 16)
    args = (x, w1, s1, b1, w2, s2, b2)
    ref = jcb.double_conv_infer(*map(jnp.asarray, args), row_tile=8)
    assert _err(kcb.double_conv_infer(*_t(*args)), ref) < TOL
    assert kcb.launches == 0


@pytest.mark.parametrize("b,h,w,cin,cout,rt,relu", [
    (1, 32, 64, 64, 64, 16, True), (1, 37, 70, 128, 64, 8, True),
    (1, 32, 64, 64, 128, 16, True), (1, 40, 60, 16, 64, 8, False),
    (1, 16, 20, 16, 256, 16, True)])
def test_conv3x3_hcw_matches_pallas(interpret, b, h, w, cin, cout, rt,
                                    relu):
    """K4 at tests/test_tpu_hw.py's shape classes (Cin 16..128, Cout 64,
    128 and 256, tail row groups), cut to <= 40 rows."""
    x, wt, s, bias = _conv_inputs(np.random.default_rng(w), b, h, w, cin,
                                  cout)
    xh = jch.halo_pad(jnp.transpose(jnp.asarray(x), (0, 1, 3, 2)), rt)
    out = jch.conv3x3_hcw(xh, jnp.asarray(wt), jnp.asarray(s),
                          jnp.asarray(bias), h, w, row_tile=rt, relu=relu)
    ref = jnp.transpose(out[:, 1:1 + h, :, :w], (0, 1, 3, 2))
    got = kch.conv3x3_hcw(*_t(x, wt, s, bias), relu=relu)
    assert _err(got, ref) < TOL
    assert _counts() == (0, 0, 0)


@pytest.mark.parametrize("b,h,w,cin,cmid,cout", [
    (1, 24, 60, 16, 64, 64), (1, 16, 50, 128, 128, 64),
    (1, 32, 70, 64, 128, 128)])
def test_double_conv_hcw_matches_pallas(interpret, b, h, w, cin, cmid, cout):
    """K5: the conv1 output stays on chip in both; float32, so its
    rounding to the working dtype is exact."""
    rng = np.random.default_rng(cin + cmid)
    x, w1, s1, b1 = _conv_inputs(rng, b, h, w, cin, cmid)
    _, w2, s2, b2 = _conv_inputs(rng, 1, 1, 1, cmid, cout)
    xh = jch.halo2_pad(jnp.transpose(jnp.asarray(x), (0, 1, 3, 2)), 8)
    out = jch.double_conv_hcw(xh, *map(jnp.asarray, (w1, s1, b1, w2, s2, b2)),
                              h, w, row_tile=8)
    ref = jnp.transpose(out[:, 2:2 + h, :, :w], (0, 1, 3, 2))
    got = kch.double_conv_hcw(*_t(x, w1, s1, b1, w2, s2, b2))
    assert _err(got, ref) < TOL
    assert _counts() == (0, 0, 0)


def test_double_conv_hcw_plain_rounds_the_mid():
    """In bf16 the plain version rounds conv1's output to bf16 before conv2,
    as the TPU kernel's mid scratch (``conv_hcw.py:454``) does."""
    rng = np.random.default_rng(9)
    x, w1, s1, b1 = _conv_inputs(rng, 1, 9, 11, 16, 64)
    _, w2, s2, b2 = _conv_inputs(rng, 1, 1, 1, 64, 64)
    xt, w1t, w2t = (torch.from_numpy(a).bfloat16() for a in (x, w1, w2))
    s1t, b1t, s2t, b2t = _t(s1, b1, s2, b2)
    got = kch.double_conv_hcw(xt, w1t, s1t, b1t, w2t, s2t, b2t)
    mid = kch.conv3x3_hcw(xt, w1t, s1t, b1t)
    assert mid.dtype == torch.bfloat16
    assert torch.equal(got, kch.conv3x3_hcw(mid, w2t, s2t, b2t))


@pytest.fixture(scope="module")
def unet():
    jp, js = unet_params(64, seed=4)
    _, up, us = weights.from_jax(_tf_params(), jp, js)
    return jp, js, up, us


def _x(h, w, seed=5):
    return np.random.default_rng(seed).uniform(0, 1, (1, h, w, 3)).astype(
        np.float32)


def test_apply_infer_entry_points_match_jax(interpret, unet):
    """apply_infer_hcw and apply_infer_pallas of both packages at 32x36,
    and the port's apply_infer_dconv, all against JAX ``apply``; each port
    entry point launches nothing on the CPU."""
    jp, js, up, us = unet
    x = _x(32, 36)
    ref, _ = junet.apply(jp, js, jnp.asarray(x))
    jhcw = junet.apply_infer_hcw(jp, js, jnp.asarray(x))
    jpal = junet.apply_infer_pallas(jp, js, jnp.asarray(x), row_tile=8)
    # the JAX entry points compute apply to accumulation tolerance
    assert _err(torch.from_numpy(np.asarray(jhcw)), ref) < TOL
    assert _err(torch.from_numpy(np.asarray(jpal)), ref) < TOL
    xt = torch.from_numpy(x)
    for fn, jref in ((tunet.apply_infer_hcw, jhcw),
                     (tunet.apply_infer_pallas, jpal),
                     (tunet.apply_infer_dconv, ref)):
        got = fn(up, us, xt)
        assert _err(got, jref) < TOL, fn.__name__
        assert _err(got, ref) < TOL, fn.__name__
    assert _counts() == (0, 0, 0)
    with pytest.raises(ValueError):
        tunet.apply_infer_hcw(up, us, xt[:, :30])


@pytest.mark.parametrize("size", [(32, 36), (24, 44)])
def test_apply_exact2x_matches_jax(unet, size):
    jp, js, up, us = unet
    x = _x(*size, seed=6)
    ref, _ = junet.apply(jp, js, jnp.asarray(x), exact2x=True)
    got, _ = tunet.apply(up, us, torch.from_numpy(x), exact2x=True)
    assert _err(got, ref) < TOL
    # exact-2x and align-corners differ: the test sees the upsample
    plain, _ = junet.apply(jp, js, jnp.asarray(x))
    assert float(jnp.max(jnp.abs(plain - ref))) > 1e-4


def _apply_with_pooled_pad_lane(up, us, x):
    """``apply(train=False)`` except down2's conv1, which sees, right of the
    pooled x2's last column, the row-pooled last column of x2 (the column
    an odd W/2 pool drops) instead of zero padding; conv2 and the rest see
    zeros.  This is what the JAX ``apply_infer_hcw`` computes when W/2 is
    odd: ``_pool_hcw`` pools x2's pad lane (0) with x2's last column into
    the pooled buffer's first pad lane (``unet_light.py:114-132``)."""
    def bn_relu(p, s, y, k):
        return tnn.relu(tnn.batchnorm(p[f"bn{k}"], s[f"bn{k}"], y))

    def dc(name, v):
        p, s = up[name], us[name]
        v = bn_relu(p, s, tnn.conv2d(p["conv1"], v, padding=1), 1)
        return bn_relu(p, s, tnn.conv2d(p["conv2"], v, padding=1), 2)

    x1 = dc("inc", x)
    x2 = dc("down1", tnn.maxpool2d(x1))
    w3 = x2.shape[2] // 2
    lane = torch.nn.functional.max_pool2d(x2.permute(0, 3, 1, 2), 2,
                                          ceil_mode=True).permute(0, 2, 3, 1)
    p, s = up["down2"], us["down2"]
    mid = bn_relu(p, s, tnn.conv2d(p["conv1"], lane, padding=1), 1)
    x3 = bn_relu(p, s, tnn.conv2d(p["conv2"], mid[:, :, :w3], padding=1), 2)
    u = dc("up1", torch.cat([x2, tnn.upsample_bilinear(x3, *x2.shape[1:3])],
                            -1))
    u = dc("up2", torch.cat([x1, tnn.upsample_bilinear(u, *x1.shape[1:3])],
                            -1))
    return tnn.conv2d(up["outc"], u, padding=0)


def test_apply_infer_hcw_odd_half_width(interpret, unet):
    """At 16x18 (W/2 = 9 odd) the JAX ``apply_infer_hcw`` differs from
    ``apply`` (1e-4..1e-3 here; 1e-8 at even W/2), and a plain forward that
    puts x2's dropped last column in the pooled pad lane reproduces it to
    float32 rounding: the pooled pad lane is the cause.  The port holds
    ``apply``, the documented oracle."""
    jp, js, up, us = unet
    x = _x(16, 18, seed=8)
    ref, _ = junet.apply(jp, js, jnp.asarray(x))
    jhcw = np.asarray(junet.apply_infer_hcw(jp, js, jnp.asarray(x)))
    gap = float(np.max(np.abs(jhcw - np.asarray(ref))))
    assert 1e-5 < gap < 1e-2, gap
    xt = torch.from_numpy(x)
    assert _err(tunet.apply_infer_hcw(up, us, xt), ref) < TOL
    assert _err(_apply_with_pooled_pad_lane(up, us, xt), jhcw) < TOL
