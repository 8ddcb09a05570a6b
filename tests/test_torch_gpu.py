"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import).  Run on the GPU machine, which has no JAX for
tests/conftest.py, with
``python -m pytest tests/test_torch_gpu.py --noconftest -p no:cacheprovider``.
TF32 is off for the plain versions' convs and matmuls, so float32 bounds
are tight.
"""

import pytest
import torch

from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.models import talking_face as ttf
from speech2lip_tpu_torch.ops.coords import get_coords
from speech2lip_tpu_torch.ops.embedders import fourier_embed
from speech2lip_tpu_torch.ops.kernels import fused_block as kfb
from speech2lip_tpu_torch.ops.kernels import fused_mlp as kmlp
from speech2lip_tpu_torch.ops.kernels import hat_sample as khs
from speech2lip_tpu_torch.ops.kernels import window_sample as kws
from speech2lip_tpu_torch.ops.kernels.conv_block import fold_bn

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]
# kernel vs plain, relative to max(1, max|plain|): float32 sums in another
# order (3xTF32 products), bf16 roundings at other places (a few ulps)
BOUND = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,frames", [(100, 3), (9600, 2)])
def test_fused_mlp_kernel(cuda, dtype, n, frames):
    tp, _, _ = weights.random_params(0, device=cuda, dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    uv = fourier_embed(get_coords(n, 1, dtype=dtype, device=cuda), 10)
    base = torch.randn(frames, 256, device=cuda, generator=g)
    skip = torch.randn(frames, 256, device=cuda, generator=g)
    trunk = tp["trunk"]
    args = (uv.contiguous(), (tp["fc_uv"]["b"].float() + base).contiguous(),
            (tp["fc_uv_skip"]["b"].float() + skip).contiguous(),
            tp["fc_uv"]["w"], tp["fc_uv_skip"]["w"], [l["w"] for l in trunk],
            [l["b"].float() for l in trunk], tp["output"]["w"],
            tp["output"]["b"].float())
    before = kmlp.launches
    got = kmlp.fused_mlp(*args)
    torch.cuda.synchronize()
    assert kmlp.launches == before + 1
    assert _rel_err(got, kmlp.fused_mlp_plain(*args)) < BOUND[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_window_sample_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    b, hs, ws, h, w, y_off, x_off = 3, 54, 70, 200, 220, 60, 70
    src = torch.rand(b, hs, ws, 3, device=cuda, generator=g).to(dtype)
    # points inside, across the edge of and outside the crop
    gx = (x_off - 5 + (ws + 10) * torch.rand(b, 5000, device=cuda,
                                             generator=g)) / w * 2 - 1
    gy = (y_off - 5 + (hs + 10) * torch.rand(b, 5000, device=cuda,
                                             generator=g)) / h * 2 - 1
    grid = torch.stack([gx, gy], -1).contiguous()
    before = kws.launches
    got = kws.window_sample(src, grid, y_off, x_off, h, w)
    torch.cuda.synchronize()
    assert kws.launches == before + 1
    ref = kws.window_sample_plain(src, grid, y_off, x_off, h, w)
    # float32: same formula; bf16: one output rounding apart at most
    assert _rel_err(got, ref) < (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block,size,pool", [
    ("inc", (36, 52), True), ("down1", (18, 26), True),
    ("down2", (9, 13), False), ("up1", (18, 26), False),
    ("up2", (36, 52), False)])
def test_fused_block_kernel(cuda, dtype, block, size, pool):
    _, up, us = weights.random_params(0, device=cuda, dtype=dtype)
    p, s = up[block], us[block]
    s1, b1 = fold_bn(p["bn1"], s["bn1"])
    s2, b2 = fold_bn(p["bn2"], s["bn2"])
    args = (p["conv1"]["w"], s1.float(), b1.float(), p["conv2"]["w"],
            s2.float(), b2.float())
    cin = p["conv1"]["w"].shape[2]
    g = torch.Generator(device=cuda).manual_seed(2)
    h, w = size
    if block.startswith("up"):
        x = torch.rand(2, h, w, cin // 2, device=cuda, generator=g).to(dtype)
        lo = torch.rand(2, (h + 1) // 2, (w + 1) // 2, cin // 2, device=cuda,
                        generator=g).to(dtype)
    else:
        x = torch.rand(2, h, w, cin, device=cuda, generator=g).to(dtype)
        lo = None
    before = kfb.launches
    got = kfb.fused_block(x, *args, up=lo, pool=pool)
    torch.cuda.synchronize()
    assert kfb.launches == before + 1
    ref = kfb.fused_block_plain(x, *args, up=lo, pool=pool)
    for g_, r_ in zip(got if pool else (got,), ref if pool else (ref,)):
        assert _rel_err(g_, r_) < BOUND[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_render_pixels_kernel(cuda, dtype):
    """K1b: one frame through K1, the 4-offset ensemble in the rows."""
    tp, _, _ = weights.random_params(0, device=cuda, dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(3)
    coords = torch.rand(4, 9600, 2, device=cuda, generator=g)
    code = torch.randn(1, 64, device=cuda, generator=g).to(dtype)
    before = kmlp.launches
    got = ttf.render_pixels(tp, coords, code, 7.0, use_kernels=True)
    torch.cuda.synchronize()
    assert kmlp.launches == before + 1 and got.shape == (4, 9600, 3)
    ref = ttf.render_pixels(tp, coords, code, 7.0)
    assert _rel_err(got, ref) < BOUND[dtype]


def _hat_case(cuda, dtype, case):
    """(src, grid, cotangent, geometry) of a K7 case: a full-frame source
    as the blackaug window gather has it, a crop sampled border-clamped as
    the depth-loss points are, or a grid exactly on pixel centres."""
    g = torch.Generator(device=cuda).manual_seed(4)
    b, p = 2, 6000
    if case == "window":
        hs, ws, h, w, y_off, x_off, spill = 96, 128, 96, 128, 0, 0, 3
    else:
        hs, ws, h, w, y_off, x_off, spill = 54, 70, 128, 256, 30, 60, 6
    src = torch.rand(b, hs, ws, 3, device=cuda, generator=g).to(dtype)
    if case == "integer":
        # power-of-two image sizes: (g + 1) * size/2 - (0.5 + off) is exact
        cols = torch.randint(1, ws - 1, (b, p), device=cuda, generator=g)
        rows = torch.randint(1, hs - 1, (b, p), device=cuda, generator=g)
        grid = torch.stack([(2.0 * (cols + x_off) + 1.0) / w - 1.0,
                            (2.0 * (rows + y_off) + 1.0) / h - 1.0], -1)
    else:
        u = torch.rand(b, p, 2, device=cuda, generator=g)
        grid = torch.stack(
            [(x_off - spill + (ws + 2 * spill) * u[..., 0]) / w * 2 - 1,
             (y_off - spill + (hs + 2 * spill) * u[..., 1]) / h * 2 - 1], -1)
        if case == "points":
            grid = khs.border_clamp(grid, hs, ws, y_off, x_off, h, w)
    cot = torch.randn(b, p, 3, device=cuda, generator=g).to(dtype)
    return src, grid.float().contiguous(), cot, (y_off, x_off, h, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["window", "points", "integer"])
def test_hat_sample_backward_kernels(cuda, dtype, case):
    src, grid, cot, geo = _hat_case(cuda, dtype, case)
    hs, ws = src.shape[1:3]
    before = (khs.dsrc_launches, khs.dgrid_launches)
    dsrc = khs.hat_sample_dsrc(grid, cot, hs, ws, *geo)
    dgrid = khs.hat_sample_dgrid(src, grid, cot, *geo)
    torch.cuda.synchronize()
    assert (khs.dsrc_launches, khs.dgrid_launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert dsrc.dtype == dtype and dgrid.dtype == torch.float32
    # dsrc: float32 atomics add in another order, bf16 then rounds once
    # (one ulp apart at most); dgrid: the same inputs and float32 sums
    assert _rel_err(dsrc, khs.hat_sample_dsrc_plain(grid, cot, hs, ws, *geo)
                    ) < (1e-5 if dtype == torch.float32 else 1e-2)
    assert _rel_err(dgrid, khs.hat_sample_dgrid_plain(src, grid, cot, *geo)
                    ) < 1e-5
    if case == "integer":
        # hat'(u) = -sign(u) on |u| < 1: exactly on a pixel the grid
        # gradient is 0
        assert bool((dgrid == 0).all())


def test_hat_sample_launches_only_the_needed_kernels(cuda):
    src, grid, cot, geo = _hat_case(cuda, torch.float32, "window")
    counts = lambda: (kws.launches, khs.dsrc_launches, khs.dgrid_launches)
    grads = {}
    for kernels in (True, False):
        s = src.clone().requires_grad_(True)
        before = counts()
        khs.hat_sample(s, grid, *geo, kernels=kernels).backward(cot)
        q = grid.clone().requires_grad_(True)
        khs.hat_sample(src, q, *geo, kernels=kernels).backward(cot)
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(counts(), before))
        assert got == ((2, 1, 1) if kernels else (0, 0, 0)), got
        grads[kernels] = (s.grad, q.grad)
    for a, r in zip(grads[True], grads[False]):
        assert _rel_err(a, r) < 1e-5


def test_wrappers_raise_on_bad_input(cuda):
    src = torch.zeros(1, 4, 4, 3, device=cuda, dtype=torch.float16)
    grid = torch.zeros(1, 5, 2, device=cuda)
    with pytest.raises(TypeError):
        kws.window_sample(src, grid, 0, 0, 8, 8)
    with pytest.raises(ValueError):
        kws.window_sample(src.float(), grid.double(), 0, 0, 8, 8)
    with pytest.raises(TypeError):
        khs.hat_sample_dgrid(src, grid, torch.zeros(1, 5, 3, device=cuda,
                                                    dtype=torch.float16),
                             0, 0, 8, 8)
    with pytest.raises(ValueError):
        khs.hat_sample_dsrc(grid, torch.zeros(1, 6, 3, device=cuda), 4, 4,
                            0, 0, 8, 8)
