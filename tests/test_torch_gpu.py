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
from speech2lip_tpu_torch.ops.coords import get_coords
from speech2lip_tpu_torch.ops.embedders import fourier_embed
from speech2lip_tpu_torch.ops.kernels import fused_block as kfb
from speech2lip_tpu_torch.ops.kernels import fused_mlp as kmlp
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


def test_wrappers_raise_on_bad_input(cuda):
    src = torch.zeros(1, 4, 4, 3, device=cuda, dtype=torch.float16)
    grid = torch.zeros(1, 5, 2, device=cuda)
    with pytest.raises(TypeError):
        kws.window_sample(src, grid, 0, 0, 8, 8)
    with pytest.raises(ValueError):
        kws.window_sample(src.float(), grid.double(), 0, 0, 8, 8)
