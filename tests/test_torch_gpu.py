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
from speech2lip_tpu_torch.models import unet_light as tunet
from speech2lip_tpu_torch.ops.coords import get_coords
from speech2lip_tpu_torch.ops.embedders import fourier_embed
from speech2lip_tpu_torch.ops.kernels import conv_block as kcb
from speech2lip_tpu_torch.ops.kernels import conv_hcw as kch
from speech2lip_tpu_torch.ops.kernels import dot_probe as kdp
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


def _check_fused_block(cuda, dtype, block, size, pool, batch=2, lo_size=None):
    """K3 with the U-Net block's weights on a size x input (an up block's
    low-resolution source at lo_size, by default ((h + 1) // 2, (w + 1) //
    2)) against its plain version, pooled output too."""
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
        x = torch.rand(batch, h, w, cin // 2, device=cuda, generator=g).to(
            dtype)
        lo = torch.rand(batch, *(lo_size or ((h + 1) // 2, (w + 1) // 2)),
                        cin // 2, device=cuda, generator=g).to(dtype)
    else:
        x = torch.rand(batch, h, w, cin, device=cuda, generator=g).to(dtype)
        lo = None
    before = kfb.launches
    got = kfb.fused_block(x, *args, up=lo, pool=pool)
    torch.cuda.synchronize()
    assert kfb.launches == before + 1
    ref = kfb.fused_block_plain(x, *args, up=lo, pool=pool)
    for g_, r_ in zip(got if pool else (got,), ref if pool else (ref,)):
        assert _rel_err(g_, r_) < BOUND[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block,size,pool", [
    ("inc", (36, 52), True), ("down1", (18, 26), True),
    ("down2", (9, 13), False), ("up1", (18, 26), False),
    ("up2", (36, 52), False),
    # the static-scene crop's three levels (non-square, no tile multiple):
    # 308x344, 154x172 with a 77x86 source, 77x86 pooled to 38x43
    ("inc", (308, 344), True), ("down1", (154, 172), True),
    ("down2", (77, 86), True), ("up1", (154, 172), False),
    ("up2", (308, 344), False)])
def test_fused_block_kernel(cuda, dtype, block, size, pool):
    _check_fused_block(cuda, dtype, block, size, pool)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size,lo_size", [((40, 70), (16, 60)),
                                          ((21, 35), (21, 35)),
                                          ((2, 2), (3, 5))])
def test_fused_block_kernel_any_upsample_ratio(cuda, dtype, size, lo_size):
    """K3 with a source that is not half the size: align-corners ratios
    (source - 1) / (size - 1) of 0.38 to 4 per axis (the U-Net's are
    about 0.5), a source larger than x included."""
    _check_fused_block(cuda, dtype, "up1", size, True, lo_size=lo_size)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", [15, 16, 17])
@pytest.mark.parametrize("w", [31, 32, 33])
@pytest.mark.parametrize("pool", [True, False])
def test_fused_block_kernel_tile_edges(cuda, dtype, h, w, pool):
    """K3 one pixel under, on and over the bf16 body's 16x32 tile on each
    axis: pooled as down1 (two 64-channel output tiles), unpooled as up2
    (a computed upsample source); batch 3 spreads the tiles over blocks."""
    _check_fused_block(cuda, dtype, "down1" if pool else "up2", (h, w),
                       pool, batch=3)


# (cin, cout) of the U-Net's ten convs, inc to up2
UNET_CONVS = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 128),
              (128, 128), (256, 128), (128, 64), (128, 64), (64, 64)]
# (cin, cmid, cout) of its five DoubleConvs
UNET_DCONVS = [(3, 64, 64), (64, 128, 128), (128, 128, 128),
               (256, 128, 64), (128, 64, 64)]


def _conv_args(cuda, dtype, cin, cout, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = (0.1 * torch.randn(3, 3, cin, cout, device=cuda, generator=g)).to(dtype)
    scale = 0.5 + torch.rand(cout, device=cuda, generator=g)
    bias = 0.2 * torch.randn(cout, device=cuda, generator=g)
    return w, scale, bias


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,cout,relu", [c + (True,) for c in UNET_CONVS]
                         + [(64, 64, False), (16, 256, True),
                            (3, 256, True), (256, 256, False)])
def test_conv3x3_kernels(cuda, dtype, cin, cout, relu):
    """K4 (conv3x3_hcw) and K6 (conv3x3_infer), one kernel behind two
    wrappers, at the U-Net's conv shapes on a 37x45 input (no tile
    multiple), ReLU off, Cin 3 and Cout 256 too."""
    w, scale, bias = _conv_args(cuda, dtype, cin, cout, cin + cout)
    x = torch.rand(2, 37, 45, cin, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(5)
                   ).to(dtype)
    ref = kfb.conv3x3_affine_plain(x, w, scale, bias, relu)
    before = (kch.conv3x3_launches, kcb.launches)
    got4 = kch.conv3x3_hcw(x, w, scale, bias, relu)
    got6 = kcb.conv3x3_infer(x, w, scale, bias, relu)
    torch.cuda.synchronize()
    assert (kch.conv3x3_launches, kcb.launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert _rel_err(got4, ref) < BOUND[dtype]
    assert torch.equal(got4, got6)
    if not relu:
        assert bool((got4 < 0).any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,cmid,cout", UNET_DCONVS)
@pytest.mark.parametrize("size", [(31, 45), (14, 14)])
def test_double_conv_kernel(cuda, dtype, cin, cmid, cout, size):
    """K5 at the U-Net's DoubleConv shapes, on a size that is no multiple
    of any of its tiles and on a 14x14 input."""
    w1, s1, b1 = _conv_args(cuda, dtype, cin, cmid, cin)
    w2, s2, b2 = _conv_args(cuda, dtype, cmid, cout, cout)
    x = torch.rand(2, *size, cin, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(6)
                   ).to(dtype)
    args = (x, w1, s1, b1, w2, s2, b2)
    before = kch.double_conv_launches
    got = kch.double_conv_hcw(*args)
    torch.cuda.synchronize()
    assert kch.double_conv_launches == before + 1
    assert _rel_err(got, kch.double_conv_hcw_plain(*args)) < BOUND[dtype]


def _k5_tile(dtype, cmid):
    """(rows, cols) of K5's output tile (csrc/double_conv.cu): bf16 14x30
    at Cmid 128 and 30x30 at Cmid 64, float32 14x14."""
    if dtype == torch.float32:
        return 14, 14
    return (14, 30) if cmid == 128 else (30, 30)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,cmid,cout", UNET_DCONVS)
@pytest.mark.parametrize("edge", ["rows_under_cols_over",
                                  "rows_over_cols_under", "one_tile"])
@pytest.mark.parametrize("batch", [1, 3])
def test_double_conv_kernel_tile_edges(cuda, dtype, cin, cmid, cout, edge,
                                       batch):
    """K5 one pixel under and over a multiple of its tile on each axis, and
    on exactly one tile: a missed mask on the mid's zero padding, the
    conv2 fragments past the tile or the image edge shows here."""
    th, tw = _k5_tile(dtype, cmid)
    size = {"rows_under_cols_over": (2 * th - 1, 2 * tw + 1),
            "rows_over_cols_under": (2 * th + 1, 2 * tw - 1),
            "one_tile": (th, tw)}[edge]
    w1, s1, b1 = _conv_args(cuda, dtype, cin, cmid, cin + 1)
    w2, s2, b2 = _conv_args(cuda, dtype, cmid, cout, cout + 1)
    x = torch.rand(batch, *size, cin, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(8)
                   ).to(dtype)
    args = (x, w1, s1, b1, w2, s2, b2)
    before = kch.double_conv_launches
    got = kch.double_conv_hcw(*args)
    torch.cuda.synchronize()
    assert kch.double_conv_launches == before + 1
    assert _rel_err(got, kch.double_conv_hcw_plain(*args)) < BOUND[dtype]


@pytest.mark.parametrize("kernel", ["double_conv", "conv3x3", "dot_probe"])
def test_bf16_kernels_have_no_local_memory(cuda, kernel):
    """Every bf16 instance of K5 (Cmid, Cout in {64, 128}) and of the conv
    kernel behind K3/K4/K6 (Cout 64, 128, 256), and K8's bf16 and int8
    dot kernels, keep their accumulators in registers: no spills, no local
    memory."""
    if kernel == "double_conv":
        insts = [kch.double_conv_attrs(torch.bfloat16, cmid, cout)
                 for cmid in (64, 128) for cout in (64, 128)]
    elif kernel == "dot_probe":
        insts = [kdp.dot_probe_attrs(dt) for dt in (torch.bfloat16,
                                                    torch.int8)]
    else:
        insts = [kfb.conv3x3_attrs(torch.bfloat16, cout)
                 for cout in (64, 128, 256)]
    for attrs in insts:
        assert attrs["local_bytes"] == 0, attrs
        assert 0 < attrs["regs"] <= 255 and attrs["smem_bytes"] > 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_unet_entry_points(cuda, dtype):
    """apply_infer_hcw / _pallas / _dconv against the plain forward, with
    their launch counts per call (10 K4, 10 K6, 5 K5)."""
    _, up, us = weights.random_params(0, device=cuda, dtype=dtype)
    x = torch.rand(2, 36, 52, 3, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(7)
                   ).to(dtype)
    ref, _ = tunet.apply(up, us, x)
    counts = lambda: (kch.conv3x3_launches, kcb.launches,
                      kch.double_conv_launches)
    for fn, want in ((tunet.apply_infer_hcw, (10, 0, 0)),
                     (tunet.apply_infer_pallas, (0, 10, 0)),
                     (tunet.apply_infer_dconv, (0, 0, 5))):
        before = counts()
        got = fn(up, us, x)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), before)) == want
        # bf16: the plain forward rounds after every op, the kernels once
        # per conv (a few bf16 ulps apart)
        assert _rel_err(got, ref) < BOUND[dtype], fn.__name__


def test_conv_wrappers_raise_on_unsupported_shapes(cuda):
    x = torch.zeros(1, 8, 8, 16, device=cuda)
    w, scale, bias = _conv_args(cuda, torch.float32, 16, 96, 0)
    for fn in (kch.conv3x3_hcw, kcb.conv3x3_infer):
        with pytest.raises(ValueError):
            fn(x, w, scale, bias)          # Cout 96 is not instantiated
        with pytest.raises(ValueError):
            fn(x, w.bfloat16(), scale, bias)
    w1, s1, b1 = _conv_args(cuda, torch.float32, 16, 256, 0)
    w2, s2, b2 = _conv_args(cuda, torch.float32, 256, 64, 0)
    with pytest.raises(ValueError):
        kch.double_conv_hcw(x, w1, s1, b1, w2, s2, b2)   # Cmid 256
    with pytest.raises(ValueError):
        tunet.apply_infer_hcw(*weights.random_params(0, device=cuda)[1:],
                              torch.zeros(1, 30, 32, 3, device=cuda))


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


# (M, K, N, G, T): the probe's shape, then T 1 and 3, G 1 and 8, N one and
# two 256-column block tiles, M two 128-row tiles, K 512
DOT_SHAPES = [(128, 768, 512, 8, 256), (128, 768, 256, 1, 1),
              (128, 768, 512, 1, 3), (128, 768, 256, 8, 3),
              (256, 512, 512, 2, 3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("m,k,n,g,t", DOT_SHAPES)
def test_dot_probe_kernel(cuda, dtype, m, k, n, g, t):
    """K8 against its plain version: int8 exactly (int32 sums of the same
    integers); bf16 within 1e-4 of max(1, max|plain|) (float32 sums of
    exact products in another order than float64)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    if dtype == torch.int8:
        lhs, rhs = (torch.randint(-128, 128, s, device=cuda, generator=gen,
                                  dtype=torch.int8)
                    for s in ((m, k), (g, k, n)))
    else:
        lhs, rhs = (torch.randn(s, device=cuda, generator=gen).to(dtype)
                    for s in ((m, k), (g, k, n)))
    before = kdp.launches
    got = kdp.dot_probe(lhs, rhs, t)
    torch.cuda.synchronize()
    assert kdp.launches == before + 1
    ref = kdp.dot_probe_plain(lhs, rhs, t)
    assert got.dtype == ref.dtype and got.shape == (t, m, n)
    if dtype == torch.int8:
        assert torch.equal(got, ref)
    else:
        assert _rel_err(got, ref) <= 1e-4


def test_dot_probe_raises_on_what_it_does_not_take(cuda):
    lhs = torch.zeros(128, 768, device=cuda, dtype=torch.int8)
    rhs = torch.zeros(2, 768, 256, device=cuda, dtype=torch.int8)
    with pytest.raises(TypeError):
        kdp.dot_probe(lhs.float(), rhs.float(), 1)            # float32
    with pytest.raises(TypeError):
        kdp.dot_probe(lhs, rhs.bfloat16(), 1)                 # mixed
    with pytest.raises(ValueError):
        kdp.dot_probe(lhs[:64], rhs, 1)                       # M 64
    with pytest.raises(ValueError):
        kdp.dot_probe(lhs, rhs[..., :128].contiguous(), 1)    # N 128
    with pytest.raises(ValueError):
        kdp.dot_probe(lhs[:, :704].contiguous(),
                      rhs[:, :704].contiguous(), 1)           # K 704
    for x, y in ((lhs, rhs), (lhs.bfloat16(), rhs.bfloat16())):
        with pytest.raises(ValueError):
            kdp.dot_probe(x[:, :640].contiguous(),
                          y[:, :640].contiguous(), 1)         # K 640 = 5 x 128
    with pytest.raises(ValueError):
        kdp.dot_probe(lhs, rhs, 0)                            # t 0
    with pytest.raises(ValueError):
        kdp.dot_probe(lhs, rhs.transpose(1, 2).contiguous().transpose(1, 2),
                      1)                                      # not contiguous
    with pytest.raises(ValueError):
        kdp.dot_probe(lhs, rhs.cpu(), 1)                      # two devices
