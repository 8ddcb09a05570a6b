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


def _window_views(cuda, dtype, grid_form, b=3):
    """K2's inputs as the composite passes them: a crop view of a larger
    frame, and a window view of a larger grid (4-D; "interleaved": of a
    grid that holds the batch innermost, as one frame's grid broadcast
    over the batch by numpy does) or a slice of a larger point list (3-D),
    with points inside, across the edge of and outside the crop.  Returns
    (src, grid, y_off, x_off, height, width)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    h, w, y_off, x_off, hs, ws = 200, 220, 60, 70, 54, 70
    frame = torch.rand(b, h, w, 3, device=cuda, generator=g).to(dtype)
    src = frame[:, y_off:y_off + hs, x_off:x_off + ws]
    gx = (x_off - 5 + (ws + 10) * torch.rand(b, 120, 150, device=cuda,
                                             generator=g)) / w * 2 - 1
    gy = (y_off - 5 + (hs + 10) * torch.rand(b, 120, 150, device=cuda,
                                             generator=g)) / h * 2 - 1
    coord = torch.stack([gx, gy], -1)
    if grid_form == "interleaved":
        coord = coord.permute(1, 2, 0, 3).contiguous().permute(2, 0, 1, 3)
    grid = (coord.reshape(b, -1, 2)[:, 501:9000] if grid_form == "points"
            else coord[:, 10:90, 20:131])
    assert not (src.is_contiguous() or grid.is_contiguous())
    return src, grid, y_off, x_off, h, w


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid_form", ["window", "interleaved", "points"])
def test_window_sample_kernel_on_views(cuda, dtype, grid_form):
    """K2 reads the crop and the grid in place: against its plain version
    at the bounds of test_window_sample_kernel, and bit for bit against
    itself on contiguous copies."""
    src, grid, *geom = _window_views(cuda, dtype, grid_form)
    before = kws.launches
    got = kws.window_sample(src, grid, *geom)
    torch.cuda.synchronize()
    assert kws.launches == before + 1
    assert got.shape == (src.shape[0], grid[0, ..., 0].numel(), 3)
    ref = kws.window_sample_plain(src, grid, *geom)
    assert _rel_err(got, ref) < (1e-5 if dtype == torch.float32 else 1e-2)
    flat = grid.reshape(grid.shape[0], -1, 2).contiguous()
    assert torch.equal(got, kws.window_sample(src.contiguous(), flat, *geom))


@pytest.mark.parametrize("c", [1, 4])
def test_window_sample_kernel_any_channel_count(cuda, c):
    """C other than the images' 3 takes the kernel's scalar path, on views
    too, against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(4)
    frame = torch.rand(2, 60, 70, c, device=cuda, generator=g)
    src = frame[:, 11:40, 7:52]
    coord = torch.rand(2, 50, 64, 2, device=cuda, generator=g) * 2 - 1
    grid = coord[:, 3:30, 5:44]
    got = kws.window_sample(src, grid, 11, 7, 60, 70)
    torch.cuda.synchronize()
    assert got.shape == (2, 27 * 39, c)
    assert _rel_err(got, kws.window_sample_plain(src, grid, 11, 7, 60,
                                                 70)) < 1e-5


def test_window_sample_raises_on_views_it_cannot_take(cuda):
    src = torch.rand(2, 20, 30, 3, device=cuda)
    grid = torch.rand(2, 50, 2, device=cuda) * 2 - 1
    four = torch.rand(2, 20, 30, 4, device=cuda)
    planar = torch.rand(2, 3, 20, 30, device=cuda).permute(0, 2, 3, 1)
    for bad_src in (four[..., :3],   # pixel stride 4, C 3
                    planar):         # channel stride 600
        with pytest.raises(ValueError):
            kws.window_sample(bad_src, grid, 0, 0, 20, 30)
    for bad_grid in (torch.rand(2, 2, 50, device=cuda).transpose(1, 2),
                     torch.rand(2, 50, 4, device=cuda)[..., ::2],
                     grid.cpu(), grid.double(), grid[:1],
                     torch.rand(2, 50, 3, device=cuda)):
        with pytest.raises(ValueError):
            kws.window_sample(src, bad_grid, 0, 0, 20, 30)
    with pytest.raises(TypeError):
        kws.window_sample(src.half(), grid, 0, 0, 20, 30)


@pytest.mark.parametrize("dtype", DTYPES)
def test_window_sample_kernel_in_a_cuda_graph(cuda, dtype):
    """K2 captured in a CUDA graph launches on the capturing stream: the
    replay gives the eager output, and again after the inputs change in
    place.  The launch counter counts at capture."""
    src, grid, *geom = _window_views(cuda, dtype, "window")
    eager = kws.window_sample(src, grid, *geom)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kws.window_sample(src, grid, *geom)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kws.launches
    with torch.cuda.graph(graph):
        out = kws.window_sample(src, grid, *geom)
    assert kws.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    src.mul_(0.5)
    grid.add_(0.01)
    graph.replay()
    torch.cuda.synchronize()
    assert kws.launches == before + 1
    assert torch.equal(out, kws.window_sample(src, grid, *geom))


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


# K7 cases: the main path's three, then taps across 32-pixel borders, a
# ragged crop, taps at the crop's edges, a window view, a sparse cotangent,
# C = 1 and C = 5
HAT_CASES = ["window", "points", "integer", "straddle", "ragged", "edges",
             "window_view", "sparse", "straddle_c1", "ragged_c1", "edges_c1",
             "window_view_c1", "sparse_c1", "ragged_c5"]


def _hat_case(cuda, dtype, case):
    """(src, grid, cotangent, geometry) of a K7 case: a full-frame source
    as the blackaug window gather has it, a crop sampled border-clamped as
    the depth-loss points are, or a grid exactly on pixel centres; the
    other cases come from ``_hat_edge_case``."""
    if case not in ("window", "points", "integer"):
        return _hat_edge_case(cuda, dtype, case)
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


def _hat_edge_case(cuda, dtype, case):
    """(src, grid, cotangent, geometry) of a K7 case ``name[_c<C>]`` (C
    channels, default 3):
    - straddle: every point's taps straddle a 32-pixel border, in x, in y
      or in both;
    - ragged: a 45x77 crop (no multiple of 16 or 32) with points across
      its edges;
    - edges: points whose first tap column or row is -1 or the crop's
      last (x0 or y0 at -1 and at Ws-1 / Hs-1);
    - window_view: the grid a [B, wh, ww, 2] window of a larger coord grid
      and the cotangent a slice of a wider one (non-unit strides);
    - sparse: the cotangent zero on most points (as the train step's is
      off the lip box), the points in the source's upper-left quarter, the
      cotangent transposed (channel stride P)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    name, _, ch = case.partition("_c")
    c = int(ch) if ch else 3
    b, p = 2, 6000
    if name in ("ragged", "edges"):
        hs, ws, h, w, y_off, x_off, spill = 45, 77, 100, 120, 20, 30, 4
    else:
        hs, ws, h, w, y_off, x_off, spill = 96, 128, 96, 128, 0, 0, 3
    src = torch.rand(b, hs, ws, c, device=cuda, generator=g).to(dtype)
    # crop pixel coordinates (ix, iy) -> the grid normalised to (h, w)
    to_grid = lambda ix, iy: torch.stack([(2 * (ix + x_off) + 1) / w - 1,
                                          (2 * (iy + y_off) + 1) / h - 1], -1)
    u = torch.rand(b, p, 2, device=cuda, generator=g)
    k = torch.randint(0, 4, (b, p, 2), device=cuda, generator=g)
    if name == "straddle":
        # x0 = 32k - 1 (taps 32k - 1 and 32k) in x, y or both, by thirds
        border = 32.0 * (k + 1) - 1 + u
        free = torch.rand(b, p, 2, device=cuda, generator=g) * torch.tensor(
            [ws - 1.0, hs - 1.0], device=cuda)
        which = torch.arange(p, device=cuda) % 3
        ix = torch.where(which != 1, border[..., 0], free[..., 0])
        iy = torch.where(which != 0, border[..., 1], free[..., 1])
        grid = to_grid(ix, iy)
    elif name == "edges":
        # first tap at -1 or at the last pixel, in x, y or both
        lo_hi = lambda size, kk: torch.where(kk % 2 == 0, -1.0, size - 1.0)
        ex = lo_hi(ws, k[..., 0]) + u[..., 0]
        ey = lo_hi(hs, k[..., 1]) + u[..., 1]
        fx = torch.rand(b, p, device=cuda, generator=g) * (ws - 1)
        fy = torch.rand(b, p, device=cuda, generator=g) * (hs - 1)
        which = torch.arange(p, device=cuda) % 3
        grid = to_grid(torch.where(which != 1, ex, fx),
                       torch.where(which != 0, ey, fy))
    else:
        span = 0.5 if name == "sparse" else 1.0
        grid = to_grid(-spill + (span * ws + 2 * spill) * u[..., 0],
                       -spill + (span * hs + 2 * spill) * u[..., 1])
    grid = grid.float().contiguous()
    cot = torch.randn(b, p, c, device=cuda, generator=g).to(dtype)
    if name == "window_view":
        # the points as rows of 60 in a larger [B, 140, 90, 2] grid
        coord = torch.rand(b, 140, 90, 2, device=cuda, generator=g)
        coord[:, 20:120, 10:70] = grid.reshape(b, 100, 60, 2)
        grid = coord[:, 20:120, 10:70]
        cot = torch.randn(b, p, c + 2, device=cuda, generator=g).to(
            dtype)[..., 1:c + 1]
    elif name == "sparse":
        keep = torch.rand(b, p, 1, device=cuda, generator=g) < 0.1
        cot = (cot * keep).transpose(1, 2).contiguous().transpose(1, 2)
    return src, grid, cot, (y_off, x_off, h, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", HAT_CASES)
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
    ref = khs.hat_sample_dsrc_plain(grid, cot, hs, ws, *geo)
    assert _rel_err(dsrc, ref) < (1e-5 if dtype == torch.float32 else 1e-2)
    assert _rel_err(dgrid, khs.hat_sample_dgrid_plain(src, grid, cot, *geo)
                    ) < 1e-5
    # a pixel no tap of a live point reaches reads exactly 0
    reached = khs.hat_sample_dsrc_plain(grid, cot.float().abs(), hs, ws,
                                        *geo) != 0
    assert bool((dsrc[~reached] == 0).all())
    if case.startswith("sparse"):
        assert float((~reached).float().mean()) > 0.5
    if case == "integer":
        # hat'(u) = -sign(u) on |u| < 1: exactly on a pixel the grid
        # gradient is 0
        assert bool((dgrid == 0).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_hat_sample_backward_kernels_in_a_cuda_graph(cuda, dtype):
    """dsrc's launches (zero-fill, scatter, cast) and dgrid's, captured in
    a CUDA graph on the capturing stream: the replay matches the eager
    calls, and the plain versions again after the inputs change in place.
    The counters count at capture."""
    src, grid, cot, geo = _hat_case(cuda, dtype, "window_view")
    hs, ws = src.shape[1:3]
    both = lambda: (khs.hat_sample_dsrc(grid, cot, hs, ws, *geo),
                    khs.hat_sample_dgrid(src, grid, cot, *geo))
    eager = both()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (khs.dsrc_launches, khs.dgrid_launches)
    with torch.cuda.graph(graph):
        outs = both()
    assert (khs.dsrc_launches, khs.dgrid_launches) == (before[0] + 1,
                                                       before[1] + 1)
    bound = 1e-5 if dtype == torch.float32 else 1e-2
    for step in range(2):
        graph.replay()
        torch.cuda.synchronize()
        if step == 0:
            assert _rel_err(outs[0], eager[0]) < bound
            assert torch.equal(outs[1], eager[1])
        assert _rel_err(outs[0], khs.hat_sample_dsrc_plain(
            grid, cot, hs, ws, *geo)) < bound
        assert _rel_err(outs[1], khs.hat_sample_dgrid_plain(
            src, grid, cot, *geo)) < 1e-5
        # new inputs in place: the graph reads them at the next replay
        cot.mul_(-0.5)
        grid.add_(0.013)
        src.mul_(0.5)
    assert (khs.dsrc_launches, khs.dgrid_launches) == (before[0] + 1,
                                                       before[1] + 1)


def test_hat_sample_kernels_have_no_local_memory(cuda):
    """dsrc and dgrid, both dtypes, keep their state in registers."""
    for which in ("dsrc", "dgrid"):
        for bf16 in (False, True):
            attrs = khs.attrs(which, bf16)
            assert attrs["local_bytes"] == 0, (which, bf16, attrs)
            assert 0 < attrs["regs"] <= 255


def test_hat_sample_on_a_window_view(cuda):
    """The Function hands the window view to K2 and K7 as it is: dsrc and
    dgrid through hat_sample on the view match the kernels on contiguous
    copies, and the grid's gradient lands in the window only."""
    src, grid, cot, geo = _hat_case(cuda, torch.float32, "window_view")
    coord = torch.zeros(2, 140, 90, 2, device=cuda)
    coord[:, 20:120, 10:70] = grid
    coord.requires_grad_(True)
    s = src.clone().requires_grad_(True)
    view = coord[:, 20:120, 10:70]
    out = khs.hat_sample(s, view, *geo)
    assert out.shape == (2, 6000, 3)
    out.backward(cot)
    flat = view.detach().reshape(2, -1, 2).contiguous()
    hs, ws = src.shape[1:3]
    assert _rel_err(s.grad, khs.hat_sample_dsrc(
        flat, cot.contiguous(), hs, ws, *geo)) < 1e-5
    assert torch.equal(coord.grad[:, 20:120, 10:70].reshape(2, -1, 2),
                       khs.hat_sample_dgrid(src, flat, cot.contiguous(),
                                            *geo))
    outside = coord.grad.clone()
    outside[:, 20:120, 10:70] = 0
    assert bool((outside == 0).all())


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
# two 256-column block tiles, M two 128-row tiles, K 512, and 274 tiles,
# which outnumber the 132 SMs by a ragged amount (2 x 132 + 10)
DOT_SHAPES = [(128, 768, 512, 8, 256), (128, 768, 256, 1, 1),
              (128, 768, 512, 1, 3), (128, 768, 256, 8, 3),
              (256, 512, 512, 2, 3), (128, 768, 512, 8, 137)]


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
