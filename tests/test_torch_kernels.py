"""Plain versions of the port's kernels (K1 fused_mlp, K2 window_sample,
K3 fused_block) against the JAX package, on the CPU in float32.

The wrappers given CPU tensors run these plain versions, and leave their
launch counters at 0; the CUDA kernels themselves are held against the
plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import importlib.util
import re
from pathlib import Path

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
from speech2lip_tpu_torch.ops.kernels import _build
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


def _mlp_params(seed, skip_layer=4, depth=8):
    """The trunk's parameter tree (fc_uv, fc_uv_skip, trunk, output), drawn
    with numpy at roughly the model's init scales."""
    rng = np.random.default_rng(seed)

    def dense(k, n):
        return {"w": (rng.standard_normal((k, n)) * np.sqrt(2.0 / k)
                      ).astype(np.float32),
                "b": rng.uniform(-0.1, 0.1, n).astype(np.float32)}

    return {"fc_uv": dense(42, 256), "fc_uv_skip": dense(42, 256),
            "trunk": [dense(512 if i == skip_layer + 1 else 256, 256)
                      for i in range(depth)],
            "output": dense(256, 3)}


# (TPU kernel, N, frames, tile): K1 at a ragged N and at a tile multiple,
# K1b (one frame) ragged; tile 128 is the port's row tile
PALLAS_CASES = [("batched", 300, 2, 128), ("batched", 256, 3, 128),
                ("single", 200, 1, 128)]
# relative to max(1, max|ref|).  float32: bias folding and summation order
# differ over 9 layers (the XLA-trunk test's bound; measured <= 8.6e-7).
# bf16: the TPU kernel casts uv to float32 and keeps float32 activations
# between layers, the port rounds each layer to bf16 (measured <= 1.1e-2
# over these cases; the bound is ~3x that)
PALLAS_BOUND = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,n,frames,tile", PALLAS_CASES)
def test_fused_mlp_plain_matches_pallas_kernel(kernel, n, frames, tile,
                                               dtype):
    """K1 / K1b's plain version against the TPU kernels themselves,
    ``fused_mlp_batched`` and ``fused_mlp``, in Pallas interpret mode on
    the same numpy-seeded weights and inputs (in dtype)."""
    from jax.experimental.pallas import tpu as pltpu

    import speech2lip_tpu.ops.pallas.fused_mlp as jmlp

    tdt = dtype
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    params = _mlp_params(n)
    rng = np.random.default_rng(n + 1)
    uv = rng.uniform(-1, 1, (n, 42)).astype(np.float32)
    base = rng.standard_normal((frames, 256)).astype(np.float32)
    skip = rng.standard_normal((frames, 256)).astype(np.float32)
    # both sides see the same dtype-rounded weights and uv; biases float32
    cast = lambda a: np.asarray(jnp.asarray(a, jdt).astype(jnp.float32))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    for leaf in ([jp["fc_uv"], jp["fc_uv_skip"], jp["output"]]
                 + jp["trunk"]):
        leaf["b"] = leaf["b"].astype(jnp.float32)
    uv_j = jnp.asarray(uv, jdt)
    with pltpu.force_tpu_interpret_mode():
        if kernel == "batched":
            ref = jmlp.fused_mlp_batched(jp, uv_j, jnp.asarray(base),
                                         jnp.asarray(skip), tile=tile)
        else:
            ref = jmlp.fused_mlp(jp, uv_j, jnp.asarray(base[0]),
                                 jnp.asarray(skip[0]), tile=tile)[None]
    t = lambda a: torch.from_numpy(np.array(cast(a))).to(tdt)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    trunk = params["trunk"]
    got = kmlp.fused_mlp_plain(
        t(uv), f(params["fc_uv"]["b"] + base),
        f(params["fc_uv_skip"]["b"] + skip), t(params["fc_uv"]["w"]),
        t(params["fc_uv_skip"]["w"]), [t(l["w"]) for l in trunk],
        [f(l["b"]) for l in trunk], t(params["output"]["w"]),
        f(params["output"]["b"]))
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape == (frames, n, 3)
    scale = max(1.0, float(np.abs(ref).max()))
    assert _err(got, ref) / scale < PALLAS_BOUND[dtype]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid_form", ["window", "interleaved", "points"])
def test_window_sample_plain_strided_equals_contiguous(dtype, grid_form):
    """The plain K2 on a crop view of a larger frame and on a window view of
    a larger grid (4-D; "interleaved": of a grid that holds the batch
    innermost, as the synthetic batch's broadcast grid does) or a slice of
    a larger point list (3-D) gives what it gives on contiguous copies, bit
    for bit."""
    rng = np.random.default_rng(3)
    frame = torch.from_numpy(rng.uniform(0, 1, (2, 60, 70, 3)).astype(
        np.float32)).to(dtype)
    src = frame[:, 11:40, 7:52]  # image[11:, 7:] of a 60 x 70 image
    coord = torch.from_numpy(rng.uniform(-1, 1, (2, 50, 64, 2)).astype(
        np.float32))
    if grid_form == "interleaved":
        coord = coord.permute(1, 2, 0, 3).contiguous().permute(2, 0, 1, 3)
    grid = (coord.reshape(2, -1, 2)[:, 100:900] if grid_form == "points"
            else coord[:, 3:30, 5:44])
    assert not (src.is_contiguous() or grid.is_contiguous())
    got = kws.window_sample(src, grid, 11, 7, 60, 70)
    ref = kws.window_sample_plain(src.contiguous(),
                                  grid.reshape(2, -1, 2).contiguous(), 11, 7,
                                  60, 70)
    assert got.shape == (2, grid[0, ..., 0].numel(), 3)
    assert got.dtype == dtype and torch.equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_post_fusion_composite_window_matches_jax(interp, dtype):
    """The composite's window branch with K2 on (the port reads the crop
    and the window in place, JAX copies both into its Pallas kernel, run
    in interpret mode) against JAX, in float32 and bf16."""
    from speech2lip_tpu.data.synthetic import synthetic_batch
    from speech2lip_tpu.data.windows import compute_warp_window
    from speech2lip_tpu_torch.models import talking_face as ttf

    face, lip_h, lip_w, b = 64, 16, 24, 2
    raw, geo = synthetic_batch(b, face=face, lip_h=lip_h, lip_w=lip_w)
    box = jtf.expanded_lip_box(lip_h, lip_w, geo["lip_x"], geo["lip_y"])
    window = compute_warp_window([raw["coord"][i] for i in range(b)], box,
                                 face, face, margin=4)
    rng = np.random.default_rng(4)
    rgb_lip = rng.uniform(0, 1, (b, lip_h, lip_w, 3)).astype(np.float32)
    ins = [rgb_lip] + [raw[k] for k in ("rgb_face_zero", "rgb_face_ori",
                                        "mask_lip_canonical")]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref, _, _ = jtf.post_fusion_composite(
        *[jnp.asarray(x, jdt) for x in ins], jnp.asarray(raw["coord"]),
        geo["lip_x"], geo["lip_y"], window=window, use_pallas=True)
    before = kws.launches
    got, _, _ = ttf.post_fusion_composite(
        *[torch.from_numpy(x).to(tdt) for x in ins],
        torch.from_numpy(raw["coord"]), geo["lip_x"], geo["lip_y"],
        window=window, use_kernels=True)
    assert kws.launches == before and got.dtype == tdt
    # float32: the same hat weights, contracted as a matmul in JAX; bf16:
    # the sample and the blend round at other places (a few bf16 ulps)
    assert _err(got, ref) < (1e-5 if dtype == "float32" else 1e-2)


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


@pytest.mark.parametrize("size,lo_size", [((13, 19), (6, 9)),
                                           ((9, 14), (5, 7))])
def test_fused_block_plain_matches_jax_stages_upsampled_pooled(size, lo_size):
    """The plain block, the oracle the kernel is held to on the card, at an
    odd, non-square size with an upsample source and a pool (floor(H/2) x
    floor(W/2)), against the JAX stages: align-corners upsample, concat
    after x, DoubleConv, 2x2 max pool."""
    jp, js = unet_params(64)
    _, up, us = weights.from_jax(_tf_params(), jp, js)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, *size, 64)).astype(np.float32)
    lo = rng.uniform(0, 1, (2, *lo_size, 64)).astype(np.float32)
    jin = jnp.concatenate([jnp.asarray(x), jnn.upsample_bilinear(
        jnp.asarray(lo), *size)], axis=-1)
    jout = _jblock(jp["up2"], js["up2"], jin)
    before = kfb.launches
    got, pooled = kfb.fused_block(torch.from_numpy(x),
                                  *_fused_args(up, us, "up2"),
                                  up=torch.from_numpy(lo), pool=True)
    assert kfb.launches == before == 0
    assert pooled.shape == (2, size[0] // 2, size[1] // 2, 64)
    # float32 3x3 convs; BN folded in a different order than JAX applies it
    assert _err(got, jout) < 1e-4
    assert _err(pooled, jnn.maxpool2d(jout)) < 1e-4


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


ROOT = Path(__file__).resolve().parents[1]


def _fused_block_source() -> str:
    return (_build.CSRC / "fused_block.cu").read_text()


def test_fused_block_kernels_keep_the_name_their_roofline_reads():
    """The bf16 body (namespace hb of csrc/fused_block.cu), which every
    bf16 K3, K4 and K6 launch reaches, names each of its kernels with the
    pattern ``fused_block_roofline`` finds them by in a device trace, and
    launches nothing else: a rename cannot silently empty the metric."""
    spec = importlib.util.spec_from_file_location(
        "fused_block_roofline",
        ROOT / "portbench" / "metrics" / "fused_block_roofline.py")
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    src = _fused_block_source()
    hb = src[src.index("namespace hb {"):src.index("}  // namespace hb")]
    kernels = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(", hb)
    launched = re.findall(r"(\w+)(?:<[^<>;]*>)?\s*<<<", hb)
    assert kernels and launched
    assert all(metric.PATTERN in k for k in kernels), kernels
    assert set(launched) <= set(kernels), launched
    # the bf16 entry points reach the body through launch<T>
    assert "hb::launch(a, cout, s)" in src


def test_fused_block_defines_the_entry_points_it_is_bound_by():
    """Every ``conv3x3_*`` C entry point ``_build`` binds is defined in
    csrc/fused_block.cu with the number of arguments it binds."""
    src = _fused_block_source()
    names = [n for n in _build.SIGNATURES if n.startswith("conv3x3_")]
    assert len(names) == 5
    for name in names:
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        assert len(m.group(1).split(",")) == len(_build.SIGNATURES[name]), name
