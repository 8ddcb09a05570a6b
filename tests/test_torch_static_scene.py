"""The port's static-scene serving renderer (speech2lip_tpu_torch.infer.
static_scene) against the JAX package's, on the CPU.

Inputs from the port's ``synthetic_batch`` and warp window; the same
parameters (JAX init through ``weights.from_jax``), lip 16x24, the full
256-wide MLP, the U-Net at base 16.  Face 64 gives no crop (the haloed
crop would cover the frame), face 160 a crop of 136x160.
"""

import numpy as np
import pytest
import torch

from speech2lip_tpu.core.config import default_config as jdefault_config
from speech2lip_tpu.infer import static_scene as jss
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.config import default_config
from speech2lip_tpu_torch.core.device import resolve_device
from speech2lip_tpu_torch.data.synthetic import synthetic_batch
from speech2lip_tpu_torch.data.windows import compute_warp_window
from speech2lip_tpu_torch.infer import renderer as trender
from speech2lip_tpu_torch.infer import static_scene as tss
from speech2lip_tpu_torch.models.talking_face import expanded_lip_box
from speech2lip_tpu_torch.ops.kernels import fused_block, fused_mlp, \
    window_sample
from test_torch_kernels import _tf_params, unet_params

torch.set_num_threads(2)

LIP_H, LIP_W, B = 16, 24, 2


def _launches():
    return (fused_mlp.launches, window_sample.launches, fused_block.launches)


@pytest.mark.parametrize("window,face", [
    ((300, 160, 120, 180), 500), ((390, 160, 90, 180), 500),
    ((2, 2, 30, 30), 100), ((100, 100, 50, 50), 499), ((88, 56, 40, 48), 160),
    ((24, 8, 40, 48), 64), ((5, 3, 17, 9), 96)])
def test_crop_geometry_matches_jax(window, face):
    assert (tss.HALO, tss.PASTE_MARGIN) == (jss.HALO, jss.PASTE_MARGIN)
    assert tss.crop_geometry(window, face, face) == \
        jss.crop_geometry(window, face, face)


def _scene(face):
    raw, geo = synthetic_batch(B, face=face, lip_h=LIP_H, lip_w=LIP_W)
    box = expanded_lip_box(LIP_H, LIP_W, geo["lip_x"], geo["lip_y"])
    window = compute_warp_window([raw["coord"][i] for i in range(B)], box,
                                 face, face, margin=4)
    base = {k: raw[k][0] for k in ("rgb_face_zero", "rgb_face_ori",
                                   "mask_lip_canonical", "coord")}
    return raw, geo, window, base


@pytest.fixture(scope="module")
def params():
    return _tf_params(1), *unet_params(16, seed=1)


def _port(params, face, use_kernels=False):
    raw, geo, window, base = _scene(face)
    cfg = default_config()
    cfg["data"].update(height=LIP_H, width=LIP_W)
    r = tss.StaticSceneRenderer(cfg, *weights.from_jax(*params), base,
                                window, geo["lip_x"], geo["lip_y"],
                                device="cpu", use_kernels=use_kernels)
    return r, raw


@pytest.mark.parametrize("face", [64, 160])
def test_plain_path_matches_jax(params, face):
    """float32: the crop path (face 160) and the full frame, both packages'
    plain paths (exact-2x upsampling)."""
    raw, geo, window, base = _scene(face)
    cfg = jdefault_config()
    cfg["data"]["height"], cfg["data"]["width"] = LIP_H, LIP_W
    jr = jss.StaticSceneRenderer(cfg, *params, base, window, geo["lip_x"],
                                 geo["lip_y"], use_pallas=False)
    t = np.array([0.0, 7.0], np.float32)
    r, _ = _port(params, face)
    assert r.compute_dtype == torch.float32 and not r.use_kernels
    assert r.geo == jr.geo and (r.geo is None) == (face == 64)
    before = _launches()
    for got, ref in ((r(raw["audio"], t), jr(raw["audio"], t)),
                     (r.render_full(raw["audio"], t),
                      jr.render_full(raw["audio"], t))):
        ref = np.asarray(ref)
        assert got.shape == ref.shape == (B, face, face, 3)
        # float32: MLP, composite and the U-Net's 10 convs, summed in
        # another order
        assert float(np.max(np.abs(got.numpy() - ref))) < 1e-5
    assert _launches() == before


def test_crop_interior_equals_full_frame(params):
    """The crop path reproduces the full frame on the plain path (float32,
    translation-equivariant upsampling), and audio drives the window while
    the exterior is the shared static face."""
    r, raw = _port(params, 160)
    g = r.geo
    assert g is not None and g["ch"] * g["cw"] < 0.9 * 160 * 160
    t = np.array([0.0, 7.0], np.float32)
    fast = r(raw["audio"], t)
    full = r.render_full(raw["audio"], t)
    assert float((fast - full).abs().max()) < 1e-5
    assert float((fast[0] - fast[1]).abs().max()) > 1e-5
    assert torch.equal(fast[:, :g["iy0"]],
                       r.static_face.float().expand(B, -1, -1, -1)[
                           :, :g["iy0"]])


def test_kernel_path_on_cpu_runs_plain_versions(params):
    """With kernels on the CPU the wrappers run their plain versions and
    launch nothing; the kernel path serves bf16 and its full frame is the
    port's align-corners renderer in bf16."""
    before = _launches()
    r, raw = _port(params, 160, use_kernels=True)
    assert r.compute_dtype == torch.bfloat16 and r.use_kernels
    t = np.array([0.0, 7.0], np.float32)
    fast = r(raw["audio"], t)
    full = r.render_full(raw["audio"], t)
    assert _launches() == before == (0, 0, 0)
    assert torch.isfinite(fast).all() and fast.shape == (B, 160, 160, 3)
    cfg = default_config()
    cfg["data"].update(height=LIP_H, width=LIP_W)
    cfg["model"]["compute_dtype"] = "bfloat16"
    _, _, window, _ = _scene(160)
    ren = trender.Renderer(cfg, *weights.from_jax(*params), device="cpu",
                           window=window)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in raw.items()}
    batch["index"] = torch.from_numpy(t)
    ref = ren(batch, r.lip_x, r.lip_y)["face"]
    # the same bf16 ops on the same inputs, but rgb_face_zero / ori and the
    # mask come from frame 0 for both frames here
    frame0 = float((full[0] - ref[0]).abs().max())
    assert frame0 < 1e-6, frame0
    # align-corners on the crop is not translation-equivariant: the crop's
    # interior and the full frame differ (a behaviour of the reference)
    assert not torch.equal(fast, full)


def _jax_align_corners(params):
    """The kernel path's crop (K3 semantics: align-corners upsampling on the
    non-square crop) in JAX: its plain composite in float32, its plain
    align-corners ``unet_light.apply`` on the same crop, the interior
    pasted into the full frame's output of the canonical scene.  Returns
    (reference, inputs, time indices, the JAX renderer's crop geometry)."""
    import jax.numpy as jnp

    from speech2lip_tpu.models import unet_light as junet

    raw, geo, window, base = _scene(160)
    cfg = jdefault_config()
    cfg["data"]["height"], cfg["data"]["width"] = LIP_H, LIP_W
    jr = jss.StaticSceneRenderer(cfg, *params, base, window, geo["lip_x"],
                                 geo["lip_y"], use_pallas=False)
    t = np.array([0.0, 7.0], np.float32)
    g = jr.geo
    assert g is not None and g["ch"] != g["cw"]
    unet_in = jss._composite(
        jr.params, jr.unet_params, jr.unet_state, jr.scene, jr.coord,
        jnp.asarray(raw["audio"]), jnp.asarray(t), lip_h=LIP_H, lip_w=LIP_W,
        lip_x=jr.lip_x, lip_y=jr.lip_y, window=jr.window,
        expand_divisor=jr.expand_divisor, use_pallas=False, cdt=jnp.float32)
    crop = unet_in[:, g["cy0"]:g["cy0"] + g["ch"], g["cx0"]:g["cx0"] + g["cw"]]
    out, _ = junet.apply(jr.unet_params, jr.unet_state, crop)
    ref, _ = junet.apply(jr.unet_params, jr.unet_state, jr.scene[1])
    y0, x0 = g["iy0"] - g["cy0"], g["ix0"] - g["cx0"]
    ref = np.repeat(np.asarray(ref), B, axis=0)
    ref[:, g["iy0"]:g["iy0"] + g["ih"], g["ix0"]:g["ix0"] + g["iw"]] = \
        np.asarray(out)[:, y0:y0 + g["ih"], x0:x0 + g["iw"]]
    return ref, raw, t, g


def test_kernel_path_matches_jax_align_corners(params):
    """The kernel path in bf16 against the JAX align-corners reference in
    float32 (``_jax_align_corners``)."""
    ref, raw, t, g = _jax_align_corners(params)
    r, _ = _port(params, 160, use_kernels=True)
    assert r.geo == g
    got = r(raw["audio"], t).numpy()
    # bf16 through the whole path (MLP, composite, five K3 blocks) against
    # float32: the measured gap is 0.0048 of max|ref|
    err = float(np.max(np.abs(got - ref))) / float(np.max(np.abs(ref)))
    assert err < 2e-2, err


def test_render_plain_is_the_align_corners_path(params):
    """``render_plain``, the reference the card's kernel path is held to,
    is the JAX align-corners path in float32 to 1e-5 and launches nothing;
    so is the kernel path in float32 (the wrappers' plain versions)."""
    ref, raw, t, g = _jax_align_corners(params)
    _, geo, window, base = _scene(160)
    cfg = default_config()
    cfg["data"].update(height=LIP_H, width=LIP_W)
    r = tss.StaticSceneRenderer(cfg, *weights.from_jax(*params), base,
                                window, geo["lip_x"], geo["lip_y"],
                                device="cpu", use_kernels=True,
                                compute_dtype=torch.float32)
    assert r.geo == g and r.compute_dtype == torch.float32
    before = _launches()
    plain = r.render_plain(raw["audio"], t).numpy()
    assert _launches() == before
    np.testing.assert_allclose(plain, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r(raw["audio"], t).numpy(), ref, rtol=1e-5,
                               atol=1e-5)


def test_renderers_default_to_the_card(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw, geo, window, base = _scene(64)
    cfg = default_config()
    cfg["data"].update(height=LIP_H, width=LIP_W)
    p = weights.from_jax(*params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tss.StaticSceneRenderer(cfg, *p, base, window, geo["lip_x"],
                                geo["lip_y"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trender.Renderer(cfg, *p)
    assert resolve_device("cpu") == torch.device("cpu")
    # the card serves the kernel path only (checked before any tensor moves)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="use_kernels=False"):
        tss.StaticSceneRenderer(cfg, *p, base, window, geo["lip_x"],
                                geo["lip_y"], use_kernels=False)
