"""The port's first slice (speech2lip_tpu_torch.infer.renderer) against the
JAX renderer: same parameters (JAX init through ``weights.from_jax``), same
synthetic batch, on the CPU.  Face 64, lip 16x24, 2 frames, the full
256-wide MLP, the U-Net at base 16.  Face 66 (``ODD``, not a multiple of 4)
is where the kernel path's U-Net is the plain forward, as in the JAX
renderer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.data.synthetic import synthetic_batch
from speech2lip_tpu.data.windows import compute_warp_window
from speech2lip_tpu.infer import renderer as jrender
from speech2lip_tpu.models import talking_face as jtf
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.config import default_config
from speech2lip_tpu_torch.infer import renderer as trender
from speech2lip_tpu_torch.models import talking_face as ttf
from speech2lip_tpu_torch.ops.kernels import fused_block, fused_mlp, \
    window_sample
from test_torch_kernels import _tf_params, unet_params

torch.set_num_threads(2)

FACE, LIP_H, LIP_W, B = 64, 16, 24, 2
ODD = 66


@functools.lru_cache(maxsize=None)
def _setup(face):
    raw, geo = synthetic_batch(B, face=face, lip_h=LIP_H, lip_w=LIP_W)
    box = jtf.expanded_lip_box(LIP_H, LIP_W, geo["lip_x"], geo["lip_y"])
    window = compute_warp_window([raw["coord"][i] for i in range(B)], box,
                                 face, face, margin=4)
    jp = _tf_params(1)
    jup, jus = unet_params(16, seed=1)
    return raw, geo, window, (jp, jup, jus)


@pytest.fixture(scope="module")
def setup():
    return _setup(FACE)


def _jax_render(setup, window, dtype=jnp.float32):
    raw, geo, _, (jp, jup, jus) = setup
    if dtype != jnp.float32:
        cast = lambda t: jax.tree.map(lambda x: jnp.asarray(x, dtype), t)
        jp, jup, jus = cast(jp), cast(jup), cast(jus)
    out = jrender.render_face_batch(
        jp, jup, jus, jax.tree.map(jnp.asarray, raw), lip_x=geo["lip_x"],
        lip_y=geo["lip_y"], lip_h=LIP_H, lip_w=LIP_W, use_pallas=False,
        compute_dtype=dtype, window=window)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _torch_batch(raw):
    return {k: torch.from_numpy(np.array(v)) for k, v in raw.items()}


def _err(got, ref):
    got = got.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.max(np.abs(got - ref)))


@pytest.mark.parametrize("use_window", [True, False])
@pytest.mark.parametrize("use_kernels,face", [
    pytest.param(False, FACE, id="False"), pytest.param(True, FACE, id="True"),
    pytest.param(True, ODD, id=f"True-{ODD}")])
def test_render_face_batch_matches_jax(use_window, use_kernels, face):
    setup = _setup(face)
    raw, geo, window, jparams = setup
    window = window if use_window else None
    assert not use_window or window is not None
    ref = _jax_render(setup, window)
    params = weights.from_jax(*jparams)
    got = trender.render_face_batch(
        *params, _torch_batch(raw), lip_x=geo["lip_x"], lip_y=geo["lip_y"],
        lip_h=LIP_H, lip_w=LIP_W, use_kernels=use_kernels, window=window)
    # float32 end to end: MLP (9 layers), composite, U-Net (10 convs)
    assert _err(got["lip"], ref["lip"]) < 5e-5
    assert _err(got["face"], ref["face"]) < 1e-4


def _renderer(setup, dtype):
    raw, geo, window, jparams = setup
    cfg = default_config()
    cfg["data"].update(height=LIP_H, width=LIP_W)
    cfg["model"]["compute_dtype"] = dtype
    return trender.Renderer(cfg, *weights.from_jax(*jparams), device="cpu",
                            window=window)


@pytest.mark.parametrize("face", [FACE, ODD])
def test_renderer_float32_matches_jax_and_launches_nothing(face):
    setup = _setup(face)
    raw, geo, window, _ = setup
    ref = _jax_render(setup, window)
    before = (fused_mlp.launches, window_sample.launches, fused_block.launches)
    got = _renderer(setup, "float32")(_torch_batch(raw), geo["lip_x"],
                                      geo["lip_y"])
    assert _err(got["lip"], ref["lip"]) < 5e-5
    assert _err(got["face"], ref["face"]) < 1e-4
    # on the CPU the wrappers run their plain versions
    assert (fused_mlp.launches, window_sample.launches,
            fused_block.launches) == before == (0, 0, 0)


def test_renderer_bfloat16_near_jax(setup):
    raw, geo, window, _ = setup
    ref = _jax_render(setup, window, jnp.bfloat16)
    r = _renderer(setup, "bfloat16")
    assert r.params[0]["trunk"][0]["w"].dtype == torch.bfloat16
    got = r(_torch_batch(raw), geo["lip_x"], geo["lip_y"])
    # bf16 rounds at other places in the two packages (the port sums in
    # float32 inside K1/K3); the JAX bench's face bound
    assert _err(got["lip"], ref["lip"]) < 5e-2
    assert _err(got["face"], ref["face"]) < 5e-2


def test_post_fusion_window_equals_full_frame(setup):
    raw, geo, window, jparams = setup
    tb = _torch_batch(raw)
    rgb_lip = torch.rand(B, LIP_H, LIP_W, 3,
                         generator=torch.Generator().manual_seed(0))
    args = (rgb_lip, tb["rgb_face_zero"], tb["rgb_face_ori"],
            tb["mask_lip_canonical"], tb["coord"], geo["lip_x"], geo["lip_y"])
    full, _, _ = ttf.post_fusion_composite(*args)
    for use_kernels in (False, True):
        win, _, _ = ttf.post_fusion_composite(*args, window=window,
                                              use_kernels=use_kernels)
        assert float((win - full).abs().max()) < 1e-5


def test_audio_encoder_and_frame_features(setup):
    raw, _, _, (jp, _, _) = setup
    tp = weights.from_jax(*setup[3])[0]
    audio = raw["audio"]
    jcodes = jtf.encode_audio(jp, jnp.asarray(audio))
    codes = ttf.encode_audio(tp, torch.from_numpy(audio))
    assert _err(codes, np.asarray(jcodes)) < 1e-5   # float32, 6 layers
    idx = np.array([0, 7], np.float32)
    jb, js = jrender.batched_frame_feature(jp, jcodes, jnp.asarray(idx))
    tb, ts = trender.batched_frame_feature(tp, codes, torch.from_numpy(idx))
    assert _err(tb, np.asarray(jb)) < 1e-5
    assert _err(ts, np.asarray(js)) < 1e-5
    # the single-frame form gives the batched form's row
    fb, fs = ttf.frame_feature(tp, codes[1:2], torch.tensor(7.0))
    assert float((fb - tb[1:2]).abs().max()) < 1e-6
    assert float((fs - ts[1:2]).abs().max()) < 1e-6
