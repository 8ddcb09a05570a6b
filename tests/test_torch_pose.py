"""The port's pose editing, forward splat and video export against the
JAX package, on inputs made from a numpy seed: ``ops/splat.py``,
``infer/pose_edit.py``, ``preprocess/video_io.py`` and ``cli/infer``'s
``--change_pose`` / ``--export_video``.

Tolerances: the splat is exact on shared flow and z (integer targets,
min / max reductions).  The whole warp computes its targets in float32
geometry in each package, and a target at a half pixel can round the
other way, so it is held to a share of mismatched pixels (``WARP_SHARE``)
with the matched pixels within ``F32``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.infer import pose_edit as jpe
from speech2lip_tpu.ops import splat as jsplat
from speech2lip_tpu.preprocess import video_io as jvio
from speech2lip_tpu_torch.infer import pose_edit as tpe
from speech2lip_tpu_torch.ops import splat as tsplat
from speech2lip_tpu_torch.preprocess import video_io as tvio

torch.set_num_threads(2)

F32 = 1e-5          # float32, matched pixels and the U-Net's output
WARP_SHARE = 0.01   # share of pixels a whole warp may place elsewhere
REL_POSE = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _splat_inputs(seed, b=2, h=9, w=11, c=3):
    """Flows that send many sources onto one target (collisions), some
    off the image, some at exact half pixels (round half to even)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.5, 1, (b, h, w, c)).astype(np.float32)
    flow = rng.integers(-3, 4, (b, h, w, 2)).astype(np.float32)
    flow += rng.choice([0.0, 0.5, -0.5, 0.25], (b, h, w, 2)).astype(
        np.float32)
    flow[:, 0, :3] = 40.0          # out of range
    z = rng.choice([1.0, 2.0, 3.0], (b, h, w)).astype(np.float32)  # ties
    return src, flow, z


@pytest.mark.parametrize("with_z", [True, False])
def test_forward_splat_nearest_exact(with_z):
    src, flow, z = _splat_inputs(0)
    zz = z if with_z else None
    ref = np.asarray(jsplat.forward_splat_nearest(
        jnp.asarray(src), jnp.asarray(flow),
        None if zz is None else jnp.asarray(zz)))
    got = tsplat.forward_splat_nearest(_t(src), _t(flow),
                                       None if zz is None else _t(zz))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == 0).any() and (ref != 0).any()


def test_splat_depth_exact():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-3, 14, (300, 2)).astype(np.float32)
    pts[:20] = np.round(pts[:20]) + 0.5           # half pixels
    z = rng.uniform(-0.5, 3, 300).astype(np.float32)
    ref = np.asarray(jsplat.splat_depth(jnp.asarray(pts), jnp.asarray(z),
                                        10, 12))
    got = tsplat.splat_depth(_t(pts), _t(z), 10, 12).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (ref > 0).any() and (ref == 0).any()


@pytest.mark.parametrize("edit,index,value", [("euler", 1, 0.2),
                                              ("trans", 0, 0.3),
                                              ("trans", 2, 2.5)])
def test_edited_rel_pose(edit, index, value):
    rng = np.random.default_rng(2)
    e = (0.1 * rng.standard_normal(3)).astype(np.float32)
    t = np.array([0.02, -0.01, 2.1], np.float32)
    ref = np.asarray(jpe.edited_rel_pose(e, t, edit, index, value))
    got = tpe.edited_rel_pose(_t(e), _t(t), edit, index, value).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL_POSE)
    both = tpe.edited_rel_pose(_t(np.stack([e, e])), _t(np.stack([t, t])),
                               edit, index, value).numpy()
    np.testing.assert_array_equal(both[0], got)
    with pytest.raises(ValueError):
        tpe.edited_rel_pose(_t(e), _t(t), "scale", 0, 1.0)


def _share_off(got, ref, tol=F32):
    """Share of pixels whose channels differ by more than ``tol``, and the
    largest difference among the others."""
    d = np.abs(got - ref).max(-1)
    off = d > tol
    return off.mean(), d[~off].max()


def test_forward_warp_to_pose_matches_jax():
    h, w = 40, 48
    rng = np.random.default_rng(3)
    depth = rng.uniform(1.8, 2.2, (h, w)).astype(np.float32)
    depth[:5] = 0.0                                    # holes
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    e = np.zeros(3, np.float32)
    t = np.array([0, 0, 2.0], np.float32)
    for edit, axis, value in (("euler", 1, 0.15), ("trans", 0, 0.2)):
        rel = jpe.edited_rel_pose(e, t, edit, axis, value)
        ref = np.asarray(jpe.forward_warp_to_pose(jnp.asarray(img),
                                                  jnp.asarray(depth), rel,
                                                  60.0))
        trel = tpe.edited_rel_pose(_t(e), _t(t), edit, axis, value)
        got = tpe.forward_warp_to_pose(_t(img), _t(depth), trel, 60.0)
        share, worst = _share_off(got.numpy(), ref)
        assert share <= WARP_SHARE and worst <= F32, (edit, share, worst)
        assert (ref == 0).all(-1).mean() > 0.05       # holes and disocclusion
        batched = tpe.forward_warp_to_pose(_t(np.stack([img, img])),
                                           _t(depth), trel[None].repeat(
                                               2, 1, 1), 60.0)
        np.testing.assert_array_equal(batched[1].numpy(), got.numpy())


def _jax_models(cfg, seed):
    from speech2lip_tpu.models import talking_face as jtf
    from speech2lip_tpu.models import unet_light as junet
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    p = jax.tree.map(np.asarray, jtf.init(k1, cfg))
    up, us = jax.tree.map(np.asarray, junet.init(k2))
    rng = np.random.default_rng(seed)
    p["canonical_depth"] = rng.uniform(
        1.9, 2.1, p["canonical_depth"].shape).astype(np.float32)
    return p, up, us


@pytest.mark.parametrize("face", [48, 66])
def test_render_pose_edited_batch_matches_jax(face):
    """Both paths against the JAX function; at 66 (not a multiple of 4)
    the kernel path's U-Net is the plain forward, as in the JAX renderer."""
    from speech2lip_tpu.core.config import default_config
    from speech2lip_tpu.data.synthetic import synthetic_batch
    from speech2lip_tpu_torch import weights

    lip = 16
    cfg = default_config()
    cfg["model"]["canonical_depth_height"] = face
    cfg["model"]["canonical_depth_width"] = face
    p, up, us = _jax_models(cfg, 4)
    batch, geo = synthetic_batch(2, face=face, lip_h=lip, lip_w=lip)
    kw = dict(lip_x=geo["lip_x"], lip_y=geo["lip_y"], lip_h=lip, lip_w=lip,
              focal=geo["focal"], edit="euler", axis=1, value=0.1)
    ref = np.asarray(jpe.render_pose_edited_batch(
        p, up, us, jax.tree.map(jnp.asarray, batch), **kw))
    tp = weights.from_jax(p, up, us)
    tb = {k: _t(v) for k, v in batch.items()}
    for use_kernels in (False, True):
        got = tpe.render_pose_edited_batch(*tp, tb, use_kernels=use_kernels,
                                           **kw).numpy()
        assert got.shape == ref.shape == (2, face, face, 3)
        # a target that rounds the other way moves one pixel of the
        # U-Net's input, which the U-Net spreads over its receptive field
        share, worst = _share_off(got, ref)
        assert share <= WARP_SHARE and worst <= F32, (use_kernels, share,
                                                      worst)


def test_write_avi_byte_identical_and_demux_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
              for _ in range(5)]
    audio = (rng.standard_normal(3200) * 3000).astype(np.int16)
    for name, a in (("pcm", audio), ("float", audio / 40000.0),
                    ("mute", None)):
        pj, pt = str(tmp_path / f"j_{name}.avi"), str(tmp_path /
                                                     f"t_{name}.avi")
        jvio.write_avi(pj, frames, fps=25.0, audio=a)
        tvio.write_avi(pt, frames, fps=25.0, audio=a)
        assert open(pj, "rb").read() == open(pt, "rb").read(), name
        if a is None:
            with pytest.raises(ValueError, match="no PCM audio"):
                tvio.demux_avi_pcm(pt)
            continue
        sr, got = tvio.demux_avi_pcm(pt)
        assert sr == 16000
        want = a if a.dtype == np.int16 else (
            np.clip(a, -1, 1) * 32767.0).astype(np.int16)
        np.testing.assert_array_equal(got, want)
    wav = str(tmp_path / "x.wav")
    tvio.extract_wav(str(tmp_path / "t_pcm.avi"), wav)
    from scipy.io import wavfile
    assert np.array_equal(wavfile.read(wav)[1], audio)


def _identity(tmp_path, name, seed, mel=False, cfg_edit=None):
    """A synthetic identity tree, its config written by the port, and a
    checkpoint of seeded parameters written by the port."""
    from speech2lip_tpu_torch import config as tconfig
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.core import checkpoint as tckpt
    from speech2lip_tpu_torch.data import synthetic as tsyn

    root = str(tmp_path / name)
    geo = tsyn.make_synthetic_tree(root, n_frames=8, face=64, lip_h=16,
                                   lip_w=24, seed=seed)
    cfg = tsyn.synthetic_config(root, geo)
    cfg["model"]["use_audio_mel"] = mel
    cfg["training"]["out_dir"] = str(tmp_path / f"{name}_out")
    if cfg_edit:
        cfg_edit(cfg)
    p, up, us = weights.random_params(seed, cfg=cfg)
    tckpt.CheckpointManager(cfg["training"]["out_dir"]).save_latest(
        {"params": p, "unet_params": up, "unet_state": us, "it": 0}, it=0)
    path = str(tmp_path / f"{name}.yaml")
    tconfig.save_config(path, cfg)
    return path, cfg


def test_cli_infer_change_pose_and_export_video_match_jax(tmp_path,
                                                         monkeypatch):
    import sys

    from speech2lip_tpu.cli import infer as jinfer
    from speech2lip_tpu_torch.cli import infer as tinfer
    from speech2lip_tpu_torch.data import image_io

    path, cfg = _identity(tmp_path, "id", 6)
    monkeypatch.chdir(tmp_path)
    flags = ["--batch", "2", "--change_pose", "0.12", "--pose_edit",
             "euler", "--pose_axis", "1", "--export_video"]
    monkeypatch.setattr(sys, "argv", ["infer", path, "--output_dir", "jax",
                                      *flags])
    jinfer.main()
    res = tinfer.main([path, "--output_dir", "port", "--device", "cpu",
                       *flags])
    out = tmp_path / "rendering_result"
    names = sorted(os.listdir(out / "jax" / "postfusion"))
    assert sorted(os.listdir(out / "port" / "postfusion")) == names
    assert res["frames"] == len(names) == cfg["data"]["val_split_frames"]
    for n in names:
        a = image_io.imread_float(str(out / "jax" / "postfusion" / n))
        b = image_io.imread_float(str(out / "port" / "postfusion" / n))
        # JPEGs of uint8 frames that round alike: a level apart at most
        # where a float32 value sits at a rounding boundary
        assert np.abs(a - b).max() <= 2 / 255 and np.abs(a - b).mean() < 1e-3
    assert res["video"] == os.path.join("rendering_result", "port",
                                        "result.avi")
    sr_j, pcm_j = jvio.demux_avi_pcm(str(out / "jax" / "result.avi"))
    sr_t, pcm_t = tvio.demux_avi_pcm(str(out / "port" / "result.avi"))
    assert sr_j == sr_t and np.array_equal(pcm_j, pcm_t) and len(pcm_t) > 0
    import cv2
    cap = cv2.VideoCapture(str(out / "port" / "result.avi"))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == len(names)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pose_edit_renderer_is_the_function_on_cast_parameters(dtype):
    """``PoseEditRenderer`` (what cli/infer --change_pose serves with) is
    ``render_pose_edited_batch`` on the parameters cast once to the compute
    dtype, the canonical depth kept in float32: with K1 and K3 (their plain
    versions on the CPU) when called, with neither in ``render_plain``.
    Exact."""
    from speech2lip_tpu.core.config import default_config as jdefault
    from speech2lip_tpu.data.synthetic import synthetic_batch
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.config import default_config
    from speech2lip_tpu_torch.core.device import cast_tree

    face, lip = 48, 16
    jcfg = jdefault()
    jcfg["model"]["canonical_depth_height"] = face
    jcfg["model"]["canonical_depth_width"] = face
    tp = weights.from_jax(*_jax_models(jcfg, 5))
    batch, geo = synthetic_batch(2, face=face, lip_h=lip, lip_w=lip)
    tb = {k: _t(v) for k, v in batch.items()}
    cfg = default_config()
    cfg["model"]["compute_dtype"] = dtype
    cfg["data"]["face_img_focal"] = geo["focal"]
    r = tpe.PoseEditRenderer(cfg, *tp, lip_h=lip, lip_w=lip, edit="trans",
                             axis=0, value=0.2, device="cpu")
    cdt = getattr(torch, dtype)
    cast = [cast_tree(t, "cpu", cdt) for t in tp]
    cast[0]["canonical_depth"] = tp[0]["canonical_depth"].float()
    kw = dict(lip_x=geo["lip_x"], lip_y=geo["lip_y"], lip_h=lip, lip_w=lip,
              focal=geo["focal"], edit="trans", axis=0, value=0.2,
              compute_dtype=cdt)
    for use_kernels, got in (
            (True, r(tb, geo["lip_x"], geo["lip_y"])["face"]),
            (False, r.render_plain(tb, geo["lip_x"], geo["lip_y"])["face"])):
        ref = tpe.render_pose_edited_batch(*cast, tb,
                                           use_kernels=use_kernels, **kw)
        assert got.dtype == torch.float32 and torch.equal(got, ref)
    assert r.params[0]["canonical_depth"].dtype == torch.float32
