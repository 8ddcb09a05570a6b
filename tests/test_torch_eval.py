"""The port's evaluation slice (speech2lip_tpu_torch.train.metrics_eval,
models.tiny_landmarks, models.syncnet's train mode, cli.evaluate) against
the JAX package's, on the CPU.

Bounds: PSNR, SSIM and the edge widths / CPBD in float64 on both sides,
PSNR/SSIM to 1e-9 relative (SSIM's sums are a direct conv here, an FFT
there; measured ~2e-13), the widths and CPBD equal.  LMD to 1e-9 relative
on the same landmarks.  The tiny detector in float32 to 1e-3 px (measured
~1e-4).  The SyncNet confidence to 1e-4 with its offset equal.  The
train-mode SyncNet to 1e-5 on a batch of 16: float32 convs in another
order, amplified by the batch statistics of the 1x1 late layers (measured
~4e-6; ~2.5e-5 on a batch of 4).  The CLIs: every JSON key within the
bound of its metric.
"""

import json
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.cli import evaluate as jevaluate
from speech2lip_tpu.core import checkpoint as jckpt
from speech2lip_tpu.data.synthetic import make_learnable_tree
from speech2lip_tpu.models import syncnet as jsyncnet
from speech2lip_tpu.models import tiny_landmarks as jtl
from speech2lip_tpu.train import metrics_eval as jme
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.cli import evaluate as tevaluate
from speech2lip_tpu_torch.config import save_config
from speech2lip_tpu_torch.core import checkpoint as tckpt
from speech2lip_tpu_torch.data.synthetic import synthetic_config
from speech2lip_tpu_torch.models import syncnet as tsyncnet
from speech2lip_tpu_torch.models import tiny_landmarks as ttl
from speech2lip_tpu_torch.train import metrics_eval as tme

torch.set_num_threads(2)

REL = 1e-9          # PSNR / SSIM / LMD, float64 on both sides
LMS_TOL = 1e-3      # px, the tiny detector in float32
SYNC_TOL = 1e-4     # the sync confidence
TRAIN_TOL = 1e-5    # train-mode SyncNet embeddings and BN state
T = lambda a: torch.from_numpy(np.asarray(a))
to_np = lambda tree: jax.tree.map(np.asarray, tree)


def _pairs():
    """(name, [N, H, W(, C)] a, b) batches of seeded sharp, noisy and
    blurred images, as tests/test_aux_components.py draws them."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (64, 64, 3))
    noisy = img + rng.standard_normal(img.shape) * 20
    sharp = (np.indices((128, 128)).sum(0) % 16 < 8).astype(np.float64) * 255
    blurred = cv2.GaussianBlur(sharp, (15, 15), 5.0)
    color = rng.uniform(0, 255, (128, 192, 3))
    smooth = cv2.GaussianBlur(color, (7, 7), 2.0)
    return [("rgb 64", np.stack([img, img]), np.stack([img, noisy])),
            ("gray 128", np.stack([sharp, sharp]), np.stack([blurred, sharp])),
            ("rgb 128x192", np.stack([color, smooth]),
             np.stack([smooth, smooth]))]


@pytest.mark.parametrize("metric", ["psnr", "ssim"])
def test_psnr_ssim_match_jax(metric):
    for name, a, b in _pairs():
        got = getattr(tme, metric)(T(a), T(b)).numpy()
        want = np.array([getattr(jme, metric)(x, y) for x, y in zip(a, b)])
        np.testing.assert_allclose(got, want, rtol=REL, atol=0,
                                   err_msg=name)
    assert float(tme.psnr(T(a[:1]), T(a[:1]))[0]) == 100.0


def test_cpbd_matches_jax():
    """Sharp, blurred, gray and 3-channel frames, with edge blocks and
    without: CPBD equal (the same integer counts)."""
    vals = []
    for name, a, b in _pairs():
        for x in (a, b):
            got = tme.cpbd(T(x)).numpy()
            want = np.array([jme.cpbd(f) for f in x])
            np.testing.assert_array_equal(got, want, err_msg=name)
            vals += list(want)
    assert len(set(vals)) > 3, vals


def test_edge_widths_match_jax():
    """The random, smooth, plateau and checkerboard rows of
    tests/test_aux_components.py, with all-edge and random edge masks."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (48, 64))
    plateau = img.copy()
    plateau[:, 20:30] = 128.0
    board = (np.indices((48, 64)).sum(0) % 8 < 4) * 255.0
    images = np.stack([img, cv2.GaussianBlur(img, (7, 7), 2.0), plateau,
                       board])
    for edge in (np.ones_like(images, bool),
                 rng.uniform(0, 1, images.shape) > 0.7):
        got = tme._edge_widths(T(images), T(edge)).numpy()
        want = np.stack([jme._edge_widths(x, e)
                         for x, e in zip(images, edge)])
        np.testing.assert_array_equal(got, want)
        assert want.max() > 1


def test_lmd_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 100, (5, 68, 2))
    for b, mouth in ((a, True), (a + 2.0, True),
                     (a + rng.standard_normal(a.shape), True),
                     (a + rng.standard_normal(a.shape), False)):
        got = float(tme.lmd(T(a), T(b), mouth_only=mouth))
        assert got == pytest.approx(jme.lmd(a, b, mouth_only=mouth),
                                    rel=REL, abs=0)


@pytest.mark.parametrize("max_offset", [3, 15])
def test_sync_confidence_matches_jax(max_offset):
    """Seeded JAX weights moved over; 8 windows, so at max_offset 15 most
    offsets have no overlap and score -1, as in the JAX package."""
    p, s = jsyncnet.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    mels = rng.standard_normal((8, 80, 16)).astype(np.float32)
    faces = rng.uniform(0, 1, (8, 48, 96, 15)).astype(np.float32)
    want = jme.sync_confidence(p, s, mels, faces, max_offset=max_offset)
    tp, ts = weights.syncnet_from_jax(to_np(p), to_np(s))
    got = tme.sync_confidence(tp, ts, T(mels), T(faces),
                              max_offset=max_offset, chunk=3)
    assert got[1] == want[1]
    assert got[0] == pytest.approx(want[0], abs=SYNC_TOL)


@pytest.fixture(scope="module")
def tiny():
    assert os.path.exists(ttl.CKPT)
    jp, _ = jckpt.load(ttl.CKPT, like=jtl.init(jax.random.PRNGKey(0)))
    return jp, ttl.load(ttl.CKPT)


def test_tiny_landmarks_apply_matches_jax(tiny):
    jp, tp = tiny
    imgs = np.random.default_rng(4).uniform(0, 1, (3, 96, 96, 3)).astype(
        np.float32)
    got = ttl.apply(tp, T(imgs)).numpy()
    want = np.asarray(jtl.apply(jp, jnp.asarray(imgs)))
    assert got.shape == (3, 68, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=LMS_TOL)


@pytest.mark.parametrize("hw", [(96, 96), (192, 288)])
def test_tiny_landmarks_detect_matches_jax(tiny, hw):
    """192x288 goes through the antialiased shrink to 96² and the (0, 1)
    SAME padding of the stride-2 convs."""
    jp, tp = tiny
    frames = np.random.default_rng(5).uniform(0, 1, (2, *hw, 3)).astype(
        np.float32)
    got = ttl.detect(tp, T(frames)).numpy()
    for g, f in zip(got, frames):
        np.testing.assert_allclose(
            g, np.asarray(jtl.detect(jp, jnp.asarray(f))), rtol=0,
            atol=LMS_TOL)


def test_tiny_landmarks_load_checks_keys(tmp_path):
    flat, _ = tckpt.load(ttl.CKPT)
    bad = str(tmp_path / "bad.ckpt")
    with open(bad, "wb") as f:
        np.savez(f, __scalars__="{}",
                 **{k: v for k, v in flat.items() if k != "fc1/w"})
    with pytest.raises(ValueError, match="fc1/w"):
        ttl.load(bad)


def test_syncnet_apply_train_matches_jax():
    p, s = jsyncnet.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(6)
    mel = rng.standard_normal((16, 80, 16, 1)).astype(np.float32)
    faces = rng.uniform(0, 1, (16, 48, 96, 15)).astype(np.float32)
    a, v, ns = jsyncnet.apply(p, s, jnp.asarray(mel), jnp.asarray(faces),
                              train=True)
    tp, ts = weights.syncnet_from_jax(to_np(p), to_np(s))
    ta, tv, tns = tsyncnet.apply_train(tp, ts, T(mel), T(faces))
    np.testing.assert_allclose(ta.numpy(), np.asarray(a), atol=TRAIN_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), atol=TRAIN_TOL)
    want, got = jckpt._flatten(to_np(ns)), tckpt.flatten(tns)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TRAIN_TOL,
                                   atol=TRAIN_TOL, err_msg=k)
    # eval mode is unchanged by the train-mode path
    got = tsyncnet.apply(tp, ts, T(mel), T(faces))
    want = jsyncnet.apply(p, s, jnp.asarray(mel), jnp.asarray(faces))[:2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TRAIN_TOL)


# -- cli/evaluate ------------------------------------------------------------

@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """A learnable identity (24 frames at 128², so CPBD has 64² blocks),
    12 "rendered" frames (its frames 8..19 blurred and noised, as JPEGs),
    .lms files for both, a config and a teacher saved by the JAX side."""
    tmp = tmp_path_factory.mktemp("eval")
    root = str(tmp / "identity")
    geo = make_learnable_tree(root, n_frames=24, face=128, lip_h=16,
                              lip_w=24)
    gt = os.path.join(root, "ori_images_face")
    pred, lms_p, lms_g = (str(tmp / d) for d in ("pred", "lms_p", "lms_g"))
    for d in (pred, lms_p, lms_g):
        os.makedirs(d)
    rng = np.random.default_rng(7)
    names = sorted(os.listdir(gt))
    for i in range(12):
        img = cv2.imread(os.path.join(gt, names[8 + i])).astype(np.float64)
        img = cv2.GaussianBlur(img, (5, 5), 1.0 + 0.1 * i)
        img += rng.standard_normal(img.shape) * 4
        cv2.imwrite(os.path.join(pred, f"{i + 1:05d}.jpg"),
                    np.clip(img, 0, 255).astype(np.uint8))
        base = rng.uniform(0, 128, (68, 2))
        np.savetxt(os.path.join(lms_p, f"{i + 1:05d}.lms"), base)
    for n in names:
        np.savetxt(os.path.join(lms_g, n.replace(".jpg", ".lms")),
                   rng.uniform(0, 128, (68, 2)))
    teacher = str(tmp / "teacher.ckpt")
    jckpt.save(teacher, jsyncnet.init(jax.random.PRNGKey(2)))
    cfg = synthetic_config(root, geo)
    cfg["training"]["syncnet_weights"] = teacher
    cfg_path = str(tmp / "config.yaml")
    save_config(cfg_path, cfg)
    return {"pred": pred, "gt": gt, "lms_p": lms_p, "lms_g": lms_g,
            "cfg": cfg_path, "no_fan": str(tmp / "no_fan.ckpt"),
            "teacher": teacher}


# metric -> (relative, absolute) bound; other keys must be equal
CLI_BOUNDS = {"psnr": (REL, 0), "ssim": (REL, 0), "cpbd": (0, 0),
              "lmd": (0, LMS_TOL), "sync_conf": (0, SYNC_TOL)}


def _run_jax(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["evaluate", *argv])
    capsys.readouterr()
    jevaluate.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["frames", "lms_precomputed", "lms_tiny",
                                  "sync"])
def test_cli_evaluate_matches_jax(scored, case, monkeypatch, capsys):
    argv = ["--pred", scored["pred"], "--gt", scored["gt"], "--offset", "8"]
    argv += {"frames": [],
             "lms_precomputed": ["--lms-pred", scored["lms_p"], "--lms-gt",
                                 scored["lms_g"]],
             "lms_tiny": ["--lms-from-fan", scored["no_fan"]],
             "sync": ["--sync", "--config", scored["cfg"]]}[case]
    want = _run_jax(argv, monkeypatch, capsys)
    got = tevaluate.main(argv + ["--device", "cpu"])
    assert set(got) == set(want)
    assert want["n_frames"] == 12 and 0 < want["cpbd"] < 1
    for k, w in want.items():
        if k in CLI_BOUNDS:
            rel, abs_ = CLI_BOUNDS[k]
            assert got[k] == pytest.approx(w, rel=rel, abs=abs_), (k, w)
        else:
            assert got[k] == w, k
    if case == "lms_tiny":
        assert got["lmd_detector"] == "tiny" and got["lmd"] > 0
    if case == "sync":
        assert want["sync_conf"] != 0


def test_cli_evaluate_fan_weights_raise(scored):
    """A weights file at the FAN path that holds no FAN (here the SyncNet
    teacher's (params, state) file): the CLI raises rather than score LMD
    with another detector."""
    with pytest.raises(ValueError, match="fan"):
        tevaluate.main(["--pred", scored["pred"], "--gt", scored["gt"],
                        "--offset", "8", "--lms-from-fan",
                        scored["teacher"], "--device", "cpu"])


def test_cli_evaluate_lmd_through_fan_matches_jax(scored, tmp_path,
                                                  monkeypatch, capsys):
    """LMD through the FAN of a weights file in the JAX CLI's (params,
    state) tuple layout (keys 0/..., 1/...): the port's CLI against the
    JAX CLI, 1e-3 px."""
    from speech2lip_tpu.models import fan as jfan
    fan_path = str(tmp_path / "fan.ckpt")
    jckpt.save(fan_path, jfan.init(jax.random.PRNGKey(4)))
    argv = ["--pred", scored["pred"], "--gt", scored["gt"], "--offset", "8",
            "--max-frames", "2", "--lms-from-fan", fan_path]
    want = _run_jax(argv, monkeypatch, capsys)
    got = tevaluate.main(argv + ["--device", "cpu"])
    assert want["lmd_detector"] == got["lmd_detector"] == "fan"
    assert got["lmd"] == pytest.approx(want["lmd"], abs=1e-3)
    assert got["lmd"] > 0


def test_cli_evaluate_without_teacher_says_so(scored, tmp_path, capsys):
    """No teacher file: the port scores against init_syncnet(0) and says
    that it differs from the JAX package's random teacher."""
    from speech2lip_tpu_torch.config import load_config
    cfg = load_config(scored["cfg"])
    cfg["training"]["syncnet_weights"] = str(tmp_path / "missing.ckpt")
    path = str(tmp_path / "config.yaml")
    save_config(path, cfg)
    got = tevaluate.main(["--pred", scored["pred"], "--gt", scored["gt"],
                          "--offset", "8", "--sync", "--config", path,
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "# sync teacher" in out and "init_syncnet(0)" in out
    assert np.isfinite(got["sync_conf"]) and -15 <= got["sync_offset"] <= 15
