"""The port's preprocessing CLI, every step, on a 48^2 world of 4 frames
(synthetic assets rendered at known poses, true landmarks, a wav), each
artifact held against the JAX package's step functions run in-process on
the same input files.

Tolerances: ``.lms`` within 1e-3 px and ``face_bbox_dict`` rows within
1 px with confidences to 1e-4 (seeded FAN, S3FD and DSFD with face-sized
regression heads); coords, depth and masks within 1e-4; the JPEGs the
steps write within 2/255 of the JAX arrays written the same way (a value
that rounds to the other byte moves the codec's block); the same lip box.
The tracker's values are held in test_torch_tracker.py: here only the
``_pack`` keys, shapes and dtypes of ``track_params.pt.npz``.
"""

import os
import tempfile

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.models import bisenet as jbis
from speech2lip_tpu.models import dsfd as jdsfd
from speech2lip_tpu.models import fan as jfan
from speech2lip_tpu.models import s3fd as js3fd
from speech2lip_tpu.preprocess import face_3dmm as jb
from speech2lip_tpu.preprocess import landmarks as jlm
from speech2lip_tpu.preprocess import steps as jsteps
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.cli import preprocess as cli
from speech2lip_tpu_torch.core import checkpoint as ckpt
from speech2lip_tpu_torch.preprocess import face_3dmm as tb
from speech2lip_tpu_torch.preprocess import synthetic_world as sw
from speech2lip_tpu_torch.preprocess.video_io import write_avi

torch.set_num_threads(2)

SIZE, N, FOCAL = 48, 4, 60.0
DIMS = dict(n_verts=150, id_dim=6, exp_dim=4, tex_dim=6, seed=1)
np_tree = lambda t: jax.tree.map(np.asarray, t)


def _face_sized(params, prefix):
    """Regression heads scaled by 0.05, so that the boxes are face-sized
    (see test_torch_preprocess_models.py)."""
    for k in params:
        if k.startswith(prefix):
            params[k] = {n: v * np.float32(0.05)
                         for n, v in params[k].items()}
    return params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pre")
    root, assets_dir = str(tmp / "id"), str(tmp / "assets")
    ta = tb.synthetic_assets(**DIMS)
    tb.save_reference_schema(ta, assets_dir)
    w = sw.make_raw_identity(root, ta, N, SIZE, FOCAL)
    wdir = str(tmp / "w")
    os.makedirs(wdir)
    jax_nets = {
        "fan": np_tree(jfan.init(jax.random.PRNGKey(0), n_modules=1)),
        "s3fd": _face_sized(np_tree(js3fd.init(jax.random.PRNGKey(1))),
                            "reg_"),
        "bisenet": np_tree(jbis.init(jax.random.PRNGKey(3)))}
    for name in ("fan", "bisenet"):
        p, s = jax_nets[name]
        ckpt.save(os.path.join(wdir, name + ".ckpt"),
                  {"params": p, "state": s})
    ckpt.save(os.path.join(wdir, "s3fd.ckpt"), jax_nets["s3fd"])
    ckpt.save(os.path.join(wdir, "deepspeech.ckpt"),
              weights.random_deepspeech(0, hidden=32))
    p, s = np_tree(jdsfd.init(jax.random.PRNGKey(2), depths=(1, 1, 1, 1)))
    jax_nets["dsfd"] = (_face_sized(p, "reg"), s)
    wdir2 = str(tmp / "w_dsfd")
    os.makedirs(wdir2)
    ckpt.save(os.path.join(wdir2, "fan.ckpt"),
              {"params": jax_nets["fan"][0], "state": jax_nets["fan"][1]})
    ckpt.save(os.path.join(wdir2, "dsfd.ckpt"),
              {"params": jax_nets["dsfd"][0], "state": jax_nets["dsfd"][1]})
    base = ["--root", root, "--assets", assets_dir, "--crop_size",
            str(SIZE), "--focal", str(FOCAL), "--lip_w", "16", "--lip_h",
            "12", "--track_scale", "0.02", "--device", "cpu"]
    return {"root": root, "assets": assets_dir, "tmp": tmp, "truth": w,
            "wdir": wdir, "wdir_dsfd": wdir2, "nets": jax_nets, "base": base}


def _read(path):
    return cv2.imread(path).astype(np.int32)


def _jpeg_of(img_rgb_float):
    """A JAX step's array written and read back as the CLIs write it."""
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "x.jpg")
        cli._imwrite(f, img_rgb_float)
        return _read(f)


def _landmarks_against_jax(world, wdir, dsfd_pair=None, s3fd_params=None):
    root = world["root"]
    got = cli.main(["landmarks", "--weights_dir", wdir] + world["base"])
    assert got["steps"] == ["landmarks"] and got["frames"]["landmarks"] == N
    bb_t = np.load(os.path.join(root, "face_bbox_dict.npy"),
                   allow_pickle=True).item()
    lms_t = {f: np.loadtxt(os.path.join(root, "landmarks", f))
             for f in sorted(os.listdir(os.path.join(root, "landmarks")))}
    jdir = str(world["tmp"] / ("jax_lms" + ("_dsfd" if dsfd_pair else "")))
    fan_p, fan_s = world["nets"]["fan"]
    bis_p, bis_s = world["nets"]["bisenet"] if s3fd_params is not None \
        else (None, None)
    bb_j = jlm.run_step1(os.path.join(root, "ori_images_face"), jdir,
                         os.path.join(jdir, "bbox.npy"), fan_p, fan_s,
                         bis_p, bis_s, s3fd_params=s3fd_params,
                         dsfd=dsfd_pair)
    assert set(bb_t) == set(bb_j) and len(bb_t) == N
    for f in bb_j:
        assert bb_t[f].shape == (5,) and bb_t[f].dtype == np.float32
        np.testing.assert_allclose(bb_t[f][:4], bb_j[f][:4], atol=1)
        assert bb_t[f][4] == pytest.approx(bb_j[f][4], abs=1e-4)
    for f, pts in lms_t.items():
        assert pts.shape == (68, 2)
        np.testing.assert_allclose(pts, np.loadtxt(os.path.join(jdir, f)),
                                   atol=1e-3)


@pytest.fixture(scope="module")
def tracked(world):
    """landmarks (S3FD, then DSFD), the true .lms restored, then track."""
    _landmarks_against_jax(world, world["wdir"],
                           s3fd_params=world["nets"]["s3fd"])
    _landmarks_against_jax(world, world["wdir_dsfd"],
                           dsfd_pair=world["nets"]["dsfd"])
    sw.write_lms(world["root"], world["truth"]["lms"])
    out = cli.main(["track", "--weights_dir", world["wdir"]]
                   + world["base"])
    assert out["focal"] == FOCAL and set(out["track_timings"]) == {
        "phase_a_pose", "phase_b_idexp", "phase_c_photometric",
        "phase_d_window"}
    track = dict(np.load(os.path.join(world["root"],
                                      "track_params.pt.npz")))
    return track


def test_landmarks_and_track_artifacts(tracked):
    shapes = {"id": (1, 6), "exp": (N, 4), "euler": (N, 3), "trans": (N, 3),
              "focal": (), "tex": (1, 6), "light": (N, 27)}
    assert set(tracked) == set(shapes)
    for k, shape in shapes.items():
        assert tracked[k].shape == shape and tracked[k].dtype == np.float32
        assert np.isfinite(tracked[k]).all()


def test_warp_uv_masks_crop_lip_match_jax(world, tracked):
    root, base = world["root"], world["base"]
    for step in ("warp", "uv_mapping", "masks", "crop_lip"):
        got = cli.main([step, "--weights_dir", world["wdir"]] + base)
        assert got["steps"] == [step]
    ja = jb.load_assets(world["assets"], 6, 4, 6)
    frames = np.stack([cv2.cvtColor(_read(os.path.join(
        root, "ori_images_face", f"{i + 1:05d}.jpg")).astype(np.uint8),
        cv2.COLOR_BGR2RGB).astype(np.float32) for i in range(N)])

    warped = jsteps.warp_images(tracked, ja, frames, 0, SIZE, SIZE)
    for i in range(N):
        got = _read(os.path.join(root, "warp_images", f"{i + 1:05d}.jpg"))
        assert np.abs(got - _jpeg_of(warped[i])).max() <= 2

    coords = jsteps.compute_uv_mapping(tracked, ja, 0, SIZE, SIZE)
    for i in range(N):
        got = np.load(os.path.join(root, "coords", f"{i + 1:05d}.npy"))
        assert got.shape == (SIZE, SIZE, 2) and np.abs(got).max() <= 1.0
        np.testing.assert_allclose(got, coords[i], atol=1e-4)

    p, s = world["nets"]["bisenet"]
    classes = np.asarray(jbis.parse_face(p, s, jnp.asarray(frames[0] / 255.0)))
    classes = cv2.resize(classes.astype(np.uint8), (SIZE, SIZE),
                         interpolation=cv2.INTER_NEAREST)
    parsing = np.zeros((SIZE, SIZE, 3), np.uint8)
    parsing[np.isin(classes, list(range(1, 16)))] = (255, 0, 0)
    got = _read(os.path.join(root, "canonical_face_parsing.jpg"))
    assert np.abs(got - _jpeg_of(parsing.astype(np.float32))).max() <= 2
    depth, face_mask, head_mask = jsteps.canonical_masks(
        tracked, ja, 0, SIZE, SIZE, parsing_map=parsing)
    np.testing.assert_allclose(
        np.load(os.path.join(root, "depth_face_canonical.npy")), depth,
        atol=1e-4)
    for name, mask in (("face", face_mask), ("head", head_mask)):
        got = cv2.imread(os.path.join(root, f"canonical_{name}_mask.jpg"),
                         cv2.IMREAD_GRAYSCALE)
        ok, enc = cv2.imencode(".jpg", mask.astype(np.uint8) * 255)
        want = cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE)
        assert np.abs(got.astype(np.int32) - want).max() <= 2, name

    warped_t = np.stack([cv2.cvtColor(_read(os.path.join(
        root, "warp_images", f"{i + 1:05d}.jpg")).astype(np.uint8),
        cv2.COLOR_BGR2RGB).astype(np.float32) for i in range(N)])
    lms0 = np.loadtxt(os.path.join(root, "landmarks", "00001.lms")).astype(
        np.float32)
    crops, lip_mask, xy = jsteps.crop_lip(warped_t, lms0, 16, 12)
    got = cli.main(["crop_lip"] + base)
    assert tuple(got["lip_box"]) == tuple(xy)
    assert np.array_equal(cv2.imread(os.path.join(
        root, "canonical_lip_mask.jpg"), cv2.IMREAD_GRAYSCALE),
        cv2.imdecode(cv2.imencode(".jpg", lip_mask)[1],
                     cv2.IMREAD_GRAYSCALE))
    for i in range(N):
        got = _read(os.path.join(root, "images", f"{i + 1:05d}.jpg"))
        assert got.shape == (12, 16, 3)
        assert np.abs(got - _jpeg_of(crops[i])).max() <= 2


def test_audio_features_and_no_card(world, tracked):
    root = world["root"]
    got = cli.main(["audio_features", "--weights_dir", world["wdir"]]
                   + world["base"])
    aud = np.load(os.path.join(root, "audio", "audio.npy"))
    assert aud.shape[1:] == (16, 29) and got["frames"]["audio_features"] \
        == len(aud) and np.isfinite(aud).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["crop_lip"] + world["base"][:-2])


def test_extract_and_crop_face_from_avi(tmp_path):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)
              for _ in range(3)]
    audio = (0.3 * np.sin(2 * np.pi * 440 * np.arange(8000) / 16000)
             * 32767).astype(np.int16)
    video = str(tmp_path / "clip.avi")
    write_avi(video, frames, fps=25.0, audio=audio, sample_rate=16000)
    root = str(tmp_path / "id")
    got = cli.main(["extract", "--root", root, "--video", video,
                    "--device", "cpu"])
    assert got["frames"]["extract"] == 3
    names = sorted(os.listdir(os.path.join(root, "ori_images")))
    assert names == ["00001.jpg", "00002.jpg", "00003.jpg"]
    from scipy.io import wavfile
    sr, wav = wavfile.read(os.path.join(root, "audio", "audio.wav"))
    assert sr == 16000 and np.array_equal(wav, audio)
    got = cli.main(["crop_face", "--root", root, "--raw_frames",
                    os.path.join(root, "ori_images"), "--crop_center", "30",
                    "20", "--crop_size", "24", "--device", "cpu"])
    assert got["frames"]["crop_face"] == 3
    for f in names:
        src = cv2.cvtColor(cv2.imread(os.path.join(root, "ori_images", f)),
                           cv2.COLOR_BGR2RGB).astype(np.float32)
        want = jsteps.crop_face(src, (30, 20), 24)
        got = _read(os.path.join(root, "ori_images_face", f))
        assert got.shape == (24, 24, 3)
        assert np.abs(got - _jpeg_of(want)).max() <= 2
