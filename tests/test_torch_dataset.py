"""The port's data path (speech2lip_tpu_torch.data, ops.audio_dsp,
ops.grid_sample_np, ops.flowviz, models init) against the JAX package's on
the CPU, on a tree written by the JAX package's ``make_synthetic_tree``
(64² face, 16x24 lip, 12 frames, sync loss and black-hole augmentation
on).

Both packages decode JPEGs with the same codec (OpenCV), so JPEG-derived
fields are held equal; the bound of the JAX package's native decoder
test (2.5/255) is the stated limit where a codec differs.  npy-derived
fields are exact.  The mel spectrogram: the port computes in float64, the
JAX package in float32 (measured gap 1e-5 on [-4, 4]): 1e-4.
"""

import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from speech2lip_tpu.core.checkpoint import _flatten as jflatten
from speech2lip_tpu.data import dataset as jds
from speech2lip_tpu.data import synthetic as jsyn
from speech2lip_tpu.data import windows as jwin
from speech2lip_tpu.models import lpips as jlpips
from speech2lip_tpu.models import syncnet as jsyncnet
from speech2lip_tpu.models import talking_face as jtf
from speech2lip_tpu.models import unet_light as junet
from speech2lip_tpu.ops import audio_dsp as jaudio
from speech2lip_tpu.ops import flowviz as jflow
from speech2lip_tpu.ops.grid_sample import grid_sample_np as jgrid_np
from speech2lip_tpu_torch.core.checkpoint import flatten as tflatten
from speech2lip_tpu_torch.data import dataset as tds
from speech2lip_tpu_torch.data import image_io
from speech2lip_tpu_torch.data import synthetic as tsyn
from speech2lip_tpu_torch.data import windows as twin
from speech2lip_tpu_torch.models import talking_face as ttf
from speech2lip_tpu_torch.ops import audio_dsp as taudio
from speech2lip_tpu_torch.ops import flowviz as tflow
from speech2lip_tpu_torch.ops.grid_sample import grid_sample_np as tgrid_np
from speech2lip_tpu_torch.train import trainer as ttrainer

JPEG_TOL = 2.5 / 255   # a JPEG decoder against another
MEL_TOL = 1e-4         # float32 (JAX) against float64 (port) mel
# fields read from JPEGs, directly or through a warp or resize
JPEG_KEYS = {"rgb", "rgb_face_ori", "rgb_face_zero", "rgb_zero",
             "mask_lip_canonical", "mask_head_canonical",
             "mask_face_canonical", "rgb_window_neg", "warped_base",
             "blackaug_face_mask"}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    geo = jsyn.make_synthetic_tree(root, n_frames=12, face=64, lip_h=16,
                                   lip_w=24)
    cfg = jsyn.synthetic_config(root, geo)
    assert cfg["training"]["use_syncloss"]
    assert cfg["model"]["use_post_fusion_blackaug"]
    return root, geo, cfg


def _same(got, ref, key):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, key
    if key == "mel" or (key == "audio" and got.shape[-1] == 80):
        np.testing.assert_allclose(got, ref, rtol=0, atol=MEL_TOL,
                                   err_msg=key)
    elif key in JPEG_KEYS:
        assert np.abs(got - ref).max(initial=0) <= JPEG_TOL, key
        np.testing.assert_array_equal(got, ref, err_msg=key)  # one codec
    else:
        np.testing.assert_array_equal(got, ref, err_msg=key)


@pytest.mark.parametrize("mode,mel", [("train", False), ("val", False),
                                      ("test", False), ("val", True)])
def test_load_frame_matches_jax(tree, mode, mel):
    root, _, cfg = tree
    cfg = json.loads(json.dumps(cfg))
    cfg["model"]["use_audio_mel"] = mel
    j, t = jds.LipDataset(root, mode, cfg), tds.LipDataset(root, mode, cfg)
    assert len(t) == len(j) > 0
    assert (t.lefttop_x, t.lefttop_y, t.face_h, t.face_w, t.lip_h,
            t.lip_w) == (j.lefttop_x, j.lefttop_y, j.face_h, j.face_w,
                         j.lip_h, j.lip_w)
    for pos in range(len(j)):
        js, ts = j.load_frame(pos), t.load_frame(pos)
        assert set(ts) == set(js), (pos, set(ts) ^ set(js))
        for k in js:
            _same(ts[k], js[k], k)
        jl, tl = j.load_frame_light(pos), t.load_frame_light(pos)
        assert set(tl) == set(jl)
        for k in jl:
            _same(tl[k], jl[k], k)
    if mode == "train":
        assert {"mel", "rgb_window_neg", "warped_base"} <= set(ts)
    jb = jds.stack_batch([j.load_frame(i) for i in range(2)])
    tb = tds.stack_batch([t.load_frame(i) for i in range(2)])
    assert set(tb) == set(jb)
    for k in jb:
        _same(tb[k], jb[k], k)


def test_warp_window_cache_and_validation(tree, tmp_path):
    root, _, cfg = tree
    j, t = jds.LipDataset(root, "train", cfg), tds.LipDataset(root, "train",
                                                              cfg)
    box = jtf.expanded_lip_box(j.lip_h, j.lip_w, j.lefttop_x, j.lefttop_y)
    assert ttf.expanded_lip_box(t.lip_h, t.lip_w, t.lefttop_x,
                                t.lefttop_y) == box
    path = os.path.join(root, "warp_window.json")
    if os.path.exists(path):
        os.remove(path)
    win = twin.cached_warp_window(root, box, t.face_h, t.face_w,
                                  t.iter_coords)
    written = json.load(open(path))
    os.remove(path)
    assert jwin.cached_warp_window(root, box, j.face_h, j.face_w,
                                   j.iter_coords) == win
    assert json.load(open(path)) == written     # the same file and key
    # a file with the right key is read back, not recomputed
    json.dump({"key": written["key"], "window": [0, 0, 8, 8]},
              open(path, "w"))
    assert twin.cached_warp_window(root, box, t.face_h, t.face_w,
                                   lambda: iter(())) == (0, 0, 8, 8)
    os.remove(path)
    assert ttrainer.warp_window(cfg, t) == win
    coords = list(t.iter_coords())
    for w in (win, (win[0] + 8, win[1], win[2], win[3])):
        assert twin.validate_window(coords, box, w, t.face_h, t.face_w) \
            == jwin.validate_window(coords, box, w, j.face_h, j.face_w)


def test_mouth_bbox_and_track_params(tmp_path):
    rng = np.random.default_rng(3)
    for _ in range(5):
        lms = rng.uniform(0, 500, (68, 2)).astype(np.float32)
        assert tds.compute_mouth_bbox(lms, 120, 80, 1.02) == \
            jds.compute_mouth_bbox(lms, 120, 80, 1.02)
    p = str(tmp_path / "track_params.pt")
    torch.save({"euler": torch.randn(4, 3), "trans": torch.randn(4, 3)}, p)
    got, ref = tds._load_track_params(p), jds._load_track_params(p)
    assert set(got) == set(ref) == {"euler", "trans"}
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_melspectrogram_and_audio_windows(tree):
    root = tree[0]
    wav = taudio.load_wav(os.path.join(root, "audio", "audio.wav"))
    np.testing.assert_array_equal(
        wav, jaudio.load_wav(os.path.join(root, "audio", "audio.wav")))
    rng = np.random.default_rng(0)
    noisy = (wav + 0.01 * rng.standard_normal(wav.shape)).astype(np.float32)
    for w in (wav, noisy):
        for fmin in (55.0, 95.0):
            got, ref = taudio.melspectrogram(w, fmin), jaudio.melspectrogram(
                w, fmin)
            assert got.shape == ref.shape and got.dtype == np.float32
            np.testing.assert_allclose(got, ref, rtol=0, atol=MEL_TOL)
    np.testing.assert_array_equal(
        taudio.mel_filterbank(16000, 800, 80, 55.0, 7600.0),
        jaudio.mel_filterbank(16000, 800, 80, 55.0, 7600.0))
    spec = rng.standard_normal((100, 80)).astype(np.float32)
    for start in (0, 7, 40):
        np.testing.assert_array_equal(taudio.crop_audio_window(spec, start),
                                      jaudio.crop_audio_window(spec, start))


def test_host_warp_and_flow_bit_identical():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (2, 20, 24, 3)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 20, 24, 2)).astype(np.float32)
    np.testing.assert_array_equal(tgrid_np(img, grid), jgrid_np(img, grid))
    flow = tflow.extract_flow(grid)
    np.testing.assert_array_equal(flow, jflow.extract_flow(grid))
    np.testing.assert_array_equal(tflow.flow_to_image(flow[0]),
                                  jflow.flow_to_image(flow[0]))


def test_image_io_matches_jax_reader(tree, tmp_path):
    root = tree[0]
    path = os.path.join(root, "ori_images_face", "00003.jpg")
    for hw in (None, (96, 96)):
        np.testing.assert_array_equal(image_io.imread_float(path, hw),
                                      jds._imread_float(path, hw))
    out = str(tmp_path / "x.jpg")
    ys, xs = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 24),
                         indexing="ij")
    rgb = image_io.to_uint8(np.stack([xs, ys, 0.5 * xs + 0.25], -1))
    image_io.imwrite(out, rgb, quality=100)
    # JPEG's subsampled chroma on a 16x24 gradient: 8/255 measured; a swap
    # of the red and blue channels would be off by 0.5
    assert np.abs(image_io.imread_float(out) - rgb / 255.0).max() <= 0.05
    with pytest.raises(FileNotFoundError):
        image_io.imread_float(str(tmp_path / "missing.jpg"))


def _same_files(a, b):
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for n in names:
        fa, fb = os.path.join(a, n), os.path.join(b, n)
        if n.endswith(".jpg"):
            da, db = image_io.imread_float(fa), image_io.imread_float(fb)
            assert np.abs(da - db).max() <= JPEG_TOL, n
        else:
            assert filecmp.cmp(fa, fb, shallow=False), n
    return names


@pytest.mark.parametrize("writer", ["make_synthetic_tree",
                                    "make_learnable_tree"])
def test_tree_writers_match_jax(tmp_path, writer):
    kw = dict(n_frames=6, face=32, lip_h=8, lip_w=12, seed=4)
    geo_j = getattr(jsyn, writer)(str(tmp_path / "j"), **kw)
    geo_t = getattr(tsyn, writer)(str(tmp_path / "t"), **kw)
    assert geo_t == geo_j
    names = _same_files(str(tmp_path / "j"), str(tmp_path / "t"))
    assert "coords/00006.npy" in names and "images/00001.jpg" in names
    assert tsyn.synthetic_config("r", geo_t) == jsyn.synthetic_config(
        "r", geo_j)


def test_init_models_leaves_match_jax_inits(tree):
    root, _, cfg = tree
    t = tds.LipDataset(root, "train", cfg)
    params, unet_p, unet_s, frozen = ttrainer.init_models(cfg, t, seed=0)
    key = jax.random.PRNGKey(0)
    ref = {"params": jax.eval_shape(lambda k: jtf.init(k, cfg), key),
           "unet": jax.eval_shape(junet.init, key),
           "lpips": jax.eval_shape(jlpips.init, key),
           "syncnet": jax.eval_shape(jsyncnet.init, key)}
    got = {"params": params, "unet": (unet_p, unet_s),
           "lpips": frozen["lpips"], "syncnet": frozen["syncnet"]}
    shapes = lambda flat: {k: tuple(v.shape) for k, v in flat.items()}
    assert shapes(tflatten(got)) == shapes(jflatten(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), ref)))
    # the canonical depth starts from the dataset's hole-filled depth
    depth = jtf.prepare_canonical_depth_init(
        t.depth_canonical, t.mask_head_canonical[..., 0])
    np.testing.assert_allclose(params["canonical_depth"].numpy(),
                               np.asarray(depth), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        ttf.prepare_canonical_depth_init(t.depth_canonical,
                                         t.mask_head_canonical[..., 0]),
        np.asarray(depth), rtol=0, atol=1e-6)
    # BatchNorm starts at the JAX init's identity
    assert float(unet_s["inc"]["bn1"]["var"].min()) == 1.0
