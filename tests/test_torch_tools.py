"""The port's user tools on the CPU: the method registry
(``core/factory``) against the JAX package's, the raw-video pipeline
(``tools/full_pipeline_run``) against the JAX tool's world and report, and
the training and per-stage benches at a CPU size.

Tolerances: the registry's keys and ``get_model``'s leaf names and shapes
equal (JAX's by ``jax.eval_shape``: the draws differ); ``get_dataset``'s
frames equal, the mel within 1e-4 (float64 port, float32 JAX);
``make_world``'s asset files equal, its landmarks within 1e-4 px, its
AVI's decoded frames within 2/255 and its PCM equal; the tiny pipeline
run's report keys equal the committed PIPELINE.json's; each bench stage's
kernel call equals its plain call (on the CPU both are the plain code).
"""

import argparse
import json
import os
import re
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tools import full_pipeline_run as jpipe  # noqa: E402
from speech2lip_tpu.core import factory as jfactory  # noqa: E402
from speech2lip_tpu.data import synthetic as jsyn  # noqa: E402
from speech2lip_tpu_torch import weights  # noqa: E402
from speech2lip_tpu_torch.core import checkpoint as ckpt  # noqa: E402
from speech2lip_tpu_torch.core import factory  # noqa: E402
from speech2lip_tpu_torch.infer.renderer import Renderer  # noqa: E402
from speech2lip_tpu_torch.preprocess.video_io import demux_avi_pcm  # noqa
from speech2lip_tpu_torch.tools import bench_components  # noqa: E402
from speech2lip_tpu_torch.tools import bench_train  # noqa: E402
from speech2lip_tpu_torch.tools import full_pipeline_run as pipe  # noqa
from speech2lip_tpu_torch.train import trainer  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_SIZE = (48, 16, 24)    # face, lip_h, lip_w of the benches on a CPU
MEL_TOL = 1e-4
FRAME_TOL = 2.0            # uint8 levels: 2/255


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    geo = jsyn.make_synthetic_tree(root, n_frames=8, face=48, lip_h=16,
                                   lip_w=24)
    return root, jsyn.synthetic_config(root, geo)


# -- core/factory -------------------------------------------------------------

def test_factory_registry_keys():
    for name in ("_MODEL_BUILDERS", "_TRAINER_BUILDERS", "_DATASET_BUILDERS"):
        assert sorted(getattr(factory, name)) == sorted(
            getattr(jfactory, name)), name
    assert set(factory._MODEL_BUILDERS) == {"face_simple"}
    assert set(factory._DATASET_BUILDERS) == {"lip_someone"}


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _shapes(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tuple(tree.shape)}


def test_get_model_matches_jax_shapes(tree):
    _, cfg = tree
    want = jax.eval_shape(lambda: jfactory.get_model(cfg))
    got = factory.get_model(cfg, device="cpu")
    assert _shapes(got) == _shapes(want)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for _, t in ckpt.flatten_paths(got))
    # the U-Net's BatchNorm at the JAX init's identity
    assert float(got[1]["inc"]["bn1"]["scale"].min()) == 1.0
    assert float(got[2]["inc"]["bn1"]["var"].max()) == 1.0
    # the same seed, the same draw
    again = factory.get_model(cfg, device="cpu")
    assert torch.equal(got[0]["fc_uv"]["w"], again[0]["fc_uv"]["w"])


def test_get_model_asks_for_the_card(tree):
    _, cfg = tree
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory.get_model(cfg)


def test_get_trainer_and_dataset_match_jax(tree):
    root, cfg = tree
    assert factory.get_trainer(cfg) is trainer
    assert hasattr(factory.get_trainer(cfg), "fit")
    for mode in ("train", "val"):
        t, j = factory.get_dataset(mode, cfg), jfactory.get_dataset(mode,
                                                                      cfg)
        assert len(t) == len(j) > 0
        for pos in range(len(j)):
            ts, js = t.load_frame(pos), j.load_frame(pos)
            assert set(ts) == set(js)
            for k in js:
                g, w = np.asarray(ts[k]), np.asarray(js[k])
                assert g.shape == w.shape and g.dtype == w.dtype, k
                if k == "mel":
                    np.testing.assert_allclose(g, w, rtol=0, atol=MEL_TOL)
                else:
                    np.testing.assert_array_equal(g, w, err_msg=k)


# -- tools/full_pipeline_run ----------------------------------------------------

def _world_args(**over):
    kw = dict(frames=6, crop=48, margin=16, verts=200, depth_stretch=2.5,
              z_motion=1.0, focal_true=900.0, seed=0)
    kw.update(over)
    return argparse.Namespace(**kw)


def _avi_frames(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f.astype(np.float32))
    cap.release()
    return np.stack(frames)


def test_make_world_matches_jax(tmp_path):
    args = _world_args()
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(a)
    os.makedirs(b)
    want = jpipe.make_world(a, args)
    got = pipe.make_world(b, args, device="cpu")
    assert (got["raw"], got["n"]) == (want["raw"], want["n"])
    for name in ("3DMM_info.npy", "keys_info.npy", "topology_info.npy"):
        jd = np.load(os.path.join(a, "assets", name), allow_pickle=True
                     ).item()
        td = np.load(os.path.join(b, "assets", name), allow_pickle=True
                     ).item()
        assert sorted(jd) == sorted(td), name
        for k in jd:
            assert td[k].dtype == jd[k].dtype and np.array_equal(
                td[k], jd[k]), (name, k)
    assert float(np.abs(got["lms_crop"] - want["lms_crop"]).max()) <= 1e-4
    fa, fb = (_avi_frames(os.path.join(d, "clip.avi")) for d in (a, b))
    assert fa.shape == fb.shape == (args.frames, got["raw"], got["raw"], 3)
    assert fb.max() >= 20 and float(np.abs(fa - fb).max()) <= FRAME_TOL
    sa, wa = demux_avi_pcm(os.path.join(a, "clip.avi"))
    sb, wb = demux_avi_pcm(os.path.join(b, "clip.avi"))
    assert sa == sb == 16000 and np.array_equal(wa, wb)


def test_synth_step1_weights_load_as_step1_weights(tmp_path):
    wdir = pipe.synth_step1_weights(str(tmp_path))
    assert sorted(os.listdir(wdir)) == ["dsfd.ckpt", "fan.ckpt"]
    fan = ckpt.load_nested(os.path.join(wdir, "fan.ckpt"))[0]
    p, _ = weights.fan_from_jax(fan["params"], fan["state"])
    assert len(p["hg"]) == 1
    dsfd = ckpt.load_nested(os.path.join(wdir, "dsfd.ckpt"))[0]
    p, _ = weights.dsfd_from_jax(dsfd["params"], dsfd["state"])
    assert [len(p[f"layer{i}"]) for i in range(1, 5)] == [1, 1, 1, 1]


TINY = ["--frames", "10", "--crop", "48", "--margin", "16", "--lip-w", "16",
        "--lip-h", "12", "--verts", "200", "--iters", "4", "--batch", "2",
        "--val-frames", "4", "--validate-every", "2", "--track-scale",
        "0.02"]


def test_pipeline_end_to_end_on_the_cpu(tmp_path):
    """Every step of the raw-video pipeline at a tiny size; the report has
    the committed PIPELINE.json's keys, each part runs once, in order and
    receives its step's result."""
    out = tmp_path / "pipe"
    os.makedirs(out / "weights")
    # a narrow DeepSpeech keeps audio_features fast (the CLI reads it)
    ckpt.save(str(out / "weights" / "deepspeech.ckpt"),
              weights.random_deepspeech(0, hidden=32))
    parts, results = [], {}

    class _Part:
        def __init__(self, name):
            parts.append(name)
            self.slot = results[name] = {}

        def __enter__(self):
            return self.slot

        def __exit__(self, *exc):
            return False

    report_path = str(tmp_path / "report.json")
    rep = pipe.main(["--out", str(out), "--device", "cpu",
                     "--json", report_path, *TINY], part=_Part)
    with open(os.path.join(ROOT, "PIPELINE.json")) as f:
        committed = json.load(f)
    assert list(rep) == list(committed)
    with open(report_path) as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    assert rep["pipeline"] == committed["pipeline"]
    assert set(rep["phase_seconds"]) == set(committed["phase_seconds"])
    assert parts == ["synthesize_world", "extract", "crop_face", "landmarks",
                     "track", "warp", "uv_mapping", "masks", "crop_lip",
                     "audio_features", "train", "infer", "evaluate"]
    assert rep["best_checkpoint_selected"] and rep["backend"] == "cpu"
    assert len(rep["val_psnr_trajectory"]) == 2
    assert rep["rendered_val_metrics"]["n_frames"] == 4
    assert np.isfinite(rep["rendered_val_metrics"]["psnr"])
    assert 600 <= rep["focal_found"] <= 1500
    n_rendered = len(os.listdir(out / "rendering_result" / "pipeline" /
                                "postfusion"))
    assert n_rendered == 4
    infer = results["infer"]["result"]
    assert isinstance(infer["renderer"], Renderer) and infer["frames"] == 4
    assert results["evaluate"]["result"] == rep["rendered_val_metrics"]
    # the --psnr-bar exit code
    os.makedirs(tmp_path / "bar" / "weights")
    os.link(out / "weights" / "deepspeech.ckpt",
            tmp_path / "bar" / "weights" / "deepspeech.ckpt")
    with pytest.raises(SystemExit) as e:
        pipe.main(["--out", str(tmp_path / "bar"), "--device", "cpu",
                   "--psnr-bar", "1000", *TINY[:-2], "--track-scale",
                   "0.01"])
    assert e.value.code == 1


def test_pipeline_refuses_what_it_cannot_run(tmp_path):
    with pytest.raises(NotImplementedError, match="data-parallel"):
        pipe.main(["--out", str(tmp_path), "--devices", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipe.main(["--out", str(tmp_path), *TINY])


# -- tools/bench_train and tools/bench_components ------------------------------

ROW = re.compile(r"^(stage1|sync  ) +b(\d) +(float32|bfloat16) *: +([\d.]+) "
                 r"ms/step \( *([\d.]+) ms/frame\)")


def test_bench_train_default_rows(monkeypatch, capsys):
    monkeypatch.setattr(bench_train, "ITERS", 1)
    rows = bench_train.main(["--device", "cpu"], size=CPU_SIZE)
    printed = [ROW.match(line) for line in capsys.readouterr().out.splitlines()]
    printed = [m for m in printed if m]
    assert len(rows) == len(printed) == 6
    for r, m in zip(rows, printed):
        assert (r["case"].split()[0], str(r["batch"]), r["dtype"]) == (
            m.group(1).strip(), m.group(2), m.group(3))
        assert np.isfinite(r["ms_per_step"]) and np.isfinite(r["loss"])
        assert r["ms_per_frame"] == pytest.approx(r["ms_per_step"]
                                                  / r["batch"])
        # no kernel launches on the CPU
        assert set(r["launches"].values()) == {0}


@pytest.mark.parametrize("mode", ["batch_scaling", "ablate"])
def test_bench_train_modes_rows(mode, monkeypatch, capsys):
    monkeypatch.setattr(bench_train, "ITERS", 1)
    rows = []
    getattr(bench_train, mode)(torch.device("cpu"), CPU_SIZE, rows,
                               batches=(1, 2))
    out = capsys.readouterr().out
    if mode == "batch_scaling":
        assert [r["batch"] for r in rows] == [1, 2]
        assert len(re.findall(r"^batch \d: full +[\d.]+ ms/frame", out,
                              re.M)) == 2
        keys = ("full_ms_per_frame", "unet_ms_per_frame",
                "lip_mlp_ms_per_frame", "lip_only_ms_per_frame")
    else:
        names = [r["case"] for r in rows if r["batch"] == 1]
        # +dcrop runs where the depth mask's box is small enough
        assert names == [n for n, _, _ in bench_train.ABLATIONS]
        assert len(re.findall(r"^batch \d \S+ *: +[\d.]+ ms/step", out,
                              re.M)) == len(rows) == 20
        keys = ("ms_per_step", "ms_per_frame")
    assert all(np.isfinite(r[k]) and r[k] > 0 for r in rows for k in keys)


def test_bench_components_rows(monkeypatch, capsys):
    monkeypatch.setattr(bench_components, "ITERS", 2)
    monkeypatch.setattr(bench_components, "REPEATS", 1)
    rows = bench_components.main(["--device", "cpu"], size=(64, 16, 24))
    out = capsys.readouterr().out
    assert list(rows) == list(bench_components.STAGES)
    assert "# batch 2, float32" in out
    for label in ("full render", "lip MLP", "composite", "U-Net"):
        assert re.search(rf"^ *{label} *: +[\d.]+ ms", out, re.M), label
    assert all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in rows.values())
    bench = bench_components.build("cpu", (64, 16, 24))
    assert bench.batch == 2 and bench.dtype == torch.float32
    with torch.no_grad():
        for name, (kern, plain) in bench.stages.items():
            g = kern()
            assert torch.isfinite(g).all(), name
            if plain is None:
                assert name == "U-Net plain"
                continue
            w = plain()
            assert g.shape == w.shape and torch.equal(g, w), name
        # the U-Net stage runs on the render's own composited input
        assert torch.equal(bench.stages["U-Net"][0](),
                           bench.stages["full render"][0]())


def test_benches_ask_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (bench_train.main, bench_components.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
