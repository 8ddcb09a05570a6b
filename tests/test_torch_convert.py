"""The port's weight converter (speech2lip_tpu_torch.tools.convert_weights)
against the JAX package's tools/convert_weights.py, on the reference's
files made from seeds by tools/reference_weights (``small=True``: a
32-wide talking face with a 16^2 canonical depth, FAN with its 4 modules,
DSFD at depths 1, 1, 1, 1, DeepSpeech at hidden 32, the others at their
published widths), in the reference's names and blob layouts.

Tolerances: every converted tree, and every npz file both tools write,
equal bit for bit; the converted talking face and U-Net rendered by the
port's Renderer (float32, on the CPU) within 1e-5 of the JAX renderer on
the same checkpoint.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tools import convert_weights as jcw  # noqa: E402
from speech2lip_tpu.data.synthetic import synthetic_batch  # noqa: E402
from speech2lip_tpu.data.windows import compute_warp_window  # noqa: E402
from speech2lip_tpu.infer import renderer as jrender  # noqa: E402
from speech2lip_tpu.models import talking_face as jtf  # noqa: E402
from speech2lip_tpu_torch import weights  # noqa: E402
from speech2lip_tpu_torch.cli import evaluate as cli_evaluate  # noqa: E402
from speech2lip_tpu_torch.cli import preprocess as cli_pre  # noqa: E402
from speech2lip_tpu_torch.config import default_config  # noqa: E402
from speech2lip_tpu_torch.core import checkpoint as ckpt  # noqa: E402
from speech2lip_tpu_torch.infer.renderer import Renderer  # noqa: E402
from speech2lip_tpu_torch.tools import convert_weights as cw  # noqa: E402
from speech2lip_tpu_torch.tools import reference_weights as rw  # noqa: E402

torch.set_num_threads(2)

KINDS = ["talking_face", "syncnet", "lpips", "bisenet", "fan", "dsfd",
         "s3fd", "deepspeech"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's files (small widths) and the trees they hold."""
    src = str(tmp_path_factory.mktemp("reference"))
    trees = rw.reference_trees(0, small=True)
    return src, rw.write_reference_files(src, trees), trees


def _flat_equal(a, b):
    fa, fb = ckpt.flatten(a), ckpt.flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


def _convert(mod, kind, paths):
    """``mod.convert_<kind>`` on the file's blob, as each tool's main
    unpacks it."""
    load = lambda p: torch.load(p, map_location="cpu", weights_only=True)
    if kind == "talking_face":
        return mod.convert_talking_face(load(paths[kind])["model"])
    if kind == "syncnet":
        return mod.convert_syncnet(load(paths[kind])["state_dict"])
    if kind == "lpips":
        return mod.convert_lpips(load(paths["lpips_alex"]),
                                 load(paths["lpips_lin"]))
    if kind == "deepspeech":
        return mod.convert_deepspeech(paths[kind])
    blob = load(paths[kind])
    return getattr(mod, f"convert_{kind}")(blob.get("state_dict", blob))


@pytest.mark.parametrize("kind", KINDS)
def test_convert_matches_jax_tool(ref, kind):
    _, paths, trees = ref
    got, want = _convert(cw, kind, paths), _convert(jcw, kind, paths)
    _flat_equal(got, want)
    # and it is the tree the file was made from
    _flat_equal(got, trees[kind])


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _jax_main(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["convert_weights.py"] + argv)
    jcw.main()


def test_main_writes_the_jax_tool_files(ref, tmp_path, monkeypatch):
    """``--all`` (which finds no .pb) and the DeepSpeech .npz by its
    positional form: the same files, keys and arrays as the JAX tool's."""
    src, paths, _ = ref
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_main(["--all", src, a], monkeypatch)
    found = cw.main(["--all", src, b])
    _jax_main(["deepspeech", paths["deepspeech"], a + "/deepspeech.ckpt"],
              monkeypatch)
    cw.main(["deepspeech", paths["deepspeech"], b + "/deepspeech.ckpt"])
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert names == sorted(["talking_face.ckpt", "unet.ckpt",
                            "syncnet_weights.ckpt", "lpips_weights.ckpt",
                            "bisenet_weights.ckpt", "fan_weights.ckpt",
                            "dsfd_weights.ckpt", "s3fd_weights.ckpt",
                            "deepspeech.ckpt"])
    for name in names:
        za, zb = _npz(os.path.join(a, name)), _npz(os.path.join(b, name))
        assert sorted(za) == sorted(zb), name
        for k in za:
            assert za[k].dtype == zb[k].dtype and np.array_equal(
                za[k], zb[k]), (name, k)
    assert set(found) == set(KINDS) - {"deepspeech"}


def test_convert_all_finds_the_same_files(ref, tmp_path):
    """``convert_all`` on a tree with the LPIPS head alone, a FAN, and
    the talking face under another model_*.pt name: both tools convert
    and name the same kinds and skip the same ones."""
    _, paths, _ = ref
    src = tmp_path / "src"
    os.makedirs(src / "nested")
    os.link(paths["fan"], src / "nested" / "2DFAN4.pth")
    os.link(paths["lpips_lin"], src / "alex.pth")
    os.link(paths["talking_face"], src / "model_obama.pt")
    rel = lambda d, root: {k: os.path.relpath(v, root) for k, v in d.items()}
    a = jcw.convert_all(str(src), str(tmp_path / "a"))
    b = cw.convert_all(str(src), str(tmp_path / "b"))
    assert rel(a, tmp_path / "a") == rel(b, tmp_path / "b") == {
        "talking_face": "talking_face.ckpt", "fan": "fan_weights.ckpt"}


def test_converted_renderer_matches_jax(ref, tmp_path):
    """The converted talking_face.ckpt + unet.ckpt, rendered by the port's
    Renderer on the CPU and by the JAX renderer, float32."""
    _, paths, _ = ref
    out = str(tmp_path)
    cw.main(["talking_face", paths["talking_face"], out])
    tf_tree = ckpt.load_nested(os.path.join(out, "talking_face.ckpt"))[0]
    unet = ckpt.load_nested(os.path.join(out, "unet.ckpt"))[0]
    face, lip_h, lip_w, b = 32, 16, 24, 2
    raw, geo = synthetic_batch(b, face=face, lip_h=lip_h, lip_w=lip_w)
    box = jtf.expanded_lip_box(lip_h, lip_w, geo["lip_x"], geo["lip_y"])
    window = compute_warp_window([raw["coord"][i] for i in range(b)], box,
                                 face, face, margin=4)
    j = lambda t: jax.tree.map(jnp.asarray, t)
    want = jrender.render_face_batch(
        j(tf_tree), j(unet["params"]), j(unet["state"]), j(raw),
        lip_x=geo["lip_x"], lip_y=geo["lip_y"], lip_h=lip_h, lip_w=lip_w,
        use_pallas=False, compute_dtype=jnp.float32, window=window)
    cfg = default_config()
    cfg["data"].update(height=lip_h, width=lip_w)
    rnd = Renderer(cfg, *weights.from_jax(tf_tree, unet["params"],
                                          unet["state"]),
                   device="cpu", window=window)
    got = rnd({k: torch.from_numpy(np.array(v)) for k, v in raw.items()},
              geo["lip_x"], geo["lip_y"])
    for k in ("lip", "face"):
        g, w = got[k].numpy(), np.asarray(want[k], np.float32)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert float(np.abs(g - w).max()) <= 1e-5, k


class _Payload:
    """An object the weights-only unpickler must refuse."""
    ran = []

    def __reduce__(self):
        return (_Payload.ran.append, ("unpickled",))


def test_refused_blob_raises_with_its_name(tmp_path):
    path = str(tmp_path / "lipsync_expert.pth")
    torch.save({"state_dict": {}, "extra": _Payload()}, path)
    _Payload.ran.clear()
    with pytest.raises(pickle.UnpicklingError, match="lipsync_expert.pth"):
        cw.main(["syncnet", path, str(tmp_path / "out.ckpt")])
    assert _Payload.ran == []            # never unpickled in full
    assert not os.path.exists(tmp_path / "out.ckpt")


def test_deepspeech_pb_names_tensorflow(tmp_path, monkeypatch):
    """A .pb where TensorFlow is not installed (as on the GPU machine)."""
    pb = tmp_path / "deepspeech-0.1.0.pb"
    pb.write_bytes(b"\x00")
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="TensorFlow"):
        cw.convert_deepspeech(str(pb))


def test_talking_face_blob_layouts(ref, tmp_path):
    """model_may.pt's {"model": sd, ...} and a bare sd with "module."
    keys convert to the same files."""
    _, paths, trees = ref
    blob = torch.load(paths["talking_face"], weights_only=True)
    assert set(blob) == {"model", "it", "epoch_it", "loss_val_best"}
    bare = str(tmp_path / "model_bare.pt")
    torch.save({"module." + k: v for k, v in blob["model"].items()}, bare)
    for src, d in ((paths["talking_face"], "a"), (bare, "b")):
        os.makedirs(tmp_path / d)
        cw.main(["talking_face", src, str(tmp_path / d)])
    for name in ("talking_face.ckpt", "unet.ckpt"):
        _flat_equal(_npz(tmp_path / "a" / name), _npz(tmp_path / "b" / name))
    tf_p, up, us = trees["talking_face"]
    _flat_equal(ckpt.load_nested(str(tmp_path / "a" / "unet.ckpt"))[0],
                {"params": up, "state": us})


def test_converted_fan_name_gap(ref, tmp_path, monkeypatch):
    """The converter writes ``fan_weights.ckpt`` (as the JAX tool does);
    ``cli/preprocess`` reads ``fan.ckpt`` from ``--weights_dir``, so a
    converted FAN does not reach STEP1 without renaming, while
    ``cli/evaluate --lms-from-fan`` reads ``models/fan_weights.ckpt``.
    Both packages behave so (ROADMAP C); this pins the port to it."""
    _, paths, _ = ref
    assert cw.ALL_ARTIFACTS["fan"][0] == jcw.ALL_ARTIFACTS["fan"][0] \
        == "fan_weights.ckpt"
    models = tmp_path / "models"
    cw.main(["fan", paths["fan"], str(models / "fan_weights.ckpt")])
    root = tmp_path / "id"
    os.makedirs(root / "ori_images_face")
    with pytest.raises(FileNotFoundError, match="fan.ckpt"):
        cli_pre.main(["landmarks", "--root", str(root), "--weights_dir",
                      str(models), "--device", "cpu"])
    assert _evaluate_fan_default(monkeypatch) == "models/fan_weights.ckpt"
    # renamed, the converted FAN loads as STEP1's weights
    os.rename(models / "fan_weights.ckpt", models / "fan.ckpt")
    tree = ckpt.load_nested(str(models / "fan.ckpt"))[0]
    p, s = weights.fan_from_jax(tree["params"], tree["state"])
    assert len(p["hg"]) == 4


def _evaluate_fan_default(monkeypatch):
    """The path ``cli/evaluate --lms-from-fan`` reads by default: its
    parser's constant, caught before the CLI does any work."""
    import argparse

    class _Parsed(Exception):
        pass

    def capture(parser, *a, **k):
        raise _Parsed([x.const for x in parser._actions
                       if x.dest == "lms_from_fan"][0])

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as e:
        cli_evaluate.main(["--pred", "x", "--gt", "y"])
    return e.value.args[0]
