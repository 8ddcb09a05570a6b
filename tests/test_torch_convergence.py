"""The port's convergence run (speech2lip_tpu_torch.tools.convergence_run)
at a CPU size, across the sync boundary with a pretrained teacher: its
report has the JAX tool's keys, read from ``tools/convergence_run.py``
with ``ast``, and every value is finite.  The JAX run itself is not
repeated: tests/test_torch_eval.py, test_torch_syncnet_pretrain.py and
test_torch_fit.py hold its parts to the JAX package's.  Also: the new
entry points ask for the card by default and raise where there is none.
"""

import ast
import math
import pathlib

import pytest
import torch

from speech2lip_tpu_torch.tools import convergence_run

torch.set_num_threads(2)

JAX_TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "convergence_run.py"


def _jax_report_keys():
    """The keys of ``report = {...}`` and ``report.update({...})`` in the
    JAX tool's ``main``."""
    keys = []
    for node in ast.walk(ast.parse(JAX_TOOL.read_text())):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets]
                == ["report"]):
            keys += [k.value for k in node.value.keys]
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"
                and getattr(node.func.value, "id", None) == "report"):
            keys += [k.value for k in node.args[0].keys]
    return keys


def _finite(x, where="report"):
    if isinstance(x, dict):
        for k, v in x.items():
            _finite(v, f"{where}.{k}")
    elif isinstance(x, list):
        for i, v in enumerate(x):
            _finite(v, f"{where}[{i}]")
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        assert math.isfinite(x), where
    else:
        assert isinstance(x, (str, bool)), (where, x)


def test_convergence_run_at_a_cpu_size(tmp_path):
    parts = []

    class Part:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            parts.append(self.name)

        def __exit__(self, *exc):
            return False

    report = convergence_run.main(
        ["--out", str(tmp_path / "conv"), "--device", "cpu", "--face", "48",
         "--frames", "24", "--val-frames", "8", "--iters", "4",
         "--validate-every", "2", "--batch", "2", "--sync-start-iter", "2",
         "--pretrain-teacher", "2", "--json", str(tmp_path / "r.json")],
        part=Part)
    want = _jax_report_keys()
    assert len(want) == 17 and "sync_conf_delta" in want
    assert list(report) == want
    _finite(report)
    assert report["best_checkpoint_selected"]
    assert len(report["teacher_bce_history"]) == 2
    assert [r["it"] for r in report["loss_sync_trajectory"]] == [3, 4]
    for k in ("rendered_val_metrics", "presync_val_metrics",
              "postsync_val_metrics"):
        assert report[k]["n_frames"] == 8
        assert report[k]["lmd_detector"] == "tiny"
    renders = ("convergence", "conv_presync", "conv_postsync")
    assert parts == ["teacher", "fit"] + [f"{p}:{r}" for r in renders
                                         for p in ("infer", "evaluate")]


@pytest.mark.parametrize("entry", ["evaluate", "train_syncnet",
                                   "convergence_run"])
def test_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    from speech2lip_tpu_torch.cli import evaluate, train_syncnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path)
    run = {"evaluate": lambda: evaluate.main(["--pred", d, "--gt", d]),
           "train_syncnet": lambda: train_syncnet.main(
               [str(JAX_TOOL.parents[1] / "configs" / "may" / "may.yaml"),
                "--out", d + "/t.ckpt"]),
           "convergence_run": lambda: convergence_run.main(
               ["--out", d + "/conv"])}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
