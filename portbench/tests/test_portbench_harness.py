"""The harness: it finds every file by name, a new cell needs only new
files and entries, its last line has the contract's keys, and it refuses to
run without the card."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.core import harness, registry
from portbench.tests import small

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_registry_finds_every_file_of_a_cell(name):
    c = registry.Cell(name, BENCH)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["driver"] in ("serve", "train")
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert c.end_to_end and c.per_layer
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert callable(registry.metric_module(m["name"]).read)


def test_every_config_and_metric_has_its_file():
    for conf in BENCH["configs"]:
        assert (registry.ROOT / conf["file"]).is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in BENCH["per_layer"]:
        assert (registry.HERE / "metrics" / f"{m['name']}.py").is_file()


def _check_line(out, trace):
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["attempted"] > 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_schema(trace):
    c = small.cell("serve.dub-b32")
    out = harness.run(c, 2 ** 31 + 11, 0.3, trace, small.CPU, 0.0)
    _check_line(out, trace)
    names = set(out["metrics"])
    if trace:
        assert {"enqueue_ms.serve", "mfu.serve"} <= names
    else:
        assert names == {"frames_per_s", "batch_p95_ms", "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_training_last_line_schema(trace, tmp_path):
    c = small.cell("train.stage1-b1")
    c.build_dir = tmp_path
    out = harness.run(c, 2 ** 31 + 13, 0.3, trace, small.CPU, 0.0)
    _check_line(out, trace)
    names = set(out["metrics"])
    if trace:
        assert {"batch_build_ms", "step_ms", "mfu.train"} <= names
    else:
        assert names == {"iter_ms", "setup_s"}


def test_device_ms_is_busy_time_per_iteration():
    mod = registry.metric_module("device_ms.train")

    class Busy:
        busy_s = 3.0
    assert mod.read({"trace": Busy(), "iters": 20}) == 150.0
    assert mod.read({"trace": None, "iters": 20}) is None


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A dummy cell, with its own traffic mix, limits and per-layer metric,
    added without editing any file of the benchmark."""
    root = tmp_path / "checkout"
    shutil.copytree(registry.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "serve.dummy-b2", "config": "may.serve",
                               "traffic": "dummy-b2", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "frames_per_s" == m["name"]:
            m["workloads"].append("serve.dummy-b2")
    bench["per_layer"].append({"name": "frames.dummy", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving entry",
                               "moves": "frames_per_s",
                               "workloads": ["serve.dummy-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((registry.HERE / "workloads" / "dub-b32.json")
                         .read_text())
    traffic["batch"] = 2
    (root / "portbench" / "workloads" / "dummy-b2.json").write_text(
        json.dumps(traffic))
    (root / "portbench" / "limits" / "serve.dummy-b2.json").write_text(
        (registry.HERE / "limits" / "serve.dub-b32.json").read_text())
    (root / "portbench" / "metrics" / "frames.dummy.py").write_text(
        "def read(ctx):\n    return float(ctx['frames'])\n")
    c = small.cell("serve.dummy-b2", bench=bench, root=root)
    out = harness.run(c, 5, 0.2, True, small.CPU, 0.0)
    assert out["metrics"]["frames.dummy"]["value"] > 0
    out = harness.run(c, 5, 0.2, False, small.CPU, 0.0)
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}


class _Trace:
    def kernel_seconds(self, pattern):
        return 2.0

    def kernel_count(self, pattern):
        return 10


@pytest.mark.parametrize("name", ["fused_block_roofline",
                                  "fused_mlp_roofline"])
def test_roofline_holds_the_trace_to_the_ports_counter(name):
    """A roofline reads the port's own launch counter: silent where no
    call launched the kernel or the trace holds fewer launches than the
    calls; the counter is an attribute of the port."""
    mod = registry.metric_module(name)
    kern = name[:-len("_roofline")]
    ctx = {"trace": _Trace(), "kernels": {kern: {"bound_s": 0.5}}}
    assert mod.read(dict(ctx, counters={mod.COUNTER: 0})) is None
    assert mod.read(dict(ctx, counters={mod.COUNTER: 11})) is None
    assert mod.read(dict(ctx, counters={mod.COUNTER: 5})) == 25.0
    assert set(harness.read_counters([mod])) == {mod.COUNTER}


def test_run_refuses_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the machine without one")
    p = subprocess.run(
        [sys.executable, str(registry.HERE / "run.py"), "--workload",
         "serve.dub-b32", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=registry.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_forbidden_modules_compare_whole_names(monkeypatch):
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "speech2lip_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "speech2lip_tpu_torch.infer", sys)
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert set(harness.forbidden_modules()) == before | {"flax"}


def test_host_threads_hold_the_pools_and_restore_them():
    from portbench.core import device
    before = torch.get_num_threads()
    with device.host_threads(1):
        assert torch.get_num_threads() == 1
    assert torch.get_num_threads() == before
    with device.host_threads(None):
        assert torch.get_num_threads() == before
