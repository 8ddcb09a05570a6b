"""The serving entry's share of batches served by a replay of its CUDA
graphs (``graph_replay_pct.serve``): what it reads, its entry, and a
traced shrunk run on the CPU, where the program never captures and the
share is silent."""

import pytest

from portbench.core import harness, registry
from portbench.tests import small

NAME = "graph_replay_pct.serve"
BENCH = registry.benchmark()


class _Trace:
    def __init__(self, busy_s):
        self.busy_s = busy_s


def test_reads_replays_over_batches():
    mod = registry.metric_module(NAME)
    assert mod.COUNTER == "speech2lip_tpu_torch.infer.graphs:replays"
    ctx = {"counters": {mod.COUNTER: 47}, "batches": 50}
    assert mod.read(ctx) == pytest.approx(94.0)
    ctx["trace"] = _Trace(1.5)
    assert mod.read(ctx) == pytest.approx(94.0)
    # on the card a window that never replayed reads 0, not silence
    assert mod.read({"counters": {mod.COUNTER: 0}, "batches": 9,
                     "trace": _Trace(1.5)}) == 0.0


@pytest.mark.parametrize("ctx", [{"counters": {}, "batches": 50},
                                 {"batches": 50},
                                 {"counters": {"x:y": 3}, "batches": 0}])
def test_silent_without_its_counter(ctx):
    assert registry.metric_module(NAME).read(ctx) is None


def test_silent_where_no_device_ran():
    mod = registry.metric_module(NAME)
    assert mod.read({"counters": {mod.COUNTER: 0}, "batches": 9,
                     "trace": _Trace(0.0)}) is None


def test_silent_in_a_program_without_graphs(monkeypatch):
    """A program without ``infer.graphs`` (the module is not found):
    no counter for the harness to read, and the reader returns None."""
    import importlib.util
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda n, *a: (
        None if n.endswith("infer.graphs") else real(n, *a)))
    mod = registry.metric_module(NAME)
    assert mod.COUNTER is None
    assert harness.read_counters([mod]) == {}
    assert mod.read({"counters": {}, "batches": 50}) is None


def test_its_entry():
    m = {x["name"]: x for x in BENCH["per_layer"]}[NAME]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "%", "higher", "program_counter", "serving entry", "frames_per_s")
    assert m["workloads"] == ["serve.dub-b32", "serve.avatar-b8"]
    assert BENCH["per_layer"][-1] is m


@pytest.mark.parametrize("name", ["serve.dub-b32", "serve.avatar-b8"])
def test_a_traced_cpu_run_is_silent(name, tmp_path):
    """On the CPU the program never captures and the trace holds no
    device activity: the share is left out of the line."""
    c = small.cell(name)
    c.build_dir = tmp_path
    out = harness.run(c, 2 ** 31 + 31, 0.3, True, small.CPU, 0.0)
    assert out["correct"] is True
    assert NAME in {m["name"] for m in c.per_layer}
    assert NAME not in out["metrics"]
