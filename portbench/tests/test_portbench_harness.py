"""The harness: it finds every file by name, a new cell (serving, with the
serving driver or a driver of its own, or training in another stage) needs
only new files and entries, its last line has the contract's keys, and it
refuses to run without the card."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.core import harness, registry
from portbench.reference import compare
from portbench.tests import small

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_registry_finds_every_file_of_a_cell(name):
    c = registry.Cell(name, BENCH)
    assert c.config["name"] == c.entry["config"]
    assert (registry.HERE / "drivers" / f"{c.traffic['driver']}.py").is_file()
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
    for m in BENCH["per_layer"] + [e for e in BENCH["end_to_end"]
                                   if e["source"] == "device_trace"]:
        assert (registry.HERE / "metrics" / f"{m['name']}.py").is_file()


# what ``small.cell`` changes in each cell's configuration and traffic, by
# the rule of its driver: (path of keys, value)
LIP_64 = {"x": 20, "y": 30, "h": 16, "w": 24}
SERVE_TRAFFIC = {("batch",): 4, ("frames",): 24, ("warmup_batches",): 1,
                 ("check", "batches"): 2, ("check", "within"): 3}
SMALL = {
    "serve.dub-b32": (
        {("geometry", "face"): 64,
         **{("geometry", "lip", k): v for k, v in LIP_64.items()},
         ("config", "data", "height"): 16, ("config", "data", "width"): 24},
        SERVE_TRAFFIC),
    "serve.avatar-b8": (
        {("geometry", "face"): 320, ("geometry", "lip", "x"): 128,
         ("geometry", "lip", "y"): 150, ("geometry", "lip", "h"): 48,
         ("geometry", "lip", "w"): 64,
         ("config", "data", "height"): 48, ("config", "data", "width"): 64},
        SERVE_TRAFFIC),
    "train.stage1-b1": (
        {("geometry", "face"): 64,
         **{("geometry", "lip", k): v for k, v in LIP_64.items()},
         ("config", "data", "height"): 16, ("config", "data", "width"): 24,
         ("identity_frames",): 12},
        {("identity", "face"): 64,
         **{("identity", "lip", k): v for k, v in LIP_64.items()}}),
}


def _leaves(tree, path=()):
    if not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, path + (k,)))
    return out


def _changed(before, after):
    """{path: value after} of every leaf that differs, is new or is gone
    (``None``)."""
    a, b = _leaves(before), _leaves(after)
    return {p: b.get(p) for p in a.keys() | b.keys() if a.get(p) != b.get(p)}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_sizes_are_pinned(name):
    """The CPU test sizes of the three cells, key for key: what their
    drivers' ``small`` change, and nothing else."""
    c, s = registry.Cell(name, BENCH), small.cell(name)
    config, traffic = SMALL[name]
    assert _changed(c.config, s.config) == config
    assert _changed(c.traffic, s.traffic) == traffic


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
        assert {"batch_build_ms", "step_ms", "mfu.train",
                "iter_ms.train"} <= names
    else:
        # the CPU records no device trace: the host clock's metrics alone
        assert names == {m["name"] for m in c.end_to_end
                         if m["source"] == "host_clock"} == {"setup_s"}


def _busy_ms(monkeypatch, ms=1.0):
    """An untraced run on the CPU records its window as on the card, and
    its trace reads ``ms`` of device activity."""
    from portbench.core import trace as T
    real = T.from_profiler

    def busy(prof, rec):
        tr = real(prof, rec)
        tr.union = [(tr.window[0], tr.window[0] + 1e3 * ms)]
        return tr
    monkeypatch.setattr(harness, "device_window", lambda cell, dev: True)
    monkeypatch.setattr(T, "from_profiler", busy)


def test_an_end_to_end_metric_of_the_device_trace(monkeypatch, tmp_path):
    """``iter_device_ms`` is read from the window's device trace in an
    untraced run: the busy time over the window's iterations, beside the
    host clock's metrics, and no per-layer metric or breakdown."""
    c = small.cell("train.stage1-b1")
    c.build_dir = tmp_path
    assert [m["name"] for m in c.end_to_end
            if m["source"] == "device_trace"] == ["iter_device_ms"]
    _busy_ms(monkeypatch, 6.0)
    out = harness.run(c, 2 ** 31 + 31, 0.3, False, small.CPU, 0.0)
    _check_line(out, False)
    assert set(out["metrics"]) == {"iter_device_ms", "setup_s"}
    assert out["metrics"]["iter_device_ms"]["value"] == pytest.approx(
        6.0 / out["attempted"])
    assert "breakdown" not in out and "busy_s" not in out["device"]


def test_device_ms_is_busy_time_per_iteration():
    mod = registry.metric_module("device_ms.train")

    class Busy:
        busy_s = 3.0
    assert mod.read({"trace": Busy(), "iters": 20}) == 150.0
    assert mod.read({"trace": None, "iters": 20}) is None


def test_host_iteration_is_the_window_over_its_iterations():
    mod = registry.metric_module("iter_ms.train")
    assert mod.read({"window_s": 30.0, "iters": 60}) == 500.0
    assert mod.read({"window_s": 30.0, "iters": 0}) is None


@pytest.mark.parametrize("name", CELLS)
def test_only_a_device_metric_records_an_untraced_window(name):
    """An untraced run records the device's activity only on the card and
    only for a cell that ``BENCHMARK.json`` lists under an end-to-end
    metric of the device trace (its ``source`` and ``workloads``)."""
    c = registry.Cell(name, BENCH)
    device = any(name in m.get("workloads", CELLS)
                 for m in BENCH["end_to_end"]
                 if m["source"] == "device_trace")
    assert harness.device_window(c, torch.device("cuda", 0)) is device
    assert harness.device_window(c, small.CPU) is False


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


# A stand-in for a sync-stage reference, written into the temporary
# checkout: it reads the batches and follows the steps through the program.
STANDIN = '''
import numpy as np
from portbench.traffic.weights import tree_leaves, tree_paths
from speech2lip_tpu_torch.data.dataset import LipDataset, stack_batch
from speech2lip_tpu_torch.train import train_step as ts, trainer


def read_batches(root, cfg, indices):
    ds = LipDataset(root, "train", cfg)
    return [stack_batch([ds.load_frame(int(i)) for i in idx])
            for idx in indices]


def steps(cfg, weights, frozen, batches, draws, precision="f32"):
    tr = cfg["training"]
    ds = LipDataset(cfg["data"]["path"], "train", cfg)
    start = max(tr["sync_start_iter"], tr["postnet_freeze_iter"]) + 1
    dev = batches[0]["audio"].device
    st = trainer.build_statics(cfg, ds, start, dev)
    params, up, us = weights
    opt = ts.make_optimizer(cfg)
    leaves = ts.tree_leaves({"model": params, "unet": up})
    state = ts.TrainState(params, up, us, opt.init(leaves), start)
    step = ts.make_train_step(opt, st, frozen)
    out = {"loss": [], "grad_norm": []}
    paths = tree_paths({"model": params, "unet": up})
    for k, (b, d) in enumerate(zip(batches, draws)):
        state, m = step(state, b, d)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if k == 0:
            out["grad"] = {p: g / (1.0 - opt.b1) for p, g in
                           zip(paths, state.opt_state["mu"])}
    out["params"] = dict(zip(paths, tree_leaves(
        {"model": state.params, "unet": state.unet_params})))
    return out
'''


def _hashes(top):
    return {p.relative_to(top): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(top.rglob("*")) if p.is_file()}


def test_a_new_training_cell_is_new_files_and_entries(tmp_path, monkeypatch):
    """A training cell of May's sync stage (its configuration starts past
    ``sync_start_iter`` and ``postnet_freeze_iter``, with the served
    weights), with its own traffic mix, limits, per-layer metric and a
    stand-in reference, added without editing any file of the benchmark:
    the step takes the sync branch, and the run reports the cell's
    metrics."""
    from portbench.drivers import train as driver
    root = tmp_path / "checkout"
    shutil.copytree(registry.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _hashes(root / "portbench")
    conf = json.loads((registry.HERE / "configs" / "may.train.json")
                      .read_text())
    tr = conf["config"]["training"]
    conf.update(name="may.sync-test", weights="served",
                start_iter=max(tr["sync_start_iter"],
                               tr["postnet_freeze_iter"]) + 1,
                reference="portbench/reference/standin_sync.py")
    pb = root / "portbench"
    (pb / "configs" / "may.sync-test.json").write_text(json.dumps(conf))
    (pb / "reference" / "standin_sync.py").write_text(STANDIN)
    (pb / "workloads" / "sync-test.json").write_text(
        (registry.HERE / "workloads" / "stage1-b1.json").read_text())
    (pb / "limits" / "train.sync-test.json").write_text(
        (registry.HERE / "limits" / "train.stage1-b1.json").read_text())
    (pb / "metrics" / "iters.sync-test.py").write_text(
        "def read(ctx):\n    return float(ctx['iters'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "may.sync-test",
                             "source": BENCH["configs"][1]["source"],
                             "file": "portbench/configs/may.sync-test.json",
                             "reduced": ["identity_frames"], "why": "a test"})
    bench["workloads"].append({"name": "train.sync-test",
                               "config": "may.sync-test",
                               "traffic": "sync-test", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "train.stage1-b1" in m.get("workloads", []):
            m["workloads"].append("train.sync-test")
    bench["per_layer"].append({"name": "iters.sync-test", "unit": "iters",
                               "better": "higher", "source": "host_clock",
                               "layer": "training loop",
                               "moves": "iter_device_ms",
                               "workloads": ["train.sync-test"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    sessions = []
    setup = driver.Session.setup

    def kept(self):
        setup(self)
        sessions.append(self)
    monkeypatch.setattr(driver.Session, "setup", kept)
    c = small.cell("train.sync-test", bench=bench, root=root)
    c.build_dir = tmp_path / "build"
    with monkeypatch.context() as mp:
        _busy_ms(mp)
        out = harness.run(c, 2 ** 31 + 17, 0.3, False, small.CPU, 0.0)
    _check_line(out, False)
    assert set(out["metrics"]) == {"iter_device_ms", "setup_s"}
    out = harness.run(c, 2 ** 31 + 19, 0.3, True, small.CPU, 0.0)
    _check_line(out, True)
    assert set(out["metrics"]) == {"iters.sync-test"}
    for s in sessions:
        assert s.st.sync_on and s.st.postnet_frozen
        assert "syncnet" in s.frozen
        assert all("loss_sync" in k["terms"] for k in s.checked)
    assert len(sessions) == 2
    after = _hashes(root / "portbench")
    assert {p: after[p] for p in before} == before


# A stand-in for a serving cell with a driver of its own, written into the
# temporary checkout as ``portbench/drivers/serve_standin.py``.
STANDIN_DRIVER = '''"""A stand-in serving driver: requests of several lengths, each one's
audio windows made on the host as ``cli/serve`` reads a ``.npy`` request,
cut into batches of the ``StaticSceneRenderer`` at the request's own frame
indices; the window shape is the configuration's ``speech`` section."""

import numpy as np
import torch

from portbench.drivers import serve
from portbench.traffic import draws as D

CONTROL = {"standin-fp8": "fp8"}


def small(config, traffic):
    config, traffic = serve.small(config, traffic)
    return config, dict(traffic, lengths=[6, 3])


def control_precision(cell):
    return "standin-fp8"


class Session(serve.Session):
    def setup(self):
        sp = self.cell.config["speech"]
        # the seed's own order of the lengths, and the windows: the
        # ``order`` stream, which the serving driver draws nothing from
        rng = D.rng(self.seed, "order")
        self.plan = []
        for n in rng.permutation(self.tr["lengths"]):
            audio = rng.standard_normal(
                (int(n), sp["window"], sp["features"]), dtype=np.float32)
            for s in range(0, int(n), self.batch):
                a = audio[s:s + self.batch]
                self.plan.append((a, np.arange(s, s + len(a),
                                               dtype=np.float32)))
        super().setup()

    def _batch(self, k):
        return self.plan[k % len(self.plan)]

    def _call(self, k):
        return {"face": self.program(*self._batch(k))}

    def _inputs(self, k):
        return {key: torch.from_numpy(v).to(self.dev)
                for key, v in zip(("audio", "index"), self._batch(k))}

    def frames(self):
        return sum(len(self._batch(k)[1]) for k in range(self.batches))

    def end_to_end(self):
        return dict(super().end_to_end(),
                    frames_per_s=self.frames() / self.window_s)

    def context(self):
        begun = sum(self._batch(k)[1][0] == 0 for k in range(self.batches))
        return dict(super().context(), frames=self.frames(),
                    requests=int(begun))

    def control(self, precision):
        return super().control(CONTROL[precision])
'''


def test_a_new_serving_driver_is_new_files_and_entries(tmp_path, monkeypatch,
                                                       request):
    """A serving cell with a driver of its own (a stand-in: requests of
    several lengths from the host, cut into batches of the static scene),
    with its own configuration section, traffic mix, limits and per-layer
    metric, added without editing any file of the benchmark: the harness
    finds every file, ``small.cell`` shrinks it by the driver's own rule,
    it runs correct untraced and traced, and its control is the one the
    driver names."""
    from portbench import calibrate, drivers
    from portbench.drivers import serve
    root = tmp_path / "checkout"
    shutil.copytree(registry.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "portbench"
    before = _hashes(pb)
    conf = json.loads((registry.HERE / "configs" / "may.serve.json")
                      .read_text())
    conf.update(name="may.standin", speech={"window": 16, "features": 29})
    (pb / "configs" / "may.standin.json").write_text(json.dumps(conf))
    (pb / "drivers" / "serve_standin.py").write_text(STANDIN_DRIVER)
    (pb / "workloads" / "standin-b8.json").write_text(json.dumps({
        "driver": "serve_standin", "path": "static_scene", "batch": 8,
        "frames": 600, "lengths": [50, 125, 250], "warmup_batches": 3,
        "check": {"batches": 3, "within": 48}}))
    (pb / "limits" / "serve.standin-b8.json").write_text(
        (registry.HERE / "limits" / "serve.avatar-b8.json").read_text())
    (pb / "metrics" / "requests.standin.py").write_text(
        "def read(ctx):\n    return float(ctx['requests'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "may.standin",
                             "source": BENCH["configs"][0]["source"],
                             "file": "portbench/configs/may.standin.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "serve.standin-b8",
                               "config": "may.standin",
                               "traffic": "standin-b8", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("serve.standin-b8")
    bench["per_layer"].append({"name": "requests.standin",
                               "unit": "requests", "better": "higher",
                               "source": "host_clock",
                               "layer": "serving entry",
                               "moves": "frames_per_s",
                               "workloads": ["serve.standin-b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    name = "portbench.drivers.serve_standin"

    def forget():
        sys.modules.pop(name, None)
        drivers.__dict__.pop("serve_standin", None)
    request.addfinalizer(forget)
    monkeypatch.setattr(drivers, "__path__",
                        [*drivers.__path__, str(pb / "drivers")])

    full = registry.Cell("serve.standin-b8", bench, root)
    assert full.config["speech"] == {"window": 16, "features": 29}
    assert full.traffic["lengths"] == [50, 125, 250]
    assert full.limits == registry.Cell("serve.avatar-b8", BENCH).limits
    assert {m["name"] for m in full.end_to_end} == {"frames_per_s",
                                                    "setup_s"}
    assert [m["name"] for m in full.per_layer] == ["requests.standin"]
    assert callable(registry.metric_module("requests.standin", root).read)
    c = small.cell("serve.standin-b8", bench=bench, root=root)
    assert small.driver(c).__name__ == name
    assert c.traffic["lengths"] == [6, 3] and c.traffic["batch"] == 4
    assert c.config["geometry"]["face"] == 320
    assert c.config["speech"] == full.config["speech"]
    assert calibrate.control_precision(c) == "standin-fp8"

    sessions = []
    setup = serve.Session.setup

    def kept(self):
        setup(self)
        sessions.append(self)
    monkeypatch.setattr(serve.Session, "setup", kept)
    out = harness.run(c, 2 ** 31 + 23, 0.3, False, small.CPU, 0.0)
    _check_line(out, False)
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    out = harness.run(c, 2 ** 31 + 37, 0.3, True, small.CPU, 0.0)
    _check_line(out, True)
    assert set(out["metrics"]) == {"requests.standin"}
    assert len(sessions) == 2
    for s in sessions:
        assert type(s).__module__ == name
        assert sorted(len(i) for _, i in s.plan) == [2, 3, 4]
    ctrl = compare.judge(sessions[-1].control(calibrate.control_precision(c)),
                         c.limits)
    assert not compare.passed(ctrl), ctrl
    after = _hashes(pb)
    assert {p: after[p] for p in before} == before


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
