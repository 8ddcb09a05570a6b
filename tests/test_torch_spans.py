"""The port's host spans (``speech2lip_tpu_torch.core.spans``) on the CPU.

Tracing is off by default and records nothing; with it on, each path gives
the same outputs bit for bit, records exactly its spans, nested under one
root per batch or step, and never synchronises the device.  Self time is
a span's duration less its children's, as the benchmark's reduction
(``portbench/core/program_spans.py``) computes it.
"""

import collections
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from speech2lip_tpu_torch.core import spans
from speech2lip_tpu_torch.data import synthetic as tsyn
from speech2lip_tpu_torch.data.dataset import LipDataset, stack_batch
from speech2lip_tpu_torch.infer.renderer import Renderer
from speech2lip_tpu_torch.infer.static_scene import StaticSceneRenderer
from speech2lip_tpu_torch.train import train_step as ts
from speech2lip_tpu_torch.train import trainer

PATHS = ("renderer", "static_scene", "build", "step")
BATCH = 2
RENDER = ["render", "render.lip", "render.composite", "render.unet"]
# the frame's spans in LipDataset.load_frame, once per frame of a batch
FRAME = ["build.read", "build.sync_extras", "build.warp"]
# each path's roots and the spans under each, by name
EXPECTED = {
    "renderer": {"render": RENDER},
    "static_scene": {"render": RENDER},
    "build": {"build": ["build"] + FRAME * BATCH + ["build.stack"],
              "build.copy": ["build.copy"]},
    "step": {"step": ["step", "step.forward", "step.backward",
                      "step.update", "step.update"]},
}


@pytest.fixture
def tracing():
    """Tracing as the test leaves it: restored, with no records kept."""
    was = spans.enabled()
    spans.clear()
    yield spans
    spans.enable(was)
    spans.clear()


@pytest.fixture(scope="module")
def identity(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spans") / "tree")
    geo = tsyn.make_synthetic_tree(root, n_frames=9, face=64, lip_h=16,
                                   lip_w=24)
    cfg = tsyn.synthetic_config(root, geo)
    ds = LipDataset(root, "train", cfg)
    assert ds.use_syncloss and ds.use_blackaug
    return cfg, ds, geo


def _programs(cfg, ds, geo):
    """Each path as a function of nothing that returns its outputs; built
    with tracing off."""
    params, up, us, frozen = trainer.init_models(cfg, ds, 0, "cpu")
    host = stack_batch([ds.load_frame(i) for i in range(BATCH)])
    window = trainer.warp_window(cfg, ds)
    renderer = Renderer(cfg, params, up, us, device="cpu", window=window)
    batch = trainer.to_device(host, "cpu")
    static = StaticSceneRenderer(cfg, params, up, us, ds.load_frame(0),
                                 window, geo["lip_x"], geo["lip_y"],
                                 device="cpu")
    st = trainer.build_statics(cfg, ds, 0, "cpu")
    opt = ts.make_optimizer(cfg)
    state = ts.init_train_state(params, up, us, opt)
    step = ts.make_train_step(opt, st, frozen)
    tbatch = {k: v for k, v in batch.items() if k not in trainer._SYNC_KEYS}
    gen = torch.Generator().manual_seed(5)
    draws = ts.draw_noise(st, BATCH, "cpu", gen)

    def build():
        host = next(trainer.batch_iterator(ds, BATCH, shuffle=True, seed=3,
                                           use_native=False))
        return host, trainer.to_device(host, "cpu")

    def train():
        new, m = step(state, tbatch, draws)
        return ts.tree_leaves({"model": new.params, "unet": new.unet_params,
                               "state": new.unet_state}), new.opt_state, m

    return {
        "renderer": lambda: renderer(batch, geo["lip_x"], geo["lip_y"]),
        "static_scene": lambda: static(batch["audio"], batch["index"]),
        "build": build,
        "step": train,
    }


@pytest.fixture(scope="module")
def runs(identity):
    """Each path run with tracing off, then on: (outputs off, outputs on,
    records on, torch.cuda.synchronize calls while on)."""
    was = spans.enabled()
    out = {}
    try:
        for name, run in _programs(*identity).items():
            spans.enable(False)
            spans.clear()
            off = run()
            assert spans.records() == [], name
            calls = []
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(torch.cuda, "synchronize",
                           lambda *a, **k: calls.append(a))
                spans.enable()
                on = run()
                spans.enable(False)
            out[name] = (off, on, spans.records(), calls)
    finally:
        spans.enable(was)
        spans.clear()
    return out


def test_tracing_is_off_by_default():
    code = ("from speech2lip_tpu_torch.core import spans\n"
            "a = spans.span('x')\n"
            "with a:\n    pass\n"
            "assert not spans.enabled() and a is spans.span('y')\n"
            "assert spans.records() == []\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60)


def test_a_disabled_span_records_nothing(tracing):
    spans.enable(False)
    with spans.span("render"):
        with spans.span("render.lip"):
            pass
    assert spans.records() == []


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("path", PATHS)
def test_outputs_are_bit_identical_with_tracing_on(runs, path):
    off, on, _, _ = runs[path]
    _same(off, on)


def _root(r, by_id):
    while r.parent_id is not None:
        r = by_id[r.parent_id]
    return r


@pytest.mark.parametrize("path", PATHS)
def test_each_path_records_its_spans_under_one_root(runs, path):
    _, _, recs, _ = runs[path]
    by_id = {r.id: r for r in recs}
    trees = collections.defaultdict(list)
    for r in recs:
        trees[_root(r, by_id).id].append(r)
    got = {by_id[i].name: sorted(r.name for r in t)
           for i, t in trees.items()}
    assert len(got) == len(trees)        # one root of each name
    assert got == {k: sorted(v) for k, v in EXPECTED[path].items()}
    for r in recs:
        assert r.start_ns <= r.end_ns
        assert r.thread_id == threading.get_ident()
        if r.parent_id is not None:
            p = by_id[r.parent_id]
            assert r.name.startswith(p.name + ".")
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


@pytest.mark.parametrize("path", PATHS)
def test_no_span_synchronises_the_device(runs, path):
    assert runs[path][3] == []


def test_a_span_on_another_thread_is_a_root_of_that_thread(tracing):
    spans.enable()
    with spans.span("step"):
        t = threading.Thread(target=lambda: spans.span("build").__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    inner, outer = spans.records()
    assert (inner.name, inner.parent_id) == ("build", None)
    assert inner.thread_id != outer.thread_id == threading.get_ident()


def test_self_time_is_duration_less_children(tracing):
    from portbench.core import program_spans as P
    spans.enable()
    with spans.span("step"):
        time.sleep(0.002)
        with spans.span("step.forward"):
            time.sleep(0.003)
        with spans.span("step.backward"):
            time.sleep(0.001)
    recs = spans.records()
    root = next(r for r in recs if r.parent_id is None)
    kids = [(r.start_ns, r.end_ns) for r in recs if r.parent_id == root.id]
    want = (root.end_ns - root.start_ns) - sum(e - s for s, e in kids)
    assert len(kids) == 2 and 0 < want < root.end_ns - root.start_ns
    assert P.self_time(root.start_ns, root.end_ns, kids) == want

    class Trace:       # the window holds every span; no device activity
        window = (root.start_ns / 1e3, root.end_ns / 1e3)
        union = []
    w = P.Window(recs, Trace())
    assert w.self_us["step"] == pytest.approx(want / 1e3)
    for r in recs:
        if r.parent_id is not None:
            assert w.self_us[r.name] == pytest.approx(
                (r.end_ns - r.start_ns) / 1e3)
