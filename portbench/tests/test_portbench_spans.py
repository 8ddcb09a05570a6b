"""The per-layer metrics that read the program's own spans
(``portbench/core/program_spans.py``): a traced shrunk run of each cell
reports every host-time part above 0 on the CPU, where the idle readers are
silent; every reader is silent on a window with no program span; the
program's spans lie on the ``Recorder``'s clock; and each idle gap goes to
the innermost span of the main thread."""

import threading

import pytest

from portbench.core import harness, program_spans as P, registry
from portbench.core import trace as T
from portbench.tests import small
from speech2lip_tpu_torch.core import spans

BENCH = registry.benchmark()
SERVE = [f"{k}{idle}_ms.serve" for k in ("lip", "composite", "unet")
         for idle in ("", "_idle")]
TRAIN = [f"{k}_ms.train" for k in ("read", "warp", "sync_extras", "stack",
                                    "copy", "forward", "backward", "update")]
SPAN_METRICS = {m["name"]: m for m in BENCH["per_layer"]
                if m["name"] in SERVE + TRAIN}


def test_fourteen_span_metrics():
    assert len(SPAN_METRICS) == 14
    for name, m in SPAN_METRICS.items():
        src = (registry.HERE / "metrics" / f"{name}.py").read_text()
        assert "program_spans" in src
        assert m["source"] == ("device_trace" if "_idle_" in name
                               else "program_counter")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_run_reports_every_part(name, tmp_path):
    c = small.cell(name)
    c.build_dir = tmp_path
    out = harness.run(c, 2 ** 31 + 29, 0.4, True, small.CPU, 0.0)
    assert out["correct"] is True
    mine = {m["name"]: m for m in c.per_layer if "program_spans" in (
        c.root / "portbench" / "metrics" / f"{m['name']}.py").read_text()}
    host = {n for n, m in mine.items() if m["source"] == "program_counter"}
    assert host
    got = out["metrics"]
    for n in host:
        assert got[n]["value"] > 0, n
    # the CPU trace holds no device activity: the idle readers are silent
    assert not (set(mine) - host) & set(got)


class _Trace:
    window = (1000.0, 2000.0)
    union = [(1000.0, 1500.0)]
    busy_s = 5e-4


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_a_reader_is_silent_without_program_spans(name):
    mod = registry.metric_module(name)
    spans.clear()
    with spans.span("render"):        # a span on the clock, outside 1-2 ms
        pass
    ctx = {"trace": _Trace(), "batches": 3, "iters": 3}
    assert mod.read(ctx) is None
    assert mod.read(dict(ctx, trace=None)) is None
    spans.clear()


def test_program_spans_lie_in_the_recorders_window(monkeypatch):
    recorders = []

    class Recorder(T.Recorder):
        def __init__(self, device):
            super().__init__(device)
            recorders.append(self)

    monkeypatch.setattr(harness.T, "Recorder", Recorder)
    monkeypatch.setattr(spans, "clear", lambda: None)   # keep the records
    monkeypatch.setattr(spans, "_records", [])
    out = harness.run(small.cell("serve.dub-b32"), 2 ** 31 + 31, 0.3, True,
                      small.CPU, 0.0)
    recs = spans.records()
    rec, = recorders
    w0, w1 = rec.window
    roots = [r for r in recs if r.name == "render" and w0 <= r.start_ns <= w1]
    assert len(roots) == out["attempted"] > 0
    enq = [(s, e) for n, s, e in rec.spans if n == "enqueue"]
    assert len(enq) == len(roots)
    for r, (s, e) in zip(sorted(roots, key=lambda r: r.start_ns), enq):
        assert w0 <= s <= r.start_ns <= r.end_ns <= e <= w1


def test_idle_gaps_go_to_the_innermost_main_thread_span():
    main = threading.main_thread().ident
    other = main + 1
    # device busy 0-10, 30-40, 70-100 µs of a 0-100 µs window: gaps 10-30
    # (midpoint 20) and 40-70 (midpoint 55)
    tr = T.Trace([("k", 0.0, 10.0), ("k", 30.0, 40.0), ("k", 70.0, 100.0)],
                 [], (0.0, 100.0))
    ns = lambda us: int(us * 1000)
    recs = [
        (1, None, "render", ns(5), ns(95), main),
        (2, 1, "render.lip", ns(12), ns(25), main),
        (3, 1, "render.unet", ns(45), ns(90), main),
        (4, None, "build", ns(15), ns(60), other),   # not the main thread
        (5, None, "step", ns(150), ns(160), main),   # after the window
    ]
    w = P.Window(recs, tr)
    assert dict(w.idle_us) == {"render.lip": 20.0, "render.unet": 30.0}
    assert w.self_us["render"] == pytest.approx(90.0 - 13.0 - 45.0)
    assert "step" not in w.self_us and "build" not in w.self_us
    ctx = {"trace": tr, "batches": 2}
    spans.clear()
    P._reduced.clear()
    P._reduced[tuple(tr.window)] = w
    assert P.idle_ms(ctx, "render.lip", "batches") == pytest.approx(0.01)
    assert P.idle_ms(ctx, "render.composite", "batches") == 0.0
    assert P.self_ms(ctx, "render.unet", "batches") == pytest.approx(0.0225)
    P._reduced.clear()
