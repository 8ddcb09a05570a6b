"""The serving batch's CUDA graphs (``speech2lip_tpu_torch.infer.graphs``)
on the CPU: the rule that decides when a call captures or replays, the
key, and that on the CPU neither renderer captures, its outputs those of
the eager path bit for bit.  Every op of a renderer's batch runs inside
one of its three stages, so a capture would hold the whole batch.  The
replays themselves run on the card (``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from speech2lip_tpu_torch.data import synthetic as tsyn
from speech2lip_tpu_torch.data.dataset import LipDataset, stack_batch
from speech2lip_tpu_torch.infer import graphs
from speech2lip_tpu_torch.infer.renderer import Renderer, render_face_batch
from speech2lip_tpu_torch.infer.static_scene import StaticSceneRenderer
from speech2lip_tpu_torch.train import trainer

E, C, R = graphs.EAGER, graphs.CAPTURE, graphs.REPLAY


def _actions(keys):
    """The actions of a call sequence, with the state ``StageGraphs``
    keeps: the held key (set by a capture) and the previous call's."""
    held = last = None
    out = []
    for k in keys:
        a = graphs.plan(held, last, k)
        if a == C:
            held = k
        last = k
        out.append(a)
    return out


@pytest.mark.parametrize("keys,want", [
    ("AAAA", [E, C, R, R]),
    # a ragged last batch runs eagerly and keeps the held graphs
    ("AAAB", [E, C, R, E]),
    ("AAABAA", [E, C, R, E, R, R]),
    # a new key replaces them once it comes twice in a row
    ("AABBA", [E, C, E, C, E]),
    ("AABBAA", [E, C, E, C, E, C]),
    # alternating keys never capture
    ("ABABAB", [E] * 6),
    ("A", [E]),
])
def test_the_key_rule(keys, want):
    assert _actions(keys) == want


def test_the_key_is_shapes_dtypes_and_static_values():
    x = {"a": torch.zeros(4, 3), "i": torch.zeros(4, dtype=torch.int64)}
    k = graphs.input_key(x, 1, 2)
    same = {"a": torch.ones(4, 3), "i": torch.arange(4)}
    assert graphs.input_key(same, 1, 2) == k
    assert graphs.input_key({"a": torch.zeros(3, 3), "i": x["i"]}, 1, 2) != k
    assert graphs.input_key({"a": x["a"].double(), "i": x["i"]}, 1, 2) != k
    assert graphs.input_key(x, 1, 3) != k
    assert graphs.input_key({"i": x["i"], "a": x["a"]}, 1, 2) != k
    arr = graphs.input_key({"a": np.zeros((4, 3), np.float32)})
    assert arr == (("a", (4, 3), "float32"),)


def test_stage_graphs_off_the_card_run_the_body_eagerly():
    g = graphs.StageGraphs("cpu")
    assert not g.on
    x = {"a": torch.arange(3.0)}
    before = (graphs.replays, graphs.captures)
    for _ in range(3):
        out = g(graphs.input_key(x), x, {"a": torch.bfloat16},
                lambda stage, b: {"y": b["a"]})
        assert out["y"] is x["a"]
    assert g.held is None and (graphs.replays, graphs.captures) == before


@pytest.fixture(scope="module")
def identity(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("graphs") / "tree")
    geo = tsyn.make_synthetic_tree(root, n_frames=6, face=64, lip_h=16,
                                   lip_w=24)
    cfg = tsyn.synthetic_config(root, geo)
    ds = LipDataset(root, "train", cfg)
    params, up, us, _ = trainer.init_models(cfg, ds, 0, "cpu")
    window = trainer.warp_window(cfg, ds)
    host = stack_batch([ds.load_frame(i) for i in range(3)])
    batch = trainer.to_device(host, "cpu")
    return cfg, ds, geo, (params, up, us), window, batch


def _same(a, b):
    assert a.dtype == b.dtype and torch.equal(a, b)


def test_cpu_renderer_never_captures(identity):
    cfg, _, geo, ps, window, batch = identity
    r = Renderer(cfg, *ps, device="cpu", window=window)
    before = (graphs.replays, graphs.captures)
    p, up, us = r.params
    want = render_face_batch(
        p, up, us, batch, lip_x=geo["lip_x"], lip_y=geo["lip_y"],
        lip_h=r.lip_h, lip_w=r.lip_w, expand_divisor=r.expand_divisor,
        use_kernels=True, compute_dtype=r.compute_dtype, window=r.window)
    short = {k: v[:2] for k, v in batch.items()}
    for b in (batch, batch, batch, short, batch):
        out = r(b, geo["lip_x"], geo["lip_y"])
        n = b["audio"].shape[0]
        for k in ("lip", "face"):
            _same(out[k], want[k][:n])
    assert r.graphs.held is None
    assert (graphs.replays, graphs.captures) == before


def test_cpu_static_scene_never_captures(identity):
    cfg, ds, geo, ps, window, batch = identity
    r = StaticSceneRenderer(cfg, *ps, ds.load_frame(0), window,
                            geo["lip_x"], geo["lip_y"], device="cpu")
    before = (graphs.replays, graphs.captures)
    want = r(batch["audio"], batch["index"])
    for n in (3, 3, 2, 3):
        _same(r(batch["audio"][:n], batch["index"][:n]), want[:n])
    assert r.graphs.held is None
    assert (graphs.replays, graphs.captures) == before


class _OpsOutsideStages(TorchDispatchMode):
    """Records each op that runs while no stage is open."""

    def __init__(self):
        super().__init__()
        self.depth, self.outside, self.stages = 0, [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.depth == 0:
            self.outside.append(str(func))
        return func(*args, **(kwargs or {}))

    def stage(self, name):
        mode = self

        class _Stage:
            def __enter__(self):
                mode.stages.append(name)
                mode.depth += 1

            def __exit__(self, *exc):
                mode.depth -= 1
                return False
        return _Stage()


@pytest.mark.parametrize("path", ["renderer", "static_scene"])
def test_every_op_of_a_batch_runs_inside_a_stage(identity, path):
    """What a capture would run outside its three graphs: nothing, given
    the inputs in their static buffers' dtypes."""
    cfg, ds, geo, ps, window, batch = identity
    if path == "renderer":
        r = Renderer(cfg, *ps, device="cpu", window=window)
        x = {k: batch[k].to(d) if d else batch[k]
             for k, d in r.staged.items()}

        def body(stage):
            p, up, us = r.params
            return render_face_batch(
                p, up, us, x, lip_x=geo["lip_x"], lip_y=geo["lip_y"],
                lip_h=r.lip_h, lip_w=r.lip_w,
                expand_divisor=r.expand_divisor, use_kernels=True,
                compute_dtype=r.compute_dtype, window=r.window, stage=stage)
    else:
        r = StaticSceneRenderer(cfg, *ps, ds.load_frame(0), window,
                                geo["lip_x"], geo["lip_y"], device="cpu")
        x = {"audio": batch["audio"].float(),
             "t_indices": batch["index"].float()}

        def body(stage):
            return r._batch(stage, x)
    rec = _OpsOutsideStages()
    with torch.no_grad(), rec:
        out = body(rec.stage)
    assert rec.stages == ["render.lip", "render.composite", "render.unet"]
    assert rec.outside == []
    assert out["face"].shape[0] == 3
