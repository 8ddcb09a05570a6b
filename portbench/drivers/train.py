"""The training driver: one identity's fit, iteration by iteration, as
``train.trainer.fit`` runs it, in the stage its configuration states.

Set-up reads the identity (``data.dataset.LipDataset``), builds the step's
statics (``train.trainer.build_statics``) at the configuration's
``start_iter`` (0 where absent), so the program's own rule decides whether
the sync loss is on and the U-Net frozen, Adam (``train.train_step.
make_optimizer``, its moments at zero) and the step (``make_train_step``)
on weights made from the seed (the configuration's ``weights`` draw,
``init`` where absent) with the frozen nets (LPIPS; SyncNet, on a stream of
its own, when the sync loss is on), and drives that step through its first
``check_steps`` iterations, which the configuration's ``reference`` module
follows.  The window then goes on with the same state.  An iteration is the
batch build (``train.trainer.batch_iterator``, the loader ``fit`` picks for
the configuration), the copy to the card (``to_device``), the step's draws
and the step, synchronised.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench.core.device import Phases
from portbench.core.registry import reference_module
from portbench.counts import flops
from portbench.reference import batch as refbatch
from portbench.reference import train as reftrain
from portbench.traffic import draws as D
from portbench.traffic import identity as ID
from portbench.traffic import weights as W

SYNC_KEYS = ("mel", "audio_window", "coord_window", "rgb_window_neg")


def small(config, traffic):
    """(configuration, traffic) cut to sizes a CPU test runs: a 64-px face
    with a 24 x 16 lip crop, in the configuration and in the identity the
    traffic writes, and 12 frames."""
    face, lip = 64, {"x": 20, "y": 30, "h": 16, "w": 24}
    config = copy.deepcopy(config)
    config.update(geometry={"face": face, "lip": lip}, identity_frames=12)
    config["config"]["data"].update(height=lip["h"], width=lip["w"])
    traffic = copy.deepcopy(traffic)
    traffic["identity"].update(face=face, lip=dict(lip))
    return config, traffic


def control_precision(cell) -> str:
    """The control's precision: one step below the type the step trains
    in (``fp8`` below bfloat16, ``tf32`` below float32)."""
    dt = cell.config["config"]["training"].get("compute_dtype")
    return "fp8" if dt == "bfloat16" else "tf32"


class Session:
    def __init__(self, cell, seed: int, device, span):
        self.cell, self.seed, self.dev, self.span = cell, seed, device, span
        self.tr = cell.traffic
        self.build_dir = cell.build_dir
        self.t_build: List[float] = []
        self.t_step: List[float] = []

    def setup(self) -> None:
        from speech2lip_tpu_torch.data.dataset import LipDataset
        from speech2lip_tpu_torch.train import train_step as ts
        from speech2lip_tpu_torch.train import trainer
        self.trainer, self.ts = trainer, ts
        dev = self.dev
        ph = Phases(dev)
        # the identity's length is the configuration's (its data scale)
        self.root = ID.ensure(dict(
            self.tr["identity"],
            n_frames=int(self.cell.config["identity_frames"])),
            self.build_dir)
        ph("identity on disk")
        cfg = copy.deepcopy(self.cell.config["config"])
        cfg["data"]["path"] = str(self.root)
        cfg["model"]["canonical_depth_init_path"] = str(
            self.root / "depth_face_canonical.npy")
        cfg["training"]["batch_size"] = int(self.tr["batch"])
        self.cfg = cfg
        self.ds = LipDataset(str(self.root), "train", cfg)
        start = int(self.cell.config.get("start_iter", 0))
        st = trainer.build_statics(cfg, self.ds, start, dev)
        self.st = st
        ph("dataset and statics")
        wg = D.generator(self.seed, "weights", dev)
        draw = self.cell.config.get("weights", W.INIT)
        tf_l = W.talking_face_leaves(draw)
        up_l, us_l = W.unet_leaves(draw)
        params = W.make_tree(tf_l, wg, dev)
        # the canonical depth starts from the identity's depth (no holes)
        params["canonical_depth"] = torch.from_numpy(np.load(
            self.root / "depth_face_canonical.npy")).to(dev)
        up, us = W.make_tree(up_l, wg, dev), W.make_tree(us_l, wg, dev)
        self.frozen = {"lpips": W.make_tree(W.lpips_leaves(), wg, dev)}
        if st.sync_on:
            sg = D.generator(self.seed, "syncnet", dev)
            self.frozen["syncnet"] = tuple(W.make_tree(l, sg, dev)
                                           for l in W.syncnet_leaves())
        self.init = tuple(W.tree_map(torch.clone, t) for t in (params, up, us))
        opt = ts.make_optimizer(cfg)
        self.b1 = opt.b1
        leaves = ts.tree_leaves({"model": params, "unet": up})
        self.state = ts.TrainState(params, up, us, opt.init(leaves), start)
        self.step = ts.make_train_step(opt, st, self.frozen)
        self.ref = reference_module(self.cell.config["reference"],
                                    self.cell.root)
        self.dgen = D.generator(self.seed, "draws", dev)
        self.order = D.rng(self.seed, "order")
        self.epoch = 0
        self.it = self._epoch()
        ph("weights and step")
        # the checked steps: the window's own call and feed
        self.checked: List[Dict[str, Any]] = []
        for k in range(int(self.tr["check_steps"])):
            host, dr, m = self._iteration(keep=True)
            if st.sync_on and "loss_sync" not in m:
                raise RuntimeError(
                    "the configuration's stage has the sync loss on, but "
                    "the step reported no loss_sync: it ran another stage")
            self.checked.append({"host": host, "draws": dr,
                                 "loss": float(m["loss"]),
                                 "grad_norm": float(m["grad_norm"]),
                                 "terms": sorted(m)})
            if k == 0:
                self.after_first = self.state
        self.after_last = self.state
        ph("checked steps")

    def _epoch(self):
        self.epoch += 1
        return self.trainer.batch_iterator(
            self.ds, int(self.tr["batch"]), shuffle=True,
            seed=int(self.order.integers(1 << 31)))

    def _next_batch(self):
        try:
            return next(self.it)
        except StopIteration:
            self.it = self._epoch()
            return next(self.it)

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _iteration(self, keep: bool = False):
        a = time.perf_counter()
        with self.span("batch_build"):
            host = self._next_batch()
            if not self.st.sync_on:
                host = {k: v for k, v in host.items() if k not in SYNC_KEYS}
            batch = self.trainer.to_device(host, self.dev)
        b = time.perf_counter()
        with self.span("step"):
            rows = int(batch["audio"].shape[0])
            dr = D.step_draws(self.dgen, rows, self.st.face_h,
                              self.st.face_w, self.dev, self.st.use_blackaug,
                              rows * self.st.sync_T if self.st.sync_on else 0)
            self.state, m = self.step(self.state, batch, dr)
            self._sync()
        c = time.perf_counter()
        self.t_build.append(b - a)
        self.t_step.append(c - b)
        if keep:
            return ({k: np.array(v, copy=True) for k, v in host.items()},
                    {k: (W.tree_map(torch.clone, v) if isinstance(v, dict)
                         else v.clone()) for k, v in dr.items()}, m)
        return None

    def window_run(self, seconds: float) -> None:
        self.t_build, self.t_step = [], []
        n = 0
        t0 = time.perf_counter()
        with self.span("window"):
            while True:
                self._iteration()
                n += 1
                c = time.perf_counter()
                if c - t0 >= seconds:
                    break
        self.window_s = c - t0
        self.iters = n

    def end_to_end(self) -> Dict[str, float]:
        return {"iter_ms": 1e3 * self.window_s / self.iters}

    def context(self) -> Dict[str, Any]:
        b = int(self.tr["batch"])
        st = self.st
        count = flops.sync_iter_ops if st.sync_on else flops.train_iter_ops
        return {"window_s": self.window_s, "iters": self.iters,
                "spans": {"batch_build": self.t_build, "step": self.t_step},
                "model_ops": self.iters * count(
                    st.lip_h, st.lip_w, st.face_h, st.face_w, b),
                "peak": "f32", "kernels": {}}

    def release(self) -> None:
        self.step = None
        self.state = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _ref_batches(self):
        """The checked steps' batches as the reference reads them, and the
        largest gap to the loop's."""
        read = self.ref.read_batches(
            str(self.root), self.cfg,
            [c["host"]["index"] for c in self.checked])
        out, gaps = [], []
        for c, rb in zip(self.checked, read):
            gaps.append(refbatch.gap(c["host"], rb))
            out.append({k: torch.from_numpy(np.ascontiguousarray(v))
                        .to(self.dev) for k, v in rb.items()})
        return out, max(gaps)

    def _follow(self, batches, precision: str):
        return self.ref.steps(self.cfg, self.init, self.frozen, batches,
                              [c["draws"] for c in self.checked], precision)

    def _gaps(self, got, ref) -> Dict[str, float]:
        """got/ref: {loss [k], grad_norm [k], grad {path: first gradient},
        params {path: after the last checked step}}."""
        init = dict(zip(W.tree_paths({"model": self.init[0],
                                      "unet": self.init[1]}),
                        W.tree_leaves({"model": self.init[0],
                                       "unet": self.init[1]})))
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
        grads = reftrain.leaf_gaps(got["grad"], ref["grad"])
        changes = reftrain.leaf_gaps(
            {k: v - init[k] for k, v in got["params"].items()},
            {k: v - init[k] for k, v in ref["params"].items()},
            reftrain.moved(ref["grad"]))
        losses = [rel(a, b) for a, b in zip(got["loss"], ref["loss"])]
        top = lambda g: sorted(g.items(), key=lambda kv: -kv[1])[:4]
        self.diag = {"loss_by_step": losses,
                     "grad_norm_by_step": [rel(a, b) for a, b in zip(
                         got["grad_norm"], ref["grad_norm"])],
                     "grad_worst": top(grads), "change_worst": top(changes),
                     "change_median": float(np.median(list(
                         changes.values()))) if changes else math.inf}
        self.diag.update(
            loss_gap=max(losses), grad_norm_gap=max(
                self.diag["grad_norm_by_step"]),
            change_gap=max(changes.values()) if changes else math.inf)
        # the compared numbers: the first step's loss (the later steps'
        # losses carry the round-off of Adam's first sign-like updates),
        # the worst leaf of the first gradient, the worst and the median
        # leaf's change over the checked steps
        return {"loss1_gap": losses[0],
                "grad_gap": max(grads.values()) if grads else math.inf,
                "change_gap": self.diag["change_gap"],
                "change_median_gap": self.diag["change_median"]}

    def _program(self) -> Dict[str, Any]:
        """The program's readings: each checked step's loss and gradient
        norm, its first gradient as Adam holds it after one step (mu / (1 -
        b1)), and its parameters after the last checked step."""
        paths = W.tree_paths({"model": self.init[0], "unet": self.init[1]})
        s = self.after_last
        return {"loss": [c["loss"] for c in self.checked],
                "grad_norm": [c["grad_norm"] for c in self.checked],
                "grad": {p: m / (1.0 - self.b1) for p, m in
                         zip(paths, self.after_first.opt_state["mu"])},
                "params": dict(zip(paths, W.tree_leaves(
                    {"model": s.params, "unet": s.unet_params})))}

    def check(self) -> Dict[str, float]:
        batches, batch_gap = self._ref_batches()
        out = self._gaps(self._program(), self._follow(batches, "f32"))
        out["batch_gap"] = batch_gap
        return out

    def control(self, precision: str) -> Dict[str, float]:
        batches, _ = self._ref_batches()
        out = self._gaps(self._follow(batches, precision),
                         self._follow(batches, "f32"))
        out["batch_gap"] = 0.0
        return out

    def attempted(self) -> int:
        return self.iters
