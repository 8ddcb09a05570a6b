"""The serving driver: one client in a closed loop, one batch at a time,
through the port's entry points.

``path: renderer`` (video dubbing): ``infer.renderer.Renderer.__call__`` on
batches of consecutive frames of an identity resident on the card, cycling.
``path: static_scene`` (a live avatar): ``infer.static_scene.
StaticSceneRenderer.__call__`` on audio windows at consecutive frame
indices, the pose fixed.  A batch finishes at the synchronise that makes
its output ready; its latency runs from the call to that point.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench.core.device import Phases
from portbench.counts import flops
from portbench.reference import common, compare
from portbench.reference import serve as ref
from portbench.traffic import draws as D
from portbench.traffic import frames as FR
from portbench.traffic import weights as W

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# a CPU test's face and lip crop (x, y, h, w) by path; the static scene's
# crop stays under 90% of its face, so it takes the crop path
SMALL = {"renderer": (64, (20, 30, 16, 24)),
         "static_scene": (320, (128, 150, 48, 64))}


def small(config, traffic):
    """(configuration, traffic) cut to sizes a CPU test runs: the path's
    face and lip crop, batches of 4 from 24 frames, one warm-up batch, and
    2 checked batches drawn from the first 3."""
    face, (x, y, h, w) = SMALL[traffic["path"]]
    config = copy.deepcopy(config)
    config["geometry"] = {"face": face,
                          "lip": {"x": x, "y": y, "h": h, "w": w}}
    config["config"]["data"].update(height=h, width=w)
    traffic = dict(copy.deepcopy(traffic), batch=4, frames=24,
                   warmup_batches=1, check={"batches": 2, "within": 3})
    return config, traffic


def control_precision(cell) -> str:
    """The control's precision: one step below the type the model is
    served in (``fp8`` below bfloat16, ``tf32`` below float32)."""
    dt = cell.config["config"]["model"].get("compute_dtype")
    return "fp8" if dt == "bfloat16" else "tf32"


class Session:
    def __init__(self, cell, seed: int, device, span):
        self.cell, self.seed, self.dev, self.span = cell, seed, device, span
        self.cfg = cell.config["config"]
        self.geo = cell.config["geometry"]
        self.tr = cell.traffic
        self.path = self.tr["path"]
        self.batch = int(self.tr["batch"])
        self.lip = self.geo["lip"]
        self.face = int(self.geo["face"])

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from speech2lip_tpu_torch.infer.renderer import Renderer
        from speech2lip_tpu_torch.infer.static_scene import StaticSceneRenderer
        dev, b = self.dev, self.batch
        ph = Phases(dev)
        served = DTYPES[self.cfg["model"].get("compute_dtype", "float32")]
        wg = D.generator(self.seed, "weights", dev)
        up_l, us_l = W.unet_leaves(W.SERVED)
        self.weights = tuple(W.make_tree(l, wg, dev, served) for l in (
            W.talking_face_leaves(W.SERVED), up_l, us_l))
        ph("weights")
        fg = D.generator(self.seed, "frames", dev)
        n = int(self.tr["frames"])
        box = FR.expanded_lip_box(
            self.lip, int(self.cfg["data"].get("expand_mask_divisor", 5)))
        if self.path == "renderer":
            self.store = FR.make_identity(fg, n, b - 1, self.geo,
                                          self.tr["motion"], dev)
            self.window = FR.warp_window(self.store["coord"][:n], box)
            self.program = Renderer(self.cfg, *self.weights, device=dev,
                                    window=self.window)
        elif self.path == "static_scene":
            can = FR.canonical_face(self.face, fg, dev)
            coord = FR.identity_grid(self.face, dev)
            self.scene = {"rgb_face_zero": can,
                          "rgb_face_ori": FR.warp(can, coord[None])[0],
                          "mask_lip_canonical": FR.lip_mask(self.face,
                                                            self.lip, dev),
                          "coord": coord}
            self.window = FR.warp_window(coord[None], box)
            idx = torch.arange(n + b - 1, device=dev) % n
            self.store = {"audio": torch.randn(n, 16, 29, generator=fg,
                                               device=dev)[idx],
                          "index": idx.float()}
            # the card's path (its default there; on the CPU the kernel
            # wrappers' plain versions with the same semantics)
            self.program = StaticSceneRenderer(
                self.cfg, *self.weights, base=self.scene, window=self.window,
                lip_x=self.lip["x"], lip_y=self.lip["y"], device=dev,
                use_kernels=True)
        else:
            raise ValueError(f"unknown serving path {self.path!r}")
        ph("inputs and program")
        self.n = n
        for k in range(int(self.tr["warmup_batches"])):
            self._call(k)
        self._sync()
        ph("warm-up")
        crng = D.rng(self.seed, "check")
        chk = self.tr["check"]
        self.sample = set(int(v) for v in crng.choice(
            int(chk["within"]), size=int(chk["batches"]), replace=False))

    def _inputs(self, k: int) -> Dict[str, torch.Tensor]:
        s = (k * self.batch) % self.n
        return {key: v[s:s + self.batch] for key, v in self.store.items()}

    def _call(self, k: int):
        x = self._inputs(k)
        if self.path == "renderer":
            return self.program(x, self.lip["x"], self.lip["y"])
        return {"face": self.program(x["audio"], x["index"])}

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # -- the window -------------------------------------------------------------

    def window_run(self, seconds: float) -> None:
        lat: List[float] = []
        enq: List[float] = []
        kept: Dict[int, Any] = {}
        last = None
        k = 0
        t0 = time.perf_counter()
        with self.span("window"):
            while True:
                a = time.perf_counter()
                with self.span("enqueue"):
                    out = self._call(k)
                b = time.perf_counter()
                with self.span("sync"):
                    self._sync()
                c = time.perf_counter()
                lat.append(c - a)
                enq.append(b - a)
                if k in self.sample:
                    kept[k] = out
                last = (k, out)
                k += 1
                if c - t0 >= seconds:
                    break
        self.window_s = c - t0
        self.batches = k
        self.lat, self.enq = lat, enq
        kept[last[0]] = last[1]
        self.kept = kept

    def end_to_end(self) -> Dict[str, float]:
        return {"frames_per_s": self.batches * self.batch / self.window_s,
                "batch_p95_ms": 1e3 * float(np.percentile(self.lat, 95))}

    def unet_shape(self):
        """(h, w) of the U-Net pass each frame makes on this path, by the
        benchmark's own rule: the full frame, or the static scene's crop
        of the warp window (``reference.common.crop_rule``)."""
        if self.path == "renderer":
            return self.face, self.face
        g = common.crop_rule(self.window, self.face, self.face)
        return (g["ch"], g["cw"]) if g else (self.face, self.face)

    def context(self) -> Dict[str, Any]:
        uh, uw = self.unet_shape()
        lh, lw = self.lip["h"], self.lip["w"]
        calls = self.batches
        return {
            "window_s": self.window_s, "frames": self.batches * self.batch,
            "batches": self.batches,
            "spans": {"enqueue": self.enq, "latency": self.lat},
            "model_ops": flops.serve_frame_ops(lh, lw, uh, uw,
                                               self.batches * self.batch),
            "peak": "bf16",
            "kernels": {
                "fused_block": {"bound_s": calls * flops.fused_block_bound_s(
                    uh, uw, self.batch)},
                "fused_mlp": {"bound_s": calls * flops.fused_mlp_bound_s(
                    lh * lw, self.batch)}},
        }

    # -- correctness ----------------------------------------------------------------

    def release(self) -> None:
        """Free the program's state; the inputs and the kept outputs stay."""
        self.program = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, k: int, precision: str, static=None):
        x = self._inputs(k)
        if self.path == "renderer":
            return ref.dub(self.cfg, self.weights, x, self.lip["x"],
                           self.lip["y"], precision)
        return {"face": ref.avatar(self.cfg, self.weights, self.scene,
                                   x["audio"], x["index"], self.window,
                                   self.lip["x"], self.lip["y"], static,
                                   precision)}

    def _gaps(self, triples) -> Dict[str, float]:
        """(got, float32 reference, reference in the configuration's
        rounding) of each kept batch -> the worst batch's gap of each
        output, in units of the configuration's own rounding gap."""
        gaps: Dict[str, List[float]] = {}
        wy0, wx0, wh, ww = self.window
        win = (slice(None), slice(wy0, wy0 + wh), slice(wx0, wx0 + ww))
        for out, r, base in triples:
            for key in ("lip", "face"):
                if key not in r:
                    continue
                gaps.setdefault(f"{key}_rms", []).append(
                    compare.rms_ratio(out.get(key), r[key], base[key]))
                gaps.setdefault(f"{key}_max", []).append(
                    compare.max_ratio(out.get(key), r[key], base[key]))
            gaps.setdefault("window_rms", []).append(compare.rms_ratio(
                out["face"][win], r["face"][win], base["face"][win]))
        return {k: compare.worst(v) for k, v in gaps.items()}

    def _static(self, precision: str):
        if self.path != "static_scene":
            return None
        return ref.static_face(self.weights, self.scene["rgb_face_ori"],
                               precision)

    def _triples(self, got_precision: str = None):
        """(got, reference, reference in the configuration's rounding) of
        each kept batch; ``got_precision``: the reference in that
        precision in the program's place."""
        stated = ref.stated_precision(self.cfg)
        precs = ["f32", stated] + ([got_precision] if got_precision else [])
        statics = {p: self._static(p) for p in precs}
        for k, out in sorted(self.kept.items()):
            rs = {p: self._reference(k, p, statics[p]) for p in precs}
            yield (rs[got_precision] if got_precision else out, rs["f32"],
                   rs[stated])

    def check(self) -> Dict[str, float]:
        """The gaps between the kept batches and the reference."""
        return self._gaps(self._triples())

    def control(self, precision: str) -> Dict[str, float]:
        """The same gaps with the reference computed in ``precision`` put
        in the program's place."""
        return self._gaps(self._triples(precision))

    def attempted(self) -> int:
        return self.batches
