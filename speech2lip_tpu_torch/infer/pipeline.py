"""New-audio inference and multi-identity serving (counterpart of
``speech2lip_tpu/infer/pipeline.py``).

- ``new_audio_frames``: raw wav -> DeepSpeech windows -> rendered,
  composited face frames through the ``Renderer``.
- ``MultiSpeakerServer``: N identities served from one process, grouped
  by lip paste offset.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from speech2lip_tpu_torch.core.device import resolve_device
from speech2lip_tpu_torch.infer.renderer import FrontEnd, render_face_batch
from speech2lip_tpu_torch.parallel.mesh import (DATA, all_gather_rows,
                                                data_size, local_rows)

# the batch entries the renderers read
RENDER_KEYS = ("audio", "index", "rgb_face_zero", "rgb_face_ori",
               "mask_lip_canonical", "coord")


def frame_batch(base: Dict[str, Any], windows: np.ndarray, start: int,
                stop: int, device) -> Dict[str, torch.Tensor]:
    """Frames ``start``..``stop`` of a new-audio clip on ``device``: the
    canonical frame's sample ``base`` with each frame's audio window and
    its index in the clip."""
    from speech2lip_tpu_torch.data.dataset import stack_batch
    from speech2lip_tpu_torch.train.trainer import to_device

    samples = []
    for i in range(start, stop):
        s = dict(base)
        s["audio"] = windows[i].astype(np.float32)
        s["index"] = np.int32(i)
        samples.append(s)
    host = stack_batch(samples)
    return to_device({k: host[k] for k in RENDER_KEYS if k in host}, device)


def new_audio_frames(cfg: Dict[str, Any], state, ds, ds_params,
                     wav: np.ndarray, sample_rate: int, batch: int = 8,
                     window: Optional[tuple] = None, device=None):
    """Render face frames for arbitrary speech audio.

    state: anything with ``params``, ``unet_params`` and ``unet_state``
    (a ``TrainState``); ds: a ``LipDataset`` opened in 'test' mode (its
    canonical-frame artifacts serve every frame); ds_params: the port's
    DeepSpeech tree.  Runs on the card unless ``device`` names another.
    Yields [B, H, W, 3] float32 numpy face frames."""
    from speech2lip_tpu_torch.infer.renderer import Renderer
    from speech2lip_tpu_torch.preprocess.audio_features import \
        wav_to_deepspeech_windows

    device = resolve_device(device)
    windows = wav_to_deepspeech_windows(wav, sample_rate, ds_params,
                                        device=device)
    renderer = Renderer(cfg, state.params, state.unet_params,
                        state.unet_state, device=device, window=window)
    base = ds.load_frame(0)
    n = windows.shape[0]
    for start in range(0, n, batch):
        b = frame_batch(base, windows, start, min(start + batch, n), device)
        yield renderer(b, ds.lefttop_x, ds.lefttop_y)["face"].cpu().numpy()


class MultiSpeakerServer(FrontEnd):
    """Multi-identity serving: S identities that share the lip and face
    geometry, grouped by lip paste offset.

    The JAX server stacks each group's parameters and serves a group with
    one vmapped XLA program, or each identity through its fused kernels.
    The port has no vmapped program to build: K1's weights belong to one
    identity, so no K1 launch spans identities.  It keeps one set of
    parameters per identity, cast to the compute dtype once, at
    construction (casting per call would cost hundreds of small copies),
    and serves each identity of each group in turn through the kernel
    path: K1, K2 and five K3 launches a batch on the card.

    ``mesh`` (``parallel.mesh.make_mesh``): the identities of each offset
    group split over the mesh's data axis, as the JAX server shards a
    group's stacked parameters over ``data``: the ranks of data index d
    serve the d-th contiguous block of the group on their own devices
    (replicated over ``pixel``), through the same path, and
    ``render_all`` gathers every identity's frames over the data axis to
    every rank.  A group of one identity is served by every rank, as the
    JAX server replicates it; other group sizes must be multiples of the
    data axis.

    Runs on the card unless ``device`` names another.  On a CUDA device it
    runs the kernels, and ``use_kernels=False`` raises: the card serves no
    plain path.  On the CPU ``use_kernels`` defaults to False, the plain
    path; True runs the kernel wrappers' plain versions.  As in the JAX
    server the dtype follows the path, whatever the config says: bfloat16
    with the kernels, float32 without; ``compute_dtype`` overrides it.
    """

    def __init__(self, cfg: Dict[str, Any], param_sets: List[tuple],
                 lip_positions: List[tuple], window: Optional[tuple] = None,
                 use_kernels: Optional[bool] = None, mesh=None, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        """param_sets: [(params, unet_params, unet_state)] per identity;
        lip_positions: [(lip_x, lip_y)] per identity; window: the static
        warp window every identity's composite uses."""
        from speech2lip_tpu_torch.parallel.distributed import rank_device
        self.window = tuple(window) if window is not None else None
        self.n_identities = len(param_sets)
        self.groups: Dict[tuple, List[int]] = {}
        for i, (x, y) in enumerate(lip_positions):
            self.groups.setdefault((int(x), int(y)), []).append(i)
        self._offset = {i: off for off, ids in self.groups.items()
                        for i in ids}
        self.mesh = mesh
        w = data_size(mesh)
        # per group, the identities this rank serves
        self._mine: Dict[tuple, List[int]] = {}
        for off, ids in self.groups.items():
            if len(ids) > 1 and len(ids) % w:
                raise ValueError(
                    f"offset group {off} holds {len(ids)} identities, which "
                    f"do not split over {w} ranks: group sizes must be "
                    f"multiples of the data axis, or 1")
            self._mine[off] = (ids if len(ids) == 1
                               else ids[local_rows(len(ids), mesh)])
        self.served = [i for ids in self._mine.values() for i in ids]
        self._param_sets = self.bind(
            cfg, {i: param_sets[i] for i in self.served},
            rank_device(resolve_device(device)), use_kernels, compute_dtype,
            kernel_dtype=torch.bfloat16, plain_dtype=torch.float32)

    def param_shardings(self) -> Dict[tuple, torch.device]:
        """{offset group -> the device its identities' parameters are on}:
        under a mesh, this rank's device, which holds the group's
        identities ``served`` names."""
        return {off: self.device for off in self.groups}

    def _render(self, identity: int, batch: Dict[str, Any],
                use_kernels: bool):
        lip_x, lip_y = self._offset[identity]
        with torch.no_grad():
            return render_face_batch(
                *self._param_sets[identity], batch, lip_x=lip_x, lip_y=lip_y,
                lip_h=self.lip_h, lip_w=self.lip_w, use_kernels=use_kernels,
                compute_dtype=self.compute_dtype, window=self.window)

    def render(self, identity: int, batch: Dict[str, Any]):
        """Render a frame batch (tensors on the server's device) for one
        identity: {'lip', 'face'} float32."""
        return self._render(identity, batch, self.use_kernels)

    def render_plain(self, identity: int, batch: Dict[str, Any]):
        """``render`` with no kernel, on the same cast parameters, dtype and
        window: the reference the kernel path is held to.  It serves
        nothing."""
        return self._render(identity, batch, False)

    def render_all(self, batches: List[Dict[str, Any]]):
        """Serve every identity, group by group, each identity of a group
        in turn.  batches: per-identity frame batches of one size.
        Returns the outputs indexed by identity.  Under a mesh each rank
        renders its identities and the outputs are gathered to every
        rank."""
        if len(batches) != self.n_identities:
            raise ValueError(f"need {self.n_identities} batches, "
                             f"got {len(batches)}")
        out: List[Any] = [None] * self.n_identities
        for off, ids in self.groups.items():
            mine = self._mine[off]
            rendered = [self.render(i, batches[i]) for i in mine]
            if len(mine) == len(ids):
                for i, o in zip(mine, rendered):
                    out[i] = o
                continue
            every = {key: all_gather_rows(
                torch.stack([o[key] for o in rendered]), self.mesh, DATA)
                for key in rendered[0]}
            for k, i in enumerate(ids):
                out[i] = {key: v[k] for key, v in every.items()}
        return out
