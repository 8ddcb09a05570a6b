"""The ranks' mesh and its collectives (counterpart of
``speech2lip_tpu/parallel/mesh.py``).

The JAX package lays a ``(data, pixel)`` mesh over its devices and lets
the SPMD partitioner insert the collectives.  The port runs one process a
device, so its mesh is this process's place in the ``torch.distributed``
group: world size, rank, device and the ``(data, pixel)`` shape, and the
collectives are explicit.  Frames split over ``data``: each rank holds its
rows of the global batch, parameters are replicated, and what the JAX
step computes over the whole batch (BatchNorm statistics, masked-loss
sums, metrics) is summed over the ranks here.

At a data axis of 1 every collective returns its input unchanged, so a
one-process run computes what it computed before the mesh existed.  The
``pixel`` axis (rows of a frame over devices) is not ported: a mesh with
``pixel > 1`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from speech2lip_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class Mesh:
    """This process's place on a ``(data, pixel)`` mesh of ranks."""
    data: int
    pixel: int
    rank: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """{'data': D, 'pixel': P}, as the JAX mesh's ``shape``."""
        return {"data": self.data, "pixel": self.pixel}


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              device="cpu") -> Mesh:
    """The mesh of this process group, ``(world, 1)`` by default.

    As the JAX ``make_mesh`` checks its shape against the devices, this
    checks it against the ranks: the data axis must be the world size
    (``ValueError`` otherwise), and a pixel axis above 1 raises
    ``NotImplementedError``."""
    world = distributed.process_count()
    data, pixel = ((world, 1) if not mesh_shape
                   else (int(mesh_shape[0]),
                         int(mesh_shape[1]) if len(mesh_shape) > 1 else 1))
    if pixel > 1:
        raise NotImplementedError(
            f"mesh_shape {[data, pixel]}: the 'pixel' axis (a frame's rows "
            f"over devices) is not ported: it is the port's next slice, "
            f"ROADMAP A4 (the pixel axis)")
    if data != world:
        raise ValueError(f"mesh_shape {[data, pixel]} needs {data} ranks "
                         f"on its data axis, the process group has {world}")
    return Mesh(data, pixel, distributed.process_index(),
                torch.device(device))


def data_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.data


# -- the mesh a step runs under ----------------------------------------------

_ACTIVE: List[Mesh] = []


@contextlib.contextmanager
def data_axis(mesh: Optional[Mesh]) -> Iterator[None]:
    """Inside the block, the reductions over the batch that the JAX step
    takes over the global batch (``ops.nn.batchnorm_train``, the masked
    ``train.losses.photometric_loss``) reduce over the mesh's ranks.  A
    mesh of one rank, or None, changes nothing."""
    if data_size(mesh) <= 1:
        yield
        return
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active() -> Optional[Mesh]:
    """The mesh of the enclosing ``data_axis`` block, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


# -- collectives -------------------------------------------------------------

class _AllSum(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the cotangents."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


def all_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: its backward sums
    the ranks' cotangents, so a loss that each rank computes from the
    sum, with gradients averaged over the ranks afterwards
    (``mean_tensors``), gets the gradient of the mean of those losses."""
    if data_size(mesh) <= 1:
        return x
    return _AllSum.apply(x)


def sum_no_grad(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the ranks, outside autograd."""
    if data_size(mesh) <= 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM)
    return y


def mean_tensors(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]
                 ) -> List[torch.Tensor]:
    """Each tensor averaged over the ranks, through one all-reduce of one
    flat buffer (per dtype); outside autograd."""
    tensors = list(tensors)
    w = data_size(mesh)
    if w <= 1 or not tensors:
        return tensors
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat = flat / w
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def mean_dict(values: Dict[str, torch.Tensor], mesh: Optional[Mesh]
              ) -> Dict[str, torch.Tensor]:
    """``mean_tensors`` of a dict of tensors, in sorted key order (the same
    on every rank)."""
    if data_size(mesh) <= 1:
        return values
    keys = sorted(values)
    return dict(zip(keys, mean_tensors([values[k] for k in keys], mesh)))


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks) concatenated along
    axis 0 in rank order; outside autograd."""
    w = data_size(mesh)
    if w <= 1:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(w)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def barrier() -> None:
    """Wait for every rank of the process group (none: return)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# -- placement ---------------------------------------------------------------

def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def replicate(tree: Any, mesh: Optional[Mesh]) -> Any:
    """Rank 0's values of every tensor of ``tree`` on every rank (in
    place); the tree is returned.  Ranks that built the tree from one seed
    hold it already: this makes sure."""
    if data_size(mesh) > 1:
        for t in _leaves(tree):
            dist.broadcast(t.data, src=0)
    return tree


def local_rows(n_global: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a global batch of ``n_global``: the rank's
    contiguous block, as the JAX batch sharding lays the frame axis over
    ``data``."""
    w = data_size(mesh)
    if n_global % w:
        raise ValueError(f"a global batch of {n_global} does not split "
                         f"over {w} ranks")
    per = n_global // w
    r = 0 if mesh is None else mesh.rank
    return slice(r * per, (r + 1) * per)


def shard_batch(batch: Dict[str, Any], mesh: Optional[Mesh]
                ) -> Dict[str, Any]:
    """This rank's rows of a global batch (every entry's axis 0)."""
    if data_size(mesh) <= 1:
        return batch
    n = next(iter(batch.values())).shape[0]
    sl = local_rows(n, mesh)
    return {k: v[sl] for k, v in batch.items()}

