"""The ranks' mesh and its collectives (counterpart of
``speech2lip_tpu/parallel/mesh.py``).

The JAX package lays a ``(data, pixel)`` mesh over its devices and lets
the SPMD partitioner insert the collectives.  The port runs one process a
device, so its mesh is this process's place in the ``torch.distributed``
group: the ``(data, pixel)`` shape, the rank, its device and the process
groups of its two axes, and the collectives are explicit.  Ranks lie on
the mesh as the JAX mesh lays out its devices (``reshape(mesh_shape)``):
rank r sits at data index ``r // pixel`` and pixel index ``r % pixel``.

- Frames split over ``data``: each data index holds its rows of the
  global batch, parameters are replicated, and what the JAX step computes
  over the whole batch (BatchNorm statistics, masked-loss sums, metrics)
  is summed over the data axis here.
- A frame's rows split over ``pixel`` in the post-fusion U-Net: each
  pixel rank runs the U-Net on its band of rows (``Band``), with one-row
  halos from its neighbours (``halo_rows``), and the bands are gathered
  into whole frames (``gather_bands``).  Everything else is replicated
  over ``pixel``.

Every collective names the axis it reduces over (``DATA``, ``PIXEL`` or
``ALL``), and over an axis of one rank it returns its input unchanged, so
a one-process run computes what it computed before the mesh existed.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from speech2lip_tpu_torch.parallel import distributed

DATA, PIXEL, ALL = "data", "pixel", "all"


@dataclass(frozen=True)
class Mesh:
    """This process's place on a ``(data, pixel)`` mesh of ranks.
    ``groups`` holds the process groups of the axes that are neither one
    rank nor the whole world (``make_mesh`` builds them); a mesh built by
    hand has none and takes no collective over such an axis."""
    data: int
    pixel: int
    rank: int
    device: torch.device
    groups: Optional[Dict[str, Any]] = field(default=None, compare=False,
                                             repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        """{'data': D, 'pixel': P}, as the JAX mesh's ``shape``."""
        return {"data": self.data, "pixel": self.pixel}

    @property
    def world(self) -> int:
        return self.data * self.pixel

    @property
    def data_index(self) -> int:
        return self.rank // self.pixel

    @property
    def pixel_index(self) -> int:
        return self.rank % self.pixel


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              device="cpu") -> Mesh:
    """The mesh of this process group, ``(world, 1)`` by default.

    As the JAX ``make_mesh`` checks its shape against the devices, this
    checks it against the ranks: ``data * pixel`` must be the world size
    (``ValueError`` otherwise).  Every rank calls it, in one order: with
    both axes above one it makes each data index's pixel group and each
    pixel index's data group (``dist.new_group``, all of them on every
    rank)."""
    world = distributed.process_count()
    data, pixel = ((world, 1) if not mesh_shape
                   else (int(mesh_shape[0]),
                         int(mesh_shape[1]) if len(mesh_shape) > 1 else 1))
    if data < 1 or pixel < 1 or data * pixel != world:
        raise ValueError(f"mesh_shape {[data, pixel]} needs {data * pixel} "
                         f"ranks, the process group has {world}")
    rank = distributed.process_index()
    groups = None
    if data > 1 and pixel > 1:
        groups = {}
        for d in range(data):
            g = dist.new_group([d * pixel + p for p in range(pixel)])
            if d == rank // pixel:
                groups[PIXEL] = g
        for p in range(pixel):
            g = dist.new_group([d * pixel + p for d in range(data)])
            if p == rank % pixel:
                groups[DATA] = g
    return Mesh(data, pixel, rank, torch.device(device), groups)


def axis_size(mesh: Optional[Mesh], axis: str = DATA) -> int:
    """The number of ranks along ``axis`` (DATA, PIXEL or ALL); 1 without
    a mesh."""
    if mesh is None:
        return 1
    return {DATA: mesh.data, PIXEL: mesh.pixel, ALL: mesh.world}[axis]


def data_size(mesh: Optional[Mesh]) -> int:
    return axis_size(mesh, DATA)


def _group(mesh: Mesh, axis: str):
    """The process group of ``axis`` on this rank (None: the world)."""
    if axis_size(mesh, axis) == mesh.world:
        return None
    if mesh.groups is None:
        raise ValueError(f"a mesh built by hand has no {axis!r} group: "
                         f"build it with make_mesh")
    return mesh.groups[axis]


# -- the mesh a step runs under ----------------------------------------------

_ACTIVE: List[Mesh] = []


@contextlib.contextmanager
def on_mesh(mesh: Optional[Mesh]) -> Iterator[None]:
    """Inside the block, the reductions over the batch that the JAX step
    takes over the global batch (``ops.nn.batchnorm_train``, the masked
    ``train.losses.photometric_loss``) reduce over the mesh's data axis,
    and the step's U-Net runs on a band of rows per pixel rank
    (``train.train_step``).  A mesh of one rank, or None, changes
    nothing."""
    if axis_size(mesh, ALL) <= 1:
        yield
        return
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active() -> Optional[Mesh]:
    """The mesh of the enclosing ``on_mesh`` block, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


# -- collectives -------------------------------------------------------------

class _AllSum(torch.autograd.Function):
    """All-reduce (sum) over a group whose backward all-reduces the
    cotangents over it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, mesh: Optional[Mesh], axis: str = DATA
            ) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, differentiable: its
    backward sums the ranks' cotangents, so a loss that each rank computes
    from the sum, with gradients averaged over the ranks afterwards
    (``mean_tensors``), gets the gradient of the mean of those losses."""
    if axis_size(mesh, axis) <= 1:
        return x
    return _AllSum.apply(x, _group(mesh, axis))


def sum_no_grad(x: torch.Tensor, mesh: Optional[Mesh], axis: str = DATA
                ) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, outside autograd."""
    if axis_size(mesh, axis) <= 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=_group(mesh, axis))
    return y


def mean_tensors(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh],
                 axis: str = DATA) -> List[torch.Tensor]:
    """Each tensor averaged over the ranks of ``axis``, through one
    all-reduce of one flat buffer (per dtype); outside autograd."""
    tensors = list(tensors)
    w = axis_size(mesh, axis)
    if w <= 1 or not tensors:
        return tensors
    group = _group(mesh, axis)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat / w
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def mean_dict(values: Dict[str, torch.Tensor], mesh: Optional[Mesh],
              axis: str = DATA) -> Dict[str, torch.Tensor]:
    """``mean_tensors`` of a dict of tensors, in sorted key order (the same
    on every rank)."""
    if axis_size(mesh, axis) <= 1:
        return values
    keys = sorted(values)
    return dict(zip(keys, mean_tensors([values[k] for k in keys], mesh,
                                       axis)))


def _gather(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x.contiguous(), group=_group(mesh, axis))
    return parts


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh],
                    axis: str = DATA) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` (one shape on all ranks)
    concatenated along axis 0 in index order; outside autograd."""
    if axis_size(mesh, axis) <= 1:
        return x
    return torch.cat(_gather(x.detach(), mesh, axis))


def barrier() -> None:
    """Wait for every rank of the process group (none: return)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# -- a frame's rows over the pixel axis --------------------------------------

def band_rows(height: int, pixel: int) -> Tuple[int, ...]:
    """The heights of the ``pixel`` bands of a frame of ``height`` rows:
    multiples of 4, so that the U-Net's two 2x2 pools cut on band edges;
    the height/4 quarter-rows split as evenly as they go, the larger bands
    first (500 rows over 4: 128, 124, 124, 124)."""
    if height % 4:
        raise ValueError(f"a frame of {height} rows does not split into "
                         f"bands of whole 2x2x2 pool cells: the height "
                         f"must be a multiple of 4")
    q = height // 4
    if q < pixel:
        raise ValueError(f"{height} rows give {q} quarter-rows, fewer than "
                         f"the {pixel} ranks of the pixel axis")
    base, extra = divmod(q, pixel)
    return tuple(4 * (base + (p < extra)) for p in range(pixel))


@dataclass(frozen=True)
class Band:
    """This rank's band of a frame's rows at one U-Net level: ``rows``
    holds every pixel rank's band height, in pixel-index order."""
    mesh: Mesh
    rows: Tuple[int, ...]

    @property
    def height(self) -> int:
        """The frame's height at this level."""
        return sum(self.rows)

    @property
    def start(self) -> int:
        return sum(self.rows[:self.mesh.pixel_index])

    @property
    def stop(self) -> int:
        return self.start + self.rows[self.mesh.pixel_index]

    def half(self) -> "Band":
        """The band after a 2x2 pool."""
        return Band(self.mesh, tuple(r // 2 for r in self.rows))


def frame_band(mesh: Mesh, height: int) -> Band:
    """This rank's band of a frame of ``height`` rows (``band_rows``)."""
    return Band(mesh, band_rows(height, mesh.pixel))


class _Halo(torch.autograd.Function):
    """[B, h, W, C] band -> [B, h + 2, W, C]: the row above the band (the
    previous pixel rank's last) and the row below it (the next one's
    first), zero rows at the frame's top and bottom.  One all-gather of
    each rank's two edge rows within the pixel group; the backward sends
    each halo row's cotangent back the same way and adds it to the
    owner's edge row."""

    @staticmethod
    def forward(ctx, x, band):
        ctx.band = band
        above, below = _swap_edges(x[:, 0], x[:, -1], band)
        return torch.cat([above[:, None], x, below[:, None]], dim=1)

    @staticmethod
    def backward(ctx, g):
        # the cotangent of the row above this band belongs to the previous
        # rank's last row, the one below to the next rank's first row
        band = ctx.band
        to_first, to_last = _swap_edges(g[:, 0], g[:, -1], band)
        gx = g[:, 1:-1].clone()
        gx[:, 0] += to_first
        gx[:, -1] += to_last
        return gx, None


def _swap_edges(top, bottom, band):
    """(the previous pixel rank's ``bottom``, the next one's ``top``),
    zeros where there is no such rank."""
    parts = _gather(torch.stack([top, bottom]), band.mesh, PIXEL)
    p = band.mesh.pixel_index
    above = parts[p - 1][1] if p > 0 else torch.zeros_like(top)
    below = parts[p + 1][0] if p + 1 < len(parts) else torch.zeros_like(
        bottom)
    return above, below


def halo_rows(x: torch.Tensor, band: Band) -> torch.Tensor:
    """``x`` (this rank's band, [B, h, W, C]) with one row from each
    neighbouring band above and below it: [B, h + 2, W, C], zero rows
    beyond the frame; differentiable (``_Halo``)."""
    return _Halo.apply(x, band)


class _GatherBands(torch.autograd.Function):
    """Every pixel rank's band, [B, h_p, ...], into the whole frame
    [B, H, ...] on every pixel rank.  The backward is a reduce-scatter:
    the sum of the pixel ranks' cotangents of the frame, then this rank's
    rows."""

    @staticmethod
    def forward(ctx, x, band):
        ctx.band = band
        most = max(band.rows)
        pad = x.new_zeros((x.shape[0], most - x.shape[1], *x.shape[2:]))
        parts = _gather(torch.cat([x, pad], dim=1), band.mesh, PIXEL)
        return torch.cat([part[:, :h] for part, h in zip(parts, band.rows)],
                         dim=1)

    @staticmethod
    def backward(ctx, g):
        band = ctx.band
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM,
                        group=_group(band.mesh, PIXEL))
        return g[:, band.start:band.stop], None


def gather_bands(x: torch.Tensor, band: Band) -> torch.Tensor:
    """The whole frames of which ``x`` is this rank's band, on every pixel
    rank; differentiable (``_GatherBands``)."""
    return _GatherBands.apply(x, band)


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
    """Rank 0's values of every tensor of ``tree`` on every rank of the
    mesh (in place); the tree is returned.  Ranks that built the tree from
    one seed hold it already: this makes sure."""
    if axis_size(mesh, ALL) > 1:
        for t in _leaves(tree):
            dist.broadcast(t.data, src=0)
    return tree


def local_rows(n_global: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a global batch of ``n_global``: its data
    index's contiguous block, as the JAX batch sharding lays the frame
    axis over ``data`` (the pixel ranks of a data index hold the same
    rows)."""
    w = data_size(mesh)
    if n_global % w:
        raise ValueError(f"a global batch of {n_global} does not split "
                         f"over {w} ranks")
    per = n_global // w
    r = 0 if mesh is None else mesh.data_index
    return slice(r * per, (r + 1) * per)


def shard_batch(batch: Dict[str, Any], mesh: Optional[Mesh]
                ) -> Dict[str, Any]:
    """This rank's rows of a global batch (every entry's axis 0)."""
    if data_size(mesh) <= 1:
        return batch
    n = next(iter(batch.values())).shape[0]
    sl = local_rows(n, mesh)
    return {k: v[sl] for k, v in batch.items()}
