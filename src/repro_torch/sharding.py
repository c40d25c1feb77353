"""The sharding rules and the per-rank helpers of a model on a mesh,
shared by ``models`` and ``kernels``: the counterparts of the sharding
part of ``repro.models.common`` (``AxisSizes``, the specs and
``with_sharding_constraint``) and of ``shard_map``.

Every parameter and activation gets a *requested* spec, a tuple with one
entry per dimension (``None``, a mesh axis name, or a tuple of names),
the reference's ``PartitionSpec``; a dimension is only sharded on a mesh
axis when its size divides by that axis's size (``AxisSizes.spec``). On
a ``DeviceMesh`` a spec becomes DTensor placements
(``AxisSizes.placements``): for each mesh dimension, ``Shard(d)`` where
the spec names that axis at dimension ``d``, else ``Replicate()``; a
dimension sharded over a tuple of axes is ``Shard(d)`` on each of them,
in the spec's order, which is the mesh's order.

Where a layer runs as per-rank code (the reference's ``shard_map``, a
kernel, or where DTensor's own propagation fails or gathers what a rank
does not need), ``per_rank`` is the one wrapper around ``local_map``.
Nothing here imports a process group or touches one at import.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["AxisSizes", "entry", "shard", "settled", "is_dtensor", "contiguous_strides",
           "axes_of", "split_axis", "batch_split", "per_rank",
           "all_reduce_fwd", "all_reduce_bwd", "all_reduce_both",
           "placed_empty", "placed_zeros", "assign_", "write_rows_"]


Spec = Tuple[object, ...]


def entry(want):
    """A spec entry as JAX's ``PartitionSpec`` holds it: a tuple of one
    axis name is that name."""
    if isinstance(want, (tuple, list)):
        return want[0] if len(want) == 1 else tuple(want)
    return want


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (imported only where one can exist)."""
    return type(x).__name__ == "DTensor" and hasattr(x, "placements")


@dataclasses.dataclass(frozen=True)
class AxisSizes:
    """Mesh axis sizes used for divisibility-aware spec construction, and
    the ``DeviceMesh`` the specs place tensors on (``None`` off a mesh)."""

    sizes: Tuple[Tuple[str, int], ...]  # e.g. (("pod",2),("data",16),("model",16))
    mesh: Optional[object] = None       # torch DeviceMesh

    @staticmethod
    def from_mesh(layout) -> "AxisSizes":
        """The axis sizes of a ``launch.mesh.Layout`` (its ``mesh``, where
        it has one, places the tensors)."""
        return AxisSizes(tuple(zip(layout.axes, layout.shape)),
                         getattr(layout, "mesh", None))

    @staticmethod
    def single() -> "AxisSizes":
        return AxisSizes((("data", 1), ("model", 1)))

    def size(self, name) -> int:
        if isinstance(name, (tuple, list)):
            out = 1
            for n in name:
                out *= self.size(n)
            return out
        for n, s in self.sizes:
            if n == name:
                return s
        return 1

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.sizes)

    def has(self, name: str) -> bool:
        return name in self.names

    @property
    def batch_axes(self):
        """Axes that shard the batch dimension (pod+data when multi-pod)."""
        return ("pod", "data") if self.has("pod") else ("data",)

    def spec(self, dims: Sequence[Optional[object]],
             shape: Sequence[int]) -> Spec:
        """A spec, dropping axes that don't divide."""
        assert len(dims) == len(shape), (dims, shape)
        out = []
        for want, size in zip(dims, shape):
            if want is None:
                out.append(None)
            elif size % self.size(want) == 0:
                out.append(entry(want))
            else:
                out.append(None)
        return tuple(out)

    def placements(self, spec: Spec) -> List:
        """DTensor placements of ``spec`` on this mesh, one per mesh
        dimension."""
        from torch.distributed.tensor import Replicate, Shard
        out: List = [Replicate() for _ in self.sizes]
        for dim, want in enumerate(spec):
            names = want if isinstance(want, (tuple, list)) else (want,)
            order = [self.names.index(n) for n in names if n is not None]
            if order != sorted(order):
                raise ValueError(f"spec {spec}: axes {names} of dimension "
                                 f"{dim} are not in the mesh's order "
                                 f"{self.names}")
            for i in order:
                out[i] = Shard(dim)
        return out


def _whole(t):
    """``t`` with every ``Partial`` placement combined to ``Replicate``
    (in ``t``'s dtype), unchanged where it has none."""
    from torch.distributed.tensor import Partial, Replicate
    if not any(isinstance(q, Partial) for q in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(q, Partial) else q for q in t.placements])


class _Settle(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _whole(x).view_as(x) if is_dtensor(x) else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole(g) if is_dtensor(g) else g


def settled(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its partial sums combined now, in its own dtype, and
    its gradient's likewise: GSPMD's all-reduce at a row-parallel
    product's output, and at a column-parallel product's input gradient,
    in the product's dtype. DTensor would otherwise defer the sum to the
    next op that needs the whole value, often past a norm's cast to
    float32. The identity on a plain tensor and on one with no partial
    placement (a one-device layout)."""
    return _Settle.apply(x) if is_dtensor(x) else x


def shard(x: torch.Tensor, ax: AxisSizes,
          dims: Sequence[Optional[object]]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` with the
    divisibility fallback: a DTensor is redistributed to the spec's
    placements. A no-op off a mesh, on a one-device mesh (as in the
    reference) and for a plain tensor."""
    if ax.mesh is None or ax.mesh.size() == 1 or not is_dtensor(x):
        return x
    return x.redistribute(ax.mesh, ax.placements(ax.spec(dims, x.shape)))


# ------------------------------------------------------- per-rank layers
#
# Where a layer runs as per-rank code (the reference's shard_map, or
# where DTensor's own propagation fails or gathers what a rank does not
# need), ``per_rank`` wraps it in ``local_map``: each argument is
# redistributed to the placements the layer's code needs (a weight
# sharded over "data" is all-gathered: the FSDP gather), the code runs on
# the local tensors, and the outputs come back as DTensors. A tensor
# replicated over a mesh axis on which the layer's work is split gets a
# partial gradient (``Partial``) on that axis.

def axes_of(t) -> AxisSizes:
    """The mesh axes of a DTensor, with its mesh."""
    mesh = t.device_mesh
    return AxisSizes(tuple(zip(mesh.mesh_dim_names, mesh.shape)), mesh)


def split_axis(ax: AxisSizes, n: int, name: str = "model"):
    """``name`` where the axis has more than one rank and divides ``n``,
    else ``None`` (the dimension stays whole)."""
    size = ax.size(name)
    return name if ax.has(name) and size > 1 and n % size == 0 else None


def batch_split(ax: AxisSizes, b: int):
    """The batch axes where they divide ``b`` (and hold more than one
    rank), else ``None``."""
    size = ax.size(ax.batch_axes)
    return ax.batch_axes if size > 1 and b % size == 0 else None


def per_rank(fn, ax: AxisSizes, args: Sequence, dims: Sequence,
             out_dims: Sequence, partial: Sequence = (),
             grad_partial: Optional[Sequence] = None):
    """``fn(*local args)`` on each rank of ``ax.mesh`` through
    ``local_map``. ``dims[i]`` is arg ``i``'s spec (one entry per
    dimension: ``None``, an axis name or a tuple of names), ``None`` for
    a plain argument; ``out_dims`` likewise per output (a single output
    when ``fn`` returns a tensor).

    ``partial[j]`` names the axes (one name or a tuple; ``None`` for
    none) over which output ``j`` is each rank's partial sum, which
    DTensor combines when it is next read whole: a row-parallel product
    over ``"model"``, a loss over the batch ranks.

    The gradient of an argument keeps its shards; over an axis it is
    replicated on, it is partial where ``grad_partial[i]`` names the axis
    and whole elsewhere. ``grad_partial`` (or its entry ``i``) ``None``
    takes every axis that some argument is split on: a replicated input
    used by each rank for its own part of the work."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    split = set()
    for d in dims:
        for want in d or ():
            split.update(_names(want))
    in_pl = [None if d is None else ax.placements(d) for d in dims]

    def grad_of(i, pl):
        if pl is None:
            return None
        axes = split if grad_partial is None or grad_partial[i] is None \
            else set(_names(grad_partial[i]))
        return [q if isinstance(q, Shard) else
                Partial() if n in axes else Replicate()
                for n, q in zip(ax.names, pl)]

    outs = []
    for j, d in enumerate(out_dims):
        axes = _names(partial[j]) if j < len(partial) else ()
        outs.append([Partial() if n in axes else q
                     for n, q in zip(ax.names, ax.placements(d))])
    wrapped = local_map(
        fn, out_placements=outs[0] if len(outs) == 1 else tuple(outs),
        in_placements=tuple(in_pl),
        in_grad_placements=tuple(grad_of(i, pl)
                                 for i, pl in enumerate(in_pl)),
        device_mesh=ax.mesh, redistribute_inputs=True)
    return wrapped(*args)


def _names(want) -> Tuple[str, ...]:
    """The axis names of a spec entry (``None``, a name or a tuple)."""
    if not want:
        return ()
    return tuple(want) if isinstance(want, (tuple, list)) else (want,)


def _all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op, group))


class _ReduceFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        return _all_reduce(x, group, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_reduce_fwd(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum (or ``op``) over ``group`` whose result every rank then uses
    alike (the reference's ``psum`` before replicated work): the
    gradient passes through unchanged."""
    return _ReduceFwd.apply(x, group, op)


def all_reduce_bwd(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; the gradient is summed over ``group`` (a replicated
    input each rank uses for its own part of the work)."""
    return _ReduceBwd.apply(x, group)


def all_reduce_both(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` whose result each rank uses for its own part of
    the work: the gradient is summed over ``group`` too."""
    return _ReduceBoth.apply(x, group)


def placed_empty(shape, dtype, device, mesh, placements) -> torch.Tensor:
    """An uninitialised DTensor of global ``shape`` with ``placements``
    on ``mesh``, whose storage is this rank's shard only."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape = torch.Size(shape)
    local_shape, _ = compute_local_shape_and_global_offset(shape, mesh,
                                                           placements)
    local = torch.empty(local_shape, dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=contiguous_strides(shape))


def contiguous_strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (no tensor made:
    a dry run's counter follows every storage, meta ones included)."""
    out, n = [], 1
    for size in reversed(tuple(shape)):
        out.append(n)
        n *= max(int(size), 1)
    return tuple(reversed(out))


def placed_zeros(shape, dtype, device, mesh, placements) -> torch.Tensor:
    out = placed_empty(shape, dtype, device, mesh, placements)
    out.to_local().zero_()
    return out


def _unsharded_along(t, dim: int):
    """``t``'s placements with any sharding of ``dim`` replaced by
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if isinstance(q, Shard) and q.dim == dim else q
            for q in t.placements]


def assign_(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)`` (a cache update in place). A DTensor ``dst``
    takes ``src`` redistributed to its own placements first: an in-place
    DTensor op cannot move its destination."""
    if is_dtensor(dst):
        src = src.redistribute(dst.device_mesh, dst.placements)
    return dst.copy_(src)


def write_rows_(cache: torch.Tensor, new: torch.Tensor, start,
                dim: int = 2) -> None:
    """Writes ``new`` over ``cache``'s rows ``[start, start + n)`` along
    ``dim`` in place; ``start`` is an int, or a 0-d tensor for one row
    (``n`` = 1; the row is ``start``, clamped by the caller).

    On a DTensor cache whose ``dim`` may be sharded (the sequence of a
    batch-1 cache, ``cache_pspecs``), ``new`` is gathered along ``dim``
    to the cache's other placements, and each rank writes the part of
    the rows that falls in its own shard (the meta device included: a
    row index held in a tensor is selected, never read on the host)."""
    if not is_dtensor(cache):
        if isinstance(start, torch.Tensor):
            cache.index_copy_(dim, start.reshape(1), new.to(cache.dtype))
        else:
            cache.narrow(dim, start, new.shape[dim]).copy_(new)
        return
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    new = new.redistribute(cache.device_mesh, _unsharded_along(cache, dim))
    local, rows = cache.to_local(), new.to_local().to(cache.dtype)
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    off, n = offset[dim], shape[dim]
    if isinstance(start, torch.Tensor):
        at = (start.reshape(1) - off).clamp(0, max(n - 1, 0))
        mine = (start >= off) & (start < off + n)
        local.index_copy_(dim, at, torch.where(
            mine, rows, local.index_select(dim, at)))
        return
    lo, hi = max(start, off), min(start + new.shape[dim], off + n)
    if hi > lo:
        local.narrow(dim, lo - off, hi - lo).copy_(
            rows.narrow(dim, lo - start, hi - lo))
