"""Partition specs, the ambient mesh, and moves between placements.

Counterpart of the JAX package's sharding vocabulary: ``PartitionSpec``
(:class:`PartitionSpec`, alias ``P``: a tuple of axis names, ``None`` or
tuples of names, entry for entry JAX's), ``compat.set_mesh`` /
``compat.get_abstract_mesh`` (:func:`set_mesh`, :func:`get_abstract_mesh`)
and ``NamedSharding`` (:class:`NamedSharding`: a mesh and a spec, with the
local block's shape and this rank's slice of a full tensor).

GSPMD turns the reference's specs into collectives when it partitions a
jitted program.  The port has no partitioner: on a
:class:`~repro_torch.core.mesh.ProcessMesh` every rank holds its block of
each tensor and the model code calls the collectives itself
(:mod:`repro_torch.core.collectives`).  :func:`reshard` is the general
move between two specs of one tensor:

  * replicated -> sharded on a dim: this rank's slice (no transfer);
  * sharded -> replicated: an all-gather along the dim;
  * sharded on one dim -> another dim over the same axis: an all-to-all;
  * partial (a sum over ranks not yet taken) -> summed: a psum.

The ambient state is per context (``contextvars``): the mesh set by
:func:`set_mesh`, and the global batch of the call in flight
(:func:`batch_scope`), which tells a rank whether its activations hold a
block of the batch or all of it (the reference's ``shard`` drops a batch
entry whose extent does not divide the batch).

Gradients.  Under autograd every move here is differentiable, with the
transpose that GSPMD's partitioner gives the reference's program; the
forward, and what it counts, is the same with or without autograd.  What a
rank's gradient of a tensor means is one convention, per axis:

* over "model", the consumers of a replicated tensor are replicated: every
  rank holds the whole gradient of what it holds.  So a psum's transpose is
  the identity, an all-gather's is this rank's slice, a slice's is an
  all-gather.  A tensor replicated over "model" that enters a product split
  over "model" (a column-parallel weight, a rank's heads, a rank's run of a
  block stream) goes through :func:`model_in`: the identity, whose
  transpose sums the ranks' partial gradients over "model" (JAX's
  ``pvary``, Megatron's "copy to the model-parallel region").
* over the batch axes ("pod", "data"), where the global batch of the call
  in flight is split over them (:func:`batch_split`), the consumers hold
  distinct rows, so a rank's gradient of a replicated tensor is its rows'
  part of it: an all-gather's transpose is a ``psum_scatter`` (FSDP
  weights, the stationary head's activations), a ``psum_scatter``'s an
  all-gather, an all-to-all's the reverse all-to-all, a slice's zeros
  beside the slice's gradient, and a psum's the identity (the loss: every
  rank seeds its own gradient of the one global loss).  The gradients of
  params replicated over the batch axes stay partial here and are summed
  once, after the backward (``launch/steps.py``).  Where the batch is not
  split, every rank computes every row and the batch axes take the
  "model" convention.

A max over ranks (the optimizer's int8 scales) is an all-gather of each
rank's maxima, one vector, then a local max: it counts as an all-gather.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

__all__ = ["PartitionSpec", "P", "NamedSharding", "set_mesh",
           "get_abstract_mesh", "mesh_sizes", "axis_size", "axis_index",
           "entry_axes", "collectives", "reshard", "gather_dim", "slice_dim",
           "model_in", "psum", "world_max", "in_this_scope", "batch_scope",
           "global_batch", "batch_split", "batch_shard", "batch_unshard"]


def _entry(e):
    """An entry as JAX's PartitionSpec keeps it: a one-name tuple is the
    name, an empty one None, a list a tuple."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class PartitionSpec(tuple):
    """A tuple of per-dimension entries: an axis name, a tuple of axis
    names, or ``None`` (replicated on that dimension).  Equal, entry for
    entry, to the JAX package's ``PartitionSpec`` of the same arguments."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                        default=None)
_BATCH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_batch",
                                                         default=None)


@contextlib.contextmanager
def set_mesh(mesh):
    """Ambient-mesh context (``compat.set_mesh``): inside it the model code
    runs its sharded program on ``mesh`` (None: one device)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def get_abstract_mesh():
    """The mesh installed by :func:`set_mesh`, or None."""
    return _MESH.get()


def mesh_sizes(mesh) -> dict:
    """{axis name: extent} of a mesh."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def axis_size(axes, mesh=None) -> int:
    """The product of the extents of ``axes`` (a name or a tuple) on
    ``mesh`` (default: the ambient one); 1 for axes it lacks or no mesh."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    if mesh is None:
        return 1
    sizes = mesh_sizes(mesh)
    n = 1
    for a in entry_axes(axes):
        n *= sizes.get(a, 1)
    return n


def axis_index(axes, mesh=None) -> int:
    """This rank's position along ``axes``: mixed radix over the names in
    order (the first the most significant), as JAX orders a multi-axis
    entry; 0 without a mesh."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    if mesh is None:
        return 0
    sizes = mesh_sizes(mesh)
    idx = 0
    for a in entry_axes(axes):
        if a in sizes:
            idx = idx * sizes[a] + mesh.coords[mesh.axis_names.index(a)]
    return idx


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry (() for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (``jax.sharding.NamedSharding``): each dimension
    of a tensor is split into equal blocks over its entry's axes."""

    mesh: object
    spec: PartitionSpec

    def extent(self, i: int) -> int:
        return axis_size(self.spec[i], self.mesh) if i < len(self.spec) else 1

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        """The local block's shape of a tensor of ``shape``."""
        return tuple(int(n) // self.extent(i) for i, n in enumerate(shape))

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full tensor ``t`` (a view)."""
        for i, entry in enumerate(self.spec[: t.ndim]):
            if entry is not None:
                t = slice_dim(t, entry, i, self.mesh)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block ``t`` (collective)."""
        for i, entry in enumerate(self.spec[: t.ndim]):
            if entry is not None:
                t = gather_dim(t, entry, i, self.mesh)
        return t


def collectives(mesh=None):
    """The :class:`~repro_torch.core.collectives.Collectives` of ``mesh``
    (default: the ambient one): the mesh's own, so its counts add up over
    every call of a program."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    return mesh.collectives


def _recording(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _grads_partial(axes, mesh=None) -> bool:
    """Whether a rank's gradient of a tensor replicated over ``axes`` is
    partial (its rows' part, summed over the axes later): the batch axes
    while the global batch of the call in flight is split over them.  Over
    "model", and over the batch axes otherwise, it is whole."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    axes = entry_axes(axes)
    batch = [a in _batch_axes(mesh) for a in axes]
    if not any(batch):
        return False
    if not all(batch):
        raise NotImplementedError(f"a differentiable move over {axes}: the "
                                  "batch axes and others at once")
    return global_batch() is not None and batch_split(mesh)


def _narrow(t: torch.Tensor, axes, dim: int, mesh) -> torch.Tensor:
    n = axis_size(axes, mesh)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {entry_axes(axes)} ({n} ranks)")
    b = t.shape[dim] // n
    return t.narrow(dim, axis_index(axes, mesh) * b, b)


def _gather(t: torch.Tensor, axes, dim: int, mesh) -> torch.Tensor:
    sizes = mesh_sizes(mesh)
    coll = collectives(mesh)
    for a in reversed(entry_axes(axes)):
        if sizes.get(a, 1) > 1:
            t = coll.all_gather(t.movedim(dim, 0), a).movedim(0, dim)
    return t


class _Slice(torch.autograd.Function):
    """This rank's block; the gradient all-gathered (whole) or padded with
    zeros (partial)."""

    @staticmethod
    def forward(ctx, t, axes, dim, mesh, partial):
        ctx.args, ctx.shape = (axes, dim, mesh, partial), t.shape
        return _narrow(t, axes, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        axes, dim, mesh, partial = ctx.args
        if partial:
            out = g.new_zeros(ctx.shape)
            _narrow(out, axes, dim, mesh).copy_(g)
        else:
            out = _gather(g, axes, dim, mesh)
        return out, None, None, None, None


class _Gather(torch.autograd.Function):
    """The ranks' blocks over one axis; the gradient sliced (whole) or
    psum-scattered (partial)."""

    @staticmethod
    def forward(ctx, t, axis, dim, mesh, partial):
        ctx.args = (axis, dim, mesh, partial)
        return _gather(t, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        axis, dim, mesh, partial = ctx.args
        if partial:
            g = collectives(mesh).psum_scatter(g.movedim(dim, 0).contiguous(),
                                               axis).movedim(0, dim)
        else:
            g = _narrow(g, axis, dim, mesh)
        return g, None, None, None, None


class _ModelIn(torch.autograd.Function):
    """The identity; the gradient summed over "model"."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.detach()  # an alias, not a view: caching it on x makes no cycle

    @staticmethod
    def backward(ctx, g):
        return collectives(ctx.mesh).psum(g, "model"), None


def slice_dim(t: torch.Tensor, axes, dim: int, mesh=None) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``axes`` (a view)."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    if axis_size(axes, mesh) == 1:
        return t
    if _recording(t):
        return _Slice.apply(t, axes, dim, mesh, _grads_partial(axes, mesh))
    return _narrow(t, axes, dim, mesh)


def gather_dim(t: torch.Tensor, axes, dim: int, mesh=None) -> torch.Tensor:
    """The ranks' blocks of ``t`` along ``dim`` over ``axes``
    concatenated in axis order (an all-gather per axis, the minor one
    first)."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    if not _recording(t):
        return _gather(t, axes, dim, mesh)
    sizes = mesh_sizes(mesh)
    for a in reversed(entry_axes(axes)):
        if sizes.get(a, 1) > 1:
            t = _Gather.apply(t, a, dim, mesh, _grads_partial(a, mesh))
    return t


def model_in(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x``, replicated over "model", as it enters products split over
    "model": the identity, whose gradient is the ranks' partial gradients
    summed over "model".  Idempotent: the products of one input share one
    sum (a second call on ``x`` returns the first call's result)."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    if not _recording(x) or axis_size("model", mesh) == 1:
        return x
    y = getattr(x, "_model_in", None)
    if y is None:
        y = _ModelIn.apply(x, mesh)
        x._model_in = y
    return y


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``x`` summed over each of ``axes`` of extent > 1 (a psum per axis;
    differentiable, as :meth:`Collectives.psum`)."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    sizes = mesh_sizes(mesh)
    for a in entry_axes(axes):
        if sizes.get(a, 1) > 1:
            x = collectives(mesh).psum(x, a)
    return x


def world_max(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The elementwise max of a 1-D ``x`` over every rank of the mesh: one
    all-gather of it over all the mesh's axes, then a local max."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    if mesh.devices.size == 1:
        return x
    every = collectives(mesh).all_gather(x.reshape(1, -1), tuple(mesh.axis_names))
    return every.amax(dim=0)


def _norm(spec, ndim: int) -> list:
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return [entry_axes(e) for e in spec[:ndim]]


def reshard(x: torch.Tensor, src, dst, *, partial=(), mesh=None) -> torch.Tensor:
    """This rank's block of a tensor under spec ``dst``, from its block
    ``x`` under ``src`` (plus a sum over the ``partial`` axes still to
    take).  An axis that leaves one dimension for another moves by an
    all-to-all; one that leaves a dimension is all-gathered; one that joins
    a dimension is sliced.  Axes of extent 1 move nothing."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    sizes = mesh_sizes(mesh)
    coll = collectives(mesh)
    for a in entry_axes(partial):
        if sizes.get(a, 1) > 1:
            x = coll.psum(x, a)
    s, d = _norm(src, x.ndim), _norm(dst, x.ndim)
    for a in mesh.axis_names:
        i = next((k for k, e in enumerate(s) if a in e), None)
        j = next((k for k, e in enumerate(d) if a in e), None)
        if i is None or j is None or i == j:
            continue
        if s[i] != (a,) or d[j] != (a,) or s[j] or d[i]:
            raise NotImplementedError(
                f"reshard {src} -> {dst}: an all-to-all moves one axis "
                "alone between two otherwise replicated dims")
        if sizes[a] > 1:
            x = coll.all_to_all(x, a, split_dim=j, concat_dim=i)
        s[i], s[j] = (), (a,)
    for k in range(x.ndim):
        gone = [a for a in s[k] if a not in d[k]]
        if gone:
            if list(s[k][len(s[k]) - len(gone):]) != gone:
                raise NotImplementedError(f"reshard {src} -> {dst}: dim {k}")
            x = gather_dim(x, tuple(gone), k, mesh)
            s[k] = s[k][: len(s[k]) - len(gone)]
        new = [a for a in d[k] if a not in s[k]]
        if new:
            if tuple(d[k][: len(s[k])]) != tuple(s[k]):
                raise NotImplementedError(f"reshard {src} -> {dst}: dim {k}")
            x = slice_dim(x, tuple(new), k, mesh)
            s[k] = d[k]
    return x


# ---------------------------------------------------------------------------
# the global batch of the call in flight
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def batch_scope(global_batch: int):
    """Declare the global batch of the model call in flight: the ranks'
    activations hold a block of it where the batch axes divide it
    (:func:`batch_split`), all of it otherwise."""
    token = _BATCH.set(int(global_batch))
    try:
        yield
    finally:
        _BATCH.reset(token)


def global_batch() -> Optional[int]:
    return _BATCH.get()


def in_this_scope(fn):
    """``fn`` bound to the ambient mesh and global batch of the call that
    makes it: a recompute in the backward (``torch.utils.checkpoint``) runs
    outside those contexts, on autograd's device thread for CUDA tensors."""
    mesh, batch = get_abstract_mesh(), global_batch()

    def bound(*args, **kwargs):
        with set_mesh(mesh):
            if batch is None:
                return fn(*args, **kwargs)
            with batch_scope(batch):
                return fn(*args, **kwargs)

    return bound


def _batch_axes(mesh) -> tuple:
    from ..models.common import batch_axes

    return batch_axes(mesh)


def batch_split(mesh=None) -> bool:
    """Whether the global batch of the call in flight is split over the
    mesh's batch axes (their extent divides it)."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    B = global_batch()
    n = axis_size(_batch_axes(mesh), mesh) if mesh is not None else 1
    if B is None:
        raise RuntimeError("a sharded model call needs its global batch: run "
                           "it inside sharding.batch_scope(B)")
    return n > 1 and B % n == 0


def batch_shard(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """This rank's rows of a global-batch tensor (all of them where the
    batch is not split)."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    if mesh is None or not batch_split(mesh):
        return x
    return slice_dim(x, _batch_axes(mesh), 0, mesh)


def batch_unshard(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The global batch from every rank's rows ``x`` (an all-gather over
    the batch axes where the batch is split)."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    if mesh is None or not batch_split(mesh):
        return x
    return gather_dim(x, _batch_axes(mesh), 0, mesh)

