"""Elastic rescaling and the shardings of spec trees.

Counterpart of ``repro/runtime/elastic.py``.  Checkpoints store full
(unsharded) leaves, so a restore may target another mesh shape; picking
that shape is :func:`rescale_mesh_shape`.  :func:`make_shardings` and
:func:`sanitize_shardings` turn a PartitionSpec tree into the
:class:`~repro_torch.core.sharding.NamedSharding` tree of a mesh, as the
reference's do; :func:`shard_tree` takes this rank's block of every full
leaf (``convert.lm_params`` output, a checkpoint's leaves, a seeded init)
and :func:`unshard_tree` gathers the full leaves back from the ranks'
blocks.

Restoring a training run onto a smaller mesh: :func:`rescaled_mesh` lays
the ranks that are left out as ``rescale_mesh_shape`` says (model
parallelism kept, the data axis shrunk), and ``TrainLoop(cfg, opt_cfg,
mesh=rescaled_mesh(world, model_parallel=m), global_batch=B, ...)``
rebuilds its shardings from the same spec trees (``make_shardings`` +
``sanitize_shardings``), takes its blocks of the checkpoint's full leaves
(``restore_checkpoint(..., shardings=)``, :func:`shard_tree`) and keeps
the global batch ``B``: each rank's rows grow, the step's numbers do not
change.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.sharding import NamedSharding, P, entry_axes
from ..tree import tree_map

__all__ = ["rescale_mesh_shape", "rescaled_mesh", "make_shardings",
           "sanitize_shardings", "shard_tree", "unshard_tree", "empty_blocks",
           "seeded_blocks", "spec_axes", "RescalePlan"]


@dataclass(frozen=True)
class RescalePlan:
    old_shape: tuple
    new_shape: tuple
    axis_names: tuple
    reason: str = ""


def rescale_mesh_shape(n_devices: int, axis_names=("data", "model"),
                       model_parallel: int | None = None) -> tuple:
    """Largest usable mesh for n_devices: keep model parallelism fixed (it is
    dictated by per-chip memory), shrink the data axis; drop remainder
    devices (they become hot spares)."""
    if model_parallel is None:
        model_parallel = 1
    data = max(1, n_devices // model_parallel)
    if len(axis_names) == 3:  # (pod, data, model): collapse pods on rescale
        return (1, data, model_parallel)
    return (data, model_parallel)


def rescaled_mesh(world, axis_names=("data", "model"),
                  model_parallel: int | None = None):
    """The process mesh of ``world``'s ranks at
    :func:`rescale_mesh_shape` (collective: every rank calls it)."""
    from ..core.mesh import make_process_mesh

    shape = rescale_mesh_shape(world.size, axis_names, model_parallel)
    return make_process_mesh(world, shape, axis_names)


def spec_axes(spec) -> set:
    """The mesh axis names a PartitionSpec splits over."""
    return {a for e in tuple(spec) for a in entry_axes(e)}


def _is_spec(x) -> bool:
    return isinstance(x, P)


def make_shardings(mesh, spec_tree):
    """PartitionSpec tree -> NamedSharding tree on ``mesh``, dropping the
    axis names the mesh does not have (e.g. "pod" on a single-pod mesh)."""

    def conv(s):
        cleaned = []
        for entry in tuple(s):
            if isinstance(entry, (tuple, list)):
                kept = tuple(a for a in entry if a in mesh.axis_names)
                cleaned.append(kept if kept else None)
            else:
                cleaned.append(entry if entry in mesh.axis_names else None)
        return NamedSharding(mesh, P(*cleaned))

    return tree_map(conv, spec_tree, is_leaf=_is_spec)


def sanitize_shardings(sh_tree, aval_tree):
    """Drop spec entries whose mesh extent does not divide the dimension
    (replicated on that dim instead), as the reference's: e.g. xlstm's
    4-head gate projections on a 16-way model axis, or a batch of 1 over
    data.  ``aval_tree`` holds anything with a ``.shape`` (tensors, fake
    tensors), leaf for leaf."""

    def fix(sh, aval):
        if sh is None or not hasattr(sh, "spec"):
            return sh
        sizes = dict(zip(sh.mesh.axis_names, sh.mesh.devices.shape))
        shape = tuple(aval.shape)
        out = []
        for i, entry in enumerate(tuple(sh.spec)):
            if entry is None or i >= len(shape):
                out.append(None if i >= len(shape) else entry)
                continue
            extent = 1
            for a in entry_axes(entry):
                extent *= sizes.get(a, 1)
            out.append(entry if extent and shape[i] % extent == 0 else None)
        return NamedSharding(sh.mesh, P(*out[: len(shape)]))

    return tree_map(fix, sh_tree, aval_tree,
                    is_leaf=lambda x: isinstance(x, NamedSharding) or x is None)


def shard_tree(tree, sh_tree, device=None, out=None):
    """This rank's block of every full leaf of ``tree`` (a contiguous copy,
    on ``device`` if given, or written into the tensors of ``out``): the
    leaves the sharded program holds."""
    if out is not None:
        tree_map(lambda dst, t, sh: dst.copy_(sh.local(t)), out, tree, sh_tree,
                 is_leaf=lambda x: isinstance(x, NamedSharding))
        return out

    def one(t, sh):
        block = sh.local(t)
        if device is not None:
            block = block.to(device)
        return block.clone(memory_format=torch.contiguous_format)

    return tree_map(one, tree, sh_tree,
                    is_leaf=lambda x: isinstance(x, NamedSharding))


def empty_blocks(like, sh_tree, device):
    """Uninitialized tensors of this rank's block shapes of ``like``'s
    leaves (anything with ``.shape`` and ``.dtype``) on ``device``."""
    return tree_map(lambda t, sh: torch.empty(sh.shard_shape(t.shape), dtype=t.dtype,
                                              device=device),
                    like, sh_tree, is_leaf=lambda x: isinstance(x, NamedSharding))


def seeded_blocks(cfg, like, sh_tree, mesh, seed: int = 0, dtype=torch.bfloat16):
    """This rank's blocks of ``lm.init_params`` seeded with ``seed`` (the
    reference's tree, no port-only keys) on the rank's device: the rank
    draws the full tree and keeps its blocks.  The blocks are allocated
    before the tree, so no block lands in a segment of the tree's and
    freeing the tree gives its memory back.  Ranks that share one device
    take turns (a barrier over the mesh after each), so one full tree at
    a time lies on it.  Collective: every rank of ``mesh`` calls it."""
    import gc

    import torch.distributed as dist

    from ..models import lm
    from ..sparse.layers import strip_derived

    device = mesh.device
    shared = mesh.devices.size > 1 and len({str(d) for d in mesh.devices.flat}) == 1
    local = None
    for turn in range(mesh.devices.size if shared else 1):
        if not shared or turn == mesh.rank:
            local = empty_blocks(like, sh_tree, device)
            gen = torch.Generator(device=device).manual_seed(seed)
            full = strip_derived(lm.init_params(gen, cfg, dtype))
            shard_tree(full, sh_tree, out=local)
            del full
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        if shared:
            dist.barrier(group=mesh.world_group)
    return local


def unshard_tree(tree, sh_tree):
    """The full leaves from every rank's blocks (collective: every rank of
    the mesh calls it with its own blocks)."""
    return tree_map(lambda t, sh: sh.gather(t), tree, sh_tree,
                    is_leaf=lambda x: isinstance(x, NamedSharding))
