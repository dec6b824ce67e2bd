"""Step-atomic checkpointing with exact-resume semantics.

Counterpart of ``repro/runtime/checkpoint.py``, in its format, so that
each package reads the other's checkpoints:

    <dir>/step_000000042/        # complete checkpoints only (atomic rename)
        index.json               # step, n_leaves, dtypes, shapes, metadata
        leaf-000000.npy ...      # one file per leaf (np.save), full arrays
    <dir>/LATEST                 # text file: name of newest complete step dir

Leaves are numbered in ``jax.tree.flatten``'s order (``repro_torch.tree``):
dict keys sorted as strings, ``OptState`` fields as step, m, v, quantized
moments as ``{"q", "scale"}``.  Dtype names are numpy's (``"bfloat16"``,
``"float32"``, ``"int32"``); bfloat16 is stored as its uint16 bits.  The
reference reads only ``n_leaves`` and ``dtypes`` of the index, so its
``treedef`` entry here describes the port's tree instead.

Guarantees (tested in tests/test_torch_train_loop.py):
  * atomicity — writers fill ``step_X.tmp`` then ``os.rename`` (POSIX-atomic);
    a crash mid-write never corrupts LATEST.
  * bit-exact resume — restore(save(x)) round-trips every dtype incl. bf16.

A sparse LM's port-only keys (``sparse.layers.DERIVED``) are not part of
the format: callers strip them before saving and rebuild them after
restoring (``strip_derived`` / ``with_derived``).

On a process mesh (``shardings=``: the NamedSharding tree of the tree's
leaves) the tree holds this rank's blocks.  Saving is collective: every
rank takes part in gathering each full leaf (``NamedSharding.gather``, a
leaf at a time, so no rank holds the whole state twice), the ranks write
the gathered leaves in turn (leaf ``i`` by rank ``i mod n``, so the writes
overlap the next gathers), rank 0 publishes the step with the atomic
rename, and the others wait at a barrier until it is published.  Restoring reads the full leaves on every rank and
keeps its blocks, so a checkpoint written on one mesh (or one device, or by
the JAX package) restores onto any other.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from ..tree import flatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


def _leaf_to_np(x: torch.Tensor) -> np.ndarray:
    # contiguous before the copy to the host: ``np.save`` writes a strided
    # array (a leaf gathered along an inner dim) through a buffered
    # iterator, tens of times slower than a contiguous one
    x = x.detach().contiguous().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)  # the raw bits
    return x.numpy()


def _np_to_leaf(x: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    if x.dtype.name != dtype:
        raise ValueError(f"leaf stored as {x.dtype} but indexed as {dtype}")
    return torch.from_numpy(x)


def _is_sharding(x) -> bool:
    return hasattr(x, "spec") and hasattr(x, "mesh")


def save_checkpoint(ckpt_dir: str, step: int, tree, metadata: dict | None = None,
                    *, shardings=None):
    """Write a complete checkpoint of ``tree`` (tensors) for ``step``
    atomically; returns its directory.  With ``shardings`` the call is
    collective over their mesh (see the module docstring)."""
    leaves, _ = flatten(tree)
    rank, n = 0, 1
    if shardings is not None:
        mesh = flatten(shardings, is_leaf=_is_sharding)[0][0].mesh
        shs = flatten(shardings, is_leaf=_is_sharding)[0]
        rank, n = mesh.rank, mesh.devices.size
        full = (sh.gather(leaf) for leaf, sh in zip(leaves, shs))
    else:
        full = iter(leaves)
    name = f"step_{step:09d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    dtypes, shapes = [], []
    if rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    if n > 1:
        dist.barrier(group=mesh.world_group)  # the directory is there
    for i, leaf in enumerate(full):
        dtypes.append(_dtype_name(leaf))
        shapes.append(list(leaf.shape))
        if i % n == rank:
            np.save(os.path.join(tmp, f"leaf-{i:06d}.npy"), _leaf_to_np(leaf))
    if n > 1:
        dist.barrier(group=mesh.world_group)  # every leaf is written
    if rank == 0:
        _publish(ckpt_dir, name, tmp, final, {
            "step": step,
            "treedef": f"repro_torch: {len(leaves)} leaves in jax.tree.flatten order",
            "n_leaves": len(leaves),
            "dtypes": dtypes,
            "shapes": shapes,
            "metadata": metadata or {},
        })
    if n > 1:
        dist.barrier(group=mesh.world_group)  # the step is published
    return final


def _publish(ckpt_dir: str, name: str, tmp: str, final: str, index: dict) -> None:
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(name)
    os.rename(os.path.join(ckpt_dir, "LATEST.tmp"), os.path.join(ckpt_dir, "LATEST"))


def latest_step(ckpt_dir: str) -> int | None:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "index.json")):
        return None  # torn LATEST; treat as absent
    return int(name.split("_")[1])


def _block(raw: np.ndarray, sh) -> np.ndarray:
    """This rank's block of a stored full leaf, copied out of the mapping."""
    from ..core.sharding import axis_index

    index = []
    for i, n in enumerate(raw.shape):
        k = sh.extent(i)
        if k > 1:
            j, b = axis_index(sh.spec[i], sh.mesh), n // k
            index.append(slice(j * b, (j + 1) * b))
        else:
            index.append(slice(None))
    return np.array(raw[tuple(index)], order="C", copy=True)  # off the mapping


def restore_checkpoint(ckpt_dir: str, like, step: int | None = None,
                       device=None, *, shardings=None):
    """Restore into the structure of ``like`` (a params / opt tree template).

    Each leaf goes to ``device``, or where it is None to the device of the
    template's leaf.  With ``shardings`` (the NamedSharding tree of
    ``like``'s leaves, which are this rank's blocks) each leaf is this
    rank's block of the stored full leaf.  Returns (tree, step), or (None,
    None) when no checkpoint exists.

    Raises:
      ValueError: the checkpoint's leaf count, shapes or dtypes do not
        match the template's structure and files.
    """
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None, None
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    leaves_like, unflatten = flatten(like)
    if index["n_leaves"] != len(leaves_like):
        raise ValueError(f"checkpoint has {index['n_leaves']} leaves, "
                         f"template {len(leaves_like)}")
    shs = (flatten(shardings, is_leaf=_is_sharding)[0] if shardings is not None
           else [None] * len(leaves_like))
    out = []
    for i, (tmpl, sh) in enumerate(zip(leaves_like, shs)):
        # a rank's block reads only its pages of the mapped file
        raw = np.load(os.path.join(d, f"leaf-{i:06d}.npy"),
                      mmap_mode=None if sh is None else "r")
        shape = list(raw.shape) if sh is None else list(sh.shard_shape(raw.shape))
        if shape != list(tmpl.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {list(raw.shape)}"
                             f"{'' if sh is None else f' (a block {shape})'}, "
                             f"template {list(tmpl.shape)}")
        if sh is not None:
            arr = _np_to_leaf(_block(raw, sh), index["dtypes"][i])
        else:
            arr = _np_to_leaf(raw, index["dtypes"][i])
        out.append(arr.to(tmpl.device if device is None else device))
    return unflatten(out), step
