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
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..tree import flatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


def _leaf_to_np(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)  # the raw bits
    return x.numpy()


def _np_to_leaf(x: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    if x.dtype.name != dtype:
        raise ValueError(f"leaf stored as {x.dtype} but indexed as {dtype}")
    return torch.from_numpy(x)


def save_checkpoint(ckpt_dir: str, step: int, tree, metadata: dict | None = None):
    """Write a complete checkpoint of ``tree`` (tensors) for ``step``
    atomically; returns its directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, _ = flatten(tree)
    index = {
        "step": step,
        "treedef": f"repro_torch: {len(leaves)} leaves in jax.tree.flatten order",
        "n_leaves": len(leaves),
        "dtypes": [_dtype_name(leaf) for leaf in leaves],
        "shapes": [list(leaf.shape) for leaf in leaves],
        "metadata": metadata or {},
    }
    for i, leaf in enumerate(leaves):
        np.save(os.path.join(tmp, f"leaf-{i:06d}.npy"), _leaf_to_np(leaf))
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(name)
    os.rename(os.path.join(ckpt_dir, "LATEST.tmp"), os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> int | None:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "index.json")):
        return None  # torn LATEST; treat as absent
    return int(name.split("_")[1])


def restore_checkpoint(ckpt_dir: str, like, step: int | None = None,
                       device=None):
    """Restore into the structure of ``like`` (a params / opt tree template).

    Each leaf goes to ``device``, or where it is None to the device of the
    template's leaf.  Returns (tree, step), or (None, None) when no
    checkpoint exists.

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
    out = []
    for i, tmpl in enumerate(leaves_like):
        raw = np.load(os.path.join(d, f"leaf-{i:06d}.npy"))
        if list(raw.shape) != list(tmpl.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {list(raw.shape)}, "
                             f"template {list(tmpl.shape)}")
        arr = _np_to_leaf(raw, index["dtypes"][i])
        out.append(arr.to(tmpl.device if device is None else device))
    return unflatten(out), step
