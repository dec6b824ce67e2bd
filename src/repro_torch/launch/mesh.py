"""Mesh definitions for the launchers.

Counterpart of ``repro/launch/mesh.py``.  The reference lays 256 or 512
TPU chips out as (data, model) = (16, 16) or (pod, data, model) =
(2, 16, 16).  Here the places of a mesh are the ranks of a
``torch.distributed`` world (``core/world.py``), one per device:

* :func:`make_production_mesh` lays the reference's layout over a world of
  256 or 512 ranks as a :class:`~repro_torch.core.mesh.ProcessMesh` (a
  world of the "dry" backend gives a dry-run mesh that only counts).  It
  never falls back to one device: without such a world it raises, naming
  the ranks it needs.
* :func:`make_local_mesh` is a (world / mp, mp) process mesh over a world
  (the reference's over its host's devices), or, without one, the (1, 1)
  ``Mesh`` of one device.
* :func:`env_world` joins the world that ``torchrun`` describes in the
  environment, where it started this process as a rank: the launchers'
  ``main``s run on ``make_local_mesh(world=)`` then, and on one device
  otherwise.
"""
from __future__ import annotations

import os

import torch

from repro_torch.core.mesh import (Mesh, ProcessMesh, dry_process_mesh, make_mesh,
                                   make_process_mesh)

__all__ = ["make_production_mesh", "make_local_mesh", "production_layout",
           "env_world", "MODEL_PARALLEL"]

# the reference's model-parallel width on its pod (fixed by per-chip HBM)
MODEL_PARALLEL = 16


def production_layout(multi_pod: bool = False) -> tuple:
    """(shape, axis names) of the reference's production mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(world=None, *, multi_pod: bool = False) -> ProcessMesh:
    """The reference's (16, 16) or (2, 16, 16) mesh over ``world``'s ranks.

    Raises:
      NotImplementedError: no world is given (one process cannot lay it
        out over distinct devices; see ROADMAP.md, "Multi-card meshes").
      ValueError: the world's size is not the layout's.
    """
    shape, axes = production_layout(multi_pod)
    ranks = 1
    for n in shape:
        ranks *= n
    if world is None:
        raise NotImplementedError(
            f"the {shape} production mesh needs a world of {ranks} ranks, one "
            f"per device (core.world.init_world); none was given (see "
            f"ROADMAP.md, 'Multi-card meshes')")
    if world.size != ranks:
        raise ValueError(f"the {shape} production mesh needs a world of {ranks} "
                         f"ranks; this one has {world.size}")
    if world.backend == "dry":
        return dry_process_mesh(shape, axes, rank=world.rank)
    return make_process_mesh(world, shape, axes)


def make_local_mesh(model_parallel: int = 1, device="cuda",
                    world=None) -> Mesh:
    """A (data, model) mesh: over ``world``'s ranks, (size / mp, mp) with mp
    = ``model_parallel`` clipped to the world's size (a
    :class:`~repro_torch.core.mesh.ProcessMesh`; collective); without a
    world, the (1, 1) mesh of ``device`` (the card unless the caller passes
    "cpu"), whatever ``model_parallel`` asks, as the reference clips it to
    the devices it has."""
    if world is None:
        return make_mesh((1, 1), ("data", "model"), devices=[device])
    mp = max(1, min(model_parallel, world.size))
    if world.size % mp:
        raise ValueError(f"model_parallel={mp} does not divide a world of "
                         f"{world.size} ranks")
    return make_process_mesh(world, (world.size // mp, mp), ("data", "model"))


def env_world(device="cuda"):
    """This process's world where ``torchrun`` started it as a rank
    (``RANK`` and ``WORLD_SIZE`` in the environment, the store at
    ``MASTER_ADDR`` / ``MASTER_PORT``; ``core.world.init_world``), else
    None.  ``device`` "cpu" puts every rank on the host over gloo;
    otherwise each rank takes ``cuda:<LOCAL_RANK>``, over NCCL where the
    host has a card for each of its ranks (``LOCAL_WORLD_SIZE``) and over
    gloo where they share cards (NCCL refuses two ranks on one)."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    from repro_torch.core.world import init_world

    dev = torch.device(device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    own_card = dev.type == "cuda" and local <= torch.cuda.device_count()
    on = None if dev.type == "cuda" and dev.index is None else dev
    return init_world("nccl" if own_card else "gloo", device=on)
