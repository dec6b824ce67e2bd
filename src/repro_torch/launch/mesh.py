"""Mesh definitions for the launchers.

Counterpart of ``repro/launch/mesh.py``.  The reference lays 256 or 512
TPU chips out as (data, model) or (pod, data, model).  The port runs on
one card: :func:`make_local_mesh` is a (1, 1) ``Mesh`` over it, and
:func:`make_production_mesh` raises until multi-card meshes land (a grid
of distinct devices, ROADMAP.md "Multi-card meshes"); it never falls back
to one device.
"""
from __future__ import annotations

from repro_torch.core.mesh import Mesh, make_mesh

__all__ = ["make_production_mesh", "make_local_mesh", "MODEL_PARALLEL"]

# the reference's model-parallel width on its pod (kept for parity)
MODEL_PARALLEL = 16


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's (16, 16) or (2, 16, 16) mesh: not ported.

    Raises:
      NotImplementedError: always (see ROADMAP.md, "Multi-card meshes").
    """
    chips = 512 if multi_pod else 256
    raise NotImplementedError(
        f"a {chips}-device production mesh needs distinct devices, which are "
        "not ported yet (see ROADMAP.md, 'Multi-card meshes'); the port runs "
        "on one card (make_local_mesh)")


def make_local_mesh(model_parallel: int = 1, device="cuda") -> Mesh:
    """A (data, model) = (1, 1) mesh over ``device`` (the card unless the
    caller passes "cpu").  One device holds one place, whatever
    ``model_parallel`` asks, as the reference clips it to the devices it
    has."""
    del model_parallel  # one device: the model axis has width 1
    return make_mesh((1, 1), ("data", "model"), devices=[device])
