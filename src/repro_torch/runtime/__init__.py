"""Runtime: checkpointing, fault tolerance, elastic rescaling.
Counterpart of ``repro/runtime``; the spec trees' shardings over a process
mesh (``make_shardings``, ``sanitize_shardings``) live in ``elastic``."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: F401
from .elastic import (RescalePlan, make_shardings, rescale_mesh_shape,  # noqa: F401
                      sanitize_shardings, shard_tree, unshard_tree)
from .fault import FaultEvent, HealthMonitor, RestartPolicy  # noqa: F401
