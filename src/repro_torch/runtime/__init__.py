"""Runtime: checkpointing, fault tolerance, elastic rescaling.
Counterpart of ``repro/runtime`` on one device."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: F401
from .elastic import RescalePlan, rescale_mesh_shape  # noqa: F401
from .fault import FaultEvent, HealthMonitor, RestartPolicy  # noqa: F401
