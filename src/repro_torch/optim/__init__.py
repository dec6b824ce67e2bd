"""Optimizer substrate: AdamW, schedules, gradient compression.
Counterpart of ``repro/optim``; ``opt_specs`` places the state of
``TrainLoop(mesh=)``, whose update takes the global norm and the int8
scales over the whole leaves (``apply_updates(..., shardings=)``)."""
from .adamw import (  # noqa: F401
    AdamWConfig,
    OptState,
    apply_updates,
    global_norm_clip,
    init_opt,
    opt_specs,
    warmup_cosine,
)
from .compress import (  # noqa: F401
    compress_grads,
    dequantize_int8,
    init_residual,
    quantize_int8,
)
