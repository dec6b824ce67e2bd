"""Optimizer substrate: AdamW, schedules, gradient compression.
Counterpart of ``repro/optim``; ``opt_specs`` is data only until training
runs on a mesh (ROADMAP.md §1 item 7)."""
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
