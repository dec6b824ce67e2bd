"""Config registry: one module per assigned architecture + the paper's own.

Counterpart of ``repro/configs``: the same names and the same configs.
"""
import importlib

_MODULES = [
    "llama3_2_1b",
    "qwen1_5_0_5b",
    "gemma2_27b",
    "smollm_360m",
    "deepseek_v3_671b",
    "mixtral_8x22b",
    "xlstm_1_3b",
    "seamless_m4t_medium",
    "zamba2_2_7b",
    "llava_next_34b",
]

_loaded = False


def _load_all():
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True


from .base import ArchConfig, get_config, list_configs, SHAPES  # noqa: E402,F401
