"""Architecture config schema + registry.

Counterpart of ``repro/configs/base.py``, kept as a copy because the port
never imports the JAX package: the same fields, defaults, ``n_params`` and
``reduced()``, so every ``get_config(name)`` equals the reference's field
for field.  Fields that steer only the JAX package's compilation
(``unroll_layers``, ``remat``) are kept for that equality and read by
nothing in the port.

One ``ArchConfig`` describes any of the 10 assigned architectures (plus the
paper's own SpMV workload via configs/spmv_paper.py).  Layer stacks are
expressed as a repeating ``block_pattern`` (``n_repeats`` times) plus
optional ``prefix_pattern`` — e.g. gemma2 is 23 repeats of
("attn_local", "attn_global"); deepseek-v3 is 3 dense MLA layers then 58
repeats of ("mla_moe",).

`reduced()` shrinks any config to a CPU-smoke-testable size while keeping
the family topology (same pattern, tiny dims).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, Tuple

__all__ = ["ArchConfig", "register", "get_config", "list_configs", "SHAPES"]


# The assigned input-shape grid (system prompt): name -> (seq_len, batch, kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # layer stack
    block_pattern: Tuple[str, ...] = ("attn",)
    prefix_pattern: Tuple[str, ...] = ()

    # attention
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_scale: float | None = None
    attn_softcap: float | None = None  # gemma2: 50.0
    logit_softcap: float | None = None  # gemma2: 30.0
    sliding_window: int | None = None
    gemma_norm: bool = False  # (1 + w) RMSNorm + post-norms
    tie_embeddings: bool = True

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    moe_router: str = "mixtral"
    moe_capacity_factor: float = 1.25

    # MLA (deepseek)
    use_mla: bool = False
    mla_kv_comp: int = 512
    mla_q_comp: int = 1536
    mla_rope_dim: int = 64

    # MTP (deepseek multi-token prediction)
    mtp_depth: int = 0

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_d_inner: int = 0

    # enc-dec (seamless)
    encoder_layers: int = 0

    # modality stub (audio frames / vision patches), prefix length in tokens
    modality_tokens: int = 0

    # SparseP integration: block-sparse FFN density (1.0 = dense)
    ffn_density: float = 1.0
    sparse_block: Tuple[int, int] = (8, 128)

    # shape-cell applicability
    skip_shapes: Tuple[str, ...] = ()
    source: str = ""

    # roofline-probe mode: replace lax.scan loops with unrolled Python loops
    # so compiled.cost_analysis() counts every iteration (analysis/roofline.py
    # lowers L=1 and L=2 unrolled probes to get exact per-layer costs).
    unroll_layers: bool = False

    # activation rematerialization policy for the layer scan:
    #   "full"  recompute everything (min HBM, max recompute FLOPs + the
    #           FSDP weight gathers run twice) — the baseline
    #   "dots"  save matmul outputs without batch dims (XLA names) — fewer
    #           recompute FLOPs at higher HBM (§Perf lever)
    #   "none"  no remat (prefill/decode or small models)
    remat: str = "full"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        pat_layers = len(self.prefix_pattern) + len(self.block_pattern) * self.n_repeats
        assert pat_layers == self.n_layers, (
            f"{self.name}: pattern covers {pat_layers} != n_layers {self.n_layers}"
        )

    @property
    def n_repeats(self) -> int:
        rem = self.n_layers - len(self.prefix_pattern)
        assert rem % len(self.block_pattern) == 0, self.name
        return rem // len(self.block_pattern)

    def moe_capacity(self, tokens: int) -> int:
        """Equal-capacity expert buffers (SparseP padding constraint)."""
        ideal = tokens * self.moe_top_k / max(self.n_experts, 1)
        return max(8, int(math.ceil(ideal * self.moe_capacity_factor / 8) * 8))

    @property
    def n_params(self) -> float:
        """Analytic parameter count (embeddings included once)."""
        d, f = self.d_model, self.d_ff
        per_layer = {}
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim + (
            self.n_heads * self.head_dim * d
        )
        mla = (
            d * self.mla_q_comp
            + self.mla_q_comp * self.n_heads * (self.head_dim + self.mla_rope_dim)
            + d * (self.mla_kv_comp + self.mla_rope_dim)
            + self.mla_kv_comp * self.n_heads * self.head_dim * 2
            + self.n_heads * self.head_dim * d
        )
        mlp = 3 * d * f * self.ffn_density
        moe = (3 * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
               + d * self.n_experts)
        ssm = (d * 2 * self.ssm_d_inner
               + d * 2 * self.ssm_state * self.ssm_heads
               + d * self.ssm_heads + self.ssm_d_inner * d)
        mlstm = 6 * d * d
        slstm = 4 * d * d + 4 * d * (d // max(self.n_heads, 1)) + d * d
        kinds = {
            "attn": attn + mlp,
            "attn_local": attn + mlp,
            "attn_global": attn + mlp,
            "cross_attn": 2 * attn + mlp,  # self + cross attention (enc-dec)
            "moe": attn + moe,
            "mla_dense": mla + mlp,
            "mla_moe": mla + moe,
            "mamba": ssm,
            "mlstm": mlstm,
            "slstm": slstm,
            "shared_attn": 0,  # weights shared; counted once below
        }
        total = sum(kinds[k] for k in self.prefix_pattern)
        total += self.n_repeats * sum(kinds[k] for k in self.block_pattern)
        if "shared_attn" in self.block_pattern:
            total += attn + mlp  # the single shared block
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        total += self.encoder_layers * (attn + mlp)
        return float(total)

    def active_params(self) -> float:
        """Per-token active parameters (MoE: only top_k experts)."""
        if not self.n_experts:
            return self.n_params
        inactive_frac = 1.0 - (self.moe_top_k / self.n_experts)
        moe_total = 3 * self.d_model * self.moe_d_ff * self.n_experts
        n_moe_layers = sum(
            1 for k in self.prefix_pattern if "moe" in k
        ) + self.n_repeats * sum(1 for k in self.block_pattern if "moe" in k)
        return self.n_params - inactive_frac * moe_total * n_moe_layers

    def shapes(self) -> dict:
        return {k: v for k, v in SHAPES.items() if k not in self.skip_shapes}

    def reduced(self) -> "ArchConfig":
        """Tiny same-topology config for CPU smoke tests."""
        pat = len(self.block_pattern)
        pre = len(self.prefix_pattern)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        heads = (heads // kv) * kv  # keep GQA grouping valid
        return replace(
            self,
            n_layers=pre + pat,
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.n_experts else 0,
            moe_d_ff=64 if self.n_experts else 0,
            mla_kv_comp=32 if self.use_mla else 512,
            mla_q_comp=48 if self.use_mla else 1536,
            mla_rope_dim=16 if self.use_mla else 64,
            ssm_state=16 if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            ssm_d_inner=128 if self.ssm_d_inner else 0,
            encoder_layers=min(self.encoder_layers, 2),
            sliding_window=(min(self.sliding_window, 16)
                            if self.sliding_window else None),
            modality_tokens=min(self.modality_tokens, 8),
        )


_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ArchConfig:
    from . import _load_all  # populate registry

    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs():
    from . import _load_all

    _load_all()
    return sorted(_REGISTRY)
