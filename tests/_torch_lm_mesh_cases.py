"""Cases of the LM-on-a-process-mesh tests (numpy only).

Both sides build the same configs, params and tokens from these: the JAX
package's runner (``tests/_torch_lm_mesh_runner.py``, 4 fake devices) and
the port's 4 gloo ranks (``tests/_torch_lm_world_runner.py``).  Params are
each package's own init tree (the same keys, shapes and sparsity
patterns) with every float leaf replaced by a seeded draw from
:func:`fill`, so both packages hold identical weights.
"""
import dataclasses

import numpy as np

B, S, MAX_LEN, DECODE_STEPS = 4, 16, 20, 3
SPARSE = dict(ffn_density=0.5, sparse_block=(8, 16))

# (case id, arch, mesh shape, config overrides)
LM_CASES = (
    ("qwen-1x4-dense", "qwen1.5-0.5b", (1, 4), {}),
    ("qwen-1x4-sparse", "qwen1.5-0.5b", (1, 4), SPARSE),
    ("qwen-2x2-dense", "qwen1.5-0.5b", (2, 2), {}),
    ("qwen-2x2-sparse", "qwen1.5-0.5b", (2, 2), SPARSE),
    # 64 experts: the reduced config's 4 would take the reference's
    # few-experts branch; 64 takes the expert-parallel one (all-to-alls).
    # One dense MLA prefix layer and one MLA + MoE repeat, as on the card
    ("deepseek-2x2-sparse", "deepseek-v3-671b", (2, 2),
     dict(SPARSE, n_experts=64, n_layers=2, prefix_pattern=("mla_dense",))),
    ("mixtral-2x2", "mixtral-8x22b", (2, 2), {}),
)
SERVER_CASE = "qwen-2x2-sparse"  # also through Server(mesh=).generate
# the ranks share one host, so their collectives move the data through
# shared memory; these also run over gloo's own collectives
GLOO_CASES = ("qwen-2x2-sparse", "deepseek-2x2-sparse")
SERVER_TOKENS = 4

# MoE layers alone, (4, 32, d) tokens on (2, 2): two dispatch groups of 64
# tokens; the capacity factor is cut so that assignments drop
MOE_SHAPE = (4, 32)
MOE_CASES = (
    ("moe-ep", "deepseek-v3-671b", dict(n_experts=64, moe_capacity_factor=0.5)),
    ("moe-local", "mixtral-8x22b", dict(moe_capacity_factor=0.5)),
)
MOE_MESH = (2, 2)


def config(get_config, arch: str, overrides: dict):
    return dataclasses.replace(get_config(arch).reduced(), **overrides)


def _paths(tree, prefix=""):
    """(path, leaf) of nested dicts, keys sorted (jax.tree's order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def fill(tree: dict, seed: int) -> dict:
    """``tree`` (nested dicts of numpy arrays) with every float leaf drawn
    anew: norm scales 1 + 0.1 N, other vectors 0.1 N, block values
    N / sqrt(2 c), matrices N / sqrt(fan-in)."""
    out: dict = {}
    for i, (path, a) in enumerate(_paths(tree)):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            rng = np.random.default_rng([seed, i])
            n = rng.standard_normal(a.shape)
            if path.endswith("/scale"):
                a = 1.0 + 0.1 * n
            elif a.ndim == 1:
                a = 0.1 * n
            elif path.endswith("/bvalues"):
                a = n / np.sqrt(2 * a.shape[-1])
            else:
                a = n / np.sqrt(a.shape[-2])
            a = a.astype(np.float32)
        node = out
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = a
    return out


def lm_inputs(cfg, seed: int = 5):
    """(prompt (B, S), decode tokens (DECODE_STEPS, B, 1)), int32."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (DECODE_STEPS, B, 1)).astype(np.int32)
    return toks, steps


def moe_input(cfg, seed: int = 9) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(MOE_SHAPE + (cfg.d_model,)).astype(np.float32)
