"""Cases of the LM-training-on-a-process-mesh tests (numpy only).

Both sides build the same configs, f32 params (``_torch_lm_mesh_cases.
fill``) and batches from these: the JAX package's runner
(``tests/_torch_lm_mesh_train_runner.py``, 4 fake devices) and the port's
gloo ranks (``tests/_torch_lm_world_train_runner.py``).
"""
import numpy as np

from _torch_lm_mesh_cases import SPARSE

B, S = 4, 16
OPT = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)

# (case id, arch, mesh shape, config overrides, microbatches)
TRAIN_CASES = (
    ("qwen-1x4-dense", "qwen1.5-0.5b", (1, 4), {}, 1),
    ("qwen-1x4-sparse", "qwen1.5-0.5b", (1, 4), SPARSE, 1),
    ("qwen-2x2-dense", "qwen1.5-0.5b", (2, 2), {}, 1),
    ("qwen-2x2-sparse", "qwen1.5-0.5b", (2, 2), SPARSE, 1),
    # 64 experts: the expert-parallel branch (two all-to-alls); its sparse
    # MLA prefix layer and the MTP head
    ("deepseek-2x2-sparse", "deepseek-v3-671b", (2, 2),
     dict(SPARSE, n_experts=64, n_layers=2, prefix_pattern=("mla_dense",)), 1),
    ("mixtral-2x2-mb2", "mixtral-8x22b", (2, 2), {}, 2),
)
QUANT_CASE = "qwen-2x2-dense"  # also one step with int8 second moments

# TrainLoop(mesh=): the reduced qwen on (2, 2) over TokenStream batches
LOOP_ARCH, LOOP_MESH, LOOP_SEQ, LOOP_STEPS = "qwen1.5-0.5b", (2, 2), 16, 6
FAIL_AT, CKPT_EVERY = 4, 3
# elastic: 4 ranks on (2, 2) write step 4; 2 ranks on (1, 2) run to step 8
ELASTIC_AT, ELASTIC_STEPS, ELASTIC_MP = 4, 8, 2


def train_batch(cfg, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": labels}


# ---------------------------------------------------------------------------
# each differentiable move alone: (id, axis kind), global x and cotangents
# ---------------------------------------------------------------------------

MOVE_MESH = (2, 2)
MOVES = (
    ("gather-model", "model"),
    ("gather-data-split", "data"),
    ("gather-data-whole", "data"),
    ("slice-model", "model"),
    ("slice-data-split", "data"),
    ("psum-model", "model"),
    ("psum-scatter-data", "data"),
    ("all-to-all-data", "data"),
    ("reshard-data", "data"),
    ("model-in", "model"),
)


def move_arrays(move: str, seed: int = 11) -> tuple:
    """(x, r): a seeded global input (4, 6) and a cotangent per rank
    (4 ranks, each (4, 6)) of float64-exact small integers."""
    rng = np.random.default_rng([seed, len(move)])
    x = rng.integers(-3, 4, (4, 6)).astype(np.float32)
    r = rng.integers(-3, 4, (4, 4, 6)).astype(np.float32)
    return x, r
