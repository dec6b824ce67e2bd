"""Cases of the recurrent-kinds and encoder-decoder training-on-a-mesh
tests (numpy only).

Both sides build the same configs, f32 params (``_torch_lm_mesh_cases.
fill``), batches and frames from these: the JAX package's runner
(``tests/_torch_lm_mesh_train_recurrent_runner.py``, 4 fake devices) and
the port's gloo ranks (``tests/_torch_lm_world_train_recurrent_runner.py``).
"""
from _torch_lm_mesh_cases import SPARSE
from _torch_lm_mesh_recurrent_cases import frames
from _torch_lm_mesh_train_cases import B, OPT, S, train_batch  # noqa: F401

# (case id, arch, mesh shape, config overrides, microbatches).  The reduced
# zamba2 has one repeat (5 Mamba2 blocks and the shared block); at 12
# layers the shared block runs twice, each invocation rematerialized.  The
# reduced xlstm is 7 mLSTM blocks and 1 sLSTM block.  seamless's vocab of
# 258 splits over 2 ranks but not over 4, as the full 256,206 does.
CASES = (
    ("zamba2-1x4-sparse", "zamba2-2.7b", (1, 4), SPARSE, 1),
    ("zamba2-2x2-dense", "zamba2-2.7b", (2, 2), {}, 1),
    ("zamba2-2x2-sparse-12l", "zamba2-2.7b", (2, 2), dict(SPARSE, n_layers=12), 1),
    ("zamba2-2x2-mb2", "zamba2-2.7b", (2, 2), {}, 2),
    ("xlstm-1x4", "xlstm-1.3b", (1, 4), {}, 1),
    ("xlstm-2x2", "xlstm-1.3b", (2, 2), {}, 1),
    ("seamless-2x2-sparse", "seamless-m4t-medium", (2, 2), SPARSE, 1),
    ("seamless-1x4-v258", "seamless-m4t-medium", (1, 4), dict(vocab=258), 1),
)
QUANT_CASE = "zamba2-2x2-dense"  # also one step with int8 second moments

# TrainLoop(mesh=): the reduced zamba2 on (2, 2) over TokenStream batches
LOOP_ARCH, LOOP_MESH, LOOP_SEQ, LOOP_STEPS = "zamba2-2.7b", (2, 2), 16, 6
FAIL_AT, CKPT_EVERY = 4, 3
# elastic: 4 ranks on (2, 2) write step 4; 2 ranks on (1, 2) run to step 8
ELASTIC_AT, ELASTIC_STEPS, ELASTIC_MP = 4, 8, 2
# xlstm's tree across meshes: (2, 2) writes step 2, (1, 4) and (1, 2) run on
XLSTM_ARCH, XLSTM_AT, XLSTM_STEPS = "xlstm-1.3b", 2, 4


def batch(cfg) -> dict:
    """The case's global batch: tokens and labels, and an enc-dec arch's
    f32 frames."""
    out = train_batch(cfg)
    if cfg.encoder_layers:
        out["frames"] = frames(cfg)
    return out

