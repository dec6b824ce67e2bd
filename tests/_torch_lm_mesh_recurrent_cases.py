"""Cases of the recurrent-kinds and encoder-decoder mesh tests (numpy only).

Both sides build the same configs, params, tokens and frames from these:
the JAX package's runner (``tests/_torch_lm_mesh_recurrent_runner.py``, 4
fake devices) and the port's 4 gloo ranks
(``tests/_torch_lm_world_recurrent_runner.py``).  Params come from each
package's own init tree with every float leaf drawn by
``_torch_lm_mesh_cases.fill``, so both hold identical weights.
"""
import numpy as np

from _torch_lm_mesh_cases import (B, DECODE_STEPS, MAX_LEN, S, SPARSE,  # noqa: F401
                                  _paths, config, fill, lm_inputs)

# (case id, arch, mesh shape, config overrides).  The reduced zamba2 has 4
# SSM heads and d_inner 128: on (1, 4) ranks 0-1 hold in_proj's x columns
# and ranks 2-3 its z columns.  seamless's reduced vocab of 256 splits
# over 2 (a vocab-parallel embedding on (2, 2)); 258 splits over 2 but not
# over 4, as the full 256,206 does, so on (1, 4) the embedding is whole.
CASES = (
    ("zamba2-1x4-dense", "zamba2-2.7b", (1, 4), {}),
    ("zamba2-1x4-sparse", "zamba2-2.7b", (1, 4), SPARSE),
    ("zamba2-2x2-dense", "zamba2-2.7b", (2, 2), {}),
    ("zamba2-2x2-sparse", "zamba2-2.7b", (2, 2), SPARSE),
    ("xlstm-1x4", "xlstm-1.3b", (1, 4), {}),
    ("xlstm-2x2", "xlstm-1.3b", (2, 2), {}),
    ("seamless-2x2-sparse", "seamless-m4t-medium", (2, 2), SPARSE),
    ("seamless-1x4-v258", "seamless-m4t-medium", (1, 4), dict(vocab=258)),
)
SERVER_CASE = "zamba2-2x2-sparse"  # also through Server(mesh=).generate
SERVER_TOKENS = 4
S_ENC = 12  # stub frames a row
# the step builders' shape (an entry both runners add to their SHAPES)
SHAPE = "mesh_test_prefill"
SHAPE_ENTRY = dict(seq_len=MAX_LEN, global_batch=B, kind="prefill")


def frames(cfg, seed: int = 7) -> np.ndarray:
    """(B, S_ENC, d) f32 stub frame embeddings."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)


def heads_dim(kind: str) -> int:
    """The heads dim of a stacked cache tensor of ``kind``: (NR, B, H, ...)
    for a recurrent state, (NR, B, S, H, dh) for a KV cache."""
    return 2 if kind in ("mamba", "mlstm", "slstm") else 3
