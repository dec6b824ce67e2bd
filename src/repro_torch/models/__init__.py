"""Model architectures (plain torch, config-driven).

Counterpart of ``repro/models`` for every registered arch:

  common.py       norms, embeddings, RoPE, MLPs
  attention.py    GQA, MLA and cross-attention (+ the decode paths)
  moe.py          MoE layers: routers, SparseP-style dispatch / combine
  linear_attn.py  Mamba2, mLSTM, sLSTM (chunked GLA and its step)
  blocks.py       per-kind block bundles
  lm.py           full assembly: init/forward/loss (+ MTP)/prefill/decode,
                  and the enc-dec encoder (``encode``)
"""
from . import lm  # noqa: F401
