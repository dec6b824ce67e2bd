"""Model architectures (plain torch, config-driven).

Counterpart of ``repro/models`` for the dense and MoE families:

  common.py       norms, embeddings, RoPE, MLPs
  attention.py    GQA and MLA (+ their decode paths)
  moe.py          MoE layers: routers, SparseP-style dispatch / combine
  blocks.py       per-kind block bundles (attention, MoE and MLA kinds)
  lm.py           full assembly: init/forward/loss (+ MTP)/prefill/decode

The linear-attention blocks and the encoder wait for their slices
(ROADMAP.md §1 items 4-5).
"""
from . import lm  # noqa: F401
