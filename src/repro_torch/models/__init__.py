"""Model architectures (plain torch, config-driven).

Counterpart of ``repro/models`` for the dense family:

  common.py       norms, embeddings, RoPE, MLPs
  attention.py    GQA (+ the decode path)
  blocks.py       per-kind block bundles (attention kinds)
  lm.py           full assembly: init/forward/loss/prefill/decode

MoE, MLA, the linear-attention blocks and the encoder wait for their
slices (ROADMAP.md §1 items 2-5).
"""
from . import lm  # noqa: F401
