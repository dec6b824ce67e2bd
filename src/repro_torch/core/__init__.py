"""SparseP core, in PyTorch: compressed formats, statistics, scheme selection.

  formats.py   CSR/COO/BCSR/BCOO as dataclasses of tensors (paper §2.1.1)
  stats.py     sparsity statistics + regular/scale-free/block classes (§4)
  adaptive.py  scheme auto-selection from matrix stats (paper Rec. #3)
  partition.py 1D / 2D partitioning into P parts (paper §3.3, Figs. 5-8)
  mesh.py      a named grid of places for the parts: one device (Mesh), or
               the ranks of a torch.distributed world (ProcessMesh), with
               each place's slot in a topology's device order
  world.py     the world a process mesh runs on (init_world, spawn)
  collectives.py  all-gather, ppermute, psum, psum_scatter over a process
               mesh, with their bytes by kind
  spmv.py      single-device SpMV dispatch (facade over kernels/ops.py)
  distributed.py  partitioned SpMV: per-part kernels + merges (paper Fig. 4)
"""
from .adaptive import HardwareModel, Plan, select_scheme  # noqa: F401
from .formats import BCOO, BCSR, COO, CSR  # noqa: F401
from .stats import MatrixStats, compute_stats  # noqa: F401
