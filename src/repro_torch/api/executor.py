"""Executor — one call signature for every SpMV path.

Counterpart of ``repro/api/executor.py`` (single-device part).  An
:class:`Executor` is the compiled end of the ``SparseMatrix ->
ExecutionPlan -> Executor`` pipeline: ``y = exe(x)`` for one vector and
``Y = exe.batch(X)`` for multi-RHS SpMM.  Both return host NumPy rows.

x may be a NumPy array or a torch tensor.  Results whose dtype is bfloat16
are returned widened to float32 (exactly): NumPy has no bfloat16 unless
``ml_dtypes`` is installed.  Under ``impl="cuda"`` a bfloat16 matrix yields
float32 anyway (the kernels' accumulation dtype).

The mesh executor of the partitioned schemes and ``iterate`` are not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import formats as F
from ..kernels import ops

__all__ = ["Executor", "SingleDeviceExecutor", "to_host"]


def to_host(y: torch.Tensor) -> np.ndarray:
    """Device result -> host ndarray (bfloat16 widened to float32)."""
    if y.dtype == torch.bfloat16:
        y = y.float()
    return y.cpu().numpy()


class Executor:
    """Common surface: ``exe(x) -> y`` and ``exe.batch(X) -> Y`` (host rows)."""

    plan = None  # the ExecutionPlan this executor was compiled from

    def __call__(self, x) -> np.ndarray:
        """y = A @ x for one vector x of shape (cols,); returns host rows."""
        raise NotImplementedError

    def batch(self, X) -> np.ndarray:
        """Y = A @ X for X of shape (cols, B); one SpMM, returns host rows."""
        raise NotImplementedError

    def release(self) -> None:
        """Free device buffers held by this executor (idempotent)."""

    # -- shared input validation ------------------------------------------

    def _check_x(self, x, cols: int, dtype: torch.dtype) -> torch.Tensor:
        x = F.to_tensor(x)
        if not torch.can_cast(x.dtype, dtype):
            raise TypeError(f"x dtype {x.dtype} cannot safely cast to matrix "
                            f"dtype {dtype}")
        x = x.to(dtype)
        if x.shape[0] != cols:
            raise ValueError(f"x has {x.shape[0]} rows, matrix has {cols} cols")
        return x


class SingleDeviceExecutor(Executor):
    """kernels.ops-backed executor on one device (torch oracle or kernels).

    For ``impl="cuda"`` the kernel program (``.program``: chunk plan for
    COO/CSR, block-row pointer for BCOO) is built and placed on the device
    once, here; every ``exe(x)`` / ``exe.batch(X)`` then runs only the
    kernel — one launch for a whole SpMM batch.  For ``impl="torch"`` the
    container itself is placed on the device once.
    """

    def __init__(self, plan, container, impl: str, device):
        self.plan = plan
        self.impl = impl
        self.device = torch.device(device)
        self.shape = container.shape
        self.dtype = container.dtype
        if impl == "cuda":
            self.container = container
            self.program = ops.kernel_program(container, device=self.device)
        else:
            self.container = container.to(self.device)
            self.program = None
        self._released = False

    def __call__(self, x) -> np.ndarray:
        """y = A @ x (host rows).

        Args:
          x: (cols,) vector, or (cols, B) — forwarded to :meth:`batch`.

        Raises:
          TypeError: if x's dtype cannot safely cast to the matrix dtype.
          ValueError: on a length mismatch with the matrix columns.
          RuntimeError: if the executor was released.
        """
        x = self._check_x(x, self.shape[1], self.dtype)
        if x.ndim == 2:
            return self.batch(x)
        return self._run(x)

    def batch(self, X) -> np.ndarray:
        """Y = A @ X for X of shape (cols, B) — one SpMM, any impl.

        Raises:
          TypeError/ValueError: as :meth:`__call__`, plus ValueError when X
            is not 2D.
        """
        X = self._check_x(X, self.shape[1], self.dtype)
        if X.ndim != 2:
            raise ValueError(f"batch expects X of shape (cols, B); got "
                             f"{tuple(X.shape)}")
        return self._run(X)

    def _run(self, x: torch.Tensor) -> np.ndarray:
        if self._released:
            raise RuntimeError("executor released; recompile")
        x = x.to(self.device).contiguous()
        if self.program is not None:
            return to_host(self.program(x))
        return to_host(ops.spmv(self.container, x, impl="torch"))

    def release(self) -> None:
        """Drop the device-placed matrix and kernel program (idempotent)."""
        self._released = True
        self.container = None
        self.program = None
