"""Executor — one call signature for every SpMV path.

Counterpart of ``repro/api/executor.py``.  An :class:`Executor` is the
compiled end of the ``SparseMatrix -> ExecutionPlan -> Executor`` pipeline:
``y = exe(x)`` for one vector and ``Y = exe.batch(X)`` for multi-RHS SpMM,
whether the plan runs

  * on one device through :mod:`repro_torch.kernels.ops`
    (:class:`SingleDeviceExecutor`), or
  * partitioned over the P parts of a mesh through
    :mod:`repro_torch.core.distributed` (:class:`MeshExecutor`), which also
    exposes the paper's three phases (``place`` / ``run_raw`` /
    ``assemble``, Fig. 4 load / kernel / retrieve).

Both return host NumPy rows in the dtype the JAX package returns.  x may
be a NumPy array or a torch tensor.  NumPy has no bfloat16 of its own:
where ``ml_dtypes`` imports (it comes with JAX), bfloat16 results are
``ml_dtypes.bfloat16`` arrays, bit for bit, as the JAX package's are;
where it does not (the card's machine has no JAX), they are widened to
float32, exactly.  Under ``impl="cuda"`` a single-device bfloat16 matrix
yields float32 (the kernels' accumulation dtype), as the JAX package's
``impl="pallas"`` does; partitioned plans cast each part to the values
dtype before the merge, as the reference does.

``exe.iterate(x0, steps=k | tol=...)`` runs a solver session with x on
the device between steps (:mod:`repro_torch.api.iterate`).

A :class:`MeshExecutor` on a process mesh whose rank 0 leads
(``core/control.py``; ``SpmvEngine(world=)`` makes one) is called on rank 0
alone.  Each call validates x there, sends the other ranks a command and
scatters each rank only its ``x_spec`` shard (the paper's Fig. 4 load, as
JAX's sharded ``device_put``; counted as ``"scatter"`` in
``exe.collectives``); every rank then runs its part and the merge, the
assembled y comes back on rank 0, and the other ranks drop theirs.  The
command holds the world's mesh lock from :meth:`~MeshExecutor.place` to
the end of :meth:`~MeshExecutor.assemble`: a thread that calls the three
phases one by one holds them in that order (``exe(x)`` does).

Every request runs on the calling thread's own CUDA stream
(:mod:`repro_torch.core.streams`), and each phase that blocks waits on
that stream alone, as the reference blocks on the request's own arrays:
with several host threads serving at once, one request's phase times hold
its own work only.
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..core import distributed as D
from ..core import formats as F
from ..core.mesh import AXES_2D, AXIS_1D
from ..core.streams import on_thread_stream, wait
from ..kernels import ops
from .iterate import IterateResult, check_iterate, run_iterate

__all__ = ["Executor", "SingleDeviceExecutor", "MeshExecutor", "to_host",
           "IterateResult", "ExecutorReleased", "AXIS_1D", "AXES_2D",
           "follower_handlers"]


class ExecutorReleased(RuntimeError):
    """The executor's device arrays were released before this call used
    them; nothing was launched.  Recompile (or, in the engine, look the
    plan up again)."""


@functools.cache
def _np_bfloat16():
    """numpy's bfloat16 from ml_dtypes, or None where it does not import
    (imported on the first bfloat16 result, not with the package)."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


def to_host(y: torch.Tensor) -> np.ndarray:
    """Device result -> host ndarray.  bfloat16 comes back as
    ``ml_dtypes.bfloat16`` (same bits) where ml_dtypes imports, else
    widened to float32 (exact)."""
    if y.dtype == torch.bfloat16:
        bf16 = _np_bfloat16()
        if bf16 is None:
            return y.float().cpu().numpy()
        return y.cpu().view(torch.int16).numpy().view(bf16)
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

    # -- iterative-solver sessions ----------------------------------------

    def iterate(self, x0, steps=None, tol=None, combine="plain", *,
                b=None, diag=None, omega: float = 1.0,
                max_steps: int = 1000, check_every: int = 8) -> IterateResult:
        """Run a solver loop of SpMVs with x resident on the device.

        Exactly ``steps=k`` steps, or (``tol=...``) steps until the
        residual, read every ``check_every`` steps, falls to ``tol``,
        bounded by ``max_steps``; each step is ``y = A @ x`` plus the
        per-step ``combine`` (``plain`` / ``power`` / ``richardson`` /
        ``jacobi`` / ``cg`` or a callable ``f(x, y) -> x_next``) — see
        :mod:`repro_torch.api.iterate`.  Requires a square matrix.  Runs on
        the calling thread's own stream; the loop is cached per (combine,
        mode), so repeated solves — including with new ``b`` — reuse it.

        Returns:
          :class:`IterateResult` — x on host, steps executed, convergence
          flag + residual, per-phase seconds.

        Raises:
          ValueError: non-square matrix, both/neither of steps and tol,
            batched x0, or missing combine params (b / diag).
          TypeError: x0 dtype cannot safely cast to the matrix dtype.
          ExecutorReleased: the executor was released.
        """
        with on_thread_stream(self.device):
            return run_iterate(
                self, self._iterate_apply(), x0, steps=steps, tol=tol,
                combine=combine, b=b, diag=diag, omega=omega,
                max_steps=max_steps, check_every=check_every,
            )

    def _iterate_shape(self):
        """(n, dtype) for solver loops; raises unless the matrix is square."""
        raise NotImplementedError

    def _iterate_apply(self):
        """Device function, logical (n,) -> (n,) in the matrix dtype."""
        raise NotImplementedError

    @staticmethod
    def _require_square(rows: int, cols: int):
        if rows != cols:
            raise ValueError(
                f"iterate() feeds y back as the next x and therefore needs "
                f"a square matrix; got {rows}x{cols}"
            )
        return cols

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

    def __call__(self, x) -> np.ndarray:
        """y = A @ x (host rows).

        Args:
          x: (cols,) vector, or (cols, B) — forwarded to :meth:`batch`.

        Raises:
          TypeError: if x's dtype cannot safely cast to the matrix dtype.
          ValueError: on a length mismatch with the matrix columns.
          ExecutorReleased: if the executor was released.
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
        spmv = self._device_spmv()
        # the copy back to the host waits on this thread's stream alone
        with on_thread_stream(self.device):
            return to_host(spmv(x.to(self.device).contiguous()))

    def _device_spmv(self):
        """y = A @ x on the device: the kernel program, or the oracle on
        the placed container; the caller holds it, so a concurrent
        release cannot pull it away mid-request."""
        program, container = self.program, self.container
        if container is None:  # released (release drops both)
            raise ExecutorReleased("executor released; recompile")
        if program is not None:
            return program
        return functools.partial(ops.spmv, container, impl="torch")

    def release(self) -> None:
        """Drop the device-placed matrix and kernel program (idempotent)."""
        self.container = None
        self.program = None

    # -- solver-loop backend ----------------------------------------------

    def _iterate_shape(self):
        return self._require_square(*self.shape), self.dtype

    def _iterate_apply(self):
        """y = A @ v on the device — the same kernel program (or oracle) as
        ``exe(x)``, cast back to the matrix dtype so the recurrence matches
        k host-side calls bit for bit (``_check_x`` applies the same cast on
        the host loop: bfloat16 matrices yield float32 from the kernels)."""
        spmv, dtype = self._device_spmv(), self.dtype

        def apply(v):
            y = spmv(v)
            return y.to(dtype) if y.dtype != dtype else y

        return apply


class MeshExecutor(Executor):
    """Partitioned executor: the matrix partitioned, placed and its program
    built once.

    On a :class:`~repro_torch.core.mesh.Mesh` every part lies on the mesh's
    one device; the program
    (:class:`~repro_torch.core.distributed.PartitionedProgram`) runs the
    per-part tile kernel for all parts at once — for ``impl="cuda"`` one
    part-axis launch per request — and the merge as tensor operations on
    the part axis.

    On a :class:`~repro_torch.core.mesh.ProcessMesh` this executor is one
    rank's: it holds this rank's part, every rank calls it collectively
    with the same x, and every rank returns the whole y.  :meth:`place`
    keeps this rank's shard of x (the reference's ``x_spec``), the program
    runs the part's tile kernel (for ``impl="cuda"`` one launch per rank
    and request) and the collectives, whose calls, bytes and seconds
    ``collectives`` counts.
    """

    def __init__(self, plan, part, mesh, axes: tuple, program, x_spec,
                 x_pad: int, merge: str):
        self.plan = plan
        self.part = part
        self.mesh = mesh
        self.device = mesh.device
        self.axes = axes
        self.program = program
        self.x_spec = x_spec
        self.x_pad = x_pad
        self.merge = merge
        self.arrays = None  # placed matrix arrays (set by place_matrix)
        self.build_seconds = 0.0
        # rank 0 of a led world (ExecutionPlan.compile sets both): the
        # control channel, and the id the other ranks hold this plan under
        self.control = None
        self.wid = None
        self.build_split = None  # rank 0 of a led world: partition / send
        self._calls = threading.local()  # the command a thread has in flight

    @property
    def trace_count(self) -> int:
        """Programs built for this executor: 1, built in ``compile``.

        The JAX package counts ``jit`` (re)traces here; torch runs eagerly
        and traces nothing, so the port counts program builds instead.  A
        request never builds one.
        """
        return 1

    def place_matrix(self, placed_arrays) -> "MeshExecutor":
        self.arrays = placed_arrays
        return self

    @property
    def collectives(self):
        """The process mesh's :class:`~repro_torch.core.collectives.
        Collectives` of this executor (None on a one-device mesh)."""
        return getattr(self.program, "coll", None)

    def _shard(self, x: torch.Tensor, rank=None) -> torch.Tensor:
        """``rank``'s (default: this rank's) shard of the padded x along
        ``x_spec``'s axis (the whole x on a one-device mesh)."""
        if not self.mesh.is_process:
            return x
        axis = self.mesh.axis_names.index(self.x_spec[0])
        n = self.mesh.devices.shape[axis]
        w = x.shape[0] // n
        coords = (self.mesh.coords if rank is None else
                  np.unravel_index(rank, self.mesh.devices.shape))
        i = int(coords[axis])
        return x[i * w: (i + 1) * w]

    # -- rank 0 of a led world -------------------------------------------------

    def _lead_place(self, x: torch.Tensor) -> torch.Tensor:
        """Send the call to the other ranks and scatter each its shard of
        the padded x; the command stays open (mesh lock held) until
        :meth:`assemble` or a failure ends it."""
        ctl = self.control
        pieces = [self._shard(x, r) for r in range(self.mesh.devices.size)]
        with ctl.lock:  # no release can slip in between the check and the send
            if self.arrays is None:
                raise ExecutorReleased("executor released; recompile")
            cmd = ctl.command("call", {"wid": self.wid,
                                       "shape": tuple(pieces[0].shape),
                                       "dtype": x.dtype})
            cmd.__enter__()
        self._calls.cmd = cmd
        try:
            with on_thread_stream(self.device):
                xs = self.collectives.scatter(pieces, pieces[0].shape, x.dtype)
                wait(self.device)
        except BaseException as e:
            self._lead_end(e)
            raise
        return xs

    def _lead_end(self, error=None) -> None:
        """End this thread's open command: wait for the other ranks'
        answers (raises RankFailed naming a rank that failed)."""
        cmd = self._calls.__dict__.pop("cmd", None)
        if cmd is not None:
            cmd.__exit__(None if error is None else type(error), error, None)

    def follow_call(self, shape, dtype) -> None:
        """A rank that follows: the leader's call on this rank's part (the
        scatter of its shard, the program, the gather of the parts); the
        assembled y is dropped."""
        with on_thread_stream(self.device):
            xs = self.collectives.scatter(None, shape, dtype)
            D.assemble_rows(self.program(self.arrays, xs))
            wait(self.device)

    # -- the paper's three phases (Fig. 4), individually timeable ---------

    def place(self, x) -> torch.Tensor:
        """Load phase: validate, pad and place x on the mesh's device (blocks).

        Args:
          x: (cols,) vector or (cols, B) batch (host array or tensor).

        Returns:
          The placed x, zero-padded to the plan's x width; on a process
          mesh this rank's shard of it.

        Raises:
          TypeError/ValueError: on dtype or length mismatches.
        """
        x = self._check_x(x, self.part.shape[1], self.part.dtype)
        if self.x_pad != x.shape[0]:
            pad = torch.zeros((self.x_pad - x.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad])
        if self.control is not None:
            return self._lead_place(x)
        with on_thread_stream(self.device):
            xs = self._shard(x).to(self.device).contiguous()
            wait(self.device)
        return xs

    def run_raw(self, xs: torch.Tensor) -> D.SpmvOutput:
        """Kernel phase: the per-part kernels and the merge (blocks).

        Args:
          xs: the placed x from :meth:`place`.

        Returns:
          The per-part output slices (:class:`SpmvOutput`, on the device).

        Raises:
          ExecutorReleased: if the executor was released.
        """
        arrays = self.arrays  # held until the wait: a release may race
        try:
            if arrays is None:
                raise ExecutorReleased("executor released or never placed; "
                                       "recompile")
            with on_thread_stream(self.device):
                out = self.program(arrays, xs)
                wait(self.device)
        except BaseException as e:
            self._lead_end(e)
            raise
        return out

    def assemble(self, raw: D.SpmvOutput) -> np.ndarray:
        """Retrieve phase: assemble the global rows and fetch them.

        Returns:
          The global y as a host ndarray (rows[, B]).
        """
        try:
            with on_thread_stream(self.device):
                y = to_host(D.assemble_rows(raw))
        except BaseException as e:
            self._lead_end(e)
            raise
        self._lead_end()
        return y

    # -- public surface ----------------------------------------------------

    def __call__(self, x) -> np.ndarray:
        """y = A @ x: place -> run_raw -> assemble (the three Fig.-4 phases).

        Args:
          x: (cols,) vector or (cols, B) batch.

        Returns:
          Host rows (rows[, B]).

        Raises:
          TypeError/ValueError: on dtype/shape mismatch.
          ExecutorReleased: if the executor was released.
        """
        return self.assemble(self.run_raw(self.place(x)))

    def batch(self, X) -> np.ndarray:
        """Y = A @ X as ONE partitioned SpMM (the batch rides through the same
        program; impl="cuda" runs one part-axis launch for all of it).

        Raises:
          ValueError: if X is not 2D (plus the __call__ errors).
        """
        if F.to_tensor(X).ndim != 2:
            raise ValueError(f"batch expects X of shape (cols, B); got "
                             f"{tuple(F.to_tensor(X).shape)}")
        return self(X)

    def warmup(self) -> None:
        """Run the vector-shaped program once, off the request path (on a
        led world the whole call: the other ranks run it whole)."""
        zeros = torch.zeros(self.part.shape[1], dtype=self.part.dtype)
        if self.control is not None:
            self(zeros)
        else:
            self.run_raw(self.place(zeros))

    def iterate(self, x0, steps=None, tol=None, combine="plain", *,
                b=None, diag=None, omega: float = 1.0,
                max_steps: int = 1000, check_every: int = 8) -> IterateResult:
        """:meth:`Executor.iterate`; on rank 0 of a led world the session
        is validated here, then sent to the other ranks whole (x0 and its
        parameters with it), and rank 0 decides each tol-mode test for
        every rank."""
        ctl = self.control
        if ctl is None:
            return super().iterate(x0, steps, tol, combine, b=b, diag=diag,
                                   omega=omega, max_steps=max_steps,
                                   check_every=check_every)
        kw = dict(steps=steps, tol=tol, combine=combine, b=b, diag=diag,
                  omega=omega, max_steps=max_steps, check_every=check_every)
        x0, _, params = check_iterate(self, x0, **kw)  # raises here alone
        args = dict(kw, wid=self.wid, x0=x0.cpu(),
                    b=params.get("b"), diag=params.get("diag"))

        def tell(go: bool) -> bool:
            ctl.tell(go)
            return go

        with ctl.lock:
            if self.arrays is None:
                raise ExecutorReleased("executor released; recompile")
            with ctl.command("iterate", args), on_thread_stream(self.device):
                result = run_iterate(self, self._iterate_apply(), x0, **kw,
                                     decide=tell)
            ctl.session_steps += result.steps
        return result

    # -- solver-loop backend ----------------------------------------------

    def _iterate_shape(self):
        rows, cols = self.part.shape
        return self._require_square(rows, cols), self.part.dtype

    def _iterate_apply(self):
        """y = A @ v entirely on the device: pad v to the plan's x width (as
        :meth:`place` does on the host), run the partitioned program, and
        assemble the global rows with :func:`D.assemble_rows` — the exact
        operations of ``exe(x)`` minus the host copies, so the recurrence
        stays bit-identical to the host loop."""
        arrays = self.arrays
        if arrays is None:
            raise ExecutorReleased("executor released or never placed; recompile")
        n, dtype = self._iterate_shape()
        x_pad, program = self.x_pad, self.program

        def apply(v):
            if x_pad != n:
                v = torch.cat([v, v.new_zeros(x_pad - n)])
            y = D.assemble_rows(program(arrays, self._shard(v)))
            return y.to(dtype) if y.dtype != dtype else y

        return apply

    def release(self) -> None:
        """Drop the placed matrix arrays (idempotent); recompile to reuse.
        On rank 0 of a led world the other ranks drop theirs with the next
        command."""
        ctl = self.control
        if ctl is None:
            self.arrays = None
            return
        with ctl.lock:  # never between a call's place and its assemble
            if self.arrays is not None:
                self.arrays = None
                ctl.release(self.wid)


def follower_handlers(world) -> dict:
    """The commands a rank that follows runs (``Control.follow``): the
    compile of a plan from its part (``api/plan.py``), a call and a
    session of an executor it holds."""
    from .plan import follow_compile

    ctl = world.control

    def call(_, args, part):
        ctl.executors[args["wid"]].follow_call(args["shape"], args["dtype"])

    def session(_, args, part):
        exe = ctl.executors[args.pop("wid")]
        x0 = args.pop("x0")
        with on_thread_stream(exe.device):
            result = run_iterate(exe, exe._iterate_apply(), x0, **args,
                                 decide=lambda go: ctl.hear())
        ctl.session_steps += result.steps

    return {"compile": lambda _, args, part: follow_compile(world, args, part),
            "call": call, "iterate": session}
