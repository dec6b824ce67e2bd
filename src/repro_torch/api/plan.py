"""ExecutionPlan — the inspectable middle of the pipeline.

Counterpart of ``repro/api/plan.py``.  ``SparseMatrix.plan(...)`` resolves
*what to run* (an adaptive :class:`~repro_torch.core.adaptive.Plan`:
partitioning, balancing scheme, format, merge, grid), fits it to the device
pool and returns an :class:`ExecutionPlan` that also pins *how to run it*
(impl, device or mesh, dtype) and the analytic time estimate.
``.compile()`` turns it into an :class:`~repro_torch.api.executor.Executor`:
a single-device one, or for a mesh plan a
:class:`~repro_torch.api.executor.MeshExecutor` over the partitioned matrix.

The plan IR (``to_ir`` / :func:`plan_from_ir`) is the JAX package's: the
wire keeps its impl names ("xla" / "pallas"), mapped to "torch" / "cuda"
at the boundary, so each package reads the other's JSON — the v2 "topo"
record (the axis assignment of a topology-placed plan) included.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import distributed as D
from ..core.adaptive import HardwareModel, Plan, select_scheme
from ..core.formats import dtype_name, torch_dtype
from ..core.mesh import AXES_2D, make_mesh
from ..core.partition import (BALANCE_1D, SCHEMES_2D, PartitionedMatrix,
                              partition_1d_coalesced, partition_2d_coalesced)
from ..core.stats import MatrixStats
from ..core.streams import wait
from ..kernels.ops import IMPLS
from .executor import Executor, MeshExecutor, SingleDeviceExecutor

__all__ = [
    "ExecutionPlan",
    "fit_plan",
    "resolve_scheme",
    "plan_from_ir",
    "plan_from_partitioned",
    "IR_VERSION",
    "FORMATS",
    "IMPLS",
]

FORMATS = ("coo", "csr", "bcoo", "bcsr")

# Plan-IR version of the JAX package; v1 payloads carry no "topo" key.
IR_VERSION = 2
_IR_READABLE = (1, 2)
_IMPL_TO_WIRE = {"torch": "xla", "cuda": "pallas"}
_IMPL_FROM_WIRE = {v: k for k, v in _IMPL_TO_WIRE.items()}


# ---------------------------------------------------------------------------
# scheme resolution + device fitting
# ---------------------------------------------------------------------------


def _plan_from_string(spec: str, n_devices: int, fmt: Optional[str],
                      merge: Optional[str]) -> Plan:
    """Parse "1d" / "1d.nnz" / "2d" / "2d.equally-sized" into a Plan."""
    head, _, tail = spec.partition(".")
    fmt = fmt or "coo"
    if head == "1d":
        balance = tail or "nnz"
        if balance not in BALANCE_1D:
            raise ValueError(f"unknown 1D balance {balance!r}; one of {BALANCE_1D}")
        return Plan("1d", balance, fmt, merge or "ppermute", (n_devices, 1),
                    f"user scheme {spec!r}")
    if head == "2d":
        scheme = tail or "equally-sized"
        if scheme not in SCHEMES_2D:
            raise ValueError(f"unknown 2D scheme {scheme!r}; one of {SCHEMES_2D}")
        default = "psum_scatter" if scheme == "equally-sized" else "global"
        return Plan("2d", scheme, fmt, merge or default, (), f"user scheme {spec!r}")
    raise ValueError(
        f"unknown scheme {spec!r}: expected 'auto', '1d[.balance]', "
        f"'2d[.scheme]' or an adaptive.Plan"
    )


def fit_plan(plan: Plan, shape: tuple, n_devices: int,
             block: Tuple[int, int], *, topology=None,
             dtype_bytes: int = 4) -> Plan:
    """Adapt a paper plan to the device pool + divisibility rules.

    The JAX package's rules: 2D equally-sized requires rows % R == 0 and
    cols % C == 0 (and psum_scatter additionally (rows/R) % C == 0, else
    psum); with no fitting factorization, fall back to the 1D element-
    balanced plan.  An empty ``plan.grid`` prefers near-square grids,
    unless a :class:`repro_torch.topo.DeviceTopology` is given: the fitting
    grids are then ranked by the modelled collective cost of each grid's
    *best* axis assignment, ties broken by near-squareness, then by R.
    """
    n = n_devices
    rows, cols = shape
    fmt = plan.fmt
    if fmt in ("bcoo", "bcsr") and not (
        rows % block[0] == 0 and cols % block[1] == 0
    ):
        fmt = "coo"  # block tiling must cover the matrix exactly
    if plan.partitioning == "1d":
        balance = plan.scheme if plan.scheme in BALANCE_1D else "nnz"
        if fmt in ("csr", "bcsr") and balance == "nnz":
            balance = "nnz-rgrn"
        return Plan("1d", balance, fmt, "ppermute", (n, 1), plan.reason)
    scheme = plan.scheme if plan.scheme in SCHEMES_2D else "equally-sized"
    want_c = plan.grid[1] if len(plan.grid) == 2 else None
    cands = sorted((r, n // r) for r in range(1, n + 1) if n % r == 0)
    if scheme == "equally-sized":
        fits = [(r, c) for r, c in cands if rows % r == 0 and cols % c == 0]
    elif scheme == "equally-wide":
        fits = [(r, c) for r, c in cands if cols % c == 0]
    else:  # variable-sized: no alignment constraints
        fits = cands
    if not fits:
        return Plan(
            "1d", "nnz", "coo" if fmt in ("csr", "coo") else "bcoo",
            "ppermute", (n, 1),
            plan.reason + " [2d grid unfit for shape; 1d fallback]",
        )

    def _norm_merge(r: int, c: int) -> str:
        if scheme == "equally-sized":
            valid = ("psum", "psum_scatter", "global")
            m = plan.merge if plan.merge in valid else "psum"
            if m == "psum_scatter" and (rows // r) % c != 0:
                m = "psum"
            return m
        return "global"  # unaligned rows can only merge via the paper path

    if want_c is not None:
        R, C = min(fits, key=lambda rc: abs(rc[1] - want_c))
    elif topology is not None:
        from ..topo import CollectiveCostModel

        model = CollectiveCostModel(topology)

        def _cost(rc):
            r, c = rc
            cand = Plan("2d", scheme, fmt, _norm_merge(r, c), (r, c),
                        plan.reason)
            best = model.best(cand, shape, dtype_bytes, AXES_2D)
            total = best[1]["total_s"] if best else float("inf")
            return (total, abs(r - c), r)

        R, C = min(fits, key=_cost)
    else:
        R, C = min(fits, key=lambda rc: abs(rc[0] - rc[1]))
    return Plan("2d", scheme, fmt, _norm_merge(R, C), (R, C), plan.reason)


def resolve_scheme(
    stats: MatrixStats,
    shape: tuple,
    n_devices: int,
    scheme="auto",
    *,
    hw: Optional[HardwareModel] = None,
    partitioning: Optional[str] = None,
    fmt: Optional[str] = None,
    merge: Optional[str] = None,
    grid: Optional[tuple] = None,
    block: Tuple[int, int] = (8, 16),
    fit: bool = True,
    topology=None,
    dtype_bytes: int = 4,
) -> Plan:
    """Turn "auto" / a scheme string / an adaptive.Plan into a fitted Plan.

    ``topology`` (a :class:`repro_torch.topo.DeviceTopology`) makes the 2D
    grid fitting collective-cost-aware — see :func:`fit_plan`.
    """
    hw = hw if hw is not None else HardwareModel(chips=max(1, n_devices))
    if isinstance(scheme, Plan):
        plan = scheme
    elif scheme == "auto":
        plan = select_scheme(stats, hw)
        if partitioning is not None and plan.partitioning != partitioning:
            if partitioning == "1d":
                plan = Plan("1d", "nnz", plan.fmt, "ppermute",
                            (n_devices, 1), "forced 1d")
            else:
                plan = Plan("2d", "equally-sized", plan.fmt, "psum_scatter",
                            plan.grid, "forced 2d")
    elif isinstance(scheme, str):
        plan = _plan_from_string(scheme, n_devices, fmt, merge)
    else:
        raise TypeError(f"scheme must be 'auto', a string or a Plan; got {scheme!r}")
    if fmt is not None:
        plan = replace(plan, fmt=fmt)
    if merge is not None:
        plan = replace(plan, merge=merge)
    if plan.fmt not in FORMATS:
        raise ValueError(f"unknown format {plan.fmt!r}; one of {FORMATS}")
    if grid is not None:
        plan = replace(plan, grid=tuple(grid))
    if fit:
        plan = fit_plan(plan, shape, n_devices, block, topology=topology,
                        dtype_bytes=dtype_bytes)
    return plan


def check_device(device) -> torch.device:
    """A torch.device; raises when a CUDA device is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


# ---------------------------------------------------------------------------
# ExecutionPlan
# ---------------------------------------------------------------------------


@dataclass
class ExecutionPlan:
    """Everything needed to compile one SpMV program, inspectable up front."""

    matrix: object  # repro_torch.api.matrix.SparseMatrix
    scheme: Plan  # fitted adaptive plan: partitioning/balance/fmt/merge/grid
    impl: str  # "torch" | "cuda"
    device: torch.device  # where it runs (a mesh plan: the mesh's device)
    dtype: torch.dtype
    block: Tuple[int, int] = (8, 16)
    hw: Optional[HardwareModel] = None
    estimate: dict = field(default_factory=dict)  # analytic Fig.-4 step times
    measured: dict = field(default_factory=dict)  # tuned metadata (plan IR)
    mesh: object = None  # repro_torch.core.mesh.Mesh; None => single device
    part: Optional[PartitionedMatrix] = None  # prebuilt partition (optional)
    ring: bool = False  # 1D ring schedule (requires a bucketed part)
    ring_counts: Optional[np.ndarray] = None
    # topology-aware placement metadata (repro_torch.topo; None = flat):
    # {"logical": [...], "physical": [[...], ...], "topology": name,
    #  "transfer": {"load_s", "merge_s", "total_s"}}
    topo_assignment: Optional[dict] = None

    # -- inspection --------------------------------------------------------

    @property
    def partitioning(self) -> str:
        return self.scheme.partitioning

    @property
    def fmt(self) -> str:
        return self.scheme.fmt

    @property
    def grid(self) -> tuple:
        return tuple(self.scheme.grid)

    @property
    def merge(self) -> str:
        return self.scheme.merge

    @property
    def is_distributed(self) -> bool:
        return self.mesh is not None

    @property
    def scheme_id(self) -> str:
        """Stable scheme identity (``partitioning.scheme.fmt.merge``, plus
        ``.ring`` for the ring schedule); part of the engine's plan-cache
        key.

        Topology-placed plans carry their axis assignment as an ``@`` suffix
        (e.g. ``...@rows=host,cols=bank``) so two placements of the same
        scheme never collide in plan caches or tuning records.
        """
        sid = self.scheme.tag + (".ring" if self.ring else "")
        if self.topo_assignment:
            phys = self.topo_assignment.get("physical") or ()
            logical = self.topo_assignment.get("logical") or ()
            sid += "@" + ",".join(
                f"{l}={'*'.join(g) if g else '-'}"
                for l, g in zip(logical, phys)
            )
        return sid

    def describe(self) -> str:
        """Human-readable one-plan summary (scheme, impl, device, reason,
        analytic Fig.-4 estimate, the axis assignment of a placed plan)."""
        s = self.scheme
        where = (f"mesh{tuple(self.mesh.devices.shape)}" if self.is_distributed
                 else "single-device")
        lines = [
            f"ExecutionPlan[{s.partitioning}.{s.scheme} fmt={s.fmt} "
            f"merge={s.merge} grid={tuple(s.grid)} impl={self.impl} "
            f"dtype={dtype_name(self.dtype)} {where}({self.device})]",
            f"  reason: {s.reason}",
        ]
        if self.estimate:
            est = ", ".join(f"{k}={v:.2e}" for k, v in self.estimate.items())
            lines.append(f"  model estimate: {est}")
        if self.topo_assignment:
            ta = self.topo_assignment
            axes = ", ".join(
                f"{l}->{'*'.join(g) if g else '-'}"
                for l, g in zip(ta.get("logical") or (),
                                ta.get("physical") or ())
            )
            line = f"  topo: {axes} on {ta.get('topology', '?')}"
            tr = ta.get("transfer") or {}
            if tr:
                line += (f" (load={tr.get('load_s', 0.0):.2e}s "
                         f"merge={tr.get('merge_s', 0.0):.2e}s)")
            lines.append(line)
        if self.measured:
            m = self.measured
            line = f"  measured: {m['mean_s']:.2e}s/call"
            if m.get("candidates"):
                line += f" over {m['candidates']} candidates"
            if m.get("from_cache"):
                line += " (TuningCache hit)"
            base = m.get("baseline_mean_s")
            if base is not None:
                line += (f"; analytic pick {m.get('baseline_scheme_id')} "
                         f"measured {base:.2e}s ({m.get('speedup', 1.0):.2f}x)")
            lines.append(line)
        return "\n".join(lines)

    # -- serialization (plan IR) -------------------------------------------

    def to_ir(self) -> dict:
        """Serialize everything needed to rebuild this plan elsewhere — in
        the JAX package's IR v2 layout, impl names on the wire as "xla" /
        "pallas".

        Raises:
          ValueError: for a plan carrying a prebuilt partition (``part``).
        """
        if self.part is not None:
            raise ValueError(
                "plans wrapping a prebuilt PartitionedMatrix (part=...) "
                "cannot be serialized; re-plan from the SparseMatrix instead")
        mesh_spec = None
        if self.is_distributed:
            mesh_spec = {"shape": [int(n) for n in self.mesh.devices.shape],
                         "axes": [str(a) for a in self.axes]}
        return {
            "ir_version": IR_VERSION,
            "scheme": {
                "partitioning": self.scheme.partitioning,
                "scheme": self.scheme.scheme,
                "fmt": self.scheme.fmt,
                "merge": self.scheme.merge,
                "grid": [int(g) for g in self.scheme.grid],
                "reason": self.scheme.reason,
            },
            "impl": _IMPL_TO_WIRE[self.impl],
            "dtype": dtype_name(self.dtype),
            "block": [int(b) for b in self.block],
            "interpret": self.device.type != "cuda",
            "ring": bool(self.ring),
            "ring_counts": (None if self.ring_counts is None
                            else np.asarray(self.ring_counts).tolist()),
            "mesh": mesh_spec,
            "estimate": {k: float(v) for k, v in self.estimate.items()},
            "measured": _jsonable(self.measured),
            "topo": _jsonable(self.topo_assignment),
        }

    # -- axes / specs ------------------------------------------------------

    @property
    def axes(self) -> tuple:
        return tuple(self.mesh.axis_names) if self.is_distributed else ()

    def _x_spec(self) -> tuple:
        """The mesh axis x is split over (the JAX package's PartitionSpec):
        the part axis for 1D, the column axis for 2D."""
        axes = self.axes
        return (axes[0],) if self.partitioning == "1d" else (axes[1],)

    def _x_pad(self, part: PartitionedMatrix) -> int:
        cols = part.shape[1]
        if self.partitioning == "1d":
            parts = part.n_parts
            return -(-cols // parts) * parts
        C = part.grid[1]
        # variable-sized tiles do not align with the uniform x shards: pad x
        # so the shards divide it (the aligned schemes require cols % C)
        return cols if self.scheme.scheme != "variable-sized" else -(-cols // C) * C

    # -- compilation -------------------------------------------------------

    def _partition(self) -> PartitionedMatrix:
        """Partition the matrix's coalesced triplets (never densified)."""
        if self.part is not None:
            return self.part
        ri, ci, vals = self.matrix.triplets(self.dtype)
        if self.partitioning == "1d":
            return partition_1d_coalesced(
                ri, ci, vals, self.matrix.shape, self.scheme.grid[0],
                fmt=self.fmt, balance=self.scheme.scheme, block=self.block)
        return partition_2d_coalesced(
            ri, ci, vals, self.matrix.shape, tuple(self.scheme.grid),
            fmt=self.fmt, scheme=self.scheme.scheme, block=self.block)

    def _program(self, part: PartitionedMatrix) -> D.PartitionedProgram:
        if self.partitioning == "1d":
            if self.ring:
                if self.ring_counts is None:
                    raise ValueError("ring plans need ring_counts "
                                     "(see distributed.bucket_by_source_shard)")
                if self.impl != "torch":
                    raise ValueError("the 1D ring schedule runs the torch local "
                                     "kernel only (impl='torch')")
                return D.spmv_1d_ring(part, self.ring_counts, self.mesh)
            return D.spmv_1d(part, self.mesh, impl=self.impl)
        return D.spmv_2d(part, self.mesh, merge=self.merge, impl=self.impl)

    def _kernel_extra(self, part: PartitionedMatrix) -> Optional[dict]:
        """Host arrays the CUDA kernels read, placed with the matrix: the
        stacked chunk plans (scalar formats) or the per-part block-row
        pointers (block formats)."""
        if self.impl != "cuda" or self.ring:
            return None
        if self.fmt in ("coo", "csr"):
            return D.kernel_chunk_arrays(part)
        return D.kernel_block_arrays(part)

    def program(self, part: Optional[PartitionedMatrix] = None
                ) -> D.PartitionedProgram:
        """Build the partitioned program WITHOUT placing the matrix.

        Raises:
          ValueError: for single-device plans (no partitioned program).
        """
        if not self.is_distributed:
            raise ValueError("single-device plans have no partitioned "
                             "program; call .compile() instead")
        return self._program(part if part is not None else self._partition())

    def compile(self) -> Executor:
        """Build and place everything a request needs, once.

        Single-device plans wrap the chosen container in a
        :class:`SingleDeviceExecutor` (for impl="cuda" the kernel program
        is built and placed here).  Mesh plans partition the matrix, build
        the program with the selected per-part kernel, place the matrix —
        plus, for impl="cuda", the kernels' chunk plans or block-row
        pointers — and return a :class:`MeshExecutor`.  Ends in one wait on
        the placing stream, so every thread's stream may read the placed
        arrays from the first request on.
        """
        if not self.is_distributed:
            container = self.matrix.container(self.fmt, block=self.block,
                                              dtype=self.dtype)
            exe = SingleDeviceExecutor(self, container, self.impl, self.device)
            wait(exe.device)
            return exe
        t0 = time.perf_counter()
        part = self._partition()
        axes = self.axes
        program = self._program(part)
        extra = self._kernel_extra(part)
        if self.partitioning == "1d":
            placed = D.place_1d(part, self.mesh, extra=extra)
        else:
            placed = D.place_2d(part, self.mesh, extra=extra)
        exe = MeshExecutor(
            self, part, self.mesh, axes, program, x_spec=self._x_spec(),
            x_pad=self._x_pad(part), merge=self.merge,
        ).place_matrix(placed)
        wait(exe.device)
        exe.build_seconds = time.perf_counter() - t0
        return exe


def plan_from_partitioned(part: PartitionedMatrix, mesh, *,
                          impl: str = "torch", merge: Optional[str] = None,
                          ring: bool = False,
                          ring_counts: Optional[np.ndarray] = None,
                          matrix=None) -> ExecutionPlan:
    """Wrap an already-partitioned matrix (e.g. a ring-bucketed one) in an
    ExecutionPlan so it flows through the same program-building path."""
    partitioning = "1d" if part.grid[1] == 1 else "2d"
    scheme_name = part.scheme.split(".", 1)[-1].replace("+ring", "")
    if merge is None:
        if partitioning == "1d":
            merge = "ppermute"
        else:
            merge = "psum" if scheme_name == "equally-sized" else "global"
    plan = Plan(partitioning, scheme_name, part.fmt, merge, tuple(part.grid),
                "prebuilt partition")
    return ExecutionPlan(
        matrix=matrix, scheme=plan, impl=impl, device=mesh.device,
        dtype=part.dtype, block=part.block, mesh=mesh, part=part, ring=ring,
        ring_counts=ring_counts)


def _jsonable(obj):
    """Deep-copy ``obj`` into plain JSON types; rejects anything else."""
    if obj is None or isinstance(obj, (str, bool, int)):
        return obj
    if isinstance(obj, float):
        return float(obj)
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    raise TypeError(f"not IR-serializable: {type(obj).__name__}: {obj!r}")


def plan_from_ir(ir: dict, matrix, *, device="cuda", devices=None,
                 mesh=None, hw: Optional[HardwareModel] = None,
                 topology=None) -> ExecutionPlan:
    """Rehydrate a ``to_ir()`` record (of either package) for ``device``.

    The fitted decision is taken verbatim (no re-fitting); ``interpret`` on
    the wire is ignored — ``device`` says where the plan runs.  A mesh
    record is laid out on ``mesh``, or on ``devices`` (default: ``device``
    at every place of the recorded grid).  A v2 record's "topo" axis
    assignment rides along either way (``scheme_id``, ``describe()`` and
    ``to_ir`` keep it); with ``topology`` (a
    :class:`repro_torch.topo.DeviceTopology` of this process) the mesh is
    also laid out in the recorded placement (``Mesh.slots``), as the
    reference re-realizes it.

    Raises:
      ValueError: unknown ``ir_version``, malformed record, unknown fmt or
        impl, or too few devices for the recorded mesh.
      NotImplementedError: ``devices`` name distinct devices.
      RuntimeError: ``device="cuda"`` without a CUDA device.
    """
    version = ir.get("ir_version")
    if version not in _IR_READABLE:
        raise ValueError(
            f"unknown plan-IR version {version!r} (this reader speaks "
            f"{_IR_READABLE}); re-export the plan with a matching writer"
        )
    try:
        s = ir["scheme"]
        plan = Plan(
            partitioning=s["partitioning"],
            scheme=s["scheme"],
            fmt=s["fmt"],
            merge=s["merge"],
            grid=tuple(int(g) for g in s["grid"]),
            reason=s.get("reason", "rehydrated from plan IR"),
        )
        wire_impl = ir["impl"]
        dtype = torch_dtype(ir["dtype"])
        block = tuple(int(b) for b in ir.get("block", (8, 16)))
        mesh_spec = ir.get("mesh")
        if mesh_spec is not None:
            mesh_shape = tuple(int(n) for n in mesh_spec["shape"])
            mesh_axes = tuple(str(a) for a in mesh_spec["axes"])
    except (KeyError, TypeError) as e:
        raise ValueError(f"malformed plan IR: {type(e).__name__}: {e}") from e
    if plan.fmt not in FORMATS:
        raise ValueError(f"plan IR carries unknown format {plan.fmt!r}")
    if wire_impl not in _IMPL_FROM_WIRE:
        raise ValueError(f"plan IR carries unknown impl {wire_impl!r}")
    topo_assignment = ir.get("topo") or None
    if mesh_spec is None:
        mesh = None
    elif mesh is None:
        n = int(np.prod(mesh_shape))
        devices = [device] * n if devices is None else list(devices)
        if topology is not None and topo_assignment is not None:
            from ..topo import build_mesh

            mesh, _ = build_mesh(
                topology, mesh_shape, mesh_axes, devices=devices[:n],
                assignment={k: topo_assignment[k]
                            for k in ("logical", "physical")},
            )
        else:
            mesh = make_mesh(mesh_shape, mesh_axes, devices)
    ring_counts = ir.get("ring_counts")
    return ExecutionPlan(
        matrix=matrix,
        scheme=plan,
        impl=_IMPL_FROM_WIRE[wire_impl],
        device=mesh.device if mesh is not None else check_device(device),
        dtype=dtype,
        block=block,
        hw=hw,
        estimate=dict(ir.get("estimate") or {}),
        measured=dict(ir.get("measured") or {}),
        mesh=mesh,
        ring=bool(ir.get("ring", False)),
        ring_counts=(None if ring_counts is None
                     else np.asarray(ring_counts, dtype=np.int64)),
        topo_assignment=topo_assignment,
    )
