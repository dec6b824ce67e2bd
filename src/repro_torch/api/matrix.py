"""SparseMatrix — the single front door of the SpMV pipeline.

Counterpart of ``repro/api/matrix.py``:

    sm  = SparseMatrix.from_parts(rowind, colind, values, shape)
    pln = sm.plan(scheme="auto")          # ExecutionPlan (impl="cuda", device="cuda")
    exe = pln.compile()                   # Executor
    y   = exe(x)                          # host rows

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); ``device="cuda"`` without a card raises.  The JAX
package densifies before it builds a format; here a matrix given as
triplets (or as a container) never is: its containers come from the
coalesced triplets (``formats.triplets_to_*``), which give the same arrays.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import formats as F
from ..core.adaptive import HardwareModel, Plan, estimate_time
from ..core.mesh import AXES_2D, AXIS_1D, make_mesh, same_device, world_mesh
from ..core.stats import MatrixStats, compute_stats
from .plan import IMPLS, ExecutionPlan, check_device, resolve_scheme

__all__ = ["SparseMatrix", "fingerprint_matrix"]

_CONTAINERS = (F.CSR, F.COO, F.BCSR, F.BCOO)
_FMT_OF = {F.CSR: "csr", F.COO: "coo", F.BCSR: "bcsr", F.BCOO: "bcoo"}


def _dtype_str(dtype: torch.dtype) -> str:
    """numpy's ``dtype.str`` ("<f4", ...); bfloat16 is ml_dtypes' "<V2"."""
    if dtype == torch.bfloat16:
        return "<V2"
    return np.dtype(F.dtype_name(dtype)).str


def _fingerprint(shape, dtype, ri, ci, vals) -> str:
    h = hashlib.sha256()
    h.update(repr((tuple(shape), _dtype_str(dtype))).encode())
    h.update(ri.to(torch.int64).numpy().tobytes())
    h.update(ci.to(torch.int64).numpy().tobytes())
    if vals.dtype == torch.bfloat16:
        vals = vals.view(torch.int16)
    h.update(vals.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def fingerprint_matrix(a) -> str:
    """Stable content hash of a dense matrix's sparsity structure + values
    (the JAX package's hash of the same matrix)."""
    t = F.to_tensor(a)
    ri, ci = (t != 0).nonzero(as_tuple=True)
    return _fingerprint(t.shape, t.dtype, ri, ci, t[ri, ci])


class SparseMatrix:
    """A sparse matrix plus its stats, behind every SpMV entry point."""

    def __init__(self, *, dense=None, triplets=None, container=None,
                 shape: Tuple[int, int] = None, dtype=None,
                 stats_block: Tuple[int, int] = (8, 16)):
        if dense is None and triplets is None and container is None:
            raise ValueError("SparseMatrix needs a dense array, triplets or "
                             "a container; use the from_* constructors")
        self._dense = dense
        self._triplets = triplets  # (rowind, colind, values), as given
        self._containers: dict = {}
        if container is not None:
            self._containers[_FMT_OF[type(container)]] = container.to("cpu")
        self.shape = tuple(shape)
        self.dtype = F.torch_dtype(dtype)
        self._stats_block = stats_block
        self._stats: Optional[MatrixStats] = None
        self._fingerprint: Optional[str] = None
        self._coalesced = None

    # ------------------------------------------------------------ constructors

    @classmethod
    def from_dense(cls, a, dtype=None,
                   stats_block: Tuple[int, int] = (8, 16)) -> "SparseMatrix":
        """Wrap a dense host array (numpy or torch).

        Raises:
          ValueError: if ``a`` is not 2D.
        """
        a = F.to_tensor(a, dtype).cpu()
        if a.ndim != 2:
            raise ValueError(f"expected a 2D matrix, got shape {tuple(a.shape)}")
        return cls(dense=a, shape=a.shape, dtype=a.dtype, stats_block=stats_block)

    @classmethod
    def from_scipy(cls, m, dtype=None) -> "SparseMatrix":
        """Wrap anything with scipy.sparse's ``tocoo()`` protocol.

        Raises:
          TypeError: if ``m`` has no ``tocoo`` method.
        """
        if not hasattr(m, "tocoo"):
            raise TypeError(f"{type(m).__name__} has no .tocoo(); "
                            "expected a scipy.sparse matrix")
        coo = m.tocoo()
        return cls.from_parts(coo.row, coo.col, coo.data, coo.shape, dtype=dtype)

    @classmethod
    def from_parts(cls, rowind, colind, values, shape,
                   dtype=None) -> "SparseMatrix":
        """Wrap raw COO triplets (duplicate coordinates are summed).

        Never densified: containers are built from the coalesced triplets.

        Raises:
          ValueError: on length mismatches or out-of-range indices.
        """
        rowind = F.to_tensor(rowind).to(torch.int64).reshape(-1).cpu()
        colind = F.to_tensor(colind).to(torch.int64).reshape(-1).cpu()
        values = F.to_tensor(values, dtype).reshape(-1).cpu()
        if not (len(rowind) == len(colind) == len(values)):
            raise ValueError("rowind/colind/values lengths differ")
        rows, cols = shape
        if len(rowind) and (int(rowind.min()) < 0 or int(rowind.max()) >= rows
                            or int(colind.min()) < 0 or int(colind.max()) >= cols):
            raise ValueError(f"indices out of range for shape {tuple(shape)}")
        return cls(triplets=(rowind, colind, values), shape=(rows, cols),
                   dtype=values.dtype)

    @classmethod
    def from_format(cls, container) -> "SparseMatrix":
        """Wrap an existing CSR/COO/BCSR/BCOO container (kept and reused
        when a plan requests the same format).

        Raises:
          TypeError: for any other container type.
        """
        if not isinstance(container, _CONTAINERS):
            raise TypeError(f"unknown container {type(container).__name__}")
        return cls(container=container, shape=container.shape,
                   dtype=container.dtype)

    # ------------------------------------------------------------ inspection

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    def coalesced(self):
        """Sorted, duplicate-free, zero-free (rowind, colind, values) — the
        nonzeros of the matrix in the matrix dtype (cached)."""
        if self._coalesced is None:
            if self._dense is not None:
                ri, ci, vals, _ = F.nonzero(self._dense)
            else:
                src = (self._triplets if self._triplets is not None else
                       F.to_triplets(next(iter(self._containers.values()))))
                ri, ci, vals = F.coalesce(*src, self.shape)
            self._coalesced = (ri, ci, vals)
        return self._coalesced

    def dense(self) -> torch.Tensor:
        """Materialize (and cache) the dense host tensor (small matrices)."""
        if self._dense is None:
            ri, ci, vals = self.coalesced()
            a = torch.zeros(self.shape, dtype=self.dtype)
            a[ri, ci] = vals
            self._dense = a
        return self._dense

    @property
    def stats(self) -> MatrixStats:
        """Paper Table-4 statistics (drives the adaptive scheme selection)."""
        if self._stats is None:
            # as in the JAX package: raw triplets when the matrix holds them
            ri, ci, _ = (self._triplets if self._dense is None
                         and self._triplets is not None else self.coalesced())
            self._stats = compute_stats((ri.numpy(), ci.numpy(), self.shape),
                                        block=self._stats_block)
        return self._stats

    @property
    def nnz(self) -> int:
        return self.stats.nnz

    def fingerprint(self) -> str:
        """Content hash (the JAX package's hash of the same matrix)."""
        if self._fingerprint is None:
            self._fingerprint = _fingerprint(self.shape, self.dtype,
                                             *self.coalesced())
        return self._fingerprint

    def triplets(self, dtype=None):
        """The coalesced triplets in ``dtype`` (default: the matrix dtype),
        entries that became zero in the cast dropped — the nonzeros of the
        cast matrix, sorted by (row, col)."""
        dtype = self.dtype if dtype is None else F.torch_dtype(dtype)
        ri, ci, vals = self.coalesced()
        if vals.dtype != dtype:  # cast, then drop what became zero
            vals = vals.to(dtype)
            keep = vals != 0
            ri, ci, vals = ri[keep], ci[keep], vals[keep]
        return ri, ci, vals

    def container(self, fmt: str, block: Tuple[int, int] = (8, 16),
                  dtype=None):
        """Build (and cache) the requested container format, on the host.

        Args:
          fmt: "csr" | "coo" | "bcsr" | "bcoo".
          block: (r, c) tile shape for the block formats.
          dtype: value dtype of the built container (default: matrix dtype).

        Raises:
          ValueError: for an unknown ``fmt``.
        """
        if fmt not in _FMT_OF.values():
            raise ValueError(f"unknown format {fmt!r}")
        dtype = self.dtype if dtype is None else F.torch_dtype(dtype)
        key = fmt if dtype == self.dtype else f"{fmt}:{F.dtype_name(dtype)}"
        got = self._containers.get(key)
        if got is not None and (fmt not in ("bcsr", "bcoo")
                                or got.block == tuple(block)):
            return got
        built = F.from_coalesced(fmt, *self.triplets(dtype), self.shape,
                                 tuple(block))
        self._containers[key] = built
        return built

    def __repr__(self) -> str:
        return (f"SparseMatrix({self.rows}x{self.cols}, nnz={self.nnz}, "
                f"dtype={F.dtype_name(self.dtype)})")

    # ------------------------------------------------------------ planning

    def plan(
        self,
        *,
        scheme="auto",
        impl: str = "cuda",
        device="cuda",
        hw: Optional[HardwareModel] = None,
        mesh=None,
        devices=None,
        partitioning: Optional[str] = None,
        fmt: Optional[str] = None,
        merge: Optional[str] = None,
        grid: Optional[tuple] = None,
        block: Tuple[int, int] = (8, 16),
        fit: bool = True,
        tuner=None,
        tune_cache=None,
        batch: Optional[int] = None,
        topology=None,
        assignment=None,
        world=None,
    ) -> ExecutionPlan:
        """Resolve scheme + placement into an inspectable ExecutionPlan.

        Args:
          scheme: "auto" (paper Rec. #3 rules fitted to the device pool),
            "tune" (measure candidates with :mod:`repro_torch.tune` on the
            device and return the fastest), a string like "1d.nnz" /
            "2d.equally-sized", or an adaptive.Plan.
          impl: "cuda" (the hand-written kernels; on a CPU device their
            plain versions) or "torch" (the plain oracles).
          device: "cuda" (default) or "cpu", for a single-device plan.
          hw: HardwareModel driving the analytic selection/estimates.
          mesh: a :class:`~repro_torch.core.mesh.Mesh` to partition over;
            the fitted plan must lay out on its shape.
          devices: a pool of P devices, all the same one (e.g.
            ``["cuda"] * 16``): the plan is fitted to P parts and a mesh of
            the fitted grid is built on them.  ``device`` is then unused.
          world: a :class:`repro_torch.core.world.World` of P ranks, one
            part each: the plan is fitted to P parts and laid on the
            world's process mesh of the fitted grid
            (``core.mesh.world_mesh``: made collectively the first time,
            so every rank calls ``plan`` then; on a world that rank 0 leads,
            only rank 0 calls it, on the meshes the engine made).  Only
            ``world=`` makes a process mesh: ``devices=`` never does,
            whatever it names.
          partitioning: force "1d"/"2d" over the adaptive choice.
          fmt/merge/grid: override single dimensions of the resolved scheme.
          block: (r, c) tile for the block formats.
          fit: False inspects the paper plan for ``hw`` as-is.
          tuner: ``scheme="tune"`` only — a :class:`repro_torch.tune.Tuner`
            override (bring your own generator/measurer/cache); the default
            tuner measures the candidates of the requested ``impl`` with an
            in-memory cache.
          tune_cache: ``scheme="tune"`` only — a
            :class:`repro_torch.tune.TuningCache` (or a path for one) so
            winners persist across processes; ignored when ``tuner`` is given.
          batch: ``scheme="tune"`` only — representative SpMM width B the
            candidates are measured at (part of the tuning-cache key).
          topology: a :class:`repro_torch.topo.DeviceTopology` describing
            the physical axes behind the pool.  2D grid fitting then ranks
            factorizations by modelled collective cost, the mesh is laid out
            in the device order of the cheapest axis assignment
            (``Mesh.slots``), and the plan records it (``topo_assignment``,
            ``scheme_id``'s ``@`` suffix, ``describe()``, plan IR v2).  When
            neither ``mesh`` nor ``devices`` is given, the topology's own
            devices are the pool.  On one card the placement changes no
            answer and no launch.
          assignment: force a specific axis assignment (an
            :class:`repro_torch.topo.AxisAssignment` or its dict form)
            instead of the model's pick — how the tuner measures one
            candidate per assignment.  Requires ``topology``.

        Raises:
          ValueError: unknown impl or scheme, more than one of mesh=,
            devices= and world=, a mesh whose shape the fitted plan cannot
            lay out on,
            ``scheme="tune"`` with partitioning/fmt/merge/grid forced,
            ``assignment`` without ``topology``, or an abstract topology
            without ``devices``.
          RuntimeError: a CUDA device is asked for and none is present.
          NotImplementedError: ``devices`` that name distinct devices (one
            process cannot drive them: pass ``world=``), or ``topology=``
            with ``world=`` (multi-card meshes, ROADMAP.md).
        """
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}: one of {IMPLS}")
        if sum(v is not None for v in (mesh, devices, world)) > 1:
            raise ValueError("pass one of mesh=, devices= and world=, not "
                             "both")
        if world is not None and topology is not None:
            raise NotImplementedError(
                "topology= over a world's ranks is a later step of "
                "ROADMAP.md's 'Multi-card meshes'")
        if assignment is not None and topology is None:
            raise ValueError("assignment= requires topology=")
        if topology is not None and mesh is None and devices is None:
            # a topology with a bound device grid implies the pool
            devices = topology.flat_devices()
            if devices is None:
                raise ValueError(
                    "topology= is abstract (no devices); pass devices= too"
                )
        if scheme == "tune":
            # measure-and-refine: delegate to repro_torch.tune (lazy import:
            # the tuner itself plans through this very method)
            overrides = dict(partitioning=partitioning, fmt=fmt, merge=merge,
                             grid=grid)
            forced = [k for k, v in overrides.items() if v is not None]
            if forced:
                raise ValueError(
                    f"scheme='tune' searches {forced} itself; either drop "
                    "the override or constrain the search with a custom "
                    "tuner= (repro_torch.tune.Tuner / CandidateGenerator)"
                )
            from ..tune import CandidateGenerator, Tuner, TuningCache

            if tuner is None:
                cache = tune_cache
                if cache is not None and not isinstance(cache, TuningCache):
                    cache = TuningCache(path=cache)
                tuner = Tuner(
                    generator=CandidateGenerator(impls=(impl,)), cache=cache
                )
            return tuner.tune(
                self, device=device, devices=devices, mesh=mesh, block=block,
                hw=hw, batch=batch, topology=topology, world=world,
            ).best
        distributed = mesh is not None or devices is not None \
            or world is not None
        if mesh is not None:
            mesh_shape = tuple(mesh.devices.shape)
            n_devices = int(np.prod(mesh_shape))
            if grid is None and len(mesh_shape) == 2 \
                    and not isinstance(scheme, Plan):
                grid = mesh_shape  # prefer grids that match the given mesh
        elif devices is not None:
            devices = list(devices)
            n_devices = len(devices)
            same_device(devices)  # fail before any planning work
        elif world is not None:
            n_devices = world.size
        else:
            n_devices = 1
            device = check_device(device)
        plan = resolve_scheme(
            self.stats, self.shape, n_devices, scheme, hw=hw,
            partitioning=partitioning, fmt=fmt, merge=merge, grid=grid,
            block=block, fit=fit, topology=topology,
            dtype_bytes=self.dtype.itemsize,
        )
        if mesh is not None:
            want = ((plan.grid[0],) if plan.partitioning == "1d"
                    else tuple(plan.grid))
            if mesh_shape != want:
                raise ValueError(
                    f"mesh shape {mesh_shape} does not match the "
                    f"{plan.partitioning} plan grid {tuple(plan.grid)}; "
                    "pass grid=/scheme= that fits the mesh, or use devices= "
                    "and let plan() build the mesh")
        topo_assignment = None
        if mesh is None and distributed:
            mesh_shape = ((plan.grid[0],) if plan.partitioning == "1d"
                          else tuple(plan.grid))
            axes = (AXIS_1D,) if plan.partitioning == "1d" else AXES_2D
            if world is not None:
                mesh = world_mesh(world, mesh_shape, axes)
                if mesh.devices.size != world.size:  # fit_plan's contract
                    raise AssertionError(
                        f"a {mesh_shape} grid on a world of {world.size}")
            elif topology is not None:
                mesh, topo_assignment = self._place(
                    plan, mesh_shape, axes, devices, topology, assignment)
            else:
                mesh = make_mesh(mesh_shape, axes, devices)
        hw = hw if hw is not None else HardwareModel(chips=max(1, n_devices))
        # an unfitted 2D plan (fit=False) may carry no grid yet: no estimate
        est = (estimate_time(self.stats, plan, hw, dtype_bytes=self.dtype.itemsize)
               if len(plan.grid) == 2 else {})
        if topo_assignment is not None:
            # the topology-priced transfer split beside the Fig.-4 numbers
            est = dict(est)
            est["topo_load_s"] = topo_assignment["transfer"]["load_s"]
            est["topo_merge_s"] = topo_assignment["transfer"]["merge_s"]
        return ExecutionPlan(
            matrix=self, scheme=plan, impl=impl,
            device=mesh.device if distributed else device, dtype=self.dtype,
            block=tuple(block), hw=hw, estimate=est, mesh=mesh,
            topo_assignment=topo_assignment,
        )

    def _place(self, plan: Plan, mesh_shape: tuple, axes: tuple, devices,
               topology, assignment) -> tuple:
        """(mesh, topo_assignment record or None): the mesh of ``plan``
        laid out by ``topology`` — in ``assignment``'s device order, or the
        cost model's cheapest — and the record of the placement."""
        from .. import topo as _topo

        n = int(np.prod(mesh_shape))
        dtype_bytes = self.dtype.itemsize
        model = _topo.CollectiveCostModel(topology)
        chosen, price = assignment, None
        if chosen is None:
            best = model.best(plan, self.shape, dtype_bytes, axes)
            if best is not None:
                chosen, price = best
        mesh, chosen = _topo.build_mesh(topology, mesh_shape, axes,
                                        assignment=chosen, devices=devices[:n])
        if chosen is None:
            return mesh, None
        if price is None:
            price = model.price(plan, self.shape, dtype_bytes, chosen)
        return mesh, {**chosen.to_dict(), "topology": topology.name,
                      "transfer": {k: float(v) for k, v in price.items()}}

    def compile(self, **plan_kwargs):
        """Shorthand: ``.plan(**plan_kwargs).compile()``."""
        return self.plan(**plan_kwargs).compile()
