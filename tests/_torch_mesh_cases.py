"""Cases shared by tests/test_torch_mesh.py and its JAX runner
(tests/_torch_mesh_runner.py).  numpy only: both processes build the same
inputs from the same seeds.

Every scheme and merge the JAX package has, on P = 4 parts, in each of the
four formats somewhere.  Each plan runs on both impl pairs with
integer-valued float32 values (exact, so results compare bit for bit), and
with one more dtype on one impl pair, both in turn: bfloat16 or int8 (also
exact) or random float32 (compared at 2e-4).  Over the plans every extra
dtype meets every impl pair.
"""
import numpy as np

PARTS = 4
SHAPE = (96, 128)  # divides the (8, 16) block and every 4-part 2D grid
BLOCK = (8, 16)
BATCH = 3

# (name, scheme, fmt, merge, grid, ring); merge/grid None = the fitted default
PLANS = [
    ("1d-rows-coo", "1d.rows", "coo", None, None, False),
    ("1d-rgrn-coo", "1d.nnz-rgrn", "coo", None, None, False),
    ("1d-nnz-coo", "1d.nnz", "coo", None, None, False),
    ("1d-rows-csr", "1d.rows", "csr", None, None, False),
    ("1d-rgrn-csr", "1d.nnz-rgrn", "csr", None, None, False),
    ("1d-nnz-bcoo", "1d.nnz", "bcoo", None, None, False),
    ("1d-rgrn-bcoo", "1d.nnz-rgrn", "bcoo", None, None, False),
    ("1d-rows-bcsr", "1d.rows", "bcsr", None, None, False),
    ("2d-es-psum-coo", "2d.equally-sized", "coo", "psum", None, False),
    ("2d-es-scatter-coo", "2d.equally-sized", "coo", "psum_scatter", None, False),
    ("2d-es-global-coo", "2d.equally-sized", "coo", "global", None, False),
    ("2d-es-psum-csr", "2d.equally-sized", "csr", "psum", None, False),
    ("2d-es-scatter-bcoo", "2d.equally-sized", "bcoo", "psum_scatter", None,
     False),
    ("2d-es-scatter-1x4-coo", "2d.equally-sized", "coo", "psum_scatter",
     (1, 4), False),
    ("2d-ew-coo", "2d.equally-wide", "coo", None, None, False),
    ("2d-ew-bcsr", "2d.equally-wide", "bcsr", None, None, False),
    ("2d-vs-coo", "2d.variable-sized", "coo", None, None, False),
    ("2d-vs-csr", "2d.variable-sized", "csr", None, None, False),
    ("2d-vs-bcoo", "2d.variable-sized", "bcoo", None, None, False),
    ("ring-nnz-coo", "1d.nnz", "coo", None, None, True),
    ("ring-rows-coo", "1d.rows", "coo", None, None, True),
]
EXTRA_DTYPES = ("bf16", "i8", "rand")

# impl pairs: (port impl, JAX impl).  The ring runs the oracle only.
IMPLS = (("torch", "xla"), ("cuda", "pallas"))


def cases():
    """[(case id, plan tuple, dtype, (port impl, jax impl))]."""
    out = []
    for i, plan in enumerate(PLANS):
        impls = IMPLS[:1] if plan[5] else IMPLS  # the ring: oracle only
        runs = [(impl, "f32") for impl in impls]
        runs.append((impls[i % len(impls)], EXTRA_DTYPES[i % 3]))
        for impl, dtype in runs:
            out.append((f"{plan[0]}-{impl[0]}-{dtype}", plan, dtype, impl))
    return out


def matrix(dtype: str, seed: int = 3) -> np.ndarray:
    """A block-structured 96 x 128 matrix with two dense rows (so
    element-granular 1D parts split rows), float32 (int8 for "i8");
    integer-valued in {-2, -1, 1, 2} unless ``dtype == "rand"``."""
    rng = np.random.default_rng(seed)
    rows, cols = SHAPE
    r, c = BLOCK
    blocks = rng.random((rows // r, cols // c)) < 0.3
    mask = np.kron(blocks, np.ones(BLOCK, bool)) & (rng.random(SHAPE) < 0.6)
    mask[[21, 60]] = True
    if dtype == "rand":
        vals = rng.standard_normal(SHAPE)
    else:
        vals = rng.choice(np.array([-2, -1, 1, 2]), SHAPE)
    a = (mask * vals).astype(np.float32)
    return a.astype(np.int8) if dtype == "i8" else a


def vectors(dtype: str, seed: int = 4):
    """x (cols,) and X (cols, BATCH), in the matrix's numpy dtype family."""
    rng = np.random.default_rng(seed)
    cols = SHAPE[1]
    if dtype == "rand":
        x, X = rng.standard_normal(cols), rng.standard_normal((cols, BATCH))
    else:
        x, X = rng.integers(-2, 3, cols), rng.integers(-2, 3, (cols, BATCH))
    kind = np.int8 if dtype == "i8" else np.float32
    return x.astype(kind), X.astype(kind)


# plan IRs read across the packages: (name, scheme, fmt, port impl)
IR_PLANS = [
    ("ir-1d-nnz-coo", "1d.nnz", "coo", "cuda"),
    ("ir-2d-es-bcoo", "2d.equally-sized", "bcoo", "torch"),
    ("ir-2d-vs-csr", "2d.variable-sized", "csr", "cuda"),
]


# solver sessions on 4 parts: (case id, scheme, fmt, combine, impl pair).
# "power-tol" runs power iteration to tol=1e-6 on a PageRank matrix.
SOLVER_N = 64
SOLVER_STEPS = 5
SOLVER_CASES = [(f"solve-{fmt}-{part}-{impl[0]}", part, fmt, "plain", impl)
                for fmt in ("coo", "csr", "bcsr") for part in ("1d", "2d")
                for impl in IMPLS]
SOLVER_CASES += [
    ("solve-richardson-1d", "1d", "coo", "richardson", IMPLS[0]),
    ("solve-jacobi-2d", "2d", "csr", "jacobi", IMPLS[1]),
    ("solve-power-tol-1d", "1d", "coo", "power-tol", IMPLS[0]),
]


def solver_inputs(combine: str, seed: int = 5):
    """(a, x0, iterate kwargs) of a solver case.

    The linear combines run on a 64 x 64 matrix with 3 off-diagonal
    entries in {-1, 1} per row and a diagonal of 4 (row sums of |a| <= 7),
    from integer x0 and b: plain steps stay below 2^24, Richardson
    (omega = 1/4) and Jacobi (diagonal 4) stay dyadic, so every sum is
    exact and results compare bit for bit.  "power-tol" is the PageRank
    matrix of tests/_solver_runner.py."""
    from _solver_runner import pagerank_matrix

    n = SOLVER_N
    if combine == "power-tol":
        return (pagerank_matrix(n), np.full(n, 1.0 / n, np.float32),
                dict(tol=1e-6, combine="power", max_steps=200,
                     check_every=8))
    rng = np.random.default_rng(seed)
    a = 4.0 * np.eye(n, dtype=np.float32)
    for i in range(n):
        cols = rng.choice(np.delete(np.arange(n), i), 3, replace=False)
        a[i, cols] = rng.choice([-1.0, 1.0], 3)
    x0 = rng.integers(-2, 3, n).astype(np.float32)
    b = rng.integers(-3, 4, n).astype(np.float32)
    kw = {"plain": dict(),
          "richardson": dict(b=b, omega=0.25),
          "jacobi": dict(b=b, diag=np.diag(a).copy())}[combine]
    return a, x0, dict(steps=SOLVER_STEPS, combine=combine, **kw)


# The SpMV dry run (tests/test_torch_dryrun.py, case "dryrun" of the
# runner): synth_partition_1d's arrays at 2^12 rows on 8 parts, and its 1D
# and bucketed-ring programs at 2^10 rows on PARTS parts against x of
# dryrun_x.
DRYRUN_SYNTH = dict(rows=1 << 12, cols=1 << 12, nnz_per_row=16, parts=8)
DRYRUN_SPMV = dict(rows=1 << 10, cols=1 << 10, nnz_per_row=16, parts=PARTS)


def dryrun_x(seed: int = 6):
    """x (cols,) and X (cols, BATCH), random float32."""
    rng = np.random.default_rng(seed)
    n = DRYRUN_SPMV["cols"]
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal((n, BATCH)).astype(np.float32))
