"""Cases shared by tests/test_torch_engine.py, tests/test_torch_tune.py and
their JAX runner (tests/_torch_engine_runner.py): the serving engine and
the tuner on P = 4 parts.

Both processes build the same matrices and vectors from the same seeds.
Matrix values and x are integer-valued float32, so every answer is exact
and compares bit for bit; ``x_rand`` is random float32 (compared at 2e-4).
The matrices come from the port's generators, array for array the JAX
package's (tests/test_torch_tune.py), so the ranks of a world
(tests/_torch_engine_world_runner.py) import this module without JAX.
"""
import itertools

import numpy as np

from repro_torch.data.matrices import (block_matrix, regular_matrix,
                                       scale_free_matrix)

PARTS = 4
COLS = 128
BATCH = 4

# (matrix, partitioning, JAX impl)
CASES = [(m, part, "xla") for m in ("regular", "scale-free", "block")
         for part in ("1d", "2d")]
CASES += [("regular", "1d", "pallas"), ("block", "2d", "pallas")]
# the batcher case: vectors submitted to this engine name and flushed once
BATCHER = ("scale-free", "1d", 3)


# solver sessions on P = 4 parts (tests/test_torch_engine_world.py): the
# cases of tests/_torch_mesh_cases.py's solver_inputs, registered 1D and 2D
SESSIONS = [("plain", "1d"), ("plain", "2d"), ("power-tol", "1d"),
            ("power-tol", "2d")]

# tuning on P = 4 parts: candidate lists per (matrix, include_exotic,
# max_candidates), searched over both impls
TUNE_CASES = [(m, exotic, cap) for m in ("regular", "scale-free", "block")
              for exotic in (False, True) for cap in (16, 3)]
# 4-part plans a Measurer times under quadratic_clock: (matrix, scheme, B)
TUNE_MEASURE = [("regular", "1d.nnz", None), ("block", "2d.equally-sized", 3)]
# Tuner.tune with FakeMeasurer(seed=TUNE_SEED) on P = 4 parts, per matrix
TUNE_SEED = 5


def quadratic_clock():
    """A clock that reads k**2 at its k-th call: every difference depends
    on the order and the number of calls made before it."""
    ticks = itertools.count()
    return lambda: float(next(ticks)) ** 2


def case_key(case) -> str:
    return "|".join(str(v) for v in case)


def matrices() -> dict:
    """Integer-valued versions of tests/test_engine.py's matrices."""
    mats = {
        "regular": regular_matrix(96, COLS, 5, seed=1),
        "scale-free": scale_free_matrix(96, COLS, 600, seed=2),
        "block": block_matrix(96, COLS, block=(8, 16), block_density=0.2,
                              seed=3),
    }
    return {k: np.round(v * 2.0).astype(np.float32) for k, v in mats.items()}


def vectors() -> dict:
    rng = np.random.default_rng(11)
    return {
        "x": rng.integers(-3, 4, COLS).astype(np.float32),
        "X": rng.integers(-3, 4, (COLS, BATCH)).astype(np.float32),
        "x_rand": rng.standard_normal(COLS).astype(np.float32),
        "batcher": rng.integers(-3, 4, (BATCHER[2], COLS)).astype(np.float32),
    }


def case_id(matrix: str, part: str, impl: str) -> str:
    return f"{matrix}.{part}.{impl}"
