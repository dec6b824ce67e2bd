"""Helpers shared by the tests that hold repro_torch against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; fields
are compared as numpy arrays (bfloat16 by its bits).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

BF16 = np.dtype(jnp.bfloat16)


def rand_sparse(m, n, density=0.1, dtype=np.float32, seed=0, integer=False):
    """Random sparse dense matrix (as tests/test_kernels.py:rand_sparse);
    ``integer=True`` makes float values integer-valued (exact SpMV)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((m, n)) < density
    if integer or np.issubdtype(np.dtype(dtype), np.integer):
        a = mask * rng.integers(-4, 5, (m, n))
    else:
        a = mask * rng.standard_normal((m, n))
    return a.astype(dtype)


def np_of(a) -> np.ndarray:
    """Tensor / jax array / ndarray -> ndarray; bfloat16 as its int16 bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == BF16 else a


def jax_fields(obj) -> dict:
    """Every field of a JAX dataclass (container or ChunkPlan) as numpy."""
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def assert_same_fields(port, jax_obj):
    """Array for array (and static field for static field) equality."""
    for name, want in jax_fields(jax_obj).items():
        got = getattr(port, name)
        if isinstance(got, torch.Tensor):
            assert got.dtype != torch.int64 or want.dtype == np.int64, name
            np.testing.assert_array_equal(np_of(got), np_of(want), err_msg=name)
            assert np_of(got).dtype == np_of(want).dtype, name
        else:
            assert np.asarray(got).tolist() == want.tolist(), name


def as_f32(a) -> np.ndarray:
    """Any result (bf16 included) as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)
