"""The engine, its batcher, tuner, sessions and the service over a world of
ranks (``SpmvEngine(world=)``), against the JAX engine on 4 fake devices.

One gloo world of 4 CPU ranks runs every scenario of
tests/_torch_engine_world_runner.py (which imports no JAX): rank 0 leads
each engine, the other ranks follow it.  Beside it the JAX engine runs the
same cases on 4 fake devices in a subprocess (tests/_torch_engine_runner.py
``--world``).  Integer-valued answers compare bit for bit, ``x_rand`` at
2e-4, the power sessions at 1e-5; plan keys, fitted plans, the
FakeMeasurer's winners and step counts compare exactly.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as D
from repro_torch.core.control import Control
from repro_torch.core.mesh import same_device
from repro_torch.core.partition import partition_1d_coalesced
from repro_torch.core.world import World, spawn
from repro_torch.engine import SpmvEngine
from repro_torch.tune.cache import topology_key

import _torch_engine_world_runner as R
from _torch_engine_cases import (BATCHER, CASES, PARTS, SESSIONS, case_id,
                                 matrices)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
WORLD_CASES = [(c, impl) for c in CASES for impl in R.port_impls(c[2])]
TO_JAX = {"torch": "xla", "cuda": "pallas"}


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX's results, every rank's results): the JAX runner's subprocess
    runs while the world does."""
    out = tmp_path_factory.mktemp("engine_world") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_engine_runner.py"),
         str(out), "--world"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    try:
        ranks = spawn(R.engine_world, PARTS, "gloo", device="cpu",
                      timeout=TIMEOUT_S)
    finally:
        stdout, stderr = proc.communicate(timeout=300)
    if proc.returncode != 0:
        pytest.fail(f"engine runner crashed:\n{stderr[-3000:]}")
    if "ENGINE SKIP" in stdout:
        pytest.skip("forcing 4 fake JAX devices failed")
    with np.load(out) as z:
        return dict(z), ranks


def _json(v):
    import json

    return json.loads(str(v))


@pytest.mark.parametrize("case,impl", WORLD_CASES,
                         ids=[f"{R.case_name(c, i)}" for c, i in WORLD_CASES])
def test_world_engine_matches_jax_on_4_ranks(sides, case, impl):
    jax_side, ranks = sides
    got = ranks[0]
    cid, name = case_id(*case), R.case_name(case, impl)
    want_key = _json(jax_side[f"{cid}|key"])
    key = got[f"parity|{name}|key"]
    assert [key[0], list(key[1]), key[2], key[3]] == want_key[:4]
    if TO_JAX[impl] == case[2]:
        assert TO_JAX[key[4]] == want_key[4]
    assert got[f"parity|{name}|plan"] == _json(jax_side[f"{cid}|plan"])
    assert got[f"parity|{name}|process"]  # world= is a process mesh, always
    for v in ("x", "X"):
        np.testing.assert_array_equal(got[f"parity|{name}|{v}"],
                                      jax_side[f"{cid}|{v}"])
    np.testing.assert_allclose(got[f"parity|{name}|x_rand"],
                               jax_side[f"{cid}|x_rand"], rtol=2e-4, atol=2e-4)


def test_world_batcher_matches_jax(sides):
    jax_side, ranks = sides
    got = ranks[0]
    assert got["parity|batcher|flushed"] == BATCHER[2]
    assert got["parity|batcher|runs"] == (1, BATCHER[2])
    np.testing.assert_array_equal(got["parity|batcher|y"], jax_side["batcher|y"])


@pytest.mark.parametrize("combine,part", SESSIONS,
                         ids=[f"{c}-{p}" for c, p in SESSIONS])
def test_world_sessions_match_jax(sides, combine, part):
    """Every rank ran rank 0's number of steps (a rank one chunk off would
    have left the world waiting); the answer is JAX's."""
    jax_side, ranks = sides
    name = f"session.{combine}.{part}"
    got = ranks[0]
    assert got[f"parity|{name}|steps"] == int(jax_side[f"{name}|steps"])
    assert got[f"parity|{name}|converged"] == bool(jax_side[f"{name}|converged"])
    if combine == "plain":
        np.testing.assert_array_equal(got[f"parity|{name}|x"],
                                      jax_side[f"{name}|x"])
    else:
        np.testing.assert_allclose(got[f"parity|{name}|x"],
                                   jax_side[f"{name}|x"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("matrix", ["regular", "scale-free", "block"])
def test_world_tuner_matches_jax(sides, matrix):
    jax_side, ranks = sides
    got = ranks[0]
    assert got[f"parity|tuner|{matrix}"] == _json(jax_side[f"tuner|{matrix}"])
    assert got[f"parity|tuner|{matrix}|topology"] == f"cpu:{PARTS}/ranks"
    assert got[f"parity|tuner|{matrix}|process"]


def test_world_refinements_swap_and_answer(sides):
    jax_side, ranks = sides
    got = ranks[0]
    want = jax_side[f"{case_id('regular', '2d', 'xla')}|x"]
    fake = got["parity|refine|fake"]
    assert fake["swapped"] and fake["winner"] == "1d.nnz-rgrn.csr.ppermute"
    np.testing.assert_array_equal(got["parity|refine|fake|x"], want)
    real = got["parity|refine|real"]
    assert real["candidates"] >= 2 and not real["from_cache"]
    assert got["parity|refine|real|process"]
    np.testing.assert_array_equal(got["parity|refine|real|x"], want)


def test_world_validation_raises_on_the_leader_alone(sides):
    _, ranks = sides
    got = ranks[0]
    assert got["parity|validation"] == {
        "unknown name": "KeyError", "short x": "ValueError",
        "unsafe dtype": "TypeError", "bad impl": "ValueError",
        "non-square session": "ValueError", "lambda combine": "AttributeError"}
    np.testing.assert_array_equal(got["parity|int8|y"], got["parity|int8|want"])
    np.testing.assert_array_equal(got["parity|validation|x"],
                                  got[f"parity|{R.case_name(CASES[0], 'cuda')}|x"])


def test_world_fault_names_the_rank_and_the_world_carries_on(sides):
    _, ranks = sides
    got = ranks[0]
    assert got["parity|fault"] is not None
    assert f"rank {R.FAULT_RANK} of {PARTS} failed" in got["parity|fault"]
    assert "injected fault" in got["parity|fault"]
    assert got["parity|fault|s"] < 30
    assert not got["parity|fault|registered"]
    np.testing.assert_array_equal(got["parity|fault|x"],
                                  got[f"parity|{R.case_name(CASES[0], 'cuda')}|x"])
    # what the fault's rank could not build, the others dropped
    assert got["parity|placed|followers"] == {
        r: got["parity|placed|leader"] for r in range(1, PARTS)}


def test_world_service_equals_one_process_engine(sides):
    _, ranks = sides
    got = ranks[0]
    assert got["parity|ref|process"] is False  # devices= stays one process
    assert len(got["parity|serve|equal"]) == R.SERVE_REQUESTS
    assert all(got["parity|serve|equal"])
    assert (got["parity|serve|served"], got["parity|serve|errors"]) == (
        R.SERVE_REQUESTS, 0)
    assert got["parity|serve|closed"]  # the service closed the engine


def test_world_eviction_is_mirrored_on_every_rank(sides):
    _, ranks = sides
    got = ranks[0]
    assert got["eviction|evicted"]
    for when in ("after_register", "after_reactivate"):
        leader, followers = got[f"eviction|{when}"]
        assert leader == 2 and followers == {r: 2 for r in range(1, PARTS)}
    assert got["eviction|evictions"] == 2
    np.testing.assert_array_equal(got["eviction|reactivated|x"],
                                  got["eviction|reactivated|want"])


def test_followers_are_released_holding_nothing(sides):
    _, ranks = sides
    counts = {r["parity|commands"] for r in ranks[1:]}
    assert len(counts) == 1 and counts.pop() > len(WORLD_CASES)
    for r in ranks[1:]:
        assert r["parity|left"] == 0 and r["eviction|left"] == 0


def test_world_late_answer_breaks_the_world_and_releases_every_rank(sides):
    """Rank LATE_RANK answers a compile after rank 0's timeout: rank 0
    raises RankFailed naming it within the timeout, the world is out of
    step (its late answer is never read as another command's), the next
    call raises at once, and every follower leaves follow() holding
    nothing."""
    _, ranks = sides
    got = ranks[0]
    assert f"rank {R.LATE_RANK} of {PARTS} failed in 'compile'" in got["late|raised"]
    assert "no answer to 'compile'" in got["late|raised"]
    assert got["late|s"] < R.LATE_S
    assert "did not answer 'compile'" in got["late|broken"]
    assert "out of step" in got["late|next"]
    for r in ranks[1:]:
        assert "lost rank 0's control channel" in r["late|lost"]
        assert r["late|left"] == 0


@pytest.mark.parametrize("kind", ["gloo", "shm", "shm-rounds"])
def test_scatter_gives_each_rank_its_piece(sides, kind):
    """The load step of a led call: rank 0's piece r lands on rank r, and
    each rank counts the bytes it received under ``"scatter"``."""
    _, ranks = sides
    for r, res in enumerate(ranks):
        want = np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r
        np.testing.assert_array_equal(res[f"scatter|{kind}"], want)
        assert res[f"scatter|{kind}|bytes"] == want.nbytes


# ---------------------------------------------------------------- no world


def _dry_world(n=PARTS):
    return World("dry", 0, n, torch.device("cpu"))


def test_world_excludes_devices_topology_and_a_dry_world():
    with pytest.raises(ValueError, match="not both"):
        SpmvEngine(devices=["cpu"] * PARTS, world=_dry_world())
    with pytest.raises(NotImplementedError, match="Multi-card"):
        SpmvEngine(world=_dry_world(), topology=object())
    with pytest.raises(ValueError, match="no control channel"):
        SpmvEngine(world=_dry_world())
    from repro_torch.api import SparseMatrix

    sm = SparseMatrix.from_dense(matrices()["regular"])
    with pytest.raises(ValueError, match="one of mesh=, devices= and world="):
        sm.plan(devices=["cpu"] * PARTS, world=_dry_world())


def test_same_device_names_world_and_multi_card():
    with pytest.raises(NotImplementedError, match="world=") as e:
        same_device(["cpu", "cuda:0"])
    assert "Multi-card" in str(e.value)


def test_topology_key_keys_a_world_apart_from_a_pool():
    pool = topology_key(devices=["cpu"] * PARTS)
    assert pool == f"cpu:{PARTS}"
    assert topology_key(world=_dry_world()) == f"cpu:{PARTS}/ranks"


@pytest.mark.parametrize("fmt,balance", [("coo", "nnz"), ("bcoo", "nnz")])
def test_rank_partition_reads_as_its_part(fmt, balance):
    """A rank rebuilt from its nonzeros and the layout reads, at its own
    place, what the whole partition holds there, and every count and
    offset of every part."""
    a = matrices()["block"]
    ri, ci = np.nonzero(a)
    part = partition_1d_coalesced(ri, ci, a[ri, ci], a.shape, PARTS, fmt,
                                  balance, block=(8, 16))
    layout = D.part_layout(part)
    for p in range(PARTS):
        mine = D.rank_partition(layout, D.part_data(part, p), p)
        view, want = D.part_view(mine, p), D.part_view(part, p)
        for f in part._tensors:
            assert torch.equal(getattr(view, f), getattr(want, f)), (p, f)
            if f not in ("rowind", "colind", "values"):
                assert torch.equal(getattr(mine, f), getattr(part, f))
        assert (mine.shape, mine.grid, mine.h_pad, mine.w_pad) == (
            part.shape, part.grid, part.h_pad, part.w_pad)


def test_control_refuses_the_wrong_role():
    ctl0, ctl1 = Control(0, PARTS, 1.0, None), Control(1, PARTS, 1.0, None)
    with pytest.raises(RuntimeError, match="rank 0 leads"):
        ctl0.follow({})
    with pytest.raises(RuntimeError, match="follows"):
        ctl1.command("call").__enter__()


# ------------------------------------------------------- under torchrun

TORCHRUN_BODY = """
import numpy as np
from repro_torch.engine import SpmvEngine
from repro_torch.launch.mesh import env_world

a = np.round(np.random.default_rng(3).standard_normal((64, 48)) * 2)
a[np.abs(a) < 2] = 0
a = a.astype(np.float32)
x = np.arange(48, dtype=np.float32) - 20

world = env_world("cpu")
eng = SpmvEngine(world=world)
if world.rank == 0:
    try:
        eng.register("A", a, partitioning="1d")
        y = eng.multiply("A", x)
        print("LED", eng.plan_for("A").mesh.is_process
              and bool(np.array_equal(y, a @ x)))
    finally:
        eng.close()
else:
    print("FOLLOWED", eng.follow())
"""


def test_world_engine_under_a_torchrun_world():
    """Each rank a process started as torchrun starts it (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``): ``env_world``
    joins it, rank 0 leads, rank 1 follows until rank 0 closes."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", TORCHRUN_BODY], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert "LED True" in outs[0], outs
    # the compile and the call, at least
    assert int(outs[1].split("FOLLOWED ")[1].split()[0]) >= 2, outs
