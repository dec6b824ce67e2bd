"""Rank bodies of tests/test_torch_engine_world.py (numpy and torch only).

The test spawns one gloo world of 4 CPU ranks
(``repro_torch.core.world.spawn(engine_world, 4, "gloo", device="cpu")``).
Every rank opens each scenario's ``SpmvEngine(world=)``; rank 0 leads it
and returns what it saw as numpy arrays and plain values, the other ranks
follow until rank 0 closes it and return the commands they ran and the
executors they still hold.  Rank ``FAULT_RANK`` refuses to build any part
of a matrix of ``FAULT_ROWS`` rows (an injected fault); rank ``LATE_RANK``
builds a matrix of ``LATE_ROWS`` rows ``LATE_S`` seconds late, past its
leader's timeout (the last scenario: the world is out of step after it).
Every follower also answers a ``"placed"`` command, the test's own, with
the count of executors it holds.
"""
import asyncio
import time
import types

import numpy as np
import torch

from repro_torch.api import SparseMatrix
from repro_torch.core.world import RankFailed
from repro_torch.engine import MicroBatcher, SpmvEngine
from repro_torch.serve import AsyncSpmvService
from repro_torch.tune import CandidateGenerator, FakeMeasurer, Measurer, Tuner

from _torch_engine_cases import (BATCHER, CASES, PARTS, SESSIONS, TUNE_SEED,
                                 case_id, matrices, vectors)
from _torch_mesh_cases import solver_inputs

TO_JAX = {"torch": "xla", "cuda": "pallas"}
FAULT_RANK, FAULT_ROWS = 2, 40
LATE_RANK, LATE_ROWS, LATE_S, LATE_TIMEOUT_S = 1, 24, 3.0, 1.0
SERVE_REQUESTS, SERVE_WIDTHS = 48, (1, 4, 8)
CPU4 = ["cpu"] * PARTS


def port_impls(jimpl: str) -> tuple:
    return ("torch", "cuda") if jimpl == "xla" else ("cuda",)


def case_name(case, impl: str) -> str:
    return f"{case_id(*case)}-{impl}"


class PortFake(FakeMeasurer):
    """The port's FakeMeasurer, hashing each candidate under its JAX impl
    name, so both packages draw the same pseudo-times."""

    def _fake_time(self, plan) -> float:
        return super()._fake_time(types.SimpleNamespace(
            scheme_id=plan.scheme_id, impl=TO_JAX[plan.impl], grid=plan.grid))


def fake_tuner() -> Tuner:
    return Tuner(generator=CandidateGenerator(impls=("torch",)),
                 measurer=PortFake(seed=TUNE_SEED))


def inject_fault() -> None:
    """Make this rank fail to build every part of a FAULT_ROWS-row matrix,
    and build every part of a LATE_ROWS-row one LATE_S seconds late."""
    import repro_torch.api.plan as plan_mod

    build = plan_mod.follow_compile

    def faulty(world, args, data):
        rows = args["layout"]["shape"][0]
        if rows == FAULT_ROWS and world.rank == FAULT_RANK:
            raise RuntimeError(f"injected fault on rank {world.rank}")
        if rows == LATE_ROWS and world.rank == LATE_RANK:
            time.sleep(LATE_S)
        return build(world, args, data)

    plan_mod.follow_compile = faulty


def add_placed_command() -> None:
    """Make this follower answer ``"placed"`` with its executors' count."""
    import repro_torch.api.executor as ex

    handlers = ex.follower_handlers

    def with_placed(world):
        return dict(handlers(world),
                    placed=lambda ctl, args, part: len(ctl.executors))

    ex.follower_handlers = with_placed


def followers_placed(eng) -> dict:
    """Rank 0: each follower's count of executors, by rank."""
    with eng.control.command("placed", collective=False) as cmd:
        pass
    return cmd.values


def serve_requests(names, cols: int, seed: int = 21) -> list:
    """(name, x) pairs: integer-valued, widths 1 / 4 / 8."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(SERVE_REQUESTS):
        width = int(rng.choice(SERVE_WIDTHS))
        shape = (cols,) if width == 1 else (cols, width)
        out.append((str(rng.choice(names)),
                    rng.integers(-3, 4, shape).astype(np.float32)))
    return out


def parity(world, eng) -> dict:
    """Every case and impl of _torch_engine_cases, the batcher, the
    sessions, the tuner, validation, the injected fault, then a service
    that closes the engine."""
    mats, vecs = matrices(), vectors()
    out = {}
    for case in CASES:
        for impl in port_impls(case[2]):
            name = case_name(case, impl)
            entry = eng.register(name, mats[case[0]], partitioning=case[1],
                                 impl=impl)
            p = entry.plan
            out[f"{name}|key"] = list(entry.cache_key[:4]) + [entry.cache_key[4]]
            out[f"{name}|plan"] = [p.partitioning, p.scheme, p.fmt, p.merge,
                                   list(p.grid), p.reason]
            out[f"{name}|process"] = eng.plan_for(name).mesh.is_process
            for v in ("x", "X", "x_rand"):
                out[f"{name}|{v}"] = eng.multiply(name, vecs[v])
    name = case_name(BATCHER[:2] + ("xla",), "cuda")
    mb = MicroBatcher(eng, max_batch=4, buckets=(1, 2, 4), auto_flush=False)
    futs = [mb.submit(name, v) for v in vecs["batcher"]]
    out["batcher|flushed"] = mb.flush()
    out["batcher|y"] = np.stack([f.result(timeout=60) for f in futs])
    out["batcher|runs"] = (mb.batches_run, mb.vectors_run)

    for combine, part in SESSIONS:
        a, x0, kw = solver_inputs(combine)
        name = f"session.{combine}.{part}"
        eng.register(name, a, partitioning=part)
        r = eng.solve(name, x0, **kw)
        out[f"{name}|x"], out[f"{name}|steps"] = r.x, r.steps
        out[f"{name}|converged"] = r.converged

    for matrix, a in mats.items():
        r = fake_tuner().tune(SparseMatrix.from_dense(a), world=world)
        out[f"tuner|{matrix}"] = [r.best.scheme_id, list(r.best.grid),
                                  r.baseline.scheme_id, r.speedup,
                                  [m.scheme_id for m in r.measurements]]
        out[f"tuner|{matrix}|topology"] = r.key.topology
        out[f"tuner|{matrix}|process"] = r.best.mesh.is_process
    # the engine's refinements: the fake tuner's winner swapped in, then the
    # real Measurer's, every candidate compiled and timed on the world
    name = case_name(("regular", "2d", "xla"), "cuda")
    out["refine|fake"] = eng.refine(name)
    out["refine|fake|x"] = eng.multiply(name, vecs["x"])
    eng._tuner = Tuner(generator=CandidateGenerator(max_candidates=3),
                       measurer=Measurer(warmup=1, iters=2))
    eng.registry.get(name).tuned = False
    out["refine|real"] = eng.refine(name, x=vecs["x"])
    out["refine|real|x"] = eng.multiply(name, vecs["x"])
    out["refine|real|process"] = eng.plan_for(name).mesh.is_process

    # validation raises here alone, and the world carries on
    name = case_name(CASES[0], "cuda")
    i8 = np.zeros((8, 8), np.int8)
    i8[0, 0], i8[3, 4], i8[7, 1] = 2, 5, -3
    eng.register("int8", i8)
    out["int8|y"] = eng.multiply("int8", np.ones(8, np.int8))
    out["int8|want"] = i8 @ np.ones(8, np.int8)
    errors = {}
    for what, call in {
        "unknown name": lambda: eng.multiply("nope", vecs["x"]),
        "short x": lambda: eng.multiply(name, vecs["x"][:-1]),
        "unsafe dtype": lambda: eng.multiply("int8", np.full(8, 0.5, np.float32)),
        "bad impl": lambda: eng.register("bad", mats["regular"], impl="nope"),
        "non-square session": lambda: eng.solve(name, vecs["x"], steps=2),
        "lambda combine": lambda: eng.solve("session.plain.1d",
                                            solver_inputs("plain")[1], steps=2,
                                            combine=lambda x, y: y),
    }.items():
        try:
            call()
            errors[what] = None
        except Exception as e:  # noqa: BLE001 — the type is the result
            errors[what] = type(e).__name__
    out["validation"] = errors
    out["validation|x"] = eng.multiply(name, vecs["x"])

    # a fault on one rank: RankFailed naming it, nothing left behind
    t0 = time.perf_counter()
    try:
        eng.register("fault", np.eye(FAULT_ROWS, 128, dtype=np.float32),
                     partitioning="1d")
        out["fault"] = None
    except RankFailed as e:
        out["fault"] = str(e)
    out["fault|s"] = time.perf_counter() - t0
    out["fault|registered"] = "fault" in eng.registry
    out["fault|x"] = eng.multiply(name, vecs["x"])
    out["placed|leader"] = len(eng.cache)
    out["placed|followers"] = followers_placed(eng)

    # the service: 48 requests against a one-process 4-part engine; the
    # service's close closes the engine (and releases the followers)
    ref = SpmvEngine(devices=CPU4)
    names = [case_name(("scale-free", "1d", "xla"), "cuda"),
             case_name(("regular", "2d", "xla"), "torch"),
             case_name(("block", "2d", "pallas"), "cuda")]
    for nm in names:
        entry = eng.registry.get(nm)
        ref.register(nm, mats[nm.split(".")[0]], plan=entry.plan,
                     impl=entry.cache_key[4])
    out["ref|process"] = ref.plan_for(names[0]).mesh.is_process
    reqs = serve_requests(names, mats["regular"].shape[1])
    svc = AsyncSpmvService(engine=eng, workers=3)

    async def run():
        async with svc:
            return await asyncio.wait_for(asyncio.gather(
                *(svc.multiply(None, nm, x) for nm, x in reqs)), 120)

    got = asyncio.run(run())
    out["serve|equal"] = [bool(np.array_equal(y, ref.multiply(nm, x)))
                          for (nm, x), y in zip(reqs, got)]
    out["serve|served"], out["serve|errors"] = svc.served, svc.errors
    out["serve|closed"] = eng.control.closed
    return out


def eviction(world, eng) -> dict:
    """An LRU of 2 plans: the third registration evicts the first, its
    reactivation the second; every rank holds what rank 0 holds."""
    mats, vecs = matrices(), vectors()
    out = {}
    names = [f"lru.{m}" for m in ("regular", "scale-free", "block")]
    for nm in names:
        eng.register(nm, mats[nm.split(".", 1)[1]], partitioning="1d")
    out["evicted"] = eng.plan_for(names[0]) is None
    out["after_register"] = (len(eng.cache), followers_placed(eng))
    eng.reactivate(names[0])
    out["after_reactivate"] = (len(eng.cache), followers_placed(eng))
    out["reactivated|x"] = eng.multiply(names[0], vecs["x"])
    out["reactivated|want"] = mats["regular"] @ vecs["x"]
    out["evictions"] = eng.cache.stats.evictions
    return out


def late(world, eng) -> dict:
    """Rank LATE_RANK answers a compile after rank 0's timeout: rank 0's
    register raises RankFailed naming it, and the world is out of step
    (the answer may still come), so the next call raises at once."""
    mats, vecs = matrices(), vectors()
    eng.register("before", mats["regular"], partitioning="1d")
    eng.control.timeout = LATE_TIMEOUT_S
    out = {}
    t0 = time.perf_counter()
    try:
        eng.register("late", np.eye(LATE_ROWS, 128, dtype=np.float32),
                     partitioning="1d")
        out["raised"] = None
    except RankFailed as e:
        out["raised"] = str(e)
    out["s"] = time.perf_counter() - t0
    try:
        eng.multiply("before", vecs["x"])
        out["next"] = None
    except RankFailed as e:
        out["next"] = str(e)
    out["broken"] = eng.control.broken
    return out


# tune_margin 1: a refinement swaps whenever a candidate measures faster
SCENARIOS = ((parity, dict(cache_capacity=64, tuner=None, tune_margin=1.0)),
             (eviction, dict(cache_capacity=2)),
             (late, dict(cache_capacity=8)))


def scatters(world) -> dict:
    """Rank 0 scatters a piece to every rank: over gloo, and through shared
    memory in one round and in several (a slot smaller than the pieces)."""
    from repro_torch.core.collectives import Collectives, SharedMemoryCollectives
    from repro_torch.core.mesh import AXIS_1D, world_mesh

    mesh = world_mesh(world, (PARTS,), (AXIS_1D,))
    pieces = None
    if world.rank == 0:
        pieces = [torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * r
                  for r in range(PARTS)]
    out = {}
    for key, coll in (("gloo", Collectives(mesh)), ("shm", mesh.collectives),
                      ("shm-rounds", SharedMemoryCollectives(mesh, slot=40))):
        out[f"scatter|{key}"] = coll.scatter(pieces, (3, 2), torch.float32).numpy()
        out[f"scatter|{key}|bytes"] = coll.snapshot()["bytes"].get("scatter")
    return out


def engine_world(world) -> dict:
    """One rank: every scenario on its own led engine over ``world``, then
    the scatter collective alone."""
    torch.set_num_threads(1)
    if world.rank != 0:
        inject_fault()
        add_placed_command()
    out = {"rank": world.rank}
    for scenario, kw in SCENARIOS:
        if scenario is parity:
            kw = dict(kw, tuner=fake_tuner())
        eng = SpmvEngine(world=world, **kw)
        key = scenario.__name__
        if world.rank != 0:
            try:
                out[f"{key}|commands"] = eng.follow()
            except RankFailed as e:  # the late scenario breaks the channel
                out[f"{key}|lost"] = str(e)
            out[f"{key}|left"] = len(world.control.executors)
            continue
        try:
            out.update({f"{key}|{k}": v for k, v in scenario(world, eng).items()})
        finally:
            eng.close()
    out.update(scatters(world))
    return out
