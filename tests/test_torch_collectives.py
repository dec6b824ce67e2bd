"""The process mesh's collectives and world (``repro_torch.core.
collectives``, ``repro_torch.core.world``) on a 4-rank gloo world on the
CPU (one world for the module; rank bodies in tests/_torch_world_runner.py).

``ppermute`` follows ``jax.lax.ppermute``: a rank that is no destination
receives zeros.  ``all_to_all`` follows ``jax.lax.all_to_all(tiled=True)``
and ``core.sharding.reshard`` moves a tensor between two specs (slice,
all-gather, all-to-all, psum of partials).  ``all_gather`` and ``psum_scatter`` are tiled in axis
order; sums come back in the input's dtype (int8 wraps, as in the
reference).
Each call's bytes are the bytes of its result on the rank (the reference's
``collective_bytes`` convention), and one SpMV of each merge counts the
closed forms of its partition.  No backend is picked for the caller: NCCL
on one device twice raises before NCCL starts, a rank's device defaults to
a card, and a rank that raises or hangs fails the whole call.
"""
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import world as W
from repro_torch.core.mesh import AXES_2D, AXIS_1D

from _torch_mesh_cases import PARTS, SHAPE

F32 = 4


@pytest.fixture(scope="module")
def ranks():
    import _torch_world_runner as wr

    return W.spawn(wr.collective_cases, PARTS, "gloo", device="cpu",
                   timeout=300)


def test_ppermute_gives_zeros_to_non_destinations(ranks):
    for r, res in enumerate(ranks):
        # boundary perm (i -> i - 1): the last rank is no destination
        want = 0.0 if r == PARTS - 1 else float(r + 2)
        assert torch.equal(res["boundary"], torch.full((3,), want))
        # ring perm (i -> (i - 1) % P): every rank receives from r + 1
        assert torch.equal(res["ring"], torch.full((3,), float((r + 1) % PARTS + 1)))
        assert torch.equal(res["self"], torch.full((3,), float(r + 1)))


def test_all_gather_and_psum_scatter_are_tiled_in_axis_order(ranks):
    for r, res in enumerate(ranks):
        assert res["gather_1d"].tolist() == [0, 1, 10, 11, 20, 21, 30, 31]
        i, j = res["coords"]
        assert (i, j) == divmod(r, 2)  # rank p at flat place p
        # v = arange(4) + 100 * rank; the 2 x 2 grid's row i holds ranks
        # 2i, 2i + 1 and its column j ranks j, 2 + j
        assert res["gather_cols"].tolist() == [200 * i, 200 * i + 1,
                                               200 * i + 100, 200 * i + 101]
        assert res["gather_rows"].tolist() == [100 * j, 100 * j + 1,
                                               100 * j + 200, 100 * j + 201]
        assert res["gather_all"].tolist() == [0, 100, 200, 300]
        row = np.arange(4) * 2 + 100 * (4 * i + 1)  # ranks 2i and 2i + 1
        assert res["psum_cols"].tolist() == row.tolist()
        assert res["scatter_cols"].tolist() == row[2 * j: 2 * j + 2].tolist()
        assert res["psum_all"].tolist() == (np.arange(4) * 4 + 600).tolist()
        # int8 sums wrap in int8: 4 x 100 = 400 = -112 mod 256
        assert res["psum_i8"].dtype == torch.int8
        assert res["psum_i8"].tolist() == [-112, -112]
        assert res["psum_bf16"].dtype == torch.bfloat16
        assert res["psum_bf16"].tolist() == [10.0, 14.0]


def test_collective_counts_are_result_bytes(ranks):
    for res in ranks:
        c1, c2 = res["counts_1d"], res["counts_2d"]
        # 3 permutes of 3 f32, an all-gather of 4 x 2 int64
        assert c1["bytes"]["collective-permute"] == 3 * 3 * F32
        assert c1["calls"]["collective-permute"] == 3
        assert c1["bytes"]["all-gather"] == 8 * 8
        # all-gathers: 2 x 2, 2 x 2 (int64) and 4 x 1 (int64); a
        # reduce-scatter to 2 f32; all-reduces of 4 + 4 f32, 2 int8, 2 bf16
        assert c2["bytes"] == {"all-gather": 3 * 4 * 8, "reduce-scatter": 2 * F32,
                               "all-reduce": 8 * F32 + 2 + 2 * 2,
                               "all-to-all": 0, "collective-permute": 0}
        assert c2["total_bytes"] == sum(c2["bytes"].values())


@pytest.mark.parametrize("name", ["1d-nnz", "2d-psum", "2d-scatter",
                                  "2d-global", "2d-vs", "ring"])
def test_spmv_collective_bytes_match_their_closed_forms(ranks, name):
    """One request's bytes by kind, from the partition's shape: the load
    (x all-gathered), the merge, and the retrieve (every part gathered)."""
    rows, cols = SHAPE
    for res in ranks:
        rec = res[f"spmv|{name}"]
        part = rec["part"]
        R, C = part.grid
        h, w = part.h_pad, part.w_pad
        zero = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
                "all-to-all": 0, "collective-permute": 0}
        if name == "1d-nnz":
            x_pad = -(-cols // PARTS) * PARTS
            run = dict(zero, **{"all-gather": x_pad * F32,
                                "collective-permute": F32})  # one split row
            gather = PARTS * h * F32
        elif name == "ring":
            shard = -(-cols // PARTS)
            run = dict(zero, **{"collective-permute":
                                (PARTS - 1) * shard * F32 + F32})
            gather = None
        elif name == "2d-psum":
            run, gather = dict(zero, **{"all-reduce": h * F32}), PARTS * h * F32
        elif name == "2d-scatter":
            run = dict(zero, **{"reduce-scatter": h // C * F32})
            gather = PARTS * (h // C) * F32
        elif name == "2d-global":
            run, gather = dict(zero, **{"all-reduce": (R * h + h) * F32}), 0
        else:  # variable-sized: x re-gathered, rows padded to 8
            rows_pad = -(-rows // 8) * 8
            run = dict(zero, **{"all-gather": C * -(-cols // C) * F32,
                                "all-reduce": (rows_pad + h) * F32})
            gather = 0
        assert rec["run_raw"]["bytes"] == run, name
        if gather is not None:
            want = dict(run, **{"all-gather": run["all-gather"] + gather})
            assert rec["call"]["bytes"] == want, name
        assert int(rec["rank_part"].shape[0]) == 1  # a rank holds one part


def test_nccl_on_one_device_twice_raises_before_it_starts(monkeypatch):
    def fn(world):
        raise AssertionError("no rank may start")

    with pytest.raises(ValueError, match="duplicate GPUs"):
        W.spawn(fn, 2, "nccl", device="cuda:0")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        W.spawn(fn, 2, "nccl", device="cpu")
    # two ordinals, one card (faked ids): every rank raises through the
    # store before init_process_group
    monkeypatch.setattr(W, "device_key", lambda device: "host:cuda:GPU-same")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def started(*a, **k):
        raise AssertionError("init_process_group was called")

    monkeypatch.setattr(dist, "init_process_group", started)
    store, errors = dist.HashStore(), {}

    def rank(r):
        try:
            W.init_world("nccl", r, 2, store, device=f"cuda:{r}")
        except Exception as e:  # collected for the assertion below
            errors[r] = e

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert sorted(errors) == [0, 1]
    for e in errors.values():
        assert isinstance(e, ValueError) and "duplicate GPUs" in str(e)
    W.check_devices("gloo", ["host:cuda:GPU-same"] * 2)  # gloo may share


def test_no_backend_or_device_is_picked_for_the_caller():
    assert W.World("gloo", 0, 4, torch.device("cuda:0")).transport == \
        "gloo-host-staged"
    assert W.World("gloo", 0, 4, torch.device("cpu")).transport == "gloo"
    assert W.World("nccl", 0, 1, torch.device("cuda:0")).transport == "nccl"
    with pytest.raises(ValueError, match="unknown backend"):
        W.spawn(print, 2, "mpi")
    if not torch.cuda.is_available():
        import _torch_world_runner as wr

        # the ranks' device defaults to cuda:<rank>: no card, no run
        with pytest.raises(W.RankFailed, match="no CUDA device"):
            W.spawn(wr.fails_on_rank_1, 2, "gloo", args=("raise",),
                    timeout=120)


@pytest.mark.parametrize("how,match", [("raise", "rank 1 raised on purpose"),
                                       ("hang", "did not finish")])
def test_a_failed_or_hung_rank_fails_the_call(how, match):
    import _torch_world_runner as wr

    with pytest.raises(W.RankFailed, match=match):
        W.spawn(wr.fails_on_rank_1, 2, "gloo", device="cpu", args=(how,),
                timeout=120 if how == "raise" else 6)


@pytest.mark.parametrize("name", ["1d-nnz", "2d-psum", "2d-scatter",
                                  "2d-global", "2d-vs", "ring"])
def test_counting_transport_counts_what_the_world_moved(ranks, name):
    """A dry-run mesh's counting collectives (the SpMV dry run's) count,
    rank by rank, what the gloo world counted for the same request."""
    import _torch_world_runner as wr
    from repro_torch.api import SparseMatrix
    from repro_torch.core.mesh import dry_process_mesh

    a, x, _ = wr.inputs("f32")
    sm = SparseMatrix.from_dense(a)
    plan = {"1d-nnz": ("1d.nnz", None), "2d-psum": ("2d.equally-sized", "psum"),
            "2d-scatter": ("2d.equally-sized", "psum_scatter"),
            "2d-global": ("2d.equally-sized", "global"),
            "2d-vs": ("2d.variable-sized", None), "ring": ("1d.nnz", None)}
    scheme, merge = plan[name]
    for r, res in enumerate(ranks):
        def mesh(shape):
            names = (AXIS_1D,) if len(shape) == 1 else AXES_2D
            return dry_process_mesh(shape, names, r)

        exe = wr._plan(mesh, (name, scheme, "coo", merge, None, name == "ring"),
                       "torch", sm, a).compile()
        assert exe.mesh.world.transport == "dry"
        exe.run_raw(exe.place(x))
        assert exe.collectives.snapshot()["bytes"] == \
            res[f"spmv|{name}"]["run_raw"]["bytes"], (name, r)


def test_all_to_all_is_tiled_in_axis_order(ranks):
    """x (4, 2) per rank, value 10 * rank + row: over the "cols" axis of
    the 2 x 2 grid, rows split in 2 blocks, block k to position k, blocks
    received concatenated along dim 1 (and along dim 0)."""
    for r, res in enumerate(ranks):
        i, j = res["coords"]
        peers = [2 * i, 2 * i + 1]  # the ranks of this rank's "cols" group
        want = np.concatenate([10 * p + np.arange(4)[2 * j: 2 * j + 2, None]
                               + np.zeros((1, 2)) for p in peers], axis=1)
        np.testing.assert_array_equal(res["a2a_cols"].numpy(), want)
        want0 = np.concatenate([10 * p + np.arange(4)[2 * j: 2 * j + 2, None]
                                + np.zeros((1, 2)) for p in peers], axis=0)
        np.testing.assert_array_equal(res["a2a_rows_first"].numpy(), want0)
        # bytes: the result, 4 x 2 f32 twice; calls by kind
        assert res["counts_a2a"]["bytes"]["all-to-all"] == 2 * 8 * F32
        assert res["counts_a2a"]["calls"]["all-to-all"] == 2


def test_reshard_moves_between_specs(ranks):
    """A (4, 4) tensor (value 4 * row + col) under four specs of the 2 x 2
    grid: a rank's block after each move equals the block of the full
    tensor under the target spec; bytes as the moves' closed forms."""
    full = np.arange(16, dtype=np.float32).reshape(4, 4)
    for res in ranks:
        i, j = res["coords"]
        np.testing.assert_array_equal(res["rs_slice"].numpy(),
                                      full[2 * i: 2 * i + 2])  # P() -> P(rows)
        np.testing.assert_array_equal(res["rs_a2a"].numpy(),
                                      full[:, 2 * i: 2 * i + 2])  # P(rows) -> P(None, rows)
        np.testing.assert_array_equal(res["rs_gather"].numpy(), full)  # -> P()
        np.testing.assert_array_equal(res["rs_psum"].numpy(), 2 * full[:, 2 * j: 2 * j + 2])
        np.testing.assert_array_equal(res["shard_rows"].numpy(), full[2 * i: 2 * i + 2])
        # 3 rows do not split over 2 ranks; "nope" is no axis of the mesh
        np.testing.assert_array_equal(res["shard_odd"].numpy(),
                                      np.arange(12.0).reshape(3, 4))
        b = res["counts_rs"]["bytes"]
        # all-to-all: a (4, 2) block; all-gather: (4, 4); psum: (4, 2)
        assert b == {"all-gather": 16 * F32, "all-reduce": 8 * F32,
                     "reduce-scatter": 0, "all-to-all": 8 * F32,
                     "collective-permute": 0}


def test_a_one_host_gloo_mesh_moves_its_data_through_shared_memory(ranks):
    """make_process_mesh records that the 4 ranks share one host, and the
    mesh's collectives (``core.sharding.collectives``) then move the data
    through shared memory: nobody asks for it."""
    for res in ranks:
        assert res["mesh_transport"] == (True, "shm")


def test_shared_memory_transport_equals_gloo(ranks):
    """SharedMemoryCollectives: the data through a shared file mapping, in
    rounds of a slot (24 bytes here, so most messages take several), gives
    what gloo's own collectives give, sums in group order (int8 wraps),
    with the same counts."""
    for r, res in enumerate(ranks):
        got = res["shm"]
        assert got["transport"] == "shm"
        for key in ("gather_rows", "gather_all", "scatter_cols", "psum_all",
                    "psum_i8", "psum_bf16"):
            assert torch.equal(got[key], res[key]), key
        i, j = res["coords"]
        peers = [2 * i, 2 * i + 1]
        assert got["big"].tolist() == (np.arange(50.0) * sum(p + 1 for p in peers)).tolist()
        assert torch.equal(got["a2a"], res["a2a_cols"])
        c = got["counts"]
        assert c["calls"]["all-gather"] == 2 and c["calls"]["all-reduce"] == 4
        assert c["bytes"]["all-to-all"] == 8 * F32
