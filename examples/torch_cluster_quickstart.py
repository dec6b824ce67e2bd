"""Cluster quickstart over the PyTorch + CUDA port — multi-process SpMV
serving with failover.

A ``ClusterRouter`` spawns two engine workers (each its own process with
its own CUDA context; both engines share the one card), and this script
walks the cluster contract end to end:

  * **Placement**: matrices land on workers by consistent hashing over
    their content fingerprints; ``replicas=2`` seeds the hot matrix on
    both workers.
  * **Plans ship, workers compile**: one matrix registers via an exported
    tuning-cache slice — the worker rebuilds the tuned winner with ZERO
    re-measurements (``from_cache=True``, cache hits move).
  * **Bit-exactness**: integer payloads make float32 SpMV exact in any
    summation order, so every reply is compared bit-for-bit against the
    dense oracle.
  * **Failover**: one worker is SIGKILLed mid-conversation; the router
    re-homes its matrices from host-side copies and the next multiply is
    still bit-exact.

It runs on the card unless asked for the CPU:

    PYTHONPATH=src python examples/torch_cluster_quickstart.py [--device cpu]

Spawned workers re-import the main module, which is why the script body
lives under the ``__main__`` guard.
"""
import argparse

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.api import SparseMatrix
    from repro_torch.api.plan import check_device
    from repro_torch.cluster import ClusterRouter
    from repro_torch.data.matrices import regular_matrix, scale_free_matrix
    from repro_torch.tune import CandidateGenerator, FakeMeasurer, Tuner, TuningCache

    device = check_device(args.device)
    # integer-valued matrices -> bit-exact float32 oracle comparisons
    mats = {
        "social": np.round(scale_free_matrix(96, 128, 700, seed=0) * 2.0),
        "mesh": np.round(regular_matrix(96, 128, 5, seed=1) * 2.0),
    }
    rng = np.random.default_rng(7)

    def payload(name):
        return rng.integers(-3, 4, size=mats[name].shape[1]).astype(np.float32)

    out = {}
    with ClusterRouter(workers=2, devices=(device.type,),
                       connect_timeout=300.0) as router:
        # -- 1. plain registration: the ring decides placement ------------
        info = router.register("social", mats["social"], replicas=2)
        out["social"] = info
        print(f"social: placed on {info['placements']} "
              f"(scheme {info['scheme_id']}, source {info['source']})")

        # -- 2. ship a tuned plan: tune ONCE here, reuse everywhere -------
        # (FakeMeasurer keeps the example fast + deterministic; swap in the
        # real Measurer to tune on actual timings)
        tuner = Tuner(generator=CandidateGenerator(impls=("cuda",)),
                      measurer=FakeMeasurer(), cache=TuningCache())
        result = tuner.tune(SparseMatrix.from_dense(mats["mesh"]),
                            devices=[device])
        record = {"entries": tuner.cache.export(result.key),
                  "impls": ["cuda"], "batch": None, "block": [8, 16]}
        info = router.register("mesh", mats["mesh"], tune_record=record)
        out["mesh"] = info
        print(f"mesh: tuned winner {info['scheme_id']} rehydrated with "
              f"{info['measurements']} re-measurements "
              f"(from_cache={info['from_cache']})")
        assert info["from_cache"] and info["measurements"] == 0

        # -- 3. routed multiplies, verified bit-exactly -------------------
        for name in mats:
            for _ in range(8):
                x = payload(name)
                y = router.multiply(name, x)
                expect = (mats[name] @ x).astype(np.float32)
                assert np.array_equal(y, expect), f"{name}: mismatch!"
        print("16 routed multiplies, all bit-exact vs the dense oracle")

        # -- 4. chaos: SIGKILL a worker, keep serving ---------------------
        victim = router.entries["mesh"].placements[0]
        router.kill_worker(victim)
        x = payload("mesh")
        y = router.multiply("mesh", x)  # failover re-homes, then retries
        assert np.array_equal(y, (mats["mesh"] @ x).astype(np.float32))
        events = router.failovers
        print(f"killed {victim}: failover re-homed {events[0]['rehomed']}, "
              f"post-failover multiply still bit-exact")

        st = router.stats()
        served = {w: s.get("served", "lost") for w, s in st["workers"].items()}
        print(f"served per worker: {served}; routed vectors: {st['routed']}")
        out.update(victim=victim, rehomed=events[0]["rehomed"],
                   served=served, routed=st["routed"],
                   workers=st["workers"])
    print("OK")
    return out


if __name__ == "__main__":
    main()
