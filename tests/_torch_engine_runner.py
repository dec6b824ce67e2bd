"""Subprocess body of tests/test_torch_engine.py: the JAX engine's side on
P = 4 fake devices (XLA_FLAGS is set before jax imports).

For every case of tests/_torch_engine_cases.py it registers the matrix in
one ``SpmvEngine`` with the partitioning forced, and stores in the .npz
file named on the command line the plan key, the fitted plan and the
answers to x, X and x_rand; then it flushes the batcher case through a
``MicroBatcher`` and stores each future's answer.  Prints ``DEVICES <n>``
first and ``ENGINE SKIP`` when forcing devices failed.

    python tests/_torch_engine_runner.py OUT.npz
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.engine import MicroBatcher, SpmvEngine  # noqa: E402

from _torch_engine_cases import (BATCHER, CASES, PARTS, case_id,  # noqa: E402
                                 matrices, vectors)


def main(out_path: str) -> None:
    print(f"DEVICES {jax.device_count()}", flush=True)
    if jax.device_count() < PARTS:
        print("ENGINE SKIP")
        return
    mats, vecs = matrices(), vectors()
    eng = SpmvEngine(devices=jax.devices()[:PARTS], cache_capacity=16)
    res = {}
    for matrix, part, impl in CASES:
        cid = case_id(matrix, part, impl)
        entry = eng.register(cid, mats[matrix], partitioning=part, impl=impl)
        p = entry.plan
        res[f"{cid}|key"] = np.array(json.dumps(entry.cache_key))
        res[f"{cid}|plan"] = np.array(json.dumps(
            [p.partitioning, p.scheme, p.fmt, p.merge, list(p.grid), p.reason]))
        for name in ("x", "X", "x_rand"):
            res[f"{cid}|{name}"] = np.asarray(eng.multiply(cid, vecs[name]))
    matrix, part, n = BATCHER
    mb = MicroBatcher(eng, max_batch=4, buckets=(1, 2, 4), auto_flush=False)
    futs = [mb.submit(case_id(matrix, part, "xla"), v) for v in vecs["batcher"]]
    mb.flush()
    res["batcher|y"] = np.stack([f.result(timeout=60) for f in futs])
    np.savez(out_path, **res)
    print("ENGINE DONE")


if __name__ == "__main__":
    main(sys.argv[1])
