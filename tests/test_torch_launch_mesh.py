"""The launchers' ``main``s as the ranks of a world that ``torchrun``
describes in the environment: a 2-rank gloo world on the CPU.

Each rank is a process of its own, started with ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set as ``torchrun``
sets them, and runs ``python -m repro_torch.launch.serve`` (or ``.train``)
``--device cpu``: ``main`` joins the world over gloo and runs on
``launch.mesh.make_local_mesh(world=)``, the (2, 1) data-parallel mesh, as
the reference's ``main`` runs on ``make_local_mesh()``.  Both ranks must
report that mesh and agree on their tokens (the whole batch) or their
losses (the global batch's).  Without that environment ``main`` runs on
one device.  ``launch.mesh.env_world`` picks the backend from the host:
NCCL where each local rank has a card of its own, gloo otherwise.
"""
import os
import re
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = {
    "serve": ["--arch", "qwen1.5-0.5b", "--reduced", "--batch", "2",
              "--prompt-len", "8", "--gen", "4"],
    "train": ["--arch", "smollm-360m", "--reduced", "--steps", "2",
              "--batch", "4", "--seq", "16"],
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(module: str, argv: list, n: int = 2) -> list:
    port = str(_free_port())
    procs = []
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), RANK=str(rank),
                   WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.launch.{module}", *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.mark.parametrize("module", ["serve", "train"])
def test_main_runs_on_the_local_mesh_of_a_torchrun_world(module):
    outs = _ranks(module, ARGS[module] + ["--device", "cpu"])
    if module == "serve":
        for rank, out in enumerate(outs):
            assert f"rank {rank} of mesh (2, 1)" in out, out
        # every rank prints the same tokens: the whole batch's
        tokens = [out.split("\n", 1)[1] for out in outs]
        assert tokens[0] == tokens[1] and re.search(r"\d", tokens[0])
    else:
        losses = [re.search(r"final loss (\S+) \(start (\S+)\)", out).groups()
                  for out in outs]
        assert losses[0] == losses[1], outs


@pytest.mark.parametrize("device, local, cards, backend", [
    ("cpu", 2, 0, "gloo"),
    ("cuda", 4, 4, "nccl"),  # a card for each rank of the host
    ("cuda", 4, 1, "gloo"),  # four ranks share one card
])
def test_env_world_picks_the_backend_from_the_host(monkeypatch, device, local, cards,
                                                   backend):
    import torch

    from repro_torch.core import world as W
    from repro_torch.launch.mesh import env_world

    seen = {}
    monkeypatch.setattr(W, "init_world",
                        lambda b, device=None: seen.update(backend=b, device=device))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for k, v in {"RANK": "0", "WORLD_SIZE": str(local),
                 "LOCAL_WORLD_SIZE": str(local)}.items():
        monkeypatch.setenv(k, v)
    env_world(device)
    assert seen["backend"] == backend
    assert seen["device"] == (torch.device("cpu") if device == "cpu" else None)


def test_env_world_is_none_outside_a_torchrun_world(monkeypatch):
    from repro_torch.launch.mesh import env_world

    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert env_world("cpu") is None
