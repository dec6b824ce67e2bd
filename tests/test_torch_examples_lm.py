"""The port's LM examples and its tools, on the CPU.

``examples/torch_serve_lm.py`` and ``examples/torch_train_lm.py`` run in
process at ``--gen 4`` / ``--steps 3`` with ``--device cpu``: the tokens'
shape, finite losses, and ``--sparse-ffn`` through the block kernel's
wrapper (its plain version on the CPU).  The tools: a 20-request replay of
``tools/trace_dump_torch.py`` whose request rows hold the spans admit ...
deliver (the same rows as the reference tool's dump), a merge of two dumps
into two process rows, ``tools/check_topo_torch.py --device cpu`` and both
docs checkers.  The SpMV examples are in tests/test_torch_examples.py.
"""
import json

import numpy as np
import pytest

import repro_torch.sparse.layers as sparse_layers
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.obs.tracing import PHASES
from test_torch_examples import CPU, load


def test_serve_lm():
    out = load("examples/torch_serve_lm.py").main(CPU + ["--gen", "4"])
    cfg = get_config("qwen1.5-0.5b").reduced()
    assert cfg.vocab == jax_get_config("qwen1.5-0.5b").reduced().vocab
    toks = out["tokens"]
    assert toks.shape == (4, 4) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < cfg.vocab)).all()


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_train_lm(sparse, monkeypatch):
    calls = []
    kernel = sparse_layers.bcoo_spmv

    def counted(*args, **kw):
        calls.append(args[3].shape)
        return kernel(*args, **kw)

    monkeypatch.setattr(sparse_layers, "bcoo_spmv", counted)
    argv = CPU + ["--steps", "3"] + (["--sparse-ffn"] if sparse else [])
    out = load("examples/torch_train_lm.py").main(argv)
    assert out["sparse_ffn"] is sparse and len(out["losses"]) == 3
    assert np.isfinite(out["losses"]).all()
    cfg = get_config("llama3.2-1b").reduced()
    # forward, recompute and grad x of 3 projections a layer, every step
    assert len(calls) == (9 * cfg.n_layers * 3 if sparse else 0)


def span_rows(path) -> list:
    """The span names of each request row of a Chrome trace file."""
    with open(path) as fh:
        doc = json.load(fh)
    rows = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X":
            rows.setdefault(ev["tid"], set()).add(ev["name"])
    return list(rows.values())


def test_trace_dump_replay_and_merge(tmp_path, capsys):
    tool = load("tools/trace_dump_torch.py")
    paths = [str(tmp_path / f"w{i}.json") for i in range(2)]
    for i, path in enumerate(paths):
        assert tool.main(CPU + ["--requests", "20", "--seed", str(21 + i),
                                "--out", path]) == 0
    assert "wrote" in capsys.readouterr().out
    rows = span_rows(paths[0])
    assert len(rows) == 20
    # every request row covers admit ... deliver; requests of more than one
    # vector skip the batcher (no batch_form), as in the reference's dump
    assert set().union(*rows) == set(PHASES)
    for names in rows:
        assert set(PHASES) - {"batch_form"} <= names, names
    jax_out = str(tmp_path / "jax.json")
    assert load("tools/trace_dump.py").main(["--requests", "20", "--out",
                                             jax_out]) == 0
    assert sorted(map(sorted, rows)) == sorted(map(sorted, span_rows(jax_out)))
    merged = str(tmp_path / "cluster.json")
    assert tool.main(["--trace", paths[0], "--trace", paths[1],
                      "--out", merged]) == 0
    with open(merged) as fh:
        events = json.load(fh)["traceEvents"]
    procs = {ev["args"]["name"] for ev in events if ev["name"] == "process_name"}
    assert procs == {"w0", "w1"}
    assert {ev["pid"] for ev in events if ev["ph"] == "X"} == {1, 2}


def test_check_topo_torch_cpu(capsys):
    assert load("tools/check_topo_torch.py").main(CPU) == 0
    out = capsys.readouterr().out
    assert out.count("[ok]") == 4 and out.rstrip().endswith("OK")


@pytest.mark.parametrize("tool", ["check_docs", "check_docs_torch"])
def test_docs_checkers(tool, capsys):
    assert load(f"tools/{tool}.py").main() == 0
    assert capsys.readouterr().out.rstrip().endswith(": OK")
