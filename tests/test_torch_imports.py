"""repro_torch, chip_smoke.py, the port's examples (``examples/torch_*.py``)
and tools (``tools/*_torch.py``) stand alone: importing every module of the
port and every one of those scripts pulls in no jax and nothing of the JAX
package ``repro``, and starts no thread (the serving path's threads start
with a service or batcher)."""
import glob
import os
import pkgutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys, threading
import numpy, torch
threads = {t.ident for t in threading.enumerate()}
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: F401  (its work runs under __main__ only)
import glob, importlib.util, os
scripts = sorted(glob.glob(os.path.join(ROOT, "examples", "torch_*.py"))
                 + glob.glob(os.path.join(ROOT, "tools", "*_torch.py")))
for path in scripts:  # imported, main not run
    name = "_script_" + os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("SCRIPTS", sorted(os.path.relpath(p, ROOT) for p in scripts))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.", "ml_dtypes"))
             or m == "repro")
print("MODULES", len(names))
print("TOPO", sorted(n for n in names if n.startswith("repro_torch.topo")))
print("LM", sorted(n for n in names if n.split(".")[1:2] in (
    ["models"], ["sparse"], ["launch"])))
print("TRAIN", sorted(n for n in names if n.split(".")[1:2] in (
    ["data"], ["optim"], ["runtime"], ["tree"])))
print("ANALYSIS", sorted(n for n in names if n.split(".")[1:2] == ["analysis"]))
print("BAD", bad)
print("NEW_THREADS", sorted(t.name for t in threading.enumerate()
                            if t.ident not in threads))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + PROBE],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert lines["BAD"] == "[]", lines["BAD"]
    assert lines["NEW_THREADS"] == "[]", lines["NEW_THREADS"]
    import repro_torch

    n_modules = 1 + len(list(pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch.")))
    assert int(lines["MODULES"]) == n_modules >= 90
    # the topology package and its modules are among them
    assert lines["TOPO"] == str(["repro_torch.topo", "repro_torch.topo.cost",
                                 "repro_torch.topo.mesh",
                                 "repro_torch.topo.topology"])
    # the LM serving and training paths' packages, and the ten configs and
    # the paper's
    assert lines["LM"] == str([
        "repro_torch.launch", "repro_torch.launch.dryrun",
        "repro_torch.launch.dryrun_spmv", "repro_torch.launch.mesh",
        "repro_torch.launch.serve", "repro_torch.launch.steps",
        "repro_torch.launch.train", "repro_torch.models",
        "repro_torch.models.attention", "repro_torch.models.blocks",
        "repro_torch.models.common", "repro_torch.models.linear_attn",
        "repro_torch.models.lm", "repro_torch.models.moe", "repro_torch.sparse",
        "repro_torch.sparse.layers"])
    assert lines["TRAIN"] == str([
        "repro_torch.data", "repro_torch.data.matrices", "repro_torch.data.tokens",
        "repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.optim.compress",
        "repro_torch.runtime", "repro_torch.runtime.checkpoint",
        "repro_torch.runtime.elastic", "repro_torch.runtime.fault",
        "repro_torch.tree"])
    # the dry run's analysis: the roofline arithmetic, the report, the
    # count; and the sharded program's closed forms
    assert lines["ANALYSIS"] == str([
        "repro_torch.analysis", "repro_torch.analysis.count",
        "repro_torch.analysis.report", "repro_torch.analysis.roofline",
        "repro_torch.analysis.sharded"])
    configs = [m for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
               if m.name.startswith("repro_torch.configs.")]
    assert len(configs) == 12  # base, spmv_paper and the ten archs
    # the ten examples and the three tools of the port
    assert lines["SCRIPTS"] == str(sorted(
        [f"examples/torch_{n}.py" for n in (
            "quickstart", "spmv_end_to_end", "engine_quickstart",
            "solver_quickstart", "serve_quickstart", "slo_quickstart",
            "topo_quickstart", "cluster_quickstart", "serve_lm", "train_lm")]
        + [f"tools/{n}_torch.py" for n in ("trace_dump", "check_topo",
                                           "check_docs")]))


def test_port_sources_name_no_jax_import():
    src = os.path.join(ROOT, "src", "repro_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(src) for f in fs
             if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
    files += glob.glob(os.path.join(ROOT, "examples", "torch_*.py"))
    files += glob.glob(os.path.join(ROOT, "tools", "*_torch.py"))
    for path in files:
        with open(path) as fh:
            for line in fh:
                s = line.strip()
                assert not s.startswith(("import jax", "from jax", "import repro.",
                                         "from repro ", "from repro.")), (path, s)
                assert s != "import repro", path
