"""repro_torch and chip_smoke.py stand alone: importing every module of the
port pulls in no jax and nothing of the JAX package ``repro``, and starts
no thread (the serving path's threads start with a service or batcher)."""
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
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.", "ml_dtypes"))
             or m == "repro")
print("MODULES", len(names))
print("TOPO", sorted(n for n in names if n.startswith("repro_torch.topo")))
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
    assert int(lines["MODULES"]) == n_modules >= 56
    # the topology package and its modules are among them
    assert lines["TOPO"] == str(["repro_torch.topo", "repro_torch.topo.cost",
                                 "repro_torch.topo.mesh",
                                 "repro_torch.topo.topology"])


def test_port_sources_name_no_jax_import():
    src = os.path.join(ROOT, "src", "repro_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(src) for f in fs
             if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
    for path in files:
        with open(path) as fh:
            for line in fh:
                s = line.strip()
                assert not s.startswith(("import jax", "from jax", "import repro.",
                                         "from repro ", "from repro.")), (path, s)
                assert s != "import repro", path
