#!/usr/bin/env python
"""Documentation link + symbol checker for the PyTorch + CUDA port.

The counterpart of ``tools/check_docs.py`` over ``repro_torch``, with its
link check and symbol resolution.  Walks README.md and docs/*.md and fails
if

  * a relative markdown link ``[text](path)`` points at a file or directory
    that does not exist (anchors and absolute URLs are skipped), or
  * a backticked dotted symbol starting with ``repro_torch.`` does not
    resolve to an importable module / attribute chain, or
  * a symbol exported via ``__all__`` from the port's serving-facing
    packages (:data:`COVERED_MODULES` — ``repro_torch.serve``,
    ``repro_torch.obs``, ``repro_torch.topo``) is never mentioned in any
    backticked span of the docs corpus.

    PYTHONPATH=src python tools/check_docs_torch.py
"""
from __future__ import annotations

import importlib
import os
import re
import sys
from pathlib import Path

# the reference checker's link check and symbol resolution (standard
# library only), shared rather than copied
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from check_docs import LINK_RE, ROOT, check_links, resolve_symbol  # noqa: E402

SYMBOL_RE = re.compile(r"`(repro_torch(?:\.\w+)+)`")

# packages whose entire __all__ surface must appear in the docs corpus
COVERED_MODULES = ("repro_torch.serve", "repro_torch.obs", "repro_torch.topo")


def check_symbols(md: Path) -> list[str]:
    return [f"{md.relative_to(ROOT)}: unresolvable symbol `{dotted}`"
            for dotted in sorted(set(SYMBOL_RE.findall(md.read_text())))
            if not resolve_symbol(dotted)]


def check_symbol_coverage(corpus: str) -> list[str]:
    """Every ``__all__`` symbol of :data:`COVERED_MODULES` has a docs home:
    its bare name inside an inline code span or a fenced code block (fenced
    blocks are cut out before the inline scan, as ``tools/check_docs.py``
    does)."""
    errors = []
    fence = re.compile(r"```.*?```", re.DOTALL)
    blocks = fence.findall(corpus)
    inline = re.findall(r"`[^`]+`", fence.sub("", corpus))
    spans = "\n".join(blocks + inline)
    for modname in COVERED_MODULES:
        mod = importlib.import_module(modname)
        for sym in getattr(mod, "__all__", ()):
            if not re.search(rf"\b{re.escape(sym)}\b", spans):
                errors.append(
                    f"{modname}.{sym} is exported via __all__ but never "
                    "mentioned (backticked) in README.md or docs/*.md"
                )
    return errors


def main() -> int:
    docs = [ROOT / "README.md", *sorted((ROOT / "docs").glob("*.md"))]
    missing = [d for d in docs if not d.exists()]
    if missing:
        print(f"missing doc files: {[str(m) for m in missing]}")
        return 1
    errors = []
    n_links = n_syms = 0
    corpus = []
    for md in docs:
        text = md.read_text()
        corpus.append(text)
        n_links += len(LINK_RE.findall(text))
        n_syms += len(set(SYMBOL_RE.findall(text)))
        errors += check_links(md)
        errors += check_symbols(md)
    errors += check_symbol_coverage("\n".join(corpus))
    n_covered = sum(
        len(getattr(importlib.import_module(m), "__all__", ()))
        for m in COVERED_MODULES
    )
    for e in errors:
        print(f"ERROR: {e}")
    print(f"checked {len(docs)} files, {n_links} links, "
          f"{n_syms} repro_torch.* symbols, "
          f"{n_covered} __all__ exports from {len(COVERED_MODULES)} "
          f"packages: {'FAIL' if errors else 'OK'}")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
