"""Count a step's FLOPs, bytes and peak memory: the port's stand-in for
XLA's ``cost_analysis`` and ``memory_analysis``.

The reference lowers and compiles a step for 256 or 512 TPU chips and
reads three things from the compiled program: its FLOPs, the bytes it
accesses and its argument / temporary memory.  The port compiles nothing.
:func:`counting` runs a step eagerly under one ``TorchDispatchMode`` and
counts, op by op:

* **FLOPs**: each aten op's FLOPs by ``torch.utils.flop_counter``'s
  formulas (those of ``FlopCounterMode``: matrix products, convolutions,
  attention), plus what the kernel wrappers report for their calls
  (``kernels/instrument.py``): a ctypes launch is out of the dispatcher's
  sight.  Inside a wrapper (its ``kernel_scope``) the aten ops of its plain
  version are not counted; the wrapper's report stands for them, so a
  kernel counts the same on the card and in its plain version.  What the
  formulas saw inside the plain versions is kept apart (``plain_flops``).
* **Bytes**: each aten op that is not a view, a metadata op or a bare
  allocation counts the bytes of its tensor inputs once and of its
  outputs once.  This is an eager upper bound (no fusion, no cache reuse),
  the counterpart of XLA's "bytes accessed".
* **Peak live bytes**: every storage an op creates is tracked until it is
  freed (a weak reference to the storage); ``argument_bytes`` are the
  storages of the trees the caller passes (params, optimizer state, inputs,
  caches), counted exactly, and ``temp_bytes`` = peak - arguments.  A
  wrapper's plain version's temporaries do not raise the peak: the kernel
  has none.

Run on fake tensors (:func:`fake_tree`, ``FakeTensorMode`` on the CPU) a
count allocates nothing: a cell of any size is counted on the host.  The
same count runs over real tensors on the card, which is how the card's
count of a step is checked against the fake one.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import instrument
from repro_torch.models import lm
from repro_torch.tree import leaves, tree_map

__all__ = ["Count", "counting", "fake_mode", "fake_tree", "tree_bytes"]

_aten = torch.ops.aten
# allocations and metadata: no byte of data is read or written
_NO_BYTES = {
    _aten.empty.memory_format, _aten.empty_like.default, _aten.empty_strided.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
    _aten.detach.default, _aten.lift_fresh.default, _aten.set_.source_Storage,
    _aten.resize_.default, _aten._local_scalar_dense.default,
}


@dataclass
class Count:
    """One step's count (see the module doc).  ``seconds`` is the count's
    wall time on the host."""

    flops: int = 0
    bytes: int = 0
    argument_bytes: int = 0
    peak_bytes: int = 0
    kernel_flops: int = 0
    kernel_bytes: int = 0
    plain_flops: int = 0
    seconds: float = 0.0
    ops: int = 0
    flops_by_op: Counter = field(default_factory=Counter)
    bytes_by_op: Counter = field(default_factory=Counter)

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(*trees) -> int:
    """Bytes of the distinct storages the tensors of ``trees`` hold."""
    seen: dict = {}
    for tree in trees:
        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _tensors(x, out: list) -> list:
    """The tensors in an op's arguments or results (nested lists, tuples,
    dicts)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


class _CountMode(TorchDispatchMode):
    def __init__(self, count: Count, arguments):
        super().__init__()
        self.count = count
        self.refs: dict = {}  # id(storage) -> (weakref, bytes), made in the count
        self.known = {id(t.untyped_storage()) for tree in arguments
                      for t in leaves(tree) if isinstance(t, torch.Tensor)}
        self.live = count.argument_bytes
        self.ops: dict = {}  # op -> (counts bytes, FLOP formula or None)

    def _freed(self, key: int):
        def freed(_ref):
            self.live -= self.refs.pop(key)[1]
        return freed

    def _op(self, func):
        info = self.ops.get(func)
        if info is None:
            info = (not func.is_view and func not in _NO_BYTES,
                    flop_registry.get(func._overloadpacket))
            self.ops[func] = info
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":  # prim.device and the like: metadata
            return out
        c = self.count
        c.ops += 1
        outs = _tensors(out, [])
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key not in self.refs and key not in self.known:
                n = st.nbytes()
                self.refs[key] = (weakref.ref(st, self._freed(key)), n)
                self.live += n
        counts_bytes, formula = self._op(func)
        flops = int(formula(*args, **kwargs, out_val=out)) if formula else 0
        if instrument.in_kernel():
            c.plain_flops += flops
            return out
        if flops:
            c.flops += flops
            c.flops_by_op[str(func._overloadpacket)] += flops
        if counts_bytes:
            moved = sum(_nbytes(t) for t in _tensors((args, kwargs), outs))
            c.bytes += moved
            c.bytes_by_op[str(func._overloadpacket)] += moved
        if self.live > c.peak_bytes:
            c.peak_bytes = self.live
        return out


@contextlib.contextmanager
def counting(*arguments):
    """Count what runs inside (see the module doc).  ``arguments`` are the
    trees the step takes (params, optimizer state, batch, caches): their
    storages are ``argument_bytes``.  Yields the :class:`Count`, complete
    when the block exits."""
    count = Count(argument_bytes=tree_bytes(*arguments))
    count.peak_bytes = count.argument_bytes
    mode = _CountMode(count, arguments)
    f0, b0 = instrument.work()
    t0 = time.perf_counter()
    with instrument.listening():
        with mode:
            yield count
        f1, b1 = instrument.work()
    count.seconds = time.perf_counter() - t0
    count.kernel_flops, count.kernel_bytes = f1 - f0, b1 - b0
    count.flops += count.kernel_flops
    count.bytes += count.kernel_bytes
    count.peak_bytes = max(count.peak_bytes, mode.live)


def fake_mode() -> FakeTensorMode:
    """A ``FakeTensorMode`` for counting (``models.lm.fake_mode``'s)."""
    return lm.fake_mode()


def fake_tree(tree, mode: FakeTensorMode, device="cpu"):
    """``tree`` with every tensor replaced by a fake one of its shape and
    dtype on ``device`` (default the CPU, where the kernel wrappers take
    their plain versions); other leaves kept.  Nothing is allocated."""
    def fake(t):
        if not isinstance(t, torch.Tensor):
            return t
        with mode:
            return torch.empty(t.shape, dtype=t.dtype, device=device)
    return tree_map(fake, tree)
