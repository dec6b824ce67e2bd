"""TuningCache — measured winners, persisted so tuning pays once.

Counterpart of ``repro/tune/cache.py``: the same version-1 JSON document,
the same key encoding, file lock and merge-on-write, so the port reads a
file the reference wrote.  Two things differ: the pool identity is
``"<device type>:<count>"`` (``cuda:1`` for one card, ``cuda:16`` for
``["cuda"] * 16``, ``cpu:1`` on the CPU; a topology appends
``|<name>:<sizes>``, e.g. ``cuda:4|pim2x2:2x2``), and impls are the port's
names (``"cuda"``, ``"torch"``).

Measuring candidates costs real compiles and real runs; the result is a
property of (matrix content, device topology, dtype, batch shape) and
nothing else.  The cache keys on exactly that tuple, so a re-``register``
of the same matrix on the same pool — today or next week — replans from
the recorded winner instead of re-measuring.

On-disk format is one JSON document (version-tagged); writes are atomic
(temp file + ``os.replace``) and a corrupt or unreadable file degrades to
an empty cache rather than an exception — a broken cache must never take
the serving path down.

**Multi-process safety** (the cluster tier shares one cache path across N
engine workers, docs/cluster.md): every save takes an exclusive advisory
file lock (``flock`` on a ``<path>.lock`` sidecar) and *merges on write* —
the on-disk document is re-read under the lock and only the keys this
process actually wrote (its dirty set) overlay it, last-writer-wins per
key.  Two workers refining different matrices therefore never clobber each
other's persisted winners; two workers racing on the *same* key converge on
whichever wrote last.  ``refresh()`` pulls winners other processes have
persisted since load; ``hits``/``misses`` count lookups, which is how the
cluster tests verify a rehydrating worker re-measured nothing.
"""

from __future__ import annotations

import json
import os
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional


import torch

from ..core.adaptive import Plan
from ..core.formats import dtype_name

__all__ = ["TuneKey", "TuningCache", "topology_key", "record_to_plan", "make_key"]

_VERSION = 1

try:
    import fcntl

    def _lock_fd(fd: int) -> None:
        fcntl.flock(fd, fcntl.LOCK_EX)

    def _unlock_fd(fd: int) -> None:
        fcntl.flock(fd, fcntl.LOCK_UN)

except ImportError:  # non-POSIX: degrade to lock-free (single-process) mode

    def _lock_fd(fd: int) -> None:
        pass

    def _unlock_fd(fd: int) -> None:
        pass


def topology_key(devices=None, mesh=None, topology=None, *,
                 device="cuda", world=None) -> str:
    """Stable identity of the device pool a measurement is valid for.

    ``type:count`` (e.g. ``cuda:1``, ``cuda:16``, ``cpu:1``) — measurements
    on another device type or pool size are different cache entries.  The
    pool is ``mesh``'s devices, else ``devices``, else the devices of a
    bound ``topology``, else the one ``device``.  A
    :class:`repro_torch.topo.DeviceTopology` appends its name and axis
    sizes (e.g. ``cuda:4|pim2x2:2x2``): placements measured against one
    declared interconnect say nothing about another.

    One rank per part (``world``, or a process ``mesh``) appends
    ``/ranks`` (``cuda:4/ranks``): a world of 4 ranks moves its merges
    between processes, so its winners answer nothing about a one-process
    pool of 4 parts, nor the other way round.
    """
    if world is not None:
        return f"{torch.device(world.device).type}:{world.size}/ranks"
    if mesh is not None and mesh.is_process:
        return f"{mesh.device.type}:{mesh.devices.size}/ranks"
    if mesh is not None:
        devices = list(mesh.devices.flat)
    elif devices is None and topology is not None \
            and topology.devices is not None:
        devices = topology.flat_devices()
    elif devices is None:
        devices = [device]
    else:
        devices = list(devices)
    types = sorted({torch.device(d).type for d in devices})
    key = f"{'+'.join(types)}:{len(devices)}"
    if topology is not None:
        sizes = "x".join(str(s) for s in topology.axis_sizes)
        key += f"|{topology.name}:{sizes}"
    return key


@dataclass(frozen=True)
class TuneKey:
    """(matrix fingerprint, device topology, dtype, batch, impls, block) —
    one tuning problem; the unit the cache never re-measures.

    ``impls`` and ``block`` are part of the key because they are part of
    the *search space*: a winner found among torch candidates answers nothing
    about a cuda search on the same matrix, and a different block tile
    changes which fitted candidates exist at all.
    """

    fingerprint: str
    topology: str
    dtype: str  # numpy dtype name, e.g. "float32"
    batch: int = 1
    impls: str = "cuda"  # "+"-joined sorted impls searched, e.g. "cuda+torch"
    block: tuple = (8, 16)

    def encode(self) -> str:
        return (
            f"{self.fingerprint}|{self.topology}|{self.dtype}|{self.batch}"
            f"|{self.impls}|{self.block[0]}x{self.block[1]}"
        )


def record_to_plan(record: dict) -> Plan:
    """Rebuild the winning adaptive.Plan from a cached record."""
    s = record["scheme"]
    return Plan(
        partitioning=s["partitioning"],
        scheme=s["scheme"],
        fmt=s["fmt"],
        merge=s["merge"],
        grid=tuple(s["grid"]),
        reason=s.get("reason", "tuned winner (from TuningCache)"),
    )


class TuningCache:
    """Persistent map TuneKey -> winning-plan record.

    Args:
      path: JSON file backing the cache; ``None`` keeps it in-memory only
        (same interface, nothing persisted — the default for one-shot
        ``scheme="tune"`` calls).

    Attributes:
      hits/misses: lookup counters (``get``/``__contains__`` that found /
        did not find a record) — the cluster's zero-re-measurement proof.
    """

    def __init__(self, path: Optional[str] = None):
        # expanduser: the documented usage is tune_cache="~/.cache/..."
        self.path = (
            os.path.expanduser(os.fspath(path)) if path is not None else None
        )
        self._entries: dict = {}
        self._dirty: set = set()  # keys THIS process wrote (merge overlay)
        self.load_error: Optional[str] = None
        self.hits = 0
        self.misses = 0
        self._load()

    # ------------------------------------------------------------ disk I/O

    def _read_disk(self) -> dict:
        """Parse the on-disk document into an entries dict (raises on
        corruption; callers decide whether that degrades or propagates)."""
        with open(self.path, encoding="utf-8") as fh:
            doc = json.load(fh)
        if doc.get("version") != _VERSION:
            raise ValueError(f"unknown cache version {doc.get('version')!r}")
        entries = doc["entries"]
        if not isinstance(entries, dict):
            raise ValueError("entries is not a mapping")
        return entries

    def _load(self) -> None:
        if self.path is None or not os.path.exists(self.path):
            return
        try:
            self._entries = self._read_disk()
        except (OSError, ValueError, KeyError, AttributeError) as e:
            # corrupt/unreadable cache: start empty, remember why (test hook
            # + debuggability), never raise into the serving path
            self.load_error = f"{type(e).__name__}: {e}"
            self._entries = {}

    @contextmanager
    def _file_lock(self):
        """Exclusive advisory lock on the ``<path>.lock`` sidecar.

        The sidecar (not the data file) is locked so the atomic
        ``os.replace`` of the data file never invalidates the locked fd.
        """
        fd = os.open(self.path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
        try:
            _lock_fd(fd)
            try:
                yield
            finally:
                _unlock_fd(fd)
        finally:
            os.close(fd)

    def _save(self) -> None:
        """Merge-on-write under the file lock (see module docstring)."""
        if self.path is None:
            return
        directory = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(directory, exist_ok=True)
        with self._file_lock():
            merged: dict = {}
            if os.path.exists(self.path):
                try:
                    merged = self._read_disk()
                except (OSError, ValueError, KeyError, AttributeError):
                    merged = {}  # corrupt on-disk doc: our entries win
            # overlay ONLY the keys this process wrote: concurrent writers'
            # keys (and deletions we never saw) survive last-writer-wins
            for key in self._dirty:
                if key in self._entries:
                    merged[key] = self._entries[key]
                else:
                    merged.pop(key, None)  # dirty-but-absent == deleted
            doc = {"version": _VERSION, "entries": merged}
            fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as fh:
                    json.dump(doc, fh, indent=2, sort_keys=True)
                os.replace(tmp, self.path)  # atomic: readers see old or new
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            # in-memory view now mirrors disk; dirty keys are persisted
            self._entries = merged
            self._dirty.clear()

    def refresh(self) -> None:
        """Merge winners other processes persisted since our last load.

        Disk entries win for every key this process has not itself written;
        locally dirty keys keep their in-memory value (they will overlay on
        the next save).  A no-op for in-memory caches.
        """
        if self.path is None or not os.path.exists(self.path):
            return
        try:
            disk = self._read_disk()
        except (OSError, ValueError, KeyError, AttributeError) as e:
            self.load_error = f"{type(e).__name__}: {e}"
            return
        for key, record in disk.items():
            if key not in self._dirty:
                self._entries[key] = record

    # ------------------------------------------------------------ mapping

    def get(self, key: TuneKey) -> Optional[dict]:
        record = self._entries.get(key.encode())
        if record is not None:
            self.hits += 1
        else:
            self.misses += 1
        return record

    def put(self, key: TuneKey, record: dict) -> None:
        encoded = key.encode()
        self._entries[encoded] = record
        self._dirty.add(encoded)
        self._save()

    def ingest(self, entries: dict, persist: bool = False) -> int:
        """Install already-encoded ``{key_str: record}`` entries (the form
        ``export()`` returns and cluster register messages carry).

        Args:
          entries: encoded-key -> record mapping.
          persist: also mark the keys dirty and save, so this process
            re-publishes them to its cache path (default: in-memory only —
            the shipped record's origin already persisted it).

        Returns:
          Number of entries installed.
        """
        for key, record in entries.items():
            self._entries[str(key)] = record
            if persist:
                self._dirty.add(str(key))
        if persist and entries:
            self._save()
        return len(entries)

    def export(self, key: Optional[TuneKey] = None) -> dict:
        """Encoded-key -> record snapshot (one key, or the whole cache) —
        the wire form cluster register messages ship to workers."""
        if key is None:
            return dict(self._entries)
        record = self._entries.get(key.encode())
        return {} if record is None else {key.encode(): record}

    def __contains__(self, key: TuneKey) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._dirty.update(self._entries.keys())  # record the deletions
        self._entries.clear()
        self._save()


def make_key(
    matrix,
    *,
    device="cuda",
    devices=None,
    mesh=None,
    batch: Optional[int] = None,
    impls=("cuda",),
    block=(8, 16),
    topology=None,
    world=None,
) -> TuneKey:
    """The TuneKey for tuning ``matrix`` on the given pool.

    ``impls`` may be a string or an iterable of impl names; order does not
    matter (the key normalizes to a sorted join).  ``dtype`` is the numpy
    name of the matrix dtype ("float32", "bfloat16", ...), the string the
    reference writes.
    """
    if isinstance(impls, str):
        impls = (impls,)
    return TuneKey(
        fingerprint=matrix.fingerprint(),
        topology=topology_key(devices=devices, mesh=mesh, topology=topology,
                              device=device, world=world),
        dtype=dtype_name(matrix.dtype),
        batch=int(batch or 1),
        impls="+".join(sorted(set(impls))),
        block=tuple(block),
    )
