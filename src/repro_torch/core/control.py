"""Control — the channel on which rank 0 of a world leads the other ranks.

The JAX engine is a single controller: one process addresses every device
of its pool and places a part on each.  A world of ranks
(:mod:`repro_torch.core.world`) has no such process: each rank runs its own
program.  A led engine (``repro_torch.engine.SpmvEngine(world=)``) makes
rank 0 the controller.  It runs every public call, and before a call
touches the mesh it sends a *command* on this channel; the other ranks
wait in :meth:`Control.follow` and run each command's builds and
collectives, in the order sent, on their own parts.

The channel is a gloo process group of its own (:func:`channel`), made
when every rank opens a led engine on the world and kept with it, so a
command never interleaves with a data collective.  Every message is a
point-to-point one:

* a command: rank 0 sends ``(op, args, releases)`` to each follower (one
  message of 1 KiB where it fits, else a second with the rest), then any
  per-rank payload (a rank's part of a partitioned matrix: its tensors,
  sent as bytes);
* the leader's own share of a command runs under :attr:`Control.lock` (an
  ``RLock``) from the command until its collectives end, so calls from
  several host threads reach every rank in one order;
* every follower answers each command with its status, ``(True, value)``
  or ``(False, traceback)``.  The leader waits for all of them, at most the
  world's timeout, and raises :class:`~repro_torch.core.world.RankFailed`
  naming each rank that failed or did not answer.

A follower waits for its next command as long as the leader idles; the
leader never waits longer than the world's timeout for a follower.  (A
wait that gloo gives up closes every connection of the leader's side of
the channel: the followers' next message then raises.)  A
command whose followers all answered, and failed before any collective (a
follower's build), leaves the ranks in step: the leader drops what the
others built and the world carries on.  A command that failed in its
collectives, or that a follower did not answer in time (its answer may
still be on its way, and would be read as the next command's), leaves
the world out of step: the channel is then *broken*, every later command
raises at once, and :meth:`close` still tries to release the followers.

The executors a follower holds live in :attr:`Control.executors`, under
the id the leader gave each (:meth:`new_id`).  The leader releases one by
queueing its id (:meth:`release`); every follower drops it as the next
command arrives (:meth:`flush` sends one at once).
"""
from __future__ import annotations

import collections
import datetime
import itertools
import pickle
import threading
import time
import traceback
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from .world import BACKENDS, RankFailed

__all__ = ["Control", "channel", "leading", "IDLE_S", "SMALL"]

SMALL = 1024  # bytes of a message's first piece (its length and its start)
IDLE_S = 7 * 24 * 3600.0  # how long a follower waits for the next command


def channel(world) -> "Control":
    """``world``'s control channel, made on the first call and kept with
    the world (``World.control``).  The first call is collective (a gloo
    group of its own): every rank makes it as it opens a led engine.

    Raises:
      ValueError: ``world`` was never joined (a dry world).
    """
    ctl = world.control
    if ctl is None:
        if world.backend not in BACKENDS:
            raise ValueError(f"a {world.backend!r} world has no control "
                             "channel; join one with init_world / spawn")
        ctl = world.made["control"] = Control(
            world.rank, world.size, world.timeout,
            dist.new_group(backend="gloo", timeout=_seconds(world.timeout)))
    return ctl


def leading(mesh) -> Optional["Control"]:
    """The control channel of ``mesh``'s world where this process leads it
    (rank 0 of a process mesh while a led engine is open), else None."""
    if mesh is None or not mesh.is_process:
        return None
    ctl = mesh.world.control
    return ctl if ctl is not None and ctl.leading and ctl.rank == 0 else None


def _seconds(s: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=max(s, 1e-3))


class _Command:
    """A command in flight on the leader (see :meth:`Control.command`)."""

    def __init__(self, ctl: "Control", op: str, args, parts, collective: bool):
        self.ctl, self.op, self.args, self.parts = ctl, op, args, parts
        self.collective = collective
        self.values: Dict[int, object] = {}  # each follower's answer
        self.sent_bytes = 0  # the per-rank payloads' bytes
        self.send_s = 0.0  # seconds to send the command and the payloads

    def __enter__(self) -> "_Command":
        ctl = self.ctl
        ctl.lock.acquire()
        try:
            ctl._check_open(self.op)
            with ctl._queue_lock:
                releases, ctl._releases = ctl._releases, []
            # pickled before anything is sent: what cannot cross fails here
            data = pickle.dumps((self.op, self.args, releases,
                                 self.parts is not None),
                                protocol=pickle.HIGHEST_PROTOCOL)
        except BaseException:
            ctl.lock.release()
            raise
        rank, t0 = None, time.perf_counter()
        try:
            for rank in ctl.followers:
                ctl._send_bytes(data, rank)
                if self.parts is not None:
                    self.sent_bytes += ctl._send_tensors(self.parts[rank], rank)
        except BaseException as e:
            ctl.broken = f"sending {self.op!r} to rank {rank} failed: {e}"
            ctl.lock.release()
            raise RankFailed(f"rank {rank} of {ctl.size} took no {self.op!r} "
                             f"command: {type(e).__name__}: {e}") from e
        self.send_s = time.perf_counter() - t0  # the command and its payloads
        ctl.sent[self.op] += 1
        ctl.sent_bytes[self.op] += self.sent_bytes
        from ..obs import profile as obs_profile

        self._span = obs_profile.annotate(f"ctrl:{self.op}")
        self._span.__enter__()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        ctl = self.ctl
        try:
            values, failed, late = ctl._statuses(self.op)
        finally:
            self._span.__exit__(et, ev, tb)
            ctl.lock.release()
        self.values = values
        if late:  # an answer still on its way would be read as the next one's
            ctl.broken = (f"rank(s) {sorted(late)} did not answer {self.op!r} "
                          "in time")
        elif (failed or ev is not None) and self.collective:
            ctl.broken = (f"{self.op!r} failed in its collectives on rank(s) "
                          f"{sorted(failed) or [0]}")
        if failed:
            lines = "\n".join(f"rank {r}: {msg}" for r, msg in sorted(failed.items()))
            raise RankFailed(f"rank{'s' if len(failed) > 1 else ''} "
                             f"{', '.join(map(str, sorted(failed)))} of "
                             f"{ctl.size} failed in {self.op!r}:\n{lines}") from ev
        return False  # the leader's own error, if any, propagates


class Control:
    """The control channel of one rank of a world (``World.control``)."""

    def __init__(self, rank: int, size: int, timeout: float, group):
        self.rank, self.size, self.timeout = int(rank), int(size), float(timeout)
        self.group = group
        self.lock = threading.RLock()  # the mesh lock: command to collectives' end
        self.leading = False  # rank 0 while a led engine is open
        self.broken: Optional[str] = None  # why the world fell out of step
        self.closed = False
        self.executors: dict = {}  # a follower's executors, by the leader's id
        self.served = collections.Counter()  # a follower's commands, by op
        self.sent = collections.Counter()  # the leader's commands, by op
        self.sent_bytes = collections.Counter()  # the leader's payload bytes, by op
        self.session_steps = 0  # steps of the sessions run here, every rank
        self._queue_lock = threading.Lock()
        self._releases: list = []
        self._ids = itertools.count(1)

    @property
    def followers(self) -> range:
        return range(1, self.size)

    def begin(self) -> None:
        """Open the channel for a led engine on this rank: rank 0 leads,
        the others follow, until :meth:`close`.

        Raises:
          ValueError: rank 0 already leads an open engine.
          RankFailed: an earlier command left the world out of step.
        """
        if self.leading:
            raise ValueError("another engine leads this world; close it first")
        if self.broken is not None:
            raise RankFailed(f"the world is out of step ({self.broken})")
        self.closed, self.leading = False, self.rank == 0

    # -- the wire --------------------------------------------------------------

    def _send_bytes(self, data: bytes, dst: int) -> None:
        n = len(data)
        head = torch.zeros(SMALL, dtype=torch.uint8)
        head[:8] = torch.tensor([n], dtype=torch.int64).view(torch.uint8)
        body = torch.frombuffer(bytearray(data), dtype=torch.uint8) if n \
            else torch.zeros(0, dtype=torch.uint8)
        k = min(n, SMALL - 8)
        head[8:8 + k] = body[:k]
        dist.send(head, dst, group=self.group)
        if n > k:
            dist.send(body[k:].contiguous(), dst, group=self.group)

    def _recv_bytes(self, src: int, timeout: float) -> bytes:
        head = torch.empty(SMALL, dtype=torch.uint8)
        dist.irecv(head, src, group=self.group).wait(_seconds(timeout))
        n = int(head[:8].view(torch.int64)[0])
        k = min(n, SMALL - 8)
        data = head[8:8 + k].numpy().tobytes()
        if n > k:
            rest = torch.empty(n - k, dtype=torch.uint8)
            dist.irecv(rest, src, group=self.group).wait(_seconds(self.timeout))
            data += rest.numpy().tobytes()
        return data

    def _send(self, obj, dst: int) -> None:
        self._send_bytes(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), dst)

    def _recv(self, src: int, timeout: Optional[float] = None):
        return pickle.loads(self._recv_bytes(
            src, self.timeout if timeout is None else timeout))

    def _send_tensors(self, tensors: dict, dst: int) -> int:
        """Send a dict of host tensors (their bytes, no pickling); returns
        the bytes sent."""
        meta = {k: (v.dtype, tuple(v.shape)) for k, v in tensors.items()}
        self._send(meta, dst)
        n = 0
        for k, v in tensors.items():
            if v.numel():
                flat = v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                dist.send(flat, dst, group=self.group)
                n += flat.numel()
        return n

    def _recv_tensors(self, src: int) -> dict:
        out = {}
        for k, (dtype, shape) in self._recv(src).items():
            numel = 1
            for d in shape:
                numel *= d
            buf = torch.empty(numel * torch.empty((), dtype=dtype).element_size(),
                              dtype=torch.uint8)
            if numel:
                dist.irecv(buf, src, group=self.group).wait(_seconds(self.timeout))
            out[k] = buf.view(dtype).reshape(shape)
        return out

    def _statuses(self, op: str) -> tuple:
        """({rank: value}, {rank: why}, {ranks that did not answer}) of
        every follower's answer to ``op``, each waited for until the
        channel's timeout (at least a second).  The first rank that does
        not answer ends the reading: gloo closes every connection of a
        wait it gave up, so the ranks after it cannot be read."""
        deadline = time.monotonic() + self.timeout
        values, failed, late = {}, {}, set()
        for r in self.followers:
            try:
                ok, value = self._recv(r, max(1.0, deadline - time.monotonic()))
            except Exception as e:
                failed[r] = (f"no answer to {op!r} within {self.timeout:g} s "
                             f"({type(e).__name__}: {e}); ranks after it not "
                             "read")
                late.add(r)
                break
            (values if ok else failed)[r] = value
        return values, failed, late

    # -- the leader --------------------------------------------------------------

    def _check_open(self, op: str) -> None:
        if self.rank != 0:
            raise RuntimeError(f"rank {self.rank} follows: only rank 0 leads "
                               f"(it sent {op!r}); call follow() here")
        if self.closed:
            raise RuntimeError(f"the control channel is closed ({op!r})")
        if self.broken is not None and op != "close":
            raise RankFailed(f"the world is out of step ({self.broken}); "
                             f"{op!r} was not sent")

    def command(self, op: str, args=None, parts: Optional[dict] = None,
                collective: bool = True) -> _Command:
        """A command to every follower, as a context manager: entering it
        takes the mesh lock and sends ``(op, args)`` (and ``parts[rank]``,
        a dict of host tensors, to each follower); the block is the
        leader's own share; leaving it waits for every follower's answer
        and releases the lock.

        ``collective=False`` marks a command whose failure leaves the ranks
        in step (nothing of it reaches a collective), as long as every
        follower answered it in time.  The followers' answers are the
        command's ``values``, by rank.

        Raises:
          RankFailed: a follower failed or did not answer (each named),
            or the world is out of step from an earlier failure.
          RuntimeError: called on a follower, or after :meth:`close`.
        """
        return _Command(self, op, args, parts, collective)

    def new_id(self) -> int:
        """A fresh id for an executor the followers will hold."""
        with self._queue_lock:
            return next(self._ids)

    def release(self, wid: int) -> None:
        """Queue executor ``wid``'s release on every follower (sent with the
        next command)."""
        with self._queue_lock:
            self._releases.append(wid)

    def flush(self) -> None:
        """Send the queued releases now."""
        with self._queue_lock:
            pending = bool(self._releases)
        if pending and self.broken is None and not self.closed:
            with self.command("flush", collective=False):
                pass

    def tell(self, value) -> None:
        """Send ``value`` to every follower, inside a command (the leader's
        decisions: a session's next chunk)."""
        for r in self.followers:
            self._send(value, r)

    def hear(self):
        """The leader's :meth:`tell`, on a follower."""
        return self._recv(0)

    def close(self) -> None:
        """Release every follower from :meth:`follow` (idempotent).  A
        broken world is released as far as its followers still answer."""
        if self.closed or self.rank != 0:
            return
        try:
            if self.broken is None:
                with self.command("close", collective=False):
                    pass
            else:
                with self.lock:
                    for r in self.followers:
                        try:  # and its answer: an unread one holds it a timeout
                            self._send_bytes(pickle.dumps(("close", None, [], False)), r)
                            self._recv(r)
                        except Exception:
                            pass
        finally:
            self.closed, self.leading = True, False

    # -- a follower --------------------------------------------------------------

    def follow(self, handlers: Dict[str, Callable]) -> int:
        """Run the leader's commands until it closes the channel; returns
        the commands run.  ``handlers[op](control, args, part)`` runs
        command ``op`` (``part``: the tensors the leader sent this rank, or
        None) and returns the value the leader receives.

        Raises:
          RankFailed: the channel to rank 0 broke (rank 0 gave up waiting
            for an answer, which closes its side, or died); the executors
            this rank held are released.
        """
        if self.rank == 0:
            raise RuntimeError("rank 0 leads; the other ranks follow")
        try:
            return self._follow(handlers)
        except RuntimeError as e:  # the wire, not a handler
            for exe in self.executors.values():
                exe.release()
            self.executors.clear()
            raise RankFailed(f"rank {self.rank} lost rank 0's control "
                             f"channel: {e}") from e

    def _follow(self, handlers: Dict[str, Callable]) -> int:
        from ..obs import profile as obs_profile

        builtin = {"flush": lambda c, a, p: None}
        n = 0
        while True:
            op, args, releases, has_part = self._recv(0, IDLE_S)
            for wid in releases:
                exe = self.executors.pop(wid, None)
                if exe is not None:
                    exe.release()
            part = self._recv_tensors(0) if has_part else None
            if op == "close":
                for exe in self.executors.values():
                    exe.release()
                self.executors.clear()
                self._send((True, None), 0)
                self.closed = True
                return n
            n += 1
            self.served[op] += 1
            try:
                with obs_profile.annotate(f"ctrl:{op}"):
                    status = (True, (builtin.get(op) or handlers[op])(self, args, part))
            except Exception:
                status = (False, traceback.format_exc())
            del part
            self._send(status, 0)
