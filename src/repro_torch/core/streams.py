"""One CUDA stream per host thread, and waits on that stream alone.

The serving path reaches the card from several host threads at once: the
batcher's flush thread, the service's worker pool and any caller of
``exe(x)``.  Each thread runs its requests on a stream of its own
(:func:`on_thread_stream`; the kernels launch on the current stream), and a
phase ends in :func:`wait`, which blocks on an event recorded on that
stream — never on the whole device — so one request's phase times hold its
own work only (the JAX package blocks on the request's own arrays,
``jax.block_until_ready``).

A tensor made on one thread's stream and read on another's needs an order
between the two: the placed matrix gets it from the one :func:`wait` at the
end of placement (``ExecutionPlan.compile``), before any request can see
it.  On a CPU device every helper here is a no-op.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["thread_stream", "on_thread_stream", "wait"]

_LOCAL = threading.local()
_POOL = 32  # streams per device in PyTorch's round-robin stream pool
_HELD: dict = {}  # (device, stream handle) -> the thread that holds it
_LOCK = threading.Lock()


def thread_stream(device: torch.device) -> torch.cuda.Stream:
    """The calling thread's own stream on CUDA ``device``.

    Taken on first use from PyTorch's pool, skipping streams that another
    live thread holds, so up to 32 live threads never share one (beyond
    that, threads share and their work serializes)."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    streams = getattr(_LOCAL, "streams", None)
    if streams is None:
        streams = _LOCAL.streams = {}
    stream = streams.get(device)
    if stream is None:
        with _LOCK:
            for key in [k for k, t in _HELD.items() if not t.is_alive()]:
                del _HELD[key]
            for _ in range(_POOL):
                stream = torch.cuda.Stream(device)
                if (device, stream.cuda_stream) not in _HELD:
                    break
            _HELD[(device, stream.cuda_stream)] = threading.current_thread()
        streams[device] = stream
    return stream


def on_thread_stream(device: torch.device):
    """Context that makes the calling thread's own stream current on
    ``device`` (a no-op context for a CPU device)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(thread_stream(device))


def wait(device: torch.device) -> None:
    """Block until the work enqueued so far on the current stream of
    ``device`` is done (an event on that stream, not a device-wide
    synchronize)."""
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        event.synchronize()
