"""Host<->device staging plane: the one landing helper and the
``ec_stage_*`` accounting every staged byte rides through.

The counterpart of the JAX package's ``ceph_tpu/utils/staging.py``, with
the same counter and histogram names on the process-wide ``ec_kernels``
registry (next to the KernelProfiler's compile/device/sync slices, so one
``dump`` shows the whole decomposition).  These counters meter the
BATCHER/ARENA staging plane: ``ec_stage_d2h_copies`` divided by the
batcher's launch count is the "one device->host copy per flush" contract.
Codec-internal per-op copies (pass-through paths, non-batched callers)
ride the KernelProfiler's ``sync`` slice instead.

On a CUDA device a copy to the card goes through a pinned host buffer
and ``.to(device, non_blocking=True)`` (a non_blocking copy from pageable
memory is synchronous), and copies are timed with CUDA events around
them on the current stream.  On the CPU "device" a copy is a memcpy,
timed on the host clock.

Streams.  Nothing here waits for the whole card.  A launch waits for its
own outputs (``wait_for``: an event on the stream that made them); a
batcher flush runs on its thread's own stream (``FlushStreams``), after
the events its ops' staging copies recorded (``record_ready``); tables
that every stream reads land once before first use (``upload_tables``).
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from .perf import CounterType, PerfCounters, global_perf, kernel_profiler

#: registered (zeroed) on the ``ec_kernels`` registry at first use, so
#: perf dump exposes one stable schema whether or not the
#: device-resident plane ever engaged
COUNTERS = ("ec_stage_h2d_bytes", "ec_stage_h2d_copies",
            "ec_stage_d2h_bytes", "ec_stage_d2h_copies")
HISTOGRAMS = ("ec_stage_h2d_us", "ec_stage_d2h_us")

_REG_LOCK = threading.Lock()


def backend_is_cpu(device) -> bool:
    """Whether ``device`` (a codec's device) is the host CPU.  There
    every copy "to the device" is a memcpy over the same memory bus the
    kernel reads, so the ingest plane folds host bytes once instead of
    staging each op (the reference measured per-op staging plus a concat
    at ~3x the one host fold it replaces)."""
    return torch.device(device).type == "cpu"


def stage_perf() -> PerfCounters:
    """The ``ec_kernels`` registry with the staging schema ensured —
    idempotent (PerfCounters.add RESETS an existing counter, so the
    late registrants here must check first)."""
    pc = global_perf().create("ec_kernels")
    with _REG_LOCK:
        for n in COUNTERS:
            if not pc.has(n):
                pc.add(n)
        for h in HISTOGRAMS:
            if not pc.has(h):
                pc.add(h, CounterType.HISTOGRAM)
    return pc


def note_h2d(nbytes: int, seconds: float | None = None,
             exemplar=None) -> None:
    """``seconds=None`` books bytes + the copy count but NOT latency: an
    unforced copy to the card returns when it is queued, so timing it
    would book the enqueue, not the transfer.  ``exemplar`` is the
    staging op's sampled trace_id (or None)."""
    pc = stage_perf()
    pc.inc("ec_stage_h2d_bytes", int(nbytes))
    pc.inc("ec_stage_h2d_copies")
    if seconds is not None:
        pc.hinc("ec_stage_h2d_us", seconds * 1e6, exemplar=exemplar)


def note_d2h(nbytes: int, seconds: float, exemplar=None) -> None:
    pc = stage_perf()
    pc.inc("ec_stage_d2h_bytes", int(nbytes))
    pc.inc("ec_stage_d2h_copies")
    pc.hinc("ec_stage_d2h_us", seconds * 1e6, exemplar=exemplar)


def wait_for(tensors) -> None:
    """Block until the work that made ``tensors`` is done: for each CUDA
    device among them, one event recorded on its current stream (the
    stream the op that made them ran on) and a wait on that event only,
    never on the whole card.  CPU tensors and numpy arrays need none."""
    seen = set()
    for t in tensors:
        if (isinstance(t, torch.Tensor) and t.device.type == "cuda"
                and t.device not in seen):
            seen.add(t.device)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            ev.synchronize()


def record_ready(device):
    """An event after the work queued so far on ``device``'s current
    stream (an op's staging copies), for a flush on another stream to
    wait on before it reads the staged bytes; None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def upload_tables(arrays, device) -> tuple[torch.Tensor, ...]:
    """Read-only tables (numpy arrays) as tensors on ``device``, landed:
    on a card, one event after the copies, synchronized once, so a
    launch on any stream may read them.  They stay alive while the op
    that holds them is referenced, and every launch waits for its
    outputs before its caller lets go of the op."""
    device = torch.device(device)
    out = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in arrays)
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()
    return out


class FlushStreams:
    """A small pool of CUDA streams, one for each thread that flushes: a
    thread takes the next stream of the pool at its first flush on a
    device and keeps it, so flushes of different threads run on
    different streams (beyond ``size`` threads, they share them in
    turn)."""

    def __init__(self, size: int = 8):
        self._size = size
        self._lock = threading.Lock()
        self._pool: dict[torch.device, list] = {}
        self._taken: dict[torch.device, int] = {}
        self._local = threading.local()

    def stream(self, device: torch.device):
        """This thread's stream on ``device``."""
        mine = getattr(self._local, "streams", None)
        if mine is None:
            mine = self._local.streams = {}
        s = mine.get(device)
        if s is None:
            with self._lock:
                pool = self._pool.setdefault(device, [])
                n = self._taken.get(device, 0)
                self._taken[device] = n + 1
                if len(pool) < self._size:
                    pool.append(torch.cuda.Stream(device=device))
                s = pool[n % self._size]
            mine[device] = s
        return s

    @contextlib.contextmanager
    def flush(self, device: torch.device, waits=(), uses=()):
        """Run the block on this thread's stream of ``device``, after the
        events of ``waits`` (the staging copies of the flush's ops).
        Each CUDA tensor of ``uses``, made on another stream, is marked as
        used on this one (``record_stream``), so the caching allocator
        does not hand its memory out again before this stream is done."""
        s = self.stream(device)
        with torch.cuda.stream(s):
            for ev in waits:
                if ev is not None:
                    s.wait_event(ev)
            for t in uses:
                if t.is_cuda:
                    t.record_stream(s)
            yield s


def _events(device: torch.device):
    """A (start, end) pair of timing CUDA events, start recorded now on
    ``device``'s current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(torch.cuda.current_stream(device))
    return start, end


def _host_tensor(host: np.ndarray) -> torch.Tensor:
    """``host`` as a CPU tensor: a view when numpy lets it be written,
    else a copy (the library refuses read-only views quietly only by
    warning)."""
    return torch.from_numpy(host if host.flags.writeable else host.copy())


def device_put_landed(host: np.ndarray, device, *, force: bool = True,
                      record: bool = True, exemplar=None) -> torch.Tensor:
    """Stage a host buffer to ``device`` and return the tensor there.

    On a CUDA device the bytes go into a pinned host buffer, then
    ``.to(device, non_blocking=True)``; ``force=True`` waits for the copy
    to land and times it with CUDA events, ``force=False`` returns once
    it is queued (and books no latency).  On the CPU the tensor is a
    copy of ``host`` (the caller may reuse its buffer), timed on the host
    clock.  ``record=True`` books the copy against ``ec_stage_h2d_*``."""
    device = torch.device(device)
    host = np.ascontiguousarray(host)
    if device.type == "cpu":
        t0 = time.perf_counter()
        dev = torch.from_numpy(host.copy())
        dt = time.perf_counter() - t0
    elif force:
        pinned = _host_tensor(host).pin_memory()
        start, end = _events(device)
        dev = pinned.to(device, non_blocking=True)
        end.record(torch.cuda.current_stream(device))
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        # queued: no timing events (nothing reads them), and each library
        # call made here gives the interpreter lock to the other
        # submitting threads and waits to take it back
        dev = _host_tensor(host).pin_memory().to(device, non_blocking=True)
        dt = None
    if record:
        note_h2d(host.nbytes, dt, exemplar=exemplar)
    return dev


def fetch_recorded(devs, *, sig: str | None = None) -> list[np.ndarray]:
    """Materialize one or more tensors on the host as ONE metered
    device->host copy event (the flush-plane "exactly one copy per
    flush" contract: a fused launch's parity AND csums leave the card
    together, so they are booked together).  Returns numpy arrays in
    input order; numpy inputs pass through unmetered — they never left
    the host.  CUDA tensors land in pinned host buffers by non_blocking
    copies, all queued before one wait, timed with CUDA events."""
    devs = list(devs)
    if all(isinstance(d, np.ndarray) for d in devs):
        return devs
    cuda = [d for d in devs if isinstance(d, torch.Tensor)
            and d.device.type == "cuda"]
    t0 = time.perf_counter()
    if cuda:
        device = cuda[0].device
        start, end = _events(device)
        landed = {}
        for d in cuda:
            buf = torch.empty(d.shape, dtype=d.dtype, pin_memory=True)
            buf.copy_(d, non_blocking=True)
            landed[id(d)] = buf
        end.record(torch.cuda.current_stream(device))
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
        out = [d if isinstance(d, np.ndarray) else
               landed[id(d)].numpy() if id(d) in landed
               else d.detach().numpy() for d in devs]
    else:
        out = [d if isinstance(d, np.ndarray) else d.detach().numpy()
               for d in devs]
        dt = time.perf_counter() - t0
    nbytes = sum(o.nbytes for o, d in zip(out, devs)
                 if not isinstance(d, np.ndarray))
    note_d2h(nbytes, dt)
    kernel_profiler().note("sync", sig or "sync/bulk",
                           time.perf_counter() - t0)
    return out
