"""Launches of the port wait for their own outputs on their own streams,
never for the whole card (ceph_tpu_torch/utils/staging.py wait_for,
record_ready, upload_tables, FlushStreams; ec/batcher.py _launch_ctx):
a scan of the sources, the codecs' launch paths through wait_for, and
the batcher's flushes on per-thread streams after their ops' staging
events — with a fake stream and event on the CPU that record the order.
The byte checks compare exactly (tolerance 0)."""

import os
import re
import threading

import numpy as np
import pytest
import torch

from ceph_tpu_torch import ec
from ceph_tpu_torch.ec import batcher as batcher_mod
from ceph_tpu_torch.ops import gf256
from ceph_tpu_torch.utils import staging

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ceph_tpu_torch")
_SYNC = re.compile(r"\bcuda\s*\.\s*synchronize\b|\bdevice_synchronize\b"
                   r"|cudaDeviceSynchronize")


@pytest.mark.parametrize("sub", ["ec", "ops", "models", "utils"])
def test_no_whole_card_synchronize_in_the_package(sub):
    """No source of the launch paths waits for the whole card."""
    hits = []
    for root, _dirs, files in os.walk(os.path.join(PKG, sub)):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, f)
                with open(path, encoding="utf-8") as fh:
                    for n, line in enumerate(fh, 1):
                        if _SYNC.search(line):
                            hits.append(f"{path}:{n}: {line.strip()}")
    assert not hits, hits


def _count_waits(monkeypatch) -> list:
    calls = []
    real = staging.wait_for

    def counted(tensors):
        tensors = tuple(tensors)
        calls.append(tensors)
        return real(tensors)

    monkeypatch.setattr(staging, "wait_for", counted)
    return calls


def test_profiled_launch_waits_through_wait_for(monkeypatch):
    """A matrix codec's launch (the plain encode and the fused
    encode+CRC op) waits on its own outputs through staging.wait_for,
    both outputs of the fused op at once."""
    calls = _count_waits(monkeypatch)
    codec = ec.factory("tpu", {"k": "4", "m": "2", "device": "cpu"})
    data = np.random.default_rng(1).integers(0, 256, (4, 4096),
                                             dtype=np.uint8)
    parity = codec.encode_chunks(data)
    assert np.array_equal(parity, gf256.encode_region(codec.matrix, data))
    assert len(calls) >= 1
    n = len(calls)
    parity2, csums = codec.encode_chunks_with_csums(data)
    assert np.array_equal(parity2, parity) and csums.shape == (6,)
    assert len(calls) > n and len(calls[-1]) == 2


def test_bit_matrix_apply_waits_through_wait_for(monkeypatch):
    """The bit-matrix codec's device apply waits on its own output
    through staging.wait_for."""
    calls = _count_waits(monkeypatch)
    codec = ec.factory("jerasure", {"technique": "liberation", "k": "5",
                                    "m": "2", "w": "7", "backend": "torch",
                                    "device": "cpu"})
    L = codec.get_chunk_size(5 * (1 << 16))
    data = np.random.default_rng(2).integers(0, 256, (5, L),
                                             dtype=np.uint8)
    host = ec.factory("jerasure", {"technique": "liberation", "k": "5",
                                   "m": "2", "w": "7", "backend": "numpy"})
    assert np.array_equal(codec.encode_chunks(data),
                          host.encode_chunks(data))
    assert calls and all(len(c) == 1 for c in calls)


def test_wait_for_and_record_ready_leave_the_cpu_alone(monkeypatch):
    """On CPU tensors and numpy arrays nothing waits and no CUDA event is
    made."""
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made for a CPU tensor")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    staging.wait_for([torch.zeros(3), np.zeros(2), None])
    assert staging.record_ready("cpu") is None
    t = staging.upload_tables([np.arange(4, dtype=np.int32)], "cpu")
    assert t[0].tolist() == [0, 1, 2, 3]


class _FakeEvent:
    def __init__(self, log, name):
        self.log, self.name = log, name


class _FakeStream:
    """A stream that logs the events it is made to wait on."""

    made = 0

    def __init__(self, log, device=None):
        type(self).made += 1
        self.id = type(self).made
        self.log = log

    def wait_event(self, ev):
        self.log.append(("wait", self.id, ev.name, threading.get_ident()))


@pytest.fixture
def fake_card(monkeypatch):
    """The batcher's card path on the CPU: staging events and flush
    streams are fakes that log, in order, each op's staging event, each
    stream's waits and entries, and each fused launch."""
    log = []
    lock = threading.Lock()
    seq = iter(range(10**6))

    def record_ready(device):
        with lock:
            ev = _FakeEvent(log, f"ev{next(seq)}")
            log.append(("ready", ev.name, threading.get_ident()))
        return ev

    class Ctx:
        def __init__(self, s):
            self.s = s

        def __enter__(self):
            log.append(("enter", self.s.id, threading.get_ident()))

        def __exit__(self, *exc):
            log.append(("exit", self.s.id, threading.get_ident()))

    monkeypatch.setattr(staging, "backend_is_cpu", lambda device: False)
    monkeypatch.setattr(staging, "record_ready", record_ready)
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device=None: _FakeStream(log, device))
    monkeypatch.setattr(torch.cuda, "stream", Ctx)
    orig = batcher_mod.MatrixErasureCode._profiled_launch

    def launch(self, op, rows, sig, events=None):
        log.append(("launch", sig, threading.get_ident()))
        return orig(self, op, rows, sig, events)

    monkeypatch.setattr(batcher_mod.MatrixErasureCode, "_profiled_launch",
                        launch)
    return log


def _flushes(log):
    """Per flush (enter .. exit of one stream): its stream, its waits and
    whether its launches came after all of them."""
    out, cur = [], None
    by_thread = {}
    for entry in log:
        kind = entry[0]
        if kind == "enter":
            by_thread[entry[2]] = {"stream": entry[1], "waits": [],
                                   "launch_after_waits": None}
        elif kind == "wait":
            cur = by_thread[entry[3]]
            assert cur["launch_after_waits"] is None, "a wait after a launch"
            cur["waits"].append(entry[2])
        elif kind == "launch" and entry[2] in by_thread:
            by_thread[entry[2]]["launch_after_waits"] = True
        elif kind == "exit":
            out.append(by_thread.pop(entry[2]))
    return out


def test_each_staged_op_is_waited_on_by_its_flush(fake_card):
    """Four encodes (one size flush) and four degraded reads (one size
    flush), each staged in its own thread: every op's staging event is
    waited on by the stream of the flush that carries it, before the
    flush launches, and the bytes are the oracle's."""
    log = fake_card
    codec = ec.factory("tpu", {"k": "4", "m": "2", "device": "cpu"})
    rng = np.random.default_rng(3)
    datas = [rng.integers(0, 256, (4, 4096), dtype=np.uint8)
             for _ in range(4)]
    b = batcher_mod.ECBatcher(window_us=10_000_000, max_bytes=4 * 4 * 4096)
    out = [None] * 4
    gate = threading.Barrier(4, timeout=60)

    def write(i):
        gate.wait()
        out[i] = b.encode(codec, datas[i], with_csums=True)

    threads = [threading.Thread(target=write, args=(i,), daemon=True)
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for data, (parity, csums) in zip(datas, out):
        assert np.array_equal(parity, gf256.encode_region(codec.matrix,
                                                          data))
        assert csums.shape == (6,)
    ready = [e[1] for e in log if e[0] == "ready"]
    assert len(ready) == 4
    flushes = _flushes(log)
    assert len(flushes) == 1
    assert sorted(flushes[0]["waits"]) == sorted(ready)
    assert flushes[0]["launch_after_waits"]

    log.clear()
    full = [np.concatenate([d, p]) for d, (p, _c) in zip(datas, out)]
    reads = [None] * 4
    rb = batcher_mod.ECBatcher(window_us=10_000_000, max_bytes=4 * 4 * 4096)
    gate = threading.Barrier(4, timeout=60)

    def read(i):
        gate.wait()
        reads[i] = rb.decode(codec, [1, 4],
                             {s: full[i][s] for s in (0, 2, 3, 5)})

    threads = [threading.Thread(target=read, args=(i,), daemon=True)
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for f, r in zip(full, reads):
        assert np.array_equal(r[1], f[1]) and np.array_equal(r[4], f[4])
    ready = [e[1] for e in log if e[0] == "ready"]
    flushes = _flushes(log)
    assert len(ready) == 4 and len(flushes) == 1
    assert sorted(flushes[0]["waits"]) == sorted(ready)
    assert flushes[0]["launch_after_waits"]


def test_flushing_threads_take_their_own_streams(monkeypatch):
    """Each thread keeps the stream it took at its first flush; threads
    take different streams while the pool lasts, then share in turn."""
    log = []
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device=None: _FakeStream(log, device))
    pool = staging.FlushStreams(size=3)
    dev = torch.device("cuda", 0)
    got = [None] * 5
    for i in range(5):
        t = threading.Thread(
            target=lambda i=i: got.__setitem__(
                i, (pool.stream(dev), pool.stream(dev))))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert all(a is b for a, b in got)
    ids = [a.id for a, _b in got]
    assert len(set(ids[:3])) == 3
    assert ids[3] == ids[0] and ids[4] == ids[1]
