"""The kernel race times the kernels alone (ceph_tpu_torch/ec/
matrix_code.py _timed_launch): on the card, each timed launch sits
behind a sleep of RACE_LEAD_CYCLES on its stream, so the host has queued
the op before the card reaches the start event, and the wrapper's host
work stays outside the window.  Without it the card sat idle inside the
window while the host ran the wrapper, which on a ~0.04 ms kernel is
of the same order as the kernel, and a race pinned a kernel 9.2 %
slower than the fastest at the 3x8 encode on (8, 8 MiB) (chip_smoke.py's
check_race_picks).  Checked here with a fake card that records the
order of the stream's work; the bytes compare exactly."""

import contextlib

import numpy as np
import torch

from ceph_tpu_torch import ec
from ceph_tpu_torch.ops import gf256

torch.set_num_threads(1)


class FakeEvent:
    def __init__(self, log, **_):
        self.log = log

    def record(self, stream=None):
        self.log.append("event")

    def elapsed_time(self, other):
        return 0.04


def test_timed_launch_sleeps_before_its_start_event(monkeypatch):
    codec = ec.factory("tpu", {"k": "8", "m": "3", "device": "cpu"})
    log = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda **kw: FakeEvent(log, **kw))
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: log.append(("sleep", cycles)))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    rows = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (8, 4096), dtype=np.uint8))
    M = codec.matrix
    op = codec._torch_matmul(M, kernel="xla")  # built for the CPU
    codec.device = torch.device("cuda")  # times as on the card

    def launch(x):
        log.append("op")
        return op(x)

    out, dt = codec._timed_launch(launch, rows, "matmul/test")
    assert log == [("sleep", codec.RACE_LEAD_CYCLES), "event", "op",
                   "event"]
    assert codec.RACE_LEAD_CYCLES >= 400_000
    assert dt == 0.04e-3
    assert np.array_equal(out.numpy(), gf256.encode_region(M,
                                                           rows.numpy()))
