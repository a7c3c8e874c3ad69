"""Core runtime utils tests: buffers, codec, config, perf, throttle,
intervals, op tracking (the unittest tier of SURVEY.md §4), on the port:
the JAX package's tests/test_utils.py on ceph_tpu_torch, with every
thread join and blocked get bounded by a minute."""

import threading
import time

import numpy as np
import pytest

from ceph_tpu_torch.utils import (Buffer, BufferList, Config, CounterType, Decoder,
                            Encodable, Encoder, IntervalSet, Option,
                            OptionLevel, OpTracker, PerfCounters, Throttle,
                            default_config)
from ceph_tpu_torch.utils.buffer import PAGE_ALIGN
from ceph_tpu_torch.utils.codec import CodecError
from ceph_tpu_torch.utils.config import ConfigError


# ----------------------------------------------------------- buffers
def test_buffer_views_and_slices():
    b = Buffer(b"hello world")
    assert len(b) == 11
    assert b[6:11].to_bytes() == b"world"
    assert b[0:5].to_bytes() == b"hello"
    with pytest.raises(TypeError):
        b[3]


def test_buffer_aligned_create():
    for align in (64, 4096):
        b = Buffer.create_aligned(1000, align)
        assert b.is_aligned(align)
        assert len(b) == 1000


def test_bufferlist_append_substr_bytes():
    bl = BufferList(b"abc")
    bl.append(b"defgh")
    bl.append_zero(3)
    assert len(bl) == 11
    assert bl.to_bytes() == b"abcdefgh\0\0\0"
    assert bl.substr(2, 4).to_bytes() == b"cdef"
    assert bl.substr(7, 3).to_bytes() == b"h\0\0"


def test_bufferlist_rebuild_aligned():
    bl = BufferList(b"x" * 100)
    bl.append(b"y" * 57)
    assert not bl.is_contiguous()
    bl.rebuild_aligned(64)
    assert bl.is_contiguous()
    assert bl.buffers[0].is_aligned(64)
    assert bl.to_bytes() == b"x" * 100 + b"y" * 57


def test_buffer_crc_cache_and_chain():
    from ceph_tpu_torch.ops import native
    bl = BufferList(b"123456789")
    assert bl.crc32c() == 0xE3069283
    two = BufferList(b"12345")
    two.append(b"6789")
    assert two.crc32c() == 0xE3069283  # chained across buffers
    b = Buffer(b"cache me")
    c1 = b.crc32c()
    assert b.crc32c() == c1 == native.crc32c(b"cache me")


def test_bufferlist_zero_dedup():
    bl = BufferList()
    bl.append_zero(PAGE_ALIGN)
    bl.append_zero(PAGE_ALIGN)
    assert bl.buffers[0].raw is bl.buffers[1].raw  # shared zero raw
    assert bl.buffers[0].is_zero()


# ----------------------------------------------------------- codec
class Point(Encodable):
    VERSION, COMPAT = 2, 1

    def __init__(self, x, y, label=None):
        self.x, self.y, self.label = x, y, label

    def encode(self, enc):
        def body(e):
            e.i64(self.x)
            e.i64(self.y)
            e.optional(self.label, Encoder.string)
        enc.versioned(self.VERSION, self.COMPAT, body)

    @classmethod
    def decode(cls, dec):
        def body(d, version):
            x, y = d.i64(), d.i64()
            label = d.optional(Decoder.string) if version >= 2 else None
            return cls(x, y, label)
        return dec.versioned(cls.VERSION, body)


def test_codec_roundtrip_primitives():
    e = Encoder()
    e.u8(7); e.u16(300); e.u32(1 << 30); e.u64(1 << 50); e.i64(-12)
    e.boolean(True); e.string("héllo"); e.blob(b"\x00\x01")
    e.seq([1, 2, 3], Encoder.u32)
    e.mapping({"a": 1, "b": 2}, Encoder.string, Encoder.u32)
    d = Decoder(e.tobytes())
    assert [d.u8(), d.u16(), d.u32(), d.u64(), d.i64()] == [
        7, 300, 1 << 30, 1 << 50, -12]
    assert d.boolean() is True
    assert d.string() == "héllo"
    assert d.blob() == b"\x00\x01"
    assert d.seq(Decoder.u32) == [1, 2, 3]
    assert d.mapping(Decoder.string, Decoder.u32) == {"a": 1, "b": 2}
    assert d.remaining() == 0


def test_codec_versioned_skip_unknown_tail():
    """A v2 encoder's extra fields must be skippable by a v1 decoder."""
    p = Point(3, -4, "hi")
    raw = p.encode_bytes()

    class PointV1(Encodable):
        def encode(self, enc): raise NotImplementedError

        @classmethod
        def decode(cls, dec):
            def body(d, version):
                return (d.i64(), d.i64())  # ignores the v2 tail
            return dec.versioned(1, body)

    assert PointV1.decode_bytes(raw) == (3, -4)
    # and the full decoder sees everything
    p2 = Point.decode_bytes(raw)
    assert (p2.x, p2.y, p2.label) == (3, -4, "hi")


def test_codec_incompat_rejected():
    e = Encoder()
    e.versioned(5, 4, lambda s: s.u32(1))
    with pytest.raises(CodecError, match="needs >= v4"):
        Decoder(e.tobytes()).versioned(3, lambda d, v: d.u32())


def test_codec_truncation_rejected():
    e = Encoder()
    e.string("hello")
    with pytest.raises(CodecError, match="past end"):
        Decoder(e.tobytes()[:-2]).string()


# ----------------------------------------------------------- config
def test_config_typed_and_validated():
    cfg = default_config()
    assert cfg.get("ec_plugin") == "tpu"
    cfg.set("osd_pool_default_pg_num", "64")  # string coercion
    assert cfg.get("osd_pool_default_pg_num") == 64
    with pytest.raises(ConfigError):
        cfg.set("osd_pool_default_pg_num", 0)
    with pytest.raises(ConfigError):
        cfg.set("ec_plugin", "floppy")
    with pytest.raises(ConfigError):
        cfg.set("nonexistent_option", 1)


def test_config_observers_and_startup_flags():
    cfg = default_config()
    seen = []
    cfg.observe("log_level", lambda n, v: seen.append((n, v)))
    cfg.set("log_level", 5)
    assert seen == [("log_level", 5)]
    cfg.mark_started()
    with pytest.raises(ConfigError, match="startup"):
        cfg.set("log_recent_size", 500)


def test_config_env_layer(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_LOG_LEVEL", "3")
    cfg = default_config()
    cfg.apply_env()
    assert cfg.get("log_level") == 3


def test_config_help_and_dump():
    cfg = default_config()
    h = cfg.help("osd_heartbeat_grace")
    assert h["type"] == "float" and h["desc"]
    assert "ec_plugin" in cfg.dump()


# ----------------------------------------------------------- perf
def test_perf_counters():
    pc = PerfCounters("osd")
    pc.add("ops")
    pc.add("bytes", CounterType.COUNTER)
    pc.add("lat", CounterType.TIME)
    pc.add("sizes", CounterType.HISTOGRAM)
    pc.inc("ops")
    pc.inc("bytes", 4096)
    with pc.time("lat"):
        pass
    pc.hinc("sizes", 4096)
    d = pc.dump()
    assert d["ops"] == 1 and d["bytes"] == 4096
    assert d["lat"]["count"] == 1
    assert d["sizes"]["count"] == 1
    with pytest.raises(KeyError):
        pc.inc("missing")


def test_perf_collection_dump():
    from ceph_tpu_torch.utils import global_perf
    pc = global_perf().create("test_subsys")
    pc.add("x")
    pc.inc("x", 3)
    assert global_perf().dump()["test_subsys"]["x"] == 3
    global_perf().remove("test_subsys")


# ----------------------------------------------------------- throttle
def test_throttle_blocking_and_oversize():
    t = Throttle("msgs", 4)
    assert t.try_get(3)
    assert not t.try_get(2)
    assert t.try_get(1)
    released = []

    def waiter():
        ok = t.get(2, timeout=60)
        released.append(ok)

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.05)
    t.put(4)
    th.join(timeout=60)
    assert not th.is_alive()
    assert released == [True]
    t.put(2)
    # oversize request admitted alone instead of deadlocking
    assert t.get(100, timeout=1)


# ----------------------------------------------------------- intervals
def test_interval_set_ops():
    s = IntervalSet()
    s.insert(0, 5)
    s.insert(10, 5)
    s.insert(5, 2)  # merges with [0,5)
    assert list(s) == [(0, 7), (10, 15)]
    assert s.contains(3, 4)
    assert not s.contains(6, 2)
    assert s.intersects(6, 5)
    assert not s.intersects(7, 3)
    s.erase(2, 3)
    assert list(s) == [(0, 2), (5, 7), (10, 15)]
    assert s.size() == 2 + 2 + 5
    u = s.union(IntervalSet([(1, 6)]))
    assert list(u) == [(0, 7), (10, 15)]
    i = s.intersect(IntervalSet([(1, 12)]))
    assert list(i) == [(1, 2), (5, 7), (10, 12)]


# ----------------------------------------------------------- op tracking
def test_op_tracker():
    tr = OpTracker(history_size=8, slow_op_seconds=0.01)
    with tr.create("client write") as op:
        op.mark("queued")
        op.mark("sub_op_sent")
        assert len(tr.dump_ops_in_flight()) == 1
        time.sleep(0.02)
    assert tr.dump_ops_in_flight() == []
    hist = tr.dump_historic_ops()
    assert hist and hist[0]["description"] == "client write"
    assert [e["event"] for e in hist[0]["events"]][:2] == [
        "initiated", "queued"]
    assert tr.slow_op_count() == 1
    slow_hist = tr.dump_historic_slow_ops()
    assert len(slow_hist) == 1
    assert slow_hist[0]["description"] == "client write"
    # the summary feed: nothing blocked NOW (the slow op finished), but
    # the cumulative count remembers it
    summary = tr.slow_summary()
    assert summary["inflight"] == 0 and summary["total"] == 1
    assert summary["worst"] == []
    # an in-flight op past the threshold shows up as a worst offender
    hung = tr.create("hung read")
    time.sleep(0.02)
    summary = tr.slow_summary()
    assert summary["inflight"] == 1
    assert summary["worst"][0]["description"] == "hung read"
    hung.finish()


def test_interval_map_buffer_values():
    """interval_map<K, bufferlist> role: value-carrying ranges with
    splice-on-overwrite, slice-preserving erase, byte coalescing, and
    covering queries."""
    from ceph_tpu_torch.utils.interval import IntervalMap

    m = IntervalMap()
    assert m.empty() and not m.covers(0, 1)
    m.insert(0, 4, b"AAAA")
    m.insert(4, 4, b"BBBB")
    # byte neighbours coalesce
    assert len(m) == 1
    assert m.get(0, 8) == [(0, 8, b"AAAABBBB")]
    # overwrite splices: later writes win, survivors keep their slices
    m.insert(2, 4, b"XXXX")
    assert m.get(0, 8) == [(0, 8, b"AAXXXXBB")]
    # ranged query clips values
    assert m.get(3, 2) == [(3, 2, b"XX")]
    # erase keeps the remainders
    m.erase(1, 6)
    assert m.get(0, 8) == [(0, 1, b"A"), (7, 1, b"B")]
    assert not m.covers(0, 8) and m.covers(7, 1)
    # non-byte values: kept whole, no coalescing, no slicing
    m2 = IntervalMap()
    m2.insert(0, 10, {"v": 1})
    m2.insert(10, 5, {"v": 2})
    assert len(m2) == 2
    assert m2.get(8, 4) == [(8, 2, {"v": 1}), (10, 2, {"v": 2})]
    m2.erase(5, 7)
    assert m2.get(0, 20) == [(0, 5, {"v": 1}), (12, 3, {"v": 2})]
    assert m2.covers(12, 3) and not m2.covers(4, 2)
    # invariants: byte length must match; degenerate erase is a no-op
    m3 = IntervalMap()
    with pytest.raises(ValueError):
        m3.insert(0, 4, b"too-long!")
    m3.insert(0, 4, b"GOOD")
    m3.erase(2, 0)
    m3.erase(2, -5)
    assert m3.get(0, 4) == [(0, 4, b"GOOD")]


def test_throttle_timeout_reset_max_and_midpoint():
    """The wait/wakeup seams the messenger backpressure path leans on:
    a timed-out get returns False WITHOUT taking units, reset_max wakes
    blocked waiters into the new budget, and past_midpoint flags the
    half-full watermark."""
    t = Throttle("caps", 2)
    assert t.get(2, timeout=1)
    assert t.past_midpoint()
    # cap full: a timed get fails fast and leaves the count untouched
    t0 = time.monotonic()
    assert not t.get(1, timeout=0.05)
    assert time.monotonic() - t0 < 30.0
    assert t.current == 2
    # a blocked waiter wakes when the cap GROWS past its request
    released = []

    def waiter():
        released.append(t.get(2, timeout=60))

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.05)
    assert released == []          # still blocked at max=2
    t.reset_max(4)
    th.join(timeout=60)
    assert not th.is_alive()
    assert released == [True] and t.current == 4
    assert t.past_midpoint()
    # put() floors at zero rather than going negative
    t.put(100)
    assert t.current == 0
    assert not t.past_midpoint()
