"""The port's wire formats against the JAX package's: every message type
of msg.wire.MESSAGE_TYPES and every versioned struct of the wire corpus,
built from each package's canonical sample (tools/dencoder), encodes to
the same bytes in both, and each package decodes the other's bytes to
equal fields, and messengers of the two talk over TCP.  The port's
dencoder checks corpus_wire/ and names the three archived files it
cannot decode yet.  Bytes and fields compare exactly."""

import ctypes
import dataclasses
import os
import threading
import time

import numpy as np
import pytest

import ceph_tpu.msg.messenger as ref_messenger
import ceph_tpu.msg.stack as ref_stack
import ceph_tpu.msg.tcp as ref_tcp
import ceph_tpu.msg.wire as ref_wire
import ceph_tpu.tools.dencoder as ref_dencoder
import ceph_tpu_torch.msg.messenger as port_messenger
import ceph_tpu_torch.msg.stack as port_stack
import ceph_tpu_torch.msg.tcp as port_tcp
import ceph_tpu_torch.msg.wire as port_wire
import ceph_tpu_torch.tools.dencoder as port_dencoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "corpus_wire")

MESSAGE_NAMES = [c.__name__ for c in ref_wire.MESSAGE_TYPES]
STRUCT_NAMES = sorted(port_dencoder.struct_samples())


def plain(v):
    """A value of either package as plain Python data: a dataclass as
    its class name and fields, buffers as bytes, containers element by
    element."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__, tuple(
            (f.name, plain(getattr(v, f.name)))
            for f in dataclasses.fields(v)))
    if isinstance(v, (bytes, bytearray, memoryview)):
        return ("bytes", bytes(v))
    if isinstance(v, np.ndarray):
        return ("bytes", v.tobytes())
    if isinstance(v, dict):
        return ("dict", tuple(sorted(
            ((plain(k), plain(x)) for k, x in v.items()), key=repr)))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(plain(x) for x in v))
    if hasattr(v, "__dict__") and not isinstance(v, type):
        return (type(v).__name__, tuple(sorted(
            (k, plain(x)) for k, x in vars(v).items())))
    return v


def by_name(samples: dict) -> dict:
    return {cls.__name__: msg for cls, msg in samples.items()}


REF_MSGS = by_name(ref_dencoder.message_samples())
PORT_MSGS = by_name(port_dencoder.message_samples())


def test_registries_list_the_same_types_in_the_same_order():
    """The frame's type id is the index in MESSAGE_TYPES: the port's list
    names the same classes in the same order, with the same fields."""
    assert [c.__name__ for c in port_wire.MESSAGE_TYPES] == MESSAGE_NAMES
    for ref, port in zip(ref_wire.MESSAGE_TYPES, port_wire.MESSAGE_TYPES):
        assert [f.name for f in dataclasses.fields(port)] == \
            [f.name for f in dataclasses.fields(ref)], ref.__name__
    assert len(MESSAGE_NAMES) == 47


@pytest.mark.parametrize("name", MESSAGE_NAMES)
def test_message_crosses_both_ways(name):
    ref_msg, port_msg = REF_MSGS[name], PORT_MSGS[name]
    assert plain(port_msg) == plain(ref_msg)
    ref_raw = ref_wire.encode_frame("mon.0", "osd.3", ref_msg)
    port_raw = port_wire.encode_frame("mon.0", "osd.3", port_msg)
    assert port_raw == ref_raw
    # the reference's bytes in the port, the port's in the reference
    src, dst, got = port_wire.decode_frame(ref_raw[4:])
    assert (src, dst) == ("mon.0", "osd.3")
    assert type(got) is type(port_msg)
    assert plain(got) == plain(ref_msg)
    assert port_wire.encode_frame(src, dst, got) == ref_raw
    src, dst, back = ref_wire.decode_frame(port_raw[4:])
    assert type(back).__name__ == name
    assert plain(back) == plain(port_msg)
    assert ref_wire.encode_frame(src, dst, back) == port_raw


@pytest.mark.parametrize("name", STRUCT_NAMES)
def test_struct_crosses_both_ways(name):
    ref_obj, ref_dec = ref_dencoder.struct_samples()[name]
    port_obj, port_dec = port_dencoder.struct_samples()[name]
    raw = ref_obj.encode_bytes()
    assert port_obj.encode_bytes() == raw
    got = port_dec(raw)
    assert plain(got) == plain(port_obj)
    assert got.encode_bytes() == raw
    back = ref_dec(port_obj.encode_bytes())
    assert plain(back) == plain(ref_obj)
    assert back.encode_bytes() == raw


def test_port_samples_are_the_references_less_the_pending_structs():
    assert set(PORT_MSGS) == set(REF_MSGS)
    ref_structs = set(ref_dencoder.struct_samples())
    assert set(STRUCT_NAMES) == ref_structs
    assert not hasattr(port_dencoder, "PENDING")
    assert {"ImageHeader", "SnapRecord"} <= set(STRUCT_NAMES)


def test_corpus_checks_55_files_and_none_pending():
    """The port replays every archived file the reference replays, the
    two structs of services.rbd among them, and skips none;
    the reference passes the same corpus."""
    assert ref_dencoder.check(CORPUS) == []
    report = port_dencoder.check(CORPUS)
    assert report.problems == []
    assert len(report.checked) == 55
    for name in ("struct_LogEntry.bin", "struct_SnapRecord.bin",
                 "struct_ImageHeader.bin"):
        assert name in report.checked
    assert sorted(report.checked) == sorted(os.listdir(CORPUS))


def test_corpus_check_cli_prints_an_empty_pending_list(capsys,
                                                       monkeypatch):
    monkeypatch.setattr("sys.argv", ["dencoder", "--check",
                                     "--base", CORPUS])
    assert port_dencoder.main() == 0
    out = capsys.readouterr().out
    assert "PENDING" not in out
    assert "struct_LogEntry.bin" not in out
    assert "55 blobs checked)" in out


class _Sink:
    """A Dispatcher of either package that keeps what it receives."""

    def __init__(self, messenger_mod):
        outer = self
        self.got = []
        self.event = threading.Event()

        class Sink(messenger_mod.Dispatcher):
            def ms_dispatch(self, conn, msg):
                outer.got.append(msg)
                outer.event.set()
                return True

        self.dispatcher = Sink()


@pytest.mark.parametrize("secure", [False, True], ids=["auth", "secure"])
@pytest.mark.parametrize("src,dst", [("ref", "port"), ("port", "ref")],
                         ids=["ref-to-port", "port-to-ref"])
def test_tcp_messengers_talk_across_the_packages(src, dst, secure):
    """A messenger of one package sends over TCP on loopback to a
    messenger of the other (the handshake, the frame MAC and, in secure
    mode, the ChaCha20 stream): every canonical message arrives with its
    fields."""
    mods = {"ref": (ref_messenger, ref_tcp, REF_MSGS),
            "port": (port_messenger, port_tcp, PORT_MSGS)}
    secret = b"k" * 32
    nets = {side: mods[side][1].TcpNetwork(auth_secret=secret,
                                           secure=secure)
            for side in (src, dst)}
    tx = mods[src][0].Messenger(nets[src], "mon.0",
                                mods[src][0].Policy.lossless_peer())
    rx = mods[dst][0].Messenger(nets[dst], "osd.0",
                                mods[dst][0].Policy.lossless_peer())
    sink = _Sink(mods[dst][0])
    rx.add_dispatcher(sink.dispatcher)
    try:
        tx.start()
        rx.start()
        nets[src].set_addr("osd.0", nets[dst].addr_of("osd.0"))
        names = ["MOSDBoot", "MMapPush", "MMonCommand", "MAuth",
                 "MSubWrite", "MPGPush"]
        for name in names:
            assert tx.send_message("osd.0", mods[src][2][name])
        deadline = time.monotonic() + 60
        while len(sink.got) < len(names) and time.monotonic() < deadline:
            sink.event.wait(1)
            sink.event.clear()
        assert [type(m).__name__ for m in sink.got] == names
        for name, msg in zip(names, sink.got):
            assert plain(msg) == plain(mods[src][2][name])
    finally:
        tx.shutdown()
        rx.shutdown()
        for net in nets.values():
            net.stop()


def test_both_packages_pin_buffers_in_one_process():
    """Each package's messenger stack pins buffers for zero-copy sends
    in one process with the other: the port calls the buffer protocol
    through function objects of its own, not the process-wide ones of
    ctypes.pythonapi, whose argtypes the JAX package's stack sets to its
    own struct."""
    data = memoryview(bytearray(b"0123456789"))[2:]
    for stack in (ref_stack, port_stack):
        pin = stack._Pin(data, writable=True)
        assert pin.nbytes == 8
        pin.release()
    assert port_stack._GetBuffer is not \
        ctypes.pythonapi.PyObject_GetBuffer
