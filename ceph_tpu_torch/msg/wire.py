"""Generic message wire format for real transports.

The role of the reference's src/messages/ encode/decode bodies +
msgr frame assembly (frames_v2.h): every message dataclass serializes
through the versioned codec so it can cross a process/host boundary.
Wire-critical types keep their hand-written codecs (versioned field
layout, MOSDOp etc.); everything else rides a generic tagged-value body
derived from the dataclass fields, wrapped in a versioned section so
fields can be appended compatibly (skip-unknown-tail).

Frame layout on a stream (the frame_message contract):

    [u32 frame_len][string src][string dst][u16 type_id][body bytes]

`src` lets the receiving endpoint learn reply routes (the Connection
identity of AsyncMessenger: you answer on the pipe the request came in
on); `dst` routes frames when one socket serves several entities.

Zero-copy wire path (the bufferlist discipline): `frame_encoder`
returns the frame as a SEGMENTED Encoder — large data payloads ride as
referenced segments, never copied into the stream — so the transport
can `sendmsg` the segment list straight from the submitter's buffers.
`decode_frame(payload, carve_min=N)` carves large blob fields as
read-only memoryviews over the one received frame buffer (skip-copy
decode).  Frame BYTES are unchanged either way: `encode_frame` (the
assembling face) and `b"".join(frame_encoder(...).segments())` produce
identical layouts, which the archived corpus_wire/ gate pins.
"""

from __future__ import annotations

import dataclasses
import struct

from ..utils.codec import CodecError, Decoder, Encoder
from . import messages as M

# ---------------------------------------------------------------------------
# Tagged values: the closed vocabulary every message field fits in.
# ---------------------------------------------------------------------------

_T_NONE, _T_FALSE, _T_TRUE, _T_INT, _T_FLOAT = 0, 1, 2, 3, 4
_T_STR, _T_BYTES, _T_LIST, _T_TUPLE, _T_DICT, _T_PGID = 5, 6, 7, 8, 9, 10


def encode_value(enc: Encoder, v) -> None:
    if v is None:
        enc.u8(_T_NONE)
    elif v is True:
        enc.u8(_T_TRUE)
    elif v is False:
        enc.u8(_T_FALSE)
    elif isinstance(v, int):
        enc.u8(_T_INT)
        enc.i64(v)
    elif isinstance(v, float):
        enc.u8(_T_FLOAT)
        enc.f64(v)
    elif isinstance(v, str):
        enc.u8(_T_STR)
        enc.string(v)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        enc.u8(_T_BYTES)
        enc.blob(v)  # large blobs ride by reference (Encoder.blob)
    elif isinstance(v, M.PgId):
        enc.u8(_T_PGID)
        enc.u64(v.pool)
        enc.u64(v.seed)
    elif isinstance(v, tuple):
        enc.u8(_T_TUPLE)
        enc.seq(v, encode_value)
    elif isinstance(v, (list, set, frozenset)):
        enc.u8(_T_LIST)
        enc.seq(list(v), encode_value)
    elif isinstance(v, dict):
        enc.u8(_T_DICT)
        enc.u32(len(v))
        for k, val in v.items():
            encode_value(enc, k)
            encode_value(enc, val)
    else:
        raise CodecError(f"unencodable wire value {type(v).__name__}")


def decode_value(dec: Decoder):
    tag = dec.u8()
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return dec.i64()
    if tag == _T_FLOAT:
        return dec.f64()
    if tag == _T_STR:
        return dec.string()
    if tag == _T_BYTES:
        return dec.blob()
    if tag == _T_PGID:
        return M.PgId(dec.u64(), dec.u64())
    if tag == _T_TUPLE:
        return tuple(dec.seq(decode_value))
    if tag == _T_LIST:
        return dec.seq(decode_value)
    if tag == _T_DICT:
        out = {}
        for _ in range(dec.u32()):
            k = decode_value(dec)
            if isinstance(k, memoryview):
                # keys must stay hashable-by-value: a carved view over
                # a writable frame buffer is not — detach
                k = bytes(k)
            out[k] = decode_value(dec)
        return out
    raise CodecError(f"bad wire value tag {tag}")


# ---------------------------------------------------------------------------
# Message registry: stable ids (append-only — never renumber).
# ---------------------------------------------------------------------------

MESSAGE_TYPES: list[type] = [
    M.MOSDOp, M.MOSDOpReply,                      # 1, 2 (hand codecs)
    M.MSubWrite, M.MSubPartialWrite, M.MSubDelta,  # 3-5
    M.MSubWriteReply, M.MSubRead, M.MSubReadReply,  # 6-8
    M.MOSDPing, M.MOSDPingReply, M.MFailureReport,  # 9-11
    M.MMapPush, M.MMonSubscribe, M.MOSDBoot,        # 12-14
    M.MMonCommand, M.MMonCommandReply,              # 15-16
    M.MPGQuery, M.MPGInfo, M.MPGPull, M.MPGPush,    # 17-20
    M.MStatsReport,                                 # 21
    M.MScrubRequest, M.MScrubShard, M.MScrubMap, M.MScrubResult,  # 22-25
    M.MMonPing, M.MMonElect, M.MMonVote, M.MMonClaim,             # 26-29
    M.MMonPropose, M.MMonPropAck, M.MMonSyncReq,                  # 30-32
    M.MMonSyncEntries, M.MMonForward, M.MMonFwdReply,             # 33-35
    M.MPGRollback,                                                # 36
    M.MWatchNotify, M.MNotifyAck,                                 # 37-38
    M.MOSDPGTemp,                                                 # 39
    M.MRecoveryReserve,                                           # 40
    M.MAuth, M.MAuthReply,                                        # 41-42
    M.MPGList, M.MPGListReply,                                    # 43-44
    M.MSubReadN, M.MSubReadReplyN,                                # 45-46
    M.MLeaseRegister,                                             # 47
]
_TYPE_IDS = {t: i + 1 for i, t in enumerate(MESSAGE_TYPES)}
_ID_TYPES = {i: t for t, i in _TYPE_IDS.items()}

_GENERIC_VERSION = 1


def _encode_body(enc: Encoder, msg) -> None:
    cls = type(msg)
    if hasattr(cls, "VERSION") and hasattr(msg, "encode"):
        msg.encode(enc)  # hand-written versioned codec
        return

    def body(e: Encoder):
        fields = dataclasses.fields(msg)
        e.u32(len(fields))
        for f in fields:
            encode_value(e, getattr(msg, f.name))

    enc.versioned(_GENERIC_VERSION, 1, body)


def _decode_body(dec: Decoder, cls):
    if hasattr(cls, "VERSION") and hasattr(cls, "decode"):
        return cls.decode(dec)

    def body(d: Decoder, version: int):
        n = d.u32()
        values = [decode_value(d) for _ in range(n)]
        fields = dataclasses.fields(cls)
        # forward compat: ignore extra trailing fields from a newer
        # sender; let defaults cover fields a newer receiver grew
        return cls(*values[: len(fields)])

    return dec.versioned(_GENERIC_VERSION, body)


def pack_value(value) -> bytes:
    """One tagged value as bytes (the shared serialization helper for
    op payloads, class IO, and client APIs)."""
    e = Encoder()
    encode_value(e, value)
    return e.tobytes()


def unpack_value(raw: bytes):
    return decode_value(Decoder(raw)) if raw else None


def frame_encoder(src: str, dst: str, msg) -> Encoder:
    """The frame body [src][dst][type_id][body] WITHOUT the u32 length
    prefix, as a segmented Encoder: the transport streams
    ``enc.segments()`` via vectored IO (data payloads never flatten
    Python-side) or assembles with ``enc.tobytes()`` when it must
    (seal/encrypt, compression).  dst rides the frame because one
    socket can serve several local entities (shared outgoing pipes,
    learned reply routes)."""
    e = Encoder()
    e.string(src)
    e.string(dst)
    tid = _TYPE_IDS.get(type(msg))
    if tid is None:
        raise CodecError(f"unregistered message type {type(msg).__name__}")
    e.u16(tid)
    _encode_body(e, msg)
    return e


def encode_frame(src: str, dst: str, msg) -> bytes:
    """Full stream frame as contiguous bytes: length-prefixed
    [src][dst][type_id][body] (the assembling face of frame_encoder,
    for corpus archiving and in-proc consumers)."""
    e = frame_encoder(src, dst, msg)
    payload = e.tobytes()
    return struct.pack("<I", len(payload)) + payload


def decode_frame(payload, carve_min: int = 0):
    """payload (after the u32 length prefix) -> (src, dst, message).
    ``carve_min > 0`` enables carve-on-decode: data blob fields at or
    above that size come back as read-only memoryviews over
    ``payload`` (which the caller must never reuse/mutate — the
    transport hands a fresh refcount-pinned buffer per carved frame;
    see msg/README.md for the ownership contract)."""
    d = Decoder(payload, carve_min=carve_min)
    src = d.string()
    dst = d.string()
    cls = _ID_TYPES.get(d.u16())
    if cls is None:
        raise CodecError("unknown message type id")
    return src, dst, _decode_body(d, cls)
