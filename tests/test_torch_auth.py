"""cephx authorization on the port: caps grammar and tickets (the JAX
package's tests/test_auth.py on ceph_tpu_torch, less its cluster cases,
which wait for the port's OSDs and client), and tickets and the entity
table crossing between the two packages.

The reference's model (src/mon/AuthMonitor.h:35,
src/auth/cephx/CephxKeyServer.h:165, OSDCap checks in src/osd/OSD.cc):
per-entity keys live at the mon, clients obtain time-limited service
tickets carrying their capability string, and daemons enforce those
caps at op ingress with no mon round-trip.
"""

import time

import pytest

import ceph_tpu.auth.cephx as ref_cephx
import ceph_tpu_torch.auth.cephx as port_cephx
from ceph_tpu_torch.auth.caps import Caps, CapsError
from ceph_tpu_torch.auth.cephx import (AuthContext, KeyServer,
                                       ServiceVerifier, Ticket, op_proof)


# ---------------------------------------------------------------- caps unit
def test_caps_parse_and_match():
    c = Caps.parse("allow rw pool=alpha, allow r")
    assert c.allows("r")                      # bare grant, any pool
    assert c.allows("rw", pool="alpha")
    assert not c.allows("w", pool="beta")     # rw grant is alpha-only
    assert c.allows("r", pool="beta")
    assert not c.allows("x", pool="alpha")


def test_caps_star_and_union():
    assert Caps.parse("allow *").allows("rwx", pool="anything")
    # bits accumulate across matching grants (OSDCap::is_capable)
    c = Caps.parse("allow r pool=p, allow w pool=p")
    assert c.allows("rw", pool="p")
    assert not c.allows("rw", pool="q")


def test_caps_path_prefix():
    c = Caps.parse("allow rw path=/home/a")
    assert c.allows("rw", path="/home/a")
    assert c.allows("rw", path="/home/a/deep/file")
    assert not c.allows("rw", path="/home/ab")   # component boundary
    assert not c.allows("r", path="/home")


@pytest.mark.parametrize("bad", [
    "deny r", "allow", "allow q", "allow rw pool=", "allow rw disk=x",
    "", "allow rw,", "allow *x"])
def test_caps_rejects_malformed(bad):
    with pytest.raises(CapsError):
        Caps.parse(bad)


# ------------------------------------------------------------- tickets unit
def _ks(clock, rotation=0.0, ttl=60.0):
    return KeyServer({"mon": b"M" * 32, "osd": b"O" * 32},
                     rotation=rotation, ttl=ttl, clock=clock)


def test_ticket_issue_verify_roundtrip():
    now = [1000.0]
    ks = _ks(lambda: now[0])
    key = ks.add("client.a", {"osd": "allow rw pool=p"})
    blob, sealed, nonce = ks.issue("client.a", "osd")
    ver = ServiceVerifier("osd", b"O" * 32, clock=lambda: now[0])
    vt = ver.verify(blob)
    assert vt is not None and vt.entity == "client.a"
    assert vt.caps.allows("rw", pool="p")
    # the client unseals the same session key the daemon derives
    ctx = AuthContext("client.a", key)
    ctx.accept("osd", blob, sealed, nonce)
    _, session = ctx.ticket_for("osd", clock=lambda: now[0])
    assert session == vt.session_key
    # per-op proof binds the op fields
    proof = op_proof(session, 7, 1, "oid", "write", 0, 3, b"abc")
    assert proof == op_proof(vt.session_key, 7, 1, "oid", "write",
                             0, 3, b"abc")
    assert proof != op_proof(vt.session_key, 7, 1, "oid", "write",
                             0, 3, b"abd")


def test_ticket_expiry_and_tamper():
    now = [1000.0]
    ks = _ks(lambda: now[0], ttl=10.0)
    ks.add("client.a", {"osd": "allow *"})
    blob, _, _ = ks.issue("client.a", "osd")
    ver = ServiceVerifier("osd", b"O" * 32, clock=lambda: now[0])
    assert ver.verify(blob) is not None
    now[0] += 11.0
    assert ver.verify(blob) is None          # expired, even if cached
    now[0] -= 11.0
    assert ver.verify(bytes([blob[0]]) + blob[1:-1] +
                      bytes([blob[-1] ^ 1])) is None  # bit-flipped sig
    assert ver.verify(b"junk") is None
    # a ticket for another service never verifies here
    mon_blob, _, _ = ks.issue("client.a", "osd")
    assert ServiceVerifier("mon", b"M" * 32).verify(mon_blob) is None


def test_ticket_rotation_window():
    now = [10_000.0]
    ks = _ks(lambda: now[0], rotation=100.0, ttl=1000.0)
    ks.add("client.a", {"osd": "allow *"})
    blob, _, _ = ks.issue("client.a", "osd")
    ver = ServiceVerifier("osd", b"O" * 32, rotation=100.0,
                          clock=lambda: now[0])
    assert ver.verify(blob) is not None
    now[0] += 100.0          # one generation later: grace window holds
    assert ver.verify(blob) is not None
    now[0] += 200.0          # beyond current+-1: refused despite ttl
    assert ver.verify(blob) is None


def test_entity_table_replication_bytes():
    ks = _ks(time.time)
    ks.add("client.a", {"osd": "allow rw pool=p"}, key=b"k" * 32)
    ks.add("osd.0", {"mon": "allow r"})
    raw = ks.encode_db()
    ks2 = _ks(time.time)
    ks2.load_db(raw)
    assert ks2.entities == ks.entities


# ----------------------------------------------------- across the packages
@pytest.mark.parametrize("issuer,verifier", [(ref_cephx, port_cephx),
                                             (port_cephx, ref_cephx)],
                         ids=["ref-to-port", "port-to-ref"])
def test_tickets_cross_both_ways(issuer, verifier):
    """A ticket one package's KeyServer issues verifies at the other's
    daemon, and the other's client unseals the same session key."""
    now = [5000.0]

    def clock():
        return now[0]

    ks = issuer.KeyServer({"mon": b"M" * 32, "osd": b"O" * 32}, ttl=60.0,
                          clock=clock)
    key = ks.add("client.a", {"osd": "allow rw pool=p"}, key=b"k" * 32)
    blob, sealed, nonce = ks.issue("client.a", "osd")
    vt = verifier.ServiceVerifier("osd", b"O" * 32, clock=clock).verify(
        blob)
    assert vt is not None and vt.entity == "client.a"
    assert vt.caps.allows("rw", pool="p")
    assert not vt.caps.allows("w", pool="q")
    ctx = verifier.AuthContext("client.a", key)
    ctx.accept("osd", blob, sealed, nonce)
    assert ctx.ticket_for("osd", clock=clock)[1] == vt.session_key
    assert verifier.op_proof(vt.session_key, 7, 1, "oid", "write", 0, 3,
                             b"abc") == issuer.op_proof(
        vt.session_key, 7, 1, "oid", "write", 0, 3, b"abc")
    now[0] += 61.0
    assert verifier.ServiceVerifier("osd", b"O" * 32,
                                    clock=clock).verify(blob) is None


def test_entity_table_crosses_both_ways():
    ref = ref_cephx.KeyServer({"mon": b"M" * 32, "osd": b"O" * 32})
    port = KeyServer({"mon": b"M" * 32, "osd": b"O" * 32})
    for ks in (ref, port):
        ks.add("client.a", {"osd": "allow rw pool=p"}, key=b"k" * 32)
        ks.add("osd.0", {"mon": "allow r"}, key=b"o" * 32)
    assert port.encode_db() == ref.encode_db()
    back = ref_cephx.KeyServer({"mon": b"M" * 32, "osd": b"O" * 32})
    back.load_db(port.encode_db())
    assert back.entities == port.entities
    got = KeyServer({"mon": b"M" * 32, "osd": b"O" * 32})
    got.load_db(ref.encode_db())
    assert got.entities == ref.entities
    t = Ticket("client.a", "osd", "allow rw pool=p", 1234567890123, 5,
               b"n" * 16, b"s" * 32)
    assert ref_cephx.Ticket.decode_bytes(t.encode_bytes()).encode_bytes() \
        == t.encode_bytes()
