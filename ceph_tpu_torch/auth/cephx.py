"""cephx-shaped authentication: entity keys, mon-issued tickets, proofs.

The reference's cephx is a KDC: the monitor cluster stores one secret
per named entity (client.foo, osd.0 — AuthMonitor, ref
src/mon/AuthMonitor.h:35) plus rotating per-service secrets (ref
src/auth/cephx/CephxKeyServer.h:165); a client proves knowledge of its
entity key to the mon and receives TIME-LIMITED tickets — one per
service — each carrying the entity's capability string, signed under
the service's current rotating key, together with a session key sealed
under the entity key.  A daemon verifies a ticket with nothing but its
own service secret (no mon round-trip), derives the same session key,
and checks a per-op proof, so possession of a ticket blob alone
(sniffed, replayed) authorizes nothing.

Redesigns vs the reference, documented: HMAC-SHA256 everywhere instead
of AES-CBC ceph_secret encryption (same trust structure, modern
primitive); the auth handshake is one round trip (client sends a
nonce+timestamp proof) instead of cephx's server-challenge exchange —
replaying the request is harmless because the reply's session keys are
sealed under the entity key the attacker lacks; rotation generations
are derived from the service base secret by epoch number (the
rotating-secrets window of msg/tcp.py) rather than mon-pushed, which
bounds ticket lifetime identically but cannot survive base-secret
compromise (noted in msg/tcp.py:252 as well).
"""

from __future__ import annotations

import hashlib
import hmac
import json as _json
import secrets as _secrets
import time
from dataclasses import dataclass, field

from ..utils.codec import Decoder, Encodable, Encoder
from .caps import Caps, CapsError

DEFAULT_TTL = 3600.0       # auth_service_ticket_ttl role
MAX_CLOCK_SKEW = 300.0     # auth request timestamp window


def _mac(key: bytes, *parts: bytes) -> bytes:
    msg = b"".join(len(p).to_bytes(4, "little") + p for p in parts)
    return hmac.new(key, msg, hashlib.sha256).digest()


def _canon(*fields) -> bytes:
    """Length-prefixed canonical bytes of mixed fields (no ambiguity
    between ("ab","c") and ("a","bc"))."""
    out = bytearray()
    for f in fields:
        if isinstance(f, int):
            b = f.to_bytes(8, "little", signed=True)
        elif isinstance(f, str):
            b = f.encode()
        else:
            b = bytes(f)
        out += len(b).to_bytes(4, "little") + b
    return bytes(out)


def service_key(base_secret: bytes, service: str, gen: int) -> bytes:
    """The per-generation rotating service secret."""
    return _mac(base_secret, b"svc", service.encode(),
                gen.to_bytes(8, "little"))


def _session_key(svc_key: bytes, nonce: bytes, entity: str) -> bytes:
    return _mac(svc_key, b"sess", nonce, entity.encode())


def _seal(session_key: bytes, entity_key: bytes, nonce: bytes) -> bytes:
    """Seal/unseal (XOR one-time pad under an entity-key-derived wrap
    key; each nonce is fresh-random so the pad never repeats)."""
    pad = _mac(entity_key, b"wrap", nonce)
    return bytes(a ^ b for a, b in zip(session_key, pad))


def op_proof(session_key: bytes, *fields) -> bytes:
    """16-byte proof binding one op's identity-relevant fields to the
    ticket's session key."""
    return _mac(session_key, b"op", _canon(*fields))[:16]


def auth_request_proof(entity_key: bytes, entity: str, nonce: bytes,
                       ts_ms: int, services: list) -> bytes:
    return _mac(entity_key, b"authreq",
                _canon(entity, nonce, ts_ms, *sorted(services)))


def canonical_command(cmd: dict) -> bytes:
    """Deterministic bytes of a mon command dict, identical on the
    signing client and the verifying mon regardless of dict order."""
    return _json.dumps(cmd, sort_keys=True, separators=(",", ":"),
                       default=str).encode()


@dataclass
class Ticket(Encodable):
    """One service ticket (CephXTicketBlob role): who, for which
    service, with what caps, until when — signed by the service key of
    generation `gen` so the daemon alone can verify it."""

    entity: str
    service: str
    caps_text: str
    valid_until_ms: int
    gen: int
    nonce: bytes
    sig: bytes = b""

    VERSION, COMPAT = 1, 1

    def payload(self) -> bytes:
        return _canon(self.entity, self.service, self.caps_text,
                      self.valid_until_ms, self.gen, self.nonce)

    def encode(self, enc: Encoder) -> None:
        def body(e):
            e.string(self.entity); e.string(self.service)
            e.string(self.caps_text); e.u64(self.valid_until_ms)
            e.u64(self.gen); e.blob(self.nonce); e.blob(self.sig)
        enc.versioned(self.VERSION, self.COMPAT, body)

    @classmethod
    def decode(cls, dec: Decoder) -> "Ticket":
        def body(d, v):
            return cls(d.string(), d.string(), d.string(), d.u64(),
                       d.u64(), d.blob(), d.blob())
        return dec.versioned(cls.VERSION, body)


@dataclass
class VerifiedTicket:
    entity: str
    caps: Caps
    session_key: bytes
    valid_until: float
    gen: int = 0


class KeyServer:
    """Mon-side entity/key database + ticket mint (AuthMonitor +
    CephxKeyServer roles).  The entity table replicates through the
    mon's paxos store (key "authdb"); service base secrets are
    provisioned identically to every mon/daemon at deploy time (the
    keyring-file role) and never cross the wire."""

    def __init__(self, service_secrets: dict[str, bytes],
                 rotation: float = 0.0, ttl: float = DEFAULT_TTL,
                 clock=time.time):
        self.service_secrets = dict(service_secrets)
        self.rotation = float(rotation)
        self.ttl = float(ttl)
        self.clock = clock
        # entity -> {"key": bytes, "caps": {service: caps_text}}
        self.entities: dict[str, dict] = {}

    # -- rotation ----------------------------------------------------------
    def generation(self, now: float | None = None) -> int:
        if self.rotation <= 0:
            return 0
        return int((self.clock() if now is None else now)
                   // self.rotation)

    # -- entity table ------------------------------------------------------
    def add(self, name: str, caps: dict[str, str],
            key: bytes | None = None) -> bytes:
        for svc, text in caps.items():
            if svc not in self.service_secrets and svc != "mon":
                raise CapsError(f"unknown service {svc!r}")
            Caps.parse(text)  # fail closed on a typo'd cap NOW
        ent = self.entities.get(name)
        if ent is None:
            ent = {"key": key or _secrets.token_bytes(32), "caps": {}}
            self.entities[name] = ent
        elif key is not None and key != ent["key"]:
            raise CapsError(f"entity {name!r} exists with another key")
        ent["caps"] = dict(caps)
        return ent["key"]

    def get_or_create(self, name: str,
                      caps: dict[str, str] | None = None) -> bytes:
        ent = self.entities.get(name)
        if ent is not None and caps is None:
            return ent["key"]
        return self.add(name, caps if caps is not None
                        else (ent["caps"] if ent else {}))

    def remove(self, name: str) -> bool:
        return self.entities.pop(name, None) is not None

    def list_entities(self) -> dict:
        return {name: {"caps": dict(ent["caps"])}
                for name, ent in sorted(self.entities.items())}

    # -- replication (paxos "authdb" value) --------------------------------
    def encode_db(self) -> bytes:
        enc = Encoder()

        def body(e):
            e.u32(len(self.entities))
            for name, ent in sorted(self.entities.items()):
                e.string(name); e.blob(ent["key"])
                e.u32(len(ent["caps"]))
                for svc, text in sorted(ent["caps"].items()):
                    e.string(svc); e.string(text)
        enc.versioned(1, 1, body)
        return enc.tobytes()

    def load_db(self, raw: bytes) -> None:
        dec = Decoder(raw)

        def body(d, v):
            ents = {}
            for _ in range(d.u32()):
                name, key = d.string(), d.blob()
                caps = {}
                for _ in range(d.u32()):
                    svc = d.string()
                    caps[svc] = d.string()
                ents[name] = {"key": key, "caps": caps}
            return ents
        self.entities = dec.versioned(1, body)

    # -- the mint ----------------------------------------------------------
    def verify_request(self, entity: str, nonce: bytes, ts_ms: int,
                       services: list, proof: bytes) -> bool:
        ent = self.entities.get(entity)
        if ent is None:
            return False
        if abs(self.clock() - ts_ms / 1000.0) > MAX_CLOCK_SKEW:
            return False
        want = auth_request_proof(ent["key"], entity, nonce, ts_ms,
                                  services)
        return hmac.compare_digest(proof, want)

    def issue(self, entity: str, service: str) -> tuple | None:
        """(ticket_blob, sealed_session_key, nonce) for one service, or
        None if the entity has no caps there."""
        ent = self.entities.get(entity)
        if ent is None:
            return None
        caps_text = ent["caps"].get(service)
        if caps_text is None:
            return None
        base = self.service_secrets.get(service)
        if base is None:
            return None
        now = self.clock()
        gen = self.generation(now)
        nonce = _secrets.token_bytes(16)
        t = Ticket(entity, service, caps_text,
                   int((now + self.ttl) * 1000), gen, nonce)
        skey = service_key(base, service, gen)
        t.sig = _mac(skey, b"tkt", t.payload())
        session = _session_key(skey, nonce, entity)
        return t.encode_bytes(), _seal(session, ent["key"], nonce), nonce


class ServiceVerifier:
    """Daemon-side ticket gate: verifies tickets with only this
    service's base secret (current generation +- one, the rotating
    window), caches verified tickets by signature, and re-derives the
    session key for per-op proof checks."""

    CACHE_MAX = 4096

    def __init__(self, service: str, base_secret: bytes,
                 rotation: float = 0.0, clock=time.time):
        self.service = service
        self.base_secret = base_secret
        self.rotation = float(rotation)
        self.clock = clock
        self._cache: dict[bytes, VerifiedTicket] = {}

    def _generation(self) -> int:
        if self.rotation <= 0:
            return 0
        return int(self.clock() // self.rotation)

    def verify(self, blob: bytes) -> VerifiedTicket | None:
        vt = self._cache.get(blob[-48:] if len(blob) > 48 else blob)
        if vt is None:
            vt = self._verify_slow(blob)
            if vt is None:
                return None
            if len(self._cache) >= self.CACHE_MAX:
                self._cache.clear()
            self._cache[blob[-48:] if len(blob) > 48 else blob] = vt
        if self.clock() > vt.valid_until:
            return None  # expired: renewal forced
        if self.rotation > 0 and abs(vt.gen - self._generation()) > 1:
            return None  # generation aged out of the rotating window
        return vt

    def _verify_slow(self, blob: bytes) -> VerifiedTicket | None:
        try:
            t = Ticket.decode_bytes(blob)
        except Exception:  # noqa: BLE001 - malformed blob fails closed
            return None
        if t.service != self.service:
            return None
        if self.rotation > 0 and abs(t.gen - self._generation()) > 1:
            return None
        if self.rotation <= 0 and t.gen != 0:
            return None
        skey = service_key(self.base_secret, self.service, t.gen)
        if not hmac.compare_digest(t.sig, _mac(skey, b"tkt",
                                               t.payload())):
            return None
        try:
            caps = Caps.parse(t.caps_text)
        except CapsError:
            return None
        return VerifiedTicket(t.entity, caps,
                              _session_key(skey, t.nonce, t.entity),
                              t.valid_until_ms / 1000.0, t.gen)


@dataclass
class AuthContext:
    """Client-side identity: the entity name + key, and the live
    tickets obtained from the mon (CephXTicketManager role)."""

    entity: str
    key: bytes
    # service -> (ticket_blob, session_key, valid_until_s)
    tickets: dict = field(default_factory=dict)
    RENEW_MARGIN = 0.25  # renew when <25% of the ttl remains

    def build_request(self, services: list, clock=time.time) -> tuple:
        nonce = _secrets.token_bytes(16)
        ts_ms = int(clock() * 1000)
        proof = auth_request_proof(self.key, self.entity, nonce, ts_ms,
                                   services)
        return nonce, ts_ms, proof

    def accept(self, service: str, blob: bytes, sealed: bytes,
               nonce: bytes) -> None:
        t = Ticket.decode_bytes(blob)
        session = _seal(sealed, self.key, nonce)  # XOR unseal
        self.tickets[service] = (blob, session,
                                 t.valid_until_ms / 1000.0)

    def ticket_for(self, service: str,
                   clock=time.time) -> tuple | None:
        """(blob, session_key) if a fresh-enough ticket is cached,
        else None (caller must renew)."""
        ent = self.tickets.get(service)
        if ent is None:
            return None
        blob, session, valid_until = ent
        if clock() >= valid_until:
            return None
        return blob, session

    def needs_renewal(self, service: str, ttl: float,
                      clock=time.time) -> bool:
        ent = self.tickets.get(service)
        if ent is None:
            return True
        return ent[2] - clock() < ttl * self.RENEW_MARGIN
