"""Capability strings: what an authenticated entity may DO.

The role of the reference's cap grammars (src/osd/OSDCap.h `allow rwx
pool=foo`, src/mon/MonCap.h, src/mds/MDSAuthCaps.h `allow rw path=/dir`):
a cap string is a comma-separated list of grants; each grant allows a
set of permission bits, optionally restricted to one pool (OSD) or one
path prefix (MDS).  Permission bits accumulate across every grant whose
restriction matches the resource (OSDCap::is_capable semantics: the
union of matching grants must cover the requested access).

Bits: r (read), w (write), x (execute: object-class calls / admin
verbs), or `*` (all three).  Grammar:

    caps   := grant ("," grant)*
    grant  := "allow" spec
    spec   := "*" | perms restriction*
    perms  := subset of "rwx" in any order
    restriction := "pool=" name | "path=" prefix

Parsing is strict — an unknown token raises CapsError so a typo'd cap
fails closed at `auth get-or-create` time, not silently at enforcement
time.
"""

from __future__ import annotations

from dataclasses import dataclass, field

ALL_BITS = frozenset("rwx")


class CapsError(ValueError):
    pass


@dataclass(frozen=True)
class Grant:
    bits: frozenset
    pool: str | None = None
    path: str | None = None

    def matches(self, pool: str | None, path: str | None) -> bool:
        if self.pool is not None and pool != self.pool:
            return False
        if self.path is not None:
            if path is None:
                return False
            # prefix match on path components ("/a" covers "/a/b",
            # not "/ab") — MDSAuthCaps path semantics
            p = self.path.rstrip("/") or "/"
            got = path.rstrip("/") or "/"
            if got != p and not got.startswith(p.rstrip("/") + "/"):
                return False
        return True


@dataclass(frozen=True)
class Caps:
    grants: tuple = field(default_factory=tuple)

    @classmethod
    def parse(cls, text: str) -> "Caps":
        grants = []
        for part in text.split(","):
            toks = part.split()
            if not toks:
                raise CapsError(f"empty grant in {text!r}")
            if toks[0] != "allow":
                raise CapsError(f"grant must start with 'allow': {part!r}")
            if len(toks) < 2:
                raise CapsError(f"grant has no permissions: {part!r}")
            perms = toks[1]
            if perms == "*":
                bits = ALL_BITS
            else:
                bad = set(perms) - ALL_BITS
                if bad or not perms:
                    raise CapsError(f"bad permission bits {perms!r}")
                bits = frozenset(perms)
            pool = path = None
            for tok in toks[2:]:
                if tok.startswith("pool="):
                    pool = tok[len("pool="):]
                elif tok.startswith("path="):
                    path = tok[len("path="):]
                else:
                    raise CapsError(f"unknown restriction {tok!r}")
                if not (pool if tok.startswith("pool=") else path):
                    raise CapsError(f"empty restriction {tok!r}")
            grants.append(Grant(bits, pool, path))
        return cls(tuple(grants))

    def allows(self, need: str, pool: str | None = None,
               path: str | None = None) -> bool:
        """True iff the union of matching grants covers every bit of
        `need` for the given resource."""
        have: set = set()
        for g in self.grants:
            if g.matches(pool, path):
                have |= g.bits
        return set(need) <= have

    def __str__(self) -> str:
        out = []
        for g in self.grants:
            bits = "*" if g.bits == ALL_BITS else \
                "".join(b for b in "rwx" if b in g.bits)
            s = f"allow {bits}"
            if g.pool is not None:
                s += f" pool={g.pool}"
            if g.path is not None:
                s += f" path={g.path}"
            out.append(s)
        return ", ".join(out)
