"""Past intervals: the membership history a PG peers against.

The capability of the reference's interval machinery
(src/osd/PeeringState.h:460+ statechart prior-set construction,
src/osd/osd_types.h PastIntervals): every time a PG's up set or
primary changes across map epochs, the closed interval is recorded
durably with the PG's metadata.  A freshly-(re)promoted primary then
knows WHO might have served writes while it was away and must be
queried (or waited for) before the PG serves IO — current up members
alone are not enough, because an OSD that held the PG in a prior
interval may carry committed writes every current member missed.

Shape differences from the reference are deliberate: intervals live in
the same meta-object omap as the PGLog (one durability domain per PG),
and `maybe_went_active` is approximated by "had a primary" — the
min_size refinement rides on the primary's own last-epoch-started
fence, checked at query time.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.codec import Decoder, Encoder

# omap keys on the PG meta object (shared with PGLog's entries + "_lc")
INTERVALS_KEY = "_intervals"
LES_KEY = "_les"  # last epoch started: peering-complete fence


@dataclass
class Interval:
    first: int          # first map epoch of the interval
    last: int           # last map epoch (inclusive)
    up: list            # up set (may contain None holes)
    primary: int | None

    def maybe_went_active(self) -> bool:
        """Could writes have been served in this interval?  Without a
        primary nothing was served (PastIntervals::check_new_interval's
        acting-nonempty test, simplified)."""
        return self.primary is not None


@dataclass
class PastIntervals:
    """Closed intervals (oldest first) + the currently-open one."""

    intervals: list[Interval] = field(default_factory=list)
    cur_first: int = 0           # first epoch of the open interval
    cur_up: list = field(default_factory=list)
    cur_primary: int | None = None

    KEEP = 64  # bounded history (pruned by last-epoch-started anyway)

    # -- maintenance -------------------------------------------------------
    def note(self, epoch: int, up: list, primary: int | None) -> bool:
        """Observe the PG's membership at `epoch`.  Returns True when a
        new interval opened (the caller persists)."""
        up = list(up)
        if not self.cur_up and self.cur_primary is None \
                and self.cur_first == 0:
            self.cur_first, self.cur_up, self.cur_primary = \
                epoch, up, primary
            return True
        if up == self.cur_up and primary == self.cur_primary:
            return False
        self.intervals.append(Interval(self.cur_first, epoch - 1,
                                       self.cur_up, self.cur_primary))
        if len(self.intervals) > self.KEEP:
            self.intervals = self.intervals[-self.KEEP:]
        self.cur_first, self.cur_up, self.cur_primary = epoch, up, primary
        return True

    def trim_to(self, epoch: int) -> None:
        """Drop intervals fully before `epoch` (the PG peered and went
        active at `epoch`: older history can no longer matter)."""
        self.intervals = [i for i in self.intervals if i.last >= epoch]

    # -- queries -----------------------------------------------------------
    def prior_osds(self, since: int, exclude: int) -> set[int]:
        """OSDs that were members of a maybe-active interval whose span
        reaches back to `since` (the last epoch this PG completed
        peering) — the prior set the primary must hear from."""
        out: set[int] = set()
        for i in self.intervals:
            if i.last < since or not i.maybe_went_active():
                continue
            out.update(o for o in i.up if o is not None)
        out.discard(exclude)
        return out

    # -- codec -------------------------------------------------------------
    def encode_bytes(self) -> bytes:
        e = Encoder()

        def body(se: Encoder):
            se.u32(len(self.intervals))
            for i in self.intervals:
                se.u64(i.first)
                se.u64(i.last)
                se.u32(len(i.up))
                for o in i.up:
                    se.i64(-1 if o is None else o)
                se.i64(-1 if i.primary is None else i.primary)
            se.u64(self.cur_first)
            se.u32(len(self.cur_up))
            for o in self.cur_up:
                se.i64(-1 if o is None else o)
            se.i64(-1 if self.cur_primary is None else self.cur_primary)
        e.versioned(1, 1, body)
        return e.tobytes()

    @classmethod
    def decode_bytes(cls, raw: bytes) -> "PastIntervals":
        d = Decoder(raw)

        def body(sd: Decoder, _v: int):
            pi = cls()
            for _ in range(sd.u32()):
                first, last = sd.u64(), sd.u64()
                up = [None if (o := sd.i64()) < 0 else o
                      for _ in range(sd.u32())]
                prim = sd.i64()
                pi.intervals.append(
                    Interval(first, last, up,
                             None if prim < 0 else prim))
            pi.cur_first = sd.u64()
            pi.cur_up = [None if (o := sd.i64()) < 0 else o
                         for _ in range(sd.u32())]
            prim = sd.i64()
            pi.cur_primary = None if prim < 0 else prim
            return pi
        return d.versioned(1, body)
