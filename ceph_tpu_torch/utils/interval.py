"""Interval algebra: IntervalSet over [start, end) extents.

The capability of the reference's interval_set/interval_map
(src/include/interval_set.h, src/common/interval_map.h — SURVEY.md §2.2),
the substrate of extent maps (extent_map = interval_map<u64, bufferlist>,
ECUtil.h:60-62) and recovery/scrub range bookkeeping.
"""

from __future__ import annotations

import bisect
from typing import Iterator


class IntervalSet:
    """Sorted, coalesced set of half-open integer intervals."""

    def __init__(self, intervals=None):
        self._starts: list[int] = []
        self._ends: list[int] = []
        if intervals:
            for s, e in intervals:
                self.insert(s, e - s)

    # -- mutation ----------------------------------------------------------
    def insert(self, start: int, length: int) -> None:
        if length <= 0:
            return
        end = start + length
        i = bisect.bisect_left(self._ends, start)  # first iv ending >= start
        j = bisect.bisect_right(self._starts, end)  # last iv starting <= end
        if i < j:  # overlaps/touches [i, j)
            start = min(start, self._starts[i])
            end = max(end, self._ends[j - 1])
        self._starts[i:j] = [start]
        self._ends[i:j] = [end]

    def erase(self, start: int, length: int) -> None:
        if length <= 0:
            return
        end = start + length
        new_s, new_e = [], []
        for s, e in zip(self._starts, self._ends):
            if e <= start or s >= end:
                new_s.append(s)
                new_e.append(e)
                continue
            if s < start:
                new_s.append(s)
                new_e.append(start)
            if e > end:
                new_s.append(end)
                new_e.append(e)
        self._starts, self._ends = new_s, new_e

    def union(self, other: "IntervalSet") -> "IntervalSet":
        out = IntervalSet(self)
        for s, e in other:
            out.insert(s, e - s)
        return out

    def intersect(self, other: "IntervalSet") -> "IntervalSet":
        out = IntervalSet()
        for s1, e1 in self:
            for s2, e2 in other:
                s, e = max(s1, s2), min(e1, e2)
                if s < e:
                    out.insert(s, e - s)
        return out

    # -- queries -----------------------------------------------------------
    def contains(self, start: int, length: int = 1) -> bool:
        end = start + length
        i = bisect.bisect_right(self._starts, start) - 1
        return i >= 0 and self._ends[i] >= end and self._starts[i] <= start

    def intersects(self, start: int, length: int) -> bool:
        if length <= 0:
            return False
        end = start + length
        i = bisect.bisect_left(self._ends, start + 1)
        return i < len(self._starts) and self._starts[i] < end

    def size(self) -> int:
        return sum(e - s for s, e in self)

    def num_intervals(self) -> int:
        return len(self._starts)

    def empty(self) -> bool:
        return not self._starts

    def range_start(self) -> int:
        return self._starts[0]

    def range_end(self) -> int:
        return self._ends[-1]

    def __iter__(self) -> Iterator[tuple[int, int]]:
        return iter(zip(self._starts, self._ends))

    def __eq__(self, other) -> bool:
        return (isinstance(other, IntervalSet)
                and self._starts == other._starts
                and self._ends == other._ends)

    def __repr__(self) -> str:
        ivs = ", ".join(f"[{s},{e})" for s, e in self)
        return f"IntervalSet({ivs})"


class IntervalMap:
    """Offset-ranged VALUES (the interval_map<K, V> role,
    src/include/interval_map.h — BlueStore and the EC read pipeline use
    it with bufferlist values): non-overlapping [start, start+len)
    ranges each carrying a value; inserts SPLICE over existing ranges
    (later writes win, like overlapping buffer extents), adjacent
    ranges with splice-compatible values merge via the value's
    concatenation when it supports it (bytes), and lookups return the
    covering segments of any query range."""

    def __init__(self):
        self._segs: list[list] = []  # [start, length, value], sorted

    # -- mutation ----------------------------------------------------------
    def insert(self, start: int, length: int, value) -> None:
        if length <= 0:
            return
        if isinstance(value, (bytes, bytearray)) \
                and len(value) != length:
            # every byte-value slice below relies on ln == len(v) —
            # the C++ interval_map asserts this invariant at insert
            raise ValueError(
                f"value length {len(value)} != interval {length}")
        self.erase(start, length)
        idx = bisect.bisect_left(self._segs, start,
                                 key=lambda seg: seg[0])
        self._segs.insert(idx, [start, length, value])
        self._coalesce(idx)

    def erase(self, start: int, length: int) -> None:
        """Remove [start, start+length): overlapping segments are cut,
        byte-valued segments keep their surviving slices."""
        if length <= 0:
            return
        end = start + length
        out = []
        for s, ln, v in self._segs:
            e = s + ln
            if e <= start or s >= end:
                out.append([s, ln, v])
                continue
            if s < start:  # left remainder
                keep = start - s
                out.append([s, keep,
                            v[:keep] if isinstance(v, (bytes, bytearray))
                            else v])
            if e > end:    # right remainder
                keep = e - end
                off = end - s
                out.append([end, keep,
                            v[off:off + keep]
                            if isinstance(v, (bytes, bytearray))
                            else v])
        self._segs = out

    def _coalesce(self, idx: int) -> None:
        """Merge byte-valued neighbours that abut exactly."""
        segs = self._segs
        # try merging idx with its right neighbour, then left
        for i in (idx, idx - 1):
            if 0 <= i < len(segs) - 1:
                s, ln, v = segs[i]
                s2, ln2, v2 = segs[i + 1]
                if s + ln == s2 and isinstance(v, (bytes, bytearray)) \
                        and isinstance(v2, (bytes, bytearray)):
                    segs[i] = [s, ln + ln2, bytes(v) + bytes(v2)]
                    del segs[i + 1]

    # -- queries -----------------------------------------------------------
    def get(self, start: int, length: int) -> list[tuple[int, int, object]]:
        """Covering segments of [start, start+length) clipped to it:
        [(seg_start, seg_len, value_slice_or_value)]."""
        end = start + length
        out = []
        for s, ln, v in self._segs:
            e = s + ln
            if e <= start or s >= end:
                continue
            lo, hi = max(s, start), min(e, end)
            if isinstance(v, (bytes, bytearray)):
                out.append((lo, hi - lo, bytes(v[lo - s: hi - s])))
            else:
                out.append((lo, hi - lo, v))
        return out

    def covers(self, start: int, length: int) -> bool:
        """True when every byte of the range carries a value."""
        need = start
        end = start + length
        for s, ln, _v in self._segs:
            if s > need:
                return False
            if s + ln > need:
                need = s + ln
                if need >= end:
                    return True
        return need >= end

    def __len__(self) -> int:
        return len(self._segs)

    def __iter__(self):
        return iter((s, ln, v) for s, ln, v in self._segs)

    def empty(self) -> bool:
        return not self._segs
