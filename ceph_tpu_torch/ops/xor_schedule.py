"""XOR schedules for GF(2) bit-matrices — the bitxor kernel's front end.

A GF(2) bit-matrix applied to plane rows is pure XOR:

    out[r] = XOR over c of planes[c]  where B[r, c] == 1

Evaluated row by row that costs sum(popcount(row)) - rows XORs.  The
optimization literature for XOR-based erasure codes ("Accelerating
XOR-based Erasure Coding using Program Optimization Techniques",
arXiv:2108.02692; "Fast XOR-based Erasure Coding based on Polynomial
Ring Transforms", arXiv:1701.07731) gets its wins from *scheduling*
those XORs: partial sums shared between output rows are computed once
and memoized — classic common-subexpression elimination over the XOR
chain, jerasure's "smart scheduling" generalized across rows.

This module builds such schedules CPU-side at matrix-construction time
(ops/ec_kernels.py lowers them into the flat instruction program
the CUDA bitxor kernel interprets, and runs them as plain torch
ops on the CPU) with the greedy pairwise-matching CSE: repeatedly
find the operand PAIR co-occurring in the most rows, hoist it into a
fresh intermediate node, substitute, stop when no pair repeats.  The
pair counts update incrementally and the max extraction rides a lazy
heap, so construction stays near-linear in the schedule it emits.

Everything here is numpy/stdlib only — the schedule is shared by the
device lowerings AND the numpy oracle evaluator the property tests
compare against, so a scheduler bug cannot hide behind a lowering bug.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

#: above this many bit-matrix cells the CSE pass is skipped (the initial
#: pair count is O(rows * row_weight^2) Python work — a 512x512 decode
#: bit-matrix would pay seconds for a schedule the kernel LRU may churn
#: out anyway); the raw per-row schedule is still correct, just unshared
CSE_CELL_LIMIT = 1 << 16


@dataclass(frozen=True)
class XorSchedule:
    """A straight-line XOR program over input planes 0..n_in-1.

    ``ops`` is the intermediate chain: ``(dst, a, b)`` computes node
    ``dst = a ^ b`` (dst ids start at ``n_in`` and ascend, operands
    always precede their op).  ``outputs[r]`` lists the node ids whose
    XOR is output row r — an empty tuple is an all-zero row.
    ``used_inputs`` are the input plane ids the program actually reads
    (lowering skips unpacking the rest)."""

    n_in: int
    ops: tuple[tuple[int, int, int], ...]
    outputs: tuple[tuple[int, ...], ...]
    used_inputs: tuple[int, ...]

    def xor_count(self) -> int:
        """Total XORs the schedule performs (intermediates + per-row
        combines) — the quantity CSE minimizes."""
        return len(self.ops) + sum(max(0, len(o) - 1)
                                   for o in self.outputs)

    def naive_xor_count(self) -> int:
        """XOR cost of evaluating each row independently (popcount-1
        per nonempty row) — the pre-CSE baseline."""
        naive = 0
        stack = {i: frozenset([i]) for i in range(self.n_in)}
        for dst, a, b in self.ops:
            stack[dst] = stack[a] ^ stack[b]
        for out in self.outputs:
            leaves: frozenset = frozenset()
            for t in out:
                leaves = leaves ^ stack[t]
            naive += max(0, len(leaves) - 1)
        return naive


def build_schedule(B: np.ndarray, *, cse: bool = True) -> XorSchedule:
    """Greedy pairwise-CSE XOR schedule for bit-matrix ``B`` (R, C).

    Deterministic: ties between equally-frequent pairs break toward the
    lexicographically smallest (a, b), so the same matrix always yields
    the same schedule (the CI pick-stability contract rides on this).
    """
    B = np.ascontiguousarray(B, dtype=np.uint8) & 1
    if B.ndim != 2:
        raise ValueError(f"bit-matrix must be 2-D, got {B.shape}")
    R, C = B.shape
    rows: list[set[int]] = [set(np.nonzero(B[r])[0].tolist())
                            for r in range(R)]
    ops: list[tuple[int, int, int]] = []
    if cse and R * C <= CSE_CELL_LIMIT and R > 1:
        ops = _cse_pass(rows, C)
    outputs = tuple(tuple(sorted(row)) for row in rows)
    used: set[int] = set()
    for _dst, a, b in ops:
        used.add(a)
        used.add(b)
    for out in outputs:
        used.update(out)
    used_inputs = tuple(sorted(u for u in used if u < C))
    return XorSchedule(n_in=C, ops=tuple(ops), outputs=outputs,
                       used_inputs=used_inputs)


def _cse_pass(rows: list[set[int]], n_in: int) -> list[tuple[int, int, int]]:
    """Hoist repeated operand pairs into fresh nodes, mutating ``rows``
    in place; returns the intermediate op chain."""
    cnt: dict[tuple[int, int], int] = {}
    heap: list[tuple[int, tuple[int, int]]] = []

    def bump(pair: tuple[int, int], by: int) -> None:
        n = cnt.get(pair, 0) + by
        if n <= 0:
            cnt.pop(pair, None)
            return
        cnt[pair] = n
        if by > 0:
            # lazy heap: stale entries are skipped at pop time
            heapq.heappush(heap, (-n, pair))

    for row in rows:
        srow = sorted(row)
        for i, a in enumerate(srow):
            for b in srow[i + 1:]:
                bump((a, b), 1)

    ops: list[tuple[int, int, int]] = []
    nxt = n_in
    while heap:
        negn, pair = heap[0]
        live = cnt.get(pair, 0)
        if live < 2:
            heapq.heappop(heap)
            continue
        if -negn != live:
            heapq.heappop(heap)
            heapq.heappush(heap, (-live, pair))
            continue
        a, b = pair
        ops.append((nxt, a, b))
        for row in rows:
            if a not in row or b not in row:
                continue
            row.discard(a)
            row.discard(b)
            # retire the old pairs of a and b against the row's other
            # members, then count the new node's pairs — the pair table
            # stays exact without a rescan
            for other in row:
                bump((min(a, other), max(a, other)), -1)
                bump((min(b, other), max(b, other)), -1)
                bump((other, nxt), 1)
            row.add(nxt)
        cnt.pop(pair, None)
        nxt += 1
    return ops


def apply_schedule(sched: XorSchedule, planes: np.ndarray) -> np.ndarray:
    """Numpy oracle evaluator: planes (n_in, ...) -> (len(outputs), ...)
    by running the schedule literally.  The property tests compare this
    against the naive bit-matrix apply AND the device lowerings, so it
    stays dead simple on purpose."""
    planes = np.asarray(planes)
    if planes.shape[0] != sched.n_in:
        raise ValueError(
            f"expected {sched.n_in} planes, got {planes.shape[0]}")
    nodes: list[np.ndarray | None] = \
        [None] * (sched.n_in + len(sched.ops))
    for p in sched.used_inputs:
        nodes[p] = planes[p]
    for dst, a, b in sched.ops:
        nodes[dst] = nodes[a] ^ nodes[b]
    zero = np.zeros_like(planes[0]) if sched.n_in else None
    out = []
    for terms in sched.outputs:
        acc = None
        for t in terms:
            acc = nodes[t] if acc is None else acc ^ nodes[t]
        out.append(zero if acc is None else acc)
    return np.stack(out) if out else \
        np.zeros((0,) + planes.shape[1:], dtype=planes.dtype)


def naive_apply(B: np.ndarray, planes: np.ndarray) -> np.ndarray:
    """Reference bit-matrix apply: out[r] = XOR of planes where B[r]."""
    B = np.ascontiguousarray(B, dtype=np.uint8) & 1
    out = np.zeros((B.shape[0],) + planes.shape[1:], dtype=planes.dtype)
    for r in range(B.shape[0]):
        idx = np.nonzero(B[r])[0]
        if idx.size:
            out[r] = np.bitwise_xor.reduce(planes[idx], axis=0)
    return out
