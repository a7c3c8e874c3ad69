"""Distributed stripe EC over a device mesh.

The counterpart of ``ceph_tpu/parallel/distributed.py``, whose steps are
``shard_map`` programs over a ("dp", "shard") mesh.  Here a sharded
value is a ``ShardedTensor`` — the mesh, a partition spec and the block
of each of this process's devices — and each step runs its per-device
body on every device's block in turn, on that device's own CUDA stream,
with the collectives between them done as explicit tensor movement:

- encode runs column-sharded (each device holds a slice of every
  chunk's columns), so parity needs no communication;
- chunk placement is an ``all_to_all`` that re-lays the stripe from
  column-sharded to row-sharded ownership (each shard device owns whole
  chunks: the acting-set fan-out);
- rebalance/backfill is a ``ppermute`` of chunk rows around the shard
  ring (the pg-remap analogue, ECUtil.h:477-517);
- a degraded read re-lays the surviving rows column-sharded and decodes
  locally (the ReadPipeline fan-in, ECCommon.h:352-420);
- cluster-wide stats reduce with ``psum`` (uint32 wrap-around, summed
  in int64 and masked).

The per-device bodies are the port's StripeCodec graphs, so they launch
the hand-written kernels on a card and their plain versions on the CPU.
Inside one process the "shard" and "dp" collectives are copies between
blocks; a ``psum`` over the "host" axis of a process group goes through
``torch.distributed.all_reduce``.  The "shard" axis never crosses a
process (make_host_mesh keeps each host's devices together); an
``all_to_all`` or ``ppermute`` that would raises.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Sequence

import numpy as np
import torch

from ..models.stripe_codec import StripeCodec
from ..ops import ec_kernels
from ..utils import staging
from .mesh import Device, Mesh, process_count

_U32 = 0xFFFFFFFF


def P(*axes) -> tuple:
    """A partition spec: for each dimension None (whole), a mesh axis
    name, or a tuple of axis names (sharded over their product)."""
    return tuple(axes)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block_slices(mesh: Mesh, spec: tuple, shape: tuple,
                  coord: tuple) -> tuple[slice, ...]:
    """The slice of a global ``shape`` that the device at ``coord``
    holds under ``spec``."""
    out = []
    for dim, size in enumerate(shape):
        idx, cnt = 0, 1
        for a in _axes(spec[dim] if dim < len(spec) else None):
            pos = mesh.axis_names.index(a)
            idx = idx * mesh.devices.shape[pos] + coord[pos]
            cnt *= mesh.devices.shape[pos]
        if size % cnt:
            raise ValueError(f"dimension {dim} of {size} does not split "
                             f"{cnt} ways")
        b = size // cnt
        out.append(slice(idx * b, (idx + 1) * b))
    return tuple(out)


@contextlib.contextmanager
def _on(dev: Device):
    """Run a device's share: on its own stream on a card, and with its
    launches booked to it (ec_kernels.device_launch_counts)."""
    s = dev.stream()
    with ec_kernels.on_logical_device(dev.id):
        if s is None:
            yield
        else:
            with torch.cuda.stream(s):
                yield


def _fork(mesh: Mesh, coords) -> None:
    """Each device stream waits for the work queued so far on its
    card's current stream (where the inputs were made)."""
    for c in coords:
        dev = mesh.devices[c]
        s = dev.stream()
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(dev.torch_device))


def _join(mesh: Mesh, coords) -> None:
    """The current stream of each card of ``coords`` waits for all their
    device streams (so a block may be read on any of those cards)."""
    streams = [s for s in (mesh.devices[c].stream() for c in coords)
               if s is not None]
    for d in {mesh.devices[c].torch_device for c in coords}:
        if d.type == "cuda":
            cur = torch.cuda.current_stream(d)
            for s in streams:
                cur.wait_stream(s)


def _handoff(t: torch.Tensor, src: Device, dst: Device) -> None:
    """Order ``dst``'s stream after ``src``'s and keep ``t`` (made on
    ``src``'s) alive for ``dst``'s use."""
    s = dst.stream()
    if s is not None and src is not dst:
        s.wait_stream(src.stream())
        if t.is_cuda:
            t.record_stream(s)


class ShardedTensor:
    """A global array laid over a mesh by a partition spec: ``blocks``
    maps each of this process's mesh coordinates to its block, a tensor
    on that device (devices that share a block each hold a copy, as a
    jax.Array's shards do).  ``np.asarray`` gathers it to the host."""

    def __init__(self, mesh: Mesh, spec: tuple, shape: tuple,
                 blocks: dict, dtype=np.uint8):
        self.mesh, self.spec, self.shape = mesh, tuple(spec), tuple(shape)
        self.blocks = blocks
        self.dtype = np.dtype(dtype)

    def slices(self, coord) -> tuple[slice, ...]:
        return _block_slices(self.mesh, self.spec, self.shape, coord)

    def unique_blocks(self) -> list[tuple[tuple[slice, ...], torch.Tensor]]:
        """(slices, block) once for each distinct block held here."""
        seen = {}
        for c, t in self.blocks.items():
            sl = self.slices(c)
            seen.setdefault(tuple((s.start, s.stop) for s in sl), (sl, t))
        return list(seen.values())

    def gather(self) -> np.ndarray:
        """The global array on the host; raises where a block is held
        only by another process."""
        out = np.empty(self.shape, dtype=self.dtype)
        covered = 0
        for sl, t in self.unique_blocks():
            host = t.detach().cpu()
            if self.dtype == np.uint32 and host.dtype == torch.int64:
                host = host & _U32
            out[sl] = host.numpy().astype(self.dtype, copy=False)
            covered += int(np.prod([s.stop - s.start for s in sl]))
        if covered != out.size:
            raise ValueError("the array has blocks held by another process")
        return out

    def __array__(self, dtype=None, copy=None):
        a = self.gather()
        return a if dtype is None else a.astype(dtype)

    def assemble(self, device) -> torch.Tensor:
        """The global array as one tensor on ``device`` (on a card whose
        logical devices hold the blocks: one copy on the card), queued
        on ``device``'s current stream after the device streams."""
        device = torch.device(device)
        parts = self.unique_blocks()
        out = torch.empty(self.shape, dtype=parts[0][1].dtype,
                          device=device)
        cur = (torch.cuda.current_stream(device)
               if device.type == "cuda" else None)
        for c in self.blocks if cur is not None else ():
            s = self.mesh.devices[c].stream()
            if s is not None:
                cur.wait_stream(s)
        for sl, t in parts:
            if cur is not None and t.device == device:
                t.record_stream(cur)
            out[sl].copy_(t, non_blocking=True)
        return out


def stage(x: np.ndarray, mesh: Mesh, spec: tuple) -> ShardedTensor:
    """A host array straight into its sharding: one host-to-device copy
    of each of this process's blocks, on the device's stream, metered on
    the ``ec_stage_h2d_*`` counters as one copy event (the slices leave
    the host together)."""
    x = np.asarray(x)
    t0 = time.perf_counter()
    blocks, nbytes, on_card = {}, 0, False
    for c in mesh.local_coords():
        dev = mesh.devices[c]
        part = np.ascontiguousarray(x[_block_slices(mesh, spec, x.shape, c)])
        with _on(dev):
            blocks[c] = torch.from_numpy(part).to(dev.torch_device)
        nbytes += part.nbytes
        on_card = on_card or dev.torch_device.type == "cuda"
    staging.note_h2d(nbytes, None if on_card else time.perf_counter() - t0)
    return ShardedTensor(mesh, spec, x.shape, blocks, x.dtype)


def stage_folded(rows, mesh: Mesh, axis: str = "shard"):
    """A host fold (c, N) staged column-sharded over ``axis`` (one copy
    of a column slice to each device).  Anything else passes through."""
    if not isinstance(rows, np.ndarray):
        return rows
    return stage(rows, mesh, P(None, axis))


def _column_blocks(rows, mesh: Mesh, axis: str) -> ShardedTensor:
    """``rows`` (c, N) — numpy, a tensor, or already column-sharded — as
    a ShardedTensor of column slices.  A tensor's slices are views, read
    by each device's share on its stream."""
    if isinstance(rows, ShardedTensor):
        if rows.mesh is not mesh or rows.spec != P(None, axis):
            raise ValueError(f"expected a {P(None, axis)} array on this "
                             f"mesh, got {rows.spec}")
        return rows
    if isinstance(rows, np.ndarray):
        return stage_folded(rows, mesh, axis)
    spec = P(None, axis)
    blocks = {}
    for c in mesh.local_coords():
        part = rows[_block_slices(mesh, spec, tuple(rows.shape), c)]
        blocks[c] = part.to(mesh.devices[c].torch_device)
    return ShardedTensor(mesh, spec, tuple(rows.shape), blocks)


def make_folded_matmul(M: np.ndarray, mesh: Mesh, axis: str = "shard",
                       kernel: str = "auto"):
    """Mesh-sharded folded region multiply: fn(rows (c, N) uint8) ->
    (r, N) ShardedTensor, M @ rows over GF(2^8) with the length axis
    sharded over ``axis`` — the fan-out of the ECBatcher's folded
    (k, sum L) launches.  Columns are independent, so each device runs
    the region kernel (``kernel``, ec_kernels.KERNELS; ``auto`` is K1 on
    a card and the plain version on the CPU) on its slice and no
    collective runs.  Callers pad N to a multiple of 4 * devices; zero
    columns encode to zero, so the padding slices away exact."""
    M = np.ascontiguousarray(M, dtype=np.uint8)
    enc = ec_kernels.region_fn(M, kernel)
    n_dev = mesh.devices.shape[mesh.axis_names.index(axis)]

    def fn(rows) -> ShardedTensor:
        if rows.shape[-1] % n_dev:
            raise ValueError(f"{rows.shape[-1]} columns do not split "
                             f"over {n_dev} devices")
        x = _column_blocks(rows, mesh, axis)
        coords = list(x.blocks)
        _fork(mesh, coords)
        out = {}
        for c in coords:
            with _on(mesh.devices[c]):
                out[c] = enc(x.blocks[c])
        _join(mesh, coords)
        return ShardedTensor(mesh, x.spec, (M.shape[0], x.shape[-1]), out)

    return fn


def make_folded_csum(k: int, m: int, M: np.ndarray, chunk_bytes: int,
                     mesh: Mesh, axis: str = "shard",
                     kernel: str = "auto"):
    """Mesh-sharded fused encode+CRC32C: fn(data (k, N) uint8, or the
    (k + m, N) buffer it heads, N = batch * chunk_bytes) -> (parity
    (m, N), csums (k + m, batch) uint32) ShardedTensors with the length
    axis sharded over ``axis``.  A flushed batch pads its stripe count
    to a multiple of the fan-out, so each device owns whole chunks and
    runs the single-device fused op (StripeCodec.encode_csum_graph: the
    region kernel, then G1) on them; no collective runs and the digests
    equal the native sweep's."""
    codec = StripeCodec.__new__(StripeCodec)
    codec.k, codec.m = k, m
    codec.matrix = np.ascontiguousarray(M, dtype=np.uint8)
    g = codec.encode_csum_graph(chunk_bytes, kernel=kernel)
    n_dev = mesh.devices.shape[mesh.axis_names.index(axis)]

    def fn(data):
        N = int(data.shape[-1])
        if N % (n_dev * chunk_bytes):
            raise ValueError(f"{N} bytes are not whole {chunk_bytes}-byte "
                             f"chunks on each of {n_dev} devices")
        if isinstance(data, np.ndarray):
            data = data[:k]
        x = _column_blocks(data, mesh, axis)
        coords = list(x.blocks)
        _fork(mesh, coords)
        par, cs = {}, {}
        for c in coords:
            blk = x.blocks[c]
            with _on(mesh.devices[c]):
                buf = torch.empty((k + m, blk.shape[-1]), dtype=torch.uint8,
                                  device=blk.device)
                buf[:k] = blk[:k]
                par[c], cs[c] = g(buf)
        _join(mesh, coords)
        return (ShardedTensor(mesh, x.spec, (m, N), par),
                ShardedTensor(mesh, x.spec, (k + m, N // chunk_bytes), cs,
                              np.uint32))

    return fn


# ---------------------------------------------------------------------------
# collectives between the blocks of one process (and psum across processes)
# ---------------------------------------------------------------------------

def _group(mesh: Mesh, coord: tuple, pos: int) -> list[tuple]:
    """The coordinates that differ from ``coord`` along axis ``pos``."""
    return [coord[:pos] + (j,) + coord[pos + 1:]
            for j in range(mesh.devices.shape[pos])]


def _all_to_all(mesh: Mesh, blocks: dict, axis: str, split_axis: int,
                concat_axis: int) -> dict:
    """Tiled all_to_all over ``axis``: device j of a group sends the
    r-th ``split_axis`` slice of its block to device r, which
    concatenates what it gets along ``concat_axis`` in the senders'
    order — copies queued on the receiver's stream after the senders'."""
    pos = mesh.axis_names.index(axis)
    n = mesh.devices.shape[pos]
    out = {}
    for c in blocks:
        group = _group(mesh, c, pos)
        if any(g not in blocks for g in group):
            raise ValueError(f"all_to_all over {axis!r} would cross a "
                             "process")
        dst = mesh.devices[c]
        parts = []
        for g in group:
            src = blocks[g]
            _handoff(src, mesh.devices[g], dst)
            sz = src.shape[split_axis] // n
            parts.append(src.narrow(split_axis, c[pos] * sz, sz))
        with _on(dst):
            out[c] = torch.cat([p.to(dst.torch_device) for p in parts],
                               dim=concat_axis)
    return out


def _ppermute(mesh: Mesh, blocks: dict, axis: str,
              perm: Sequence[tuple[int, int]]) -> dict:
    """Send each device's block to another along ``axis`` (perm: (source,
    destination) positions): a copy on the destination's stream."""
    pos = mesh.axis_names.index(axis)
    send = dict(perm)
    out = {}
    for c, t in blocks.items():
        d = c[:pos] + (send[c[pos]],) + c[pos + 1:]
        if d not in blocks:
            raise ValueError(f"ppermute over {axis!r} would cross a process")
        src, dst = mesh.devices[c], mesh.devices[d]
        _handoff(t, src, dst)
        with _on(dst):
            out[d] = t.to(dst.torch_device, copy=True)
    return out


def _psum(mesh: Mesh, vals: dict, axes: Sequence[str]) -> dict:
    """Sum int64 ``vals`` over the devices of each group along ``axes``,
    wrapped to uint32; every member gets the sum.  A group that spans
    processes (the "host" axis of a process group) is summed here first,
    then across processes with one ``all_reduce`` for all such groups
    (each process holds members of every one of them)."""
    pos = [mesh.axis_names.index(a) for a in axes]
    groups: dict[tuple, list] = {}
    for c in mesh.coords():
        groups.setdefault(tuple(v for i, v in enumerate(c) if i not in pos),
                          []).append(c)
    partial, homes, spans = {}, {}, []
    for key in sorted(groups):
        local = [c for c in groups[key] if c in vals]
        if len(local) < len(groups[key]):
            spans.append(key)
        if not local:
            continue
        home = homes[key] = mesh.devices[local[0]]
        for c in local[1:]:
            _handoff(vals[c], mesh.devices[c], home)
        with _on(home):
            acc = vals[local[0]].to(torch.int64)
            for c in local[1:]:
                acc = acc + vals[c].to(home.torch_device, torch.int64)
            partial[key] = acc
    if spans:
        if any(key not in partial for key in spans):
            raise ValueError("psum over a group this process holds no "
                             "member of")
        dist = torch.distributed
        flat = [partial[key].reshape(-1) for key in spans]
        sizes = [int(f.numel()) for f in flat]
        on = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
        _join(mesh, list(vals))
        buf = torch.cat([f.to(on) for f in flat])
        dist.all_reduce(buf)
        for key, part in zip(spans, torch.split(buf, sizes)):
            partial[key] = part.reshape(partial[key].shape)
            homes[key] = None  # a host tensor now
    out = {}
    for key, members in groups.items():
        for c in members:
            if c in vals:
                dev = mesh.devices[c]
                if homes[key] is not None:
                    _handoff(partial[key], homes[key], dev)
                with _on(dev):
                    out[c] = partial[key].to(dev.torch_device) & _U32
    return out


def global_sum(x: ShardedTensor, fn) -> int:
    """sum over the array's distinct blocks of ``fn(slices, block)`` (an
    int64 scalar tensor), across the process group: a replicated scalar
    out, as a check computed inside a distributed step gives it.  Each
    block must be held by one process."""
    tot = torch.zeros((), dtype=torch.int64)
    for sl, t in x.unique_blocks():
        tot += int(fn(sl, t))
    if process_count() > 1:
        torch.distributed.all_reduce(tot)
    return int(tot)


class DistributedStripeEC:
    """Distributed EC pipeline for a StripeCodec over a ("dp", "shard")
    mesh (or ("host", "dp", "shard") with ``batch_axes=("host", "dp")``).

    Data model: a batch of stripes (B, k, L) uint8.  B is sharded over
    the batch axes; L over "shard" during compute; after placement each
    shard device owns S / n_shard whole chunk rows, where S pads k + m
    up to a multiple of the shard axis (spare rows are zero).  Each step
    takes numpy (staged into its input sharding) or a ShardedTensor of
    that sharding and returns ShardedTensors.
    """

    def __init__(self, codec: StripeCodec, mesh: Mesh,
                 batch_axes: Sequence[str] = ("dp",)):
        self.codec = codec
        self.mesh = mesh
        self.n_shard = mesh.shape["shard"]
        self.batch_axes = tuple(batch_axes)
        self.n_dp = 1
        for a in self.batch_axes:
            self.n_dp *= mesh.shape[a]
        km = codec.k + codec.m
        self.S = -(-km // self.n_shard) * self.n_shard
        self.spare_rows = self.S - km

    # specs of the two layouts
    def _col_spec(self) -> tuple:
        return P(self.batch_axes, None, "shard")

    def _row_spec(self) -> tuple:
        return P(self.batch_axes, "shard", None)

    def stage(self, data: np.ndarray) -> ShardedTensor:
        """Host stripes (B, k, L) staged in the write step's input
        sharding (batch over the batch axes, columns over "shard")."""
        return self._input(data, self._col_spec())

    def _input(self, x, spec: tuple) -> ShardedTensor:
        if isinstance(x, ShardedTensor):
            if x.mesh is not self.mesh or x.spec != spec:
                raise ValueError(f"expected a {spec} array on this mesh, "
                                 f"got {x.spec}")
            return x
        return stage(np.ascontiguousarray(x, dtype=np.uint8), self.mesh,
                     spec)

    def _encode_local(self, enc, d: torch.Tensor) -> torch.Tensor:
        """(b, k, Ll) data -> (b, S, Ll) [data; parity; zeros] on d's
        device."""
        k, m, S = self.codec.k, self.codec.m, self.S
        b, _, Ll = d.shape
        folded = d.permute(1, 0, 2).reshape(k, b * Ll)
        par = enc(folded).reshape(m, b, Ll).permute(1, 0, 2)
        zeros = torch.zeros((b, S - k - m, Ll), dtype=torch.uint8,
                            device=d.device)
        return torch.cat([d, par, zeros], dim=1)

    # ---------------- write ----------------
    def make_write_step(self):
        """fn(data (B, k, L)) -> (stack (B, S, L) with rows over "shard"
        and the batch over the batch axes, digest: the uint32 sum of
        every parity byte, psum-reduced over the whole mesh)."""
        k, m = self.codec.k, self.codec.m
        enc = self.codec.encode_graph()
        mesh = self.mesh

        def step(data):
            x = self._input(data, self._col_spec())
            coords = list(x.blocks)
            _fork(mesh, coords)
            stacks, digs = {}, {}
            for c in coords:
                with _on(mesh.devices[c]):
                    stack = self._encode_local(enc, x.blocks[c])
                    stacks[c] = stack
                    digs[c] = stack[:, k:k + m].sum(dtype=torch.int64)
            stacks = _all_to_all(mesh, stacks, "shard", 1, 2)
            digs = _psum(mesh, digs, (*self.batch_axes, "shard"))
            _join(mesh, coords)
            B, _, L = x.shape
            return (ShardedTensor(mesh, self._row_spec(), (B, self.S, L),
                                  stacks),
                    ShardedTensor(mesh, P(), (), digs, np.uint32))

        return step

    # ---------------- rebalance / backfill ----------------
    def make_rebalance_step(self, rotate: int = 1):
        """fn(stack (B, S, L)) -> the stack with chunk-row ownership
        rotated ``rotate`` positions around the shard ring (ppermute)."""
        n, mesh = self.n_shard, self.mesh
        perm = [(i, (i + rotate) % n) for i in range(n)]

        def step(stack):
            x = self._input(stack, self._row_spec())
            coords = list(x.blocks)
            _fork(mesh, coords)
            out = _ppermute(mesh, x.blocks, "shard", perm)
            _join(mesh, coords)
            return ShardedTensor(mesh, x.spec, x.shape, out)

        return step

    # ---------------- degraded read / recovery ----------------
    def make_recovery_step(self, available: Sequence[int]):
        """fn(stack (B, S, L)) -> data (B, k, L), column-sharded, decoded
        from the erasure signature ``available`` (>= k surviving chunk
        ids; the first k are read).  Each device gets the column slice
        of every row it will decode (an all_to_all, the inverse of the
        write's placement) and decodes it."""
        k, mesh = self.codec.k, self.mesh
        use = list(available)[:k]
        dec = self.codec.decode_graph(use)

        def step(stack):
            x = self._input(stack, self._row_spec())
            coords = list(x.blocks)
            _fork(mesh, coords)
            full = _all_to_all(mesh, x.blocks, "shard", 2, 1)
            out = {}
            for c in coords:
                with _on(mesh.devices[c]):
                    f = full[c]
                    b, _, Ll = f.shape
                    surv = f[:, use, :]
                    folded = surv.permute(1, 0, 2).reshape(k, b * Ll)
                    out[c] = dec(folded).reshape(k, b, Ll).permute(
                        1, 0, 2).contiguous()
            _join(mesh, coords)
            B, _, L = x.shape
            return ShardedTensor(mesh, self._col_spec(), (B, k, L), out)

        return step

    # ---------------- partial write: parity delta ----------------
    def make_delta_step(self):
        """fn(stack (B, S, L) row-sharded, delta (B, k, L)) -> the
        updated stack: parity' = parity ^ encode(delta) and data' =
        data ^ delta (GF(2^8) addition is XOR; ECUtil.cc:519-566).  The
        delta encodes column-sharded, one all_to_all lays it out as the
        stack, and the XOR folds in on each device."""
        enc = self.codec.encode_graph()
        mesh = self.mesh

        def step(stack, delta):
            x = self._input(stack, self._row_spec())
            d = self._input(delta, self._col_spec())
            coords = list(x.blocks)
            _fork(mesh, coords)
            upd = {}
            for c in coords:
                with _on(mesh.devices[c]):
                    upd[c] = self._encode_local(enc, d.blocks[c])
            upd = _all_to_all(mesh, upd, "shard", 1, 2)
            out = {}
            for c in coords:
                with _on(mesh.devices[c]):
                    out[c] = torch.bitwise_xor(x.blocks[c], upd[c])
            _join(mesh, coords)
            return ShardedTensor(mesh, x.spec, x.shape, out)

        return step

    # ---------------- per-shard stats: batch-axis reduction ----------------
    def make_stats_step(self):
        """fn(stack (B, S, L)) -> (S,) uint32 per-chunk-row byte totals,
        reduced over the batch axes only (each shard position sums its
        own rows across every batch: the per-OSD stats report).  On a
        host mesh of a process group this reduction crosses processes."""
        mesh = self.mesh

        def step(stack):
            x = self._input(stack, self._row_spec())
            coords = list(x.blocks)
            _fork(mesh, coords)
            tot = {}
            for c in coords:
                with _on(mesh.devices[c]):
                    tot[c] = x.blocks[c].sum(dim=(0, 2), dtype=torch.int64)
            tot = _psum(mesh, tot, self.batch_axes)
            _join(mesh, coords)
            return ShardedTensor(mesh, P("shard"), (self.S,), tot,
                                 np.uint32)

        return step

    # ---------------- cached steps ----------------
    @functools.cached_property
    def write_step(self):
        return self.make_write_step()

    def recovery_step(self, available: Sequence[int]):
        """The recovery step, cached per erasure signature (the decode
        table cache of the reference, ErasureCodeIsa.cc:513-563)."""
        key = tuple(available)
        cache = self.__dict__.setdefault("_recovery_cache", {})
        fn = cache.get(key)
        if fn is None:
            fn = self.make_recovery_step(available)
            if len(cache) > 128:
                cache.pop(next(iter(cache)))
            cache[key] = fn
        return fn
