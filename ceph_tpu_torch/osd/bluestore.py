"""BlueStore-lite: raw-block allocator + KV-metadata ObjectStore.

The capability slot of the reference's BlueStore proper (SURVEY.md §2.6;
ref src/os/bluestore/BlueStore.cc — onodes+extent metadata in RocksDB,
data on a raw device through an allocator, deferred small writes staged
through the KV WAL, checksums verified on every read), designed for this
codebase rather than translated:

- **device**: one flat file (`block.img`), grown in 16 MiB steps, carved
  into 4 KiB allocation units ("pages" — the min_alloc_size role);
- **allocator**: a free-page heap + per-page refcounts, REBUILT at mount
  by scanning the onode table (the fsck/freelist role: the onodes are
  the single source of truth, so space leaked by a crash between a data
  write and its KV commit is reclaimed on the next mount);
- **metadata**: every onode (size, attrs, page map with per-page crc32c)
  lives in a `KeyValueDB` (WalKV: crc-framed fsync'd WAL + snapshot
  compaction) under prefix "O"; omap under "M"; collections under "C";
- **large writes** go to freshly allocated pages (never over live data),
  are fsync'd, and only then does the KV transaction commit the new page
  map — the classic write-ahead ordering;
- **small writes** (<= deferred_limit) take the deferred path: the new
  page content commits INSIDE the KV transaction (prefix "D") and the
  device page is written after the commit returns; a crash replays "D"
  records at mount (BlueStore's deferred-write mechanism, which is what
  makes sub-alloc-unit overwrites cheap and safe);
- **clone** is O(pages): the page map is copied and per-page refcounts
  bump — writes always allocate, so sharing is copy-on-write for free;
- **reads** verify each page's crc32c against the onode every time
  (BlueStore _verify_csum role) and raise StoreError on rot;
- **inline compression** (the Compression.cc / per-blob csum+compress
  role): large aligned writes compress into BLOBS — zlib over a run of
  logical pages stored in fewer physical pages — recorded in the onode
  and transparently decompressed on read; a blob is only kept when it
  saves real pages (required_ratio), and any overwrite of a compressed
  range first materialises it back to plain pages (BlueStore's
  compressed-blob GC-on-overwrite).

Transactions are atomic: ops stage against shadow onodes and commit in
one KV batch; validation failures roll back staged allocations and leave
no trace.
"""

from __future__ import annotations

import heapq
import os
import threading
from typing import Callable

from ..ops.native import crc32c, crc32c_blocks
from ..utils.buffer import BufferList
from ..utils.codec import Decoder, Encoder
from .filestore import _dec_value, _enc_value, _esc
from .kvstore import KVTransaction, WalKV
from .objectstore import (CollectionId, NoSuchCollection, NoSuchObject,
                          ObjectId, ObjectStore, StoreError, Transaction,
                          TxOp)

PAGE = 4096                 # allocation unit (min_alloc_size role)
EXTEND_PAGES = 4096         # device growth step: 16 MiB
DEFER_LIMIT = 16 * 1024     # writes at or below take the deferred path
DEFER_FLUSH_N = 64          # flush+trim "D" records past this many

HOLE = -1                   # page map entry for an unwritten page
BLOB_BASE = -2              # entries <= BLOB_BASE reference a blob:
#                             phys = BLOB_BASE - blob_id, crc = index of
#                             this logical page inside the blob's span
COMPRESS_MIN_PAGES = 8      # blob threshold: 32 KiB of aligned pages
COMPRESS_RATIO = 0.875      # keep a blob only if it saves >= 1/8th

_P_SUPER, _P_COLL, _P_ONODE, _P_OMAP, _P_DEFER = "S", "C", "O", "M", "D"


class Onode:
    """In-RAM onode: the decoded image of one "O" record (+ its omap)."""

    __slots__ = ("size", "attrs", "omap", "pages", "blobs")

    def __init__(self):
        self.size = 0
        self.attrs: dict[str, object] = {}
        self.omap: dict[str, object] = {}
        self.pages: list[tuple[int, int]] = []  # (phys page, crc32c)
        # compressed blobs: id -> {"pages": [(phys, crc)...] of the
        # compressed stream, "clen": compressed bytes, "raw": raw bytes}
        self.blobs: dict[int, dict] = {}

    def copy(self) -> "Onode":
        o = Onode()
        o.size = self.size
        o.attrs = dict(self.attrs)
        o.omap = dict(self.omap)
        o.pages = list(self.pages)
        o.blobs = {i: {"pages": list(b["pages"]), "clen": b["clen"],
                       "raw": b["raw"]} for i, b in self.blobs.items()}
        return o

    def phys_pages(self):
        """Every physical page this onode references (plain + blob)."""
        for phys, _crc in self.pages:
            if phys >= 0:
                yield phys
        for b in self.blobs.values():
            for phys, _crc in b["pages"]:
                yield phys


def _onode_key(cid: CollectionId, oid: ObjectId) -> str:
    return (f"{cid.pool}.{cid.pg_seed:x}|{_esc(oid.name)}"
            f"|{oid.shard}|{oid.generation}")


def _coll_prefix(cid: CollectionId) -> str:
    return f"{cid.pool}.{cid.pg_seed:x}|"


def _encode_onode(oid: ObjectId, o: Onode) -> bytes:
    e = Encoder()

    def body(se: Encoder):
        se.string(oid.name); se.i64(oid.shard); se.i64(oid.generation)
        se.u64(o.size)
        se.u32(len(o.attrs))
        for k, v in sorted(o.attrs.items()):
            se.string(str(k)); _enc_value(se, v)
        se.u32(len(o.pages))
        for phys, crc in o.pages:
            se.i64(phys); se.u32(crc)
        se.u32(len(o.blobs))                      # v2 tail
        for bid, b in sorted(o.blobs.items()):
            se.u64(bid)
            se.u64(b["clen"])
            se.u64(b["raw"])
            se.u32(len(b["pages"]))
            for phys, crc in b["pages"]:
                se.i64(phys); se.u32(crc)
    e.versioned(2, 1, body)
    return e.tobytes()


def _decode_onode(raw: bytes) -> tuple[ObjectId, Onode]:
    d = Decoder(raw)

    def body(sd: Decoder, version: int):
        oid = ObjectId(sd.string(), sd.i64(), sd.i64())
        o = Onode()
        o.size = sd.u64()
        for _ in range(sd.u32()):
            k = sd.string(); o.attrs[k] = _dec_value(sd)
        o.pages = [(sd.i64(), sd.u32()) for _ in range(sd.u32())]
        if version >= 2:
            for _ in range(sd.u32()):
                bid = sd.u64()
                clen = sd.u64()
                raw = sd.u64()
                pages = [(sd.i64(), sd.u32())
                         for _ in range(sd.u32())]
                o.blobs[bid] = {"pages": pages, "clen": clen,
                                "raw": raw}
        return oid, o
    return d.versioned(2, body)


class _Staging:
    """Shadow state for one transaction (nothing escapes until commit)."""

    def __init__(self):
        self.onodes: dict[tuple, Onode | None] = {}   # None = removed
        self.colls_created: set[CollectionId] = set()
        self.colls_removed: set[CollectionId] = set()
        self.kv = KVTransaction()
        self.large: list[tuple[int, bytes]] = []      # (phys, 4K payload)
        self.defer: list[tuple[int, bytes]] = []
        self.page_data: dict[int, bytes] = {}         # staged content
        self.allocs: list[int] = []
        self.frees: list[int] = []
        self.touched: set[tuple] = set()              # need onode re-put


class BlueStore(ObjectStore):
    """Durable ObjectStore: block-device pages + KV onodes (see module
    docstring for the layout and crash-ordering rules)."""

    def __init__(self, path: str, defer_limit: int = DEFER_LIMIT,
                 kv_backend: str | None = None,
                 compression: str = "zlib",
                 kv_name: str | None = None,
                 kv_memtable_bytes: int | None = None,
                 kv_cache_bytes: int | None = None,
                 kv_background: bool | None = None):
        self.path = path
        self.defer_limit = defer_limit
        # metadata KV tier: "wal" (snapshot-compacting log) or "sst"
        # (leveled LSM with background flush/compaction, osd/sstkv.py).
        # None = unset; configure_kv may fill it from config before
        # mount, else "wal".  kv_name stands the kv.<name> perf
        # registry (flush/compact/stall/cache telemetry)
        self.kv_backend = kv_backend
        self.kv_name = kv_name
        self.kv_memtable_bytes = kv_memtable_bytes
        self.kv_cache_bytes = kv_cache_bytes
        self.kv_background = kv_background
        # inline blob compression mode ("zlib" | "none") —
        # bluestore_compression_{mode,algorithm} role
        self.compression = None if compression in ("none", "", None) \
            else compression
        self._lock = threading.RLock()
        self._mounted = False
        self._dev = None
        self._kv = None
        self._colls: dict[CollectionId, dict[ObjectId, Onode]] = {}
        self._free: list[int] = []        # heap of free page numbers
        self._refs: dict[int, int] = {}   # phys -> refcount (live pages)
        self._npages = 0
        self._deferred: dict[int, bytes] = {}  # committed, not yet fsync'd
        # staged deferred payloads whose KV commit is still queued in the
        # async pipeline: readable from RAM immediately (read-your-writes
        # before durability) but NOT written to the device until after
        # their batch's KV fsync — an in-place deferred overwrite of a
        # live page must never clobber committed bytes the crash replay
        # would still need
        self._deferred_pending: dict[int, bytes] = {}

    def configure_kv(self, cfg, name: str | None = None) -> None:
        """Fill UNSET kv-tier knobs from config before mount (the
        daemon calls this with its own name so maintenance telemetry
        lands on ``kv.<daemon>``).  Explicit constructor arguments
        always win — a store built with ``kv_backend="sst"`` stays
        sst whatever the config says."""
        if self._mounted:
            return
        if name is not None and self.kv_name is None:
            self.kv_name = name

        def opt(key):
            # per-option guard: a cfg missing ONE knob (older/test
            # schema) must not silently drop the knobs after it
            try:
                return cfg[key]
            except Exception:  # noqa: BLE001
                return None
        if self.kv_backend is None:
            self.kv_backend = opt("kv_backend")
        if self.kv_memtable_bytes is None:
            self.kv_memtable_bytes = opt("kv_memtable_bytes")
        if self.kv_cache_bytes is None:
            self.kv_cache_bytes = opt("kv_cache_bytes")
        if self.kv_background is None:
            bg = opt("kv_bg_maintenance")
            if bg is not None:
                self.kv_background = str(bg).lower() == "on"

    def kv_stats(self) -> dict | None:
        with self._lock:
            return self._kv.stats() if self._kv is not None else None

    # ------------------------------------------------------------ mount
    def mount(self) -> None:
        with self._lock:
            if self._mounted:
                return
            os.makedirs(self.path, exist_ok=True)
            from .kvstore import create_kv
            backend = self.kv_backend or "wal"
            if backend == "wal":
                # bg snapshot compaction: the wal backend's inline
                # stall in miniature moves off the submit (kv-sync)
                # path too, unless explicitly pinned off
                self._kv = WalKV(self.path, name=self.kv_name,
                                 bg_compact=self.kv_background
                                 is not False)
            else:
                kw: dict = {"name": self.kv_name}
                if self.kv_memtable_bytes is not None:
                    kw["memtable_bytes"] = self.kv_memtable_bytes
                if self.kv_cache_bytes is not None:
                    kw["cache_bytes"] = self.kv_cache_bytes
                if self.kv_background is not None:
                    kw["background"] = self.kv_background
                self._kv = create_kv(backend,
                                     os.path.join(self.path, "kv"),
                                     **kw)
            super_raw = self._kv.get(_P_SUPER, "super")
            if super_raw is None:
                self._kv.put(_P_SUPER, "super", str(PAGE).encode())
            elif int(super_raw) != PAGE:
                raise StoreError(f"page size mismatch: {super_raw!r}")
            dev_path = os.path.join(self.path, "block.img")
            if not os.path.exists(dev_path):
                open(dev_path, "wb").close()
            # "r+b", NOT append mode: O_APPEND would force every page
            # write to the end of the device regardless of seek
            self._dev = open(dev_path, "r+b")
            self._dev.seek(0, os.SEEK_END)
            self._npages = self._dev.tell() // PAGE
            self._load_metadata()
            self._replay_deferred()
            self._mounted = True

    def umount(self) -> None:
        self.flush()  # drain the commit pipeline before closing
        with self._lock:
            if not self._mounted:
                return
            self._flush_deferred()
            self._dev.close()
            self._dev = None
            self._kv.close()
            self._kv = None
            self._mounted = False

    def _load_metadata(self) -> None:
        self._colls = {}
        self._refs = {}
        key_to_obj: dict[str, tuple[CollectionId, ObjectId]] = {}
        for ckey, _ in self._kv.iterate(_P_COLL):
            pool, seed = ckey.split(".")
            self._colls[CollectionId(int(pool), int(seed, 16))] = {}
        for okey, raw in self._kv.iterate(_P_ONODE):
            pool, seed = okey.split("|", 1)[0].split(".")
            cid = CollectionId(int(pool), int(seed, 16))
            oid, onode = _decode_onode(raw)
            self._colls.setdefault(cid, {})[oid] = onode
            key_to_obj[okey] = (cid, oid)
            for phys in onode.phys_pages():
                self._refs[phys] = self._refs.get(phys, 0) + 1
        for mkey, val in self._kv.iterate(_P_OMAP):
            okey, _, user = mkey.partition("\x00")
            ref = key_to_obj.get(okey)
            if ref is None:
                continue  # orphaned omap row; ignored (fsck would trim)
            cid, oid = ref
            self._colls[cid][oid].omap[user] = _dec_value(Decoder(val))
        # freelist = every device page nobody references (fsck role:
        # reclaims pages leaked by a crash before their KV commit)
        self._free = [p for p in range(self._npages) if p not in self._refs]
        heapq.heapify(self._free)

    def _replay_deferred(self) -> None:
        """Apply committed-but-unwritten deferred pages (crash window:
        KV committed the content, the device write never happened)."""
        pending = list(self._kv.iterate(_P_DEFER))
        if not pending:
            return
        for key, data in pending:
            self._dev_write(int(key), data)
        self._dev.flush()
        os.fsync(self._dev.fileno())
        tx = KVTransaction()
        for key, _ in pending:
            tx.rm(_P_DEFER, key)
        self._kv.submit(tx)

    # ----------------------------------------------------- device pages
    def _dev_write(self, phys: int, data: bytes) -> None:
        assert len(data) == PAGE
        self._dev.seek(phys * PAGE)
        self._dev.write(data)

    def _dev_read(self, phys: int) -> bytes:
        self._dev.seek(phys * PAGE)
        return self._dev.read(PAGE)

    def _alloc(self, st: _Staging) -> int:
        if not self._free:
            new_pages = range(self._npages, self._npages + EXTEND_PAGES)
            self._npages += EXTEND_PAGES
            self._dev.truncate(self._npages * PAGE)
            for p in new_pages:
                heapq.heappush(self._free, p)
        phys = heapq.heappop(self._free)
        self._refs[phys] = 1
        st.allocs.append(phys)
        return phys

    def _rollback(self, st: _Staging) -> None:
        # st.allocs holds fresh allocations (ref set to 1) AND clone ref
        # bumps (+1 on a live page): undo both by decrementing, freeing
        # only pages that hit zero
        for phys in st.allocs:
            n = self._refs.get(phys, 0) - 1
            if n <= 0:
                self._refs.pop(phys, None)
                heapq.heappush(self._free, phys)
            else:
                self._refs[phys] = n

    def _read_page(self, st: _Staging | None, phys: int, crc: int,
                   verify: bool = True) -> bytes:
        if st is not None and phys in st.page_data:
            return st.page_data[phys]
        data = self._deferred_pending.get(phys)
        if data is None:
            data = self._deferred.get(phys)
        if data is None:
            data = self._dev_read(phys)
        if verify and crc32c(data) != crc:
            raise StoreError(f"checksum mismatch on page {phys}")
        return data

    # ------------------------------------------------------ transactions
    def _prepare(self, tx: Transaction) -> _Staging:
        """Stage against shadow onodes, then pre-commit apply: large
        payloads land on FRESH pages (buffered — the batch fsync makes
        them durable before any KV metadata points at them), the onode/
        omap/defer KV mutations are encoded into the staging's batch,
        and the in-RAM state flips so reads observe the transaction
        immediately (read-your-writes before durability).  What does
        NOT happen here: fsyncs, the KV commit, freed-page release and
        deferred device writes — all batch-ordered in _commit_batch so
        a crash can only lose un-acked suffixes."""
        with self._lock:
            if not self._mounted:
                raise StoreError("not mounted")
            st = _Staging()
            try:
                for op in tx.ops:
                    self._stage(st, op)
            except Exception:
                self._rollback(st)
                raise
            # 1) large writes: buffered now, fsync'd once per batch.
            #    Fresh pages only — never over live data — so the
            #    buffered window cannot clobber committed bytes.
            #    Contiguous pages (the common fresh-allocation shape)
            #    coalesce into one seek+write per run instead of one
            #    syscall pair per 4K page.
            if st.large:
                run_phys = -2
                run: list = []
                for phys, content in sorted(st.large):
                    if phys != run_phys + len(run):
                        if run:
                            self._dev.seek(run_phys * PAGE)
                            self._dev.write(b"".join(run))
                        run_phys, run = phys, []
                    run.append(content)
                if run:
                    self._dev.seek(run_phys * PAGE)
                    self._dev.write(b"".join(run))
            # 2) KV mutations for this tx (order matters: the staged
            #    coll/omap ops are already in st.kv; onodes then
            #    deferred payloads append behind them)
            for (cid, oid), onode in st.onodes.items():
                if (cid, oid) not in st.touched:
                    continue
                key = _onode_key(cid, oid)
                if onode is None:
                    st.kv.rm(_P_ONODE, key)
                else:
                    st.kv.put(_P_ONODE, key, _encode_onode(oid, onode))
            # deferred payloads detach here (they may be memoryview
            # carves over an rx frame; they outlive this call) and
            # become readable from RAM at once
            st.defer = [(phys, bytes(content))
                        for phys, content in st.defer]
            for phys, content in st.defer:
                st.kv.put(_P_DEFER, str(phys), content)
                self._deferred_pending[phys] = content
            # 3) in-RAM state flips to the shadow copies — reads (and
            #    later prepares) see this transaction from now on
            for cid in st.colls_created:
                self._colls.setdefault(cid, {})
            for (cid, oid), onode in st.onodes.items():
                if onode is None:
                    self._colls.get(cid, {}).pop(oid, None)
                else:
                    self._colls.setdefault(cid, {})[oid] = onode
            for cid in st.colls_removed:
                self._colls.pop(cid, None)
            return st

    def _commit_batch(self, items: list) -> int:
        """Group commit: ONE device fsync covering every item's large
        pages, ONE vectored KV append + fsync for the whole batch, then
        the ordered epilogue (freed-page release, deferred device
        writes) that must wait for durability.

        Crash ordering: the device fsync precedes any KV write, so a
        committed (prefix of the) KV batch only ever references durable
        pages; freed pages rejoin the allocator only AFTER the KV fsync
        (a reallocated page's new bytes could otherwise clobber data a
        replayed-but-unfreed onode still points at); deferred device
        writes run after commit exactly as the inline path did, with
        the "D" replay covering the crash window."""
        fsyncs = 0
        if any(st.large for st in items):
            self._dev.flush()
            os.fsync(self._dev.fileno())
            fsyncs += 1
        merged = KVTransaction()
        for st in items:
            merged.ops.extend(st.kv.ops)
        with self._lock:
            # pages whose refcount hits ZERO across this batch shed any
            # pending "D" record IN THIS COMMIT: once free they can be
            # reallocated, and a stale deferred replay after a crash
            # would clobber the new owner.  Dead pages are unreachable
            # from live onodes (every RAM flip already happened at
            # prepare), so no concurrent preparer can re-reference one
            # before the frees apply below.
            dead: set[int] = set()
            refsim: dict[int, int] = {}
            for st in items:
                for phys in st.frees:
                    n = refsim.get(phys, self._refs.get(phys, 0)) - 1
                    refsim[phys] = n
                    if n <= 0:
                        dead.add(phys)
            for phys in dead:
                merged.rm(_P_DEFER, str(phys))
        if merged.ops:
            self._kv.submit(merged, sync=False)
            self._kv.sync()
            fsyncs += 1
        with self._lock:
            for st in items:
                for phys in st.frees:
                    n = self._refs.get(phys, 0) - 1
                    if n <= 0:
                        self._refs.pop(phys, None)
                        self._deferred.pop(phys, None)
                        self._deferred_pending.pop(phys, None)
                        heapq.heappush(self._free, phys)
                    else:
                        self._refs[phys] = n
                for phys, content in st.defer:
                    if phys in dead:
                        continue
                    self._dev_write(phys, content)
                    self._deferred[phys] = content
                    # a LATER (still pending) batch may have re-staged
                    # this page — only retire OUR payload from the
                    # read-path overlay
                    if self._deferred_pending.get(phys) is content:
                        self._deferred_pending.pop(phys, None)
            if len(self._deferred) > DEFER_FLUSH_N:
                self._flush_deferred()
                fsyncs += 2  # device fsync + the trim's KV fsync
        return fsyncs

    # -- staging helpers ---------------------------------------------------
    def _coll_exists(self, st: _Staging, cid: CollectionId) -> bool:
        if cid in st.colls_created:
            return True
        if cid in st.colls_removed:
            return False
        return cid in self._colls

    def _get_onode(self, st: _Staging, cid, oid, create: bool) -> Onode:
        if not self._coll_exists(st, cid):
            raise NoSuchCollection(str(cid))
        key = (cid, oid)
        if key in st.onodes:
            o = st.onodes[key]
            if o is None:
                if not create:
                    raise NoSuchObject(f"{cid}/{oid}")
                o = Onode()
                st.onodes[key] = o
                st.touched.add(key)
            return o
        live = self._colls.get(cid, {}).get(oid)
        if live is None:
            if not create:
                raise NoSuchObject(f"{cid}/{oid}")
            o = Onode()
        else:
            o = live.copy()
        st.onodes[key] = o
        st.touched.add(key)
        return o

    def _free_page(self, st: _Staging, phys: int) -> None:
        if phys >= 0:  # HOLE and blob sentinels are not device pages
            st.frees.append(phys)

    def _blob_raw(self, st: _Staging | None, o: Onode,
                  bid: int) -> bytes:
        """Decompress one blob (crc-verified per compressed page)."""
        import zlib
        b = o.blobs[bid]
        parts = [self._read_page(st, phys, crc)
                 for phys, crc in b["pages"]]
        comp = b"".join(parts)[: b["clen"]]
        return zlib.decompress(comp)

    def _unblob_range(self, st: _Staging, o: Onode, first: int,
                      last: int) -> None:
        """Materialise any blob overlapping logical pages
        [first, last] back to plain pages (the compressed-blob
        rewrite-on-overwrite, Compression.cc GC role)."""
        hit = set()
        for idx in range(min(first, len(o.pages)),
                         min(last + 1, len(o.pages))):
            phys = o.pages[idx][0]
            if phys <= BLOB_BASE:
                hit.add(BLOB_BASE - phys)
        for bid in hit:
            raw = self._blob_raw(st, o, bid)
            span = [i for i, (p, _c) in enumerate(o.pages)
                    if p <= BLOB_BASE and BLOB_BASE - p == bid]
            for i in span:
                off = o.pages[i][1] * PAGE
                content = raw[off: off + PAGE]
                content += b"\0" * (PAGE - len(content))
                phys = self._alloc(st)
                o.pages[i] = (phys, crc32c(content))
                st.page_data[phys] = content
                st.large.append((phys, content))
            for phys, _crc in o.blobs[bid]["pages"]:
                self._free_page(st, phys)
            del o.blobs[bid]

    def _page_content(self, st: _Staging, o: Onode, idx: int) -> bytes:
        """Current (staged-aware) content of logical page idx, zero-padded
        to PAGE."""
        if idx >= len(o.pages) or o.pages[idx][0] == HOLE:
            return b"\0" * PAGE
        phys, crc = o.pages[idx]
        if phys <= BLOB_BASE:
            raw = self._blob_raw(st, o, BLOB_BASE - phys)
            off = crc * PAGE
            content = raw[off: off + PAGE]
            return content + b"\0" * (PAGE - len(content))
        return self._read_page(st, phys, crc)

    def _put_page(self, st: _Staging, o: Onode, idx: int, content: bytes,
                  deferred: bool, crc: int | None = None) -> None:
        """Install new content for logical page idx: allocate (or reuse
        in-place on the deferred path when we are the sole owner) and
        route the payload to the right write path."""
        while len(o.pages) <= idx:
            o.pages.append((HOLE, 0))
        old_phys, _old_crc = o.pages[idx]
        if crc is None:
            crc = crc32c(content)
        in_place = (deferred and old_phys != HOLE
                    and self._refs.get(old_phys, 0) == 1
                    and old_phys not in (p for p, _ in st.large))
        if in_place:
            phys = old_phys
        else:
            phys = self._alloc(st)
            self._free_page(st, old_phys)
        o.pages[idx] = (phys, crc)
        st.page_data[phys] = content
        if deferred:
            st.defer.append((phys, content))
        else:
            st.large.append((phys, content))

    def _write_range(self, st: _Staging, o: Onode, offset: int,
                     data: bytes) -> None:
        if not data:
            return
        deferred = len(data) <= self.defer_limit
        end = offset + len(data)
        first, last = offset // PAGE, (end - 1) // PAGE
        # a write over a compressed range first materialises the blob
        # (partial overwrite of compressed data is read-modify-write)
        self._unblob_range(st, o, first, last)
        if self.compression and not deferred and \
                self._try_compress(st, o, offset, data):
            return
        ref_b = copy_b = 0
        # per-page csums for the whole-page span in ONE native sweep
        # (a ctypes round-trip per 4K page dominates MiB-scale ingest)
        full_first = first if offset % PAGE == 0 else first + 1
        full_last = last if end % PAGE == 0 else last - 1
        full_crcs: list[int] = []
        if full_last >= full_first:
            full_crcs = crc32c_blocks(
                data[full_first * PAGE - offset: (full_last + 1) * PAGE
                     - offset], PAGE)
        for idx in range(first, last + 1):
            pstart = idx * PAGE
            lo = max(offset, pstart) - pstart
            hi = min(end, pstart + PAGE) - pstart
            if lo == 0 and hi == PAGE:
                # whole-page run: a slice of the caller's buffer — for
                # a memoryview payload this is BY REFERENCE (detached
                # at the buffered write() syscall in _prepare, so the
                # rx frame never pins past the enqueue)
                content = data[pstart - offset: pstart - offset + PAGE]
                if isinstance(content, memoryview):
                    ref_b += PAGE
                else:
                    copy_b += PAGE
                self._put_page(st, o, idx, content, deferred,
                               crc=full_crcs[idx - full_first])
            else:
                old = bytearray(self._page_content(st, o, idx))
                old[lo:hi] = data[pstart + lo - offset: pstart + hi - offset]
                content = bytes(old)
                copy_b += PAGE
                self._put_page(st, o, idx, content, deferred)
        if ref_b:
            self._book("store_ingest_ref_bytes", ref_b)
        if copy_b:
            self._book("store_ingest_copy_bytes", copy_b)
        o.size = max(o.size, end)

    def _try_compress(self, st: _Staging, o: Onode, offset: int,
                      data: bytes) -> bool:
        """Blob-compress the aligned whole-page run of this write when
        it spans enough pages AND actually saves space (required_ratio)
        — the Compression.cc inline path.  Unaligned head/tail bytes
        fall through to the plain path.  Returns True when the WHOLE
        write was consumed."""
        import zlib
        if offset % PAGE or len(data) % PAGE:
            return False  # keep it simple: only fully aligned writes
        n = len(data) // PAGE
        if n < COMPRESS_MIN_PAGES:
            return False
        comp = zlib.compress(data, 1)
        cpages = (len(comp) + PAGE - 1) // PAGE
        if cpages > n * COMPRESS_RATIO:
            return False  # not compressible enough to bother
        first = offset // PAGE
        bid = (max(o.blobs) + 1) if o.blobs else 0
        blob_pages = []
        for i in range(cpages):
            chunk = comp[i * PAGE: (i + 1) * PAGE]
            chunk += b"\0" * (PAGE - len(chunk))
            phys = self._alloc(st)
            blob_pages.append((phys, crc32c(chunk)))
            st.page_data[phys] = chunk
            st.large.append((phys, chunk))
        o.blobs[bid] = {"pages": blob_pages, "clen": len(comp),
                        "raw": len(data)}
        while len(o.pages) < first + n:
            o.pages.append((HOLE, 0))
        for i in range(n):
            self._free_page(st, o.pages[first + i][0])
            o.pages[first + i] = (BLOB_BASE - bid, i)
        o.size = max(o.size, offset + len(data))
        return True

    def _zero_range(self, st: _Staging, o: Onode, offset: int,
                    length: int) -> None:
        if length <= 0:
            o.size = max(o.size, offset)
            return
        end = offset + length
        first, last = offset // PAGE, (end - 1) // PAGE
        self._unblob_range(st, o, first, last)
        for idx in range(first, last + 1):
            pstart = idx * PAGE
            lo = max(offset, pstart) - pstart
            hi = min(end, pstart + PAGE) - pstart
            if idx >= len(o.pages):
                break  # beyond current pages: holes already read as zero
            if lo == 0 and hi == PAGE:
                self._free_page(st, o.pages[idx][0])
                o.pages[idx] = (HOLE, 0)
            elif o.pages[idx][0] != HOLE:
                old = bytearray(self._page_content(st, o, idx))
                old[lo:hi] = b"\0" * (hi - lo)
                self._put_page(st, o, idx, bytes(old), True)
        o.size = max(o.size, end)

    def _truncate(self, st: _Staging, o: Onode, size: int) -> None:
        if size < o.size:
            keep = (size + PAGE - 1) // PAGE
            self._unblob_range(st, o, max(0, keep - 1),
                               len(o.pages) - 1)
            for phys, _crc in o.pages[keep:]:
                self._free_page(st, phys)
            del o.pages[keep:]
            tail = size % PAGE
            if tail and keep <= len(o.pages) and keep >= 1 \
                    and o.pages[keep - 1][0] != HOLE:
                # zero the bytes past the new size inside the tail page so
                # a later grow reads zeros (MemStore truncate semantics)
                old = bytearray(self._page_content(st, o, keep - 1))
                old[tail:] = b"\0" * (PAGE - tail)
                self._put_page(st, o, keep - 1, bytes(old), True)
        o.size = size

    def _remove_onode(self, st: _Staging, cid, oid) -> None:
        o = self._get_onode(st, cid, oid, create=False)
        for phys in o.phys_pages():
            self._free_page(st, phys)
        # drop the omap rows here, while the (possibly staged) key set is
        # known — a later re-create in the same tx must not inherit them
        okey = _onode_key(cid, oid)
        for k in o.omap:
            st.kv.rm(_P_OMAP, f"{okey}\x00{k}")
        st.onodes[(cid, oid)] = None
        st.touched.add((cid, oid))

    def _stage(self, st: _Staging, op) -> None:
        kind = op[0]
        if kind == TxOp.CREATE_COLLECTION:
            st.colls_created.add(op[1])
            st.colls_removed.discard(op[1])
            st.kv.put(_P_COLL, f"{op[1].pool}.{op[1].pg_seed:x}", b"1")
            return
        if kind == TxOp.REMOVE_COLLECTION:
            cid = op[1]
            if not self._coll_exists(st, cid):
                raise NoSuchCollection(str(cid))
            # every object goes: committed ones AND ones created earlier
            # in this same transaction (staged onodes)
            doomed = set(self._colls.get(cid, {}))
            doomed.update(o for (c, o), onode in st.onodes.items()
                          if c == cid and onode is not None)
            for oid in doomed:
                if st.onodes.get((cid, oid), "absent") is not None:
                    self._remove_onode(st, cid, oid)
            st.colls_removed.add(cid)
            st.colls_created.discard(cid)
            st.kv.rm(_P_COLL, f"{cid.pool}.{cid.pg_seed:x}")
            return
        cid, oid = op[1], op[2]
        if kind == TxOp.TOUCH:
            self._get_onode(st, cid, oid, create=True)
        elif kind == TxOp.WRITE:
            o = self._get_onode(st, cid, oid, create=True)
            # contiguous(): single-buffer payloads (the rx-carved wire
            # path) arrive as a zero-copy view — whole aligned pages
            # slice out of it by reference straight into the buffered
            # device write; partial pages rebuild (copy) as ever
            self._write_range(st, o, op[3], op[4].contiguous())
        elif kind == TxOp.ZERO:
            o = self._get_onode(st, cid, oid, create=True)
            self._zero_range(st, o, op[3], op[4])
        elif kind == TxOp.TRUNCATE:
            o = self._get_onode(st, cid, oid, create=True)
            self._truncate(st, o, op[3])
        elif kind == TxOp.REMOVE:
            self._remove_onode(st, cid, oid)
        elif kind == TxOp.SETATTRS:
            o = self._get_onode(st, cid, oid, create=True)
            o.attrs.update(op[3])
        elif kind == TxOp.RMATTR:
            o = self._get_onode(st, cid, oid, create=False)
            o.attrs.pop(op[3], None)
        elif kind == TxOp.OMAP_SETKEYS:
            o = self._get_onode(st, cid, oid, create=True)
            o.omap.update(op[3])
            okey = _onode_key(cid, oid)
            for k, v in op[3].items():
                e = Encoder(); _enc_value(e, v)
                st.kv.put(_P_OMAP, f"{okey}\x00{k}", e.tobytes())
        elif kind == TxOp.OMAP_RMKEYS:
            o = self._get_onode(st, cid, oid, create=False)
            okey = _onode_key(cid, oid)
            for k in op[3]:
                o.omap.pop(k, None)
                st.kv.rm(_P_OMAP, f"{okey}\x00{k}")
        elif kind == TxOp.CLONE:
            src = self._get_onode(st, cid, op[2], create=False)
            dst_oid = op[3]
            dst = self._get_onode(st, cid, dst_oid, create=True)
            for phys in dst.phys_pages():  # clone fully replaces dst
                self._free_page(st, phys)
            dst.size = src.size
            dst.attrs = dict(src.attrs)
            dst.pages = list(src.pages)
            dst.blobs = {i: {"pages": list(b["pages"]),
                             "clen": b["clen"], "raw": b["raw"]}
                         for i, b in src.blobs.items()}
            for phys in src.phys_pages():  # share pages, bump refs
                self._refs[phys] = self._refs.get(phys, 0) + 1
                st.allocs.append(phys)  # rollback undoes the bump
            dst_key = _onode_key(cid, dst_oid)
            for k in dst.omap:
                st.kv.rm(_P_OMAP, f"{dst_key}\x00{k}")
            dst.omap = dict(src.omap)
            for k, v in dst.omap.items():
                e = Encoder(); _enc_value(e, v)
                st.kv.put(_P_OMAP, f"{dst_key}\x00{k}", e.tobytes())
        else:  # pragma: no cover
            raise StoreError(f"unknown tx op {kind}")

    def _flush_deferred(self) -> None:
        if not self._deferred:
            return
        self._dev.flush()
        os.fsync(self._dev.fileno())
        tx = KVTransaction()
        for phys in self._deferred:
            tx.rm(_P_DEFER, str(phys))
        self._kv.submit(tx)
        self._deferred.clear()

    # ------------------------------------------------------------ reads
    def _onode(self, cid, oid) -> Onode:
        coll = self._colls.get(cid)
        if coll is None:
            raise NoSuchCollection(str(cid))
        o = coll.get(oid)
        if o is None:
            raise NoSuchObject(f"{cid}/{oid}")
        return o

    def read(self, cid, oid, offset: int = 0,
             length: int | None = None) -> BufferList:
        with self._lock:
            o = self._onode(cid, oid)
            end = o.size if length is None else min(offset + length, o.size)
            if offset >= end:
                return BufferList(b"")
            first, last = offset // PAGE, (end - 1) // PAGE
            parts = []
            blob_cache: dict[int, bytes] = {}
            for idx in range(first, last + 1):
                if idx < len(o.pages) and o.pages[idx][0] != HOLE:
                    phys, crc = o.pages[idx]
                    try:
                        if phys <= BLOB_BASE:
                            bid = BLOB_BASE - phys
                            raw = blob_cache.get(bid)
                            if raw is None:
                                raw = self._blob_raw(None, o, bid)
                                blob_cache[bid] = raw
                            seg = raw[crc * PAGE: crc * PAGE + PAGE]
                            parts.append(seg + b"\0" * (PAGE - len(seg)))
                        else:
                            parts.append(self._read_page(None, phys,
                                                         crc))
                    except StoreError:
                        raise StoreError(
                            f"checksum mismatch on {cid}/{oid}")
                else:
                    parts.append(b"\0" * PAGE)
            blob = b"".join(parts)
            lo = offset - first * PAGE
            return BufferList(blob[lo:lo + (end - offset)])

    def deep_verify(self, cid, oid) -> bool:
        """Re-read every page from the device and verify its checksum
        (deep-scrub primitive; returns False on rot)."""
        with self._lock:
            try:
                o = self._onode(cid, oid)
            except (NoSuchCollection, NoSuchObject):
                return True
            entries = [(p, c) for p, c in o.pages if p >= 0]
            for b in o.blobs.values():
                entries.extend(b["pages"])
            for phys, crc in entries:
                data = self._deferred_pending.get(phys)
                if data is None:
                    data = self._deferred.get(phys)
                if data is None:
                    data = self._dev_read(phys)
                if crc32c(data) != crc:
                    return False
            return True

    def stat(self, cid, oid) -> dict:
        with self._lock:
            o = self._onode(cid, oid)
            return {"size": o.size, "attrs": len(o.attrs),
                    "omap": len(o.omap)}

    def exists(self, cid, oid) -> bool:
        with self._lock:
            return oid in self._colls.get(cid, {})

    def getattrs(self, cid, oid) -> dict[str, bytes]:
        with self._lock:
            return dict(self._onode(cid, oid).attrs)

    def omap_get(self, cid, oid) -> dict[str, bytes]:
        with self._lock:
            return dict(self._onode(cid, oid).omap)

    def list_objects(self, cid) -> list[ObjectId]:
        with self._lock:
            coll = self._colls.get(cid)
            if coll is None:
                raise NoSuchCollection(str(cid))
            return sorted(coll)

    def list_collections(self) -> list[CollectionId]:
        with self._lock:
            return sorted(self._colls)

    # ------------------------------------------------------- diagnostics
    def fsck(self) -> dict:
        """Cross-check allocator vs onode page maps (BlueStore fsck
        role).  Returns counters; raises nothing."""
        with self._lock:
            referenced: dict[int, int] = {}
            for coll in self._colls.values():
                for o in coll.values():
                    for phys in o.phys_pages():
                        referenced[phys] = referenced.get(phys, 0) + 1
            free = set(self._free)
            leaked = [p for p in range(self._npages)
                      if p not in referenced and p not in free]
            double = [p for p in referenced if p in free]
            bad_refs = {p: (self._refs.get(p), n)
                        for p, n in referenced.items()
                        if self._refs.get(p) != n}
            return {"pages": self._npages, "referenced": len(referenced),
                    "free": len(free), "leaked": leaked,
                    "double_booked": double, "bad_refcounts": bad_refs}
