"""Inline store compression: the at-rest half of the PR's seam.

Reference semantics (BlueStore ``bluestore_compression_*`` +
per-pool ``compression_*`` pool options, src/os/bluestore/BlueStore.cc
_do_write_data compression decision):

- ``none``: never compress;
- ``passive``: compress only whole-object ingest writes (the store's
  hinted path — partial overwrites and extent updates stay raw);
- ``aggressive``: compress every whole-object write (partial
  overwrites still decompress the blob first — extent arithmetic
  happens in raw space — and the next full rewrite re-compresses).

The decision is strictly AT-REST and local to ``_apply_write``:
everything on the wire — client data, EC chunks, recovery pushes,
scrub repair pushes — is RAW bytes.  Each OSD compresses its own
store per the (map-shared) pool policy with a deterministic codec, so
replicas land byte-identical and replica digest compare in scrub
stays meaningful.

Stored-extent metadata rides the attr dict: ``cz`` = algorithm name,
``crl`` = raw (uncompressed) length.  The stored digest ``d`` is
always computed over the STORED bytes, so deep scrub verifies
compressed extents without inflating them; ``len`` keeps logical
(raw) semantics everywhere.

Telemetry (registered zeroed by the daemon): ``compress_blobs`` /
``compress_rejected`` count decisions, ``bluestore_compressed_
original`` / ``bluestore_compressed_allocated`` accumulate raw vs
stored bytes of accepted blobs — allocated/original is the live
compression ratio.
"""

from __future__ import annotations

from ..compress.registry import factory

#: per-pool option names (ec_profile / pool-options dict keys); each
#: falls back to the osd_compression_* config default
POOL_OPTS = ("compression_mode", "compression_algorithm",
             "compression_required_ratio", "compression_min_blob_size")

MODES = ("none", "passive", "aggressive")

#: perf counters the daemon registers zeroed (stable exporter schema)
COUNTERS = ("compress_blobs", "compress_rejected",
            "compress_decompress",
            "bluestore_compressed_original",
            "bluestore_compressed_allocated")


class CompressionPolicy:
    """One pool's resolved compression decision."""

    __slots__ = ("mode", "algorithm", "required_ratio",
                 "min_blob_size", "_codec")

    def __init__(self, mode: str, algorithm: str,
                 required_ratio: float, min_blob_size: int):
        if mode not in MODES:
            raise ValueError(f"bad compression_mode {mode!r}")
        self.mode = mode
        self.algorithm = algorithm
        self.required_ratio = float(required_ratio)
        self.min_blob_size = int(min_blob_size)
        # fail at policy-build time, not in the write path
        self._codec = factory(algorithm) if mode != "none" else None

    @classmethod
    def from_pool(cls, pool, cfg) -> "CompressionPolicy | None":
        """Resolve a pool's policy: pool-option overrides (the
        ec_profile dict carries them as strings, replicated pools'
        pass-through profile included) over the osd_compression_*
        defaults.  Returns None when the resolved mode is none — the
        write path pays one attribute test, nothing else."""
        prof = getattr(pool, "ec_profile", None) or {}
        mode = str(prof.get("compression_mode",
                            cfg.get("osd_compression_mode")))
        if mode == "none":
            return None
        return cls(
            mode,
            str(prof.get("compression_algorithm",
                         cfg.get("osd_compression_algorithm"))),
            float(prof.get("compression_required_ratio",
                           cfg.get("osd_compression_required_ratio"))),
            int(prof.get("compression_min_blob_size",
                         cfg.get("osd_compression_min_blob_size"))))

    def maybe_compress(self, data: bytes, perf=None):
        """(stored_bytes, {"cz", "crl"}) when the blob compresses well
        enough to keep, else None (store raw; reads pay nothing)."""
        n = len(data)
        if n < self.min_blob_size:
            return None
        stored = self._codec.compress(bytes(data))
        if len(stored) > n * self.required_ratio:
            if perf is not None:
                perf.inc("compress_rejected")
            return None
        if perf is not None:
            perf.inc("compress_blobs")
            perf.inc("bluestore_compressed_original", n)
            perf.inc("bluestore_compressed_allocated", len(stored))
        return stored, {"cz": self._codec.name, "crl": n}


def decompress(stored: bytes, algorithm: str, raw_len: int,
               perf=None) -> bytes:
    """Inflate one stored blob back to its raw bytes (bounded by the
    recorded raw length — a corrupt frame cannot balloon)."""
    try:
        raw = factory(str(algorithm)).decompress(bytes(stored),
                                                 max_out=int(raw_len))
    except ValueError:
        raise
    except Exception as e:  # noqa: BLE001 - codec-specific error types
        raise ValueError(f"decompress ({algorithm}) failed: {e!r}")
    if len(raw) != int(raw_len):
        raise ValueError(
            f"decompressed length {len(raw)} != recorded {raw_len}")
    if perf is not None:
        perf.inc("compress_decompress")
    return raw


def validate_pool_opts(profile: dict) -> None:
    """Mon-side pool-option validation (pool create / set): reject a
    profile whose compression options cannot build a policy — a bad
    algorithm name must fail the command, not every OSD's write
    path."""
    mode = str(profile.get("compression_mode", "none"))
    if mode not in MODES:
        raise ValueError(f"compression_mode must be one of {MODES}")
    if mode == "none":
        return
    alg = str(profile.get("compression_algorithm", "czlib"))
    factory(alg)  # raises on unknown plugin
    rr = float(profile.get("compression_required_ratio", 0.875))
    if not 0.0 <= rr <= 1.0:
        raise ValueError("compression_required_ratio must be in [0, 1]")
    mb = int(profile.get("compression_min_blob_size", 4096))
    if mb < 0:
        raise ValueError("compression_min_blob_size must be >= 0")
