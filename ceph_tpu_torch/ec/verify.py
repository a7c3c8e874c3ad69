"""Folded CRC32C verify: the deep-scrub half of the batching seam.

The counterpart of the JAX package's ``ceph_tpu/ec/verify.py``.  Deep
scrub's per-object loop pays one Python round-trip per object; this
module gives scrub the fused write path's digests WITHOUT needing a
codec (replicated pools scrub too): many objects' stored bytes,
zero-padded to one length bucket, stack into a single ``(n, L)`` launch
whose rows each produce a standard CRC32C.  Variable lengths ride the
fold through the zero-extension identity
(ops/checksum.crc32c_extend_zeros): the EXPECTED digest of a padded row
is derived on the host from the write-time digest.

Two interchangeable backends, byte-exact against each other:

- ``torch``: the CRC32C kernel G1 (ops/checksum.crc32c_chunks) over the
  ``(n, L)`` rows on the verifier's device, one launch per flush; on a
  CPU device its plain version;
- ``native``: one ctypes sweep over the folded buffer
  (ops/native.crc32c_blocks) — still one Python call per launch.

``mode`` mirrors the ``osd_scrub_fold`` option: ``auto`` picks the
kernel when a CUDA card is present and the native sweep otherwise;
``device`` forces the torch backend on ``device`` (``CrcVerifier``'s
default ``cuda`` raises without a card; ``verifier``'s default is the
card where there is one, else the CPU); ``native`` forces the host
sweep.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..ops import native
from ..ops.checksum import crc_plan


class CrcVerifier:
    """Digest engine for the batcher's ``verify`` op kind: rows
    ``(n, L)`` uint8 -> ``(n,)`` uint32 standard CRC32C.  Stateless
    apart from its device; one shared instance per OSD."""

    def __init__(self, mode: str = "auto", device="cuda"):
        if mode not in ("auto", "device", "native"):
            raise ValueError(f"unknown verify mode {mode!r}")
        self.mode = mode
        self.device = None
        self._backend = "native"
        if mode == "device" or (mode == "auto"
                                and torch.cuda.is_available()):
            self.device = torch.device(device)
            if (self.device.type == "cuda"
                    and not torch.cuda.is_available()):
                raise RuntimeError("CrcVerifier: device cuda requested "
                                   "but torch.cuda.is_available() is "
                                   "False")
            self._backend = "torch"

    # identity the batch signature carries: two verifiers configured
    # differently must not coalesce (their flush paths differ)
    def fold_sig(self) -> tuple:
        return ("crc32c", self._backend)

    def digests(self, rows: np.ndarray) -> np.ndarray:
        """Per-row standard CRC32C of a ``(n, L)`` uint8 fold
        (L % 4 == 0 — every length bucket is).  Returns ``(n,)`` uint32
        host array."""
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        n, L = rows.shape
        if L % 4:
            raise ValueError("fold width must be a multiple of 4")
        if self._backend == "torch":
            words = torch.from_numpy(rows).to(self.device).view(torch.int32)
            out = crc_plan(L).device_fn()(words)
            return out.cpu().numpy()
        return np.array(native.crc32c_blocks(rows, L), dtype=np.uint32)


_SINGLETONS: dict[tuple, CrcVerifier] = {}
_SINGLETON_LOCK = threading.Lock()


def verifier(mode: str = "auto", device=None) -> CrcVerifier:
    """Process-wide verifier per (mode, device) — every OSD in a test
    cluster shares one process.  With no ``device``, the card where
    there is one and the CPU otherwise, so ``device`` mode runs the
    torch path's plain version on a host without a card, as the JAX
    package runs its device graph on the CPU there."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    key = (mode, str(device))
    with _SINGLETON_LOCK:
        v = _SINGLETONS.get(key)
        if v is None:
            v = _SINGLETONS[key] = CrcVerifier(mode, device)
        return v
