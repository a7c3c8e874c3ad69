#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and hold its
hand-written kernels against their plain versions.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA card (an
H100; the kernels are built for sm_90a).  It builds the CUDA library
from ceph_tpu_torch/csrc/ and the native library from native/.  Phases,
in order, one line each:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — nvcc builds every kernel from ceph_tpu_torch/csrc/, one
             process per source, all started together.
3. kernels — each region kernel (K1, K2, G4) against its plain version
             on the card (torch.equal) and against the numpy oracle, over
             the listed matrices and lengths, K3 in plane-row and in packet
             mode; CUDA-event times at the main shapes (K1, K2 and G4 at
             the 3x8 encode and the 8x8 decode, with K1's and G4's
             instruction floors and G4's library yardstick torch._int_mm),
             with K3's yardstick (a device copy of the same bytes).  G4
             also takes BITMM_CASES through its wrapper: all-0xFF data at
             c = 32 with sums of 256, r = 1 and r = 16, c = 11 on one half
             of K, ragged last tiles; its ptxas lines are printed here
             (the phase fails if a build ran and they are missing).
4. crc     — G1, the CRC32C kernel, against its plain version and the
             native library's crc32c at chunk lengths from 4 bytes to
             1 MiB + 4 on 1 to 704 rows, all-zero and all-0xFF chunks
             too; CUDA-event time at (11, 8 MiB) in 128 KiB chunks beside
             its bound and a device copy moving the same bytes.
5. slice   — the ``tpu`` plugin (reed_sol_van k=8, m=3) on the card:
             encode_batch / decode_batch of 64 x 1 MiB stripes and
             encode / decode through the interface, byte-exact.
6. cli     — tools.ec_benchmark encode and decode at 80 MiB x 10.
7. corpus  — tools.ec_non_regression --check on the 11 directories of
             corpus/ of the matrix and bit-matrix codes.
8. bits    — the jerasure bit-matrix techniques (liberation k=5,
             blaum_roth k=4, liber8tion k=6, m=2) on the card: a 4 MiB
             object encoded and decoded for every 1- and 2-erasure
             pattern, byte-exact against the numpy-backend codec.
9. bitcli  — tools.ec_benchmark for them at 80 MiB x 3 (encode, decode
             with 2 erasures) and an isa k=8 m=4 encode.
10. bitcorpus — their corpus directories again with the device-apply size
             rule at 0, so the scheduled-XOR kernel sees the corpus bytes.
11. write  — the EC write path at the OSD's batching defaults: 8 writer
             threads x 16 checksummed encodes of 1 MiB stripes (k=8,
             m=3) through one ECBatcher, then 8 threads of degraded reads
             of every stripe (shards 1, 4, 9 missing; half the survivors
             from a DeviceArena as tensors), then one folded scrub verify
             with one bit flipped; parity against the oracle, csums
             against native crc32c, reads and digests exact.  Between the
             writes and the reads, two flushes of 8 checksummed encodes
             of four lengths in one bucket (two of them not whole words),
             which the fused op cannot take.
12. shec   — SHEC k=8, m=4, c=3 at 1 MiB stripes: an 8 MiB object decoded
             through the interface for every set of 1, 2 and 3 erased
             chunks (decoded or refused as the numpy codec does), then 8
             threads x 8 checksummed encodes through one ECBatcher at the
             OSD's defaults (the fused encode+CRC op on 12 rows), then
             degraded reads of every stripe with one data chunk missing
             (a fold of SHEC's narrow window) and with 3 chunks missing.
13. clay   — CLAY k=8, m=4, d=11 (64 planes) at 1 MiB stripes through the
             same kind of ECBatcher: 64 checksummed encodes (the sub-chunk
             fold), repairs of each of the 12 chunks of 16 objects from 8
             threads (the repair fold, 16 of 64 planes from each of 11
             helpers), and a 4-erasure decode of the 16 objects (the
             sub-chunk decode fold), against the numpy codec.
14. widecorpus — tools.ec_non_regression --check on the four wide-code
             directories of corpus/ (lrc, shec, two clay).
15. bench  — the port's bench twin (tools/bench_tpu) at BASELINE's k=8,
             m=3: encode at 4 KiB, 64 KiB, 1 MiB and 4 MiB stripes,
             decode and the fused encode+CRC at 1 MiB, each candidate's
             kernel GB/s, staging and end-to-end GB/s, digests verified;
             then tools/bench_sweep --only headline_1M_b64 through its
             subprocess.
16. cluster — the port's control plane: tools.dencoder checks
             corpus_wire/ (all 55 files); three
             MonitorLites on a LocalNetwork form a quorum; ``osd pool
             create`` makes a tpu reed_sol_van k=8 m=3 pool at pg_num 1024
             from a profile with backend=torch, with no kernel launch and
             no card allocation (the monitor checks profiles on the
             host); 96 OSDs of 12
             hosts boot through MOSDBoot from a stub sender and the
             quorum commits the map; the committed map goes to a
             Dispatcher as an MMapPush over the TCP messenger on loopback
             in secure mode, and the PG-mapping digest of the decoded map
             must equal CLUSTER_DIGEST; the codec built from the pushed
             pool as the OSD builds it (ec_backend torch) encodes an (8,
             8 MiB) stack twice, against native.encode_region.
17. osd    — the port's cluster: a MiniCluster of 14 OSDs on 14 hosts and
             one monitor on the default config but OSD_CONFIG
             (ec_backend torch: every codec on the card), the tpu reed_sol_van k=8 m=3 pool at
             pg_num 64 with the 4 KiB stripe unit; 8 client threads write
             64 seeded objects of 4 MiB (256 MiB of data; cut from 128 so
             the whole run stays near 330 s), read each back
             twice (the second pass must find the arena: extent-cache
             serves and arena hits), a folded deep scrub of one PG on each
             of its OSDs, then two of its OSDs killed and marked down:
             every object read back degraded while recovery rebuilds their
             shards onto the spares the placement re-draws (a down OSD
             leaves the up sets at once here, so no "osd out" is needed to
             start it), waited for with a deadline, and a sample read
             again.  The 14 OSDs share one process, so the phase sets
             OSD_CONFIG over the defaults.  It fails if an op waited out
             the op timeout or an OSD dropped a message.  It prints the
             [osd] line: write, read and degraded-read GB/s, recovery
             seconds, ops a launch, launches of each kernel, copies back
             a flush, arena hits, timed-out ops and dropped messages.
18. bench_root — the port's twin of the repo's bench.py
             (tools/bench_root) at the reference's defaults: the kernel
             modes in this process, each with its own launch counts —
             ``--scrub`` (384 objects folded through ECBatcher.verify
             into G1), ``--ec-batch --no-overhead`` (the batched,
             per-op, sharded, plane and adaptive bursts, the kernel
             candidates on a staged fold, the wire, store and KV legs;
             not the tracing, exemplar and perf-query overhead bursts,
             whose 5 % gates two sets of identical bursts miss on the
             card's host, experiments/burst_noise.py) and
             ``--ec-recovery --progress`` (the storm, the
             max_bytes sweep, the wide matrix and the progress story);
             then the cluster modes, each a child with its timeout
             (``--ec-read``, ``--read-storm``, ``--saturate --smoke``:
             native clusters, no kernel), and the sweep's
             scrub_throughput row through tools/bench_sweep.  It prints
             a [bench_root] line of each mode's numbers.  Two options of
             ``--saturate`` are not run here (ROADMAP, Queue 3):
             ``--tenants``, whose weight-split gate reads below its
             bound in both packages on a host of this size, and
             ``--frontend rgw``, whose recovery deadline a fault shared
             with the JAX package misses in some runs (a divergent
             rollback drops shards of the gateway's objects).
19. mesh   — the multi-device fan-out (ceph_tpu_torch/parallel) on one
             card: parallel.mesh.force_devices puts 8 logical devices on
             cuda:0, each with a CUDA stream of its own, as a dp=2 x
             shard=4 mesh; DistributedStripeEC of StripeCodec(8, 3) on 64
             stripes of 1 MiB (the folded (8, 8 MiB) main shape) writes,
             rebalances by +1 and -1, recovers from chunks 1, 4 and 9
             lost, applies a parity delta and reduces its stats, each
             step held byte for byte against the same work on one device
             and sampled columns against the numpy oracle, the digest
             against numpy's wrapped sum; 8 writers each encode an (8,
             128 KiB) stripe through an ECBatcher on a tpu codec of
             shard=8, plain and checksummed (one sharded launch each,
             parity and csums against the native library); the host mesh
             2x1x4 in this process; two parallel.dcn_worker children, 4
             logical devices each on cuda:0, in a gloo group (equal
             digests, exact recovery); tools.ec_tool encodes an 8 MiB file
             on the card and decodes it with chunks 1, 4 and 9 removed.
             Each step's CUDA-event ms and GB/s are printed, and the
             launches of each kernel and each logical device.
20. services — the block, file and gateway services and the operator
             tools: (a) the port's tools.smoke scorecard (``--device
             cuda``) in this process, its EC pool's codec on the card,
             all 15 checks (rbd over NBD, rgw, .snap views, the mgr
             dashboard, split and merge, cephx caps, NVMe-oF, SMB,
             standby-replay, the EC audit, tracing, the fused
             encode+CRC kernel check ...) must PASS; (b) an RBD image of
             512 MiB (SERVICES) in rbd's 4 MiB objects, all 128 in one
             PG, on phase 17's cluster and tpu k=8 m=3 pool:
             written by 8 threads through
             the Image API in whole objects, 64 MiB again through
             NbdClient and 64 MiB through NvmeInitiator at 1 MiB a
             request, 2048 random 4 KiB overwrites, a snapshot and 256
             more, then two OSDs of the image's PGs killed and marked
             down, the whole head read back degraded through the Image
             API while recovery rebuilds, 64 MiB through NBD and the
             whole snapshot; every read byte-exact against a host copy.
             It prints the [services] line: GB/s of each write route and
             of the degraded read, 4 KiB overwrites a second, recovery
             seconds, the writes the OSDs took by route (full-stripe
             encode, parity delta, row read-modify-write), each kernel's
             launches, copies back a flush, timed-out ops and dropped
             messages.

Phases 5-7 are the main path of the ``tpu`` plugin, phases 8-10 the
bit-matrix path, phase 11 the write path, phases 12-14 the wide path and
phase 16 the cluster path, phase 17 the OSD path, phase 19 the mesh
path and phase 20 the services path: the launch counts are set to 0 before each path and read after it.
The region kernels must have launched on the first, the scheduled-XOR
kernel on the second, G1 and a region kernel on the third, the plain
versions on none, and no kernel pick may have skipped a candidate but
``mxu`` on a matrix wider than 32 columns; G4 must have launched on
every path that raced a matrix of 32 columns or fewer; where the first
path raced a matrix of phase 3 at its length, it must have pinned a
kernel that phase 3 timed within 5 % of the fastest.  On the write path every
encode flush of one length must have taken the fused encode+CRC op,
every flush of several lengths one G1 launch per length and no fused
op, no CRC may have run on the host, and every encode and decode flush
must have left the card in exactly one copy.  On the wide path a region
kernel must have launched and the plain versions never, every checksummed
SHEC encode flush must have taken the fused op, a SHEC fold of one lost
data chunk must have read fewer than k rows, and at least one sub-chunk
flush and one repair flush must have carried more than one op.  On the
cluster phase (its own counts) a region kernel must have launched and
the plain versions never.  On the OSD phase (its own counts) a region
kernel and G1 must have launched and the plain versions never, every
codec and arena must be on the card, a write must have taken the fused
op, the second reads must have found the arena, the scrub must have
verified the PG clean on G1 and the degraded reads must have decoded on a
region kernel.  On the bench_root phase every mode must exit 0 with its
row verified;
``--scrub`` must have launched G1, ``--ec-batch`` and ``--ec-recovery``
K1, K2 and G4, none a plain version or an ``xla`` pick, and the plane
leg must have made one copy back a flush.  On the mesh phase K1, K2, G4
and G1 must have launched and the plain versions never, every logical
device's slice (in this process and in each child) must have launched a
region kernel, and each batcher burst must have made a sharded launch.
On the services phase (its own counts) the scorecard must have passed
its 15 checks with a region kernel and G1 launched, the image's writes
must have launched a region kernel and G1 (the fused writes), its
degraded reads a region kernel, no plain version may have run, every
codec and arena must be on the card, and no op may have timed out and
no OSD dropped a message.  Then one JSON line lists every kernel
(``mesh_launches``: its launches on phase 19, ``services_launches``: on
phase 20), and the last line is the ``{"ok": true, "device": ...}``
object.  Any failure exits nonzero, and so does a process with no CUDA
card.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import itertools
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ceph_tpu_torch import ec
from ceph_tpu_torch.ec import batcher as ec_batcher
from ceph_tpu_torch.ec.bitmatrix_code import BitMatrixErasureCode
from ceph_tpu_torch.ec.matrix_code import MatrixErasureCode, _shape_bucket
from ceph_tpu_torch.mon import maps as mon_maps, monitor
from ceph_tpu_torch.msg import messages, tcp
from ceph_tpu_torch.msg.messenger import (Dispatcher, LocalNetwork,
                                          Messenger, Policy)
from ceph_tpu_torch.ops import (checksum, cuda_lib, ec_kernels, gf256,
                                native, xor_schedule)
from ceph_tpu_torch.osd.objectstore import CollectionId, ObjectId
from ceph_tpu_torch.tools import (bench_root, bench_sweep, bench_tpu,
                                  dencoder, ec_benchmark, ec_non_regression,
                                  vstart)
from ceph_tpu_torch.utils import staging
from ceph_tpu_torch.utils.config import default_config
from ceph_tpu_torch.utils.perf import global_perf, kernel_profiler

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261017

#: H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12
#: 32-bit shift and logic results per clock per SM on compute
#: capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
#: throughput)
INT32_PER_CLK_SM = 64
#: warp-instructions an SM dispatches per clock, whatever their pipe: one
#: for each of its 4 schedulers (NVIDIA H100 architecture white paper)
DISPATCH_PER_CLK_SM = 4

KERNELS = {
    # realization -> (kernel name, launch counter, plain version, TPU site)
    "pallas": ("gf_bitterm", "gf_bitterm", ec_kernels.gf_matmul_graph,
               "ceph_tpu/ops/ec_kernels.py:473"),
    "bitxor": ("gf_bitxor", "gf_bitxor", ec_kernels.gf_bitxor_graph,
               "ceph_tpu/ops/ec_kernels.py:172"),
    "mxu": ("gf_bitmm", "gf_bitmm", ec_kernels.gf_matmul_mxu_graph,
            "ceph_tpu/ops/ec_kernels.py:348"),
}
#: the CUDA source of each region kernel
KERNEL_SOURCES = {"pallas": "ceph_tpu_torch/csrc/gf_region.cu",
                  "bitxor": "ceph_tpu_torch/csrc/gf_region.cu",
                  "mxu": "ceph_tpu_torch/csrc/gf_bitmm.cu"}
#: K3: (kernel name, launch counter, TPU site)
SCHED_KERNEL = ("gf_sched_xor", "gf_sched_xor",
                "ceph_tpu/ops/ec_kernels.py:277")
SOURCE = KERNEL_SOURCES["pallas"]

MAIN_L = 8 << 20  # bytes per row at the main shape: 64 x 128 KiB chunks
#: smoke_matrices timed on (c, MAIN_L) for K1 and K2, the main shape
#: first: the encode of encode_batch and the decode of {1,4,9}
TIMED_SHAPES = ("reed_sol_van 3x8", "decode 8x8 {1,4,9}")
CLI_L = 10 << 20  # bytes per row of ec_benchmark's 80 MiB object, k=8
LENGTHS = (4, 508, 512, 32 * 1024 + 4, 100_000, MAIN_L, CLI_L)

#: the bit-matrix techniques of the corpus grid, (technique, k), m = 2
BIT_CODES = (("liberation", 5), ("blaum_roth", 4), ("liber8tion", 6))
#: packet-row length of ec_benchmark's 80 MiB object under liberation k=5
BIT_CLI_L = 2_396_800
SCHED_LENGTHS = (4, 64, 508, 512, 32 * 1024 + 4, 100_000, BIT_CLI_L,
                 10 << 20)
OBJECT_SIZE = 4 << 20  # the RADOS default object size

#: G1: (kernel name, launch counter, TPU site, source)
CRC_KERNEL = ("crc32c_chunks", "crc32c_chunks",
              "ceph_tpu/ops/checksum.py:190",
              "ceph_tpu_torch/csrc/crc32c.cu")
#: chunk lengths of the crc phase, each on CRC_ROWS rows of one chunk,
#: beside crc_tail_lengths()
CRC_LENGTHS = (4, 12, 508, 4096, 4100, 128 << 10, 1 << 20, (1 << 20) + 4)
CRC_ROWS = (1, 11, 704)
#: G1's main shape: the fused CRC of a 64-stripe k=8, m=3 batch of 1 MiB
#: stripes, (rows, bytes per row, chunk bytes)
CRC_MAIN = (11, 8 << 20, 128 << 10)

#: the write path: writers, encodes per writer, tpu reed_sol_van k, m,
#: chunk bytes (1 MiB stripes), the shards missing from the degraded
#: reads, and the ECBatcher at the OSD's defaults (ceph_tpu/utils/
#: config.py: ec_batch_window_us 500, ec_batch_max_bytes 8 MiB,
#: ec_batch_adaptive on, ec_batch_target_ops 4, ec_batch_window_min_us
#: 50, ec_batch_window_max_us 4000; the OSD passes all six)
WRITE = dict(writers=8, per_writer=16, k=8, m=3, chunk=128 << 10,
             erased=(1, 4, 9),
             batcher=dict(window_us=500.0, max_bytes=8 << 20,
                          adaptive=True, target_ops=4.0,
                          window_min_us=50.0, window_max_us=4000.0))
#: rows of the scrub fold
SCRUB_ROWS = 64

#: the wide path: BASELINE.json's two wide configurations, SHEC k=8 m=4
#: c=3 and CLAY k=8 m=4 d=11, at 1 MiB stripes (128 KiB chunks); threads,
#: stripes a thread, the SHEC object decoded through the interface, the
#: objects CLAY repairs and decodes, the chunks its decode erases, and the
#: ECBatcher at the OSD's defaults (WRITE's)
WIDE = dict(threads=8, per_thread=8, chunk=128 << 10,
            shec=dict(k=8, m=4, c=3), shec_object=8 << 20,
            shec_prefix=4 << 10, clay=dict(k=8, m=4, d=11),
            clay_objects=16, clay_erased=(0, 3, 8, 11),
            batcher=WRITE["batcher"])
#: phase 15: bench_tpu's encode stripes and timed reps a candidate
BENCH = dict(stripes=(4 << 10, 64 << 10, 1 << 20, 4 << 20), reps=4)
#: the plugins of the wide corpus directories
WIDE_PLUGINS = ("lrc", "shec", "clay")
#: size flushes of the mixed-length writes (one encode a writer each)
MIXED_ROUNDS = 2
#: phase 19, the mesh path: logical devices on the card (a dp=2 x
#: shard=4 mesh), stripes of k=8 chunks of ``chunk`` bytes (1 MiB
#: stripes), the sharded batcher's writers and chunk, the two-process
#: leg's logical devices a process, and ec_tool's file
MESH = dict(devices=8, B=64, chunk=128 << 10, writers=8,
            batch_chunk=128 << 10, proc_devices=4, tool_bytes=8 << 20)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smoke_matrices(rng: np.random.Generator) -> dict[str, np.ndarray]:
    C = gf256.vandermonde_matrix(8, 3)
    D = gf256.decode_matrix(C, 8, [0, 2, 3, 5, 6, 7, 8, 10])
    return {
        "reed_sol_van 3x8": C,
        "decode 8x8 {1,4,9}": D,
        "decode rows 2x8 {1,4}": D[[1, 4]],
        "decode row 1x8 {4}": D[[4]],
        "cauchy_good 4x8": gf256.cauchy_good_matrix(8, 4),
        "random 4x32": rng.integers(0, 256, (4, 32), dtype=np.uint8),
        "1x1": np.array([[0x8E]], dtype=np.uint8),
    }


def oracle_columns(L: int, windows: int = 128, width: int = 1024
                   ) -> np.ndarray:
    """Columns of an (r, L) result held against the numpy oracle: all of
    them up to 32 KiB + 4, else ``windows`` runs of ``width`` bytes spread
    evenly over the row and the row's last ``width`` bytes, so every
    grid-stride pass of either kernel is sampled."""
    if L <= windows * width:
        return np.arange(L)
    starts = [k * L // windows // 16 * 16 for k in range(windows)]
    return np.concatenate([np.arange(s, s + width) for s in starts]
                          + [np.arange(L - width, L)])


def bound_parts(M: np.ndarray, L: int) -> tuple[float, float]:
    """(bytes ms, operations ms) of the function M @ (c, L) over
    GF(2^8), whichever kernel computes it: each input byte read once and
    each output byte written once at the HBM rate; the product as a
    GF(2) bit-matrix product (an AND and an XOR per nonzero entry of
    gf256.bitmatrix(M), per byte column) at the int8 tensor-core rate,
    the card's fastest for operations of that width."""
    r, c = M.shape
    t_bytes = (r + c) * L / HBM_BYTES_PER_S
    t_ops = 2 * int(gf256.bitmatrix(M).sum()) * L / INT8_OPS_PER_S
    return t_bytes * 1e3, t_ops * 1e3


def sched_bound_parts(B: np.ndarray, L: int) -> tuple[float, float]:
    """bound_parts for B @ (C, L) over GF(2) on packet rows (K3): each
    input byte read once and each output byte written once; an AND and
    an XOR for each one of B per bit column (8 L of them) at the int8
    rate."""
    R, C = B.shape
    t_bytes = (R + C) * L / HBM_BYTES_PER_S
    t_ops = 2 * int((np.asarray(B) & 1).sum()) * 8 * L / INT8_OPS_PER_S
    return t_bytes * 1e3, t_ops * 1e3


def bound(M: np.ndarray, L: int, parts=bound_parts) -> tuple[float, str]:
    """(least ms, what bounds it): the larger of ``parts(M, L)``."""
    t_bytes, t_ops = parts(M, L)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


#: gf_bitterm's instructions on the ALU pipe, as its SASS (sm_90a) issues
#: them for one 16-byte column group (4 words of each row): per input word
#: 9 for the selectors and byte masks (2 LOP3, 1 SHF, 2 LEA.HI, 4 PRMT;
#: the shift left goes to the FMA pipe as IMAD.SHL); per general
#: coefficient 25 (2 PRMT broadcasts of the table, 8 PRMT lookups, 15
#: LOP3); per coefficient 1, 4 LOP3; per coefficient, 2 ISETP on its flag
BITTERM_WORD_OPS = 9
BITTERM_GENERAL_OPS = 25
BITTERM_UNIT_OPS = 4
BITTERM_FLAG_OPS = 2
#: output rows a gf_bitterm thread holds (kRowBlock in csrc/gf_region.cu):
#: the selectors are computed once per block of this many rows
BITTERM_ROW_BLOCK = 4


def bitterm_mix(M: np.ndarray) -> int:
    """gf_bitterm's ALU instructions per 16-byte column group of every
    row (4 lane columns, one thread's pass), from the BITTERM_*_OPS
    counts: the selectors of every input word once per block of
    BITTERM_ROW_BLOCK output rows, then each coefficient by its kind."""
    M = np.asarray(M)
    r, c = M.shape
    passes = -(-r // BITTERM_ROW_BLOCK)
    return (4 * BITTERM_WORD_OPS * c * passes
            + BITTERM_GENERAL_OPS * int(((M != 0) & (M != 1)).sum())
            + BITTERM_UNIT_OPS * int((M == 1).sum())
            + BITTERM_FLAG_OPS * r * c)


def bitterm_floor_ms(M: np.ndarray, L: int, sms: int, clock_hz: float
                     ) -> float:
    """The least time of gf_bitterm's own instruction mix on (c, L)
    bytes: bitterm_mix for each of the L / 16 column groups on the ALU
    pipe at INT32_PER_CLK_SM."""
    return 1e3 * (L // 16) * bitterm_mix(M) / (INT32_PER_CLK_SM * sms
                                               * clock_hz)


#: gf_bitmm's instructions a warp issues for one 256-column tile of its
#: word kernel (c <= 8), as its SASS (sm_90a) shows them, on the ALU pipe,
#: on the FMA pipe and in all (BMMA, loads, stores and NOPs too): in the
#: loop over groups of 4 output rows, per group, 64 BMMA, 182 IMAD (the
#: sums paired, the Horner steps), 190 on the ALU (96 PRMT, 68 LOP3, 26
#: others) and 472 in all (23 NOP among them); around that loop, once a
#: tile (the loads' addresses and the prefetch), 33 IMAD, 25 on the ALU
#: and 84 in all
BITMM_GROUP_ALU_OPS = 190
BITMM_GROUP_FMA_OPS = 182
BITMM_GROUP_OPS = 472
BITMM_TILE_ALU_OPS = 25
BITMM_TILE_FMA_OPS = 33
BITMM_TILE_OPS = 84
#: columns of every row one warp of gf_bitmm takes at once (kTileBytes)
BITMM_TILE_BYTES = 256


def bitmm_mix(M: np.ndarray) -> tuple[int, int, int]:
    """gf_bitmm's (ALU, FMA-pipe, all) instructions a warp issues per
    256-column tile of an (r, c <= 8) matrix (its word kernel), from the
    BITMM_*_OPS counts: the group loop once per group of 4 output rows,
    then the tile's own."""
    r, c = np.asarray(M).shape
    if c > 8:
        raise ValueError("the BITMM_*_OPS counts are the word kernel's: "
                         "c <= 8")
    groups = -(-r // 4)
    return (BITMM_GROUP_ALU_OPS * groups + BITMM_TILE_ALU_OPS,
            BITMM_GROUP_FMA_OPS * groups + BITMM_TILE_FMA_OPS,
            BITMM_GROUP_OPS * groups + BITMM_TILE_OPS)


def bitmm_floor_ms(M: np.ndarray, L: int, sms: int, clock_hz: float
                   ) -> float:
    """The least time of gf_bitmm's own instruction mix on (c, L) bytes:
    for each of the ceil(L / 256) tiles, the larger of two SM-clock counts
    from bitmm_mix, the busier pipe's instructions at INT32_PER_CLK_SM / 32
    warp-instructions a clock (the ALU's rate, and the FMA pipe's for
    32-bit integer multiply-adds on compute capability 9.0) and all of
    them at DISPATCH_PER_CLK_SM."""
    alu, fma, total = bitmm_mix(M)
    clocks = max(32 * max(alu, fma) / INT32_PER_CLK_SM,
                 total / DISPATCH_PER_CLK_SM)
    tiles = -(-L // BITMM_TILE_BYTES)
    return 1e3 * tiles * clocks / (sms * clock_hz)


#: G4's own phase-3 cases beside the smoke matrices, through its wrapper
#: at lengths that no padding rounds (L % 16 == 0; all but one end in a
#: ragged 256-column tile): (label, rows, columns, length, fill); the
#: "full" rows make every bit-column count in bitmatrix rows 0 and 15,
#: so all-0xFF data at c = 32 sums to 256 there, whose low byte is 0
BITMM_CASES = (
    ("all-0xFF, full rows 2x32", "full", 32, (1 << 20) + 16, 0xFF),
    ("random 1x8, ragged", 1, 8, 100_000, None),
    ("random 2x11, ragged", 2, 11, 100_000, None),
    ("random 1x17, ragged", 1, 17, 65_552, None),
    ("random 16x8", 16, 8, MAIN_L, None),
    ("random 16x32, ragged", 16, 32, 100_000, None),
    ("random 3x8, ragged", 3, 8, MAIN_L + 16, None),
)


def full_row_element(k: int) -> int:
    """The GF(2^8) element whose bitmatrix row k is all ones."""
    for a in range(1, 256):
        if gf256.bitmatrix(np.array([[a]], dtype=np.uint8))[k].all():
            return a
    raise AssertionError(f"no GF(2^8) element has bitmatrix row {k} full")


def bitmm_case_matrix(rows, cols: int, rng: np.random.Generator
                      ) -> np.ndarray:
    if rows == "full":
        return np.array([[full_row_element(0)] * cols,
                         [full_row_element(7)] * cols], dtype=np.uint8)
    return rng.integers(0, 256, (rows, cols), dtype=np.uint8)


def check_bitmm_cases(dev: torch.device, gen: torch.Generator,
                      rng: np.random.Generator, cases=BITMM_CASES
                      ) -> tuple[int, int]:
    """G4 through gf_bitmm_lanes on each of ``cases`` against its plain
    version (equal bytes, all columns) and the numpy oracle
    (oracle_columns).  Returns (cases, max abs err)."""
    err = 0
    for label, rows, cols, L, fill in cases:
        M = bitmm_case_matrix(rows, cols, rng)
        plan = ec_kernels.bitmm_plan(M)
        frag = torch.from_numpy(plan.frag.view(np.int32)).to(dev)
        data = (torch.randint(0, 256, (cols, L), dtype=torch.uint8,
                              device=dev, generator=gen) if fill is None
                else torch.full((cols, L), fill, dtype=torch.uint8,
                                device=dev))
        got = ec_kernels.gf_bitmm_lanes(
            data.view(torch.int32), gf256.bitmatrix(M),
            (frag, plan)).view(torch.uint8)
        want = ec_kernels.gf_matmul_mxu_graph(M)(data)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        diff = int((got.int() - want.int()).abs().max())
        err = max(err, diff)
        if not torch.equal(got, want):
            raise AssertionError(f"gf_bitmm {label} L={L}: differs from "
                                 f"its plain version (max abs err {diff})")
        idx = torch.from_numpy(oracle_columns(L)).to(dev)
        oracle = gf256.encode_region(M, data[:, idx].cpu().numpy())
        if not np.array_equal(got[:, idx].cpu().numpy(), oracle):
            raise AssertionError(f"gf_bitmm {label} L={L}: differs from "
                                 "the oracle")
    say("kernels", f"gf_bitmm: {len(cases)} more cases equal to the plain "
                   "version and the oracle through its wrapper: "
                   + "; ".join(f"{c[0]} L={c[3]}" for c in cases))
    return len(cases), err


def cuda_ms(fn, n: int, warm: int = 3) -> float:
    """Median CUDA-event time (ms) of ``n`` back-to-back launches.  The
    card first sleeps for about 50 ms while the host queues every
    launch, so no host gap between two launches lands inside a window."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(100_000_000)  # clock cycles
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def int_mm_ms(dev: torch.device, M: np.ndarray, L: int, n: int
              ) -> float | None:
    """G4's library yardstick: torch._int_mm of bitmatrix(M) (int8, 8r x
    8c) by bit-planes unpacked beforehand (int8, 8c x L), the GF(2)
    product's integer sums alone, without G4's unpack, parity and repack.
    The planes are laid out column-major (an (L, 8c) tensor, transposed):
    cuBLASLt refuses a row-major one at these shapes.  None where _int_mm
    refuses the shapes."""
    B = torch.from_numpy(gf256.bitmatrix(M).astype(np.int8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    planes = torch.randint(0, 2, (L, B.shape[1]), dtype=torch.int8,
                           device=dev, generator=gen).t()
    try:
        torch._int_mm(B, planes)
    except RuntimeError as e:
        say("kernels", f"gf_bitmm: torch._int_mm refuses {tuple(B.shape)} x "
                       f"{tuple(planes.shape)}: {e}")
        return None
    ms = cuda_ms(lambda: torch._int_mm(B, planes), n)
    say("kernels", f"gf_bitmm: library yardstick torch._int_mm "
                   f"{tuple(B.shape)} x {tuple(planes.shape)} int8, "
                   f"planes column-major (the product alone: planes "
                   f"unpacked beforehand, no parity, no repack) "
                   f"{ms:.4f} ms")
    return ms


def run_quiet(what: str, fn, *args) -> str:
    """``fn(*args)`` with its standard output captured; raises unless
    it returned 0, and returns the captured text."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    if rc != 0:
        raise AssertionError(f"{what} exit {rc}")
    return buf.getvalue().strip()


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> float:
    """Print the card's name and power limit; return its top SM clock
    (Hz), which the instruction floor of gf_bitterm needs."""
    say("device", f"nvidia-smi: {nvidia_smi('name,power.limit')}")
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"{torch.cuda.get_device_name(0)} "
                  f"x{torch.cuda.device_count()}, "
                  f"{torch.cuda.get_device_properties(0).multi_processor_count}"
                  f" SMs at up to {mhz:.0f} MHz")
    return mhz * 1e6


def phase_build() -> None:
    t0 = time.perf_counter()
    built = cuda_lib.build()
    say("build", f"{time.perf_counter() - t0:.2f} s "
                 f"({'nvcc ran' if built is not None else 'up to date'})")
    for ln in cuda_lib.BUILD_LOG.get("ptxas", "").splitlines():
        if any(w in ln for w in ("registers", "Compiling entry", "spill")):
            say("build", ln.strip())


def phase_kernels(dev: torch.device, rng: np.random.Generator,
                  clock_hz: float, lengths=LENGTHS, main_l: int = MAIN_L,
                  n_time: int = 30
                  ) -> tuple[dict[str, dict], dict[str, dict[str, float]]]:
    """Every kernel against its plain version (equal bytes, all columns)
    and the numpy oracle (oracle_columns); then CUDA-event times at the
    TIMED_SHAPES.  Returns each kernel's row of the kernels line (its
    numbers the main shape's) and realization -> label -> ms."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results, all_times = {}, {}
    mats = smoke_matrices(rng)
    for realization, (name, _ctr, plain_of, site) in KERNELS.items():
        err = 0
        cases = 0
        for label, M in mats.items():
            op = ec_kernels.RegionMatmul(M, kernel=realization, device=dev)
            plain = plain_of(M)
            for L in lengths:
                data = torch.randint(0, 256, (M.shape[1], L),
                                     dtype=torch.uint8, device=dev,
                                     generator=gen)
                got = op(data)
                want = plain(data)
                torch.cuda.synchronize(dev)
                diff = int((got.int() - want.int()).abs().max())
                err = max(err, diff)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{name} {label} L={L}: differs from its plain "
                        f"version (max abs err {diff})")
                cols = torch.from_numpy(oracle_columns(L)).to(dev)
                oracle = gf256.encode_region(M, data[:, cols].cpu().numpy())
                if not np.array_equal(got[:, cols].cpu().numpy(), oracle):
                    raise AssertionError(
                        f"{name} {label} L={L}: differs from the oracle")
                cases += 1
        if realization == "mxu":
            for ln in bitmm_ptxas_lines():
                say("kernels", f"{name} ptxas: {ln}")
            more, more_err = check_bitmm_cases(dev, gen, rng)
            cases += more
            err = max(err, more_err)
        say("kernels", f"{name}: {cases} cases equal to the plain version "
                       "and the oracle")
        times = {}
        for label in TIMED_SHAPES:
            M = mats[label]
            op = ec_kernels.RegionMatmul(M, kernel=realization, device=dev)
            data = torch.randint(0, 256, (M.shape[1], main_l),
                                 dtype=torch.uint8, device=dev,
                                 generator=gen)
            x32 = data.view(torch.int32)
            ms = times[label] = cuda_ms(lambda: op.encode_lanes(x32), n_time)
            clocks = nvidia_smi("clocks.sm,power.draw,temperature.gpu")
            bound_ms, bound_by = bound(M, main_l)
            t_bytes, t_ops = bound_parts(M, main_l)
            nbytes = sum(M.shape) * main_l
            say("kernels", f"{name}: {label} at {main_l >> 20} MiB/row: "
                           f"{ms:.4f} ms = {nbytes / ms / 1e6:.1f} GB/s, "
                           f"bound {bound_ms:.4f} ms ({bound_by}; bytes "
                           f"{t_bytes:.4f}, operations {t_ops:.4f}), "
                           f"{ms / bound_ms:.2f}x the bound; after timing: "
                           f"{clocks}")
            if realization == "mxu":
                floor = bitmm_floor_ms(
                    M, main_l, torch.cuda.get_device_properties(
                        dev).multi_processor_count, clock_hz)
                alu, fma, total = bitmm_mix(M)
                say("kernels", f"{name}: {label}: its own instruction mix "
                               f"({alu} ALU, {fma} FMA-pipe and {total} in "
                               f"all a warp per {BITMM_TILE_BYTES}-column "
                               "tile) "
                               f"needs at least {floor:.4f} ms at the top "
                               f"clock (bitmm_floor_ms), {ms / floor:.2f}x "
                               "of it")
            if realization == "pallas":
                floor = bitterm_floor_ms(
                    M, main_l, torch.cuda.get_device_properties(
                        dev).multi_processor_count, clock_hz)
                say("kernels", f"{name}: {label}: its own instruction mix "
                               f"({bitterm_mix(M)} ALU instructions per "
                               f"16-byte column group) needs at least "
                               f"{floor:.4f} ms at the top clock, "
                               f"{ms / floor:.2f}x of it")
        M = mats[TIMED_SHAPES[0]]
        data = torch.randint(0, 256, (M.shape[1], main_l), dtype=torch.uint8,
                             device=dev, generator=gen)
        plain = plain_of(M)
        plain_ms = cuda_ms(lambda: plain(data), max(5, n_time // 4), warm=1)
        say("kernels", f"{name}: its plain version at {TIMED_SHAPES[0]}: "
                       f"{plain_ms:.3f} ms")
        del data, x32
        bound_ms, bound_by = bound(M, main_l)
        results[realization] = {
            "name": name, "route": "cuda",
            "source": KERNEL_SOURCES[realization], "replaces": site,
            "launches": 0, "max_abs_err": err,
            "ms": times[TIMED_SHAPES[0]], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": (int_mm_ms(dev, M, main_l, n_time)
                           if realization == "mxu" else None)}
        all_times[realization] = times
    return results, all_times


def crc_bound_parts(rows: int, row_bytes: int, chunk: int
                    ) -> tuple[float, float]:
    """(bytes ms, operations ms) of the standard CRC32C of every
    ``chunk``-byte chunk of (rows, row_bytes) bytes: each input byte read
    once and each 4-byte digest written once at the HBM rate; the CRC as
    a GF(2) matrix-vector product (32 x 8 * chunk bits a chunk, an AND
    and an XOR per entry) at the int8 tensor-core rate."""
    n_in = rows * row_bytes
    t_bytes = (n_in + 4 * rows * (row_bytes // chunk)) / HBM_BYTES_PER_S
    t_ops = 2 * 32 * 8 * n_in / INT8_OPS_PER_S
    return t_bytes * 1e3, t_ops * 1e3


def crc_tail_lengths(geo: checksum.CrcGeometry = checksum.CRC_GEOMETRY
                     ) -> tuple[int, ...]:
    """Chunk lengths one word either side of the splits of G1 at ``geo``:
    a warp's load (32 * words words), a block's Horner step and a whole
    segment."""
    out = []
    for words in (32 * geo.words, geo.step_words, geo.iters * geo.step_words):
        out += [4 * (words - 1), 4 * (words + 1)]
    return tuple(out)


def ptxas_lines(kernel: str) -> list[str]:
    """The ptxas register and spill lines of the library build's entries
    whose (mangled) name holds ``kernel``."""
    out, keep = [], False
    for ln in cuda_lib.BUILD_LOG.get("ptxas", "").splitlines():
        if "Compiling entry" in ln:
            keep = kernel in ln
        if keep and any(w in ln for w in ("registers", "spill", "entry")):
            out.append(ln.strip())
    return out


def bitmm_ptxas_lines() -> list[str]:
    """G4's ptxas lines (ptxas_lines of its kernels).  Raises if this
    process ran a build whose log lacks the word or the column kernel, so
    that a renamed kernel cannot empty the print."""
    lines = ptxas_lines("gf_bitmm_")
    missing = [k for k in ("gf_bitmm_words", "gf_bitmm_columns")
               if not any(k in ln for ln in lines)]
    if cuda_lib.BUILD_LOG.get("ptxas") and missing:
        raise AssertionError(f"gf_bitmm: the build's ptxas log has no entry "
                             f"for {missing}")
    return lines


def phase_crc(dev: torch.device,
              lengths=tuple(dict.fromkeys(CRC_LENGTHS + crc_tail_lengths())),
              rows_list=CRC_ROWS, main=CRC_MAIN, n_time: int = 30) -> dict:
    """G1 against its plain version (equal digests) and against the
    native library's crc32c, at every length of ``lengths`` on each row
    count of ``rows_list`` (one chunk a row) and on all-zero and
    all-0xFF chunks; then CUDA-event times at ``main`` in its chunks,
    beside the bound, the plain version and a device copy of the same
    bytes.  Returns G1's row of the kernels line."""
    name, _ctr, site, source = CRC_KERNEL
    for ln in ptxas_lines("crc32c_mma_kernel"):
        say("crc", f"ptxas: {ln}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    cases = err = 0
    for L in lengths:
        plan = checksum.crc_plan(L)
        fn = plan.device_fn()
        for rows in rows_list + ("fill",):
            if rows == "fill":
                data = torch.tensor([[0], [255]], dtype=torch.uint8,
                                    device=dev).expand(2, L).contiguous()
            else:
                data = torch.randint(0, 256, (rows, L), dtype=torch.uint8,
                                     device=dev, generator=gen)
            words = data.view(torch.int32)
            got = fn(words)
            want = plan.plain(words).view(torch.uint32)
            torch.cuda.synchronize(dev)
            err = max(err, int((got.view(torch.int32).long()
                                - want.view(torch.int32).long())
                               .abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"{name} L={L} rows={rows}: differs "
                                     "from its plain version")
            host = np.array(native.crc32c_blocks(data.cpu().numpy(), L),
                            dtype=np.uint32)
            if not np.array_equal(got.cpu().numpy(), host):
                raise AssertionError(f"{name} L={L} rows={rows}: differs "
                                     "from native crc32c")
            cases += 1
            del data, words, got, want
    say("crc", f"{name}: {cases} cases ({len(lengths)} lengths x rows "
               f"{', '.join(map(str, rows_list))} and all-0 / all-0xFF "
               "chunks) equal to its plain version and native crc32c")
    rows, row_bytes, chunk = main
    plan = checksum.crc_plan(chunk)
    data = torch.randint(0, 256, (rows, row_bytes), dtype=torch.uint8,
                         device=dev, generator=gen)
    words = data.view(torch.int32).reshape(-1, chunk // 4)
    ms = cuda_ms(lambda: checksum.crc32c_chunks(words, plan), n_time)
    plain_ms = cuda_ms(lambda: plan.plain(words), max(5, n_time // 4),
                       warm=1)
    # the yardstick moves the bytes G1 reads: half read, half written
    half = data.reshape(-1)[: rows * row_bytes // 2]
    copy_ms = cuda_ms(lambda: torch.empty_like(half).copy_(half), n_time)
    t_bytes, t_ops = crc_bound_parts(rows, row_bytes, chunk)
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    geo = checksum.CRC_GEOMETRY
    iters, segs, pad = checksum.kernel_split(chunk // 4)
    clocks = nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    say("crc", f"{name}: ({rows}, {row_bytes >> 20} MiB) in {chunk >> 10} "
               f"KiB chunks ({'binary' if geo.b1 else 'int8'} products, "
               f"runs of {geo.run} words a row, {segs} segments of "
               f"{iters} steps of {geo.step_words} words a chunk): "
               f"{ms:.4f} ms = {rows * row_bytes / ms / 1e6:.1f} "
               f"GB/s, bound {bound_ms:.4f} ms ({bound_by}; bytes "
               f"{t_bytes:.4f}, operations {t_ops:.4f}), "
               f"{ms / bound_ms:.2f}x the bound ({bound_ms / ms:.0%} of it); "
               f"plain {plain_ms:.3f} ms; a "
               f"device copy moving the same bytes (half read, half "
               f"written) {copy_ms:.4f} ms; after "
               f"timing: {clocks}")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": site, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def _threads(n: int, target, *args) -> float:
    """Run target(i, *args) in n daemon threads started together; returns
    the wall seconds.  Any exception of a thread is raised here."""
    errors = []
    gate = threading.Barrier(n, timeout=600)

    def run(i):
        try:
            gate.wait()
            target(i, *args)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    dt = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a writer or reader thread did not finish")
    if errors:
        raise errors[0]
    return dt


def csum_launches() -> int:
    """Launches of the fused encode+CRC op so far (its ``csum/``
    signatures in the kernel profiler)."""
    return sum(a["device"] + a["compile"] for sig, a in
               kernel_profiler().dump()["signatures"].items()
               if sig.startswith("csum/"))


@contextlib.contextmanager
def launch_records(records: list):
    """Within the block, every launch of a matrix codec appends (thread,
    CUDA stream, host seconds from its enqueue to its own outputs, its
    CUDA events): the codecs' _profiled_launch with events around the op
    on the stream it ran on (on the CPU: no stream and no events)."""
    orig = MatrixErasureCode._profiled_launch

    def recorded(self, op, rows, sig, events=None):
        stream = None
        if self.device.type == "cuda":
            if events is None:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            stream = torch.cuda.current_stream(self.device).cuda_stream
        t0 = time.perf_counter()
        out = orig(self, op, rows, sig, events)
        records.append((threading.get_ident(), stream,
                        time.perf_counter() - t0, events))
        return out

    MatrixErasureCode._profiled_launch = recorded
    try:
        yield
    finally:
        MatrixErasureCode._profiled_launch = orig


def launch_summary(what: str, records: list) -> dict:
    """Prints the launches of ``records`` (launch_records): their host
    wall time beside the CUDA-event time of the ops, and the streams the
    flushing threads used; returns {"threads", "streams", "shared"}, where
    ``shared`` counts pairs of threads that launched on one stream."""
    wall = sum(r[2] for r in records)
    device = sum(r[3][0].elapsed_time(r[3][1]) for r in records
                 if r[3] is not None) / 1e3
    by_thread: dict[int, set] = {}
    for thread, stream, _dt, _ev in records:
        by_thread.setdefault(thread, set()).add(stream)
    streams = set().union(*by_thread.values()) if by_thread else set()
    shared = sum(1 for a, b in itertools.combinations(by_thread.values(), 2)
                 if a & b)
    say("write", f"{what}: {len(records)} launches, {wall:.4f} s host wall "
                 f"(enqueue to own outputs) beside {device:.4f} s of CUDA "
                 f"events around the ops; {len(by_thread)} flushing threads "
                 f"on {len(streams)} streams, {shared} pairs sharing one")
    return {"threads": len(by_thread), "streams": len(streams),
            "shared": shared, "wall": wall, "device": device}


@contextlib.contextmanager
def counted_sweeps(sweeps: list):
    """Within the block, every host CRC sweep of the batcher appends its
    row count to ``sweeps``."""
    host_csums = ec_batcher._host_csums

    def counted(rows):
        sweeps.append(len(rows))
        return host_csums(rows)

    ec_batcher._host_csums = counted
    try:
        yield
    finally:
        ec_batcher._host_csums = host_csums


def mixed_lengths(chunk: int, writers: int) -> list[int]:
    """Writer w's chunk length in the mixed writes: ``chunk`` less one of
    four cuts, so four lengths in ``chunk``'s bucket, the last two not
    whole words."""
    cuts = (0, chunk // 32, chunk // 16 + 2, chunk // 8 + 3)
    return [chunk - cuts[w % len(cuts)] for w in range(writers)]


def mixed_writes(codec, rng: np.random.Generator, *, writers: int,
                 chunk: int, rounds: int = MIXED_ROUNDS) -> dict:
    """``rounds`` flushes of one checksummed encode from each of
    ``writers`` threads at mixed_lengths: lengths in one bucket that the
    fused op cannot take (an ECBatcher
    whose byte limit is one round, so each round is one size flush).
    Checks every parity and csum; returns the flushes, the distinct
    lengths, and the G1 launches, fused launches and device-to-host
    copies they made."""
    k = codec.k
    lengths = mixed_lengths(chunk, writers)
    batcher = ec_batcher.ECBatcher(window_us=10_000_000,
                                   max_bytes=k * sum(lengths))
    data = [[rng.integers(0, 256, (k, L), dtype=np.uint8)
             for _ in range(rounds)] for L in lengths]
    out = [[None] * rounds for _ in range(writers)]
    stage = staging.stage_perf()
    d2h0 = stage.get("ec_stage_d2h_copies")
    g0 = ec_kernels.launch_counts()[CRC_KERNEL[1]]
    c0 = csum_launches()

    def write(w):
        for r in range(rounds):
            out[w][r] = batcher.encode(codec, data[w][r], with_csums=True)

    write_s = _threads(writers, write)
    for w in range(writers):
        for r in range(rounds):
            parity, csums = out[w][r]
            if not np.array_equal(
                    parity, gf256.encode_region(codec.matrix, data[w][r])):
                raise AssertionError(f"mixed write {w}.{r}: parity "
                                     "differs from the oracle")
            stack = np.concatenate([data[w][r], parity])
            host = np.array([native.crc32c(row) for row in stack],
                            dtype=np.uint32)
            if not np.array_equal(csums, host):
                raise AssertionError(f"mixed write {w}.{r}: csums differ "
                                     "from native crc32c")
    result = {"launches": batcher.stats["launches"],
              "lengths": len(set(lengths)),
              "g1": ec_kernels.launch_counts()[CRC_KERNEL[1]] - g0,
              "csum_launches": csum_launches() - c0,
              "d2h": stage.get("ec_stage_d2h_copies") - d2h0}
    say("write", f"{writers * rounds} checksummed encodes of lengths "
                 f"{sorted(set(lengths))} from {writers} threads: parity "
                 f"equal to the oracle, csums to native crc32c; "
                 f"{result['launches']} flushes, {result['g1']} G1 "
                 f"launches, {result['csum_launches']} fused; "
                 f"{write_s:.3f} s")
    return result


def phase_write(dev: torch.device, rng: np.random.Generator, *,
                writers: int, per_writer: int, k: int, m: int, chunk: int,
                erased: tuple, batcher: dict,
                scrub_rows: int = SCRUB_ROWS) -> dict:
    """The EC write path through its entry points: ``writers`` threads
    each submit ``per_writer`` checksummed encodes of (k, chunk) stripes
    to one ECBatcher built with the ``batcher`` settings; then as many threads decode every stripe with the
    ``erased`` shards missing, half of each read's survivors served from a
    DeviceArena as tensors; then one folded scrub verify of
    ``scrub_rows`` stored chunks with one bit flipped.  Checks every
    parity against the numpy oracle, every csum against native crc32c,
    every decoded chunk, and the verify digests.  Between the writes and
    the reads, mixed_writes on the same codec.  Returns what
    check_write_path reads."""
    codec = ec.factory("tpu", {"k": str(k), "m": str(m),
                               "device": str(dev)})
    perf = global_perf().create("ec_batch_smoke")
    batcher = ec_batcher.ECBatcher(perf=perf, **batcher)
    n = writers * per_writer
    data = rng.integers(0, 256, (n, k, chunk), dtype=np.uint8)
    parity = [None] * n
    csums = [None] * n
    stage = staging.stage_perf()
    d2h0 = stage.get("ec_stage_d2h_copies")
    sweeps = []  # host CRC sweeps: none may run here

    def write(w):
        for i in range(w * per_writer, (w + 1) * per_writer):
            parity[i], csums[i] = batcher.encode(codec, data[i],
                                                 with_csums=True)

    write_launches = []
    with counted_sweeps(sweeps), launch_records(write_launches):
        write_s = _threads(writers, write)
    enc = dict(batcher.stats)
    d2h1 = stage.get("ec_stage_d2h_copies")
    csum_written = csum_launches()
    folded = data.transpose(1, 0, 2).reshape(k, n * chunk)
    oracle = gf256.encode_region(codec.matrix, folded).reshape(m, n, chunk)
    for i in range(n):
        if not np.array_equal(parity[i], oracle[:, i]):
            raise AssertionError(f"write {i}: parity differs from the "
                                 "oracle")
        stack = np.concatenate([data[i], parity[i]])
        host = np.array(native.crc32c_blocks(stack, chunk), dtype=np.uint32)
        if not np.array_equal(csums[i], host):
            raise AssertionError(f"write {i}: csums differ from native "
                                 "crc32c")
    say("write", f"{n} checksummed encodes of {k} x {chunk >> 10} KiB from "
                 f"{writers} threads: parity equal to the oracle, csums to "
                 f"native crc32c; {enc['launches']} flushes, "
                 f"{enc['ops'] / enc['launches']:.2f} ops a launch, "
                 f"reasons window {enc['window']} size {enc['size']} idle "
                 f"{enc['idle']}, window now "
                 f"{perf.get('ec_batch_window_us_now')} us; "
                 f"{n * k * chunk / write_s / 1e9:.3f} GB/s of data "
                 f"({write_s:.3f} s)")
    streams = launch_summary("writes", write_launches)
    mixed_launches = []
    with counted_sweeps(sweeps), launch_records(mixed_launches):
        mixed = mixed_writes(codec, rng, writers=writers, chunk=chunk)
    launch_summary("mixed writes", mixed_launches)

    arena = ec.DeviceArena(device=dev)
    avail = [i for i in range(k + m) if i not in erased]
    served = avail[: len(avail) // 2]
    decoded = [None] * n

    def read(r):
        for i in range(r * per_writer, (r + 1) * per_writer):
            full = np.concatenate([data[i], parity[i]])
            chunks = {}
            for s in avail:
                chunks[s] = (arena.put((i, s), full[s]) if s in served
                             else full[s])
            decoded[i] = batcher.decode(codec, list(erased), chunks)

    d2h_read = stage.get("ec_stage_d2h_copies")
    read_launches = []
    with launch_records(read_launches):
        read_s = _threads(writers, read)
    dec = {key: batcher.stats[key] - enc[key] for key in enc}
    for i in range(n):
        full = np.concatenate([data[i], parity[i]])
        for s in erased:
            if not np.array_equal(decoded[i][s], full[s]):
                raise AssertionError(f"read {i}: chunk {s} differs")
    say("write", f"{n} degraded reads, shards {set(erased)} missing, "
                 f"{len(served)} of {len(avail)} survivors from the arena "
                 f"as tensors: byte-exact; {dec['launches']} flushes, "
                 f"{dec['ops'] / dec['launches']:.2f} ops a launch; "
                 f"{n * k * chunk / read_s / 1e9:.3f} GB/s of data "
                 f"({read_s:.3f} s); arena "
                 f"{stage.get('ec_arena_bytes') >> 20} MiB held, "
                 f"{stage.get('ec_arena_evictions')} evictions")
    launch_summary("degraded reads", read_launches)

    d2h2 = stage.get("ec_stage_d2h_copies")
    rows = np.ascontiguousarray(data[:scrub_rows // k].reshape(-1, chunk))
    want = np.concatenate([csums[i][:k] for i in range(scrub_rows // k)])
    bad = scrub_rows // 3
    rows[bad, 1234] ^= 0x10
    digests = batcher.verify(ec.verifier("device", dev), rows)
    host = np.array(native.crc32c_blocks(rows, chunk), dtype=np.uint32)
    if not np.array_equal(digests, host):
        raise AssertionError("verify digests differ from native crc32c")
    flagged = np.nonzero(digests != want)[0].tolist()
    if flagged != [bad]:
        raise AssertionError(f"verify flagged rows {flagged}, not [{bad}]")
    say("write", f"scrub verify of ({rows.shape[0]}, {chunk >> 10} KiB) with "
                 f"one bit flipped: digests equal to native crc32c, row "
                 f"{bad} singled out")
    return {"encode": enc, "decode": dec, "sweeps": len(sweeps),
            "d2h_encode": d2h1 - d2h0, "d2h_decode": d2h2 - d2h_read,
            "csum_launches": csum_written, "mixed": mixed,
            "streams": streams}


def check_write_path(counts: dict[str, int], result: dict,
                     csum_before: int = 0) -> None:
    """The write path went through G1 and a region kernel and no plain
    version; every encode flush of one length took the fused op (its
    ``csum/`` launches, less ``csum_before`` from earlier paths, are one
    per encode flush); every flush of the mixed writes launched G1 once
    a length and no fused op; no host CRC sweep ran; every encode and
    decode flush left the card in exactly one metered copy; the writers'
    flushes ran on more than one stream, no two threads on one."""
    say("launches", f"write path: {json.dumps(counts)}")
    if counts[CRC_KERNEL[1]] <= 0:
        raise AssertionError(f"{CRC_KERNEL[1]} never launched on the "
                             "write path")
    if sum(counts[k[1]] for k in KERNELS.values()) <= 0:
        raise AssertionError("no region kernel launched on the write path")
    if counts["plain"]:
        raise AssertionError(f"a plain version ran {counts['plain']} times "
                             "on the write path")
    enc, dec = result["encode"], result["decode"]
    fused = result["csum_launches"] - csum_before
    if result["sweeps"] or fused != enc["launches"]:
        raise AssertionError(f"{enc['launches']} encode flushes took the "
                             f"fused op {fused} times, with "
                             f"{result['sweeps']} host CRC sweeps")
    mixed = result["mixed"]
    if (not mixed["launches"] or mixed["csum_launches"]
            or mixed["g1"] != mixed["launches"] * mixed["lengths"]):
        raise AssertionError(
            f"{mixed['launches']} flushes of {mixed['lengths']} lengths "
            f"made {mixed['g1']} G1 launches and took the fused op "
            f"{mixed['csum_launches']} times")
    if (result["d2h_encode"] != enc["launches"]
            or result["d2h_decode"] != dec["launches"]
            or mixed["d2h"] != mixed["launches"]):
        raise AssertionError(
            f"device-to-host copies: {result['d2h_encode']} for "
            f"{enc['launches']} encode flushes, {mixed['d2h']} for "
            f"{mixed['launches']} mixed ones, {result['d2h_decode']} for "
            f"{dec['launches']} decode flushes")
    st = result["streams"]
    if st["streams"] < 2 or st["shared"]:
        raise AssertionError(
            f"the writers' flushes ran on {st['streams']} streams from "
            f"{st['threads']} threads, {st['shared']} pairs sharing one")
    say("launches", f"write path: {enc['launches']} encode flushes all "
                    f"fused, {mixed['launches']} of mixed lengths with "
                    f"{mixed['g1']} G1 launches, one device-to-host copy "
                    f"per encode and decode flush")


def write_path(dev: torch.device, rng: np.random.Generator, **cfg
               ) -> tuple[dict[str, int], dict]:
    """The write phase with the launch counts set to 0 before and read
    after; returns the counts and phase_write's result."""
    ec_kernels.reset_launches()
    result = phase_write(dev, rng, **cfg)
    return ec_kernels.launch_counts(), result


def bit_codec(technique: str, k: int, **profile):
    return ec.factory("jerasure", {"technique": technique, "k": str(k),
                                   "m": "2", **profile})


def sched_matrices(rng: np.random.Generator) -> dict[str, np.ndarray]:
    """K3's matrices: the bit-matrix encode drives and decode combos the
    bit path launches, the widest drive (liber8tion k=32), a random
    matrix wider than one 16-row block with a zero row, and a 1x1."""
    lib = bit_codec("liberation", 5, backend="numpy")
    l8 = bit_codec("liber8tion", 6, backend="numpy")
    Z = (rng.random((24, 64)) < 0.5).astype(np.uint8)
    Z[7] = 0
    return {
        "liberation k=5 14x35": lib.bitmatrix,
        "liberation decode {0,1} 14x35": lib._decode_combo(
            (0, 1), (2, 3, 4, 5, 6)),
        "blaum_roth k=4 12x24": bit_codec("blaum_roth", 4,
                                          backend="numpy").bitmatrix,
        "liber8tion k=6 16x48": l8.bitmatrix,
        "liber8tion decode {0,6} 16x48": l8._decode_combo(
            (0, 6), (1, 2, 3, 4, 5, 7)),
        "liber8tion decode {0,1} 16x48": l8._decode_combo(
            (0, 1), (2, 3, 4, 5, 6, 7)),
        "liber8tion k=32 16x256": bit_codec("liber8tion", 32,
                                            backend="numpy").bitmatrix,
        "random 24x64, a zero row": Z,
        "1x1": np.ones((1, 1), dtype=np.uint8),
    }


#: the packet-mode cases: (label, technique, k, erased data shards or
#: None for the encode drive); the codec's own matrices, m = 2
PACKET_CASES = (("liberation k=5", "liberation", 5, None),
                ("liberation decode {0,1}", "liberation", 5, (0, 1)),
                ("blaum_roth k=4", "blaum_roth", 4, None),
                ("liber8tion k=6", "liber8tion", 6, None),
                ("liber8tion decode {0,1}", "liber8tion", 6, (0, 1)))
PACKET_GRANULES = (1, 3, 37)


def packet_matrix(technique: str, k: int, erased) -> tuple:
    """(B, w, numpy-backend codec) of one packet-mode case."""
    codec = bit_codec(technique, k, backend="numpy")
    if erased is None:
        return codec.bitmatrix, codec.w, codec
    avail = tuple(i for i in range(k + 2) if i not in erased)
    return codec._decode_combo(tuple(erased), avail), codec.w, codec


def oracle_granules(G: int, windows: int = 64) -> np.ndarray:
    """Granules of a chunk held against the numpy codec: all of them up
    to ``windows``, else ``windows`` spread evenly and the last one."""
    if G <= windows:
        return np.arange(G)
    return np.unique(np.append(np.arange(windows) * G // windows, G - 1))


def check_packet_mode(dev: torch.device, gen: torch.Generator,
                      size: int) -> tuple[int, int]:
    """K3 in packet mode against its plain version (permute, schedule,
    permute back; equal bytes, all columns) and the numpy codec's host
    apply (oracle_granules) on every PACKET_CASES matrix at
    PACKET_GRANULES granules and at the chunk length of a ``size``
    object.  Returns (cases, max abs error)."""
    err = cases = 0
    for label, technique, k, erased in PACKET_CASES:
        B, w, codec = packet_matrix(technique, k, erased)
        op = ec_kernels.ScheduledXor(B, device=dev, w=w)
        plain = ec_kernels.gf_sched_xor_graph(B, w)
        granule = w * 64
        for G in PACKET_GRANULES + (codec.get_chunk_size(size) // granule,):
            chunks = torch.randint(0, 256, (op.c, G * granule),
                                   dtype=torch.uint8, device=dev,
                                   generator=gen)
            got = op(chunks)
            want = plain(chunks)
            torch.cuda.synchronize(dev)
            diff = int((got.int() - want.int()).abs().max())
            err = max(err, diff)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{SCHED_KERNEL[0]} packet mode {label} G={G}: differs "
                    f"from its plain version (max abs err {diff})")
            gi = torch.from_numpy(oracle_granules(G)).to(dev)
            cols = (gi[:, None] * granule + torch.arange(
                granule, device=dev)[None, :]).reshape(-1)
            oracle = codec._apply(B, chunks[:, cols].cpu().numpy())
            if not np.array_equal(got[:, cols].cpu().numpy(), oracle):
                raise AssertionError(f"{SCHED_KERNEL[0]} packet mode {label}"
                                     f" G={G}: differs from the numpy codec")
            cases += 1
            del chunks, got, want
    return cases, err


def phase_sched_xor(dev: torch.device, rng: np.random.Generator,
                    lengths=SCHED_LENGTHS, n_time: int = 30,
                    size: int = 80 << 20) -> dict:
    """K3 against its plain version (equal bytes, all columns) and the
    numpy oracle xor_schedule.naive_apply (oracle_columns) in plane-row
    mode, and in packet mode against its plain version and the numpy
    codec (check_packet_mode).  Then CUDA-event times at the two main
    shapes, the liberation encode and the densest liber8tion decode of a
    ``size`` object: plane rows at the padded packet-row length, packet
    mode (the kernel, and one whole apply of the op as the codec calls
    it) and a device copy of the same bytes."""
    name, _ctr, site = SCHED_KERNEL
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    mats = sched_matrices(rng)
    err = 0
    cases = 0
    for label, B in mats.items():
        op = ec_kernels.ScheduledXor(B, device=dev)
        plain = ec_kernels.gf_sched_xor_graph(B)
        for L in lengths:
            data = torch.randint(0, 256, (B.shape[1], L), dtype=torch.uint8,
                                 device=dev, generator=gen)
            got = op(data)
            want = plain(data)
            torch.cuda.synchronize(dev)
            diff = int((got.int() - want.int()).abs().max())
            err = max(err, diff)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{name} {label} L={L}: differs from its plain version "
                    f"(max abs err {diff})")
            cols = torch.from_numpy(oracle_columns(L)).to(dev)
            oracle = xor_schedule.naive_apply(B, data[:, cols].cpu().numpy())
            if not np.array_equal(got[:, cols].cpu().numpy(), oracle):
                raise AssertionError(
                    f"{name} {label} L={L}: differs from the oracle")
            cases += 1
            del data, got, want
    say("kernels", f"{name}: {cases} plane-row cases ({len(mats)} matrices "
                   f"x {len(lengths)} lengths) equal to the plain version "
                   "and the oracle")
    p_cases, p_err = check_packet_mode(dev, gen, size)
    err = max(err, p_err)
    say("kernels", f"{name}: {p_cases} packet-mode cases "
                   f"({len(PACKET_CASES)} codec matrices x granules "
                   f"{', '.join(map(str, PACKET_GRANULES))} and a "
                   f"{size >> 20} MiB object) equal to the plain version "
                   "and the numpy codec")
    row = None
    for label, technique, k, erased in (PACKET_CASES[0], PACKET_CASES[4]):
        B, w, codec = packet_matrix(technique, k, erased)
        Lc = codec.get_chunk_size(size)
        Lrow = Lc // w
        packet = ec_kernels.ScheduledXor(B, device=dev, w=w)
        chunks = torch.randint(0, 256, (packet.c, Lc), dtype=torch.uint8,
                               device=dev, generator=gen)
        c32 = chunks.view(torch.int32)
        state = packet._device_state()

        ms = cuda_ms(lambda: ec_kernels.gf_sched_xor_lanes(
            c32, packet.sched, state, w=w), n_time)
        apply_ms = cuda_ms(lambda: packet(chunks), n_time)
        plain = ec_kernels.gf_sched_xor_graph(B, w)
        plain_ms = cuda_ms(lambda: plain(chunks), max(5, n_time // 4),
                           warm=1)
        rows = ec_kernels.ScheduledXor(B, device=dev)
        Lp = Lrow + (-Lrow) % rows._quantum(Lrow)  # the width it launches
        x32 = torch.randint(0, 256, (B.shape[1], Lp), dtype=torch.uint8,
                            device=dev, generator=gen).view(torch.int32)
        rows_ms = cuda_ms(lambda: rows.encode_lanes(x32), n_time)
        nbytes = sum(B.shape) * Lrow
        src = torch.randint(0, 256, (nbytes // 2,), dtype=torch.uint8,
                            device=dev, generator=gen)
        copy_ms = cuda_ms(lambda: torch.empty_like(src).copy_(src), n_time)
        bound_ms, bound_by = bound(B, Lrow, sched_bound_parts)
        t_bytes, t_ops = sched_bound_parts(B, Lrow)
        clocks = nvidia_smi("clocks.sm,power.draw,temperature.gpu")
        say("kernels", f"{name}: {label} ({int(B.sum())} ones), object "
                       f"of {size >> 20} MiB, {Lrow} B per packet row: "
                       f"packet mode {ms:.4f} ms = {nbytes / ms / 1e6:.1f} "
                       f"GB/s, one whole apply {apply_ms:.4f} ms, plain "
                       f"{plain_ms:.3f} ms; plane rows at {Lp} B/row "
                       f"{rows_ms:.4f} ms; bound {bound_ms:.4f} ms "
                       f"({bound_by}; bytes {t_bytes:.4f}, operations "
                       f"{t_ops:.4f}), {ms / bound_ms:.2f}x the bound; a "
                       f"device copy of the same {nbytes} bytes "
                       f"{copy_ms:.4f} ms = {nbytes / copy_ms / 1e6:.1f} "
                       f"GB/s; after timing: {clocks}")
        if row is None:
            row = {"name": name, "route": "cuda", "source": SOURCE,
                   "replaces": site, "launches": 0, "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None}
        del chunks, x32, src
    return row


def phase_slice(dev: torch.device, rng: np.random.Generator,
                batch: int = 64, chunk: int = 128 * 1024) -> None:
    """The tpu plugin's encode/decode through its entry points."""
    codec = ec.factory("tpu", {"k": "8", "m": "3", "device": str(dev)})
    C = codec.matrix
    stripes = rng.integers(0, 256, (batch, 8, chunk), dtype=np.uint8)
    t0 = time.perf_counter()
    parity = codec.encode_batch(stripes)
    dt = time.perf_counter() - t0
    folded = stripes.transpose(1, 0, 2).reshape(8, batch * chunk)
    oracle = gf256.encode_region(C, folded).reshape(3, batch, chunk)
    if not np.array_equal(parity, oracle.transpose(1, 0, 2)):
        raise AssertionError("encode_batch differs from the oracle")
    say("slice", f"encode_batch {batch} x {8 * chunk >> 20} MiB stripes: "
                 f"byte-exact ({dt:.3f} s with the kernel race)")
    full = np.concatenate([stripes, parity], axis=1)
    for erased in ((1, 4, 9), (0, 1, 2), (8, 9, 10), (7,)):
        avail = {i: full[:, i, :] for i in range(11) if i not in erased}
        out = codec.decode_batch(list(erased), avail)
        for i in erased:
            if not np.array_equal(out[i], full[:, i, :]):
                raise AssertionError(f"decode_batch {erased}: chunk {i}")
        say("slice", f"decode_batch erasures {set(erased)}: byte-exact")
    obj = rng.integers(0, 256, batch * 8 * chunk // 64,
                       dtype=np.uint8).tobytes()
    chunks = codec.encode(obj)
    flat = np.frombuffer(obj, dtype=np.uint8)
    data = codec.encode_prepare(flat)
    oracle = gf256.encode_region(C, data)
    for i in range(11):
        want = data[i] if i < 8 else oracle[i - 8]
        if not np.array_equal(chunks[i], want):
            raise AssertionError(f"encode: chunk {i} differs")
    out = codec.decode([1, 4, 9], {i: c for i, c in chunks.items()
                                   if i not in (1, 4, 9)})
    if not all(np.array_equal(out[i], chunks[i]) for i in (1, 4, 9)):
        raise AssertionError("decode through the interface differs")
    say("slice", f"encode/decode of a {len(obj) >> 10} KiB object "
                 "through the interface: byte-exact")
    say("slice", f"kernel picks: {json.dumps(codec.kernel_picks())}")


def phase_cli(dev: torch.device, size: int = 80 << 20,
              iterations: int = 10) -> None:
    """tools.ec_benchmark encode and decode (its data is constant, as
    the reference's is), then a byte check of the same codec path at the
    same size on random data."""
    common = ["--plugin", "tpu", "-P", "k=8", "-P", "m=3",
              "--size", str(size), "--iterations", str(iterations),
              "--device", str(dev)]
    for extra in (["--workload", "encode"],
                  ["--workload", "decode", "--erasures", "3"]):
        out = run_quiet(f"ec_benchmark {extra}", ec_benchmark.main,
                        common + extra)
        say("cli", f"ec_benchmark {' '.join(extra)}: {out}")
    rng = np.random.default_rng(SEED)
    codec = ec.factory("tpu", {"k": "8", "m": "3", "device": str(dev)})
    data = rng.integers(0, 256, size, dtype=np.uint8)
    chunks = codec.encode(data)
    prepared = codec.encode_prepare(data)
    cols = oracle_columns(prepared.shape[1])
    oracle = gf256.encode_region(codec.matrix, prepared[:, cols])
    for i in range(8, 11):
        if not np.array_equal(chunks[i][cols], oracle[i - 8]):
            raise AssertionError(f"{size >> 20} MiB encode: parity {i} "
                                 "differs from the oracle")
    for erased in ((0, 5, 10), (3,)):
        out = codec.decode(list(erased), {i: c for i, c in chunks.items()
                                          if i not in erased})
        if not all(np.array_equal(out[i], chunks[i]) for i in erased):
            raise AssertionError(f"{size >> 20} MiB decode {erased} differs")
    say("cli", f"{size >> 20} MiB of random data: encode equal to the "
               f"oracle on {len(cols)} columns of every row, decodes of "
               "{0,5,10} and {3} byte-exact")


def corpus_grid(wide: bool) -> list:
    """The corpus grid's wide-code configurations, or all the others."""
    return [(plugin, prof) for plugin, prof in ec_non_regression.DEFAULT_GRID
            if (plugin in WIDE_PLUGINS) == wide]


def phase_corpus(dev: torch.device) -> None:
    say("corpus", run_quiet(
        "ec_non_regression --check", ec_non_regression.check,
        os.path.join(REPO, "corpus"), None, str(dev), corpus_grid(False)))


def phase_bits(dev: torch.device, rng: np.random.Generator,
               size: int = OBJECT_SIZE) -> int:
    """The bit-matrix techniques through the plugin's entry points: an
    object of ``size`` random bytes encoded, then decoded for every
    pattern of 1 or 2 erasures, each byte-exact against the
    numpy-backend codec and the original chunks.  Returns the applies
    that stayed on the host under the size rule."""
    host_applies = 0
    for technique, k in BIT_CODES:
        codec = bit_codec(technique, k, device=str(dev))
        host = bit_codec(technique, k, backend="numpy")
        obj = rng.integers(0, 256, size, dtype=np.uint8)
        before = ec_kernels.launch_counts()[SCHED_KERNEL[1]]
        t0 = time.perf_counter()
        chunks = codec.encode(obj)
        want = host.encode(obj)
        for i in want:
            if not np.array_equal(chunks[i], want[i]):
                raise AssertionError(f"{technique} encode: chunk {i}")
        n = codec.chunk_count
        patterns = [p for r in (1, 2)
                    for p in itertools.combinations(range(n), r)]
        for pat in patterns:
            avail = {i: c for i, c in chunks.items() if i not in pat}
            got = codec.decode(list(pat), avail)
            ref = host.decode(list(pat), avail)
            for i in pat:
                if not (np.array_equal(got[i], chunks[i])
                        and np.array_equal(ref[i], got[i])):
                    raise AssertionError(f"{technique} decode {pat}: "
                                         f"chunk {i}")
        launches = ec_kernels.launch_counts()[SCHED_KERNEL[1]] - before
        host_applies += codec.host_applies
        say("bits", f"{technique} k={k} m=2: {size >> 10} KiB object "
                    f"encoded and decoded for all {len(patterns)} patterns "
                    f"of 1 or 2 erasures, byte-exact against the numpy "
                    f"codec ({time.perf_counter() - t0:.3f} s, "
                    f"{launches} {SCHED_KERNEL[0]} launches, "
                    f"{codec.host_applies} host-path applies)")
    return host_applies


def phase_bit_cli(dev: torch.device, size: int = 80 << 20,
                  iterations: int = 3) -> None:
    """tools.ec_benchmark for the bit-matrix techniques (encode, and
    decode with 2 erasures) and one isa k=8 m=4 encode."""
    runs = []
    for technique, k in BIT_CODES:
        prof = ["--plugin", "jerasure", "-P", f"technique={technique}",
                "-P", f"k={k}", "-P", "m=2"]
        runs += [prof + ["--workload", "encode"],
                 prof + ["--workload", "decode", "--erasures", "2"]]
    runs.append(["--plugin", "isa", "-P", "k=8", "-P", "m=4",
                 "--workload", "encode"])
    for args in runs:
        out = run_quiet(f"ec_benchmark {args}", ec_benchmark.main,
                        args + ["--size", str(size), "--iterations",
                                str(iterations), "--device", str(dev)])
        say("bitcli", f"ec_benchmark {' '.join(args)} --size {size} "
                      f"--iterations {iterations}: {out}")


def phase_bit_corpus(dev: torch.device) -> None:
    """The bit-matrix corpus directories with the size rule at 0: at 4
    KiB stripes every apply is under it and would stay on the host."""
    grid = [(plugin, prof) for plugin, prof in ec_non_regression.DEFAULT_GRID
            if prof.get("technique") in dict(BIT_CODES)]
    saved = BitMatrixErasureCode.DEVICE_APPLY_MIN_BYTES
    BitMatrixErasureCode.DEVICE_APPLY_MIN_BYTES = 0
    try:
        out = run_quiet("bit-matrix corpus check", ec_non_regression.check,
                        os.path.join(REPO, "corpus"), None, str(dev), grid)
    finally:
        BitMatrixErasureCode.DEVICE_APPLY_MIN_BYTES = saved
    say("bitcorpus", f"device-apply size rule at 0: {out}")


def bit_path(dev: torch.device, rng: np.random.Generator, *,
             size: int = OBJECT_SIZE, cli_size: int = 80 << 20,
             iterations: int = 3) -> tuple[dict[str, int], int]:
    """Phases 7-9 with the launch counts set to 0 before and read after;
    returns the counts and the host-path applies of phase 7."""
    ec_kernels.reset_launches()
    host_applies = phase_bits(dev, rng, size)
    phase_bit_cli(dev, cli_size, iterations)
    phase_bit_corpus(dev)
    return ec_kernels.launch_counts(), host_applies


def main_path(dev: torch.device, rng: np.random.Generator, *,
              batch: int = 64, chunk: int = 128 * 1024,
              cli_size: int = 80 << 20, iterations: int = 10
              ) -> dict[str, int]:
    """Phases 4-6 with the launch counts set to 0 before and read
    after; returns the counts."""
    ec_kernels.reset_launches()
    phase_slice(dev, rng, batch, chunk)
    phase_cli(dev, cli_size, iterations)
    phase_corpus(dev)
    return ec_kernels.launch_counts()


def pick_cols(sig: str) -> int:
    """The column count of a pick signature's matrix
    (MatrixErasureCode._pick_sig: pick/<r>x<c>/m<crc>/L<bucket>)."""
    return int(sig.split("/")[1].split("x")[1])


def check_picks(picks: dict, counts: dict[str, int], what: str) -> None:
    """No kernel pick skipped a candidate, but for the one skip the race
    allows, ``mxu`` on a matrix wider than 32 columns (its signatures are
    printed); and G4 launched wherever a race saw a matrix of 32 columns
    or fewer.  ``picks``: the profiler's picks booked on the path."""
    bad = {s: p["skipped"] for s, p in picks.items() if p["skipped"]
           and (p["skipped"] != ["mxu"] or pick_cols(s) <= 32)}
    if bad:
        raise AssertionError(f"kernel picks skipped candidates: {bad}")
    wide = sorted(s for s, p in picks.items() if p["skipped"])
    narrow = [s for s, p in picks.items()
              if p["mode"] == "auto" and pick_cols(s) <= 32]
    if narrow and counts[KERNELS["mxu"][1]] <= 0:
        raise AssertionError(f"{len(narrow)} races of matrices of 32 "
                             f"columns or fewer on the {what}, and "
                             f"{KERNELS['mxu'][1]} never launched")
    say("launches", f"{what}: {len(picks)} kernel picks, {len(narrow)} "
                    f"raced on matrices of <= 32 columns; "
                    + (f"{len(wide)} skipped mxu, wider than 32 columns: "
                       + ", ".join(wide) if wide else "none skipped"))


def picks_since(t: float) -> dict:
    """The profiler's kernel picks booked at or after ``t`` (time.time())."""
    return {s: p for s, p in kernel_profiler().picks().items()
            if p["at"] >= t}


def check_main_path(counts: dict[str, int],
                    counters=tuple(k[1] for k in KERNELS.values()),
                    since: float = 0.0, what: str = "main path") -> None:
    """Every launch counter in ``counters`` moved, the plain versions
    never ran, and the picks booked since ``since`` pass check_picks."""
    say("launches", json.dumps(counts))
    for ctr in counters:
        if counts[ctr] <= 0:
            raise AssertionError(f"{ctr} never launched on the {what}")
    if counts["plain"]:
        raise AssertionError(
            f"a plain version ran {counts['plain']} times on the {what}")
    picks = picks_since(since)
    check_picks(picks, counts, what)
    say("launches", f"{what} picks: "
                    + json.dumps({s: p["picked"] for s, p in picks.items()}))


def check_race_picks(times: dict[str, dict[str, float]],
                     rng: np.random.Generator, margin: float = 0.05
                     ) -> None:
    """The race's picks at phase 3's shapes: where the main path raced a
    TIMED_SHAPES matrix at MAIN_L's bucket, it must have pinned a kernel
    that phase 3 timed within ``margin`` of the fastest of the three.
    ``times``: realization -> label -> ms."""
    picks = kernel_profiler().picks()
    mats = smoke_matrices(rng)
    for label in TIMED_SHAPES:
        sig = MatrixErasureCode._pick_sig(mats[label],
                                          _shape_bucket(MAIN_L))
        t = {k: v[label] for k, v in times.items()}
        fast = min(t, key=t.get)
        picked = picks.get(sig, {}).get("picked")
        gap = t[picked] / t[fast] - 1 if picked in t else 0.0
        say("launches", f"race at {label}, {sig}: picked {picked}; phase 3 "
                        + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
                        + f" (the pick {100 * gap:.1f} % above {fast})")
        if gap > margin:
            raise AssertionError(f"the race pinned {picked} at {label}, "
                                 f"where phase 3 timed {fast} "
                                 f"{100 * gap:.1f} % faster")


#: the batcher's flush methods and the fold kind each records as
FLUSH_KINDS = {"_flush_encode": "encode", "_flush_decode": "decode",
               "_flush_encode_subchunk": "subchunk encode",
               "_flush_decode_subchunk": "subchunk decode",
               "_flush_repair": "repair"}


@contextlib.contextmanager
def recorded_flushes(batcher, flushes: list):
    """Within the block, every flush of ``batcher`` appends (fold kind,
    signature, ops it carried)."""

    def wrap(kind, fn):
        def flush(sig, ops, reason):
            flushes.append((kind, sig, len(ops)))
            return fn(sig, ops, reason)
        return flush

    for name, kind in FLUSH_KINDS.items():
        setattr(batcher, name, wrap(kind, getattr(batcher, name)))
    try:
        yield
    finally:
        for name in FLUSH_KINDS:
            delattr(batcher, name)


def fold_summary(flushes: list) -> dict[str, list]:
    """fold kind -> [flushes, ops, most ops in one flush]."""
    out: dict[str, list] = {}
    for kind, _sig, n in flushes:
        agg = out.setdefault(kind, [0, 0, 0])
        agg[0] += 1
        agg[1] += n
        agg[2] = max(agg[2], n)
    return out


def _each_thread(n: int, per: int, fn) -> float:
    """_threads over ``n`` threads, thread t calling fn(i) for its ``per``
    indices t*per .. t*per + per - 1."""
    def run(t):
        for i in range(t * per, (t + 1) * per):
            fn(i)
    return _threads(n, run)


def phase_shec(dev: torch.device, rng: np.random.Generator, *, threads: int,
               per_thread: int, chunk: int, shec: dict, shec_object: int,
               shec_prefix: int, batcher: dict) -> dict:
    """SHEC through its entry points on the card: an object of
    ``shec_object`` bytes decoded for every set of 1, 2 and 3 erased
    chunks through the interface (byte-exact where the numpy codec
    decodes the first ``shec_prefix`` bytes of each chunk, refused where
    it refuses); then ``threads`` x ``per_thread`` checksummed encodes
    of (k, chunk) stripes through one ECBatcher built with ``batcher``;
    then degraded reads of every stripe with one data chunk missing and
    with a 3-erasure set missing.  Returns what check_wide_path reads."""
    prof = {key: str(v) for key, v in shec.items()}
    codec = ec.factory("shec", dict(prof, device=str(dev)))
    host = ec.factory("shec", dict(prof, backend="numpy"))
    k, n_chunks = codec.k, codec.chunk_count
    t0 = time.perf_counter()
    obj = rng.integers(0, 256, shec_object, dtype=np.uint8)
    chunks = codec.encode(obj)
    want = host.encode(obj)
    for i in want:
        if not np.array_equal(chunks[i], want[i]):
            raise AssertionError(f"shec encode: chunk {i} differs from the "
                                 "numpy codec")
    decoded = {1: [], 2: [], 3: []}
    total = {r: 0 for r in decoded}
    for r in decoded:
        for erased in itertools.combinations(range(n_chunks), r):
            total[r] += 1
            avail = {i: c for i, c in chunks.items() if i not in erased}
            try:
                ref = host.decode(list(erased), {
                    i: c[:shec_prefix] for i, c in avail.items()})
            except ec.ErasureCodeError:
                try:
                    codec.decode(list(erased), avail)
                except ec.ErasureCodeError:
                    continue
                raise AssertionError(f"shec decoded {erased} on the card, "
                                     "which the numpy codec refuses")
            got = codec.decode(list(erased), avail)
            for i in erased:
                if not (np.array_equal(got[i], chunks[i]) and
                        np.array_equal(ref[i], chunks[i][:shec_prefix])):
                    raise AssertionError(f"shec decode {erased}: chunk {i}")
            decoded[r].append(erased)
    decode_s = time.perf_counter() - t0
    say("shec", f"{shec_object >> 10} KiB object: every set of 1, 2 and 3 "
                f"erased chunks decoded byte-exact or refused as the numpy "
                f"codec does: {len(decoded[1])}/{total[1]}, "
                f"{len(decoded[2])}/{total[2]}, {len(decoded[3])}/"
                f"{total[3]} decode ({decode_s:.3f} s)")

    bat = ec_batcher.ECBatcher(**batcher)
    flushes = []
    n = threads * per_thread
    data = rng.integers(0, 256, (n, k, chunk), dtype=np.uint8)
    parity, csums = [None] * n, [None] * n

    def write(i):
        parity[i], csums[i] = bat.encode(codec, data[i], with_csums=True)

    c0 = csum_launches()
    with recorded_flushes(bat, flushes):
        write_s = _each_thread(threads, per_thread, write)
    fused = csum_launches() - c0
    # the native library's product, held against the numpy oracle by
    # tests/test_torch_native.py: 64 MiB through numpy would take seconds
    folded = data.transpose(1, 0, 2).reshape(k, n * chunk)
    oracle = native.encode_region(codec.matrix, folded).reshape(
        codec.m, n, chunk)
    for i in range(n):
        if not np.array_equal(parity[i], oracle[:, i]):
            raise AssertionError(f"shec write {i}: parity differs from the "
                                 "oracle")
        stack = np.concatenate([data[i], parity[i]])
        if not np.array_equal(csums[i], np.array(
                native.crc32c_blocks(stack, chunk), dtype=np.uint32)):
            raise AssertionError(f"shec write {i}: csums differ from native "
                                 "crc32c")
    writes = fold_summary(flushes).get("encode", [0, 0, 0])
    say("shec", f"{n} checksummed encodes of {k} x {chunk >> 10} KiB from "
                f"{threads} threads: parity equal to the oracle, csums to "
                f"native crc32c; {writes[0]} flushes of "
                f"{writes[1] / max(1, writes[0]):.2f} ops, {fused} through "
                f"the fused op; {n * k * chunk / write_s / 1e9:.3f} GB/s of "
                f"data ({write_s:.3f} s)")

    lost = (k // 2,)
    multi = next(e for e in decoded[3] if sum(i < k for i in e) >= 2)
    reads = {}
    for erased in (lost, multi):
        out = [None] * n
        mark = len(flushes)

        def read(i, erased=erased, out=out):
            full = np.concatenate([data[i], parity[i]])
            out[i] = bat.decode(codec, list(erased), {
                s: full[s] for s in range(n_chunks) if s not in erased})

        with recorded_flushes(bat, flushes):
            read_s = _each_thread(threads, per_thread, read)
        for i in range(n):
            for s in erased:
                want_s = data[i][s] if s < k else parity[i][s - k]
                if not np.array_equal(out[i][s], want_s):
                    raise AssertionError(f"shec read {i} {erased}: chunk {s}")
        rows = [len(bat._fold_rows_for(codec, sig))
                for kind, sig, _n in flushes[mark:] if kind == "decode"]
        mine = fold_summary(flushes[mark:]).get("decode", [0, 0, 0])
        reads[erased] = {"rows": rows, "s": read_s}
        say("shec", f"{n} degraded reads, chunks {list(erased)} missing: "
                    f"byte-exact; {mine[0]} flushes of "
                    f"{mine[1] / max(1, mine[0]):.2f} ops reading "
                    f"{sorted(set(rows))} rows (k={k}); "
                    f"{n * k * chunk / read_s / 1e9:.3f} GB/s of data "
                    f"({read_s:.3f} s)")
    return {"decode_s": decode_s, "write_s": write_s,
            "read_s": sum(r["s"] for r in reads.values()),
            "bytes": n * k * chunk, "fused": fused, "k": k,
            "narrow_rows": reads[lost]["rows"],
            "flushes": fold_summary(flushes)}


def phase_clay(dev: torch.device, rng: np.random.Generator, *, threads: int,
               per_thread: int, chunk: int, clay: dict, clay_objects: int,
               clay_erased: tuple, batcher: dict) -> dict:
    """CLAY through one ECBatcher built with ``batcher`` on the card:
    ``threads`` x ``per_thread`` checksummed encodes of (k, chunk)
    stripes (the sub-chunk fold) against the numpy codec and native
    crc32c; repairs of every chunk of the first ``clay_objects`` stripes
    from ``threads`` threads (the repair fold) against the numpy codec's
    repair_chunk; and their decode with ``clay_erased`` missing (the
    sub-chunk decode fold).  Returns what check_wide_path reads."""
    prof = {key: str(v) for key, v in clay.items()}
    codec = ec.factory("clay", dict(prof, device=str(dev)))
    host = ec.factory("clay", dict(prof, backend="numpy"))
    k, n_chunks, alpha = codec.k, codec.chunk_count, codec.alpha
    bat = ec_batcher.ECBatcher(**batcher)
    flushes = []
    n = threads * per_thread
    data = rng.integers(0, 256, (n, k, chunk), dtype=np.uint8)
    parity, csums = [None] * n, [None] * n

    def write(i):
        parity[i], csums[i] = bat.encode(codec, data[i], with_csums=True)

    with recorded_flushes(bat, flushes):
        write_s = _each_thread(threads, per_thread, write)
    for i in range(n):
        if not np.array_equal(parity[i], host.encode_chunks(data[i])):
            raise AssertionError(f"clay write {i}: parity differs from the "
                                 "numpy codec")
        stack = np.concatenate([data[i], parity[i]])
        if not np.array_equal(csums[i], np.array(
                native.crc32c_blocks(stack, chunk), dtype=np.uint32)):
            raise AssertionError(f"clay write {i}: csums differ from native "
                                 "crc32c")
    writes = fold_summary(flushes).get("subchunk encode", [0, 0, 0])
    say("clay", f"k={k} m={codec.m} d={codec.d}, {alpha} planes: {n} "
                f"checksummed encodes of {k} x {chunk >> 10} KiB from "
                f"{threads} threads equal to the numpy codec, csums to "
                f"native crc32c; {writes[0]} sub-chunk flushes of "
                f"{writes[1] / max(1, writes[0]):.2f} ops; "
                f"{n * k * chunk / write_s / 1e9:.3f} GB/s of data "
                f"({write_s:.3f} s)")

    fulls = [np.concatenate([data[i], parity[i]])
             for i in range(clay_objects)]
    per = clay_objects // threads
    repaired = {}

    def helpers(i, lost):
        planes = codec.repair_planes(lost)
        return {h: fulls[i][h].reshape(alpha, -1)[planes]
                for h in range(n_chunks) if h != lost}

    def repair(t):
        for lost in range(n_chunks):
            for i in range(t * per, (t + 1) * per):
                repaired[i, lost] = bat.repair(codec, lost, helpers(i, lost),
                                               chunk)

    mark = len(flushes)
    with recorded_flushes(bat, flushes):
        repair_s = _threads(threads, repair)
    for (i, lost), got in repaired.items():
        if not (np.array_equal(got, fulls[i][lost]) and np.array_equal(
                got, host.repair_chunk(lost, helpers(i, lost), chunk))):
            raise AssertionError(f"clay repair of chunk {lost} of object "
                                 f"{i} differs")
    reps = fold_summary(flushes[mark:]).get("repair", [0, 0, 0])
    sent = sum(h.nbytes for h in helpers(0, 0).values())
    say("clay", f"{len(repaired)} repairs (every chunk of {clay_objects} "
                f"objects) from {threads} threads equal to the stored chunk "
                f"and the numpy codec's repair_chunk; {reps[0]} repair "
                f"flushes of {reps[1] / max(1, reps[0]):.2f} ops; helpers "
                f"send {sent >> 10} KiB a repair against {k * chunk >> 10} "
                f"KiB for a read of k chunks; {repair_s:.3f} s")

    out = [None] * clay_objects

    def read(i):
        out[i] = bat.decode(codec, list(clay_erased), {
            s: fulls[i][s] for s in range(n_chunks) if s not in clay_erased})

    mark = len(flushes)
    with recorded_flushes(bat, flushes):
        read_s = _each_thread(threads, per, read)
    ref = host.decode(list(clay_erased), {
        s: fulls[0][s] for s in range(n_chunks) if s not in clay_erased})
    for i in range(clay_objects):
        for s in clay_erased:
            if not np.array_equal(out[i][s], fulls[i][s]) or (
                    i == 0 and not np.array_equal(ref[s], fulls[i][s])):
                raise AssertionError(f"clay decode {clay_erased} of object "
                                     f"{i}: chunk {s}")
    dec = fold_summary(flushes[mark:]).get("subchunk decode", [0, 0, 0])
    say("clay", f"{clay_objects} degraded reads, chunks {list(clay_erased)} "
                f"missing: byte-exact; {dec[0]} sub-chunk flushes of "
                f"{dec[1] / max(1, dec[0]):.2f} ops; "
                f"{clay_objects * k * chunk / read_s / 1e9:.3f} GB/s of data "
                f"({read_s:.3f} s)")
    return {"write_s": write_s, "repair_s": repair_s, "read_s": read_s,
            "bytes": n * k * chunk, "read_bytes": clay_objects * k * chunk,
            "flushes": fold_summary(flushes)}


def phase_wide_corpus(dev: torch.device) -> None:
    say("widecorpus", run_quiet(
        "wide-code corpus check", ec_non_regression.check,
        os.path.join(REPO, "corpus"), None, str(dev), corpus_grid(True)))


def wide_path(dev: torch.device, rng: np.random.Generator, *, threads: int,
              per_thread: int, chunk: int, shec: dict, shec_object: int,
              shec_prefix: int, clay: dict, clay_objects: int,
              clay_erased: tuple, batcher: dict
              ) -> tuple[dict[str, int], dict]:
    """Phases 12-14 with the launch counts set to 0 before and read
    after; returns the counts and the phases' results, and prints the
    [wide] line."""
    ec_kernels.reset_launches()
    t0 = time.perf_counter()
    shec_res = phase_shec(dev, rng, threads=threads, per_thread=per_thread,
                          chunk=chunk, shec=shec, shec_object=shec_object,
                          shec_prefix=shec_prefix, batcher=batcher)
    t1 = time.perf_counter()
    clay_res = phase_clay(dev, rng, threads=threads, per_thread=per_thread,
                          chunk=chunk, clay=clay, clay_objects=clay_objects,
                          clay_erased=clay_erased, batcher=batcher)
    t2 = time.perf_counter()
    phase_wide_corpus(dev)
    t3 = time.perf_counter()
    counts = ec_kernels.launch_counts()
    folds = {f"shec {key}": v for key, v in shec_res["flushes"].items()}
    folds.update({f"clay {key}": v for key, v in clay_res["flushes"].items()})
    say("wide", f"walls: shec {t1 - t0:.3f} s (decodes "
                f"{shec_res['decode_s']:.3f}), clay {t2 - t1:.3f} s, "
                f"widecorpus {t3 - t2:.3f} s; shec writes "
                f"{shec_res['bytes'] / shec_res['write_s'] / 1e9:.3f} GB/s "
                f"and reads "
                f"{2 * shec_res['bytes'] / shec_res['read_s'] / 1e9:.3f} "
                f"GB/s of data; clay writes "
                f"{clay_res['bytes'] / clay_res['write_s'] / 1e9:.3f} GB/s, "
                f"reads "
                f"{clay_res['read_bytes'] / clay_res['read_s'] / 1e9:.3f} "
                f"GB/s; flushes (count, ops a flush, most): " + "; ".join(
                    f"{kind} {v[0]}, {v[1] / v[0]:.2f}, {v[2]}"
                    for kind, v in folds.items()))
    return counts, {"shec": shec_res, "clay": clay_res, "folds": folds}


def check_wide_path(counts: dict[str, int], result: dict,
                    since: float = 0.0) -> None:
    """The wide path launched a region kernel (K1, K2 or G4, as the race
    picked) and G1, no plain version, and its picks pass check_picks;
    every SHEC encode flush took the fused op; every SHEC fold of one
    lost data chunk read fewer than k rows; at least one sub-chunk flush
    and one repair flush carried more than one op."""
    say("launches", f"wide path: {json.dumps(counts)}")
    if sum(counts[k[1]] for k in KERNELS.values()) <= 0:
        raise AssertionError("no region kernel launched on the wide path")
    if counts[CRC_KERNEL[1]] <= 0:
        raise AssertionError(f"{CRC_KERNEL[1]} never launched on the wide "
                             "path")
    if counts["plain"]:
        raise AssertionError(f"a plain version ran {counts['plain']} times "
                             "on the wide path")
    picks = picks_since(since)
    check_picks(picks, counts, "wide path")
    shec, folds = result["shec"], result["folds"]
    writes = folds.get("shec encode", [0, 0, 0])[0]
    if not writes or shec["fused"] != writes:
        raise AssertionError(f"{writes} shec encode flushes took the fused "
                             f"op {shec['fused']} times")
    rows = shec["narrow_rows"]
    if not rows or max(rows) >= shec["k"]:
        raise AssertionError(f"shec folds of one lost data chunk read {rows} "
                             f"rows, not fewer than k={shec['k']}")
    sub = max(folds.get(f"clay subchunk {op}", [0, 0, 0])[2]
              for op in ("encode", "decode"))
    rep = folds.get("clay repair", [0, 0, 0])[2]
    if sub < 2 or rep < 2:
        raise AssertionError(f"the most ops in one sub-chunk flush was {sub} "
                             f"and in one repair flush {rep}, not above 1")
    say("launches", f"wide path: {writes} shec encode flushes all fused; "
                    f"narrow folds of {sorted(set(rows))} rows; at most "
                    f"{sub} ops in a sub-chunk flush and {rep} in a repair "
                    f"flush")


def bench_runs() -> list[tuple[str, list[str]]]:
    """Phase 15's bench_tpu runs at BASELINE's k=8 m=3: encode at 4 KiB
    to 4 MiB stripes (batch min(64, 64 MiB / stripe), the sweep's rule),
    decode and the fused encode+CRC at 1 MiB."""
    runs = []
    for stripe in BENCH["stripes"]:
        batch = max(1, min(64, (64 << 20) // stripe))
        runs.append((f"encode {stripe >> 10} KiB",
                     ["--stripe-bytes", str(stripe), "--batch", str(batch)]))
    one = ["--stripe-bytes", str(1 << 20), "--batch", "64"]
    runs.append(("decode 1024 KiB", one + ["--workload", "decode"]))
    runs.append(("encode+csum 1024 KiB", one + ["--csum"]))
    return [(label, ["--k", "8", "--m", "3", "--reps", str(BENCH["reps"])]
             + argv) for label, argv in runs]


def check_bench(line: dict, device) -> None:
    """A bench line's digests were verified and it measured a rate for
    every realization that kernel_supports lets run its matrix on
    ``device``, and for no other."""
    W = bench_tpu.working_matrix(line["k"], line["m"], "reed_sol_van",
                                 line["workload"].split("+")[0])
    want = [k for k in ec_kernels.KERNELS
            if ec_kernels.kernel_supports(k, W, device=device)]
    cands = line["candidates"]
    if (line["digest_verified"] is not True or sorted(cands) != sorted(want)
            or not all(cands[k]["kernel_gbps"] > 0 for k in want)):
        raise AssertionError(f"bench: {line['workload']} measured "
                             f"{sorted(cands)}, want {want} verified")


def phase_bench(dev: torch.device, runs=None) -> list[dict]:
    """Phase 15's bench twin (tools/bench_tpu), in this process, for each
    of ``runs`` (bench_runs()); returns the bench lines."""
    lines = []
    for label, argv in runs or bench_runs():
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                out = run_quiet(f"bench_tpu {label}", bench_tpu.main,
                                argv + ["--device", dev.type])
        except Exception:
            print(err.getvalue(), file=sys.stderr)
            raise
        line = json.loads(out.splitlines()[-1])
        check_bench(line, dev)
        say("bench", f"{label}: kernel " + ", ".join(
            f"{k} {v['kernel_gbps']:.1f}" for k, v in
            line["candidates"].items())
            + f" GB/s (winner {line['kernel']}); staging "
            f"{line['staging_gbps']} GB/s, e2e {line['e2e_gbps']} GB/s; "
            f"{line['bytes_per_rep'] >> 20} MiB a rep, digests verified; "
            f"{line['device']}, {line['power_limit']}")
        lines.append(line)
    return lines


def phase_sweep(device: str, only: str = "headline_1M_b64") -> dict:
    """One bench_sweep row through its subprocess path; returns the
    row's state entry."""
    t0 = time.perf_counter()
    out = run_quiet("bench_sweep", bench_sweep.main,
                    ["--only", only, "--device", device, "--retries", "0"])
    with open(bench_sweep.STATE[device]) as f:
        entry = json.load(f)[only]
    res = entry.get("result", {})
    if res.get("digest_verified") is not True:
        raise AssertionError(f"bench_sweep {only}: {entry}")
    say("bench", f"bench_sweep --only {only}: kernel {res['kernel']} "
                 f"{res['kernel_gbps']} GB/s, e2e {res['e2e_gbps']} GB/s, "
                 f"{time.perf_counter() - t0:.1f} s with the child's start; "
                 f"{out}")
    return entry


#: phase 16: three monitors on a LocalNetwork, the tpu reed_sol_van k=8
#: m=3 pool at pg_num 1024 (Ceph's mon_target_pg_per_osd 100 gives
#: 96 x 100 / 11 ~ 873 PGs, rounded up to a power of two), the 96 OSDs of
#: 12 hosts (8 each) that boot into it, and the (8, 8 MiB) encode of the
#: codec built from the pushed map; the bound on each wait, and how often
#: the stub boots again an OSD the leader's map lacks
CLUSTER = dict(mons=3, osds=96, per_host=8, pg_num=1024, k=8, m=3,
               encode_L=8 << 20, wait_s=120.0, resend_s=2.0)
#: sha256 of pg_mapping_digest over the map the quorum commits
#: (CLUSTER's 96 OSDs up at weight 1.0, the pool as pool 1), computed
#: from the JAX package's OSDMap by tests/test_torch_chip_smoke.py
CLUSTER_DIGEST = ("41410a108d8aee448430b70b72b42bc0"
                  "fb9b724c4da57696c858679c55f539a6")
#: the archived corpus_wire/ files phase 16 replays (all of them)
DENCODER_FILES = 55


def cluster_profile(dev: torch.device) -> dict:
    """Phase 16's pool profile: the tpu plugin's reed_sol_van k=8 m=3 on
    the torch backend and ``dev``."""
    return {"plugin": "tpu", "technique": "reed_sol_van",
            "k": str(CLUSTER["k"]), "m": str(CLUSTER["m"]),
            "backend": "torch", "device": dev.type}


def pg_mapping_digest(osdmap) -> str:
    """sha256 over the acting set (OSDMap.pg_to_up_osds) of every PG of
    every pool of ``osdmap``, pools in id order, a hole as -1."""
    h = hashlib.sha256()
    for pid in sorted(osdmap.pools):
        for seed in range(osdmap.pools[pid].pg_num):
            acting = osdmap.pg_to_up_osds(pid, seed)
            h.update(struct.pack(f"<ii{len(acting)}i", pid, seed, *(
                -1 if d is None else d for d in acting)))
    return h.hexdigest()


def _retry_until(what: str, done, act, wait_s: float,
                 every_s: float) -> None:
    """``act()``, then again every ``every_s``, until ``done()``; fails
    when ``what`` has not happened within ``wait_s``."""
    deadline = time.monotonic() + wait_s
    while not done():
        if time.monotonic() > deadline:
            raise AssertionError(f"cluster: {what} within {wait_s} s")
        act()
        step = min(deadline, time.monotonic() + every_s)
        while not done() and time.monotonic() < step:
            time.sleep(0.01)


def cluster_quorum(net, *, mons: int, wait_s: float, **_) -> list:
    """Three MonitorLites on ``net`` started; returns them once one is
    the leader."""
    names = [f"mon.{i}" for i in range(mons)]
    cfg = default_config()
    quorum = [monitor.MonitorLite(net, name, cfg=cfg, peers=names)
              for name in names]
    for m in quorum:
        m.start()
    _retry_until("a leader elected", lambda: any(m.is_leader for m in quorum),
                 lambda: None, wait_s, wait_s)
    return quorum


#: the name of phase 16's pool
CLUSTER_POOL = "ecpool"


def _committed(mon):
    """The OSDMap ``mon`` has committed, or None."""
    raw = mon.store.kv.get("osdmap")
    return None if raw is None else mon_maps.OSDMap.decode_bytes(raw)


def _has_pool(osdmap) -> bool:
    return osdmap is not None and any(
        p.name == CLUSTER_POOL for p in osdmap.pools.values())


def cluster_pool(quorum: list, dev: torch.device, *, pg_num: int,
                 wait_s: float, resend_s: float, **_) -> dict:
    """``osd pool create`` of the tpu pool on the leader, and again on
    the next leader when an election drops the epoch before it commits
    (as a client retries its command); returns the answer once every
    monitor has committed the pool.  Fails unless each create was
    accepted without a kernel launch or a card allocation."""
    cmd = {"prefix": "osd pool create", "name": CLUSTER_POOL, "kind": "ec",
           "pg_num": pg_num, "ec_profile": cluster_profile(dev)}
    answers = []

    def create() -> None:
        leader = next((m for m in quorum if m.is_leader), None)
        if leader is None:
            return
        with leader._lock:
            if _has_pool(leader.osdmap):
                return
            before = ec_kernels.launch_counts()
            mem = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
            rc, data = leader._run_command(cmd)
        if rc != 0:
            raise AssertionError(f"cluster: pool create refused: {rc} "
                                 f"{data}")
        if ec_kernels.launch_counts() != before:
            raise AssertionError("cluster: the pool create launched "
                                 f"kernels: {before} -> "
                                 f"{ec_kernels.launch_counts()}")
        if dev.type == "cuda" and torch.cuda.memory_allocated() != mem:
            raise AssertionError("cluster: the pool create allocated on "
                                 "the card")
        answers.append(data)

    _retry_until("the pool committed by every monitor",
                 lambda: all(_has_pool(_committed(m)) for m in quorum),
                 create, wait_s, resend_s)
    return answers[-1] if answers else None


def cluster_boot(net, quorum: list, *, osds: int, per_host: int,
                 wait_s: float, resend_s: float, **_
                 ) -> tuple[bytes, int]:
    """MOSDBoot of ``osds`` OSDs (``per_host`` a host) from a stub
    sender to the leader; returns the committed OSDMap's bytes once every
    monitor has committed the same map with them all up, and the boots
    sent.  As an OSD does when a pushed map leaves it out (a boot lost
    in an election), the stub boots again, every ``resend_s``, each OSD
    the leader's map lacks."""
    stub = Messenger(net, "client.boot", Policy.lossless_peer())
    stub.start()

    def converged() -> bool:
        raws = {m.store.kv.get("osdmap") for m in quorum}
        if len(raws) != 1 or None in raws:
            return False
        osdmap = mon_maps.OSDMap.decode_bytes(raws.pop())
        return len(osdmap.up_osds()) == osds and _has_pool(osdmap)

    sent = 0

    def boot() -> None:
        nonlocal sent
        leader = next((m for m in quorum if m.is_leader), None)
        if leader is None:
            return
        with leader._lock:
            up = set(leader.osdmap.up_osds())
        for i in range(osds):
            if i not in up:
                stub.send_message(leader.name, messages.MOSDBoot(
                    i, f"host{i // per_host}", f"osd.{i}"))
                sent += 1

    try:
        _retry_until(f"{osds} OSDs up in one map committed by every "
                     "monitor", converged, boot, wait_s, resend_s)
    finally:
        stub.shutdown()
    return quorum[0].store.kv["osdmap"], sent


class MapSink(Dispatcher):
    """Receiver of phase 16's map push: decodes each MMapPush through
    the maps' shared receiver state machine."""

    def __init__(self):
        self.osdmap = None
        self.got = threading.Event()

    def ms_dispatch(self, conn, msg) -> bool:
        if not isinstance(msg, messages.MMapPush):
            return False
        new, _ = mon_maps.apply_map_push(self.osdmap, msg)
        if new is not None:
            self.osdmap = new
            self.got.set()
        return True


def cluster_push(raw: bytes, epoch: int, *, wait_s: float, **_):
    """``raw`` (an encoded OSDMap) as an MMapPush over the TCP messenger
    on loopback in secure mode; returns the map the Dispatcher
    decoded."""
    net = tcp.TcpNetwork(auth_secret=os.urandom(32), secure=True)
    tx = Messenger(net, "mon.push", Policy.lossless_peer())
    rx = Messenger(net, "osd.push", Policy.lossless_peer())
    sink = MapSink()
    rx.add_dispatcher(sink)
    try:
        tx.start()
        rx.start()
        net.set_addr("osd.push", net.addr_of("osd.push"))
        if not tx.send_message("osd.push", messages.MMapPush(epoch, raw)):
            raise AssertionError("cluster: the map push was not sent")
        if not sink.got.wait(wait_s):
            raise AssertionError("cluster: no map push arrived")
    finally:
        tx.shutdown()
        rx.shutdown()
        net.stop()
    return sink.osdmap


def cluster_codec(osdmap, dev: torch.device, rng: np.random.Generator, *,
                  k: int, encode_L: int, **_) -> list[float]:
    """The pool's codec built from the pushed map as the OSD builds it
    (osd/daemon.py _pool_codec, ec_backend torch), an encode of a (k,
    encode_L) stack twice (the first races the kernels), each held
    against native.encode_region; returns their times in ms (CUDA events
    on the card, host wall on the CPU)."""
    cfg = default_config()
    cfg.apply_dict({"ec_backend": "torch"})
    pool = next(p for p in osdmap.pools.values() if p.kind == "ec")
    profile = dict(pool.ec_profile)
    plugin = profile.pop("plugin", cfg["ec_plugin"])
    profile.setdefault("backend", cfg["ec_backend"])
    profile.setdefault("shard", cfg["ec_shard"])
    profile.setdefault("kernel", cfg["ec_kernel"])
    codec = ec.factory(plugin, profile)
    data = rng.integers(0, 256, (k, encode_L), dtype=np.uint8)
    want = native.encode_region(codec.matrix, data)
    times = []
    for _ in range(2):  # the first encode races the kernels
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            parity = codec.encode_chunks(data)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            parity = codec.encode_chunks(data)
            times.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(parity, want):
            raise AssertionError("cluster: the pushed pool's encode "
                                 "differs from native.encode_region")
    return times


def phase_cluster(dev: torch.device, rng: np.random.Generator,
                  corpus: str | None = None, **over) -> dict[str, int]:
    """Phase 16 with the launch counts set to 0 before and read after:
    the wire corpus, the quorum and the pool, the boots and the map
    push, the codec from the pushed map.  Returns the counts."""
    cfg = dict(CLUSTER, **over)
    t0 = time.perf_counter()
    report = dencoder.check(corpus or os.path.join(REPO, "corpus_wire"))
    if report.problems or len(report.checked) != DENCODER_FILES:
        raise AssertionError(f"cluster: wire corpus {report}")
    say("cluster", f"wire corpus: {len(report.checked)} files checked")
    ec_kernels.reset_launches()
    net = LocalNetwork()
    t1 = time.perf_counter()
    quorum = cluster_quorum(net, **cfg)
    try:
        t_quorum = time.perf_counter() - t1
        t1 = time.perf_counter()
        cluster_pool(quorum, dev, **cfg)
        t_pool = time.perf_counter() - t1
        t1 = time.perf_counter()
        raw, sent = cluster_boot(net, quorum, **cfg)
        t_boot = time.perf_counter() - t1
    finally:
        for m in quorum:
            m.stop()
    epoch = mon_maps.OSDMap.decode_bytes(raw).epoch
    t1 = time.perf_counter()
    pushed = cluster_push(raw, epoch, **cfg)
    t_push = time.perf_counter() - t1
    if pushed.encode_bytes() != raw:
        raise AssertionError("cluster: the pushed map re-encodes to other "
                             "bytes")
    t1 = time.perf_counter()
    digest = pg_mapping_digest(pushed)
    t_digest = time.perf_counter() - t1
    if digest != CLUSTER_DIGEST:
        raise AssertionError(f"cluster: PG-mapping digest {digest}, want "
                             f"{CLUSTER_DIGEST}")
    hosts = {o.host for o in pushed.osds.values()}
    pool = next(p for p in pushed.pools.values() if p.name == CLUSTER_POOL)
    say("cluster", f"map e{epoch}: {len(pushed.osds)} OSDs on "
                   f"{len(hosts)} hosts, pool {pool.name} {pool.kind} "
                   f"size {pool.size} pg_num {pool.pg_num}, "
                   f"{len(raw)} bytes encoded; PG-mapping digest matches")
    enc_ms = cluster_codec(pushed, dev, rng, **cfg)
    counts = ec_kernels.launch_counts()
    say("cluster", f"quorum {t_quorum:.3f} s, pool create {t_pool:.3f} s, "
                   f"{cfg['osds']} boots committed {t_boot:.3f} s ({sent} "
                   f"sent, terms {[m._term for m in quorum]}), map push "
                   f"{t_push:.3f} s, digest {t_digest:.3f} s (host wall); "
                   f"map {len(raw)} bytes; encode ({cfg['k']}, "
                   f"{cfg['encode_L'] >> 10} KiB) {enc_ms[0]:.4f} ms with "
                   f"the kernel race, {enc_ms[1]:.4f} ms after it ("
                   f"{'CUDA events' if dev.type == 'cuda' else 'host wall'}"
                   f"); {card(dev)}; phase "
                   f"{time.perf_counter() - t0:.1f} s")
    return counts


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device type off the card."""
    return nvidia_smi("name,power.limit") if dev.type == "cuda" \
        else dev.type


def check_cluster(counts: dict[str, int]) -> None:
    """Phase 16's encode launched a region kernel (K1, K2 or G4, as
    raced) and never a plain version."""
    say("launches", f"cluster: {json.dumps(counts)}")
    region = [KERNELS[r][1] for r in KERNELS]
    if not any(counts[c] > 0 for c in region):
        raise AssertionError(f"no region kernel ({', '.join(region)}) "
                             "launched on the cluster phase")
    if counts["plain"]:
        raise AssertionError(f"a plain version ran {counts['plain']} "
                             "times on the cluster phase")


#: phase 17: the port's cluster on the card, at the size of a small
#: production EC pool: 14 OSDs, each on its own host, one monitor, local
#: transport, the default config but OSD_CONFIG below (so the pool's
#: codec is torch on the card), the tpu reed_sol_van k=8 m=3 pool at pg_num 64 with Ceph's
#: 4 KiB stripe unit; 8 client threads write 64 objects of 4 MiB (the
#: RADOS default object size: 256 MiB of data, 352 MiB stored), read
#: each back twice, deep-scrub one PG, lose two OSDs, read everything
#: degraded and recover onto the spares.  ``wait_s`` bounds each wait,
#: ``sample`` is how many objects are read back after recovery.  Cut
#: from 128 objects to 64: at 128 the phase took 37.5-44.2 s on the
#: card, most of it the 14 OSDs' host work under one interpreter lock
#: after the loss (peering, and the rebuild's decodes with their kernel
#: races), and whole runs reached 403.3 s, past the ~330 s they aim at;
#: phase 20 drives the same cluster and pool with 128 objects in one PG.
OSD_PHASE = dict(osds=14, pg_num=64, k=8, m=3, objects=64,
                 object_size=OBJECT_SIZE, threads=8, lost=2, sample=16,
                 wait_s=240.0)
OSD_POOL = "ecpool"
#: the options phase 17 sets over the default config, for 14 OSDs, a
#: monitor and 8 clients that share one process and so one interpreter
#: lock (each seen on an H100 host):
#: - osd_scrub_auto off (default on): the background scrub scheduler's
#:   heartbeat tick placed every PG of its OSD in Python, and at 64 PGs
#:   the OSDs starved their own heartbeats until the monitor marked
#:   every OSD down (both packages, within seconds of the pool's
#:   creation; since then a receiver's map places each PG once, see
#:   mon/maps.py OSDMap.freeze), so the phase runs its one scrub cycle
#:   itself;
#: - osd_heartbeat_grace 60 s (default 3): under the writes a heartbeat
#:   reply can wait on the lock past 3 s, so OSDs flap down and up and
#:   shards land on stand-ins; the phase marks its lost OSDs down itself;
#: - osd_op_timeout 20 s (default 5): at 5 s the rebuild's shard reads
#:   time out and are sent again, hundreds of them, and runs fail
#:   (experiments/osd_trace.py --defaults); at 20 s none timed out, the
#:   oldest op pending 5-15 s.  The phase fails if any op waits out the
#:   20 s.
OSD_CONFIG = {"osd_scrub_auto": False, "osd_heartbeat_grace": 60.0,
              "osd_op_timeout": 20.0}


def osd_profile(dev: torch.device, *, k: int, m: int, **_) -> dict:
    """Phase 17's pool: tpu reed_sol_van with no backend and no device,
    so the OSDs build its codec as their config says (torch on the
    card); off the card (the CPU rehearsal) it asks for the CPU."""
    prof = {"plugin": "tpu", "technique": "reed_sol_van", "k": str(k),
            "m": str(m)}
    if dev.type != "cuda":
        prof["device"] = dev.type
    return prof


def osd_counters(cluster) -> dict:
    """The counters phase 17 reads before and after each step: launches
    of every kernel (and plain version), fused encode+CRC launches, the
    staging plane's copies back, the arena's hits, and the reads the
    OSDs served from their extent caches."""
    out = ec_kernels.launch_counts()
    out["fused"] = csum_launches()
    pc = staging.stage_perf()
    for name in ("ec_arena_hits", "ec_stage_d2h_copies"):
        # the arena's counters appear with the first arena
        out[name] = pc.get(name) if pc.has(name) else 0
    out["cache_served"] = sum(o.perf.get("ec_read_cache_hit")
                              for o in cluster.osds.values())
    return out


def osd_faults(osds: list) -> dict:
    """Over the phase's OSDs (the lost ones too): ops the osd_op_timeout
    sweep failed, and messages dropped by their messengers' throttles
    and their op queues' caps."""
    return {"op_timeouts": sum(o.perf.get("op_timeouts") for o in osds),
            "dropped": sum(o.messenger.perf.get("msg_drop_backpressure")
                           + sum(o.scheduler.dropped.values())
                           for o in osds)}


def counter_delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


@contextlib.contextmanager
def osd_flushes(cluster, flushes: list):
    """Within the block, every flush of every OSD's batcher appends
    (fold kind, signature, ops it carried)."""
    with contextlib.ExitStack() as stack:
        for osd in list(cluster.osds.values()):
            stack.enter_context(recorded_flushes(osd._ec_batcher, flushes))
        yield


def osd_codecs_on(cluster, dev: torch.device) -> int:
    """Every codec the OSDs built is on the torch backend on ``dev``, and
    so is every arena; returns how many codecs there are."""
    codecs = [c for o in cluster.osds.values() for c in o._ec_codecs.values()]
    wrong = [(c._backend, c.device) for c in codecs
             if c._backend != "torch" or c.device.type != dev.type]
    wrong += [("arena", a.device) for o in cluster.osds.values()
              for a in o._ec_cache._arenas.values()
              if a.device.type != dev.type]
    if not codecs or wrong:
        raise AssertionError(f"osd: codecs off the {dev.type}: {wrong}")
    return len(codecs)


def osd_peered(cluster, wait_s: float) -> None:
    """Wait until every PG has peered (its primary heard from each
    member), failing with the PGs still waiting and on whom."""
    def pending():
        return {i: {pg: set(w) for pg, w in list(o._peering.items())}
                for i, o in list(cluster.osds.items()) if o._peering}

    deadline = time.monotonic() + wait_s
    while (now := pending()):
        if time.monotonic() > deadline:
            raise AssertionError(f"osd: peering not within {wait_s} s: "
                                 f"{now}")
        time.sleep(0.05)


def osd_rebuilt(cluster, pool_id: int, lost: list) -> bool:
    """Each lost (object, shard) lies on the OSD the map now puts that
    shard on."""
    omap = cluster.mon.osdmap
    for name, shard in lost:
        seed = omap.object_to_pg(pool_id, name)
        osd = cluster.osds.get(omap.pg_to_up_osds(pool_id, seed)[shard])
        if osd is None or not osd.store.exists(CollectionId(pool_id, seed),
                                               ObjectId(name, shard=shard)):
            return False
    return True


def osd_scrub_pg(cluster, pool_id: int, seed: int) -> dict:
    """One folded deep-scrub cycle of PG ``seed`` on each OSD of its up
    set, chunk after chunk on this thread (the background scheduler's
    cycle, run to its end): returns the OSDs' summed scrub counters."""
    pgid = messages.PgId(pool_id, seed)
    tot = {"objects": 0, "bytes": 0, "mismatches": 0, "launches": 0}
    for osd_id in cluster.mon.osdmap.pg_to_up_osds(pool_id, seed):
        osd = cluster.osds[osd_id]
        launches = osd.perf.get("scrub_verify_launches")
        st = {"due": 0.0, "running": True, "objects": 0, "bytes": 0,
              "mismatches": 0, "started": time.time(), "total": 0}
        while not osd._scrub_auto_run_chunk(pgid, st):
            pass
        for key in ("objects", "bytes", "mismatches"):
            tot[key] += st[key]
        tot["launches"] += osd.perf.get("scrub_verify_launches") - launches
    return tot


def phase_osd(dev: torch.device, rng: np.random.Generator,
              **over) -> tuple[dict[str, int], dict]:
    """Phase 17 with the launch counts set to 0 before and read after:
    the writes, two reads of every object, a deep scrub of one PG, the
    degraded reads with two OSDs lost and the recovery onto the spares,
    all through a MiniCluster of the port's OSDs and RadosClients.  The
    degraded reads run while recovery rebuilds.  Returns the counts and
    the phase's numbers."""
    cfg = dict(OSD_PHASE, **over)
    k, m, n, size = cfg["k"], cfg["m"], cfg["objects"], cfg["object_size"]
    threads = cfg["threads"]
    per = n // threads
    if per * threads != n:
        raise ValueError("objects must be a multiple of threads")
    t0 = time.perf_counter()
    conf = default_config()
    if conf["ec_backend"] != "torch":
        raise AssertionError(f"osd: the default ec_backend is "
                             f"{conf['ec_backend']}, not torch")
    conf.apply_dict(OSD_CONFIG)
    raw = rng.bytes(n * size)
    payloads = [raw[i * size:(i + 1) * size] for i in range(n)]
    del raw
    names = [f"obj{i:04d}" for i in range(n)]
    gib = n * size / 1e9
    ec_kernels.reset_launches()
    cluster = vstart.MiniCluster(n_osds=cfg["osds"], cfg=conf).start()
    osds = list(cluster.osds.values())
    try:
        admin = cluster.client()
        admin.create_pool(OSD_POOL, kind="ec", pg_num=cfg["pg_num"],
                          ec_profile=osd_profile(dev, **cfg))
        pool_id = admin._pool_id(OSD_POOL)
        clients = [cluster.client() for _ in range(threads)]
        res: dict = {"objects": n, "object_size": size}
        written: list[int] = []

        def write(i):
            clients[i // per].write_full(OSD_POOL, names[i], payloads[i])
            written.append(i)

        def read(i):
            got = clients[i // per].read(OSD_POOL, names[i])
            if got != payloads[i]:
                raise AssertionError(f"osd: {names[i]} read back wrong")

        # writes
        flushes: list = []
        before = osd_counters(cluster)
        with osd_flushes(cluster, flushes):
            res["write_s"] = _each_thread(threads, per, write)
        res["write"] = counter_delta(osd_counters(cluster), before)
        res["write_folds"] = fold_summary(flushes)
        osd_codecs_on(cluster, dev)
        # two reads of every object; the second in the reverse order of
        # the writes' completion, one object a thread at a time, so each
        # primary's most recent write (its extent cache) is read again
        # before a second-hit admission replaces it
        before = osd_counters(cluster)
        res["read1_s"] = _each_thread(threads, per, read)
        res["read1"] = counter_delta(osd_counters(cluster), before)
        order = written[::-1]
        before = osd_counters(cluster)
        res["read2_s"] = _threads(threads, lambda t: [
            read(order[j]) for j in range(t, n, threads)])
        res["read2"] = counter_delta(osd_counters(cluster), before)
        # deep scrub of the first object's PG
        seed = cluster.mon.osdmap.object_to_pg(pool_id, names[0])
        before = osd_counters(cluster)
        res["scrub"] = osd_scrub_pg(cluster, pool_id, seed)
        res["scrub_counts"] = counter_delta(osd_counters(cluster), before)
        # two OSDs of that PG lost (shards 0 and 1) and marked down: the
        # placement re-draws their positions onto spares, whose shards
        # recovery rebuilds while every object is read degraded
        omap = cluster.mon.osdmap
        victims = omap.pg_to_up_osds(pool_id, seed)[:cfg["lost"]]
        lost = [(name, shard) for name in names for shard, osd in
                enumerate(omap.pg_to_up_osds(
                    pool_id, omap.object_to_pg(pool_id, name)))
                if osd in victims]
        epoch = omap.epoch
        t1 = time.perf_counter()
        for v in victims:
            cluster.kill_osd(v)
        cluster.wait_for_epoch(epoch + len(victims), timeout=cfg["wait_s"])
        for c in [admin, *clients]:
            _wait_until("a client's map", lambda: c.osdmap.epoch >=
                        epoch + len(victims), cfg["wait_s"])
        # every OSD holds the new map and every PG has peered on it (its
        # primary heard from each member) before the reads, as a client
        # that waits out `pg peering` would; recovery goes on beside them
        _wait_until("the OSDs' maps", lambda: all(
            o.osdmap.epoch >= epoch + len(victims)
            for o in list(cluster.osds.values())), cfg["wait_s"])
        osd_peered(cluster, cfg["wait_s"])
        res["peering_s"] = time.perf_counter() - t1
        flushes = []
        before = osd_counters(cluster)
        with osd_flushes(cluster, flushes):
            res["degraded_s"] = _each_thread(threads, per, read)
            _wait_until("recovery onto the spares", lambda: osd_rebuilt(
                cluster, pool_id, lost), cfg["wait_s"])
            res["recovery_s"] = time.perf_counter() - t1
        res["degraded"] = counter_delta(osd_counters(cluster), before)
        res["degraded_folds"] = fold_summary(flushes)
        res["lost_shards"] = len(lost)
        sample = names[::max(1, n // cfg["sample"])][:cfg["sample"]]
        for name in sample:
            read(names.index(name))
        res["codecs"] = osd_codecs_on(cluster, dev)
        res["victims"] = victims
        res["faults"] = osd_faults(osds)
    finally:
        cluster.stop()
    counts = ec_kernels.launch_counts()
    res["phase_s"] = time.perf_counter() - t0
    say("osd", osd_line(res, gib, dev))
    return counts, res


def _wait_until(what: str, done, wait_s: float) -> None:
    deadline = time.monotonic() + wait_s
    while not done():
        if time.monotonic() > deadline:
            raise AssertionError(f"osd: {what} not within {wait_s} s")
        time.sleep(0.02)


def osd_line(res: dict, gib: float, dev: torch.device) -> str:
    """The [osd] line: GB/s of each pass over the data, recovery
    seconds, the batched launches, each kernel's launches, the copies
    back per flush and the arena's hits."""
    w, folds = res["write"], res["write_folds"].get("encode", [0, 0, 0])
    region = {c: w[c] for c in ("gf_bitterm", "gf_bitxor", "gf_bitmm")}
    return (f"write {gib / res['write_s']:.4f} GB/s ({res['write_s']:.3f} s),"
            f" read {gib / res['read1_s']:.4f} GB/s ({res['read1_s']:.3f} s)"
            f" then {gib / res['read2_s']:.4f} GB/s ({res['read2_s']:.3f} s;"
            f" {res['read2']['cache_served']} served from the arena, "
            f"{res['read2']['ec_arena_hits']} arena hits), degraded read "
            f"{gib / res['degraded_s']:.4f} GB/s ({res['degraded_s']:.3f} s)"
            f" with OSDs {res['victims']} lost (peered in "
            f"{res['peering_s']:.3f} s), recovery of "
            f"{res['lost_shards']} shards {res['recovery_s']:.3f} s "
            f"({res['faults']['op_timeouts']} ops timed out, "
            f"{res['faults']['dropped']} messages dropped); "
            f"writes: {folds[0]} encode flushes of {folds[1]} ops "
            f"({folds[1] / max(folds[0], 1):.2f} ops a launch, at most "
            f"{folds[2]}), {w['fused']} fused encode+CRC, launches "
            f"{json.dumps(region)} crc32c_chunks {w['crc32c_chunks']}, "
            f"{w['ec_stage_d2h_copies'] / max(folds[0], 1):.2f} copies "
            f"back a flush; degraded and recovery: "
            f"{json.dumps(res['degraded_folds'])}; scrub "
            f"{json.dumps(res['scrub'])}; {res['codecs']} codecs; "
            f"{card(dev)}; phase "
            f"{res['phase_s']:.1f} s")


def check_osd(counts: dict[str, int], res: dict) -> None:
    """Phase 17 launched a region kernel and G1 and never a plain
    version; the writes took the fused op, the second read found the
    arena, the scrub verified the PG's shards clean through the batcher
    and the degraded reads decoded in folds; no op waited out the op
    timeout and no OSD dropped a message."""
    say("launches", f"osd: {json.dumps(counts)}")
    region = [KERNELS[r][1] for r in KERNELS]
    if not any(counts[c] > 0 for c in region):
        raise AssertionError(f"no region kernel ({', '.join(region)}) "
                             "launched on the osd phase")
    if not counts[CRC_KERNEL[1]]:
        raise AssertionError("G1 never launched on the osd phase")
    if counts["plain"]:
        raise AssertionError(f"a plain version ran {counts['plain']} "
                             "times on the osd phase")
    if not res["write"]["fused"]:
        raise AssertionError("osd: no write took the fused encode+CRC op")
    if not (res["read2"]["ec_arena_hits"] and
            res["read2"]["cache_served"]):
        raise AssertionError(f"osd: the second reads never found the "
                             f"arena: {res['read2']}")
    scrub = res["scrub"]
    if not (scrub["objects"] and scrub["launches"]) or scrub["mismatches"]:
        raise AssertionError(f"osd: scrub {scrub}")
    if not res["scrub_counts"][CRC_KERNEL[1]]:
        raise AssertionError("osd: the scrub did not launch G1")
    if not (res["degraded_folds"].get("decode")
            and any(res["degraded"][c] for c in region)):
        raise AssertionError(f"osd: no degraded read decoded on a region "
                             f"kernel: {res['degraded_folds']}")
    if res["faults"]["op_timeouts"] or res["faults"]["dropped"]:
        raise AssertionError(f"osd: {res['faults']['op_timeouts']} ops "
                             f"timed out, {res['faults']['dropped']} "
                             "messages dropped")


#: phase 18: tools/bench_root's kernel modes, run in this process at the
#: reference's defaults; each with the launch counters that must move
BENCH_ROOT_REGION = tuple(KERNELS[r][1] for r in ("pallas", "bitxor", "mxu"))
BENCH_ROOT_KERNEL_MODES = (
    ("scrub", ["--scrub"], (CRC_KERNEL[1],)),
    ("ec-batch", ["--ec-batch", "--no-overhead"], BENCH_ROOT_REGION),
    ("ec-recovery", ["--ec-recovery", "--progress"], BENCH_ROOT_REGION))
#: the cluster modes (native clusters, no kernel), each a child with a
#: timeout in seconds
BENCH_ROOT_CLUSTER_MODES = (
    ("ec-read", ["--ec-read"], 180),
    ("read-storm", ["--read-storm"], 180),
    ("saturate", ["--saturate", "--smoke"], 180))
#: the sweep row phase 18 runs through tools/bench_sweep
BENCH_ROOT_SWEEP_ROW = "scrub_throughput"


def bench_root_row(out: str) -> dict:
    """The JSON row a bench_root mode printed last."""
    return json.loads(out.strip().splitlines()[-1])


def check_bench_root(mode: str, row: dict, counts: dict[str, int],
                     need=(), picks=None) -> None:
    """A kernel mode of phase 18: its row verified (``digest_verified``
    or ``ok``), every counter in ``need`` moved, no plain version ran,
    no kernel pick named ``xla`` (the row's ``ec_kernel_picks`` and
    ``picks``, signature -> kernel, booked during the mode), and where
    the row has the plane leg, one copy back a flush."""
    if not (row.get("digest_verified") is True or row.get("ok") is True):
        raise AssertionError(f"bench_root {mode}: row not verified: "
                             f"{json.dumps(row)[:2000]}")
    for ctr in need:
        if counts.get(ctr, 0) <= 0:
            raise AssertionError(f"bench_root {mode}: {ctr} never launched")
    if counts.get("plain"):
        raise AssertionError(f"bench_root {mode}: a plain version ran "
                             f"{counts['plain']} times")
    xla = {s: k for s, k in {**row.get("ec_kernel_picks", {}),
                             **(picks or {})}.items() if k == "xla"}
    if xla:
        raise AssertionError(f"bench_root {mode}: xla picks {xla}")
    if "d2h_copies_per_flush" in row and row["d2h_copies_per_flush"] != 1.0:
        raise AssertionError(f"bench_root {mode}: "
                             f"{row['d2h_copies_per_flush']} copies back a "
                             "flush, want 1.0")


def check_bench_root_exit(mode: str, rc: int, row: dict) -> None:
    """A mode of phase 18 must exit 0, whichever of its gates failed."""
    if rc != 0:
        raise AssertionError(f"bench_root {mode} exit {rc}: "
                             f"{json.dumps(row)[:2000]}")


def bench_root_line(mode: str, row: dict, wall_s: float, where: str
                    ) -> str:
    """The [bench_root] line of one mode: its headline numbers."""
    keys = {"ec-batch": ("value", "vs_baseline", "ops_per_launch",
                         "per_op_gbps", "e2e_gbps", "kernel_gbps",
                         "e2e_device_share", "ec_kernel_candidates_gbps",
                         "ec_kernel_race_winner",
                         "d2h_copies_per_flush", "wire_gbps",
                         "store_fsyncs_per_txn", "kv_maint_p99_ratio"),
            "ec-recovery": ("value", "vs_baseline", "max_bytes_sweet_spot",
                            "wide_repair_bytes_per_lost_byte",
                            "wide_degraded_p99_ms"),
            "scrub": ("value", "vs_baseline", "fold_backend", "objects",
                      "folded_s", "loop_s"),
            "ec-read": ("value", "vs_baseline", "decode_launches_per_op"),
            "read-storm": ("value", "vs_baseline", "spread",
                           "lease_hit_rate")}.get(
                mode, ("value", "vs_baseline", "saturation_knee_per_s",
                       "client_read_p99_ms", "client_write_p99_ms",
                       "recovery_wall_s"))
    return (f"{mode} {row.get('unit', '')}: "
            + json.dumps({k: row.get(k) for k in keys})
            + f"; {wall_s:.1f} s; {where}")


def phase_bench_root(dev: torch.device) -> dict[str, tuple]:
    """Phase 18: the kernel modes in this process, each with its own
    launch counts, then the cluster modes as children and the sweep row;
    returns mode -> (row, counts or None)."""
    where = card(dev)
    out: dict[str, tuple] = {}
    for mode, argv, need in BENCH_ROOT_KERNEL_MODES:
        t0, since = time.perf_counter(), time.time()
        ec_kernels.reset_launches()
        err, text = io.StringIO(), io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(text):
            rc = bench_root.main(argv + ["--device", dev.type])
        counts = ec_kernels.launch_counts()
        try:
            row = bench_root_row(text.getvalue())
            check_bench_root_exit(mode, rc, row)
            check_bench_root(mode, row, counts, need, {
                s: p["picked"] for s, p in picks_since(since).items()})
        except Exception:
            print(err.getvalue()[-4000:], file=sys.stderr)
            raise
        say("bench_root", bench_root_line(
            mode, row, time.perf_counter() - t0, where)
            + f"; launches {json.dumps(counts)}")
        out[mode] = (row, counts)
    for mode, argv, timeout in BENCH_ROOT_CLUSTER_MODES:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.bench_root", *argv,
             "--device", dev.type], capture_output=True, text=True,
            timeout=timeout, cwd=REPO)
        try:
            row = bench_root_row(proc.stdout)
            check_bench_root_exit(mode, proc.returncode, row)
        except Exception:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise
        say("bench_root", bench_root_line(
            mode, row, time.perf_counter() - t0, where))
        out[mode] = (row, None)
    t0 = time.perf_counter()
    run_quiet("bench_sweep", bench_sweep.main,
              ["--only", BENCH_ROOT_SWEEP_ROW, "--device", dev.type,
               "--retries", "0"])
    with open(bench_sweep.STATE[dev.type]) as f:
        entry = json.load(f)[BENCH_ROOT_SWEEP_ROW]
    res = entry.get("result", {})
    if res.get("ok") is not True or res.get("fold_backend") != "torch":
        raise AssertionError(f"bench_sweep {BENCH_ROOT_SWEEP_ROW}: {entry}")
    say("bench_root", f"bench_sweep --only {BENCH_ROOT_SWEEP_ROW}: "
                      + json.dumps(res) + f"; {time.perf_counter() - t0:.1f}"
                      f" s with the child's start; {where}")
    out["sweep"] = (res, None)
    return out


def mesh_clock(dev: torch.device, times: dict):
    """clock(name) for parallel.dryrun.mesh_leg: CUDA events on the
    card's current stream around a step (whose device streams fork from
    it and join back), waited for; ms into ``times``.  The host clock on
    the CPU."""
    @contextlib.contextmanager
    def clock(name):
        if dev.type != "cuda":
            t0 = time.perf_counter()
            yield
            times[name] = (time.perf_counter() - t0) * 1e3
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record(torch.cuda.current_stream(dev))
        yield
        end.record(torch.cuda.current_stream(dev))
        end.synchronize()
        times[name] = start.elapsed_time(end)
    return clock


def mesh_tool(dev: torch.device, size: int, rng: np.random.Generator
              ) -> dict:
    """tools.ec_tool on a tpu k=8 m=3 profile (on the card: the plugin's
    default; ``device=cpu`` otherwise): encode a file of ``size`` seeded
    bytes, remove chunks 1, 4 and 9, decode, and compare."""
    import tempfile

    from ceph_tpu_torch.tools import ec_tool

    payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    prof = "plugin=tpu,technique=reed_sol_van,k=8,m=3" + (
        "" if dev.type == "cuda" else ",device=cpu")
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "in.bin"), os.path.join(tmp, "out.bin")
        chunks = os.path.join(tmp, "chunks")
        with open(src, "wb") as f:
            f.write(payload)
        t0 = time.perf_counter()
        run_quiet("ec_tool encode", ec_tool.main,
                  ["encode", prof, src, chunks])
        for cid in (1, 4, 9):
            os.remove(os.path.join(chunks, f"chunk.{cid}"))
        run_quiet("ec_tool decode", ec_tool.main,
                  ["decode", prof, chunks, out])
        wall = time.perf_counter() - t0
        with open(out, "rb") as f:
            if f.read() != payload:
                raise AssertionError("ec_tool: the decoded file differs")
    return {"bytes": size, "wall_s": wall}


def phase_mesh(dev: torch.device, rng: np.random.Generator, *,
               devices: int, B: int, chunk: int, writers: int,
               batch_chunk: int, proc_devices: int, tool_bytes: int
               ) -> tuple[dict, dict]:
    """Phase 19: the mesh path on logical devices of the card (module
    docstring).  Returns (launch counts of this process, results)."""
    from ceph_tpu_torch.models.stripe_codec import StripeCodec
    from ceph_tpu_torch.parallel import dryrun
    from ceph_tpu_torch.parallel import mesh as pmesh
    from ceph_tpu_torch.parallel.distributed import DistributedStripeEC

    t0 = time.perf_counter()
    k = 8
    data = rng.integers(0, 256, (B, k, chunk), dtype=np.uint8)
    delta = rng.integers(0, 256, (B, k, chunk), dtype=np.uint8)
    hdata = rng.integers(0, 256, (4, k, chunk), dtype=np.uint8)
    hdelta = rng.integers(0, 256, (4, k, chunk), dtype=np.uint8)
    pays = [rng.integers(0, 256, (k, batch_chunk), dtype=np.uint8)
            for _ in range(writers)]
    res: dict = {"times": {}}
    pmesh.force_devices(dev.type, devices)
    try:
        devs = pmesh.devices(dev.type)
        mesh = pmesh.make_mesh(devices, devices=devs)
        res["mesh"] = mesh.shape
        codec = StripeCodec(k=k, m=3)
        dec = DistributedStripeEC(codec, mesh)
        ec_kernels.reset_launches()
        # every step once untimed at the timed shapes: each device's
        # first launch of a matrix builds its tables, and the first pass
        # pays the allocations of every device's stream
        dryrun.mesh_leg(dec, data, delta, cols=oracle_columns(chunk,
                                                              windows=4))
        res["main"] = dryrun.mesh_leg(
            dec, data, delta, cols=oracle_columns(chunk, windows=16),
            clock=mesh_clock(dev, res["times"]))
        res["host"] = dryrun.host_mesh_leg(codec, devs, 2, hdata, hdelta)
        res["batcher"] = dryrun.batcher_leg(devices, dev.type, pays)
        res["batcher_csums"] = dryrun.batcher_leg(devices, dev.type, pays,
                                                  with_csums=True)
        res["tool"] = mesh_tool(dev, tool_bytes, rng)
        counts = ec_kernels.launch_counts()
        res["device_launches"] = ec_kernels.device_launch_counts()
        res["device_ids"] = [d.id for d in devs]
    finally:
        pmesh.force_devices(dev.type, None)
    t1 = time.perf_counter()
    res["processes"] = dryrun.process_leg(dev.type, proc_devices)
    res["processes_s"] = time.perf_counter() - t1
    res["phase_s"] = time.perf_counter() - t0
    return counts, res


def mesh_line(res: dict, dev: torch.device) -> str:
    """The [mesh] line: each step's CUDA-event ms and GB/s (bytes: the
    step's data in, or the stack for the ones that read it)."""
    main = res["main"]
    B, L, S = main["B"], main["L"], main["S"]
    moved = {"write": B * 8 * L, "rebalance": 2 * B * S * L,
             "recovery": B * 8 * L, "delta": B * 8 * L,
             "stats": B * S * L}
    steps = ", ".join(
        f"{name} {ms:.3f} ms ({moved[name] / ms / 1e6:.2f} GB/s)"
        for name, ms in res["times"].items())
    return (f"mesh {res['mesh']} of logical devices on {dev}, B={B} "
            f"stripes of 8 x {L} bytes: {steps}; digest "
            f"{main['digest']}; host mesh {res['host']['mesh']} digest "
            f"{res['host']['digest']}; batcher plain "
            f"{json.dumps(res['batcher'])}, checksummed "
            f"{json.dumps(res['batcher_csums'])}; ec_tool "
            f"{res['tool']['bytes'] >> 20} MiB round trip "
            f"{res['tool']['wall_s']:.3f} s; two processes "
            f"{res['processes'][0]['mesh']} digest "
            f"{res['processes'][0]['digest']} "
            f"({res['processes_s']:.1f} s with their start); {card(dev)}; "
            f"phase {res['phase_s']:.1f} s")


def check_mesh(counts: dict[str, int], res: dict) -> None:
    """Phase 19 launched K1, K2, G4 and G1 and never a plain version;
    every logical device of this process and of each child launched a
    region kernel on its slice and no plain version."""
    say("launches", f"mesh: {json.dumps(counts)}")
    region = [KERNELS[r][1] for r in KERNELS]
    for ctr in region + [CRC_KERNEL[1]]:
        if not counts[ctr]:
            raise AssertionError(f"mesh: {ctr} never launched")
    if counts["plain"]:
        raise AssertionError(f"mesh: a plain version ran {counts['plain']} "
                             "times")
    per_dev = res["device_launches"]
    by_dev = {d: {c: per_dev.get((d, c), 0) for c in region + ["plain"]}
              for d in res["device_ids"]}
    say("launches", "mesh by logical device: " + json.dumps(
        {str(d): c for d, c in by_dev.items()}))
    for d, c in by_dev.items():
        if c["plain"] or not any(c[r] for r in region):
            raise AssertionError(f"mesh: logical device {d}: {c}")
    for r in res["processes"]:
        say("launches", f"mesh: process {r['process_id']}: "
                        f"{json.dumps(r['launches'])}, by logical device "
                        f"{json.dumps(r['device_launches'])}")
        if r["launches"]["plain"] or r["foreign_modules"]:
            raise AssertionError(f"mesh: process {r['process_id']}: {r}")
        ids = {key.split("/")[0] for key in r["device_launches"]}
        if len(ids) != r["devices_local"] or not all(
                any(r["device_launches"].get(f"{d}/{c}", 0)
                    for c in region) for d in ids):
            raise AssertionError(f"mesh: process {r['process_id']}: a "
                                 "logical device launched no region "
                                 f"kernel: {r['device_launches']}")


#: phase 20 (b): an RBD image on phase 17's cluster and pool (OSD_PHASE,
#: OSD_CONFIG): ``image`` bytes in rbd's default 4 MiB objects, written
#: by ``threads`` threads through the Image API in object-aligned
#: extents; ``gateway`` bytes again through NbdClient and through
#: NvmeInitiator at ``request`` bytes a request; ``overwrites`` random
#: 4 KiB overwrites, a snapshot, ``snap_overwrites`` more; ``lost`` OSDs
#: of the image's PGs killed; the head read back degraded through the
#: Image API while recovery runs, ``gateway`` bytes of it through NBD,
#: and the snapshot.  ``wait_s`` bounds each wait.  Every object of an
#: image places in one PG, whose primary does all of the leg's host
#: work; the leg takes 83-91 s at 512 MiB on the card (the 4 KiB
#: overwrites 42-46 s of it).
SERVICES = dict(osds=14, pg_num=64, k=8, m=3, image=512 << 20,
                object_size=OBJECT_SIZE, threads=8, gateway=64 << 20,
                request=1 << 20, overwrites=2048, snap_overwrites=256,
                lost=2, wait_s=240.0)
SERVICES_POOL = "rbdpool"
#: the OSD write routes phase 20 counts, by the method that takes each
WRITE_ROUTES = ("_ec_write", "_ec_partial_write", "_ec_rmw_rows")


@contextlib.contextmanager
def osd_write_routes(cluster, routes: dict):
    """Within the block, every EC write an OSD takes is counted in
    ``routes`` by the route its primary picks: ``full_stripe`` (a whole
    object or whole rows, encoded), ``parity_delta`` (a sub-row write
    whose parity is patched by the delta) or ``row_rmw`` (rows read,
    modified and encoded again, also where the delta path fell back)."""
    from ceph_tpu_torch.osd import daemon

    lock = threading.Lock()
    seen = dict.fromkeys(("writes", "delta", "rmw", "rmw_fallback"), 0)

    def wrap(osd, name):
        real = getattr(osd, name)

        def counted(conn, *args, **kw):
            key = {"_ec_write": "writes", "_ec_partial_write": "delta",
                   "_ec_rmw_rows": "rmw"}[name]
            if name == "_ec_rmw_rows" and isinstance(conn,
                                                     daemon._ClientConn):
                key = "rmw_fallback"
            with lock:
                seen[key] += 1
            return real(conn, *args, **kw)
        setattr(osd, name, counted)

    osds = list(cluster.osds.values())
    for osd in osds:
        for name in WRITE_ROUTES:
            wrap(osd, name)
    try:
        yield
    finally:
        for osd in osds:
            for name in WRITE_ROUTES:
                delattr(osd, name)
        routes.update(
            full_stripe=seen["writes"] - seen["delta"] - seen["rmw"],
            parity_delta=seen["delta"] - seen["rmw_fallback"],
            row_rmw=seen["rmw"] + seen["rmw_fallback"])


SCORECARD_LINE = re.compile(r"^  (.+?)\s+(PASS|FAIL)  (.*)$", re.M)


def phase_scorecard(dev: torch.device) -> tuple[dict[str, int], dict]:
    """Phase 20 (a): the port's tools.smoke scorecard, all of it, in this
    process on ``dev``, with the launch counts set to 0 before and read
    after.  Returns the counts and {"rc", "checks": [(name, mark,
    detail)], "wall_s"}."""
    from ceph_tpu_torch.tools import smoke

    t0 = time.perf_counter()
    ec_kernels.reset_launches()
    err, text = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(text):
        rc = smoke.main(["--device", dev.type])
    counts = ec_kernels.launch_counts()
    res = {"rc": rc, "checks": SCORECARD_LINE.findall(text.getvalue()),
           "wall_s": time.perf_counter() - t0}
    if rc != 0:
        print(text.getvalue()[-4000:], err.getvalue()[-4000:],
              file=sys.stderr)
    say("services", f"scorecard: rc {rc}, {len(res['checks'])} checks, "
                    + ", ".join(f"{n} {m} {d}" for n, m, d in res["checks"])
                    + f"; {res['wall_s']:.1f} s; launches "
                    + json.dumps(counts))
    return counts, res


def check_scorecard(counts: dict[str, int], res: dict) -> None:
    """Phase 20 (a) passed all fifteen checks of the scorecard, launched
    a region kernel and G1, and never a plain version."""
    failed = [n for n, mark, _d in res["checks"] if mark != "PASS"]
    if res["rc"] != 0 or len(res["checks"]) != 15 or failed:
        raise AssertionError(f"services: the scorecard exited {res['rc']} "
                             f"with {len(res['checks'])} checks, failed "
                             f"{failed}")
    region = [KERNELS[r][1] for r in KERNELS]
    if not any(counts[c] for c in region):
        raise AssertionError("services: no region kernel launched on the "
                             "scorecard")
    if not counts[CRC_KERNEL[1]]:
        raise AssertionError("services: G1 never launched on the "
                             "scorecard")
    if counts["plain"]:
        raise AssertionError(f"services: a plain version ran "
                             f"{counts['plain']} times on the scorecard")


def _blocks_differ(got: bytes, image, at: int, before: set, after: set
                   ) -> str:
    """Which 4 KiB blocks of ``got`` (read at ``at``) differ from the
    host copy, and how many of them the overwrites before and after the
    snapshot wrote."""
    bad = [at + j for j in range(0, len(got), 4096)
           if got[j:j + 4096] != image[at + j:at + j + 4096]]
    return (f"{len(bad)} blocks of 4 KiB differ, first at {bad[:4]}; "
            f"{len(set(bad) & before)} overwritten before the snapshot, "
            f"{len(set(bad) & after)} after")


def _extents(rng: np.random.Generator, n: int, size: int, length: int,
             ) -> list[int]:
    """``n`` distinct ``length``-aligned offsets below ``size``."""
    return (rng.choice(size // length, n, replace=False) * length).tolist()


def phase_services_rbd(dev: torch.device, rng: np.random.Generator,
                       **over) -> tuple[dict[str, int], dict]:
    """Phase 20 (b): an RBD image on phase 17's cluster and tpu k=8 m=3
    pool (SERVICES), with the launch counts set to 0 before and read
    after; every read byte-exact against a host copy of the image.
    Returns the counts and the leg's numbers."""
    from ceph_tpu_torch.services.nbd import NbdClient, NbdServer
    from ceph_tpu_torch.services.nvmeof import (LBA_SIZE, NvmeInitiator,
                                                NvmeofTarget)
    from ceph_tpu_torch.services.rbd import RBD

    cfg = dict(SERVICES, **over)
    size, obj, threads = cfg["image"], cfg["object_size"], cfg["threads"]
    gw, req = cfg["gateway"], cfg["request"]
    objects = size // obj
    per = objects // threads
    if per * threads != objects or gw % req or size < 3 * gw:
        raise ValueError("the image must be whole objects a thread and "
                         "hold three gateway ranges")
    t0 = time.perf_counter()
    conf = default_config()
    conf.apply_dict(OSD_CONFIG)
    image = bytearray(rng.bytes(size))
    nbd_at, nvme_at = size - 2 * gw, size - gw
    nbd_data, nvme_data = rng.bytes(gw), rng.bytes(gw)
    small = _extents(rng, cfg["overwrites"] + cfg["snap_overwrites"],
                     size, 4096)
    small_data = rng.bytes(4096 * len(small))
    ec_kernels.reset_launches()
    cluster = vstart.MiniCluster(n_osds=cfg["osds"], cfg=conf).start()
    osds = list(cluster.osds.values())
    res: dict = {"image": size, "gateway": gw}
    srv = target = None
    try:
        admin = cluster.client()
        admin.create_pool(SERVICES_POOL, kind="ec", pg_num=cfg["pg_num"],
                          ec_profile=osd_profile(dev, **cfg))
        pool_id = admin._pool_id(SERVICES_POOL)
        client = cluster.client()
        img = RBD(client).create(SERVICES_POOL, "vm", size,
                                 object_size=obj)
        routes: dict = {}
        flushes: list = []
        before = osd_counters(cluster)
        with osd_write_routes(cluster, routes), \
                osd_flushes(cluster, flushes):
            # first writes: whole objects, 8 threads on one handle (the
            # first object alone, which takes the image's lock)
            def write(i):
                img.write(i * obj, bytes(image[i * obj:(i + 1) * obj]))
            t1 = time.perf_counter()
            write(0)
            res["image_write_s"] = time.perf_counter() - t1 + _threads(
                threads, lambda t: [write(i) for i in range(
                    max(1, t * per), (t + 1) * per)])
            # a range through NBD, one through NVMe/TCP, 1 MiB a request
            srv = NbdServer(cluster.client(), SERVICES_POOL)
            nbd = NbdClient(srv.port)
            nbd.go("vm")
            t1 = time.perf_counter()
            for off in range(0, gw, req):
                if nbd.write(nbd_at + off, nbd_data[off:off + req]):
                    raise AssertionError("services: an NBD write failed")
            if nbd.flush():
                raise AssertionError("services: the NBD flush failed")
            res["nbd_write_s"] = time.perf_counter() - t1
            image[nbd_at:nbd_at + gw] = nbd_data
            target = NvmeofTarget(cluster.client(), SERVICES_POOL)
            nsid = target.add_namespace("vm")
            ini = NvmeInitiator("127.0.0.1", target.port)
            t1 = time.perf_counter()
            for off in range(0, gw, req):
                ini.write(nsid, (nvme_at + off) // LBA_SIZE,
                          nvme_data[off:off + req])
            ini.flush(nsid)
            res["nvme_write_s"] = time.perf_counter() - t1
            image[nvme_at:nvme_at + gw] = nvme_data
            # 4 KiB overwrites from 8 threads at distinct offsets (the
            # first alone, which takes the lock back from the gateway)
            n = cfg["overwrites"]

            def overwrite(i):
                off = small[i]
                img.write(off, small_data[4096 * i:4096 * (i + 1)])
            t1 = time.perf_counter()
            overwrite(0)
            res["overwrite_s"] = time.perf_counter() - t1 + _threads(
                threads, lambda t: [overwrite(i) for i in range(
                    max(1, t * n // threads), (t + 1) * n // threads)])
            for i in range(n):
                image[small[i]:small[i] + 4096] = \
                    small_data[4096 * i:4096 * (i + 1)]
            # a snapshot, then more overwrites (each first touch of an
            # object copies it up to the snapshot: one thread)
            img.snap_create("s1")
            snap = bytes(image)
            t1 = time.perf_counter()
            for i in range(n, len(small)):
                overwrite(i)
                image[small[i]:small[i] + 4096] = \
                    small_data[4096 * i:4096 * (i + 1)]
            res["snap_overwrite_s"] = time.perf_counter() - t1
        res["write_faults"] = osd_faults(osds)
        say("services", "writes: " + ", ".join(
            f"{k} {res[k]:.3f} s" for k in (
                "image_write_s", "nbd_write_s", "nvme_write_s",
                "overwrite_s", "snap_overwrite_s")) + f"; routes {routes}; "
            f"faults {res['write_faults']}")
        res["write"] = counter_delta(osd_counters(cluster), before)
        res["write_folds"] = fold_summary(flushes)
        res["routes"] = routes
        osd_codecs_on(cluster, dev)
        # two OSDs of the first object's PG lost and marked down; the
        # head read back degraded while recovery rebuilds, a range
        # through NBD, then the snapshot
        omap = cluster.mon.osdmap
        seed = omap.object_to_pg(pool_id, "rbd_data.vm.0000000000000000")
        victims = omap.pg_to_up_osds(pool_id, seed)[:cfg["lost"]]
        lost = [(name, shard) for name in admin.list_objects(SERVICES_POOL)
                for shard, osd in enumerate(omap.pg_to_up_osds(
                    pool_id, omap.object_to_pg(pool_id, name)))
                if osd in victims]
        epoch = omap.epoch
        t1 = time.perf_counter()
        for v in victims:
            cluster.kill_osd(v)
        cluster.wait_for_epoch(epoch + len(victims), timeout=cfg["wait_s"])
        for c in [admin, client, srv.client, target.client]:
            _wait_until("a client's map", lambda c=c: c.osdmap.epoch >=
                        epoch + len(victims), cfg["wait_s"])
        _wait_until("the OSDs' maps", lambda: all(
            o.osdmap.epoch >= epoch + len(victims)
            for o in list(cluster.osds.values())), cfg["wait_s"])
        osd_peered(cluster, cfg["wait_s"])
        res["peering_s"] = time.perf_counter() - t1
        say("services", f"OSDs {victims} lost, {len(lost)} shards to "
                        f"rebuild; peered in {res['peering_s']:.3f} s; "
                        f"faults {osd_faults(osds)}")
        flushes = []
        before = osd_counters(cluster)
        with osd_flushes(cluster, flushes):
            wrong: dict = {}

            def read(i):
                got = img.read(i * obj, obj)
                if got != image[i * obj:(i + 1) * obj]:
                    wrong[i] = _blocks_differ(got, image, i * obj,
                                              set(small[:n]),
                                              set(small[n:]))
            res["degraded_s"] = _each_thread(threads, per, read)
            say("services", f"degraded reads {res['degraded_s']:.3f} s; "
                            f"faults {osd_faults(osds)}")
            t2 = time.perf_counter()
            at = size // 2
            for off in range(0, gw, req):
                if nbd.read(at + off, req) != image[at + off:
                                                    at + off + req]:
                    raise AssertionError("services: an NBD read of the "
                                         "degraded image differs")
            res["nbd_read_s"] = time.perf_counter() - t2
            t2 = time.perf_counter()
            res["snap_ok"] = all(
                img.read(i * obj, obj, snap="s1") == snap[i * obj:
                                                          (i + 1) * obj]
                for i in range(objects))
            res["snap_read_s"] = time.perf_counter() - t2
            if not res["snap_ok"]:
                raise AssertionError("services: the snapshot read back "
                                     "wrong")
            _wait_until("recovery onto the spares", lambda: osd_rebuilt(
                cluster, pool_id, lost), cfg["wait_s"])
            res["recovery_s"] = time.perf_counter() - t1
        if wrong:
            healed = [i for i in sorted(wrong) if img.read(i * obj, obj)
                      == image[i * obj:(i + 1) * obj]]
            raise AssertionError(
                f"services: {len(wrong)} objects of the head read back "
                f"wrong while recovery ran ({len(healed)} of them right "
                "after it): " + "; ".join(
                    f"object {i}: {why}" for i, why in
                    sorted(wrong.items())[:4]))
        res["degraded"] = counter_delta(osd_counters(cluster), before)
        res["degraded_folds"] = fold_summary(flushes)
        res["lost_shards"] = len(lost)
        res["victims"] = victims
        res["codecs"] = osd_codecs_on(cluster, dev)
        res["faults"] = osd_faults(osds)
        nbd.close()
        ini.close()
        img.close()
    finally:
        for gateway in (srv, target):
            if gateway is not None:
                gateway.stop()
        cluster.stop()
    counts = ec_kernels.launch_counts()
    res["leg_s"] = time.perf_counter() - t0
    return counts, res


def services_line(res: dict, dev: torch.device) -> str:
    """The [services] line: GB/s of each write route and of the degraded
    read, 4 KiB overwrites a second, recovery seconds, the writes of
    each OSD route, each kernel's launches, copies back a flush, timed
    out ops and dropped messages."""
    size, gw = res["image"], res["gateway"]
    w, folds = res["write"], res["write_folds"].get("encode", [0, 0, 0])
    n_small = res["overwrites"]
    region = {c: w[c] for c in ("gf_bitterm", "gf_bitxor", "gf_bitmm")}
    dregion = {c: res["degraded"][c] for c in region}
    return (f"image {size >> 20} MiB in {size // res['object_size']} "
            f"objects: Image writes {size / res['image_write_s'] / 1e9:.4f}"
            f" GB/s ({res['image_write_s']:.3f} s), NBD writes "
            f"{gw / res['nbd_write_s'] / 1e9:.4f} GB/s "
            f"({res['nbd_write_s']:.3f} s), NVMe/TCP writes "
            f"{gw / res['nvme_write_s'] / 1e9:.4f} GB/s "
            f"({res['nvme_write_s']:.3f} s), 4 KiB overwrites "
            f"{n_small / res['overwrite_s']:.1f}/s ({n_small} in "
            f"{res['overwrite_s']:.3f} s; after the snapshot "
            f"{res['snap_overwrites'] / res['snap_overwrite_s']:.1f}/s); "
            f"OSD write routes {json.dumps(res['routes'])}; degraded "
            f"Image read {size / res['degraded_s'] / 1e9:.4f} GB/s "
            f"({res['degraded_s']:.3f} s) with OSDs {res['victims']} lost "
            f"(peered in {res['peering_s']:.3f} s), NBD read "
            f"{gw / res['nbd_read_s'] / 1e9:.4f} GB/s, snapshot read "
            f"{size / res['snap_read_s'] / 1e9:.4f} GB/s, recovery of "
            f"{res['lost_shards']} shards {res['recovery_s']:.3f} s "
            f"({res['faults']['op_timeouts']} ops timed out, "
            f"{res['faults']['dropped']} messages dropped); writes: "
            f"{folds[0]} encode flushes of {folds[1]} ops, "
            f"{w['fused']} fused encode+CRC, launches {json.dumps(region)}"
            f" crc32c_chunks {w['crc32c_chunks']}, "
            f"{w['ec_stage_d2h_copies'] / max(folds[0], 1):.2f} copies "
            f"back a flush; degraded reads and recovery: launches "
            f"{json.dumps(dregion)}, folds "
            f"{json.dumps(res['degraded_folds'])}; {res['codecs']} "
            f"codecs; {card(dev)}; leg {res['leg_s']:.1f} s")


def phase_services(dev: torch.device, rng: np.random.Generator,
                   **over) -> tuple[dict[str, int], dict]:
    """Phase 20, both legs, with the launch counts set to 0 before and
    read after; returns the phase's counts and {"scorecard": ...,
    "rbd": ...} (each leg's counts are in its result)."""
    t0 = time.perf_counter()
    sc_counts, sc = phase_scorecard(dev)
    sc["counts"] = sc_counts
    rbd_counts, rbd = phase_services_rbd(dev, rng, **over)
    cfg = dict(SERVICES, **over)
    rbd.update(object_size=cfg["object_size"],
               overwrites=cfg["overwrites"],
               snap_overwrites=cfg["snap_overwrites"], counts=rbd_counts)
    say("services", services_line(rbd, dev))
    counts = {c: sc_counts[c] + rbd_counts[c] for c in sc_counts}
    return counts, {"scorecard": sc, "rbd": rbd,
                    "phase_s": time.perf_counter() - t0}


def check_services(counts: dict[str, int], res: dict) -> None:
    """Phase 20: the scorecard passed with a region kernel and G1 and no
    plain version; the image leg's writes launched a region kernel and
    G1 (the fused writes), its degraded reads a region kernel, no plain
    version ran, every codec and arena is on the card, and no op timed
    out and no message was dropped."""
    say("launches", f"services: {json.dumps(counts)}")
    check_scorecard(res["scorecard"]["counts"], res["scorecard"])
    rbd = res["rbd"]
    region = [KERNELS[r][1] for r in KERNELS]
    if counts["plain"]:
        raise AssertionError(f"services: a plain version ran "
                             f"{counts['plain']} times")
    if not any(rbd["write"][c] for c in region):
        raise AssertionError("services: no region kernel launched in the "
                             "image's writes")
    if not (rbd["write"][CRC_KERNEL[1]] and rbd["write"]["fused"]):
        raise AssertionError("services: no G1 launch in the image's fused "
                             "writes")
    if not any(rbd["degraded"][c] for c in region):
        raise AssertionError("services: no region kernel launched in the "
                             "degraded reads")
    if rbd["faults"]["op_timeouts"] or rbd["faults"]["dropped"]:
        raise AssertionError(f"services: {rbd['faults']['op_timeouts']} "
                             f"ops timed out, {rbd['faults']['dropped']} "
                             "messages dropped")


def profile_totals() -> dict[str, list]:
    """kind -> [count, seconds] summed over the kernel profiler's
    signatures."""
    tot = {k: [0, 0.0] for k in ("compile", "device", "sync")}
    for agg in kernel_profiler().dump()["signatures"].values():
        for k, v in tot.items():
            v[0] += agg[k]
            v[1] += agg[f"{k}_seconds"]
    return tot


def profile_line(wall_s: float, before=None, what: str = "main path",
                 rest: str = "copies to the card, numpy") -> None:
    """Where a path's wall time went, from the codecs' kernel profiler
    (less the ``before`` totals): first launches (device tables, library
    load), launches (kernel + synchronize) and device->host copies."""
    tot = profile_totals()
    for k, (n, sec) in (before or {}).items():
        tot[k] = [tot[k][0] - n, tot[k][1] - sec]
    say("profile", f"{what} {wall_s:.3f} s wall; " + ", ".join(
        f"{k} {n} x {sec:.4f} s" for k, (n, sec) in tot.items())
        + f"; the rest is host work ({rest})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    clock_hz = phase_device()
    phase_build()
    kernels, times = phase_kernels(dev, rng, clock_hz)
    sched_row = phase_sched_xor(dev, rng)
    crc_row = phase_crc(dev)
    t_main, since = time.perf_counter(), time.time()
    counts = main_path(dev, rng)
    profile_line(time.perf_counter() - t_main)
    check_main_path(counts, since=since)
    check_race_picks(times, np.random.default_rng(SEED))
    for realization, row in kernels.items():
        row["launches"] = counts[KERNELS[realization][1]]
    before = profile_totals()
    t_bits, since = time.perf_counter(), time.time()
    bit_counts, host_applies = bit_path(dev, rng)
    profile_line(time.perf_counter() - t_bits, before, "bit path",
                 "copies to the card, the numpy codec's checks")
    check_main_path(bit_counts, (SCHED_KERNEL[1],), since, "bit path")
    if host_applies:
        raise AssertionError(f"{host_applies} bit-path applies of the "
                             f"{OBJECT_SIZE >> 20} MiB objects stayed on "
                             "the host")
    sched_row["launches"] = bit_counts[SCHED_KERNEL[1]]
    before = profile_totals()
    csum_before = csum_launches()
    t_write, since = time.perf_counter(), time.time()
    write_counts, write_result = write_path(dev, rng, **WRITE)
    profile_line(time.perf_counter() - t_write, before, "write path",
                 "data generation, staging, the oracle and crc checks")
    check_write_path(write_counts, write_result, csum_before)
    check_picks(picks_since(since), write_counts, "write path")
    crc_row["launches"] = write_counts[CRC_KERNEL[1]]
    before = profile_totals()
    t_wide, since = time.perf_counter(), time.time()
    wide_counts, wide_result = wide_path(dev, rng, **WIDE)
    profile_line(time.perf_counter() - t_wide, before, "wide path",
                 "data generation, CLAY's coupling on the host, the numpy "
                 "codecs' checks")
    check_wide_path(wide_counts, wide_result, since)
    say("launches", "gf_bitmm launches: main path "
                    f"{counts['gf_bitmm']}, write path "
                    f"{write_counts['gf_bitmm']}, wide path "
                    f"{wide_counts['gf_bitmm']}")
    t_bench = time.perf_counter()
    phase_bench(dev)
    phase_sweep(dev.type)
    say("bench", f"phase 15: {time.perf_counter() - t_bench:.1f} s")
    check_cluster(phase_cluster(dev, np.random.default_rng(SEED)))
    check_osd(*phase_osd(dev, np.random.default_rng(SEED)))
    t_root = time.perf_counter()
    phase_bench_root(dev)
    say("bench_root", f"phase 18: {time.perf_counter() - t_root:.1f} s")
    mesh_counts, mesh_res = phase_mesh(dev, np.random.default_rng(SEED),
                                       **MESH)
    say("mesh", mesh_line(mesh_res, dev))
    check_mesh(mesh_counts, mesh_res)
    for realization, row in kernels.items():
        row["mesh_launches"] = mesh_counts[KERNELS[realization][1]]
    sched_row["mesh_launches"] = mesh_counts[SCHED_KERNEL[1]]
    crc_row["mesh_launches"] = mesh_counts[CRC_KERNEL[1]]
    svc_counts, svc_res = phase_services(dev, np.random.default_rng(SEED))
    check_services(svc_counts, svc_res)
    say("services", f"phase 20: {svc_res['phase_s']:.1f} s (scorecard "
                    f"{svc_res['scorecard']['wall_s']:.1f} s, image leg "
                    f"{svc_res['rbd']['leg_s']:.1f} s)")
    for realization, row in kernels.items():
        row["services_launches"] = svc_counts[KERNELS[realization][1]]
    sched_row["services_launches"] = svc_counts[SCHED_KERNEL[1]]
    crc_row["services_launches"] = svc_counts[CRC_KERNEL[1]]
    say("done", f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())
                      + [sched_row, crc_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
