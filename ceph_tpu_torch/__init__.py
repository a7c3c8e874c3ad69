"""ceph_tpu_torch — the PyTorch/CUDA port of ceph_tpu.

A second package beside the JAX package ``ceph_tpu``, which stays the
reference: each module here mirrors its counterpart's path and names, and
the tests hold both to the same bytes on the same inputs.  The port
imports ``torch`` and numpy, never ``jax`` and nothing of ``ceph_tpu``.
The kernels (GF(2^8) regions, GF(2) packet rows, CRC32C) are CUDA C++
written by hand for Hopper (``csrc/``), built with ``nvcc`` at first use
into ``build/``.

Entry points run on the card unless the caller asks for the CPU
(profile key ``device``, default ``cuda``).

- ``ceph_tpu_torch.ops``    — GF(2^8) math, XOR schedules, CRC32C, the
                              kernels and their plain versions, the
                              native library binding.
- ``ceph_tpu_torch.ec``     — the plugin interface, registry, plugins,
                              and the write path: ECBatcher,
                              DeviceArena, CrcVerifier.
- ``ceph_tpu_torch.models`` — StripeCodec: encode/decode as functions on
                              tensors.
- ``ceph_tpu_torch.tools``  — ec_benchmark, the corpus check, the bench
                              twins, the wire-corpus checker (dencoder).
- ``ceph_tpu_torch.utils``  — the runtime core: buffers, the versioned
                              codec, config, logging, perf counters, the
                              kernel profiler, the staging plane.
- ``ceph_tpu_torch.msg``, ``auth``, ``mon``, ``qos``, ``compress``,
  ``telemetry``, ``slo``, ``parallel`` (placement only), ``osd``
  (scheduler, compression, intervals) — the device-free control plane:
  messenger and wire formats, cephx, the monitor and its maps.
"""

__version__ = "0.1.0"
