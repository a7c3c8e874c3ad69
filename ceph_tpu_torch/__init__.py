"""ceph_tpu_torch — the PyTorch/CUDA port of ceph_tpu.

A second package beside the JAX package ``ceph_tpu``, which stays the
reference: each module here mirrors its counterpart's path and names, and
the tests hold both to the same bytes on the same inputs.  The port
imports ``torch`` and numpy, never ``jax`` and nothing of ``ceph_tpu``.
The GF(2^8) region kernels are CUDA C++ written by hand for Hopper
(``csrc/``), built with ``nvcc`` at first use into ``build/``.

Entry points run on the card unless the caller asks for the CPU
(profile key ``device``, default ``cuda``).

- ``ceph_tpu_torch.ops``    — GF(2^8) math, XOR schedules, the region
                              kernels and their plain versions.
- ``ceph_tpu_torch.ec``     — the plugin interface, registry and the
                              ``tpu`` plugin.
- ``ceph_tpu_torch.models`` — StripeCodec: encode/decode as functions on
                              tensors.
- ``ceph_tpu_torch.tools``  — ec_benchmark and the corpus check.
- ``ceph_tpu_torch.utils``  — perf counters and the kernel profiler.
"""

__version__ = "0.1.0"
