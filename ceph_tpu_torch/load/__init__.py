"""Saturation traffic harness: many-client load generation with QoS.

The "millions of users" proxy the ROADMAP's north star hangs off: a
multi-process load generator (``generator`` + ``load_worker``) drives
hundreds of simulated clients through the librados client against a
``tools/vstart.MiniCluster`` over real TCP, shaped by named workload
profiles (``profiles``: op-size distributions, read/write mix,
hot-object zipf skew, open- vs closed-loop arrivals) and composed into
scenario legs (``scenarios``: ramp-to-saturation, steady saturation,
thrash-while-loaded) with the mclock scheduler as the experiment
variable.  ``python -m ceph_tpu_torch.tools.bench_root --saturate`` is
the operator face.  The workers are TCP clients with no CUDA device.
"""

from .profiles import (PROFILES, Pow2Histogram, Profile, ZipfSampler,
                       get_profile)

__all__ = ["PROFILES", "Pow2Histogram", "Profile", "ZipfSampler",
           "get_profile"]
