"""Parallelism layer of the port: device meshes of logical devices, sharded
arrays, and the distributed EC write/recovery steps (the counterpart of
``ceph_tpu.parallel``: stripe batch = data parallel, shard axis = tensor
parallel, collectives as copies between a card's logical devices and
``torch.distributed`` between processes), plus the placement function
the monitor's maps stand on (``parallel.placement``)."""

from .mesh import init_multihost, make_flat_mesh, make_host_mesh, make_mesh
from .distributed import DistributedStripeEC, make_folded_matmul

__all__ = ["make_mesh", "make_flat_mesh", "make_host_mesh",
           "init_multihost", "DistributedStripeEC", "make_folded_matmul"]
