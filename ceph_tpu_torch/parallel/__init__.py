"""Parallelism layer of the port.  This slice holds only the placement
function (``parallel.placement``: hash-based PG placement, the CRUSH
equivalent the monitor's maps stand on); the device meshes and the
distributed EC steps of ``ceph_tpu.parallel`` are not ported yet."""
