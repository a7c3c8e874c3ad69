"""Device meshes of the port.

The counterpart of ``ceph_tpu/parallel/mesh.py``: devices arranged in a
``Mesh`` whose named axes carry the parallelism strategies — "dp"
(stripe batches, the PG-parallel analogue) x "shard" (chunk shards of
one stripe, the acting-set analogue), with an outer "host" axis for the
process boundary.

A mesh holds *logical* devices.  ``devices(kind)`` lists the real ones
(``cuda:0..n-1``, or one ``cpu``) unless ``force_devices(kind, n)`` has
set a count of logical devices on the first one — the counterpart of the
JAX package's forced host devices (``force_cpu(device_count=8)``), so
one card (or the CPU) stands in for an n-device mesh.  Each logical
device on a card has a CUDA stream of its own, and its share of a step
runs there.  Inside one process a collective is explicit tensor movement
between the devices' blocks (parallel/distributed.py); across processes
(``init_multihost``) it goes through ``torch.distributed``.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

_LOCK = threading.Lock()
#: kind -> count of logical devices forced on the first real device
_FORCED: dict[str, int] = {}
#: (kind, forced count, process count, rank) -> the device list; kept so
#: a device (and its stream) is one object for the life of the process
_LISTS: dict[tuple, list] = {}


class Device:
    """One logical device: the torch.device its work runs on, the
    process that owns it, and, on a card, a CUDA stream of its own
    (made at first use)."""

    __slots__ = ("id", "torch_device", "process_index", "_stream")

    def __init__(self, id: int, torch_device: torch.device,
                 process_index: int = 0):
        self.id = id
        self.torch_device = torch_device
        self.process_index = process_index
        self._stream = None

    @property
    def addressable(self) -> bool:
        """Whether this process holds the device's data."""
        return self.process_index == process_index()

    def stream(self):
        """The device's own CUDA stream (None on the CPU)."""
        if self.torch_device.type != "cuda":
            return None
        with _LOCK:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=self.torch_device)
            return self._stream

    def __repr__(self) -> str:
        return (f"Device(id={self.id}, {self.torch_device}, "
                f"process={self.process_index})")


def process_index() -> int:
    """This process's rank in the torch.distributed group (0 alone)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def force_devices(kind: str, n: int | None) -> None:
    """Make ``devices(kind)`` list ``n`` logical devices on the first
    real device of ``kind`` (``cuda:`` the current card, or ``cpu``);
    ``None`` goes back to the real devices."""
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unknown device kind {kind!r}")
    with _LOCK:
        if n is None:
            _FORCED.pop(kind, None)
        elif int(n) < 1:
            raise ValueError(f"need at least one device, got {n}")
        else:
            _FORCED[kind] = int(n)


def _local_torch_devices(kind: str) -> list[torch.device]:
    n = _FORCED.get(kind)
    if kind == "cpu":
        return [torch.device("cpu")] * (n or 1)
    if not torch.cuda.is_available():
        raise RuntimeError("devices('cuda') but torch.cuda.is_available() "
                           "is False (ask for 'cpu' to run on the CPU)")
    if n is not None:
        return [torch.device("cuda", torch.cuda.current_device())] * n
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def devices(kind: str = "cuda") -> list[Device]:
    """Every device of ``kind`` across the process group, as
    ``jax.devices()`` lists them: process by process, ids contiguous.
    Only this process's are addressable; another process's carry its
    rank and a placeholder torch.device of the same kind."""
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unknown device kind {kind!r}")
    local = _local_torch_devices(kind)
    n_proc, rank = process_count(), process_index()
    key = (kind, _FORCED.get(kind), len(local), n_proc, rank)
    with _LOCK:
        lst = _LISTS.get(key)
        if lst is None:
            lst = []
            for p in range(n_proc):
                for i, td in enumerate(local):
                    lst.append(Device(p * len(local) + i,
                                      td if p == rank
                                      else torch.device(kind), p))
            _LISTS[key] = lst
        return list(lst)


def local_devices(kind: str = "cuda") -> list[Device]:
    return [d for d in devices(kind) if d.addressable]


class Mesh:
    """An ndarray of logical devices with named axes (the counterpart of
    ``jax.sharding.Mesh``): ``shape`` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def coords(self):
        """Every mesh coordinate, in row-major order."""
        return list(np.ndindex(self.devices.shape))

    def local_coords(self):
        """The coordinates of this process's devices."""
        return [c for c in self.coords() if self.devices[c].addressable]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _pick(devices_arg, n_devices):
    devs = list(devices_arg if devices_arg is not None else devices())
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return devs, n


def make_mesh(n_devices: int | None = None,
              shard_axis: int | None = None,
              devices=None) -> Mesh:
    """A ("dp", "shard") mesh over the first n devices (default: every
    device of the card).  shard_axis defaults to the largest power-of-two
    divisor of n that is <= 4, so an 8-device mesh is (dp=2, shard=4)."""
    devs, n = _pick(devices, n_devices)
    devs = devs[:n]
    if shard_axis is None:
        shard_axis = 1
        while shard_axis * 2 <= min(4, n) and n % (shard_axis * 2) == 0:
            shard_axis *= 2
    if n % shard_axis:
        raise ValueError(f"{n} devices not divisible by shard={shard_axis}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(n // shard_axis, shard_axis), ("dp", "shard"))


def make_flat_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-axis ("shard",) mesh over the first n devices — the fan-out
    of folded launches (the ECBatcher's (k, sum L) tensors), where the
    only parallel dimension is the length axis and no collective runs:
    each device computes its column slice."""
    devs, n = _pick(devices, n_devices)
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr, ("shard",))


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str = "gloo") -> bool:
    """Join a group of processes (the counterpart of the reference's
    jax.distributed join) through ``torch.distributed``: gloo for CPU
    processes and for processes that share one card, ``nccl`` where each
    has a card of its own.  A no-op that returns False for a single
    process.  Environment fallbacks are torch's: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the coordinator), ``WORLD_SIZE``, ``RANK``."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or not coordinator_address:
        return False
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def make_host_mesh(n_hosts: int | None = None,
                   shard_axis: int | None = None,
                   devices=None) -> Mesh:
    """("host", "dp", "shard") mesh: the outer host axis is the process
    boundary, the inner axes one process's devices.  Chatty per-stripe
    collectives stay on "shard"; only batch-parallel reductions cross
    "host".  In a process group the host axis follows the rank; in one
    process an n_hosts axis is made by slicing the device list."""
    devs, _ = _pick(devices, None)
    if n_hosts is None:
        n_hosts = max(1, process_count())
    if len(devs) % n_hosts:
        raise ValueError(f"{len(devs)} devices not divisible by "
                         f"{n_hosts} hosts")
    per_host = len(devs) // n_hosts
    # each host's devices contiguous, so "shard"/"dp" never cross it
    devs = sorted(devs, key=lambda d: (d.process_index, d.id))
    if shard_axis is None:
        shard_axis = 1
        while shard_axis * 2 <= min(4, per_host) and \
                per_host % (shard_axis * 2) == 0:
            shard_axis *= 2
    if per_host % shard_axis:
        raise ValueError(f"{per_host} per-host devices not divisible by "
                         f"shard={shard_axis}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(n_hosts, per_host // shard_axis, shard_axis),
                ("host", "dp", "shard"))
