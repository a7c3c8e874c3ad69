"""Core runtime of the port: perf counters and the kernel profiler (the
host<->device staging plane is ``utils.staging``)."""

from .perf import (CounterType, KernelProfiler, PerfCounters,
                   PerfCountersCollection, global_perf, kernel_profiler)

__all__ = [
    "CounterType", "KernelProfiler", "PerfCounters",
    "PerfCountersCollection", "global_perf", "kernel_profiler",
]
