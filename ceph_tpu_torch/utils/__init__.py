"""Core runtime of the port: perf counters and the kernel profiler."""

from .perf import (CounterType, KernelProfiler, PerfCounters,
                   PerfCountersCollection, global_perf, kernel_profiler)

__all__ = [
    "CounterType", "KernelProfiler", "PerfCounters",
    "PerfCountersCollection", "global_perf", "kernel_profiler",
]
