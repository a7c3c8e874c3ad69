"""Core runtime of the port (the reference's src/common layer,
SURVEY.md §2.2): buffers, versioned wire codec, typed config, structured
logging, perf counters and the kernel profiler, throttles, interval
algebra, op tracking (the host<->device staging plane is
``utils.staging``)."""

from .buffer import Buffer, BufferList
from .codec import Decoder, Encoder, Encodable
from .config import Config, Option, OptionLevel, default_config
from .interval import IntervalSet
from .log import ClusterLogger, dout, global_logger
from .perf import (CounterType, KernelProfiler, PerfCounters,
                   PerfCountersCollection, global_perf, kernel_profiler)
from .throttle import Throttle
from .tracked_op import OpTracker

__all__ = [
    "Buffer", "BufferList", "Decoder", "Encoder", "Encodable", "Config",
    "Option", "OptionLevel", "default_config", "IntervalSet",
    "ClusterLogger", "dout", "global_logger", "CounterType",
    "KernelProfiler", "PerfCounters", "PerfCountersCollection",
    "global_perf", "kernel_profiler", "Throttle", "OpTracker",
]
