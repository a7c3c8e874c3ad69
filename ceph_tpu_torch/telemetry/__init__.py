"""Telemetry subsystems: dynamic perf queries (attribution), built on
the perf-counter / metrics-history planes in utils/."""
