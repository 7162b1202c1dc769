"""Utilities: profiling regions and traces (``torch.profiler``, NVTX) and
compression / throughput metrics."""

from .profiling import CodecMetrics, annotate, throughput_gbps, trace_to

__all__ = ["annotate", "trace_to", "throughput_gbps", "CodecMetrics"]
