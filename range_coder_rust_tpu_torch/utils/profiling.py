"""Tracing, profiling and compression metrics.

The port's counterpart of ``range_coder_rust_tpu/utils/profiling.py``:

* :func:`annotate` — a named region that shows up in ``torch.profiler``
  traces, and as an NVTX range where the work runs on a CUDA device;
* :func:`trace_to` — capture a ``torch.profiler`` trace of a block into a
  directory (a Chrome trace file TensorBoard's profiler plugin also reads);
* :class:`CodecMetrics` — compression observability: achieved bits/symbol
  against the order-0 Shannon bound, container overhead, throughput
  (NumPy only, a copy of the reference's).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


@contextlib.contextmanager
def annotate(name: str, device=None) -> Iterator[None]:
    """Named region for profiler timelines: a ``record_function`` range,
    plus an NVTX range when ``device`` is a CUDA device (and CUDA is there:
    without it, the work inside raises its own error).  Costs about a
    microsecond when no profiler runs."""
    with torch.profiler.record_function(name):
        if not (_is_cuda(device) and torch.cuda.is_available()):
            yield
            return
        with torch.cuda.nvtx.range(name):
            yield


@contextlib.contextmanager
def trace_to(log_dir: str, device="cuda") -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (CPU activity, plus CUDA
    activity when ``device`` is a CUDA device) and write its trace file
    (``*.pt.trace.json``) into ``log_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if _is_cuda(device):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof


def throughput_gbps(n_bytes: int, seconds: float) -> float:
    return n_bytes / 1e9 / max(seconds, 1e-12)


@dataclasses.dataclass
class CodecMetrics:
    """Per-run compression/throughput report."""

    n_symbols: int
    payload_bytes: int
    container_bytes: int
    encode_seconds: float
    decode_seconds: float
    entropy_bits: Optional[float] = None  # order-0 Shannon bound

    @classmethod
    def measure(cls, data: np.ndarray, blob: bytes, enc_s: float, dec_s: float,
                payload_bytes: Optional[int] = None) -> "CodecMetrics":
        data = np.asarray(data).reshape(-1)
        counts = np.bincount(data.astype(np.int64))
        p = counts[counts > 0] / data.size
        entropy = float(-(p * np.log2(p)).sum()) if data.size else 0.0
        return cls(
            n_symbols=int(data.size),
            payload_bytes=int(payload_bytes if payload_bytes is not None else len(blob)),
            container_bytes=len(blob),
            encode_seconds=enc_s,
            decode_seconds=dec_s,
            entropy_bits=entropy,
        )

    @property
    def bits_per_symbol(self) -> float:
        return 8 * self.payload_bytes / max(self.n_symbols, 1)

    @property
    def efficiency(self) -> float:
        """Shannon-bound efficiency: ideal bits / achieved bits (<= ~1)."""
        if not self.entropy_bits:
            return float("nan")
        return self.entropy_bits / self.bits_per_symbol

    def as_dict(self) -> dict:
        return {
            "n_symbols": self.n_symbols,
            "payload_bytes": self.payload_bytes,
            "container_bytes": self.container_bytes,
            "bits_per_symbol": round(self.bits_per_symbol, 4),
            "entropy_bits_per_symbol": round(self.entropy_bits or 0.0, 4),
            "efficiency_vs_shannon": round(self.efficiency, 4),
            "encode_gbps": round(throughput_gbps(self.n_symbols, self.encode_seconds), 4),
            "decode_gbps": round(throughput_gbps(self.n_symbols, self.decode_seconds), 4),
        }
