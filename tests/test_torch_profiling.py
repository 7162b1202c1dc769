"""The port's profiling utilities (``utils/profiling.py``) on the CPU:
named regions in ``torch.profiler``'s events, a trace file from
``trace_to``, the codec's phases as named regions, and ``CodecMetrics``
equal to the JAX package's."""

import json

import numpy as np
import pytest
import torch

from range_coder_rust_tpu.utils.profiling import CodecMetrics as JMetrics
import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu_torch.testing import zipf
from range_coder_rust_tpu_torch.utils import (CodecMetrics, annotate,
                                              throughput_gbps, trace_to)

torch.set_num_threads(1)


def _names(prof) -> set:
    return {e.name for e in prof.events()}


def test_annotate_names_a_region():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("rc.outer", device="cpu"):
            with annotate("rc.inner"):
                torch.arange(10).sum()
    assert {"rc.outer", "rc.inner"} <= _names(prof)


def test_trace_to_writes_a_trace_file(tmp_path):
    with trace_to(str(tmp_path), device="cpu"):
        with annotate("rc.traced"):
            torch.ones(100).cumsum(0)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "rc.traced" for e in events)


@pytest.mark.parametrize("profile,regions", [
    ("rans16", {"rans16.histogram", "rans16.upload", "rans16.encode_kernel",
                "rans16.d2h", "rans16.payloads", "rans16.pack",
                "rans16.parse", "rans16.decode_kernel"}),
    ("planar", {"planar.histogram", "planar.upload", "planar.encode_steps",
                "planar.d2h", "planar.payloads", "planar.pack",
                "planar.payload_matrix", "planar.decode_steps"})])
def test_codec_phases_are_named_regions(profile, regions):
    data = zipf(3000, 50, 7, dtype=np.uint8)
    cfg = (rt.CodecConfig(profile="rans16", block_len=16, group_lanes=128)
           if profile == "rans16" else rt.CodecConfig(block_len=64))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        blob = rt.encode(data, config=cfg, device="cpu")
        out = rt.decode(blob, device="cpu")
    np.testing.assert_array_equal(out, data)
    assert regions <= _names(prof)


@pytest.mark.parametrize("name", ["zipf_bytes", "one_symbol"])
def test_codec_metrics_equal_reference(name):
    data = (zipf(4096, 256, 8, dtype=np.uint8) if name == "zipf_bytes"
            else np.zeros(100, np.int32))
    blob = rt.encode(data, config=rt.CodecConfig(block_len=64),
                     device="cpu")
    args = (data, blob, 0.25, 0.125)
    for kw in ({}, {"payload_bytes": len(blob) - 40}):
        # JSON text: the one-symbol corpus's efficiency is nan on both sides
        assert json.dumps(CodecMetrics.measure(*args, **kw).as_dict()) == \
            json.dumps(JMetrics.measure(*args, **kw).as_dict())
    assert throughput_gbps(2e9, 2.0) == 1.0
