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
from range_coder_rust_tpu_torch import format as fmt
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


_RANS16 = rt.CodecConfig(profile="rans16", block_len=16, group_lanes=128)


def _coded(profile, n=3000):
    """A Zipf corpus and a config: rans16 with small groups (2048 symbols
    a group), rans16 with a sync point every tile (one group of 1024
    lanes of 3 tiles), or planar blocks of 64."""
    if profile == "rans16_sync":
        return (zipf(1024 * 192, 50, 7, dtype=np.uint8),
                rt.CodecConfig(profile="rans16", block_len=192,
                               group_lanes=1024, sync_tiles=1))
    data = zipf(n, 50, 7, dtype=np.uint8)
    return data, (_RANS16 if profile == "rans16"
                  else rt.CodecConfig(block_len=64))


@pytest.mark.parametrize("profile,regions", [
    ("rans16", {"rans16.histogram", "rans16.upload", "rans16.encode_kernel",
                "rans16.d2h", "rans16.payloads", "rans16.pack",
                "rans16.parse", "rans16.decode_kernel", "rans16.table",
                "rans16.pad", "format.unpack", "format.crc32"}),
    ("planar", {"planar.histogram", "planar.upload", "planar.encode_steps",
                "planar.d2h", "planar.payloads", "planar.pack",
                "planar.payload_bytes", "planar.decode_steps",
                "planar.table", "planar.pad", "format.unpack",
                "format.crc32"}),
    ("rans16_sync", {"format.unpack", "format.crc32", "rans16.parse",
                     "rans16.table", "rans16.upload",
                     "rans16.decode_kernel", "rans16.d2h"})])
def test_codec_phases_are_named_regions(profile, regions):
    """Encode and decode (``rans16_sync``: a read across two lanes, one
    of them from a sync point, the encode outside the profile) open every
    phase's region."""
    data, cfg = _coded(profile)
    blob = rt.encode(data, config=cfg, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if profile == "rans16_sync":
            out = rt.api.decode_range(blob, 5 * 192 + 150, 100,
                                      device="cpu")
            data = data[5 * 192 + 150 : 5 * 192 + 250]
        else:
            blob = rt.encode(data, config=cfg, device="cpu")
            out = rt.decode(blob, device="cpu")
    np.testing.assert_array_equal(out, data)
    assert regions <= _names(prof)


@pytest.mark.parametrize("profile", ["planar", "rans16"])
def test_container_regions_open_once_a_call(profile):
    """Regions are opened a phase, never a payload: a container of many
    units (94 planar blocks, 3 rans16 groups) opens one ``format.crc32``
    in its encode, and one ``format.unpack`` and one ``format.crc32`` in
    its decode."""
    data, cfg = _coded(profile, n=6000)

    def counts(fn):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = fn()
        names = [e.name for e in prof.events()]
        return out, {n: names.count(n) for n in ("format.unpack",
                                                  "format.crc32")}

    blob, enc = counts(lambda: rt.encode(data, config=cfg, device="cpu"))
    assert fmt.unpack(blob).n_blocks == (94 if profile == "planar" else 3)
    out, dec = counts(lambda: rt.decode(blob, device="cpu"))
    np.testing.assert_array_equal(out, data)
    assert enc == {"format.unpack": 0, "format.crc32": 1}
    assert dec == {"format.unpack": 1, "format.crc32": 1}


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
