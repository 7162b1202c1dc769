"""The benchmark's readers of the container format's spans
(``rc_bench/metrics/{unpack,crc}_ms.*.py``) on a hand-made timeline: a
span counts in the api call whose benchmark span holds it, nested or not,
and a reader finds nothing (``None``) where the program opens no such
span."""

import pytest

from rc_bench import harness
from rc_bench.trace import Op, Timeline


def _span(name, a, b):
    return Op(name, a, b, "span")


#: one encode, two decodes and one read; a ``format.crc32`` outside every
#: call (a set-up call's) that no reader may count
_SPANS = [
    _span("rc_bench.encode", 0.0, 1.0),
    _span("planar.pack", 0.5, 0.9),
    _span("format.crc32", 0.6, 0.8),
    _span("rc_bench.decode", 2.0, 3.0),
    _span("format.unpack", 2.0, 2.5),
    _span("format.crc32", 2.1, 2.4),
    _span("rc_bench.decode", 4.0, 5.0),
    _span("format.unpack", 4.0, 4.3),
    _span("format.crc32", 4.05, 4.25),
    _span("rc_bench.decode_range", 6.0, 6.2),
    _span("format.unpack", 6.0, 6.05),
    _span("format.crc32", 6.06, 6.1),
    _span("format.crc32", 7.0, 7.5),
]


def _read(name, spans):
    view = harness.RunView([], 1.0, Timeline(spans, [], (0.0, 6.2)), {})
    return harness._load(harness.HERE / "metrics" / f"{name}.py").read(view)


@pytest.mark.parametrize("name,ms,moves", [
    ("unpack_ms.decode", (500 + 300) / 2, "decode_GBps"),
    ("crc_ms.decode", (300 + 200) / 2, "decode_GBps"),
    ("crc_ms.encode", 200, "encode_GBps"),
    ("unpack_ms.range", 50, "range_p95_ms"),
    ("crc_ms.range", 40, "range_p95_ms")])
def test_reader_gives_the_span_a_call(name, ms, moves):
    assert _read(name, _SPANS) == pytest.approx(ms)
    entry = next(m for m in harness.load_bench()["per_layer"]
                 if m["name"] == name)
    assert (entry["source"], entry["layer"], entry["moves"]) == (
        "program_span", "container format", moves)


def test_readers_find_nothing_without_the_spans():
    """A program without the spans (or a run without a trace) leaves the
    metrics out of the line."""
    calls_only = [s for s in _SPANS if s.name.startswith("rc_bench.")]
    for name in ("unpack_ms.decode", "crc_ms.decode", "crc_ms.encode",
                 "unpack_ms.range", "crc_ms.range"):
        assert _read(name, calls_only) is None
        path = harness.HERE / "metrics" / f"{name}.py"
        assert harness._load(path).read(
            harness.RunView([], 1.0, None, {})) is None
