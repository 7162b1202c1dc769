"""The harness on the CPU: inputs by seed, sound runs, the result line,
the readers' arithmetic, and what a run may not load or fall back to.

Cells run here through ``harness.run(..., device="cpu", n_symbols=...)``:
the port's plain versions at a small size.  The command itself refuses to
run without a card.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rc_bench import generator, harness, readers
from rc_bench.trace import Op, Timeline

ROOT = Path(harness.__file__).resolve().parent.parent
SEED = (1 << 31) + 977  # past 32 signed bits, as the driver's seeds are
#: a small size a cell runs at here: planar blocks, or a rans16 group
#: whose lanes have two sync states
SMALL = {"planar_default": 1 << 17, "rans16_sync": 2 << 20}


def bench():
    return harness.load_bench()


def small(cell):
    return SMALL[harness.cell_of(bench(), cell)["config"]]


def zipf(seed, n=1 << 16):
    spec = {"n_symbols": n, "alphabet": 256, "alpha": 1.2, "dtype": "uint8"}
    return harness._load(harness.HERE / "data" / "zipf.py").make(
        spec, seed, "cpu")


def test_data_and_reads_are_fixed_by_the_seed():
    a, b, c = zipf(SEED), zipf(SEED), zipf(SEED + 1)
    assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # Zipf(1.2): symbol 0 is the most frequent, p = 0.2534
    counts = np.bincount(a, minlength=256)
    assert counts.argmax() == 0 and 0.245 < counts[0] / a.size < 0.262
    mix = {"sequence": [{"op": "decode_range", "count": 1024,
                         "start": "uniform"}]}

    def starts(seed):
        d = generator.Driver(None, None, a, 256, mix, seed, "cpu")
        return [d._start(mix["sequence"][0]) for _ in range(50)]

    assert starts(SEED) == starts(SEED)
    assert starts(SEED) != starts(SEED + 1)
    assert all(0 <= s <= a.size - 1024 for s in starts(SEED))


@pytest.mark.parametrize("cell", ["planar_default.bulk",
                                  "rans16_sync.reads"])
def test_a_sound_run_is_correct(cell):
    r = harness.run(bench(), cell, SEED, 0.2, False, device="cpu",
                    n_symbols=small(cell))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    names = {m["name"] for m in harness.metrics_of(bench(),
                                                   {"name": cell}, False)}
    assert set(r["metrics"]) == names and "setup_s" in names
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in r["checks"].values())
    json.dumps(r)


def test_readers_on_a_hand_made_timeline():
    def call(op, a, b):
        return generator.Call(op, a, b, 1_000_000, b"x", in_window=True)

    spans = [Op("rc_bench.encode", 0.0, 1.0, "span"),
             Op("planar.histogram", 0.1, 0.4, "span"),
             Op("rc_bench.encode", 2.0, 3.0, "span"),
             Op("planar.histogram", 2.1, 2.2, "span")]
    device = [Op("k", 0.5, 0.6, "kernel"), Op("Memcpy DtoH", 0.55, 0.7,
                                                 "memcpy"),
              Op("k", 1.5, 1.6, "kernel"), Op("k", 2.5, 2.55, "kernel")]
    tl = Timeline(spans, device, (0.0, 3.0))
    layout = {"profile": "planar", "n_symbols": 1 << 24, "alphabet": 256,
              "payload_bytes": 11_597_251, "halfwords": 0}
    run = harness.RunView([call("encode", 0, 1), call("encode", 2, 3)],
                          1.0, tl, layout)
    assert readers.rate_GBps(run, "encode") == pytest.approx(1e-3)
    assert readers.span_ms(run, "encode", ["planar.histogram"]) == (
        pytest.approx(200.0))
    assert readers.kernel_ms(run, "encode") == pytest.approx(75.0)
    # busy inside the calls: [0.5, 0.7] and [2.5, 2.55]; the kernel at
    # 1.5 lies between them
    assert readers.idle_pct(run, "encode") == pytest.approx(87.5)
    assert readers.roofline_pct(run, "encode") == pytest.approx(
        100 * 470_999_369 / 1.672704e13 / 0.075)
    lat = harness.RunView([call("decode_range", 0, i / 100)
                           for i in range(1, 101)], 1.0, None, None)
    assert readers.latency_ms(lat, "decode_range", 0.95) == pytest.approx(950)
    assert readers.span_ms(lat, "encode", ["x"]) is None
    assert tl.busy() == pytest.approx(0.2 + 0.05 + 0.1)
    # each stretch of a gap goes to the innermost span open over it
    gaps = dict(tl.idle_gaps())
    assert gaps == pytest.approx({"rc_bench.encode": 1.35,
                                  "planar.histogram": 0.4,
                                  "(no span)": 0.9})


def test_no_jax_is_loaded_and_forbidden_names_are_whole():
    code = ("import sys; from rc_bench import harness; "
            "b = harness.load_bench(); "
            "harness.run(b, 'rans16_sync.reads', 5, 0.1, True, "
            "device='cpu', n_symbols=1 << 18, log=lambda *a, **k: None); "
            "print(harness.forbidden_modules(), "
            "'range_coder_rust_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[] True"
    saved = dict(sys.modules)
    try:
        sys.modules["range_coder_rust_tpu.api"] = sys
        sys.modules["jaxlib"] = sys
        assert harness.forbidden_modules() == ["jaxlib",
                                               "range_coder_rust_tpu.api"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "rc_bench", "--workload",
         "planar_default.bulk", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA device" in out.stderr
