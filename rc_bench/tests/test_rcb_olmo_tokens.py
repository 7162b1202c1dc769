"""The cells ``olmo_tokens.bulk`` and ``rans16_sync.bulk`` on the CPU, the
control on the first, and the ``histogram_roofline`` reader.

The cells run through ``harness.run(..., device="cpu", n_symbols=...)``:
the port's plain versions at a small size.  The traced run of
``rans16_sync.bulk`` reads every span metric the cell lists (the
device-trace ones need a card); ``olmo_tokens.bulk`` runs untraced here,
as the trace of its plain decode takes seconds, and its spans are the
planar path's that ``tokens_planar.bulk`` reads.
"""

import pytest

from rc_bench import control, generator, harness
from rc_bench.histogram_count import histogram_bytes
from rc_bench.roofline import PEAK_BYTES_PER_S
from rc_bench.trace import Op, Timeline

SEED = (1 << 31) + 2023  # past 32 signed bits, as the benchmark's seeds are
SMALL = {"olmo_tokens.bulk": 2 * 512 + 300, "rans16_sync.bulk": 1 << 16}


def quiet(*a, **k):
    pass


@pytest.mark.parametrize("cell,trace", [("olmo_tokens.bulk", False),
                                        ("rans16_sync.bulk", True)])
def test_the_new_cells_run_correct(cell, trace):
    bench = harness.load_bench()
    r = harness.run(bench, cell, SEED, 0.01, trace, device="cpu",
                    n_symbols=SMALL[cell], log=quiet)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert all(c["value"] == 0 for c in r["checks"].values())
    names = {m["name"]: m["source"] for m in harness.metrics_of(
        bench, {"name": cell}, trace)}
    spans = {n for n, source in names.items() if source == "program_span"}
    assert (spans if trace else set(names)) <= set(r["metrics"])
    assert not trace or spans
    assert harness.config_of(bench, harness.cell_of(bench, cell))[
        "data"]["n_symbols"] == {"olmo_tokens.bulk": 10 ** 8,
                                 "rans16_sync.bulk": 1 << 28}[cell]


def test_the_control_is_not_correct_on_olmo_tokens():
    cell = "olmo_tokens.bulk"
    r = control.run(harness.load_bench(), cell, SEED, 0.01, device="cpu",
                    n_symbols=SMALL[cell], log=quiet)
    assert not r["correct"]
    assert r["checks"]["container_wrong_bytes"]["value"] > 0
    assert r["checks"]["decode_wrong_symbols"]["value"] == 0


def test_histogram_roofline_on_a_hand_made_timeline():
    read = harness._load(harness.HERE / "metrics"
                         / "histogram_roofline.py").read
    spans = [Op("rc_bench.encode", 0.0, 1.0, "span"),
             Op("rc_bench.encode", 2.0, 3.0, "span"),
             Op("rc_bench.decode", 3.0, 4.0, "span")]
    device = [Op("void planar_histogram_kernel<int, 2>", 0.1, 0.1004,
                 "kernel"),
              Op("Memset (Device)", 0.0999, 0.1, "memset"),
              Op("void planar_encode_kernel<int>", 0.2, 0.5, "kernel"),
              Op("void planar_histogram_kernel<int, 2>", 2.1, 2.1002,
                 "kernel"),
              Op("void planar_histogram_kernel<int, 2>", 3.5, 3.6, "kernel")]
    layout = {"profile": "planar", "n_symbols": 10 ** 8, "alphabet": 100352,
              "payload_bytes": 1, "halfwords": 0}
    calls = [generator.Call("encode", 0, 1, 1, b"x", in_window=True)]
    run = harness.RunView(calls, 1.0, Timeline(spans, device, (0.0, 4.0)),
                          layout)
    # 0.6 ms of histogram kernels in two encodes; the decode's is not read
    bound = (4 * 10 ** 8 + 8 * 100352) / PEAK_BYTES_PER_S
    assert histogram_bytes(layout) == 4 * 10 ** 8 + 8 * 100352
    assert read(run) == pytest.approx(100 * bound / 0.3e-3)
    no_kernel = Timeline(spans, device[1:3], (0.0, 4.0))
    assert read(harness.RunView(calls, 1.0, no_kernel, layout)) is None
    assert read(harness.RunView(calls, 1.0, None, layout)) is None
