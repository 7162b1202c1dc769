"""The port's benchmark (``bench.py``, ``python -m range_coder_rust_tpu_torch
bench``) on the CPU at 64 KiB: both profiles run with their round trips
asserted inside, the container's bits/sym equal the codec's, the scalar
baseline's bits/sym equal the JAX package's golden coder's, the JSON
line has the bench's keys, and the CLI command is wired to
``bench.run`` and needs a card by default."""

import functools
import json
import os

import pytest
import torch

from range_coder_rust_tpu.models.table import table_from_data_pow2 as j_table
from range_coder_rust_tpu.native import golden as j_golden
import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu_torch import bench
from range_coder_rust_tpu_torch import format as fmt
from range_coder_rust_tpu_torch.__main__ import main
from range_coder_rust_tpu_torch.testing import make_corpus

torch.set_num_threads(1)

N = 65536

#: the reference bench's keys kept, then the card-side ones added
KEYS = {
    "metric", "value", "unit", "vs_baseline", "profile", "encode_gbps",
    "decode_gbps", "decode_vs_encode", "e2e_gbps", "e2e_gbps_mean",
    "e2e_encode_gbps", "e2e_decode_gbps", "e2e_mb", "e2e_wall_s",
    "corpus_mb", "lane_len", "bits_per_symbol_container",
    "scalar_bits_per_symbol", "size_vs_scalar", "baseline_gbps_scalar_cpp",
    "device", "build_s", "encode_ns_per_step", "decode_ns_per_step",
    "groups", "power_limit_w",
}


@functools.lru_cache(maxsize=None)
def _reference_scalar_bits() -> float:
    """The JAX package's golden coder on the bench's sample and table."""
    data = make_corpus(N)
    t = j_table(data, 256, 16)
    return 8 * len(j_golden.encode(data, t.c, t.cum[:-1], 1 << 16)) / N


def _run(profile, monkeypatch, capsys) -> dict:
    monkeypatch.setenv("RC_BENCH_REPS", "1")
    monkeypatch.setenv("RC_BENCH_PROFILE", profile)
    for knob in ("RC_BENCH_L", "RC_BENCH_K", "RC_BENCH_E2E_MB"):
        monkeypatch.delenv(knob, raising=False)
    line = bench.run(n_bytes=N, device="cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == line and len(printed) == 1
    assert set(line) == KEYS
    assert line["profile"] == profile and line["device"] == "cpu"
    assert line["power_limit_w"] is None and line["build_s"] == 0
    assert line["scalar_bits_per_symbol"] == _reference_scalar_bits()
    assert line["corpus_mb"] == line["e2e_mb"] == N / (1 << 20)
    assert all(line[k] > 0 for k in ("value", "encode_gbps", "decode_gbps",
                                     "e2e_gbps", "encode_ns_per_step"))
    return line


def test_bench_rans16_cpu(monkeypatch, capsys):
    line = _run("rans16", monkeypatch, capsys)
    blob = rt.encode(make_corpus(N), alphabet=256, config=rt.CodecConfig(
        profile="rans16", block_len=32768), device="cpu")
    assert line["bits_per_symbol_container"] == 8 * len(blob) / N
    # 64 KiB fills one group of 2048 lanes at the shrunk lane length 32
    assert line["lane_len"] == 32 and line["groups"] == 1


def test_bench_planar_cpu(monkeypatch, capsys):
    line = _run("planar", monkeypatch, capsys)
    cont = fmt.unpack(rt.encode(make_corpus(N), alphabet=256,
                                config=rt.CodecConfig(), device="cpu"))
    B = cont.n_blocks
    assert line["lane_len"] == 512 and line["groups"] == B == N // 512
    assert line["bits_per_symbol_container"] == (
        8 * (int(cont.lengths.sum()) + 8 * B) / N)


def test_bench_rans16_needs_k16(monkeypatch):
    monkeypatch.setenv("RC_BENCH_PROFILE", "rans16")
    monkeypatch.setenv("RC_BENCH_K", "12")
    with pytest.raises(rt.errors.ConfigError):
        bench.run(n_bytes=N, device="cpu")


def test_cli_bench_calls_run(monkeypatch):
    """``bench --mb --k --device`` sets the reference's knobs and calls
    ``bench.run`` with the corpus size and the device."""
    calls = []
    monkeypatch.setattr(bench, "run", lambda **kw: calls.append(kw))
    for knob in ("RC_BENCH_MB", "RC_BENCH_K"):
        monkeypatch.delenv(knob, raising=False)
    assert main(["bench", "--mb", "3", "--k", "12", "--device", "cpu"]) == 0
    assert calls == [{"n_bytes": 3 << 20, "device": "cpu"}]
    assert os.environ["RC_BENCH_MB"] == "3"
    assert os.environ["RC_BENCH_K"] == "12"
    assert main(["bench"]) == 0
    assert calls[-1] == {"n_bytes": 64 << 20, "device": "cuda"}


def test_cli_bench_default_device_needs_a_card(monkeypatch):
    """--device defaults to cuda; without a card the bench raises before
    it makes its corpus, rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs the bench there")
    for knob in ("RC_BENCH_MB", "RC_BENCH_K"):
        monkeypatch.delenv(knob, raising=False)
    with pytest.raises((AssertionError, RuntimeError)):
        main(["bench"])
