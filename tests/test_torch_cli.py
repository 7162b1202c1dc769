"""The port's command line (``python -m range_coder_rust_tpu_torch``)
through ``__main__.main()`` with ``--device cpu``, against the JAX
package's CLI (``tests/test_cli.py``'s cases, plus ``--start/--count``,
``selftest`` and byte-equal encoded files)."""

import json

import numpy as np
import pytest
import torch

from range_coder_rust_tpu.__main__ import main as jmain
import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu_torch.__main__ import main
from range_coder_rust_tpu_torch.testing import zipf

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


def _write(tmp_path, data: bytes, name="in.bin"):
    src = tmp_path / name
    src.write_bytes(data)
    return src


def test_cli_roundtrip_and_range(tmp_path):
    data = np.random.default_rng(3).integers(0, 256, 20000).astype(
        np.uint8).tobytes()
    src = _write(tmp_path, data)
    blob, out, part = (tmp_path / n for n in ("out.rc", "rt.bin", "part.bin"))
    assert main(["encode", str(src), "-o", str(blob), "--block-len", "64",
                 *CPU]) == 0
    assert main(["decode", str(blob), "-o", str(out), *CPU]) == 0
    assert out.read_bytes() == data
    assert main(["decode", str(blob), "-o", str(part), "--start", "777",
                 "--count", "5000", *CPU]) == 0
    assert part.read_bytes() == data[777:5777]


def test_cli_decode_wide_alphabet_writes_u16(tmp_path, capsys):
    """An alphabet above 256 writes little-endian u16 symbols."""
    sym = np.random.default_rng(4).integers(0, 700, 5000).astype(np.int32)
    blob = tmp_path / "wide.rc"
    blob.write_bytes(rt.encode(sym, alphabet=700,
                               config=rt.CodecConfig(k=16, block_len=128),
                               device="cpu"))
    out = tmp_path / "wide.bin"
    assert main(["decode", str(blob), "-o", str(out), *CPU]) == 0
    assert "writing u16 LE symbols" in capsys.readouterr().err
    np.testing.assert_array_equal(
        np.frombuffer(out.read_bytes(), dtype="<u2"), sym.astype(np.uint16))


def test_cli_inspect_equals_jax(tmp_path, capsys):
    data = bytes(range(256)) * 40
    src = _write(tmp_path, data)
    blob = tmp_path / "out.rc"
    assert main(["encode", str(src), "-o", str(blob), "--block-len", "64",
                 *CPU]) == 0
    capsys.readouterr()
    assert main(["inspect", str(blob)]) == 0
    meta = capsys.readouterr().out
    assert jmain(["inspect", str(blob)]) == 0
    assert meta == capsys.readouterr().out
    meta = json.loads(meta)
    assert meta["n_symbols"] == len(data) and meta["alphabet"] == 256
    assert meta["profile"] == "rans16"


def test_cli_selftest(capsys):
    assert main(["selftest"]) == 0
    assert capsys.readouterr().out.startswith("selftest passed: ")


@pytest.mark.parametrize("opts", [
    ["--block-len", "64", "--group-lanes", "128"],
    ["--k", "12", "--block-len", "64"],
    ["--k", "12", "--adaptive", "--block-len", "64"]],
    ids=["rans16_G128", "planar_k12", "adaptive_k12"])
def test_cli_encode_equals_jax_cli(opts, tmp_path, capsys):
    """The same file and options give the JAX CLI's container, and the
    same warning for --adaptive."""
    src = _write(tmp_path, zipf(5000, 256, 5, dtype=np.uint8).tobytes())
    t_out, j_out = tmp_path / "t.rc", tmp_path / "j.rc"
    assert main(["encode", str(src), "-o", str(t_out), *opts, *CPU]) == 0
    t_err = capsys.readouterr().err
    assert jmain(["encode", str(src), "-o", str(j_out), *opts]) == 0
    assert t_err == capsys.readouterr().err
    assert t_out.read_bytes() == j_out.read_bytes()


def test_cli_default_device_needs_a_card(tmp_path):
    """--device defaults to cuda; without a card the CLI raises rather
    than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the gpu tests cover --device cuda")
    src = _write(tmp_path, b"abc" * 100)
    with pytest.raises((AssertionError, RuntimeError)):
        main(["encode", str(src), "-o", str(tmp_path / "o.rc")])
