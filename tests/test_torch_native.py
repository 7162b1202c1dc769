"""The port's conformance anchors against the JAX package's, on the CPU:
the C++ golden coder (``native/golden.py`` over a copy of
``scalar_coder.cc``) and the rans16 NumPy spec (``rans.py``).

The port's golden coder must give the reference's bytes, symbols and
transitions on seeded corpora and raise errors of the same names (the
port's own classes); its library must survive several builders at once.
The port's spec must equal the reference's on one small group."""

import threading

import numpy as np
import pytest

from range_coder_rust_tpu import errors as j_errors
from range_coder_rust_tpu import rans as j_rans
from range_coder_rust_tpu.native import golden as j_golden
from range_coder_rust_tpu_torch import errors as t_errors
from range_coder_rust_tpu_torch import rans as t_rans
from range_coder_rust_tpu_torch.models.table import table_from_data_pow2
from range_coder_rust_tpu_torch.native import golden as t_golden
from range_coder_rust_tpu_torch.testing import zipf


def _corpus(name: str):
    """(symbols, c, cum (A+1,), total)."""
    if name == "zipf_k12":
        syms = zipf(5000, 64, 21)
        t = table_from_data_pow2(syms, 64, 12)
        return syms, t.c, t.cum, 1 << 12
    if name == "zipf_k16_A1000":
        syms = zipf(4000, 1000, 22, alpha=0.9)
        t = table_from_data_pow2(syms, 1000, 16)
        return syms, t.c, t.cum, 1 << 16
    if name == "raw_total":
        syms = np.random.default_rng(23).integers(0, 300, 3000)
        c = np.bincount(syms, minlength=300).astype(np.uint32)
        return syms, c, np.concatenate([[0], np.cumsum(c)]), int(c.sum())
    raise KeyError(name)


@pytest.mark.parametrize("name", ["zipf_k12", "zipf_k16_A1000", "raw_total"])
def test_golden_streams_equal_reference(name):
    syms, c, cum, total = _corpus(name)
    code = t_golden.encode(syms, c, cum, total)
    assert code == j_golden.encode(syms, c, cum, total)
    back = t_golden.decode(code, syms.size, c, cum, total)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, syms)
    np.testing.assert_array_equal(
        back, j_golden.decode(code, syms.size, c, cum, total))


def test_golden_step_equals_reference():
    rng = np.random.default_rng(24)
    for _ in range(200):
        low = int(rng.integers(0, 1 << 63))
        range_ = int(rng.integers(1 << 48, 1 << 63))
        c = int(rng.integers(1, 1 << 10))
        cum = int(rng.integers(0, (1 << 16) - c))
        assert (t_golden.step(low, range_, c, cum, 1 << 16)
                == j_golden.step(low, range_, c, cum, 1 << 16))


def test_golden_errors_equal_reference():
    """Zero total, a zero-frequency symbol and a truncated stream raise
    the reference's errors by name and message, as the port's classes."""
    syms, c, cum, total = _corpus("zipf_k12")
    c0 = c.copy()
    c0[syms[0]] = 0
    code = t_golden.encode(syms, c, cum, total)
    calls = {
        "TableError": lambda g: g.encode(syms, c, cum, 0),
        "ZeroFrequency": lambda g: g.encode(syms, c0, cum, total),
        "TruncatedStream": lambda g: g.decode(code[:3], syms.size, c, cum,
                                              total),
    }
    for name, call in calls.items():
        with pytest.raises(getattr(j_errors, name)) as j_exc:
            call(j_golden)
        with pytest.raises(getattr(t_errors, name)) as t_exc:
            call(t_golden)
        assert type(t_exc.value).__module__ == t_errors.__name__
        assert str(t_exc.value) == str(j_exc.value)


def test_golden_concurrent_builds(tmp_path):
    """Builders racing on one library path each compile to a private name
    and rename: the library loads and no partial file is left."""
    lib = tmp_path / "native" / "libscalar_coder.so"
    errs = []

    def build():
        try:
            t_golden._build(lib)
        except Exception as e:  # reported below
            errs.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and not any(t.is_alive() for t in threads)
    assert [p.name for p in lib.parent.iterdir()] == [lib.name]
    import ctypes

    assert ctypes.CDLL(str(lib)).rc_encode
    assert t_golden.library_path().parent.parent.name == "native"


def test_rans_spec_equals_reference():
    """``encode_lanes`` / ``decode_lanes`` and the group stream of the
    port's copy equal the reference's on one 128-lane group."""
    G, L = 128, 40
    syms = zipf(G * L, 300, 25, alpha=0.9).reshape(G, L)
    t = table_from_data_pow2(syms, 300, t_rans.K)
    t_states, t_regions, t_counts = t_rans.encode_lanes(syms, t.c, t.cum)
    j_states, j_regions, j_counts = j_rans.encode_lanes(syms, t.c, t.cum)
    np.testing.assert_array_equal(t_states, j_states)
    np.testing.assert_array_equal(t_counts, j_counts)
    stream = t_rans.build_group_stream(t_states, t_regions, t_counts)
    assert stream == j_rans.build_group_stream(j_states, j_regions, j_counts)
    states, hw = t_rans.split_group_stream(stream, G)
    back = t_rans.decode_lanes(states, hw, L, t.c, t.cum)
    np.testing.assert_array_equal(back, syms)
    np.testing.assert_array_equal(
        back, j_rans.decode_lanes(states, hw, L, t.c, t.cum))
    assert (t_rans.GROUP_LANES, t_rans.K) == (j_rans.GROUP_LANES, j_rans.K)
    assert t_rans.roundtrip_group(syms, t.c, t.cum)[0] == stream
