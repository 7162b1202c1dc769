"""The port's copy of the scalar streaming API against the JAX package's:
``Encoder`` / ``Decoder`` / ``FreqTable`` byte-equal on the data of
``examples/sample_impl.py`` and on a random sweep, the adaptive scalar
model's round trips, the typed errors, and the same public names."""

import numpy as np
import pytest

import range_coder_rust_tpu as jref
import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu.models import adaptive_freq as j_adaptive
from range_coder_rust_tpu_torch import errors as t_errors
from range_coder_rust_tpu_torch.models import adaptive_freq as t_adaptive

#: the reference's acceptance data (examples/sample_impl.py)
SAMPLE = [2, 1, 1, 4, 1, 4, 2, 1, 0, 1, 5, 9, 8, 7, 6, 5]

SCALAR_NAMES = ["RangeCoder", "Encoder", "Decoder", "PModel", "FreqTable",
                "errors", "MASK64", "TOP8", "TOP16", "MAX_BYTES_PER_SYMBOL"]


def _code(pkg, data, alphabet):
    table = pkg.FreqTable(alphabet)
    for s in data:
        table.add_alphabet_freq(int(s))
    table.calc_cum()
    enc = pkg.Encoder()
    sizes = [enc.encode(table, int(s)) for s in data]
    return table, sizes, enc.finish()


def test_scalar_api_names_match_reference():
    for name in SCALAR_NAMES:
        assert name in rt.__all__
        if name.isupper():
            assert getattr(rt, name) == getattr(jref, name)
    assert rt.errors is t_errors
    assert rt.FreqTable.__module__.startswith("range_coder_rust_tpu_torch.")


def test_sample_data_bytes_equal_and_round_trip():
    jt, jsizes, jcode = _code(jref, SAMPLE, 10)
    tt, tsizes, tcode = _code(rt, SAMPLE, 10)
    assert tcode == jcode and tsizes == jsizes
    assert [tt.cum_freq(i) for i in range(10)] == [
        jt.cum_freq(i) for i in range(10)]
    dec = rt.Decoder(jcode)
    assert [dec.decode(tt) for _ in SAMPLE] == SAMPLE


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sweep_bytes_equal(seed):
    """Alphabets of 1 to 300 symbols, skewed and flat data, and each
    decoder reading the other package's code."""
    r = np.random.default_rng(seed)
    for _ in range(12):
        a = int(r.integers(1, 300))
        n = int(r.integers(1, 400))
        data = (r.zipf(1.0 + r.random() * 1.5, n) - 1) % a
        jt, jsizes, jcode = _code(jref, data, a)
        tt, tsizes, tcode = _code(rt, data, a)
        assert tcode == jcode and tsizes == jsizes
        tdec, jdec = rt.Decoder(jcode), jref.Decoder(tcode)
        assert [tdec.decode(tt) for _ in data] == list(data)
        assert [jdec.decode(jt) for _ in data] == list(data)


def test_adaptive_scalar_round_trips():
    r = np.random.default_rng(9)
    for a, n in [(2, 500), (17, 3000), (256, 2000)]:
        data = r.integers(0, a, n)
        code = t_adaptive.encode_adaptive_scalar(data, a)
        assert code == j_adaptive.encode_adaptive_scalar(data, a)
        assert t_adaptive.decode_adaptive_scalar(code, n, a) == list(data)


def test_scalar_errors_are_the_ports():
    with pytest.raises(t_errors.TruncatedStream):
        rt.Decoder(b"\x00" * 7)
    with pytest.raises(t_errors.TableError):
        rt.FreqTable(3).calc_cum()
    with pytest.raises(t_errors.UpperBoundOverflow):
        rc = rt.RangeCoder()
        rc.set_state(1, rt.MASK64)
        rc.upper_bound()
