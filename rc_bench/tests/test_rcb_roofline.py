"""The frozen roofline count (``rc_bench/roofline.py``)."""

import pytest

from rc_bench import roofline

N = 1 << 24  # one planar device call: 32768 blocks of 512 symbols
CODE = 11_597_251  # its payload bytes at 5.53 bits/sym: 2^24 * 5.53 / 8


def planar(direction, alphabet=256, n=N, code=CODE):
    layout = {"profile": "planar", "n_symbols": n, "alphabet": alphabet,
              "payload_bytes": code, "halfwords": 0}
    return roofline.work(layout, direction)


def test_planar_call_bound_is_the_hand_worked_value():
    # encode: 26 * 16777216 + 3 * 11597251 = 436207616 + 34791753
    assert planar("encode") == (16_777_216 + 11_597_251, 470_999_369)
    # decode: 29 * 16777216 + 3 * 11597251 = 486539264 + 34791753
    assert planar("decode") == (28_374_467, 521_331_017)
    # peak: 132 * 64 * 1.98e9 = 1.672704e13 operations/s
    t, by = roofline.bound_s(28_374_467, 470_999_369)
    assert by == "operations"
    assert t == pytest.approx(470_999_369 / 1.672704e13, rel=1e-12)
    assert t * 1e3 == pytest.approx(0.0281579, abs=1e-7)
    t, by = roofline.bound_s(*planar("decode"))
    assert by == "operations"
    assert t * 1e3 == pytest.approx(0.0311670, abs=1e-7)


def test_planar_decode_counts_no_search():
    """The decode's count does not grow with the alphabet: no term of a
    binary search over log2(A + 1) steps."""
    assert planar("decode", 256)[1] == planar("decode", 65536)[1]
    assert planar("decode", 2)[1] == 29 * N + 3 * CODE


@pytest.mark.parametrize("alphabet,width", [(2, 1), (256, 1), (257, 2),
                                            (65536, 2), (65537, 4)])
def test_symbols_count_at_their_alphabets_width(alphabet, width):
    assert roofline.symbol_bytes(alphabet) == width
    assert planar("encode", alphabet)[0] == width * N + CODE


def test_rans16_counts_halfwords():
    layout = {"profile": "rans16", "n_symbols": 1 << 28, "alphabet": 256,
              "payload_bytes": 177_000_000, "halfwords": 88_000_000}
    nbytes, ops = roofline.work(layout, "encode")
    assert nbytes == (1 << 28) + 177_000_000
    assert ops == 6 * (1 << 28) + 2 * 88_000_000
    assert roofline.bound_s(nbytes, ops)[1] == "bytes"
