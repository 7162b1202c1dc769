"""Shared planar tables of 2^17 to 2^24 over a 100352-token vocabulary, on
the CPU.

The ``olmo_tokens`` configuration of the benchmark (``rc_bench``): uint32
token ids over the 100352 ids of OLMo's dolma2 tokenizer, coded with
``CodecConfig(k=...)`` above the JAX package's limit of 16.  Here a few
blocks of seeded Zipf(1.0) ids with a partial last block, coded by the
plain versions of the planar kernels: each container equals the
benchmark's frozen reference byte for byte, its blocks equal the scalar
golden coder's at total 2^k, and ``decode`` and ``decode_range`` give
the ids back, every planar call counted as ``pow2_wide``.  The header's
decoder target is compiled with g++: at k 24 the float estimate misses
where the double one, which the header's rule picks there, is exact.
Imports no JAX.
"""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu_torch import format as fmt
from range_coder_rust_tpu_torch.errors import InvalidHeader
from range_coder_rust_tpu_torch.kernels import planar
from range_coder_rust_tpu_torch.native import golden
from range_coder_rust_tpu_torch.testing import zipf
from rc_bench import reference

torch.set_num_threads(1)

VOCAB = 100352  # vocab_size of OLMo's dolma2 models
N = 2 * 512 + 300  # two whole blocks and a partial one
CODEC = {"profile": "planar", "block_len": 512, "with_checksums": True}
CSRC = Path(planar.__file__).resolve().parent.parent / "csrc"


@functools.lru_cache(maxsize=None)
def tokens() -> np.ndarray:
    return zipf(N, VOCAB, 23, alpha=1.0, dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def blob(k: int) -> bytes:
    return rt.encode(tokens(), alphabet=VOCAB, config=rt.CodecConfig(k=k),
                     device="cpu")


@pytest.mark.parametrize("k", [17, 20, 24])
def test_encode_equals_the_benchmark_reference(k):
    assert blob(k) == reference.encode(tokens(), dict(CODEC, k=k), VOCAB,
                                       "cpu")
    cont = fmt.unpack(blob(k))
    assert cont.k == k and int(np.asarray(cont.tables_c).sum()) == 1 << k


def test_decode_and_range_give_the_ids_back_on_the_wide_form():
    container = blob(20)
    rt.reset_launch_counts()
    out = rt.decode(container, device="cpu")
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, tokens())
    start, count = 512 - 37, 100
    got = rt.api.decode_range(container, start, count, device="cpu")
    np.testing.assert_array_equal(got, tokens()[start : start + count])
    rt.encode(tokens()[:600], alphabet=VOCAB, config=rt.CodecConfig(k=20),
              device="cpu")
    rt.encode(tokens()[:600], alphabet=VOCAB, device="cpu")
    wide = dict.fromkeys(planar.TOTAL_FORMS, 0)
    assert rt.launch_totals() == {
        "planar_encode": dict(wide, pow2_wide=1, pow2=1),
        "planar_decode": dict(wide, pow2_wide=2)}


def test_blocks_equal_the_golden_coder():
    """Each block's payload equals the scalar coder's at total 2^k (the
    partial last block padded with the table's most frequent id)."""
    for k in (17, 24):
        cont = fmt.unpack(blob(k))
        c = np.asarray(cont.tables_c, np.uint32)
        cum = np.concatenate([[0], np.cumsum(c)]).astype(np.uint32)
        padded = np.full(cont.n_blocks * 512, np.argmax(c), np.uint32)
        padded[:N] = tokens()
        for b in range(cont.n_blocks):
            rows = padded[b * 512 : (b + 1) * 512]
            assert bytes(cont.payloads[b]) == golden.encode(rows, c, cum,
                                                            1 << k)


def test_unpack_refuses_k_outside_the_range():
    bad = bytearray(blob(20))
    bad[6] = 25
    with pytest.raises(InvalidHeader):
        fmt.unpack(bytes(bad))
    bad[6] = 0  # k 0 without the raw-total flag
    with pytest.raises(InvalidHeader):
        fmt.unpack(bytes(bad))


_SHIM = r"""
#include "planar_step.cuh"

using planar::u64;

extern "C" {

void wt_float(long long n, const u64* d, const u64* r, u64 qmax, u64* out) {
  for (long long i = 0; i < n; ++i)
    out[i] = planar::quotient<false>(d[i], r[i], qmax);
}

// the decoder's target at a total of 2^k, on the form total_form picks
void wt_target(long long n, const u64* d, const u64* rng, int k, u64* out) {
  for (long long i = 0; i < n; ++i) {
    if (planar::total_form(k) == planar::kPow2) {
      const planar::Pow2Total t = planar::pow2_total(k);
      out[i] = planar::quotient<planar::Pow2Total::kWide>(d[i], t.rpt(rng[i]),
                                                          t.qmax);
    } else {
      const planar::Pow2WideTotal t = planar::pow2_wide_total(k);
      out[i] = planar::quotient<planar::Pow2WideTotal::kWide>(
          d[i], t.rpt(rng[i]), t.qmax);
    }
  }
}

int wt_form(int k) { return planar::total_form(k); }

}  // extern "C"
"""


def test_float_target_misses_at_k24_where_the_wide_form_is_exact(
        tmp_path):
    """With the float reciprocal one ulp off, as the card's rcp.approx may
    give it, the float quotient misses ``(window - low) / (range >> 24)``
    on states the coder reaches (range in [2^48, 2^64), window in [low,
    low + range)); the target on the form the header's rule picks is
    exact there, and at k 16 and 20.  The rule is the wrappers'."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the header for the host")
    (tmp_path / "shim.cc").write_text(_SHIM)
    libs = []
    for u in (1, -1):
        so = tmp_path / f"libwt{u}.so"
        subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
                        "-Werror", f"-DPLANAR_HOST_RCP_ULPS={u}",
                        f"-I{CSRC}", "-o", str(so),
                        str(tmp_path / "shim.cc")], check=True)
        libs.append(ctypes.CDLL(str(so)))
    assert [libs[0].wt_form(k) for k in range(25)] == [
        planar.TOTAL_FORMS.index(planar.total_form(k)) for k in range(25)]
    r = np.random.default_rng(24)
    n = 1 << 16
    rng = (r.integers(1 << 48, 1 << 63, n, dtype=np.uint64)
           << np.uint64(1)) | r.integers(0, 2, n, dtype=np.uint64)
    hi = rng >> np.uint64(32)  # d = window - low, below rng
    d = (hi * r.integers(0, 1 << 32, n, dtype=np.uint64)
         + r.integers(0, 1 << 32, n, dtype=np.uint64) % hi)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    for k in (16, 20, 24):
        rpt = rng >> np.uint64(k)
        want = np.minimum(d // rpt, np.uint64((1 << k) - 1))
        for lib in libs:
            got = np.empty(n, np.uint64)
            lib.wt_target(ctypes.c_longlong(n), p(d), p(rng), k, p(got))
            np.testing.assert_array_equal(got, want, f"k {k}")
            if k == 24:
                lib.wt_float(ctypes.c_longlong(n), p(d), p(rpt),
                             ctypes.c_ulonglong((1 << k) - 1), p(got))
                assert np.count_nonzero(got != want) > 0


def test_widen_span_opens_only_for_a_copy():
    """``api.widen`` covers the host's copy of uint32 (or int64) input to
    int32 rows, and does not open where the input is taken as it is."""
    def spans(data):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            rt.api._as_symbols(data, VOCAB)
        return [e.name for e in prof.events() if e.name == "api.widen"]

    ids = tokens()[:100]
    assert spans(ids) == spans(ids.astype(np.int64)) == ["api.widen"]
    assert spans(ids.astype(np.int32)) == []
    assert spans(ids.astype(np.uint16)) == []
