"""The port's rans16 kernels against the JAX package.

On the CPU the wrappers run their plain PyTorch versions; these must give
the same per-tile sizes, region halfwords and states as the JAX encode
kernel (parsed from ``rans_codec.encode_groups`` payloads, run in
interpret mode) and as the NumPy spec ``rans.encode_lanes``, and decode
the JAX payloads back to the rows ``rans_codec.decode_groups`` gives.
All paths are integer: every comparison is exact.  The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

from range_coder_rust_tpu import rans
from range_coder_rust_tpu import rans_codec as jax_codec
from range_coder_rust_tpu.models.table import table_from_data_pow2
from range_coder_rust_tpu_torch import kernels
from range_coder_rust_tpu_torch import rans_codec as t_codec
from range_coder_rust_tpu_torch.testing import (
    CASE_OPTIONS, KERNEL_CASES, kernel_case, kernels_vs_plain, zipf)

torch.set_num_threads(1)


def _rows(case):
    """(rows (NG*G, L) int32, G, L, NG, alphabet) for a named case."""
    g, L, ng = 128, 64, 2
    if case == "odd_tile_G128_L63":
        L = 63
        data, a = zipf(ng * g * L, 256, 1), 256
    elif case in ("A129", "A400", "A1023"):
        a = int(case[1:])
        ng = 1 if a == 1023 else 2
        data = zipf(ng * g * L, a, a, alpha=0.9)
    elif case == "leading_zero_freq":
        data, a = zipf(ng * g * L, 240, 2) + 16, 256  # symbols 0..15 absent
    elif case == "c_over_2^15":
        rng = np.random.default_rng(3)
        a = 32
        data = np.where(rng.random(ng * g * L) < 0.75, 5,
                        rng.integers(0, a, ng * g * L)).astype(np.int32)
    elif case == "G2048_L64_two_tiles":
        g, ng = 2048, 1  # tile = 32 steps: 2 tiles
        data, a = zipf(ng * g * L, 256, 4), 256
    else:
        raise KeyError(case)
    return data.reshape(ng * g, L), g, L, ng, a


CASES = ["odd_tile_G128_L63", "A129", "A400", "A1023", "leading_zero_freq",
         "c_over_2^15", "G2048_L64_two_tiles"]


@pytest.fixture(scope="module")
def jax_payloads():
    """Each case's table and JAX payloads, made once per module."""
    cache = {}

    def get(case):
        if case not in cache:
            rows, g, L, ng, a = _rows(case)
            table = table_from_data_pow2(rows, a, 16)
            cache[case] = (table, jax_codec.encode_groups(
                rows, table, L, group_lanes=g))
        return cache[case]

    return get


def _encode_plain(rows, table, g, L):
    tile, _ = t_codec._tile_geometry(L, g)
    cum = t_codec.cum_table(table.cum, "cpu")
    states, sizes, region, _ = kernels.rans_encode_tiled(
        torch.from_numpy(rows), cum, group_lanes=g, tile=tile)
    return states.numpy(), sizes.numpy(), region.numpy().view(np.uint16), tile


@pytest.mark.parametrize("case", CASES)
def test_plain_encode_matches_jax_kernel_and_spec(case, jax_payloads):
    rows, g, L, ng, a = _rows(case)
    table, payloads = jax_payloads(case)
    states, sizes, region, tile = _encode_plain(rows, table, g, L)
    assert sizes.shape == (ng, L // tile) and sizes.dtype == np.int32
    assert region.shape == (int(sizes.sum()),)
    off = 0
    for gi in range(ng):
        j_sizes, j_pre6, j_region = jax_codec._parse_payload(
            payloads[gi], L, g)
        n = int(j_sizes.sum())
        np.testing.assert_array_equal(sizes[gi], j_sizes)
        np.testing.assert_array_equal(
            region[off : off + n], np.frombuffer(j_region, "<u2"))
        x8 = np.zeros((g, 8), np.uint8)
        x8[:, :6] = np.frombuffer(j_pre6, np.uint8).reshape(g, 6)
        lane_states = states[gi * g : (gi + 1) * g].view(np.uint64)
        np.testing.assert_array_equal(lane_states, x8.reshape(-1).view("<u8"))
        # and the NumPy spec
        s_states, s_regions, s_counts = rans.encode_lanes(
            rows[gi * g : (gi + 1) * g], table.c, table.cum)
        np.testing.assert_array_equal(lane_states, s_states)
        np.testing.assert_array_equal(
            sizes[gi], s_counts.reshape(-1, tile).sum(axis=1))
        assert region[off : off + n].tobytes() == b"".join(
            r.astype("<u2").tobytes() for r in s_regions)
        off += n


@pytest.mark.parametrize("case", CASES)
def test_plain_decode_matches_jax_decode(case, jax_payloads):
    rows, g, L, ng, a = _rows(case)
    table, payloads = jax_payloads(case)
    got = t_codec.decode_groups(payloads, table.c, L, g, device="cpu")
    want = jax_codec.decode_groups(payloads, table.c, L, g)
    assert got.dtype == want.dtype == (np.uint8 if a <= 256 else np.uint16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.astype(np.int32), rows)


@pytest.mark.parametrize("a,dtype", [(2, torch.uint8), (256, torch.uint8),
                                     (257, torch.int16), (1023, torch.int16)])
def test_decode_output_dtype(a, dtype):
    rows = zipf(128 * 8, a, 5).reshape(128, 8)
    table = table_from_data_pow2(rows, a, 16)
    payloads = t_codec.encode_groups(rows, table, 8, 128, device="cpu")
    assert t_codec._TORCH_OUT[t_codec._np_dtype(a)] == dtype
    out = t_codec.decode_groups(payloads, table.c, 8, 128, device="cpu")
    assert out.dtype == t_codec._np_dtype(a)
    np.testing.assert_array_equal(out.astype(np.int32), rows)


def test_plain_decode_clamps_reads_to_the_region():
    """A group whose region is cut short reads zeros past its end, never
    the next group's halfwords (the bound the CUDA kernel keeps too); the
    next group still decodes exactly."""
    rows = zipf(2 * 128 * 16, 256, 6).reshape(256, 16)
    table = table_from_data_pow2(rows, 256, 16)
    states, sizes, region, _ = _encode_plain(rows, table, 128, 16)
    n0, n1 = (int(s) for s in sizes.sum(axis=1))
    k = n0 // 2
    cum = t_codec.cum_table(table.cum, "cpu")
    hw = torch.from_numpy(region.view(np.int16).copy())
    kw = dict(group_lanes=128, block_len=16, a_count=256,
              out_dtype=torch.uint8)
    st = torch.from_numpy(states)
    cut = kernels.rans_decode_tiled(
        st, torch.cat([hw[:k], hw[n0:]]), torch.tensor([0, k, k + n1]),
        cum, **kw)
    zero_tail = kernels.rans_decode_tiled(
        st[:128], torch.cat([hw[:k], torch.zeros(n0 - k, dtype=torch.int16)]),
        torch.tensor([0, n0]), cum, **kw)
    np.testing.assert_array_equal(cut[:128].numpy(), zero_tail.numpy())
    assert not np.array_equal(cut[:128].numpy().astype(np.int32), rows[:128])
    np.testing.assert_array_equal(cut[128:].numpy().astype(np.int32),
                                  rows[128:])


def test_wrappers_refuse_other_devices():
    rows = torch.zeros((128, 4), dtype=torch.int32, device="meta")
    cum = torch.zeros(1024, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.rans_encode_tiled(rows, cum, group_lanes=128, tile=4)
    with pytest.raises(ValueError):
        kernels.rans_decode_tiled(
            torch.zeros(128, dtype=torch.int64, device="meta"),
            torch.zeros(4, dtype=torch.int16, device="meta"),
            torch.zeros(2, dtype=torch.int64, device="meta"), cum,
            group_lanes=128, block_len=4, a_count=2, out_dtype=torch.uint8)


def test_plain_decode_clamps_offsets_outside_the_region():
    rows = zipf(128 * 16, 256, 7).reshape(128, 16)
    table = table_from_data_pow2(rows, 256, 16)
    states, sizes, region, _ = _encode_plain(rows, table, 128, 16)
    cum = t_codec.cum_table(table.cum, "cpu")
    hw = torch.from_numpy(region.view(np.int16).copy())
    kw = dict(group_lanes=128, block_len=16, a_count=256,
              out_dtype=torch.uint8)
    st = torch.from_numpy(states)
    exact = kernels.rans_decode_tiled(st, hw, torch.tensor([0, hw.numel()]),
                                      cum, **kw)
    wide = kernels.rans_decode_tiled(st, hw, torch.tensor([-9, 1 << 40]),
                                     cum, **kw)
    np.testing.assert_array_equal(wide.numpy(), exact.numpy())
    np.testing.assert_array_equal(exact.numpy().astype(np.int32), rows)


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_kernel_cases_are_valid_on_cpu(name):
    """Every geometry the CUDA kernels are held to on the card encodes and
    decodes back to its rows here (``kernels_vs_plain`` raises otherwise),
    with the plain versions on both sides."""
    rows, g, a = kernel_case(name)
    errs, (states, sizes, region, syncs), symbols = kernels_vs_plain(
        rows, g, a, "cpu", **CASE_OPTIONS.get(name, {}))
    assert errs == {"rans_encode": 0, "rans_decode": 0}
    assert rows.shape[0] % g == 0 and symbols.shape == rows.shape
    assert region.numel() == int(sizes.sum())
