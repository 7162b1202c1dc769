"""Sync points and tile random access in the port, on the CPU.

The plain encode's sync states must equal the JAX encode kernel's sync
output (interpret mode); ``sync_tiles`` containers must be byte-equal to
``range_coder_rust_tpu.api.encode``'s and decode both ways; and
``api.decode_range`` must equal slicing, as ``tests/test_decode_range.py``
holds the JAX package to.  Each JAX output is made once per module and
shared.
"""

import functools

import numpy as np
import pytest
import torch

import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu import api as japi
from range_coder_rust_tpu import rans_codec as jax_codec
from range_coder_rust_tpu.models.table import table_from_data_pow2
from range_coder_rust_tpu_torch import format as fmt
from range_coder_rust_tpu_torch import kernels
from range_coder_rust_tpu_torch import rans_codec as t_codec
from range_coder_rust_tpu_torch.errors import ChecksumMismatch, ConfigError
from range_coder_rust_tpu_torch.testing import zipf

torch.set_num_threads(1)

#: 1024-lane groups: tiles of 64 steps, so L = 192 is 3 tiles
G, L = 1024, 192


@functools.lru_cache(maxsize=None)
def _jax_syncs(sync_tiles):
    """(rows, per-group tables, JAX payloads) of two groups, one table
    each, with sync period ``sync_tiles``."""
    rows = np.concatenate([zipf(G * L, 256, 31),
                           zipf(G * L, 50, 32) * 3]).reshape(-1, L)
    tables = [table_from_data_pow2(rows[i : i + G], 256, 16)
              for i in (0, G)]
    return rows, tables, jax_codec.encode_groups(rows, tables, L, sync_tiles,
                                                 group_lanes=G)


@pytest.mark.parametrize("sync_tiles,n_sync", [(1, 2), (2, 1), (3, 0)])
def test_plain_encode_syncs_match_jax_kernel(sync_tiles, n_sync):
    rows, tables, payloads = _jax_syncs(sync_tiles)
    cum = t_codec.cum_table(np.stack([t.cum for t in tables]), "cpu")
    states, sizes, region, syncs = kernels.rans_encode_plain(
        t_codec._upload_rows(rows, "cpu"), cum, group_lanes=G, tile=64,
        sync_tiles=sync_tiles)
    assert syncs.shape == (2, n_sync, G) and syncs.dtype == torch.int64
    sync6 = t_codec._states6(syncs, 2)
    for gi, p in enumerate(payloads):
        j_sizes, j_pre6, _, j_sync_t, j_sync6 = jax_codec._parse_payload(
            p, L, G, full=True)
        assert j_sync_t == (sync_tiles if n_sync else 0)
        assert sync6[gi].tobytes() == bytes(j_sync6)
        np.testing.assert_array_equal(sizes[gi].numpy(), j_sizes)
    # the port's payloads are the JAX kernel's, sync section and all
    got = t_codec.encode_groups(rows, tables, L, G, sync_tiles=sync_tiles,
                                device="cpu")
    assert got == payloads


def test_sync_state_starts_a_decode_mid_group():
    """Decoding tiles [1, 3) of group 1 from its first sync state gives
    those steps of its rows."""
    rows, tables, payloads = _jax_syncs(1)
    tc = tables[1].c
    for lo, hi in [(64, 192), (64, 65), (100, 130)]:
        got, step0 = t_codec.decode_tile_range(payloads[1], tc, L, lo, hi, G,
                                               device="cpu")
        assert step0 == (lo // 64) * 64
        np.testing.assert_array_equal(
            got, rows[G:, step0 : step0 + got.shape[1]])
        assert got.shape[1] == -(-hi // 64) * 64 - step0


#: name -> (n symbols, config keywords)
CONTAINERS = {
    "sync1_partial_last_group": (G * L + 555, dict(sync_tiles=1)),
    "sync3_no_sync_section": (G * L + 7, dict(sync_tiles=3)),
    "per_group_sync1_partial": (2 * G * L - 5, dict(sync_tiles=1,
                                                     per_group_tables=True)),
}


@functools.lru_cache(maxsize=None)
def _containers(name):
    """(data, JAX container, port container)."""
    n, kw = CONTAINERS[name]
    data = zipf(n, 256, n % 1000)
    cfg = dict(profile="rans16", block_len=L, group_lanes=G, **kw)
    return (data,
            japi.encode(data, alphabet=256, config=japi.CodecConfig(**cfg)),
            rt.encode(data, alphabet=256, config=rt.CodecConfig(**cfg),
                      device="cpu"))


@pytest.mark.parametrize("name", list(CONTAINERS))
def test_sync_container_bytes_equal(name):
    data, jblob, tblob = _containers(name)
    assert tblob == jblob
    np.testing.assert_array_equal(
        rt.decode(jblob, device="cpu").astype(np.int32), data)


def test_sync_section_only_when_there_are_sync_states():
    """sync_tiles >= NT writes the plain payload: the container equals
    the one without sync points."""
    data, _, tblob = _containers("sync3_no_sync_section")
    cfg = rt.CodecConfig(profile="rans16", block_len=L, group_lanes=G)
    assert tblob == rt.encode(data, alphabet=256, config=cfg, device="cpu")


def test_sync_overhead_is_six_bytes_a_lane_a_sync():
    data, _, tblob = _containers("sync1_partial_last_group")
    cfg = rt.CodecConfig(profile="rans16", block_len=L, group_lanes=G)
    plain = rt.encode(data, alphabet=256, config=cfg, device="cpu")
    n_groups = fmt.unpack(tblob).n_blocks
    assert len(tblob) - len(plain) == n_groups * (2 * 6 * G + 4)


def test_jax_decodes_port_sync_container():
    data, _, tblob = _containers("per_group_sync1_partial")
    np.testing.assert_array_equal(
        np.asarray(japi.decode(tblob)).astype(np.int32), data)


@pytest.mark.parametrize("name", list(CONTAINERS))
def test_decode_range_of_sync_containers(name):
    data, _, tblob = _containers(name)
    n = data.size
    for start, count in [(0, 100), (64 * 3 - 3, 10), (L - 5, 10),
                         (G * L - 3, 10), (n - 40, 40), (L * 7 + 64, 64)]:
        got = rt.api.decode_range(tblob, start, count, device="cpu")
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, data[start : start + count])


@pytest.mark.parametrize("cfg", [
    dict(profile="rans16", block_len=64),
    dict(profile="rans16", block_len=256, sync_tiles=2),
    dict(profile="rans16", block_len=64, per_group_tables=True),
])
def test_decode_range_matches_slices(cfg):
    data = zipf(300_000, 256, 7)
    blob = rt.encode(data, alphabet=256, config=rt.CodecConfig(**cfg),
                     device="cpu")
    for start, count in [(0, 100), (131072, 4096), (299_000, 1000),
                         (65536 - 7, 20), (123, 0)]:
        got = rt.api.decode_range(blob, start, count, device="cpu")
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, data[start : start + count])


def test_decode_range_ignores_corruption_elsewhere():
    """Corrupting group j does not change decode_range inside group
    i != j, and is caught when the range covers group j."""
    data = zipf(300_000, 256, 11)
    cfg = rt.CodecConfig(profile="rans16", block_len=64)
    blob = bytearray(rt.encode(data, alphabet=256, config=cfg, device="cpu"))
    blob[-3] ^= 0x40  # the last group's payload
    blob = bytes(blob)
    with pytest.raises(ChecksumMismatch):
        rt.decode(blob, device="cpu")
    got = rt.api.decode_range(blob, 0, 1000, device="cpu")
    np.testing.assert_array_equal(got, data[:1000])
    with pytest.raises(ChecksumMismatch):
        rt.api.decode_range(blob, 299_600, 400, device="cpu")


def test_decode_range_bounds():
    data = zipf(10_000, 256, 13)
    blob = rt.encode(data, alphabet=256,
                     config=rt.CodecConfig(profile="rans16"), device="cpu")
    with pytest.raises(ConfigError):
        rt.api.decode_range(blob, 9_000, 2_000, device="cpu")
    with pytest.raises(ConfigError):
        rt.api.decode_range(blob, -1, 10, device="cpu")


def test_decode_range_zero_count_at_end():
    span = 128 * 3 * 2
    data = zipf(span, 256, 2)
    blob = rt.encode(data, alphabet=256, config=rt.CodecConfig(
        profile="rans16", block_len=3, group_lanes=128), device="cpu")
    for start in (span, 0):
        got = rt.api.decode_range(blob, start, 0, device="cpu")
        assert got.size == 0 and got.dtype == np.int32


def test_tile_range_never_decodes_the_rest_of_the_group():
    """A slice read from a sync point decodes exactly even when the
    group's last tile is zeroed: those tiles are parsed, never decoded."""
    data, _, tblob = _containers("sync1_partial_last_group")
    cont = fmt.unpack(tblob)
    sizes, pre6, region, sync_t, sync6 = t_codec._parse_payload(
        cont.payloads[0], L, G, full=True)
    assert sync_t == 1 and len(sync6) == 2 * 6 * G
    p = bytearray(cont.payloads[0])
    tail = len(p) - 2 * int(sizes[-1])
    p[tail:] = bytes(len(p) - tail)
    rows, step0 = t_codec.decode_tile_range(
        bytes(p), np.asarray(cont.tables_c), L, 64, 69, G, device="cpu")
    assert step0 == 64 and rows.shape == (G, 64)
    want = data[: G * L].reshape(G, L)
    np.testing.assert_array_equal(rows[:, :5], want[:, 64:69])
