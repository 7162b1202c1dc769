"""The adaptive rans16 mode (one order-0 table per group) in the port
against the JAX package, on the CPU.

The plain kernels with ``(NG, 1024)`` tables must give the JAX encode
kernel's payloads (``(NG, 8, 128)`` tables, interpret mode) and decode
them; ``per_group_tables`` containers must be byte-equal to
``range_coder_rust_tpu.api.encode``'s, and each package must decode the
other's.  Each JAX output is made once per module and shared.
"""

import functools

import numpy as np
import pytest
import torch

import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu import api as japi
from range_coder_rust_tpu import errors as jerr
from range_coder_rust_tpu import rans_codec as jax_codec
from range_coder_rust_tpu.models.table import table_from_data_pow2
from range_coder_rust_tpu_torch import format as fmt
from range_coder_rust_tpu_torch import kernels
from range_coder_rust_tpu_torch import rans_codec as t_codec
from range_coder_rust_tpu_torch.errors import ConfigError
from range_coder_rust_tpu_torch.models.table import (
    table_from_data_pow2 as port_table)
from range_coder_rust_tpu_torch.testing import mixed_corpus, zipf

torch.set_num_threads(1)

G, L = 128, 64


def _group_rows(case):
    """(rows (NG*G, L) int32, alphabet): groups of different statistics."""
    if case == "A256_three_groups":
        a = 256
        data = np.concatenate([zipf(G * L, a, 21), zipf(G * L, 40, 22) + 200,
                               np.full(G * L, 9, np.int32)])
    else:  # "A400_two_groups"
        a = 400
        data = np.concatenate([zipf(G * L, a, 23, alpha=0.9),
                               399 - zipf(G * L, 100, 24)])
    return data.reshape(-1, L), a


@functools.lru_cache(maxsize=None)
def _jax_groups(case):
    """(rows, alphabet, per-group tables, JAX payloads)."""
    rows, a = _group_rows(case)
    tables = [table_from_data_pow2(rows[i : i + G], a, 16)
              for i in range(0, rows.shape[0], G)]
    return rows, a, tables, jax_codec.encode_groups(rows, tables, L,
                                                    group_lanes=G)


@pytest.mark.parametrize("case", ["A256_three_groups", "A400_two_groups"])
def test_plain_encode_per_group_tables_matches_jax_kernel(case):
    rows, a, tables, payloads = _jax_groups(case)
    cum = t_codec.cum_table(np.stack([t.cum for t in tables]), "cpu")
    assert cum.shape == (len(tables), 1024)
    states, sizes, region, syncs = kernels.rans_encode_tiled(
        t_codec._upload_rows(rows, "cpu"), cum, group_lanes=G, tile=L)
    assert syncs.shape == (len(tables), 0, G)
    region = region.numpy().view(np.uint16)
    off = 0
    for gi, p in enumerate(payloads):
        j_sizes, j_pre6, j_region = jax_codec._parse_payload(p, L, G)
        n = int(j_sizes.sum())
        np.testing.assert_array_equal(sizes[gi].numpy(), j_sizes)
        assert region[off : off + n].tobytes() == bytes(j_region)
        pre6 = t_codec._states6(states[gi * G : (gi + 1) * G], 1)[0]
        assert pre6.tobytes() == bytes(j_pre6)
        off += n


@pytest.mark.parametrize("case", ["A256_three_groups", "A400_two_groups"])
def test_plain_decode_per_group_tables(case):
    rows, a, tables, payloads = _jax_groups(case)
    tables_c = np.stack([t.c for t in tables])
    got = t_codec.decode_groups(payloads, tables_c, L, G, device="cpu")
    assert got.dtype == (np.uint8 if a <= 256 else np.uint16)
    np.testing.assert_array_equal(got.astype(np.int32), rows)


def test_plain_decode_per_group_tables_matches_jax_decode():
    rows, a, tables, payloads = _jax_groups("A400_two_groups")
    tables_c = np.stack([t.c for t in tables])
    want = jax_codec.decode_groups(payloads, tables_c, L, G)
    got = t_codec.decode_groups(payloads, tables_c, L, G, device="cpu")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_histogram_groups_is_exact():
    rows = np.concatenate([zipf(3 * 128 * 8, 400, 25)]).reshape(-1, 8)
    for up in (t_codec._upload_rows(rows, "cpu"),
               torch.from_numpy(rows.astype(np.uint8) % 200)):
        counts = t_codec._histogram_groups(up, 400, 3)
        flat = up.numpy().astype(np.int64).reshape(3, -1)
        want = np.stack([np.bincount(f, minlength=400) for f in flat])
        assert counts.dtype == np.uint64
        np.testing.assert_array_equal(counts, want)


#: name -> (n symbols, alphabet, config keywords)
CONTAINERS = {
    "partial_last_group": (2 * G * L + 777, 256, {}),
    "u16_alphabet": (G * L + 5, 400, {}),
    "empty": (0, 256, {}),
    "default_width_L32": (2048 * 32 * 2 + 99, 256,
                          dict(block_len=32, group_lanes=None)),
}


@functools.lru_cache(maxsize=None)
def _containers(name):
    """(data, alphabet, JAX container, port container)."""
    n, a, kw = CONTAINERS[name]
    data = mixed_corpus(max(n, 1) + (64 << 10))[:n] % a
    cfg = dict(profile="rans16", block_len=L, group_lanes=G,
               per_group_tables=True)
    cfg.update(kw)
    return (data, a,
            japi.encode(data, alphabet=a, config=japi.CodecConfig(**cfg)),
            rt.encode(data, alphabet=a, config=rt.CodecConfig(**cfg),
                      device="cpu"))


@pytest.mark.parametrize("name", list(CONTAINERS))
def test_per_group_container_bytes_equal(name):
    data, a, jblob, tblob = _containers(name)
    assert tblob == jblob
    cont = fmt.unpack(tblob)
    assert cont.per_block_tables and cont.n_symbols == data.size
    assert np.asarray(cont.tables_c).shape == (cont.n_blocks, a)


@pytest.mark.parametrize("name", list(CONTAINERS))
def test_port_decodes_jax_per_group_container(name):
    data, a, jblob, _ = _containers(name)
    out = rt.decode(jblob, device="cpu")
    assert out.dtype == (np.uint8 if a <= 256 else np.uint16)
    np.testing.assert_array_equal(out.astype(np.int32), data)


def test_jax_decodes_port_per_group_container():
    data, a, _, tblob = _containers("u16_alphabet")
    np.testing.assert_array_equal(
        np.asarray(japi.decode(tblob)).astype(np.int32), data)


def test_per_group_tables_ignores_a_supplied_table():
    """As in the reference's api, a supplied table is shared by all
    groups even with ``per_group_tables``."""
    data = zipf(3000, 64, 26)
    table = port_table(data, 64, 16)
    cfg = dict(profile="rans16", block_len=L, group_lanes=G)
    blob = rt.encode(data, config=rt.CodecConfig(per_group_tables=True,
                                                 **cfg),
                     table=table, device="cpu")
    assert blob == rt.encode(data, config=rt.CodecConfig(**cfg), table=table,
                             device="cpu")
    assert not fmt.unpack(blob).per_block_tables


def test_per_group_tables_refuse_wide_alphabets():
    data = np.arange(2000) % 1500
    with pytest.raises(jerr.ConfigError, match="per_group_tables"):
        japi.encode(data, config=japi.CodecConfig(profile="rans16",
                                                  per_group_tables=True))
    with pytest.raises(ConfigError, match="per_group_tables"):
        rt.encode(data, config=rt.CodecConfig(profile="rans16",
                                              per_group_tables=True),
                  device="cpu")
