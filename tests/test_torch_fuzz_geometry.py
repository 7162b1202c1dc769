"""A randomized sweep of the port's rans16 profile that crosses the
geometry axes of the JAX package's sweep (``tests/test_fuzz_geometry.py``,
whose ``_draw_case`` draws every case here): group width, lane length
(sub-tile lengths that force a shrink, multi-tile lanes), alphabet
(non-pow2, leading and interior zero-frequency symbols, one symbol),
partial last group, ``per_group_tables`` and ``sync_tiles``.

Every case runs through the port on the CPU (the kernels' plain
versions): encode, an exact decode, and an exact ``decode_range`` of a
random slice.  Every group's final states, per-tile sizes, region
halfwords and sync states are held to the NumPy spec
(``range_coder_rust_tpu/rans.py``) on that group's padded rows and
table.  The cases with the smallest ``g * L`` are also held byte for
byte to the JAX package's ``api.encode`` (one JAX container each).
"""

import functools

import numpy as np
import pytest
import torch

from range_coder_rust_tpu import api as japi
from range_coder_rust_tpu import rans as spec
import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu_torch import format as fmt
from range_coder_rust_tpu_torch import rans_codec
from test_fuzz_geometry import _draw_case

torch.set_num_threads(1)

N_CASES = 80
SHARDS = 5
#: cases also compared with the JAX package's container
N_JAX = 3
SEED = 0x70F022


@functools.lru_cache(maxsize=None)
def _cases() -> list:
    """``(g, L, a, pgt, sync, data, (start, count) or None)`` for every
    case, drawn once a process."""
    rng = np.random.default_rng(SEED)
    cases = []
    for _ in range(N_CASES):
        g, L, a, pgt, sync, data = _draw_case(rng)
        n = data.size
        span = None
        if n > 2:
            s0 = int(rng.integers(0, n - 1))
            span = (s0, int(rng.integers(1, min(n - s0, 300) + 1)))
        cases.append((g, L, a, pgt, sync, data.astype(np.int32), span))
    return cases


def _config(case, cls):
    g, L, _, pgt, sync, _, _ = case
    return cls(profile="rans16", block_len=L, per_group_tables=pgt,
               sync_tiles=sync, group_lanes=g)


@functools.lru_cache(maxsize=None)
def _port_blob(i: int) -> bytes:
    case = _cases()[i]
    return rt.encode(case[5], alphabet=case[2],
                     config=_config(case, rt.CodecConfig), device="cpu")


def _label(i: int) -> str:
    g, L, a, pgt, sync, data, _ = _cases()[i]
    return f"case={i} g={g} L={L} a={a} pgt={pgt} sync={sync} n={data.size}"


def _states6(states: np.ndarray) -> bytes:
    return states.astype("<u8").view(np.uint8).reshape(-1, 8)[:, :6].tobytes()


def _check_groups_against_spec(i: int, blob: bytes) -> None:
    """Each group's payload against ``spec.encode_lanes`` on its padded
    rows: final states, per-tile sizes, region halfwords, and each sync
    state (the spec's final state on the suffix from the sync's step)."""
    data = _cases()[i][5]
    cont = fmt.unpack(blob)
    g, L, ng = cont.group_lanes, cont.block_len, cont.n_blocks
    tables = np.asarray(cont.tables_c, np.uint32)
    # the codec pads with the most frequent symbol of a shared table, or
    # the last data symbol under per-group tables
    pad = (int(data[-1]) if cont.per_block_tables
           else int(np.argmax(tables)))
    rows = np.full(ng * g * L, pad, np.int64)
    rows[: data.size] = data
    rows = rows.reshape(ng * g, L)
    for gi, payload in enumerate(cont.payloads):
        sizes, pre6, region, sync_t, sync6 = rans_codec._parse_payload(
            payload, L, g, full=True)
        c = tables[gi] if cont.per_block_tables else tables
        cum = np.concatenate([[0], np.cumsum(c)]).astype(np.uint32)
        lanes = rows[gi * g : (gi + 1) * g]
        states, regions, counts = spec.encode_lanes(lanes, c, cum)
        where = f"{_label(i)} group {gi}"
        assert bytes(pre6) == _states6(states), where
        nt = sizes.size
        np.testing.assert_array_equal(
            sizes, counts.reshape(nt, L // nt).sum(1), err_msg=where)
        assert bytes(region) == np.concatenate(regions).astype(
            "<u2").tobytes(), where
        tile = L // nt
        for j in range(1, (nt - 1) // sync_t + 1 if sync_t else 1):
            want = spec.encode_lanes(lanes[:, j * sync_t * tile :], c, cum)[0]
            got = bytes(sync6[(j - 1) * 6 * g : j * 6 * g])
            assert got == _states6(want), f"{where} sync {j}"


@pytest.mark.parametrize("shard", range(SHARDS))
def test_port_fuzz_geometry(shard):
    for i in range(shard, N_CASES, SHARDS):
        data, span = _cases()[i][5], _cases()[i][6]
        blob = _port_blob(i)
        out = rt.decode(blob, device="cpu")
        np.testing.assert_array_equal(out, data, err_msg=_label(i))
        if span is not None:
            s0, cnt = span
            got = rt.api.decode_range(blob, s0, cnt, device="cpu")
            np.testing.assert_array_equal(
                got, data[s0 : s0 + cnt],
                err_msg=f"{_label(i)} range [{s0}, {s0 + cnt})")
        _check_groups_against_spec(i, blob)


def _smallest() -> list:
    """The cases with the smallest ``g * L``, first the smallest."""
    return sorted(range(N_CASES),
                  key=lambda i: (_cases()[i][0] * _cases()[i][1], i))[:N_JAX]


@pytest.mark.parametrize("rank", range(N_JAX))
def test_port_fuzz_matches_jax_container(rank):
    i = _smallest()[rank]
    case = _cases()[i]
    want = japi.encode(case[5], alphabet=case[2],
                       config=_config(case, japi.CodecConfig))
    assert _port_blob(i) == want, _label(i)
