"""Sharded coding over several devices (``parallel.dist``) against the
single call and the JAX package's containers, on the CPU.

The CPU stands in for the cards: ``["cpu"] * 4`` is four shards on one
device.  Each sharded encode must give the unsharded call's outputs bit
for bit, its containers must equal the JAX package's, and the sharded
decodes must give the data back.  JAX outputs are computed once each."""

import numpy as np
import pytest
import torch

import jax

from range_coder_rust_tpu import api as japi
from range_coder_rust_tpu.parallel import dist as jdist
from range_coder_rust_tpu.parallel import multihost as jmh
from range_coder_rust_tpu_torch import api, blocks, kernels, rans_codec
from range_coder_rust_tpu_torch.models.table import table_from_data_pow2
from range_coder_rust_tpu_torch.parallel import (default_mesh,
                                                 make_sharded_codec,
                                                 make_sharded_rans16)
from range_coder_rust_tpu_torch.parallel.multihost import assemble_container
from range_coder_rust_tpu_torch.testing import zipf

torch.set_num_threads(1)

DEVICES = ["cpu"] * 4
G, L16, NG = 128, 32, 4


def test_default_mesh():
    """Devices given are kept, repeats included; without them it is every
    card, and without a card it raises (it never picks the CPU)."""
    assert default_mesh(DEVICES) == [torch.device("cpu")] * 4
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in default_mesh())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_mesh()


def test_sharded_planar_equals_single_call_and_jax():
    k, L, B, A = 12, 128, 16, 32
    data = np.random.default_rng(9).integers(0, A, (B, L)).astype(np.int32)
    t = table_from_data_pow2(data, A, k)
    cap = blocks.default_capacity(L, k)
    c = torch.from_numpy(t.c.astype(np.int64))
    cum = torch.from_numpy(t.cum.astype(np.int64))
    rows = torch.from_numpy(data).long()
    enc, dec = make_sharded_codec(DEVICES, k=k, block_len=L, capacity=cap)
    code, lengths = enc(rows, c, cum)
    code1, lengths1 = blocks.encode_blocks(rows, c, cum, k=k, capacity=cap)
    assert torch.equal(code, code1) and torch.equal(lengths, lengths1)
    np.testing.assert_array_equal(dec(code, c, cum).numpy(), data)

    mesh = jdist.default_mesh(jax.devices()[:4])
    jenc, _ = jdist.make_sharded_codec(mesh, k=k, block_len=L, capacity=cap)
    jcode, jlengths = jenc(jax.device_put(data, jdist.block_sharding(mesh)),
                           jax.device_put(t.c, jdist.replicated(mesh)),
                           jax.device_put(t.cum, jdist.replicated(mesh)))
    kw = dict(k=k, alphabet=A, block_len=L, n_symbols=B * L, tables_c=t.c)
    blob = assemble_container(code.numpy(), lengths.numpy(), **kw)
    assert blob == jmh.assemble_container(np.asarray(jcode),
                                          np.asarray(jlengths), **kw)
    assert blob == api.encode(data.reshape(-1), alphabet=A,
                              config=api.CodecConfig(k=k, block_len=L),
                              device="cpu")


def _rans16_data(per_group: bool) -> np.ndarray:
    if not per_group:
        return zipf(NG * G * L16, 200, 31)
    # a different distribution per group
    return np.concatenate([(13 * g + zipf(G * L16, 40, 32 + g)) % 256
                           for g in range(NG)]).astype(np.int32)


@pytest.mark.parametrize("per_group", [False, True])
def test_sharded_rans16_equals_single_call_and_jax(per_group, monkeypatch):
    """The sharded kernels give the single call's (states, sizes, region,
    syncs) and decode; plugged into ``rans_codec`` in place of the kernel
    wrappers they write the JAX package's container and read it back."""
    data = _rans16_data(per_group)
    rows = data.reshape(NG * G, L16)
    if per_group:
        cum = rans_codec.cum_table(np.stack(
            [table_from_data_pow2(rows[i * G : (i + 1) * G], 256, 16).cum
             for i in range(NG)]), "cpu")
    else:
        cum = rans_codec.cum_table(
            table_from_data_pow2(rows, 256, 16).cum, "cpu")
    enc, dec = make_sharded_rans16(DEVICES, block_len=L16, a_count=256,
                                   per_group_tables=per_group)
    rows_t = torch.from_numpy(rows.astype(np.uint8))
    kw = dict(group_lanes=G, tile=L16)
    states, sizes, region, syncs = enc(rows_t, cum, **kw)
    one = kernels.rans_encode_tiled(rows_t, cum, **kw)
    n = int(one[1].sum())
    assert region.numel() == n
    for got, want in zip((states, sizes, region, syncs),
                         (one[0], one[1], one[2][:n], one[3])):
        assert torch.equal(got, want)
    grp_off = torch.cat([torch.zeros(1, dtype=torch.int64),
                         sizes.sum(1).cumsum(0)])
    out = dec(states, region, grp_off, cum, group_lanes=G,
              out_dtype=torch.uint8)
    np.testing.assert_array_equal(out.numpy(), rows)

    monkeypatch.setattr(rans_codec, "rans_encode_tiled", enc)
    monkeypatch.setattr(
        rans_codec, "rans_decode_tiled",
        lambda *a, block_len, a_count, **k: dec(*a, **k))
    cfg = dict(profile="rans16", block_len=L16, group_lanes=G,
               per_group_tables=per_group)
    blob = api.encode(data, alphabet=256, config=api.CodecConfig(**cfg),
                      device="cpu")
    assert blob == japi.encode(data, alphabet=256,
                               config=japi.CodecConfig(**cfg))
    np.testing.assert_array_equal(api.decode(blob, device="cpu"), data)


def test_sharded_units_must_divide_evenly():
    """Three groups or blocks over two shards raise the reference's
    ``ValueError``."""
    enc, dec = make_sharded_rans16(["cpu"] * 2, block_len=8, a_count=4)
    cum = rans_codec.cum_table(np.array([0, 1 << 14, 1 << 15, 3 << 14,
                                         1 << 16]), "cpu")
    with pytest.raises(ValueError, match="3 groups not divisible by 2"):
        enc(torch.zeros((3 * 128, 8), dtype=torch.uint8), cum,
            group_lanes=128, tile=8)
    penc, _ = make_sharded_codec(["cpu"] * 2, k=8, block_len=8, capacity=64)
    with pytest.raises(ValueError, match="3 blocks not divisible by 2"):
        penc(torch.zeros((3, 8), dtype=torch.int64),
             torch.full((4,), 64, dtype=torch.int64),
             torch.arange(5, dtype=torch.int64) * 64)
