"""The planar kernels' wrappers (``kernels/planar.py``) on CPU tensors, held
byte for byte to the JAX package's planar coder, on the CPU.

On the CPU each wrapper runs its plain version; the same inputs, made
from a numpy seed, go through the JAX package's ``blocks.encode_blocks``
/ ``encode_blocks_div`` / ``decode_blocks`` / ``decode_blocks_div`` and
``adaptive.encode_scan_adaptive`` / ``decode_blocks_adaptive`` (jitted).
Four variants, B = 64 blocks of L = 64: a pow2 shared table on u8
symbols, a raw total on int32 symbols, per-block tables, and one alphabet
past 2^15 as int16 (u16 bits), int32 and int64 rows.  No tolerance: code
bytes, lengths and symbols must be equal.  Also: the capacity-overflow
contract, the argument checks, and that no planar path calls the plain
loops directly.  The kernels themselves are held to these plain
versions on the card (``tests/test_torch_kernels_gpu.py``)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from range_coder_rust_tpu import adaptive as jad
from range_coder_rust_tpu import blocks as jblocks
from range_coder_rust_tpu_torch import kernels
from range_coder_rust_tpu_torch.adaptive import block_tables
from range_coder_rust_tpu_torch.blocks import default_capacity
from range_coder_rust_tpu_torch.kernels.planar import (planar_decode_blocks,
                                                       planar_encode_blocks)
from range_coder_rust_tpu_torch.models.table import table_from_data_pow2

torch.set_num_threads(1)

B, L = 64, 64
VARIANTS = ["pow2_shared_u8", "raw_total_i32", "per_block_k12",
            "wide_alphabet_widths"]
_CACHE = {}


def _variant(name: str):
    """(rows at each width to test, the symbol indices, c, cum (int64
    numpy), {k|total}, capacity, JAX (code, lengths, decoded)) for a
    variant, each JAX output made once."""
    if name in _CACHE:
        return _CACHE[name]
    r = np.random.default_rng(VARIANTS.index(name) + 40)
    if name == "pow2_shared_u8":
        rows = (r.zipf(1.3, (B, L)) % 256).astype(np.uint8)
        rows[3, :50] = 255  # a rare symbol in a run: c = 1 steps
        t = table_from_data_pow2(rows, 256, 16)
        c, cum, kw = t.c.astype(np.int64), t.cum.astype(np.int64), {"k": 16}
        widths = {"uint8": rows}
    elif name == "raw_total_i32":
        rows = r.integers(0, 40, (B, L)).astype(np.int32)
        c = np.bincount(rows.reshape(-1), minlength=41).astype(np.int64) * 3
        c[40] = 1  # an absent symbol keeps a count: total 3 * B * L + 1
        cum = np.concatenate([[0], c.cumsum()])
        kw = {"total": int(cum[-1])}
        widths = {"int32": rows}
    elif name == "per_block_k12":
        rows = (r.zipf(1.2, (B, L)) % 200).astype(np.int32)
        rows[::7] = r.integers(0, 200, (len(rows[::7]), L))
        ct, cumt = block_tables(torch.from_numpy(rows), alphabet=200, k=12)
        c, cum, kw = ct.numpy(), cumt.numpy(), {"k": 12}
        widths = {"int32": rows}
    else:
        # an alphabet past 2^15: the int16 rows hold u16 bits
        spread = np.sort(r.choice(33000, 300, replace=False))
        spread[-5:] = [32767, 32768, 32769, 40000, 65535]
        rows = spread[r.zipf(1.3, (B, L)) % 300].astype(np.uint16)
        t = table_from_data_pow2(rows, 65536, 16)
        c, cum, kw = t.c.astype(np.int64), t.cum.astype(np.int64), {"k": 16}
        widths = {"int16": rows.view(np.int16), "int32": rows.astype(np.int32),
                  "int64": rows.astype(np.int64)}
    cap = default_capacity(L, 16) if "total" not in kw else 6 * L + 8
    values = next(iter(widths.values()))
    if values.dtype == np.int16:
        values = values.view(np.uint16)
    values = values.astype(np.int32)  # the symbol indices
    jrows = jnp.asarray(values)
    jc = jnp.asarray(c.astype(np.uint32))
    jcum = jnp.asarray(cum.astype(np.uint32))
    if "total" in kw:
        jcode, jlen = jblocks.encode_blocks_div(jrows, jc, jcum, kw["total"],
                                                capacity=cap)
        jdec = jblocks.decode_blocks_div(jcode, jc, jcum, kw["total"],
                                         block_len=L)
    elif c.ndim == 2:
        ehi, elo, en, pos, jlen = jad.encode_scan_adaptive(jrows, jc, jcum,
                                                           k=kw["k"])
        jcode = jblocks.compact_emissions(ehi, elo, en, pos, capacity=cap)
        jdec = jad.decode_blocks_adaptive(jcode, jc, jcum, k=kw["k"],
                                          block_len=L)
    else:
        jcode, jlen = jblocks.encode_blocks(jrows, jc, jcum, k=kw["k"],
                                            capacity=cap)
        jdec = jblocks.decode_blocks(jcode, jc, jcum, k=kw["k"], block_len=L)
    _CACHE[name] = (widths, values, c, cum, kw, cap,
                    (np.asarray(jcode), np.asarray(jlen), np.asarray(jdec)))
    return _CACHE[name]


@pytest.mark.parametrize("name", VARIANTS)
def test_wrappers_equal_jax(name):
    """Code bytes and lengths equal the JAX package's for every row width,
    and the decode of the JAX code matrix equals the JAX decode and the
    rows."""
    widths, values, c, cum, kw, cap, (jcode, jlen, jdec) = _variant(name)
    ct, cumt = torch.from_numpy(c), torch.from_numpy(cum)
    for width, rows in widths.items():
        code, lengths = planar_encode_blocks(torch.from_numpy(rows), ct, cumt,
                                             capacity=cap, **kw)
        assert code.dtype == torch.uint8 and lengths.dtype == torch.int64
        np.testing.assert_array_equal(lengths.numpy(), jlen, width)
        np.testing.assert_array_equal(code.numpy(), jcode, width)
    dec = planar_decode_blocks(torch.from_numpy(jcode.copy()), ct, cumt,
                               block_len=L, **kw)
    assert dec.dtype == torch.int32 and dec.shape == (B, L)
    np.testing.assert_array_equal(dec.numpy(), jdec)
    np.testing.assert_array_equal(dec.numpy(), values)


def test_capacity_overflow_contract():
    """A capacity below the longest block: every length still counts all
    of its block's bytes, the bytes past the capacity are dropped (the
    rows are the JAX package's full rows cut there), and the rows hold
    zeros past each length."""
    widths, _, c, cum, kw, _, (jcode, jlen, _) = _variant("pow2_shared_u8")
    rows = torch.from_numpy(widths["uint8"])
    small = int(np.median(jlen)) // 4 * 4
    assert (jlen > small).any() and (jlen < small).any()
    code, lengths = planar_encode_blocks(rows, torch.from_numpy(c),
                                         torch.from_numpy(cum),
                                         capacity=small, **kw)
    np.testing.assert_array_equal(lengths.numpy(), jlen)
    np.testing.assert_array_equal(code.numpy(), jcode[:, :small])
    for b in np.flatnonzero(jlen < small):
        assert not code[b, jlen[b]:].any()


def test_argument_checks_raise():
    """Each wrong argument raises ValueError, on the CPU as on the card,
    and no launch is counted."""
    kernels.reset_launch_counts()
    rows = torch.zeros((4, 8), dtype=torch.uint8)
    code = torch.zeros((4, 16), dtype=torch.uint8)
    c = torch.tensor([3, 1], dtype=torch.int64)
    cum = torch.tensor([0, 3, 4], dtype=torch.int64)
    bad_encode = [
        dict(symbols=rows.float()), dict(symbols=rows[0]),
        dict(c=c.int()), dict(cum=cum[:2]), dict(c=c[None].expand(3, 2)),
        dict(k=None), dict(k=2, total=4), dict(k=25), dict(k=None, total=0),
        dict(k=None, total=1 << 32), dict(capacity=-1),
        dict(symbols=rows.to("meta")),
    ]
    for bad in bad_encode:
        args = dict(symbols=rows, c=c, cum=cum, k=2, capacity=8)
        args.update(bad)
        with pytest.raises(ValueError):
            planar_encode_blocks(args.pop("symbols"), args.pop("c"),
                                 args.pop("cum"), **args)
    for bad in [dict(code=code.long()), dict(code=code[0]),
                dict(cum=cum[None].expand(4, 3)), dict(block_len=-1),
                dict(k=0), dict(code=code.to("meta"))]:
        args = dict(code=code, c=c, cum=cum, k=2, block_len=8)
        args.update(bad)
        with pytest.raises(ValueError):
            planar_decode_blocks(args.pop("code"), args.pop("c"),
                                 args.pop("cum"), **args)
    assert kernels.launch_counts() == {"rans_encode": 0, "rans_decode": 0,
                                       "planar_encode": 0, "planar_decode": 0,
                                       "planar_histogram": 0,
                                       "planar_compact": 0}


def test_planar_paths_call_only_the_wrappers():
    """No planar path of the port calls the plain loops directly: only the
    wrappers (through ``blocks.encode_blocks`` / ``decode_blocks``)
    choose between kernel and plain version."""
    pkg = Path(kernels.__file__).resolve().parent.parent
    paths = [pkg / "api.py", pkg / "adaptive.py", pkg / "bench.py",
             *sorted((pkg / "parallel").glob("*.py"))]
    plain = re.compile(r"\b(encode_scan\w*|compact_emissions|_decode_scan|"
                       r"planar_(en|de)code_plain)\b")
    for p in paths:
        hits = [ln for ln in p.read_text().splitlines() if plain.search(ln)]
        assert not hits, (p.name, hits)
