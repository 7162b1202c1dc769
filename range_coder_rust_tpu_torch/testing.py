"""Seeded inputs and the kernel-against-plain check, shared by the port's
tests and ``chip_smoke.py``.

:data:`KERNEL_CASES` names the small geometries every CUDA kernel is held
against its plain PyTorch version on: a 2048-lane group, an odd tile
length across two 128-lane groups, non-pow2 and wide alphabets, leading
zero-frequency symbols, a symbol with c > 2^15, two tiles per group,
several lanes per decode thread, and the decode kernel's edges: u16
symbols staged with a ragged last stage (L = 25), its direct-store
variant (a group too wide for the stage) with u8 and with u16 symbols,
the widest groups (32768 lanes: 32 lanes a decode thread, where ptxas
reports spills), a stream dense enough (8 bits/symbol) to outrun a ring
narrower than the worst case, and symbols of frequency 1 (c = 1, where
the encode's reciprocal divide takes q = x).  The cases of
:data:`CASE_OPTIONS` run with one table per group (a group of one symbol
among them, c = 2^16) and with sync points:
the encode's sync states are compared too, and the decode also runs from
a sync state over a sub-range of tiles, as ``decode_tile_range`` drives
it.  All outputs are integers, so every comparison is exact.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import kernels, rans_codec
from .models.table import table_from_data_pow2


def zipf(n: int, a: int, seed: int, alpha: float = 1.2,
         dtype=np.int32) -> np.ndarray:
    """``n`` Zipf(``alpha``) symbols over ``[0, a)`` from
    ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, a + 1) ** alpha
    p /= p.sum()
    return rng.choice(a, size=n, p=p).astype(dtype)


def make_corpus(n_bytes: int, seed: int = 0xC0) -> np.ndarray:
    """Zipf(1.2) bytes: the corpus generator of the JAX package's
    ``bench.py`` (``make_corpus``), as ``uint8``."""
    return zipf(n_bytes, 256, seed, dtype=np.uint8)


def mixed_corpus(n: int, seed: int = 5) -> np.ndarray:
    """Segments of very different statistics, shuffled at 64 KB scale: a
    copy of ``mixed_corpus`` in the JAX package's
    ``scripts/adaptive_bench.py`` (the adaptive mode's corpus)."""
    rng = np.random.default_rng(seed)
    segs = []
    per = 64 << 10
    kinds = ["zipf", "uniform", "skew", "runs"]
    for i in range(n // per):
        kind = kinds[i % 4]
        if kind == "zipf":
            r = np.arange(1, 257)
            p = 1.0 / r**1.3
            p /= p.sum()
            segs.append(rng.choice(256, size=per, p=p))
        elif kind == "uniform":
            segs.append(rng.integers(0, 256, per))
        elif kind == "skew":
            base = rng.integers(0, 200)
            segs.append((base + rng.geometric(0.3, per)) % 256)
        else:
            vals = rng.integers(0, 256, per // 64)
            segs.append(np.repeat(vals, 64))
    return np.concatenate(segs)[:n].astype(np.int32)


KERNEL_CASES = ["G2048_L64_NG2", "odd_tile_G128_L63", "A129", "A400", "A1023",
                "leading_zero_freq", "c_over_2^15", "G256_L512_two_tiles",
                "G4096_L16_two_lanes_per_thread", "G2048_L25_NG2_A400",
                "G8192_L24_direct_stores", "G4096_L32_uniform_ring_fallback",
                "c_1_rare_symbols", "G1024_L192_per_group_sync1",
                "G2048_L128_per_group_A400_sync2", "G128_L1536_sync1",
                "G4096_L16_A400_u16_direct_stores", "G32768_L16_widest"]

#: kernels_vs_plain's options for the cases that need them: one table per
#: group, and a sync period
CASE_OPTIONS = {
    "G1024_L192_per_group_sync1": dict(per_group=True, sync_tiles=1),
    "G2048_L128_per_group_A400_sync2": dict(per_group=True, sync_tiles=2),
    "G128_L1536_sync1": dict(sync_tiles=1),
}


def kernel_case(name: str) -> Tuple[np.ndarray, int, int]:
    """(rows ``(NG * G, L)`` int32, G, alphabet) of a named case."""
    g, L, ng, a = 128, 64, 2, 256
    if name == "G2048_L64_NG2":
        g = 2048
        data = zipf(ng * g * L, a, 1)
    elif name == "odd_tile_G128_L63":
        L = 63
        data = zipf(ng * g * L, a, 2)
    elif name in ("A129", "A400", "A1023"):
        a = int(name[1:])
        data = zipf(ng * g * L, a, a, alpha=0.9)
    elif name == "leading_zero_freq":
        data = zipf(ng * g * L, 240, 3) + 16  # symbols 0..15 absent
    elif name == "c_over_2^15":
        rng = np.random.default_rng(4)
        a = 32
        data = np.where(rng.random(ng * g * L) < 0.75, 5,
                        rng.integers(0, a, ng * g * L)).astype(np.int32)
    elif name == "G256_L512_two_tiles":
        g, L, ng = 256, 512, 1
        data = zipf(ng * g * L, a, 5)
    elif name == "G4096_L16_two_lanes_per_thread":
        g, L, ng = 4096, 16, 3
        data = zipf(ng * g * L, a, 6)
    elif name == "G2048_L25_NG2_A400":
        g, L, a = 2048, 25, 400
        data = zipf(ng * g * L, a, 7, alpha=0.9)
    elif name == "G8192_L24_direct_stores":
        g, L, ng = 8192, 24, 1
        data = zipf(ng * g * L, a, 8)
    elif name == "G4096_L32_uniform_ring_fallback":
        g, L, ng = 4096, 32, 1
        data = np.random.default_rng(9).integers(0, a, ng * g * L,
                                                 dtype=np.int32)
    elif name == "c_1_rare_symbols":
        # two symbols seen once in 2^16 get c = 1 (the encode's reciprocal
        # has no m for them); 250..253 are absent
        g, L, ng = 2048, 32, 1
        data = zipf(ng * g * L, 250, 10)
        data[5] = 255  # lane 0, step 5
        data[-1] = 254  # the last lane's first step of the backward chain
    elif name == "G1024_L192_per_group_sync1":
        # 3 tiles of 64 steps; group 1 is one symbol (its c is 2^16)
        g, L = 1024, 192
        data = np.concatenate([zipf(g * L, a, 11),
                               np.full(g * L, 7, np.int32)])
    elif name == "G2048_L128_per_group_A400_sync2":
        # 4 tiles of 32 steps; the groups' statistics differ
        g, L, a = 2048, 128, 400
        data = np.concatenate([zipf(g * L, a, 12, alpha=0.9),
                               399 - zipf(g * L, 300, 13, alpha=1.5)])
    elif name == "G128_L1536_sync1":
        g, L, ng = 128, 1536, 1  # 3 tiles of 512 steps
        data = zipf(ng * g * L, a, 14)
    elif name == "G4096_L16_A400_u16_direct_stores":
        # u16 symbols need 2-byte slots: the stage no longer fits at 4096
        g, L, a = 4096, 16, 400
        data = zipf(ng * g * L, a, 15, alpha=0.9)
    elif name == "G32768_L16_widest":
        # 8 tiles of 2 steps; 1024 decode threads of 32 lanes each
        g, L, ng = 32768, 16, 1
        data = zipf(ng * g * L, a, 16)
    else:
        raise KeyError(name)
    return data.reshape(-1, L), g, a


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.dtype} {tuple(a.shape)} vs "
                             f"{b.dtype} {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    d = a.to(torch.int64) - b.to(a.device, torch.int64)
    return int(d.abs().max())


def encode_err(kernel_out, plain_out) -> int:
    """Largest absolute difference between the kernel's and the plain
    version's ``(states, sizes, region, syncs)``.  The kernel's region
    buffer is sized for the worst case; its first ``sizes.sum()``
    halfwords count."""
    (st_k, sz_k, rg_k, sy_k), (st_p, sz_p, rg_p, sy_p) = kernel_out, plain_out
    n = int(sz_k.sum())
    return max(_max_abs(st_k, st_p), _max_abs(sz_k, sz_p),
               _max_abs(rg_k[:n], rg_p), _max_abs(sy_k, sy_p))


def decode_err(kernel_out: torch.Tensor, plain_out: torch.Tensor) -> int:
    """Largest absolute difference between two decodes' symbols."""
    return _max_abs(kernel_out, plain_out)


def _cums(rows: np.ndarray, g: int, a: int, per_group: bool) -> np.ndarray:
    """The cum (A+1,) of ``rows``, or one per group of ``g`` rows
    (NG, A+1)."""
    if not per_group:
        return table_from_data_pow2(rows, a, 16).cum
    return np.stack([table_from_data_pow2(rows[i : i + g], a, 16).cum
                     for i in range(0, rows.shape[0], g)])


def kernels_vs_plain(rows: np.ndarray, g: int, a: int, device, *,
                     per_group: bool = False, sync_tiles: int = 0):
    """Encode ``rows`` (at the codec's width: u8 for ``a <= 256``, else
    int16) and decode the result with each CUDA kernel on ``device`` and
    with its plain version on the CPU, from the same inputs; the decode
    starts from the plain encode's output.  ``per_group`` gives each group
    its own table; with ``sync_tiles`` the encode also records sync
    states, and the decode also runs from group 0's first sync state over
    the tiles up to the next sync point (or the end).

    Returns ``({kernel name: max_abs_err}, plain (states, sizes, region,
    syncs), plain symbols)``.  Raises ``AssertionError`` unless the plain
    decodes give ``rows`` back."""
    L = rows.shape[1]
    tile, nt = rans_codec._tile_geometry(L, g)
    cum_c = rans_codec.cum_table(_cums(rows, g, a, per_group), "cpu")
    cum_d = cum_c.to(device)
    # the rows at the codec's width (u8 or int16), as the main path
    # uploads them
    rows_c = rans_codec._upload_rows(
        rows.astype(np.uint8) if a <= 256 else rows, "cpu")
    kw = dict(group_lanes=g, tile=tile, sync_tiles=sync_tiles)
    enc_k = kernels.rans_encode_tiled(rows_c.to(device), cum_d, **kw)
    enc_p = kernels.rans_encode_tiled(rows_c, cum_c, **kw)
    st_p, sz_p, rg_p, sy_p = enc_p
    grp_off = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(sz_p.sum(1).numpy())]).astype(np.int64))
    out_np = rans_codec._np_dtype(a)
    kw = dict(group_lanes=g, block_len=L, a_count=a,
              out_dtype=rans_codec._TORCH_OUT[out_np])
    dec_k = kernels.rans_decode_tiled(
        st_p.to(device), rg_p.to(device), grp_off.to(device), cum_d, **kw)
    dec_p = kernels.rans_decode_tiled(st_p, rg_p, grp_off, cum_c, **kw)
    back = dec_p.numpy().view(out_np).astype(np.int32)
    if not np.array_equal(back, rows):
        raise AssertionError("plain decode does not give the rows back")
    errs = {"rans_encode": encode_err(enc_k, enc_p),
            "rans_decode": decode_err(dec_k, dec_p)}
    if sy_p.shape[1]:
        # group 0 from sync 1 (before time-tile T) through the tile before
        # sync 2, as decode_tile_range hands it to the decode
        t0, t1 = sync_tiles, min(2 * sync_tiles, nt)
        sizes0 = sz_p[0].to(torch.int64)
        lo, hi = int(sizes0[:t0].sum()), int(sizes0[:t1].sum())
        sub = (sy_p[0, 0], rg_p[lo:hi], torch.tensor([0, hi - lo]),
               cum_c[:1] if per_group else cum_c)
        kw["block_len"] = (t1 - t0) * tile
        sub_k = kernels.rans_decode_tiled(*(t.to(device) for t in sub), **kw)
        sub_p = kernels.rans_decode_tiled(*sub, **kw)
        back = sub_p.numpy().view(out_np).astype(np.int32)
        if not np.array_equal(back, rows[:g, t0 * tile : t1 * tile]):
            raise AssertionError("plain decode from a sync state does not "
                                 "give the rows back")
        errs["rans_decode"] = max(errs["rans_decode"],
                                  decode_err(sub_k, sub_p))
    return errs, enc_p, dec_p


#: the small geometries the planar kernels are held against their plain
#: versions on: k = 16 with a shared table in shared memory on u8 rows at
#: L = 512, a 4096-symbol u16 alphabet, a 65536-symbol one (its table read
#: from device memory), a raw total, a total of 1 (a one-symbol
#: alphabet: rpt is the whole range), per-block tables at k = 12, a forced
#: capacity overflow, an odd L with a capacity that is not a multiple of 4
#: (byte stores), a decode row width that is not one, and B = 300 blocks
#: (not a multiple of the 256-thread CTA) of odd L; every case's encode
#: also runs on its symbols as int32 and int64 rows, and every decode also
#: on the flat form (:func:`flat_payloads`: the payloads at odd offsets,
#: junk between them)
PLANAR_CASES = ["k16_shared_u8_L512", "A4096_u16", "A65536_device_table",
                "raw_total", "total_1", "per_block_k12",
                "capacity_overflow", "odd_L63_cap199", "decode_width_1021",
                "flat_odd_offsets", "k17_slots8", "k20_A100352_i32",
                "k24_A4096_u16"]


def planar_case(name: str) -> dict:
    """A named planar case: ``rows`` (B, L) at the width the codec uploads
    (u8, int16 holding u16 bits, int32), ``values`` (the symbol indices,
    int32), ``c`` / ``cum`` (int64 numpy; shared or per block),
    ``total`` ({"k": k} or {"total": t}), the encode's ``capacity`` and
    the decode's row ``width``."""
    from .blocks import default_capacity, upload_rows
    from .models.table import build_table_pow2, normalize_pow2

    B, L, k, a = 128, 64, 16, 256
    cap = width = None
    if name == "k16_shared_u8_L512":
        B, L = 256, 512
        values = zipf(B * L, a, 21)
    elif name == "A4096_u16":
        a = 4096
        values = zipf(B * L, a, 22, alpha=0.9)
    elif name == "A65536_device_table":
        a = 65536
        values = zipf(B * L, a, 23, alpha=0.8)
        values[::97] = 65535
    elif name == "raw_total":
        values = zipf(B * L, 100, 24)
    elif name == "total_1":
        a, values = 1, np.zeros(B * L, np.int32)
    elif name == "per_block_k12":
        k = 12
        values = zipf(B * L, a, 25)
        values[: 8 * L] = np.random.default_rng(25).integers(0, a, 8 * L)
    elif name == "capacity_overflow":
        values = zipf(B * L, a, 26, alpha=0.6)
        cap = 40  # about half a block: most rows cut
    elif name == "odd_L63_cap199":
        L = 63
        values = zipf(B * L, a, 27)
        cap = 199
    elif name == "decode_width_1021":
        L = 500
        values = zipf(B * L, a, 28, alpha=0.6)
        width = 1021
    elif name == "flat_odd_offsets":
        B, L = 300, 61
        values = zipf(B * L, a, 29)
    elif name == "k17_slots8":  # the wide quotient beside a u8 slot table
        k = 17
        values = zipf(B * L, a, 30)
    elif name == "k20_A100352_i32":  # int32 rows, the table in memory
        k, a = 20, 100352
        values = zipf(B * L, a, 31, alpha=1.0)
        values[::89] = a - 1
    elif name == "k24_A4096_u16":  # the widest total, pairs staged
        k, a = 24, 4096
        values = zipf(B * L, a, 32, alpha=0.9)
    else:
        raise KeyError(name)
    values = values.reshape(B, L)
    if name in ("raw_total", "total_1"):
        c = (np.ones(1, np.int64) if name == "total_1" else
             np.bincount(values.reshape(-1), minlength=a).astype(np.int64))
        if name == "raw_total":
            c[-1] += 1  # total 8193: odd, not a power of two
        cum = np.concatenate([[0], c.cumsum()])
        total = {"total": int(cum[-1])}
    elif name == "per_block_k12":
        counts = np.stack([np.bincount(r, minlength=a) for r in values])
        c = normalize_pow2(torch.from_numpy(counts), k).numpy()
        cum = np.pad(c.cumsum(1), ((0, 0), (1, 0)))
        total = {"k": k}
    else:
        t = build_table_pow2(np.bincount(values.reshape(-1), minlength=a)
                             .astype(np.uint64), k)
        c, cum = t.c.astype(np.int64), t.cum.astype(np.int64)
        total = {"k": k}
    if cap is None:
        cap = (default_capacity(L, k) if "k" in total
               else -(-(6 * L + 8) // 4) * 4)
    host = values.astype(np.uint8 if a <= 256 else np.uint16 if a <= 65536
                         else np.int32)
    return {"rows": upload_rows(host, "cpu").numpy(), "values": values,
            "c": c, "cum": cum, "total": total, "capacity": cap,
            "width": width}


def flat_payloads(code: torch.Tensor, lengths: torch.Tensor, seed: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rows of a ``(B, C)`` code matrix as the decode's flat form:
    each row's first ``min(length, C)`` bytes, joined from byte 1 on with
    0 to 3 junk bytes (0xA5) before each and after the last, so the
    payloads start at odd and even offsets and a read past a payload's end
    would find junk.  Returns ``(flat uint8, offsets, lengths)`` (int64)
    on the CPU."""
    rows = code.cpu().numpy()
    lens = np.minimum(lengths.cpu().numpy(), rows.shape[1]).astype(np.int64)
    gaps = np.random.default_rng(seed).integers(0, 4, lens.size + 1)
    gaps[0] = 1
    offs = np.cumsum(gaps[:-1] + np.concatenate([[0], lens[:-1]]))
    flat = np.full(int(offs[-1] + lens[-1] + gaps[-1]), 0xA5, np.uint8)
    for row, off, n in zip(rows, offs, lens):
        flat[off : off + n] = row[:n]
    return (torch.from_numpy(flat), torch.from_numpy(offs),
            torch.from_numpy(lens))


def planar_vs_plain(name: str, device) -> dict:
    """Encode a planar case with the kernel on ``device`` (its rows at the
    codec's width, then widened to int32 and int64) and the plain version
    on the CPU, then decode the plain code matrix (cut to the case's row
    width) both ways, in the matrix form and in the flat form
    (:func:`flat_payloads`).  Returns ``{"planar_encode": max_abs_err
    of code bytes and lengths, "planar_decode": max_abs_err of the
    symbols}``.  Raises ``AssertionError`` unless the plain decode gives
    the symbols back where no row was cut, and the two forms' plain
    decodes agree."""
    case = planar_case(name)
    c, cum = torch.from_numpy(case["c"]), torch.from_numpy(case["cum"])
    rows = torch.from_numpy(case["rows"])
    kw, cap = case["total"], case["capacity"]
    L = rows.shape[1]
    code_k, len_k = kernels.planar_encode_blocks(
        rows.to(device), c.to(device), cum.to(device), capacity=cap, **kw)
    code_p, len_p = kernels.planar_encode_blocks(rows, c, cum, capacity=cap,
                                                 **kw)
    enc_err = max(_max_abs(code_k, code_p), _max_abs(len_k, len_p))
    values = torch.from_numpy(case["values"])
    for wide in (values, values.long()):
        code_w, len_w = kernels.planar_encode_blocks(
            wide.to(device), c.to(device), cum.to(device), capacity=cap, **kw)
        enc_err = max(enc_err, _max_abs(code_w, code_p),
                      _max_abs(len_w, len_p))
    width = case["width"] or cap
    code = code_p[:, :width].contiguous() if width <= cap else torch.cat(
        [code_p, code_p.new_zeros((code_p.shape[0], width - cap))], 1)
    dec_k = kernels.planar_decode_blocks(code.to(device), c.to(device),
                                         cum.to(device), block_len=L, **kw)
    dec_p = kernels.planar_decode_blocks(code, c, cum, block_len=L, **kw)
    whole = (len_p <= width).numpy()
    if not np.array_equal(dec_p.numpy()[whole], case["values"][whole]):
        raise AssertionError(f"{name}: plain decode does not give the "
                             "symbols back")
    flat, offs, lens = flat_payloads(code, len_p, PLANAR_CASES.index(name))
    flat_k = kernels.planar_decode_blocks(
        flat.to(device), c.to(device), cum.to(device), block_len=L,
        offsets=offs.to(device), lengths=lens.to(device), **kw)
    flat_p = kernels.planar_decode_blocks(flat, c, cum, block_len=L,
                                          offsets=offs, lengths=lens, **kw)
    if not torch.equal(flat_p, dec_p):
        raise AssertionError(f"{name}: the flat form's plain decode is not "
                             "the matrix form's")
    return {"planar_encode": enc_err,
            "planar_decode": max(_max_abs(dec_k, dec_p),
                                 _max_abs(flat_k, flat_p))}
