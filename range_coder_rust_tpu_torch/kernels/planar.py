"""Planar block coder: the CUDA kernels' wrappers and their plain PyTorch
versions.

The reference has no Pallas kernel for the planar profile: its coder is
a ``jax.lax.scan`` that XLA compiles into one loop on the device
(``encode_scan`` / ``compact_emissions`` / ``encode_scan_div`` /
``decode_blocks`` / ``decode_blocks_div`` of
``range_coder_rust_tpu/blocks.py`` and ``encode_scan_adaptive`` /
``decode_blocks_adaptive`` of ``range_coder_rust_tpu/adaptive.py``).  On
the card that loop is ``csrc/planar_encode.cu`` and
``csrc/planar_decode.cu``, one thread a block with native u64 state
(``csrc/planar_step.cuh``); their headers say what bounds them.  The
plain versions are a Python loop over the ``L`` symbol positions that
advances every block's coder at once with the closed-form transition
(:mod:`..ops.transition`), each step a fixed chain of tensor ops.

Both versions take

* symbols ``(B, L)`` as ``uint8``, ``int16`` (u16 bits), ``int32`` or
  ``int64`` (the encode); the decode takes the payloads where they lie:
  a flat ``uint8`` buffer with ``offsets`` and ``lengths`` ``(B,)``
  int64 (block ``b`` is ``lengths[b]`` bytes at ``offsets[b]``, as the
  container holds them joined; an offset or length outside the buffer is
  cut to it), or a code matrix ``(B, C)`` ``uint8`` of any width ``C``
  (offsets ``b * C``, lengths ``C``);
* the table as int64 tensors: one shared, ``c (A,)`` and ``cum (A+1,)``,
  or one per block, ``(B, A)`` and ``(B, A+1)`` (the adaptive mode);
* the total: ``k`` for ``2**k`` (``k`` in [1, 24]) or ``total``, any u32
  (raw-count tables, the exact division);

and return ``(code (B, capacity) uint8, lengths (B,) int64)`` (the
encode; lengths with the 8 flush bytes, bytes past ``capacity`` dropped,
zeros past each length) or ``(B, block_len)`` int32 symbols (the decode).
Per block, the payload is byte-identical to the scalar coder's with the
same table (reference src/range_coder.rs:53-92).

The total takes one of three forms (:data:`TOTAL_FORMS`, the rule
:func:`total_form`, as ``planar::total_form`` of ``csrc/planar_step.cuh``
has it): ``pow2`` (``k`` up to 16: the kernel decode's target from a
float estimate), ``pow2_wide`` (``k`` in [17, 24]: from a double one;
the float estimate's error passes the one correction there) and ``raw``.
Each wrapper counts its calls by form in ``<wrapper>.totals``: a kernel
launch as the launch reported it, a plain version's call by the rule.

The encode's payloads leave the card joined: :func:`planar_compact`
writes each row's first ``lengths[b]`` bytes of the code matrix at
``offsets[b]`` of one flat area (``csrc/planar_compact.cu``; the plain
version a boolean-mask gather), so only payload bytes are copied to the
host.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from ..ops import lookup
from ..ops.transition import (decode_find_rfreq, decode_find_rfreq_div,
                              flush_state, init_state, param_update_div,
                              param_update_pow2)

#: symbol dtypes the encode kernel reads, and their bytes
SYMBOL_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4,
                torch.int64: 8}

#: where a launch finds its table, by the number the kernel reports
#: (``planar::Placement`` of ``csrc/planar_device.cuh``): a search of the
#: (cum, c) pairs in device memory or staged in shared memory, or the
#: decode's slot table of u8 or u16 slots
PLACEMENTS = ("global", "smem_pairs", "slots8", "slots16")

#: the form of a call's total, by the number the kernel reports
#: (``planar::TotalForm``): 2^k with the float quotient, 2^k with the
#: double quotient, a raw u32 total
TOTAL_FORMS = ("pow2", "pow2_wide", "raw")
#: the largest k of a total of 2^k (``planar::kMaxK``): ``range >> k``
#: stays at 2^24 or more under the coder's invariant range >= 2^48
MAX_K = 24
#: the largest k whose decode takes the float quotient
#: (``planar::kFloatMaxK``)
FLOAT_MAX_K = 16

#: elements of one compaction index (blocks x transitions x 8 bytes):
#: bounds its int64 index and byte tensors to 32 MiB and 4 MiB
_COMPACT_ELEMS = 1 << 22


def total_form(k: int) -> str:
    """The form of a total of ``2**k`` (``k = 0``: a raw total), as the
    kernels decide it (``planar::total_form``)."""
    return ("raw" if k == 0 else "pow2" if k <= FLOAT_MAX_K
            else "pow2_wide")


def _total_of(k: Optional[int], total: Optional[int]) -> Tuple[int, int]:
    """``(k, total)`` as the kernels take them: ``k`` in [1, 24] with
    ``total = 2**k``, or ``k = 0`` with any u32 ``total``."""
    if (k is None) == (total is None):
        raise ValueError("give exactly one of k and total")
    if k is not None:
        if not 1 <= k <= MAX_K:
            raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
        return k, 1 << k
    if not 1 <= total < 1 << 32:
        raise ValueError(f"total {total} is not a u32 >= 1")
    return 0, int(total)


def _check_tables(c: torch.Tensor, cum: torch.Tensor, n_blocks: int,
                  device: torch.device) -> int:
    """The alphabet size; raises unless ``c`` / ``cum`` are one shared
    int64 table or one per block on ``device``."""
    if c.dtype != torch.int64 or cum.dtype != torch.int64:
        raise ValueError("c and cum must be int64")
    a = c.shape[-1] if c.dim() else 0
    shared = c.dim() == 1 and cum.shape == (a + 1,)
    per_block = c.shape == (n_blocks, a) and cum.shape == (n_blocks, a + 1)
    if a < 1 or not (shared or per_block):
        raise ValueError(f"tables c {tuple(c.shape)} / cum "
                         f"{tuple(cum.shape)}: expected (A,) / (A+1,) or "
                         f"({n_blocks}, A) / ({n_blocks}, A+1)")
    if c.device != device or cum.device != device:
        raise ValueError("the tables and the blocks must be on one device")
    return a


def _check_encode(symbols: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                  capacity: int) -> int:
    if symbols.dim() != 2 or symbols.dtype not in SYMBOL_BYTES:
        raise ValueError(f"symbols must be 2-D uint8, int16, int32 or "
                         f"int64, got {symbols.dtype} "
                         f"{tuple(symbols.shape)}")
    if capacity < 0:
        raise ValueError(f"capacity {capacity} must be >= 0")
    return _check_tables(c, cum, symbols.shape[0], symbols.device)


def _check_decode(code: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                  block_len: int, offsets: Optional[torch.Tensor],
                  lengths: Optional[torch.Tensor]) -> Tuple[int, int]:
    """``(A, B)``; raises unless ``code`` is a ``(B, C)`` uint8 matrix
    (``offsets`` and ``lengths`` None) or a flat uint8 buffer with
    ``(B,)`` int64 ``offsets`` and ``lengths``, on the tables' device."""
    if (offsets is None) != (lengths is None):
        raise ValueError("give both offsets and lengths, or neither")
    if offsets is None:
        if code.dim() != 2 or code.dtype != torch.uint8:
            raise ValueError(f"code must be a 2-D uint8 matrix, got "
                             f"{code.dtype} {tuple(code.shape)}")
        n_blocks = code.shape[0]
    else:
        if code.dim() != 1 or code.dtype != torch.uint8:
            raise ValueError(f"flat code must be 1-D uint8, got {code.dtype} "
                             f"{tuple(code.shape)}")
        n_blocks = offsets.shape[0] if offsets.dim() == 1 else -1
        if (n_blocks < 0 or offsets.dtype != torch.int64
                or lengths.dtype != torch.int64
                or lengths.shape != offsets.shape):
            raise ValueError(f"offsets {offsets.dtype} "
                             f"{tuple(offsets.shape)} and lengths "
                             f"{lengths.dtype} {tuple(lengths.shape)} must "
                             f"be (B,) int64")
        if offsets.device != code.device or lengths.device != code.device:
            raise ValueError("offsets, lengths and code must be on one "
                             "device")
    if block_len < 0:
        raise ValueError(f"block_len {block_len} must be >= 0")
    return _check_tables(c, cum, n_blocks, code.device), n_blocks


# ----- the plain versions -------------------------------------------------


def _scan(cs: torch.Tensor, cums: torch.Tensor, update: Callable
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance every block's coder over its ``(L, B)`` step-major symbol
    frequencies, then flush.  Returns ``(emit, en, pos, lengths)``:
    ``(L + 1, B)`` emitted-low words (int64) and byte counts (int32),
    their exclusive prefix sums over the transitions, and the ``(B,)``
    payload lengths, flush included."""
    L, B = cs.shape
    st = init_state((B,), cs.device)
    emit = torch.empty((L + 1, B), dtype=torch.int64, device=cs.device)
    en = torch.empty((L + 1, B), dtype=torch.int32, device=cs.device)
    for i in range(L):
        st, emit[i], en[i] = update(st, cs[i], cums[i])
    emit[L], en[L] = flush_state(st)
    csum = en.cumsum(0, dtype=torch.int32)
    return emit, en, csum - en, csum[L].long()


def _step_major(table: torch.Tensor, symbols: torch.Tensor) -> torch.Tensor:
    idx = symbols.long()
    if symbols.dtype == torch.int16:
        idx &= 0xFFFF  # u16 bits
    return lookup.table_lookup(table, idx).T.contiguous()


def encode_scan(symbols: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                *, k: int):
    """Stage 1 of the plain encode for total ``2**k``: the emissions of
    ``(B, L)`` symbols (see :func:`_scan`)."""
    return _scan(_step_major(c, symbols), _step_major(cum[..., :-1], symbols),
                 lambda st, cc, cu: param_update_pow2(st, cc, cu, k))


def encode_scan_div(symbols: torch.Tensor, c: torch.Tensor,
                    cum: torch.Tensor, total: int):
    """:func:`encode_scan` for any u32 ``total`` (raw-count tables): the
    exact ``range // total`` of the reference (src/range_coder.rs:38-40)."""
    return _scan(_step_major(c, symbols), _step_major(cum[..., :-1], symbols),
                 lambda st, cc, cu: param_update_div(st, cc, cu, total))


def compact_emissions(emit: torch.Tensor, en: torch.Tensor, pos: torch.Tensor,
                      *, capacity: int) -> torch.Tensor:
    """Stage 2 of the plain encode: the ``(B, capacity)`` uint8 byte
    streams.  Transition ``i`` of a block owns bytes ``[pos[i], pos[i] +
    en[i])`` of its stream, the top ``en[i]`` bytes of ``emit[i]`` (zeros
    past the eighth), so one scatter writes each transition's top
    ``min(en, 8)`` bytes to ``pos + r``; bytes past ``capacity`` are
    dropped (the caller sees the block's length exceed it)."""
    L1, B = emit.shape
    dev = emit.device
    dump = B * capacity  # one extra slot takes every write that is dropped
    out = torch.zeros(dump + 1, dtype=torch.uint8, device=dev)
    r = torch.arange(8, device=dev)
    shifts = 56 - 8 * r
    per = max(1, _COMPACT_ELEMS // (L1 * 8))
    for b0 in range(0, B, per):
        b1 = min(B, b0 + per)
        e = emit[:, b0:b1, None]
        dst = pos[:, b0:b1, None].long() + r
        ok = (r < en[:, b0:b1, None]) & (dst < capacity)
        base = torch.arange(b0, b1, device=dev)[None, :, None] * capacity
        out[torch.where(ok, dst + base, dump).view(-1)] = (
            ((e >> shifts) & 0xFF).to(torch.uint8).view(-1))
    return out[:dump].view(B, capacity)


def planar_encode_plain(symbols: torch.Tensor, c: torch.Tensor,
                        cum: torch.Tensor, *, k: Optional[int] = None,
                        total: Optional[int] = None, capacity: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encode in plain PyTorch: :func:`encode_scan` (or
    :func:`encode_scan_div`), then :func:`compact_emissions`."""
    _check_encode(symbols, c, cum, capacity)
    k, total = _total_of(k, total)
    emit, en, pos, lengths = (encode_scan(symbols, c, cum, k=k) if k
                              else encode_scan_div(symbols, c, cum, total))
    return compact_emissions(emit, en, pos, capacity=capacity), lengths


def _decode_scan(code: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                 block_len: int, find_rfreq: Callable, update: Callable
                 ) -> torch.Tensor:
    """Decode ``block_len`` symbols of each ``(B, C)`` stream: window,
    target value, symbol search, and the encoder's own transition, whose
    byte count advances the cursor (reference src/decoder.rs:38-54)."""
    B = code.shape[0]
    windows = lookup.code_windows(code)
    cum_next = cum[..., 1:].contiguous()
    st = init_state((B,), code.device)
    start = torch.zeros(B, dtype=torch.int64, device=code.device)  # cursor-8
    out = torch.empty((block_len, B), dtype=torch.int32, device=code.device)
    for i in range(block_len):
        rfreq = find_rfreq(st, lookup.window_at(windows, start))
        idx = lookup.find_symbol(cum_next, rfreq)
        st, _, n = update(st, lookup.table_lookup(c, idx),
                          lookup.table_lookup(cum, idx))
        start += n
        out[i] = idx
    return out.T


def payload_rows(code: torch.Tensor, offsets: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """The flat form's payloads as a zero-padded ``(B, C)`` uint8 matrix,
    ``C`` the longest payload: offsets and lengths cut to the buffer as
    the kernel cuts them (an offset outside ``[0, N]`` reads as an empty
    payload)."""
    n = code.numel()
    bad = (offsets < 0) | (offsets > n)
    off = torch.where(bad, 0, offsets)
    ln = torch.minimum(torch.where(bad, 0, lengths).clamp(min=0), n - off)
    col = torch.arange(int(ln.max()) if ln.numel() else 0, device=code.device)
    keep = col < ln[:, None]
    rows = torch.zeros(keep.shape, dtype=torch.uint8, device=code.device)
    rows[keep] = code[(off[:, None] + col)[keep]]
    return rows


def planar_decode_plain(code: torch.Tensor, c: torch.Tensor,
                        cum: torch.Tensor, *, k: Optional[int] = None,
                        total: Optional[int] = None, block_len: int,
                        offsets: Optional[torch.Tensor] = None,
                        lengths: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The decode in plain PyTorch, one Python iteration a symbol (the flat
    form through :func:`payload_rows`)."""
    _check_decode(code, c, cum, block_len, offsets, lengths)
    k, total = _total_of(k, total)
    if offsets is not None:
        code = payload_rows(code, offsets, lengths)
    if k:
        return _decode_scan(
            code, c, cum, block_len,
            lambda st, w: decode_find_rfreq(st, w, k),
            lambda st, cc, cu: param_update_pow2(st, cc, cu, k))
    return _decode_scan(
        code, c, cum, block_len,
        lambda st, w: decode_find_rfreq_div(st, w, total),
        lambda st, cc, cu: param_update_div(st, cc, cu, total))


# ----- the wrappers ---------------------------------------------------------


def planar_encode_blocks(symbols: torch.Tensor, c: torch.Tensor,
                         cum: torch.Tensor, *, k: Optional[int] = None,
                         total: Optional[int] = None, capacity: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode ``(B, L)`` symbols into ``(code, lengths)``: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor.  See the module
    docstring."""
    if symbols.device.type == "cpu":
        out = planar_encode_plain(symbols, c, cum, k=k, total=total,
                                  capacity=capacity)
        planar_encode_blocks.totals[total_form(k or 0)] += 1
        return out
    if symbols.device.type != "cuda":
        raise ValueError(f"no planar encode for device {symbols.device}")
    a = _check_encode(symbols, c, cum, capacity)
    k, total = _total_of(k, total)
    # keep the contiguous tensors referenced until the launch is queued
    symbols, c, cum = symbols.contiguous(), c.contiguous(), cum.contiguous()
    B, L = symbols.shape
    dev = symbols.device
    code = torch.zeros((B, capacity), dtype=torch.uint8, device=dev)
    lengths = torch.empty(B, dtype=torch.int64, device=dev)
    if B == 0:
        return code, lengths
    from ._build import check, library

    placed, form = ctypes.c_int(-1), ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().rc_planar_encode(
            symbols.data_ptr(), SYMBOL_BYTES[symbols.dtype], c.data_ptr(),
            cum.data_ptr(), int(c.dim() == 2), a, k, total, code.data_ptr(),
            lengths.data_ptr(), B, L, capacity, stream, ctypes.byref(placed),
            ctypes.byref(form))
    check(err, "planar encode kernel")
    _count(planar_encode_blocks, placed.value, form.value)
    return code, lengths


def planar_decode_blocks(code: torch.Tensor, c: torch.Tensor,
                         cum: torch.Tensor, *, k: Optional[int] = None,
                         total: Optional[int] = None, block_len: int,
                         offsets: Optional[torch.Tensor] = None,
                         lengths: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Decode ``B`` payloads (a ``(B, C)`` code matrix, or a flat buffer
    with ``offsets`` and ``lengths``) into ``(B, block_len)`` int32
    symbols: the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor.  Like the reference, a payload carries no end marker: the
    container gives the symbol count."""
    if code.device.type == "cpu":
        out = planar_decode_plain(code, c, cum, k=k, total=total,
                                  block_len=block_len, offsets=offsets,
                                  lengths=lengths)
        planar_decode_blocks.totals[total_form(k or 0)] += 1
        return out
    if code.device.type != "cuda":
        raise ValueError(f"no planar decode for device {code.device}")
    a, B = _check_decode(code, c, cum, block_len, offsets, lengths)
    k, total = _total_of(k, total)
    code, c, cum = code.contiguous(), c.contiguous(), cum.contiguous()
    out = torch.empty((B, block_len), dtype=torch.int32, device=code.device)
    if B == 0:
        return out
    if offsets is None:
        row_bytes, offs_ptr, lens_ptr = code.shape[1], None, None
    else:
        offsets, lengths = offsets.contiguous(), lengths.contiguous()
        row_bytes, offs_ptr, lens_ptr = (0, offsets.data_ptr(),
                                         lengths.data_ptr())
    from ._build import check, library

    placed, form = ctypes.c_int(-1), ctypes.c_int(-1)
    with torch.cuda.device(code.device):
        stream = torch.cuda.current_stream(code.device).cuda_stream
        err = library().rc_planar_decode(
            code.data_ptr(), code.numel(), offs_ptr, lens_ptr, row_bytes,
            c.data_ptr(), cum.data_ptr(), int(c.dim() == 2), a, k, total,
            out.data_ptr(), B, block_len, stream, ctypes.byref(placed),
            ctypes.byref(form))
    check(err, "planar decode kernel")
    _count(planar_decode_blocks, placed.value, form.value)
    return out


def _count(wrapper, placed: int, form: int) -> None:
    """One launch of ``wrapper``'s kernel, at the table placement and
    the total form the kernel reported."""
    wrapper.placements[PLACEMENTS[placed]] += 1
    wrapper.totals[TOTAL_FORMS[form]] += 1


#: launches of the CUDA kernels (the plain versions do not count), by the
#: table placement each launch reported
planar_encode_blocks.placements = dict.fromkeys(PLACEMENTS, 0)
planar_decode_blocks.placements = dict.fromkeys(PLACEMENTS, 0)
#: calls by the form of their total: the kernel's launches as each
#: reported it, the plain version's by :func:`total_form`
planar_encode_blocks.totals = dict.fromkeys(TOTAL_FORMS, 0)
planar_decode_blocks.totals = dict.fromkeys(TOTAL_FORMS, 0)


def _check_compact(code: torch.Tensor, lengths: torch.Tensor,
                   offsets: torch.Tensor, size: int) -> None:
    if code.dim() != 2 or code.dtype != torch.uint8:
        raise ValueError(f"code must be a 2-D uint8 matrix, got "
                         f"{code.dtype} {tuple(code.shape)}")
    for name, t in (("lengths", lengths), ("offsets", offsets)):
        if t.dtype != torch.int64 or t.shape != code.shape[:1]:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} must be "
                             f"({code.shape[0]},) int64")
        if t.device != code.device:
            raise ValueError(f"{name} and code must be on one device")
    if size < 0:
        raise ValueError(f"size {size} must be >= 0")


def planar_compact_plain(code: torch.Tensor, lengths: torch.Tensor,
                         offsets: torch.Tensor, *, size: int) -> torch.Tensor:
    """The compaction in plain PyTorch: a boolean-mask gather of each
    row's first ``lengths[b]`` bytes, written at ``offsets[b]`` of a
    ``(size,)`` area, cut as the kernel cuts them (to the row and to the
    area; an offset outside ``[0, size]`` writes nothing).  Bytes no row
    covers read 0."""
    _check_compact(code, lengths, offsets, size)
    out = torch.zeros(size, dtype=torch.uint8, device=code.device)
    room = torch.where((offsets >= 0) & (offsets <= size), size - offsets, 0)
    ln = torch.minimum(lengths.clamp(min=0), room)
    col = torch.arange(code.shape[1], device=code.device)
    keep = col < ln[:, None]
    out[(offsets[:, None] + col)[keep]] = code[keep]
    return out


def planar_compact(code: torch.Tensor, lengths: torch.Tensor,
                   offsets: torch.Tensor, *, size: int) -> torch.Tensor:
    """Join the payloads of a ``(B, C)`` uint8 code matrix into one
    ``(size,)`` uint8 area: row ``b``'s first ``lengths[b]`` bytes at
    ``offsets[b]`` (``(B,)`` int64 each, on the matrix's device).  With
    ``offsets`` the exclusive prefix sum of ``lengths`` and ``size`` their
    sum, the area is the payloads in row order, as the container holds
    them.  The CUDA kernel for a CUDA tensor (bytes no row covers are left
    unwritten), the plain version for a CPU tensor."""
    if code.device.type == "cpu":
        return planar_compact_plain(code, lengths, offsets, size=size)
    if code.device.type != "cuda":
        raise ValueError(f"no planar compaction for device {code.device}")
    _check_compact(code, lengths, offsets, size)
    code, lengths, offsets = (code.contiguous(), lengths.contiguous(),
                              offsets.contiguous())
    out = torch.empty(size, dtype=torch.uint8, device=code.device)
    from ._build import check, library

    with torch.cuda.device(code.device):
        stream = torch.cuda.current_stream(code.device).cuda_stream
        err = library().rc_planar_compact(
            code.data_ptr(), code.shape[1], lengths.data_ptr(),
            offsets.data_ptr(), out.data_ptr(), size, code.shape[0], stream)
    check(err, "planar compaction kernel")
    planar_compact.launches += 1
    return out


#: launches of the CUDA kernel (the plain version does not count)
planar_compact.launches = 0
