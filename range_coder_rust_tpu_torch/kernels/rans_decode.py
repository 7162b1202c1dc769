"""rans16 decode: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``_rans_decode_kernel`` of
``range_coder_rust_tpu/kernels/rans_decode.py`` (wrapper
``rans_decode_tiled``).  The kernel is ``csrc/rans_decode.cu``; its header
says what bounds it on the H100 and what its design does about that, and
:func:`decode_plan` says which of its variants a shape runs.

Both versions take

* ``states`` ``(NG * G,)`` int64: the preamble, each lane's initial state;
* ``region`` int16: the groups' halfwords concatenated, group ``g`` at
  ``[grp_off[g], grp_off[g + 1])``;
* ``grp_off`` ``(NG + 1,)`` int64;
* ``cum``: the ``(1024,)`` int32 padded table
  (:func:`..kernels.vreg.prep_cum_vreg`), or one per group,
  ``(NG, 1024)`` (the adaptive mode);

and return the symbols, lane-major ``(NG * G, L)``, in ``out_dtype``
(``torch.uint8``, ``torch.int16`` holding u16 bits, or ``torch.int32``).
Per group this is exactly the NumPy spec :func:`..rans.decode_lanes`
(the port's copy of ``range_coder_rust_tpu/rans.py``),
whose symbol search is ``searchsorted(cum, slot, 'right') - 1``.  A lane
that would refill past its group's region reads 0 instead, and offsets
outside the region are clamped to it: a corrupt input decodes to garbage
and never reads outside its group.  The states are below 2^48 (the
container's preamble is 48-bit); the CUDA kernel's arithmetic relies on it.
"""

from __future__ import annotations

import torch

_OUT_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}


def _check_inputs(states, region, grp_off, cum, group_lanes, out_dtype):
    if states.dim() != 1 or states.dtype != torch.int64:
        raise ValueError("states must be 1-D int64")
    if region.dim() != 1 or region.dtype != torch.int16:
        raise ValueError("region must be 1-D int16")
    B = states.shape[0]
    if B == 0 or B % group_lanes or group_lanes % 128:
        raise ValueError(f"{B} lanes do not make groups of {group_lanes}")
    if (cum.shape not in ((1024,), (B // group_lanes, 1024))
            or cum.dtype != torch.int32):
        raise ValueError("cum must be the (1024,) or (NG, 1024) int32 "
                         "padded table")
    if grp_off.shape != (B // group_lanes + 1,) or grp_off.dtype != torch.int64:
        raise ValueError("grp_off must be (NG + 1,) int64")
    if out_dtype not in _OUT_BYTES:
        raise ValueError(f"unsupported output dtype {out_dtype}")
    devs = {t.device for t in (states, region, grp_off, cum)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def rans_decode_plain(states: torch.Tensor, region: torch.Tensor,
                      grp_off: torch.Tensor, cum: torch.Tensor, *,
                      group_lanes: int, block_len: int, a_count: int,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """The decode in plain PyTorch on int64, lane-vectorized, one Python
    iteration per step.  ``a_count`` is unused: the search runs over the
    whole padded table, whose sentinel no slot reaches."""
    _check_inputs(states, region, grp_off, cum, group_lanes, out_dtype)
    del a_count
    B = states.shape[0]
    ng = B // group_lanes
    dev = states.device
    cum64 = cum.to(torch.int64).expand(ng, 1024).contiguous()
    hw = region.to(torch.int64) & 0xFFFF
    if hw.numel() == 0:
        hw = torch.zeros(1, dtype=torch.int64, device=dev)
    x = states.view(ng, group_lanes).clone()
    out = torch.empty((ng, group_lanes, block_len), dtype=torch.int64,
                      device=dev)
    n_hw = region.numel()
    cursor = grp_off[:-1].clamp(0, n_hw)
    end = torch.maximum(grp_off[1:], cursor).clamp(max=n_hw)
    for t in range(block_len):
        slot = x & 0xFFFF
        s = torch.searchsorted(cum64, slot, right=True) - 1
        out[:, :, t] = s
        cs = torch.gather(cum64, 1, s)
        x = (torch.gather(cum64, 1, s + 1) - cs) * (x >> 16) + slot - cs
        refill = x < (1 << 32)
        rank = torch.cumsum(refill, dim=1) - refill.to(torch.int64)
        pos = cursor[:, None] + rank
        ok = refill & (pos < end[:, None])
        h = torch.where(ok, hw[torch.where(ok, pos, 0)], 0)
        x = torch.where(refill, (x << 16) | h, x)
        cursor = cursor + refill.sum(dim=1)
    return out.view(B, block_len).to(out_dtype)


def rans_decode_tiled(states: torch.Tensor, region: torch.Tensor,
                      grp_off: torch.Tensor, cum: torch.Tensor, *,
                      group_lanes: int, block_len: int, a_count: int,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """Decode groups of lanes: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  See the module docstring."""
    if states.device.type == "cpu":
        return rans_decode_plain(
            states, region, grp_off, cum, group_lanes=group_lanes,
            block_len=block_len, a_count=a_count, out_dtype=out_dtype)
    if states.device.type != "cuda":
        raise ValueError(f"no rans16 decode for device {states.device}")
    _check_inputs(states, region, grp_off, cum, group_lanes, out_dtype)
    if not 1 <= a_count <= 1023:
        raise ValueError(f"alphabet {a_count} outside [1, 1023]")
    from ._build import check, library

    B = states.shape[0]
    dev = states.device
    out = torch.empty((B, block_len), dtype=out_dtype, device=dev)
    # keep the contiguous tensors referenced until the launch is queued;
    # an empty region still needs a valid pointer (the kernel never reads it)
    states, grp_off, cum = (states.contiguous(), grp_off.contiguous(),
                            cum.contiguous())
    n_hw = region.numel()
    region = (region.contiguous() if n_hw
              else torch.zeros(1, dtype=torch.int16, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().rc_rans_decode(
            states.data_ptr(), region.data_ptr(), n_hw, grp_off.data_ptr(),
            cum.data_ptr(), 0 if cum.dim() == 1 else 1024, out.data_ptr(),
            B // group_lanes, group_lanes, block_len, a_count,
            _OUT_BYTES[out_dtype], stream)
    check(err, "rans16 decode kernel")
    rans_decode_tiled.launches += 1
    return out


#: launches of the CUDA kernel (the plain version does not count)
rans_decode_tiled.launches = 0


def decode_plan(group_lanes: int, a_count: int, out_dtype: torch.dtype
                ) -> dict:
    """How the CUDA kernel runs a shape on the current card: ``staged``
    (symbols staged in shared memory and stored 16 bytes a row) or the
    direct-store variant, the refill ring's halfwords, the dynamic shared
    memory and the threads per block.  Needs the card (it builds the
    library)."""
    import ctypes

    from ._build import check, library

    vals = [ctypes.c_int(0) for _ in range(4)]
    check(library().rc_rans_decode_plan(
        group_lanes, a_count, _OUT_BYTES[out_dtype],
        *(ctypes.byref(v) for v in vals)), "rans16 decode plan")
    staged, ring_hw, smem, threads = (v.value for v in vals)
    return {"staged": bool(staged), "ring_hw": ring_hw, "smem_bytes": smem,
            "threads": threads}
