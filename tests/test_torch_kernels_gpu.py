"""Each CUDA kernel of the port against its plain PyTorch version, on a card.

Marked ``gpu``: every test skips without a CUDA card (the kernels have no
CPU mode).  This file imports no jax, so it also runs where only PyTorch
is installed; the repository's root conftest imports jax, so on such a
machine run it as

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu -q

Outputs are integers: kernel and plain version must be identical, and
the rans16 ones must equal the NumPy spec
``range_coder_rust_tpu_torch.rans.encode_lanes`` (the port's copy of the
JAX package's).  The planar kernels run the cases of
``testing.PLANAR_CASES`` (``chip_smoke.py`` phase 3's).
"""

import numpy as np
import pytest
import torch

from range_coder_rust_tpu_torch import kernels, rans, testing
from range_coder_rust_tpu_torch import rans_codec as t_codec
from range_coder_rust_tpu_torch.blocks import default_capacity, upload_rows
from range_coder_rust_tpu_torch.models.table import (build_table_pow2,
                                                     table_from_data_pow2)
from range_coder_rust_tpu_torch.testing import (
    CASE_OPTIONS, KERNEL_CASES, PLANAR_CASES, flat_payloads, kernel_case,
    kernels_vs_plain, planar_vs_plain, zipf)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_cuda_kernels_match_plain_and_spec(name, cuda_device):
    rows, g, a = kernel_case(name)
    opts = CASE_OPTIONS.get(name, {})
    errs, (st_p, sz_p, rg_p, _), _ = kernels_vs_plain(rows, g, a, cuda_device,
                                                      **opts)
    assert errs == {"rans_encode": 0, "rans_decode": 0}
    table = table_from_data_pow2(
        rows[:g] if opts.get("per_group") else rows, a, 16)
    s_states, s_regions, _ = rans.encode_lanes(rows[:g], table.c, table.cum)
    np.testing.assert_array_equal(st_p[:g].numpy().view(np.uint64), s_states)
    n0 = int(sz_p[0].sum())
    assert rg_p[:n0].numpy().tobytes() == b"".join(
        r.astype("<u2").tobytes() for r in s_regions)


def test_cuda_api_roundtrip_counts_launches(cuda_device):
    import range_coder_rust_tpu_torch as rt

    data = zipf(2048 * 100 + 17, 256, 7, dtype=np.uint8)
    cfg = rt.CodecConfig(profile="rans16")
    rt.reset_launch_counts()
    blob = rt.encode(data, config=cfg, device=cuda_device)
    assert blob == rt.encode(data, config=cfg, device="cpu")
    out = rt.decode(blob, device=cuda_device)
    assert rt.launch_counts() == {"rans_encode": 1, "rans_decode": 1,
                                  "planar_encode": 0, "planar_decode": 0,
                                  "planar_histogram": 0, "planar_compact": 0}
    np.testing.assert_array_equal(out, data)


@pytest.mark.parametrize("cfg", [
    dict(per_group_tables=True, block_len=32),
    dict(block_len=256, sync_tiles=2),
    dict(per_group_tables=True, block_len=192, group_lanes=1024,
         sync_tiles=1)])
def test_cuda_adaptive_and_sync_paths_match_cpu(cfg, cuda_device):
    """Per-group tables and sync points through the api on the card:
    the container equals the one the plain versions write, and decode and
    decode_range give the data back, each through the kernels."""
    import range_coder_rust_tpu_torch as rt

    data = testing.mixed_corpus(3 << 16)[:190_001]
    c = rt.CodecConfig(profile="rans16", **cfg)
    rt.reset_launch_counts()
    blob = rt.encode(data, alphabet=256, config=c, device=cuda_device)
    assert rt.launch_counts()["rans_encode"] >= 1
    assert blob == rt.encode(data, alphabet=256, config=c, device="cpu")
    out = rt.decode(blob, device=cuda_device)
    np.testing.assert_array_equal(out.astype(np.int32), data)
    L = cfg["block_len"]
    for start, count in [(0, 100), (L * 7 - 3, 9), (190_001 - 50, 50),
                         (70_000, 5000)]:
        before = rt.launch_counts()["rans_decode"]
        got = rt.api.decode_range(blob, start, count, device=cuda_device)
        assert rt.launch_counts()["rans_decode"] > before
        np.testing.assert_array_equal(got, data[start : start + count])


def test_cuda_decode_bounds_match_plain(cuda_device):
    """Offsets outside the region are clamped to it and reads stop at the
    group's end, in the kernel exactly as in the plain version."""
    rows, g, a = kernel_case("odd_tile_G128_L63")
    L = rows.shape[1]
    table = table_from_data_pow2(rows, a, 16)
    cum_c = t_codec.cum_table(table.cum, "cpu")
    st, sz, rg, _ = kernels.rans_encode_tiled(
        torch.from_numpy(rows), cum_c, group_lanes=g, tile=L)
    n0 = int(sz[0].sum())
    kw = dict(group_lanes=g, block_len=L, a_count=a, out_dtype=torch.uint8)
    for off in ([0, n0 // 2, rg.numel()], [-7, n0, 1 << 40],
                [n0, 3, rg.numel() + 5]):
        grp_off = torch.tensor(off, dtype=torch.int64)
        dec_p = kernels.rans_decode_tiled(st, rg, grp_off, cum_c, **kw)
        dec_k = kernels.rans_decode_tiled(
            st.to(cuda_device), rg.to(cuda_device), grp_off.to(cuda_device),
            cum_c.to(cuda_device), **kw)
        torch.cuda.synchronize()
        assert torch.equal(dec_k.cpu(), dec_p), off


def test_cuda_decode_unaligned_region_matches_plain(cuda_device):
    """A region that is not 16-byte aligned (a view one halfword in) and
    group offsets off the 8-halfword grid: the ring then reads halfword by
    halfword, with the same result."""
    rows, g, a = kernel_case("G2048_L64_NG2")
    L = rows.shape[1]
    table = table_from_data_pow2(rows, a, 16)
    cum_c = t_codec.cum_table(table.cum, "cpu")
    st, sz, rg, _ = kernels.rans_encode_tiled(
        torch.from_numpy(rows), cum_c, group_lanes=g, tile=32)
    n0 = int(sz[0].sum())
    padded = torch.cat([torch.zeros(3, dtype=torch.int16), rg])
    grp_off = torch.tensor([3, 3 + n0, 3 + rg.numel()])
    kw = dict(group_lanes=g, block_len=L, a_count=a, out_dtype=torch.uint8)
    dec_p = kernels.rans_decode_tiled(st, padded, grp_off, cum_c, **kw)
    np.testing.assert_array_equal(dec_p.numpy().astype(np.int32), rows)
    dev = padded.to(cuda_device)
    for view, off in ((dev, grp_off), (dev[1:], grp_off - 1)):
        dec_k = kernels.rans_decode_tiled(
            st.to(cuda_device), view, off.to(cuda_device),
            cum_c.to(cuda_device), **kw)
        torch.cuda.synchronize()
        assert torch.equal(dec_k.cpu(), dec_p), view.data_ptr() % 16


@pytest.mark.parametrize("name,staged", [
    ("G2048_L64_NG2", True), ("G2048_L25_NG2_A400", True),
    ("G4096_L16_two_lanes_per_thread", True),
    ("G8192_L24_direct_stores", False),
    ("G4096_L16_A400_u16_direct_stores", False),
    ("G32768_L16_widest", False)])
def test_cuda_decode_plan_variant(name, staged, cuda_device):
    """The staged and direct-store variants run where the kernel's header
    says, within the card's shared memory."""
    rows, g, a = kernel_case(name)
    out = t_codec._TORCH_OUT[t_codec._np_dtype(a)]
    plan = kernels.decode_plan(g, a, out)
    assert plan["staged"] == staged, plan
    assert plan["threads"] <= 1024 and g % plan["threads"] == 0, plan
    assert plan["ring_hw"] >= 64 and plan["ring_hw"] & (plan["ring_hw"] - 1) == 0
    props = torch.cuda.get_device_properties(cuda_device)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    assert 65536 < plan["smem_bytes"] <= limit


def test_cuda_encode_symbols_outside_table_do_not_fault(cuda_device):
    rows = torch.full((128, 8), 5000, dtype=torch.int32, device=cuda_device)
    rows[:, ::2] = -3
    cum = t_codec.cum_table(np.array([0, 1 << 15, 1 << 16]), cuda_device)
    kernels.rans_encode_tiled(rows, cum, group_lanes=128, tile=8)
    torch.cuda.synchronize()  # raises if the kernel faulted


@pytest.mark.parametrize("name", ["G2048_L64_NG2", "odd_tile_G128_L63",
                                  "G2048_L25_NG2_A400", "c_1_rare_symbols"])
def test_cuda_encode_row_widths_and_alignment_match_plain(name, cuda_device):
    """u8 (for A <= 256), int16 and int32 rows, each as an aligned tensor
    and as a view whose base is off the 16-byte grid (the symbol-by-symbol
    loads), give the plain version's output exactly."""
    rows, g, a = kernel_case(name)
    L = rows.shape[1]
    table = table_from_data_pow2(rows, a, 16)
    tile, _ = t_codec._tile_geometry(L, g)
    cum_c = t_codec.cum_table(table.cum, "cpu")
    want = kernels.rans_encode_plain(torch.from_numpy(rows), cum_c,
                                     group_lanes=g, tile=tile)
    for w in ([np.uint8] if a <= 256 else []) + [np.int16, np.int32]:
        host = torch.from_numpy(rows.astype(w))
        size = host.element_size()
        buf = torch.empty(host.numel() + 16 // size, dtype=host.dtype,
                          device=cuda_device)
        shifted = buf[1:1 + host.numel()].view(host.shape)
        shifted.copy_(host.to(cuda_device))
        assert shifted.data_ptr() % 16
        for dev_rows in (host.to(cuda_device), shifted):
            got = kernels.rans_encode_tiled(dev_rows, cum_c.to(cuda_device),
                                            group_lanes=g, tile=tile)
            torch.cuda.synchronize()
            assert testing.encode_err(got, want) == 0, (w, dev_rows.data_ptr())


@pytest.mark.parametrize("dtype,steps", [(torch.uint8, 32), (torch.int16, 16),
                                         (torch.int32, 8)])
def test_cuda_encode_plan(dtype, steps, cuda_device):
    plan = kernels.encode_plan(4, 2048, 32768, dtype)
    n = 4 * 2048 * 32768
    assert plan == {"scratch_bytes": 2 * n + n // 8, "chain_threads": 64,
                    "chunk_steps": steps}


def test_cuda_encode_int16_symbols_outside_table_do_not_fault(cuda_device):
    rows = torch.full((128, 24), 5000, dtype=torch.int16, device=cuda_device)
    rows[:, ::2] = -3  # u16 bits 65533
    cum = t_codec.cum_table(np.array([0, 1 << 15, 1 << 16]), cuda_device)
    kernels.rans_encode_tiled(rows, cum, group_lanes=128, tile=8)
    torch.cuda.synchronize()  # raises if the kernel faulted


@pytest.mark.parametrize("name", PLANAR_CASES)
def test_cuda_planar_kernels_match_plain(name, cuda_device):
    """Each planar kernel equals its plain version on the CPU: code bytes,
    lengths and decoded symbols."""
    assert planar_vs_plain(name, cuda_device) == {"planar_encode": 0,
                                                  "planar_decode": 0}


@pytest.mark.parametrize("a,encode_at,decode_at", [
    (256, "smem_pairs", "slots8"), (6143, "smem_pairs", "slots16"),
    (6144, "global", "slots16"), (50257, "global", "global")])
def test_cuda_planar_shared_tables_by_width_match_plain(a, encode_at,
                                                        decode_at,
                                                        cuda_device):
    """Both planar kernels on one shared 2^16 table at widths on each side
    of the placements' limits (the pairs staged up to A = 6143, a slot
    table up to what the opt-in holds; 50257 is GPT-2's vocabulary),
    symbols at the width the codec uploads (u8, else u16): code bytes,
    lengths and symbols equal the plain versions', and each launch
    reports the expected placement.  The table is apportioned from the
    Zipf(1.0) law's counts over 10^8 symbols, as a shard's: at 50257 its
    most frequent symbols get 1 of 2^16."""
    B, L = 128, 512
    values = zipf(B * L, a, 31, alpha=1.0).reshape(B, L)
    law = 1.0 / np.arange(1, a + 1)
    t = build_table_pow2(np.ceil(1e8 * law / law.sum()).astype(np.uint64), 16)
    c, cum = (torch.from_numpy(x.astype(np.int64)) for x in (t.c, t.cum))
    rows = upload_rows(values.astype(np.uint8 if a <= 256 else np.uint16),
                       "cpu")
    cap = default_capacity(L, 16)
    dev = [x.to(cuda_device) for x in (rows, c, cum)]
    kernels.reset_launch_counts()
    code_k, len_k = kernels.planar_encode_blocks(*dev, k=16, capacity=cap)
    code_p, len_p = kernels.planar_encode_blocks(rows, c, cum, k=16,
                                                 capacity=cap)
    assert torch.equal(code_k.cpu(), code_p) and torch.equal(len_k.cpu(),
                                                              len_p)
    assert int(len_p.max()) <= cap
    flat, offs, lens = flat_payloads(code_p, len_p, a)
    dec_k = kernels.planar_decode_blocks(
        flat.to(cuda_device), *dev[1:], k=16, block_len=L,
        offsets=offs.to(cuda_device), lengths=lens.to(cuda_device))
    dec_p = kernels.planar_decode_blocks(flat, c, cum, k=16, block_len=L,
                                         offsets=offs, lengths=lens)
    assert torch.equal(dec_k.cpu(), dec_p)
    np.testing.assert_array_equal(dec_p.numpy(), values)
    placed = kernels.launch_placements()
    assert placed["planar_encode"] == {**dict.fromkeys(kernels.PLACEMENTS, 0),
                                       encode_at: 1}
    assert placed["planar_decode"] == {**dict.fromkeys(kernels.PLACEMENTS, 0),
                                       decode_at: 1}


@pytest.mark.parametrize("name,encode_at,decode_at", [
    ("k17_slots8", "smem_pairs", "slots8"),
    ("k20_A100352_i32", "global", "global"),
    ("k24_A4096_u16", "smem_pairs", "smem_pairs")])
def test_cuda_planar_wide_totals_report_their_form(name, encode_at, decode_at,
                                                   cuda_device):
    """The 2^17 to 2^24 totals: each launch of both planar kernels
    reports the ``pow2_wide`` form and the placement its width selects,
    and equals its plain version (``testing.planar_vs_plain``)."""
    kernels.reset_launch_counts()
    assert planar_vs_plain(name, cuda_device) == {"planar_encode": 0,
                                                  "planar_decode": 0}
    placed, totals = kernels.launch_placements(), kernels.launch_totals()
    for kernel, at in (("planar_encode", encode_at),
                       ("planar_decode", decode_at)):
        n = sum(placed[kernel].values())
        assert n >= 1 and placed[kernel][at] == n
        # the kernel's n launches and the plain version's calls, all wide
        assert totals[kernel]["pow2_wide"] > n
        assert totals[kernel]["pow2"] == totals[kernel]["raw"] == 0


@pytest.mark.parametrize("mode", ["shared", "raw_total", "per_block"])
def test_cuda_planar_encode_matches_cpu(mode, cuda_device):
    """The planar profile on the card (the planar kernels): the container
    equals the CPU's and decodes back, each call one launch of each planar
    coder kernel and of the compaction and no rans16 kernel; the shared
    table's histogram is one launch of the histogram kernel (the raw and
    per-block tables keep their host counts)."""
    import range_coder_rust_tpu_torch as rt
    from range_coder_rust_tpu_torch import adaptive

    data = zipf(64 * 512 + 77, 256, 11, dtype=np.uint8)
    if mode == "per_block":
        def enc(device):
            return adaptive.encode_adaptive(data, device=device)
    else:
        cfg = rt.CodecConfig(raw_total=mode == "raw_total")

        def enc(device):
            return rt.encode(data, config=cfg, device=device)
    rt.reset_launch_counts()
    blob = enc(cuda_device)
    assert blob == enc("cpu")
    np.testing.assert_array_equal(rt.decode(blob, device=cuda_device), data)
    assert rt.launch_counts() == {"rans_encode": 0, "rans_decode": 0,
                                  "planar_encode": 1, "planar_decode": 1,
                                  "planar_histogram": int(mode == "shared"),
                                  "planar_compact": 1}


@pytest.mark.parametrize("per_group", [False, True])
def test_cuda_sharded_rans16_matches_single_call(per_group, cuda_device):
    """Two shards on one card: each kernel launches once a shard, and the
    outputs equal one unsharded call's."""
    from range_coder_rust_tpu_torch.parallel import make_sharded_rans16

    rows, g, a = kernel_case("G1024_L192_per_group_sync1")
    rows = np.concatenate([rows, rows[::-1]])  # 4 groups
    L = rows.shape[1]
    ng = rows.shape[0] // g
    tables = ([table_from_data_pow2(rows[i * g : (i + 1) * g], a, 16).cum
               for i in range(ng)] if per_group
              else table_from_data_pow2(rows, a, 16).cum)
    cum = t_codec.cum_table(np.stack(tables) if per_group else tables,
                            cuda_device)
    dev_rows = torch.from_numpy(rows.astype(np.uint8)).to(cuda_device)
    kw = dict(group_lanes=g, tile=64, sync_tiles=1)
    one = kernels.rans_encode_tiled(dev_rows, cum, **kw)
    enc, dec = make_sharded_rans16([cuda_device] * 2, block_len=L,
                                   a_count=a, per_group_tables=per_group)
    kernels.reset_launch_counts()
    states, sizes, region, syncs = enc(dev_rows, cum, **kw)
    grp_off = torch.cat([sizes.new_zeros(1, dtype=torch.int64),
                         sizes.sum(1).cumsum(0)])
    out = dec(states, region, grp_off, cum, group_lanes=g,
              out_dtype=torch.uint8)
    assert kernels.launch_counts() == {"rans_encode": 2, "rans_decode": 2,
                                       "planar_encode": 0, "planar_decode": 0,
                                       "planar_histogram": 0,
                                       "planar_compact": 0}
    n = int(one[1].sum())
    for got, want in zip((states, sizes, region, syncs),
                         (one[0], one[1], one[2][:n], one[3])):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(out.cpu().numpy(), rows)


def test_cuda_cli_encode_matches_cpu(tmp_path, cuda_device):
    """The CLI's encode with --device cuda writes the --device cpu file,
    and its decode on the card gives the input back."""
    from range_coder_rust_tpu_torch.__main__ import main

    src = tmp_path / "in.bin"
    data = zipf(2048 * 40 + 11, 256, 12, dtype=np.uint8)
    src.write_bytes(data.tobytes())
    out = {d: tmp_path / f"{d}.rc" for d in ("cuda", "cpu")}
    for d, path in out.items():
        assert main(["encode", str(src), "-o", str(path), "--device", d]) == 0
    assert out["cuda"].read_bytes() == out["cpu"].read_bytes()
    back = tmp_path / "back.bin"
    assert main(["decode", str(out["cuda"]), "-o", str(back)]) == 0
    assert back.read_bytes() == data.tobytes()


def _histogram_input(kind: str, n: int, a: int, np_dtype, seed: int):
    """``n`` symbols below ``a`` (and below the width's 256 for bytes):
    one symbol repeated (every add on one bin), uniform, or Zipf(1.2)."""
    top = min(a, 256) if np_dtype == np.uint8 else a
    if kind == "repeated":
        return np.full(n, top - 1, np_dtype)
    if kind == "uniform":
        return np.random.default_rng(seed).integers(0, top, n).astype(
            np_dtype)
    return zipf(n, top, seed).astype(np_dtype)


#: the largest alphabet whose u32 bins fit the opt-in shared memory
_FIT = "largest block_smem"


@pytest.mark.parametrize("np_dtype,a,path", [
    (np.uint8, 1, "warp_private"), (np.uint8, 2, "warp_private"),
    (np.uint8, 256, "warp_private"), (np.uint8, 257, "warp_private"),
    (np.uint16, 2, "warp_private"), (np.uint16, 257, "block_smem"),
    (np.uint16, 50257, "block_smem"), (np.uint16, _FIT, "block_smem"),
    (np.uint16, 65536, "global"),
    (np.int32, 1, "warp_private"), (np.int32, 256, "warp_private"),
    (np.int32, 257, "block_smem"), (np.int32, 50257, "block_smem"),
    (np.int32, _FIT, "block_smem"), (np.int32, 65536, "global")])
def test_cuda_histogram_matches_bincount(np_dtype, a, path, cuda_device):
    """The histogram kernel's counts equal ``np.bincount``'s exactly, at
    each symbol width, on each path, for lengths 0, 1, L - 1, one that
    is no multiple of 16 bytes and one over 2^24, on aligned tensors and
    on views one symbol off the 16-byte grid, and each launch is counted
    on the path the alphabet selects (u8 symbols hold 256 bins whatever
    the alphabet)."""
    props = torch.cuda.get_device_properties(cuda_device)
    optin = getattr(props, "shared_memory_per_block_optin", 232448)
    if a == _FIT:
        a = optin // 4
    width = np.dtype(np_dtype).itemsize
    to_torch = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[width]
    cases = [(n, kind) for n in (0, 1, 511, 100_003)
             for kind in ("repeated", "uniform", "zipf")]
    cases += [((1 << 24) + 7, "repeated"), ((1 << 24) + 7, "zipf")]
    kernels.reset_launch_counts()
    launches = 0
    for i, (n, kind) in enumerate(cases):
        values = _histogram_input(kind, n, a, np_dtype, i)
        want = np.bincount(values, minlength=a)
        host = torch.from_numpy(values.view(
            {1: np.uint8, 2: np.int16, 4: np.int32}[width]))
        buf = torch.empty(n + 16, dtype=to_torch, device=cuda_device)
        shifted = buf[1 : 1 + n]
        shifted.copy_(host.to(cuda_device))
        for sym in (host.to(cuda_device), shifted):
            got = kernels.planar_histogram(sym, a)
            launches += 1
            assert got.dtype == torch.int64 and got.shape == (a,)
            np.testing.assert_array_equal(got.cpu().numpy(), want,
                                          err_msg=f"{n} {kind}")
    assert kernels.launch_placements()["planar_histogram"] == {
        **dict.fromkeys(kernels.HISTOGRAM_PATHS, 0), path: launches}


@pytest.mark.parametrize("np_dtype,a,path", [
    (np.uint8, None, "warp_private"), (np.uint16, 50257, "block_smem")])
def test_cuda_encode_histogram_matches_cpu(np_dtype, a, path, cuda_device):
    """``api.encode`` with the histogram on the card: several chunks cut
    from the one uploaded buffer and a padded last row, for bytes and for
    GPT-2 token ids; the container equals the CPU's byte for byte, the
    histogram launches once on the path its alphabet selects, and the
    container decodes back on the card."""
    import range_coder_rust_tpu_torch as rt

    n = 9 * 512 + 301
    data = zipf(n, a or 256, 13, alpha=1.0 if a else 1.2).astype(np_dtype)
    cfg = rt.CodecConfig(chunk_symbols=2 * 512)
    rt.reset_launch_counts()
    blob = rt.encode(data, alphabet=a, config=cfg, device=cuda_device)
    assert rt.launch_placements()["planar_histogram"] == {
        **dict.fromkeys(kernels.HISTOGRAM_PATHS, 0), path: 1}
    assert rt.launch_counts()["planar_encode"] == 5
    assert blob == rt.encode(data, alphabet=a, config=cfg, device="cpu")
    np.testing.assert_array_equal(rt.decode(blob, device=cuda_device), data)


@pytest.mark.parametrize("row_bytes", [1544, 1543])
def test_cuda_planar_compact_matches_plain(row_bytes, cuda_device):
    """The compaction kernel on a 32768-row chunk of random bytes, with
    lengths from 0 to the whole row (most off the 4-byte grid) at their
    exclusive prefix sum (offsets at any byte): the area equals the plain
    version's on the same card tensors and the rows' prefixes joined, in
    one launch.  1544-byte rows (the encode's capacity at L = 512, k =
    16) are read as words, 1543-byte rows byte by byte."""
    B = 32768
    gen = torch.Generator(device=cuda_device).manual_seed(row_bytes)
    code = torch.randint(0, 256, (B, row_bytes), dtype=torch.uint8,
                         generator=gen, device=cuda_device)
    lengths = torch.randint(0, row_bytes + 1, (B,), generator=gen,
                            device=cuda_device)
    lengths[:4] = torch.tensor([0, row_bytes, 13, 1])
    offsets = torch.cumsum(lengths, 0) - lengths
    size = int(lengths.sum())
    kernels.reset_launch_counts()
    got = kernels.planar_compact(code, lengths, offsets, size=size)
    assert kernels.launch_counts()["planar_compact"] == 1
    want = kernels.planar_compact_plain(code, lengths, offsets, size=size)
    assert torch.equal(got, want)
    rows, lens = code.cpu().numpy(), lengths.cpu().numpy()
    assert got.cpu().numpy().tobytes() == b"".join(
        rows[b, : lens[b]].tobytes() for b in range(B))


@pytest.mark.parametrize("what,calls", [("bytes", 16), ("tokens", 6),
                                        ("rans16", 0)])
def test_cuda_encode_launches_compaction_per_chunk(what, calls,
                                                   cuda_device):
    """A planar encode on the card joins each device call's payloads with
    one launch of the compaction: 16 for 256 MiB of bytes, 6 for 10^8
    GPT-2 token ids (u16 over 50257); a rans16 encode launches none.
    Each container decodes back on the card."""
    import range_coder_rust_tpu_torch as rt

    gen = torch.Generator(device=cuda_device).manual_seed(calls)
    n, a, cfg = {"bytes": (256 << 20, 256, rt.CodecConfig()),
                 "tokens": (10**8, 50257, rt.CodecConfig()),
                 "rans16": (1 << 22, 256, rt.CodecConfig(profile="rans16"))
                 }[what]
    data = torch.randint(0, a, (n,), generator=gen, device=cuda_device)
    data = data.cpu().numpy().astype(np.uint8 if a <= 256 else np.uint16)
    rt.reset_launch_counts()
    blob = rt.encode(data, alphabet=a, config=cfg, device=cuda_device)
    counts = rt.launch_counts()
    assert counts["planar_compact"] == calls
    if calls:
        assert counts["planar_encode"] == calls
    np.testing.assert_array_equal(rt.decode(blob, device=cuda_device), data)
