"""Row 8's kernels (csrc/w8a8_mlp_fused.cu) emulated in numpy on the CPU:
the transpose pass's index map, its 4 x 4-byte prmt transposes and the
swizzled shared-memory staging of its output tile; the TMA
copy of a 128 x 128-byte box with the 128-byte swizzle and the order in
which the K-major s8 wgmma descriptor reads it (8-row x 16-byte core
matrices, 1024 bytes between 8-row groups); the s32 accumulator fragment of
wgmma.m64n128k32 mapped to (row, column) for the epilogue; the grouped tile
order of the persistent grid; the row absmax as an atomicMax over the float
bits; and the whole kernel (transpose, GEMM with the SwiGLU epilogue into
the f32 scratch, requantization). The emulation is held against
`w8a8_mlp_fused_plain` and the JAX package's Pallas kernel in interpret
mode by tests/test_torch_fused_mlp.py's measure; no GPU is needed."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu_torch.ops import quant as TQ

SRC = (Path(TQ.__file__).resolve().parent.parent / "csrc" / "w8a8_mlp_fused.cu").read_text()


def const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


BM, BN, BK, GROUP_M, TT, TTHREADS = (const(n) for n in
                                     ("BM", "BN", "BK", "GROUP_M", "TT", "TTHREADS"))
BOX = BM * BK
SMS = 132  # the H100's SMs: the persistent grid's blocks
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4


def prmt(a, b, sel):
    """PTX prmt (__byte_perm): byte i of the result is byte (sel >> 4 i) & 7
    of the 8 bytes b:a."""
    both = (np.asarray(b, np.uint64) << np.uint64(32)) | np.asarray(a, np.uint64)
    out = np.zeros(np.shape(both), np.uint64)
    for i in range(4):
        byte = (both >> np.uint64(8 * ((sel >> (4 * i)) & 7))) & np.uint64(0xFF)
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32)


# ------------------------------------------------------------- transpose


def transpose(w):
    """mlp_transpose_kernel on w [K, N] int8: the [N, K] it writes. Bytes it
    does not write stay at a sentinel, so a gap in the index map shows."""
    K, N = w.shape
    out = np.full((N, K), 77, np.uint8)
    wu = w.view(np.uint8)
    tid = np.arange(TTHREADS)
    ng, kg = tid & 31, tid >> 5
    for n0 in range(0, N, TT):
        for k0 in range(0, K, TT):
            tile = np.zeros(TT * TT, np.uint8)
            for j in range(TT * TT // 16 // TTHREADS):
                for c in tid + j * TTHREADS:
                    r, ch = c >> 3, c & 7
                    if k0 + r < K and n0 + 16 * ch < N:
                        tile[16 * c:16 * c + 16] = wu[k0 + r, n0 + 16 * ch:n0 + 16 * ch + 16]
            words = tile.view("<u4")
            w_ = [words[(16 * kg + i) * (TT // 4) + ng] for i in range(16)]
            o = [[None] * 4 for _ in range(4)]
            for q in range(4):
                lo01 = prmt(w_[4 * q], w_[4 * q + 1], 0x5140)
                hi01 = prmt(w_[4 * q], w_[4 * q + 1], 0x7362)
                lo23 = prmt(w_[4 * q + 2], w_[4 * q + 3], 0x5140)
                hi23 = prmt(w_[4 * q + 2], w_[4 * q + 3], 0x7362)
                o[0][q] = prmt(lo01, lo23, 0x5410)
                o[1][q] = prmt(lo01, lo23, 0x7632)
                o[2][q] = prmt(hi01, hi23, 0x5410)
                o[3][q] = prmt(hi01, hi23, 0x7632)
            staged = np.zeros((TT * TT // 16, 16), np.uint8)  # the tile's 16-byte chunks
            for j in range(4):
                block = np.stack(o[j], axis=1).astype("<u4").view(np.uint8)  # [threads, 16]
                staged[(4 * ng + j) * 8 + (kg ^ (ng & 7))] = block
            for j in range(TT * TT // 16 // TTHREADS):
                for c in tid + j * TTHREADS:
                    r, ch = c >> 3, c & 7
                    if n0 + r < N and k0 + 16 * ch < K:
                        out[n0 + r, k0 + 16 * ch:k0 + 16 * ch + 16] = \
                            staged[r * 8 + (ch ^ ((r >> 2) & 7))]
    return out.view(np.int8)


@pytest.mark.parametrize("K,N", [(48, 32), (272, 160), (128, 272)])
def test_transpose_writes_every_byte_once_as_w_t(K, N):
    """The transpose pass writes exactly w^T: every byte of [N, K], from
    ragged tiles at both edges (K and N multiples of 16, not of 128)."""
    w = np.random.default_rng(K + N).integers(-128, 128, (K, N)).astype(np.int8)
    np.testing.assert_array_equal(transpose(w), w.T)


def test_transpose_reads_are_conflict_free():
    """A warp (fixed kg) reads word ng of one 128-byte row of the tile: 32
    distinct banks, for each of its 16 loads."""
    for kg in range(TTHREADS // 32):
        for i in range(16):
            addr = (16 * kg + i) * (TT // 4) + LANES
            assert len(set(addr % 32)) == 32


def test_transpose_staging_is_conflict_free():
    """The output tile's 16-byte chunks in shared memory: each 8-lane phase
    of a warp's 16-byte stores (rows 4 ng + j, chunk kg) and of its reads
    back (one row, its 8 chunks) touches 8 distinct 16-byte bank groups,
    and the staging is a permutation of the tile's chunks."""
    seen = set()
    for kg in range(TTHREADS // 32):
        for j in range(4):
            slot = (4 * LANES + j) * 8 + (kg ^ (LANES & 7))
            seen.update(slot.tolist())
            for phase in range(4):
                assert len(set(slot[8 * phase:8 * phase + 8] % 8)) == 8
    assert seen == set(range(TT * TT // 16))
    for c0 in range(0, TT * TT // 16, 8):
        c = c0 + np.arange(8)
        r, ch = c >> 3, c & 7
        assert len(set((r * 8 + (ch ^ ((r >> 2) & 7))) % 8)) == 8


# ----------------------------------------------- swizzle and descriptors


def tma_box(a, r0, c0):
    """The TMA copy with CU_TENSOR_MAP_SWIZZLE_128B of the 128 x 128-byte box
    of a [R, C] (int8) at row r0, byte column c0: flat uint8 [BOX]; 16-byte
    chunk c of row r lands at chunk c ^ (r % 8) of its 128-byte row, and
    elements outside a are zeros."""
    R, C = a.shape
    pad = np.zeros((BM, BK), np.uint8)
    live = a[r0:r0 + BM, c0:c0 + BK].view(np.uint8)
    pad[:live.shape[0], :live.shape[1]] = live
    r, c = np.meshgrid(np.arange(BM), np.arange(BK), indexing="ij")
    flat = np.zeros(BOX, np.uint8)
    flat[r * 128 + (((c >> 4) ^ (r & 7)) << 4) + (c & 15)] = pad
    return flat


def sw128_desc(addr, lbo, sbo):
    """attention_common.cuh's sw128_desc: start, lbo and sbo in 16-byte
    units, layout 1 (128-byte swizzle) at bits 62-63."""
    return ((addr >> 4) & 0x3FFF) | (((lbo >> 4) & 0x3FFF) << 16) | \
        (((sbo >> 4) & 0x3FFF) << 32) | (1 << 62)


def box_desc(base, kk):
    """w8a8_mlp_fused.cu's box_desc: k32 step kk of a box at byte `base`."""
    return sw128_desc(base + kk * 32, 16, 1024)


def desc_read(smem, desc, rows):
    """What a K-major, 128-byte-swizzled s8 wgmma operand of `rows` rows and
    32 k bytes reads through `desc`: core matrix (i, c) is 8 rows x 16 bytes,
    rows 8 i .. 8 i + 7 at sbo bytes a group, chunk c of the step; row r, byte
    b at the canonical address start + (r / 8) sbo + (r % 8) 128 + b, which
    the unit swizzles (bits 4-6 ^= bits 7-9) before it reads. -> int8
    [rows, 32]."""
    assert desc >> 62 == 1
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    r = np.arange(rows)[:, None]
    b = np.arange(32)[None, :]
    addr = start + (r // 8) * sbo + (r % 8) * 128 + b
    addr = addr ^ (((addr >> 7) & 7) << 4)
    return smem[addr].view(np.int8)


def test_descriptor_reads_the_box_k_major():
    """For every k32 step: the x descriptor of warpgroup wg reads rows 64 wg
    .. 64 wg + 63 of the x box, the gate^T and up^T descriptors all 128 rows,
    each the 32 bytes 32 kk .. 32 kk + 31 of its rows, from a stage laid out
    as x, gate^T, up^T boxes 16 KB apart."""
    rng = np.random.default_rng(0)
    mats = [rng.integers(-128, 128, (BM, BK)).astype(np.int8) for _ in range(3)]
    stage = np.concatenate([tma_box(m, 0, 0) for m in mats])
    for kk in range(BK // 32):
        for wg in range(2):
            got = desc_read(stage, box_desc(wg * (BOX // 2), kk), 64)
            np.testing.assert_array_equal(got, mats[0][64 * wg:64 * wg + 64, 32 * kk:32 * kk + 32])
        for i in (1, 2):
            got = desc_read(stage, box_desc(i * BOX, kk), 128)
            np.testing.assert_array_equal(got, mats[i][:, 32 * kk:32 * kk + 32])


def test_swizzle_is_a_permutation_within_each_row():
    """The 128-byte swizzle moves 16-byte chunks only within their row (the
    box stays 128 rows of 128 bytes), and the 8 rows of a group put chunk c
    on 8 distinct chunk positions: one core matrix's 8 rows of 16 bytes lie
    on 8 distinct bank groups."""
    for r in range(16):
        chunks = [(((c ^ (r & 7)) << 4)) for c in range(8)]
        assert sorted(chunks) == [16 * c for c in range(8)]
    for c in range(8):
        assert len({c ^ r for r in range(8)}) == 8


def test_box_zero_fills_outside_the_tensor():
    """Rows past M and bytes past K arrive as zeros."""
    a = np.ones((5, 80), np.int8)
    smem = tma_box(a, 0, 0)
    got = np.concatenate([desc_read(smem, box_desc(0, kk), 128) for kk in range(4)], axis=1)
    want = np.zeros((BM, BK), np.int8)
    want[:5, :80] = 1
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------- accumulator fragment


def fragment_coords():
    """The s32 accumulator of wgmma.m64n128k32 as the PTX ISA lays it out:
    warp w of the warpgroup, lane 4 g + t, register d[4 j + 2 h + e] holds
    row 16 w + g + 8 h, column 8 j + 2 t + e. -> rows, cols [4, 32, 16, 4]."""
    w = np.arange(4)[:, None, None, None]
    j = np.arange(16)[None, None, :, None]
    reg = np.arange(4)[None, None, None, :]
    g, t = G[None, :, None, None], T[None, :, None, None]
    rows = 16 * w + g + 8 * (reg >> 1) + 0 * j
    cols = 8 * j + 2 * t + (reg & 1) + 0 * w
    return np.broadcast_to(rows, (4, 32, 16, 4)), np.broadcast_to(cols, (4, 32, 16, 4))


def test_fragment_covers_the_tile_once():
    rows, cols = fragment_coords()
    flat = (rows * 128 + cols).ravel()
    assert len(flat) == 64 * 128 and len(set(flat)) == 64 * 128


def test_epilogue_quad_shares_one_row_and_stores_full_sectors():
    """The 4 lanes of a quad hold one row in each half (so two xor shuffles
    give the row's max over the thread's columns), and for one j a warp's 8
    float2 stores of a row are 32 contiguous bytes: a whole sector."""
    rows, cols = fragment_coords()
    for w in range(4):
        for h in range(2):
            r = rows[w, :, 0, 2 * h]
            assert all(len(set(r[4 * q:4 * q + 4])) == 1 for q in range(8))
            for j in range(16):
                c = cols[w, :, j, 2 * h]
                for q in range(8):
                    start = 4 * c[4 * q:4 * q + 4]
                    assert sorted(start) == list(range(start.min(), start.min() + 32, 8))
                    assert start.min() % 32 == 0


# --------------------------------------------------------------- tile order


def tile_origin(tile, m_tiles, n_tiles):
    per_group = GROUP_M * n_tiles
    group, first = tile // per_group, tile // per_group * GROUP_M
    rows = min(m_tiles - first, GROUP_M)
    inner = tile - group * per_group
    return (first + inner % rows) * BM, (inner // rows) * BN


def block_tiles(m_tiles, n_tiles):
    """The tiles each block of the persistent grid walks, in its order."""
    tiles = m_tiles * n_tiles
    grid = min(tiles, SMS)
    return [[tile_origin(t, m_tiles, n_tiles) for t in range(b, tiles, grid)]
            for b in range(grid)]


@pytest.mark.parametrize("M,N", [(1, 32), (130, 160), (300, 272), (2100, 1040),
                                 (64 * 300, 11008), (64 * 300 + 1, 11024)])
def test_grouped_order_visits_every_tile_once(M, N):
    """Every (row tile, column tile) is walked by exactly one block once, at
    ragged M and N (a last group of fewer row tiles)."""
    m_tiles, n_tiles = -(-M // BM), -(-N // BN)
    seen = [o for blk in block_tiles(m_tiles, n_tiles) for o in blk]
    want = {(m * BM, n * BN) for m in range(m_tiles) for n in range(n_tiles)}
    assert len(seen) == len(want) and set(seen) == want


def test_a_wave_shares_few_stripes_and_column_tiles():
    """At the prefill shape the 132 tiles in flight together span GROUP_M
    row stripes of x (0.5 MB each) and 9 column tiles of gate and up (1 MB
    each): under 25 MB of L2. Walking whole groups, the weights are read
    from device memory about once a group, (150 / GROUP_M) x 90 MB, where the
    N-fastest order reads them about once a stripe (150 x 90 MB)."""
    m_tiles, n_tiles = 64 * 300 // BM, -(-11008 // BN)
    wave = [tile_origin(t, m_tiles, n_tiles) for t in range(SMS)]
    stripes = {m for m, _ in wave}
    cols = {n for _, n in wave}
    assert len(stripes) == GROUP_M and len(cols) == -(-SMS // GROUP_M)
    assert (len(stripes) * BM * 4096 + len(cols) * BN * 4096 * 2) / 1e6 < 25


# ---------------------------------------------------------------- absmax


def test_atomic_max_on_float_bits_is_the_max():
    """For values >= 0 (an absmax), the order of the float bits as unsigned
    integers is the order of the floats: zeros, denormals, normals and inf;
    the max over any order of atomicMax calls is the float max."""
    rng = np.random.default_rng(3)
    vals = np.concatenate([np.abs(rng.normal(size=1000) * 10 ** rng.uniform(-40, 38, 1000)),
                           [0.0, 1e-45, 1.2e-38, 3.4e38, np.inf]]).astype(np.float32)
    bits = vals.view(np.uint32)
    order = np.argsort(vals, kind="stable")
    assert (np.diff(bits[order].astype(np.int64)) >= 0).all()
    for _ in range(5):
        perm = rng.permutation(len(vals))
        acc = np.uint32(0)  # zeroed by the transpose pass
        for i in perm:
            acc = max(acc, bits[i])
        assert np.array([acc], np.uint32).view(np.float32)[0] == vals.max()


# ----------------------------------------------------------- whole kernel


def emulate(xq, xs, gq, gs, uq, us):
    """(hq [M, N] int8, hs [M, 1] f32) computed as the three kernels do."""
    M, K = xq.shape
    N = gq.shape[1]
    wt = [transpose(gq), transpose(uq)]
    rowmax = np.zeros(M, np.uint32)
    h = np.full((M, N), np.nan, np.float32)
    m_tiles, n_tiles, nk = -(-M // BM), -(-N // BN), -(-K // BK)
    frows, fcols = fragment_coords()
    for blk in block_tiles(m_tiles, n_tiles):
        for m0, n0 in blk:
            acc = np.zeros((2, 2, 64, 128), np.int64)  # [gate/up, warpgroup]
            for kt in range(nk):
                stage = np.concatenate([tma_box(xq, m0, kt * BK), tma_box(wt[0], n0, kt * BK),
                                        tma_box(wt[1], n0, kt * BK)])
                for kk in range(BK // 32):
                    for wg in range(2):
                        a = desc_read(stage, box_desc(wg * (BOX // 2), kk), 64).astype(np.int64)
                        for i in range(2):
                            b = desc_read(stage, box_desc((1 + i) * BOX, kk), 128)
                            acc[i, wg] += a @ b.astype(np.int64).T
            assert np.abs(acc).max() < 2 ** 31  # the s32 accumulators never wrap
            for wg in range(2):
                # the registers of each thread, then the epilogue's (row, col)
                regs = acc[:, wg][:, frows, fcols]          # [2, 4 w, 32, 16 j, 4]
                row = m0 + 64 * wg + frows
                col = n0 + fcols
                live = (row < M) & (col < N)
                r, c = row[live], col[live]
                gv = regs[0][live].astype(np.float32) * xs[r, 0] * gs[c]
                uv = regs[1][live].astype(np.float32) * xs[r, 0] * us[c]
                hv = (gv / (np.float32(1.0) + np.exp(-gv))) * uv
                h[r, c] = hv
                np.maximum.at(rowmax, r, np.abs(hv).view(np.uint32))
    assert not np.isnan(h).any()  # every element was stored once
    amax = rowmax.view(np.float32)
    hs = np.where(amax > 0, amax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
    hq = np.clip(np.rint(h / hs[:, None]), -127, 127).astype(np.int8)
    return hq, hs[:, None]


def _operands(rng, M, K, N):
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    xs = (np.abs(rng.normal(size=(M, 1))) * 0.01 + 1e-3).astype(np.float32)
    gq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    uq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    gs = (np.abs(rng.normal(size=(N,))) * 2e-3 + 1e-4).astype(np.float32)
    us = (np.abs(rng.normal(size=(N,))) * 2e-3 + 1e-4).astype(np.float32)
    return xq, xs, gq, gs, uq, us


def _hold(hq, hs, want_q, want_s):
    """tests/test_torch_fused_mlp.py's measure: hs to 1e-6 relative, hq
    within +-1 and at least 99.9% equal."""
    np.testing.assert_allclose(hs, want_s, rtol=1e-6)
    diff = np.abs(hq.astype(int) - np.asarray(want_q, int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


@pytest.mark.parametrize("K,N", [(48, 32), (80, 160), (272, 272)])
@pytest.mark.parametrize("M", [1, 5, 64, 130, 300])
def test_emulation_matches_plain_and_pallas(M, K, N):
    """The emulated kernel against the plain version and the Pallas kernel in
    interpret mode, with K and N off the tile edges (one stage with zeros
    past K, three stages; 32, 160 and 272 columns) and M across one to three
    row tiles."""
    ops = _operands(np.random.default_rng(M * 1000 + K + N), M, K, N)
    hq, hs = emulate(*ops)
    assert hq.shape == (M, N) and hs.shape == (M, 1)
    pq, ps = TQ.w8a8_mlp_fused_plain(*map(torch.from_numpy, ops))
    _hold(hq, hs, pq.numpy(), ps.numpy())
    jq, js = JQ.w8a8_mlp_fused(*map(jnp.asarray, ops), block_m=64, block_k=128, interpret=True)
    _hold(hq, hs, np.asarray(jq), np.asarray(js))


def test_constants_fit_the_card():
    """Four 48 KB stages, each warpgroup's staged scales (gs and us of 128
    columns, xs of 64 rows) and the barriers fit one block an SM (227 KB);
    the registers of the two consumer warpgroups at 232 and the producer's
    at 40 fit the SM's 65536."""
    stages = const("STAGES")
    smem = stages * 3 * BOX + 2 * (2 * BN + BM // 2) * 4 + 2 * stages * 8 + 1024
    assert smem <= 232448
    assert 256 * const("CONSUMER_REGS") + 128 * const("PRODUCER_REGS") <= 65536
