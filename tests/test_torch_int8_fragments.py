"""K1's kernel (csrc/int8_matmul.cu) emulated in numpy on the CPU: the
128-byte-swizzled int8 weight stage, each lane's word reads of it and their
banks, the prmt k-pairing and the exact widening into bf16x2 wgmma A
registers (two wgmmas of 64 output columns x 16 k a warpgroup, A from
registers), the column permutation and its inverse, x as the wgmma B
operand, the split plan (ops/quant.q8_plan) and the rank-order sum over
the cluster's K ranks with the per-column scale applied after it. The
emulation is held against `int8_matmul_plain` and the JAX package's Pallas
kernel in interpret mode; no GPU is needed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu_torch.ops import quant as TQ

BN, BK, MP = TQ.Q8_BN, TQ.Q8_BK, TQ.Q8_MP
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4
SMS = 132                  # the H100's SMs
H100 = (396, 198, 92, 45)  # K1's resident clusters of 1, 2, 4, 8 blocks (chip_smoke.py)


def bf16_round(a):
    """f32 -> the nearest bf16 (ties to even), kept as f32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def bf16_value(half):
    """The bf16 whose bits are the low 16 of `half`, as f32."""
    return ((np.asarray(half, np.uint32) & np.uint32(0xFFFF)) << np.uint32(16)).view(np.float32)


def prmt(a, b, sel):
    """PTX prmt (default mode): byte i of the result is byte (sel >> 4 i) & 7
    of the 8 bytes b:a."""
    both = (np.asarray(b, np.uint64) << np.uint64(32)) | np.asarray(a, np.uint64)
    out = np.zeros(np.shape(both), np.uint64)
    for i in range(4):
        byte = (both >> np.uint64(8 * ((sel >> (4 * i)) & 7))) & np.uint64(0xFF)
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32)


def s8x2(lo, hi, j):
    """The kernel's s8x2<J>: byte j of the words lo and hi (signed int8) to
    the bf16x2 (lo, hi). A prmt puts the two bytes at bits 0-7 and 16-23;
    v = (p & 0x007F007F) | 0x43004300 is 128 + (b & 127) a half, s = (p &
    0x00800080) | 0xC300C300 is -128 or -256 by b's sign, and one bf16x2
    add (round to nearest) gives b. -> (low value, high value), f32."""
    p = prmt(lo, hi, j | (j << 4) | ((j + 4) << 8) | ((j + 4) << 12))
    v = (p & np.uint32(0x007F007F)) | np.uint32(0x43004300)
    s = (p & np.uint32(0x00800080)) | np.uint32(0xC300C300)
    out = []
    for shift in (0, 16):
        total = bf16_value(v >> np.uint32(shift)) + bf16_value(s >> np.uint32(shift))
        out.append(bf16_round(total))
    return out


def swizzle(r, c):
    """Byte offset of (row r, byte column c) in a 128-byte-swizzled stage of
    128-byte rows: 16-byte chunk c / 16 of row r at chunk (c / 16) ^ (r % 8),
    as the TMA copies with CU_TENSOR_MAP_SWIZZLE_128B lay it out."""
    return r * BN + (((c >> 4) ^ (r & 7)) << 4) + (c & 15)


def w_stage(qpad, k0, n0):
    """The swizzled W stage of the tile at (k0, n0): flat uint8 [BK * BN]."""
    r, c = np.meshgrid(np.arange(BK), np.arange(BN), indexing="ij")
    flat = np.zeros(BK * BN, np.uint8)
    flat[swizzle(r, c)] = qpad[k0:k0 + BK, n0:n0 + BN].view(np.uint8)
    return flat


def lane_offsets(warp):
    """off_e, off_o of the kernel: the byte offsets of lane (g, t)'s words
    (columns c0 = 32 warp + 4 g .. c0 + 3) in rows 2t and 2t + 1 of k16 step
    0; rows 2t + 8 and 2t + 9 share their swizzle."""
    c0 = 32 * warp + 4 * G
    off_e = 2 * T * BN + (((c0 >> 4) ^ (2 * T)) << 4) + (c0 & 15)
    off_o = (2 * T + 1) * BN + (((c0 >> 4) ^ (2 * T + 1)) << 4) + (c0 & 15)
    return off_e, off_o


def word(flat, addr):
    b = flat[addr[..., None] + np.arange(4)].astype(np.uint32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def load_addresses(warp, kk):
    """The byte addresses of the 4 word loads of k16 step kk: rows 2t, 2t +
    1, 2t + 8, 2t + 9 (r0, r1, r8, r9), each [32 lanes]."""
    off_e, off_o = lane_offsets(warp)
    return [off_e + kk * 16 * BN, off_o + kk * 16 * BN,
            off_e + (kk * 16 + 8) * BN, off_o + (kk * 16 + 8) * BN]


def a_fragments(flat, kk):
    """The A operands of k16 step kk as the lanes build them: [wgmma jj, 64
    rows, 16 k]. widen<R>(lo, hi): byte j of (lo, hi) into register R + (j
    >> 1) of wgmma j & 1; registers a0 (row g, k 2t), a1 (row g + 8, k 2t),
    a2 (row g, k 2t + 8), a3 (row g + 8, k 2t + 8) of warp w's rows 16 w .."""
    A = np.zeros((2, 64, 16), np.float32)
    for w in range(4):
        r0, r1, r8, r9 = (word(flat, a) for a in load_addresses(w, kk))
        for R, (lo, hi) in ((0, (r0, r1)), (2, (r8, r9))):
            for j in range(4):
                vlo, vhi = s8x2(lo, hi, j)
                reg = R + (j >> 1)
                row = 16 * w + G + 8 * (reg & 1)
                k = 2 * T + 8 * (reg >> 1)
                A[j & 1, row, k] = vlo
                A[j & 1, row, k + 1] = vhi
    return A


# wgmma jj's row 16 w + g + 8 h is the block's column 32 w + 4 g + 2 h + jj
_r = np.arange(64)
COLS = np.array([32 * (_r // 16) + 4 * (_r % 8) + 2 * ((_r % 16) // 8) + jj for jj in range(2)])


def emulate(x, q8, scale, resident):
    """out[M, N] in f32 (before the final bf16 rounding), computed as the
    kernel does, block by block."""
    M, K = x.shape
    N = q8.shape[1]
    plan = TQ.q8_plan(M, K, N, SMS, resident)
    out = np.zeros((M, N), np.float32)
    # the TMA copies read zeros past K and N
    qpad = np.zeros((plan.k_tiles * BK, plan.n_tiles * BN), np.int8)
    qpad[:K, :N] = q8
    spad = np.zeros(plan.n_tiles * BN, np.float32)
    spad[:N] = scale
    for mz in range(plan.m_tiles):
        m0 = mz * MP
        rows = min(MP, M - m0)
        xt = np.zeros((MP, plan.k_tiles * BK), np.float32)
        xt[:rows, :K] = x[m0:m0 + rows]
        for nb in range(plan.n_tiles):
            n0 = nb * BN
            parts = []
            for t0, nk in TQ.rank_tiles(plan.k_tiles, plan.splitk):
                D = np.zeros((2, 64, MP), np.float32)
                for i in range(nk):
                    k0 = (t0 + i) * BK
                    flat = w_stage(qpad, k0, n0)
                    for kk in range(BK // 16):
                        B = xt[:, k0 + 16 * kk:k0 + 16 * kk + 16].T            # [16 k, 64 m]
                        D = (D + a_fragments(flat, kk) @ B).astype(np.float32)
                part = np.zeros((MP, BN), np.float32)
                for jj in range(2):
                    part[:, COLS[jj]] = D[jj].T
                parts.append(part)
            total = parts[0]
            for p in parts[1:]:                    # the cluster sum, in rank order
                total = (total + p).astype(np.float32)
            total = (total * spad[n0:n0 + BN]).astype(np.float32)   # then the scale
            ncols = min(BN, N - n0)
            out[m0:m0 + rows, n0:n0 + ncols] = total[:rows, :ncols]
    return out


def _inputs(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    q, s = JQ.quantize_int8(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32)))
    return x, np.array(q), np.array(s)


# (M, K, N, resident clusters): the split plan differs in each. 5 rows (one
# 64-row block, 59 padding rows), 2 ranks over 4 tiles, N 272 (two
# 128-column blocks and 16 columns); 70 rows (two 64-row blocks), K 1408 =
# 11 tiles over 8 ranks of 2 or 1; 33 rows, K 4104 = 32 tiles and 8 rows
# (the tail zero-filled) over 8 ranks of 5 or 4, N 48 (one partial block)
CASES = [(5, 512, 272, (4, 4, 1, 1), 2), (70, 1408, 256, (16, 8, 4, 4), 8),
         (33, 4104, 48, H100, 8)]


@pytest.mark.parametrize("M,K,N,resident,splitk", CASES)
def test_emulation_matches_plain_and_pallas_in_f32(M, K, N, resident, splitk):
    """With f32 x the emulation equals int8_matmul_plain and JAX's
    int8_matmul(interpret=True) within 1e-5 of the largest output. Not
    bit-equal: the kernel sums k16 steps, tiles and ranks in f32 in its own
    order, the others in theirs."""
    x, q, s = _inputs(M + K, M, K, N)
    assert TQ.q8_plan(M, K, N, SMS, resident).splitk == splitk
    got = emulate(x, q, s, resident)
    plain = TQ.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                                 torch.from_numpy(s)).numpy()
    pallas = np.asarray(JQ.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                       block_m=64, block_n=128, block_k=1024, interpret=True))
    scale = np.abs(plain).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("M,K,N,resident,splitk", CASES)
def test_emulation_matches_plain_and_pallas_in_bf16(M, K, N, resident, splitk):
    """With bf16 x (the widened weights are exact, so nothing else rounds
    before the sum) the f32 sums agree with a float64 product of the same
    operands within 1e-5 of the largest, and the bf16 outputs with the plain
    version's and JAX's bf16 Pallas kernel's within two bf16 steps (2^-7) of
    it."""
    x, q, s = _inputs(M * K, M, K, N)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xr = xb.float().numpy()
    got = emulate(xr, q, s, resident)
    exact = (xr.astype(np.float64) @ q.astype(np.float64)) * s.astype(np.float64)
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5 * scale)
    out = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
    plain = TQ.int8_matmul_plain(xb, torch.from_numpy(q), torch.from_numpy(s)).float().numpy()
    np.testing.assert_allclose(out, plain, rtol=0, atol=2.0 ** -7 * scale)
    pallas = JQ.int8_matmul(jnp.asarray(xr, jnp.bfloat16), jnp.asarray(q), jnp.asarray(s),
                            block_m=64, block_n=128, block_k=1024, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas.astype(jnp.float32)), rtol=0,
                               atol=2.0 ** -7 * scale)


def test_widening_is_exact_for_every_byte():
    """s8x2 gives every signed byte value exactly, in each of the word's 4
    positions, as the low and as the high half, with no rounding in the
    bf16x2 add."""
    byte = np.arange(256, dtype=np.uint32)
    want = byte.astype(np.uint8).view(np.int8).astype(np.float32)
    other = np.uint32(0x5AC3E17F)  # the bytes of the other word must not leak in
    for j in range(4):
        word_ = (byte << np.uint32(8 * j)) | (other & ~np.uint32(0xFF << (8 * j)))
        lo, _ = s8x2(word_, np.full_like(word_, other), j)
        _, hi = s8x2(np.full_like(word_, other), word_, j)
        np.testing.assert_array_equal(lo, want)
        np.testing.assert_array_equal(hi, want)
        v = bf16_value((byte & 0x7F) | 0x4300)
        s = bf16_value((byte & 0x80) | 0xC300)
        assert np.array_equal(v + s, bf16_round(v + s))  # the add is exact


def test_lane_words_are_the_columns_pairs():
    """Each lane's 4 word reads of the swizzled stage are the words of
    columns c0 .. c0 + 3 in rows 16 kk + 2t, + 1, + 8, + 9."""
    rng = np.random.default_rng(0)
    q = rng.integers(-128, 128, size=(BK, BN)).astype(np.int8)
    flat = w_stage(q, 0, 0)
    u = q.view(np.uint8).astype(np.uint32)
    for w in range(4):
        c0 = 32 * w + 4 * G
        for kk in range(BK // 16):
            for addr, dr in zip(load_addresses(w, kk), (0, 1, 8, 9)):
                r = 16 * kk + 2 * T + dr
                want = sum(u[r, c0 + i] << np.uint32(8 * i) for i in range(4))
                np.testing.assert_array_equal(word(flat, addr), want)


def test_column_permutation_and_banks():
    """wgmma jj's row 16 w + g + 8 h is the block's column 32 w + 4 g + 2 h +
    jj: a bijection of its 128 columns, which the epilogue's writes undo. A
    warp's 32 word reads of one load fall on 32 distinct banks in the
    128-byte-swizzled stage, and on 8 banks four times over in a plain
    row-major one."""
    assert sorted(COLS.ravel()) == list(range(BN))
    for w in range(4):
        c0 = 32 * w + 4 * G
        for kk in range(BK // 16):
            for addr, dr in zip(load_addresses(w, kk), (0, 1, 8, 9)):
                assert len(set((addr // 4) % 32)) == 32
                plain = (16 * kk + 2 * T + dr) * BN + c0
                assert len(set((plain // 4) % 32)) == 8


def test_swizzle_is_the_x_tile_layout():
    """The W stage's swizzle is the one of attention_common's x tiles (a
    [64, 128] bf16 tile in two 8 KB halves of 128-byte rows, 16-byte chunk c
    of row r at chunk (c % 8) ^ (r % 8)), which the TMA box of 64 x 64 bf16
    writes: one 128-byte row of either is 8 chunks permuted by its row."""
    for r in range(16):
        chunks = [swizzle(r, 16 * c) - r * BN for c in range(8)]
        assert sorted(chunks) == [16 * c for c in range(8)]
        assert chunks == [16 * (c ^ (r % 8)) for c in range(8)]


DECODE = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]


@pytest.mark.parametrize("M", [1, 14, 16, 17, 25, 64, 65, 200, 256])
@pytest.mark.parametrize("K,N", DECODE + [(4104, 4112), (4224, 1024), (4104, 32000)])
def test_plan_covers_k_once(M, K, N):
    """Every K row is covered exactly once, on whole 128-row tiles (the last
    one zero-filled past K); the ranks differ by at most one tile; S is in
    {1, 2, 4, 8} and at most the tile count (no rank is empty); a block's
    shared memory is at most 227 KB; the m and n blocks cover M and N."""
    plan = TQ.q8_plan(M, K, N, SMS, H100)
    assert plan.splitk in (1, 2, 4, 8) and plan.splitk <= plan.k_tiles
    assert TQ.q8_smem_bytes() <= 227 * 1024
    assert plan.m_tiles * MP >= M > (plan.m_tiles - 1) * MP
    assert plan.n_tiles * BN >= N > (plan.n_tiles - 1) * BN
    assert plan.k_tiles * BK >= K > (plan.k_tiles - 1) * BK
    ranks = TQ.rank_tiles(plan.k_tiles, plan.splitk)
    rows = np.zeros(plan.k_tiles * BK, np.int64)
    for t0, nk in ranks:
        rows[t0 * BK:(t0 + nk) * BK] += 1
    assert (rows == 1).all()
    counts = [nk for _, nk in ranks]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1


def test_shared_memory_fits_three_blocks_an_sm():
    """Two 32 KB stages (x 16 KB + W 16 KB, no padding: the swizzle keeps
    the reads conflict-free), the barriers and the alignment: three blocks an
    SM within the H100's 228 KB (1 KB of it reserved a block), which is what
    the registers are sized for (MINB 3)."""
    smem = TQ.q8_smem_bytes()
    assert smem == 2 * 32768 + 32 + 1024 == 66592
    assert 3 * (smem + 1024) <= 228 * 1024 < 4 * (smem + 1024)


def test_plan_at_the_decode_shapes():
    """At M 64 with the H100's resident clusters of K1: the splits that
    scripts/torch_int8_kernel.py timed fastest at the decode shapes."""
    got = {(K, N): TQ.q8_plan(64, K, N, SMS, H100) for K, N in DECODE}
    assert [p.splitk for p in got.values()] == [8, 4, 8, 1]
    assert got[(4096, 32000)].n_tiles == 250
    assert all(p.m_tiles == 1 for p in got.values())
