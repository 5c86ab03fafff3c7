"""Row 7's kernel (csrc/int4_matmul.cu) emulated in numpy on the CPU: its
split plan (ops/quant.q4_plan), the per-lane word reads of the packed
weights, the column permutation and its inverse, the nibbles widened into
wgmma A fragments (two wgmmas of 64 output columns x 16 k a warpgroup, A
from registers),
x as the wgmma B operand, and the fixed-order sum over the cluster's K
ranks. The emulation is held against
`int4_matmul_plain` and the JAX package's Pallas kernel in interpret mode;
no GPU is needed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu_torch.ops import quant as TQ

BN, BK, MP, GROUP = TQ.Q4_BN, TQ.Q4_BK, TQ.Q4_MP, 128
WS = BN + 32          # byte row stride of a packed W stage
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4
SMS = 132                 # the H100's SMs
H100 = (396, 198, 92, 45)  # its resident clusters of 1, 2, 4, 8 blocks (chip_smoke.py)


def bf16_round(a):
    """f32 -> the nearest bf16 (ties to even), kept as f32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def widen(word, sc, round_bf16):
    """The kernel's widening of the uint32 `word` (4 packed bytes, byte j
    for wgmma j) with f32 scales sc[..., 4]: xor 0x88888888, the low and
    the high nibbles masked (0x0F0F0F0F), byte j moved into the mantissa of
    2^23 (prmt with 0x4B00, selector 0x5440 | j), minus 2^23 + 8, times the
    scale, rounded once to bf16 (x's type). -> (low, high), each [..., 4]."""
    u = word.astype(np.uint32) ^ np.uint32(0x88888888)
    out = []
    for nibs in (u & np.uint32(0x0F0F0F0F), (u >> np.uint32(4)) & np.uint32(0x0F0F0F0F)):
        byte = np.stack([(nibs >> np.uint32(8 * j)) & np.uint32(0xFF) for j in range(4)], -1)
        f = (np.uint32(0x4B000000) | byte).view(np.float32) - np.float32(8388616)
        v = (f * sc).astype(np.float32)
        out.append(bf16_round(v) if round_bf16 else v)
    return out


def words(q4, rows, cols):
    """The 32-bit little-endian words of q4 at rows[...] and the 4 columns
    from cols[...]."""
    b = q4[rows[..., None], cols[..., None] + np.arange(4)].astype(np.uint32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def a_fragments(qpad, spad, n0, k0, kk, round_bf16):
    """The A operands of k16 step kk of the tile at k0 as the lanes build
    them: [warpgroup, wgmma jj, 64 rows, 16 k]. Lane (g, t) of warp w of
    warpgroup wg reads the words at columns c0 = 128 wg + 32 w + 4 g of
    packed rows 8 kk + t (k 2t, 2t + 1) and 8 kk + t + 4 (k 2t + 8, ..); byte
    j of a word goes to wgmma j & 1, row 16 w + g + 8 (j >> 1): the A
    registers a0 (row g, k 2t), a1 (row g + 8, k 2t), a2 (row g, k 2t + 8),
    a3 (row g + 8, k 2t + 8)."""
    wgs = BN // 128
    wg, w = np.meshgrid(np.arange(wgs), np.arange(4), indexing="ij")
    c0 = (128 * wg + 32 * w)[..., None] + 4 * G                          # [wg, w, lane]
    sc = spad[k0 // GROUP][n0 + c0[..., None] + np.arange(4)]            # [wg, w, lane, j]
    A = np.zeros((wgs, 2, 64, 16), np.float32)
    for dk in (0, 8):
        pr = k0 // 2 + 8 * kk + T + dk // 2                               # [lane]
        word = words(qpad, np.broadcast_to(pr, c0.shape), n0 + c0)
        lo, hi = widen(word, sc, round_bf16)                              # [wg, w, lane, j]
        for j in range(4):
            row = 16 * w[..., None] + G + 8 * (j >> 1)                   # [wg, w, lane]
            for iw in range(wgs):
                A[iw, j & 1, row[iw], 2 * T + dk] = lo[iw, ..., j]
                A[iw, j & 1, row[iw], 2 * T + dk + 1] = hi[iw, ..., j]
    return A


def emulate(x, q4, scale, resident, round_bf16):
    """out[M, N] in f32 (before the final bf16 rounding), computed as the
    kernel does, block by block."""
    M, K = x.shape
    N = q4.shape[1]
    plan = TQ.q4_plan(M, K, N, SMS, resident)
    out = np.zeros((M, N), np.float32)
    # column n0 + c of a block reads zeros past N (zero-filled copies)
    qpad = np.zeros((K // 2, plan.n_tiles * BN), np.uint8)
    qpad[:, :N] = q4
    spad = np.zeros((K // GROUP, plan.n_tiles * BN), np.float32)
    spad[:, :N] = scale
    ranks = TQ.rank_tiles(plan.k_tiles, plan.splitk)
    # warpgroup wg's wgmma jj row 16 w + g + 8 h is column 128 wg + 32 w +
    # 4 g + 2 h + jj
    wgs = BN // 128
    r = np.arange(64)
    cols = np.array([[128 * iw + 32 * (r // 16) + 4 * (r % 8) + 2 * ((r % 16) // 8) + jj
                      for jj in range(2)] for iw in range(wgs)])           # [wg, jj, row]
    assert sorted(cols.ravel()) == list(range(BN))
    for mz in range(plan.m_tiles):
        m0 = mz * MP
        rows = min(MP, M - m0)
        xt = np.zeros((MP, K), np.float32)
        xt[:rows] = x[m0:m0 + rows]
        for nb in range(plan.n_tiles):
            n0 = nb * BN
            parts = []
            for t0, nk in ranks:
                D = np.zeros((wgs, 2, 64, MP), np.float32)
                for i in range(nk):
                    k0 = (t0 + i) * BK
                    for kk in range(BK // 16):
                        A = a_fragments(qpad, spad, n0, k0, kk, round_bf16)
                        B = xt[:, k0 + 16 * kk:k0 + 16 * kk + 16].T            # [16 k, 64 m]
                        D = (D + A @ B).astype(np.float32)
                part = np.zeros((MP, BN), np.float32)
                for iw in range(wgs):
                    for jj in range(2):
                        part[:, cols[iw, jj]] = D[iw, jj].T
                parts.append(part)
            total = np.zeros((MP, BN), np.float32)
            for p in parts:                    # the cluster sum, in rank order
                total = (total + p).astype(np.float32)
            ncols = min(BN, N - n0)
            out[m0:m0 + rows, n0:n0 + ncols] = total[:rows, :ncols]
    return out


def _inputs(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    q, s = JQ.quantize_int4(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32)))
    return x, np.array(q), np.array(s)


# (M, K, N, resident clusters): the split plan differs in each. 5 rows (one
# 64-row block, 59 padding rows), 2 ranks over 4 tiles, N 272 (two
# 128-column blocks and 16 columns); 70 rows (two 64-row blocks), K 1408 =
# 11 tiles over 8 ranks of 2 or 1; 33 rows, K of 33 tiles over 8 ranks of 5
# or 4, N 48 (one partial block)
CASES = [(5, 512, 272, (4, 4, 1, 1)), (70, 1408, 256, (16, 8, 4, 4)), (33, 4224, 48, H100)]


@pytest.mark.parametrize("M,K,N,resident", CASES)
def test_emulation_matches_plain_and_pallas_in_f32(M, K, N, resident):
    """With f32 x (no rounding of the widened weights) the emulation equals
    int4_matmul_plain and JAX's int4_matmul(interpret=True) within 1e-5 of
    the largest output. Not bit-equal: the kernel sums k16 steps, tiles and
    ranks in f32 in its own order, the others in theirs."""
    x, q, s = _inputs(M + K, M, K, N)
    assert TQ.q4_plan(M, K, N, SMS, resident).splitk == (2 if K == 512 else 8)
    got = emulate(x, q, s, resident, round_bf16=False)
    plain = TQ.int4_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                                 torch.from_numpy(s)).numpy()
    pallas = np.asarray(JQ.int4_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                       block_m=64, block_n=128, block_k=1024, interpret=True))
    scale = np.abs(plain).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("M,K,N,resident", CASES)
def test_emulation_matches_plain_in_bf16(M, K, N, resident):
    """With bf16 x the kernel rounds each widened weight to bf16 before the
    product, as the plain version does: the f32 sums agree with a float64
    product of the same bf16 operands within 1e-5 of the largest, and the
    bf16 outputs with the plain version's within one bf16 step (2^-8) of
    it."""
    x, q, s = _inputs(M * K, M, K, N)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xr = xb.float().numpy()
    got = emulate(xr, q, s, resident, round_bf16=True)
    w = TQ.dequantize_int4(torch.from_numpy(q), torch.from_numpy(s), torch.bfloat16)
    exact = xr.astype(np.float64) @ w.float().numpy().astype(np.float64)
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5 * scale)
    plain = TQ.int4_matmul_plain(xb, torch.from_numpy(q), torch.from_numpy(s)).float().numpy()
    out = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(out, plain, rtol=0, atol=2.0 ** -8 * scale)


def test_widening_is_exact_for_every_byte():
    """The kernel's nibble trick gives the sign-extended values of
    unpack_int4 for all 256 bytes in each of the word's 4 positions, and
    q * scale rounded once to bf16."""
    byte = np.arange(256, dtype=np.uint32)
    want = TQ.unpack_int4(torch.from_numpy(byte.astype(np.uint8)[None, :])).numpy()
    sc = np.array([1.0, 0.0123, 3.5, 1e-3], np.float32)
    for j in range(4):
        lo, hi = widen(byte << np.uint32(8 * j), sc, round_bf16=False)
        np.testing.assert_array_equal(lo[:, j], want[0].astype(np.float32) * sc[j])
        np.testing.assert_array_equal(hi[:, j], want[1].astype(np.float32) * sc[j])
        lo, _ = widen(byte << np.uint32(8 * j), sc, round_bf16=True)
        ref = (torch.from_numpy(want[0].astype(np.float32)) * float(sc[j])).to(torch.bfloat16)
        np.testing.assert_array_equal(lo[:, j], ref.float().numpy())


def test_column_permutation_and_banks():
    """Warpgroup wg's wgmma jj row 16 w + g + 8 h is the block's column
    128 wg + 32 w + 4 g + 2 h + jj: a bijection of its columns, which the
    epilogue's writes undo. A warp's 32 word reads of one load (packed row
    8 kk + t or 8 kk + t + 4, columns c0) fall on 32 distinct banks with the
    row stride BN + 32 bytes, and on 8 banks four times over without the
    padding."""
    cols = [128 * wg + 32 * w + 4 * g + 2 * h + jj for wg in range(BN // 128) for w in range(4)
            for g in range(8) for h in range(2) for jj in range(2)]
    assert sorted(cols) == list(range(BN))
    for warp in range(BN // 32):
        for kk in range(BK // 16):
            for dr in (0, 4):
                addr = (8 * kk + T + dr) * WS + 32 * warp + 4 * G
                assert len(set((addr // 4) % 32)) == 32
                flat = (8 * kk + T + dr) * BN + 32 * warp + 4 * G
                assert len(set((flat // 4) % 32)) == 8


DECODE = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]


@pytest.mark.parametrize("M", [1, 16, 17, 64, 65, 200, 256])
@pytest.mark.parametrize("K,N", DECODE + [(4224, 4096), (4096, 4112), (4224, 32000)])
def test_plan_covers_k_once(M, K, N):
    """Every K row is covered exactly once, on whole 128-row tiles (two
    64-row tiles, one scale group each); the ranks differ by at most one
    tile; S is in {1, 2, 4, 8} and at most the tile count (the grid's K
    axis is one cluster of S, so no rank is empty); a block's shared memory
    is at most 227 KB; the m and n blocks cover M and N."""
    plan = TQ.q4_plan(M, K, N, SMS, H100)
    assert plan.splitk in (1, 2, 4, 8) and plan.splitk <= plan.k_tiles
    assert TQ.q4_smem_bytes() <= 227 * 1024
    assert plan.m_tiles * MP >= M > (plan.m_tiles - 1) * MP
    assert plan.n_tiles * BN >= N > (plan.n_tiles - 1) * BN
    ranks = TQ.rank_tiles(plan.k_tiles, plan.splitk)
    rows = np.zeros(K, np.int64)
    for t0, nk in ranks:
        for tile in range(t0, t0 + nk):
            k0 = tile * BK
            assert k0 % GROUP == 0 and BK == GROUP
            rows[k0:k0 + BK] += 1
    assert (rows == 1).all()
    counts = [nk for _, nk in ranks]
    assert max(counts) - min(counts) <= 1


def test_plan_at_the_decode_shapes():
    """At M 64 with the H100's resident clusters, the splits that
    scripts/torch_int4_probe.py timed fastest: the 4096-column matrices 8
    ways (32 clusters of 8, 256 blocks), gate/up's 86 column tiles 4 ways,
    down_proj's 86 tiles 8 ways (11 or 10 a rank), the lm_head's 250 column
    tiles not at all."""
    got = {(K, N): TQ.q4_plan(64, K, N, SMS, H100) for K, N in DECODE}
    assert [p.splitk for p in got.values()] == [8, 4, 8, 1]
    assert {nk for _, nk in TQ.rank_tiles(86, 8)} == {10, 11}
    assert got[(4096, 32000)].n_tiles == 250
    assert all(p.m_tiles == 1 for p in got.values())
