// Forward attention with an online softmax: kernel K2 for the stage-1
// prefill, the forward of row 4 (training) and row 5, which also write the
// per-row log-sum-exp, and row 6, the shared-prefix prefill's attention over
// a broadcast prefix and the row's own causal block. One tile step serves
// all four.
//
// K2 replaces the Pallas kernel revisionllm_tpu/ops/flash_attention.py:40
// _flash_kernel (entry flash_attention :119, pallas_call :191). The LSE
// forward replaces _flash_fwd_lse_kernel :352, reached from make_flash_mha
// :526 (row 4, pallas_call :584; its backward kernels are in
// flash_attention_vjp.cu) and from flash_attention_lse :721 (row 5,
// pallas_call :778, where S != T and causal may be off). The prefix kernel
// replaces _flash_prefix_kernel :859 (entry flash_attention_prefixed :945,
// pallas_call :1020).
//
// q [B, T, H, d], k/v [B, S, KH, d] bf16, per-row kv_lens [B], causal as
// row >= col from 0, GQA through kv head = h / (H / KH), f32 running max m,
// sum l and accumulator, with the same NEG_INF = -2e30 masking, so the maths
// matches mha_reference and rows that see no key give 0. The LSE entry
// stores lse = m + log(l) per row in f32 as [B, H, T] (JAX's lane-replicated
// [.., 128] layout is a Mosaic constraint and is not copied), and +2e30 for
// a row with l == 0, so that the backward's exp(s - lse) is 0 there. The
// prefix entry walks the prefix pk/pv [1, P, KH, d] (batch stride 0, every
// column < P visible to every row), then the row's own k/v [B, T, KH, d]
// causally in local positions below rest_lens[b], under one online softmax,
// and writes no LSE.
//
// What bounds it on the H100: bytes at the stage-1 shapes (B = 64, H = 32,
// T = S = 318, d = 128, causal): one layer reads and writes 0.67 GB of
// q/k/v/o bf16 (about 0.2 ms at 3.35 TB/s) but does only about 53 GFLOP of
// products (0.05 ms on the bf16 tensor cores). Operations at the training
// shape (B = 1, H = 32, T = 2048, causal): 34 GFLOP at full length, 35 us at
// 989 TFLOP/s against 15 us of bytes.
//
// The design is FlashAttention-2's with Hopper's wgmma for both products
// (attention_common.cuh): one block of one warpgroup (4 warps) per (q tile
// of 64 rows, head, batch row); the TPU grid's sequential kv axis becomes a
// loop inside the block (for the prefix kernel one loop over the prefix
// tiles, then the causal tiles). Each warp loads its 16 query rows once, by
// ldmatrix, into A fragments and keeps them in registers. K/V tiles of 64
// rows arrive through a two-stage cp.async ring in the 128-byte-swizzled
// layout; S = Q K^T is wgmma.m64n64k16 with K as a K-major descriptor, O +=
// P V is wgmma.m64n128k16 with V as a transposed (MN-major) descriptor, both
// with A from registers. The online softmax (a row's m and l in the 4 lanes
// of a quad, l summed per lane and reduced once at the end), P rounded to
// bf16 (as the Pallas bodies cast p to v's type) and the alpha rescale of O
// all stay in registers. The causal and kv_lens mask is applied only on
// tiles that cross the diagonal or kv_len. Tiles in the causal future and
// tiles at or past kv_lens[b] are never loaded, as the Pallas kernels skip
// them with pl.when; the causal q tiles are launched longest first. o leaves
// through shared memory in 16-byte stores. 84,224 B of shared memory a
// block, so two blocks share an SM.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W: K2
// 0.2621 ms a stage-1 layer (bound 0.180 ms, bytes); row 4's forward 0.1200
// ms at full length (bound 0.0348 ms, operations) and 0.0502 ms at kv_len
// 330; row 5 0.2496 ms and row 6 0.3045 ms at stage 1 (PERF.md's kernel
// table).
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/flash_attention.py.

#include "attention_common.cuh"

using namespace attn;

namespace {

constexpr int STAGES = 2;                        // cp.async ring depth
constexpr int KV_BYTES = SW_TILE_BYTES;          // one swizzled K or V tile: 16 KB
constexpr size_t RING_OFF = 0;                   // STAGES x (K, V), 1024-aligned
constexpr size_t Q_OFF = STAGES * 2 * KV_BYTES;  // the q tile (padded), then o's staging
constexpr size_t LSE_OFF = Q_OFF + TILE_BYTES;
constexpr size_t SMEM_BYTES = LSE_OFF + TILE * 4 + 1024;  // + alignment slack

// one kv tile of a block's walk: rows s0 .. s0 + TILE - 1 of k/v, where row s
// of kv head kh starts at k + s * stride; column col is live when col < limit
// and, when causal, query row >= col; rows at or past min(rows, limit) are
// loaded as zeros
struct KvTile {
  const bf16* k;
  const bf16* v;
  size_t stride;
  int s0, rows, limit, causal;
};

// the walk of K2 and rows 4-5: ceil(kv_end / TILE) tiles of one k/v
struct PlainWalk {
  const bf16 *k, *v;
  size_t stride;
  int S, kv_len, causal;
  __device__ KvTile operator()(int j) const {
    return KvTile{k, v, stride, j * TILE, S, kv_len, causal};
  }
};

// the walk of row 6: n_prefix tiles of the prefix, then the causal tiles of
// the row's own k/v
struct PrefixWalk {
  const bf16 *pk, *pv, *k, *v;
  size_t stride;
  int P, T, rest_len, n_prefix;
  __device__ KvTile operator()(int j) const {
    if (j < n_prefix) return KvTile{pk, pv, stride, j * TILE, P, P, 0};
    return KvTile{k, v, stride, (j - n_prefix) * TILE, T, rest_len, 1};
  }
};

__device__ __forceinline__ void copy_kv_async(unsigned char* stage, const KvTile& t) {
  const int valid = min(t.rows, t.limit) - t.s0;
  load_tile_sw128(stage, t.k + (size_t)t.s0 * t.stride, t.stride, valid);
  load_tile_sw128(stage + KV_BYTES, t.v + (size_t)t.s0 * t.stride, t.stride, valid);
}

// one kv tile of the warpgroup: S = Q K^T, the online softmax update of m,
// l and o, O += P V. Row g of a warp is query row0, row g + 8 is row0 + 8.
// Scores are kept in log2 units (scale2 = sm_scale * log2 e).
template <bool MASK>
__device__ __forceinline__ void kv_step(uint32_t (&qf)[D / 16][4], float (&o)[D / 8][4],
                                        float (&m)[2], float (&l)[2], const unsigned char* ks,
                                        const unsigned char* vs, const KvTile& t, int row0,
                                        float scale2, int lane) {
  float s[TILE / 8][4];
  pin<TILE / 8>(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T, K read K-major
    wgmma_m64n64k16(s, qf[kk], k_major(ks, kk), kk > 0);
  wgmma_commit();
  wgmma_wait0();
  pin<TILE / 8>(s);
  pin<D / 16>(qf);
  const int c0 = t.s0 + 2 * (lane & 3);
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * scale2;
      if (MASK) {
        const int col = c0 + n * 8 + (e & 1), row = row0 + (e >> 1) * 8;
        if (!(col < t.limit && (!t.causal || row >= col))) x = NEG_INF;
      }
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a masked entry is 0 even while its row has seen no live column
      const float p = (MASK && s[n][e] == NEG_INF) ? 0.0f : ex2(s[n][e] - m[e >> 1]);
      s[n][e] = p;
      l[e >> 1] += p;
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
  uint32_t pa[TILE / 16][4];
  pack_a<TILE>(pa, s);
  pin<D / 8>(o);
  pin<TILE / 16>(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)  // O += P V, V read MN-major
    wgmma_m64n128k16_tb(o, pa[kk], mn_major(vs, kk), 1);
  wgmma_commit();
  wgmma_wait0();
  pin<D / 8>(o);
  pin<TILE / 16>(pa);
}

// the whole forward of one block: q rows q0 .. q0 + TILE - 1 of head h of
// batch row b (q [B, T, H, D]), over n_tiles kv tiles of `walk`; writes o
// and, unless lse == nullptr, lse [B, H, T]
template <class Walk>
__device__ __forceinline__ void attend(const Walk& walk, int n_tiles, const bf16* __restrict__ q,
                                       bf16* __restrict__ out, float* __restrict__ lse, int b,
                                       int h, int q0, int T, int H, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem + Q_OFF);
  unsigned char* ring = smem + RING_OFF;
  float* lse_s = reinterpret_cast<float*>(smem + LSE_OFF);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t q_stride = (size_t)H * D;
  const size_t q_base = ((size_t)b * T + q0) * q_stride + (size_t)h * D;

  load_tile_async(qs, q + q_base, q_stride, T - q0);
  cp_async_commit();
  if (n_tiles > 0) copy_kv_async(ring, walk(0));
  cp_async_commit();
  cp_async_wait<1>();  // the q tile has landed
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_a(qf, qs + warp * 16 * DS, lane);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const float scale2 = sm_scale * LOG2E;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) copy_kv_async(ring + ((j + 1) % STAGES) * 2 * KV_BYTES, walk(j + 1));
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    fence_proxy_async();  // ... and is visible to wgmma's reads
    __syncthreads();
    const KvTile t = walk(j);
    const unsigned char* ks = ring + (j % STAGES) * 2 * KV_BYTES;
    // interior tiles (wholly below kv_len and the diagonal) take no mask
    const bool full = t.s0 + TILE <= t.limit && (!t.causal || t.s0 + TILE - 1 <= q0);
    if (full)
      kv_step<false>(qf, o, m, l, ks, ks + KV_BYTES, t, row0, scale2, lane);
    else
      kv_step<true>(qf, o, m, l, ks, ks + KV_BYTES, t, row0, scale2, lane);
    __syncthreads();  // stage j % STAGES is free for tile j + STAGES
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;  // a row with no key gives 0
  }
  // each warp stages its own 16 rows of the q tile, which only it read
  store_rows(o, inv[0], inv[1], qs + warp * 16 * DS, out + q_base + (size_t)warp * 16 * q_stride,
             q_stride, T - q0 - warp * 16, lane);
  if (lse != nullptr) {
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        lse_s[warp * 16 + (lane >> 2) + 8 * r] =
            l[r] > 0.0f ? (m[r] + log2f(l[r])) * LN2 : LSE_EMPTY;
    }
    __syncwarp();
    const int row = q0 + warp * 16 + lane;
    if (lane < 16 && row < T) lse[((size_t)b * H + h) * T + row] = lse_s[warp * 16 + lane];
  }
}

// the causal q tiles run longest first
__device__ __forceinline__ int q_tile(int causal) {
  return causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
}

// the forward of K2 and rows 4-5 over k/v [B, S, KH, D]; lse == nullptr
// skips the LSE output
__device__ __forceinline__ void flash_fwd_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ kv_lens, bf16* __restrict__ out, float* __restrict__ lse, int T,
    int S, int H, int KH, float sm_scale, int causal) {
  const int q0 = q_tile(causal) * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int kv_len = max(0, min(kv_lens[b], S));
  // live kv tiles start below kv_len and, when causal, at or before the last
  // query row of this tile
  const int kv_end = causal ? min(kv_len, q0 + TILE) : kv_len;
  const size_t stride = (size_t)KH * D;
  const size_t off = (size_t)b * S * stride + (size_t)kh * D;
  const PlainWalk walk{k + off, v + off, stride, S, kv_len, causal};
  attend(walk, (kv_end + TILE - 1) / TILE, q, out, lse, b, h, q0, T, H, sm_scale);
}

// K2 (prefill)
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ kv_lens, bf16* __restrict__ out, int T, int S, int H, int KH,
    float sm_scale, int causal) {
  flash_fwd_body(q, k, v, kv_lens, out, nullptr, T, S, H, KH, sm_scale, causal);
}

// rows 4 and 5: the same, plus the per-row LSE
__global__ void __launch_bounds__(THREADS) flash_fwd_lse_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ kv_lens, bf16* __restrict__ out, float* __restrict__ lse, int T,
    int S, int H, int KH, float sm_scale, int causal) {
  flash_fwd_body(q, k, v, kv_lens, out, lse, T, S, H, KH, sm_scale, causal);
}

// row 6: the prefix tiles (every column < P visible), then this row's causal
// tiles in local positions below rest_lens[b], under one online softmax
__global__ void __launch_bounds__(THREADS) flash_prefix_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ pk, const bf16* __restrict__ pv, const int* __restrict__ rest_lens,
    bf16* __restrict__ out, int T, int P, int H, int KH, float sm_scale) {
  const int q0 = q_tile(1) * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int rest_len = max(0, min(rest_lens[b], T));
  const int kv_end = min(rest_len, q0 + TILE);
  const int n_prefix = (P + TILE - 1) / TILE;
  const size_t stride = (size_t)KH * D;
  const size_t off = (size_t)b * T * stride + (size_t)kh * D;
  // batch stride 0: every row reads the same prefix
  const PrefixWalk walk{pk + kh * D, pv + kh * D, k + off, v + off, stride, P, T, rest_len,
                        n_prefix};
  attend(walk, n_prefix + (kv_end + TILE - 1) / TILE, q, out, nullptr, b, h, q0, T, H, sm_scale);
}

}  // namespace

// dynamic shared memory of each forward block (the same for all three)
extern "C" int flash_fwd_smem_bytes() { return (int)SMEM_BYTES; }

// q [B, T, H, D], k/v [B, S, KH, D] bf16 contiguous, kv_lens [B] int32 (each
// <= S), out [B, T, H, D] bf16. D = 128 (Vicuna's head_dim); H % KH == 0.
extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                   const void* kv_lens, void* out, int B, int T,
                                   int S, int H, int KH, int d, float sm_scale,
                                   int causal, void* stream) {
  if (d != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TILE - 1) / TILE, H, B);
  flash_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_lens), static_cast<bf16*>(out), T, S, H, KH, sm_scale, causal);
  return (int)cudaGetLastError();
}

// q [B, T, H, D], k/v [B, S, KH, D] bf16 contiguous, kv_lens [B] int32 (each
// <= S), out [B, T, H, D] bf16, lse [B, H, T] f32. D = 128; H % KH == 0.
extern "C" int flash_fwd_lse_bf16(const void* q, const void* k, const void* v,
                                  const void* kv_lens, void* out, void* lse, int B, int T,
                                  int S, int H, int KH, int d, float sm_scale, int causal,
                                  void* stream) {
  if (d != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_lse_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TILE - 1) / TILE, H, B);
  flash_fwd_lse_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_lens), static_cast<bf16*>(out), static_cast<float*>(lse), T, S,
      H, KH, sm_scale, causal);
  return (int)cudaGetLastError();
}

// q [B, T, H, D], k/v [B, T, KH, D], prefix pk/pv [1, P, KH, D] bf16
// contiguous, rest_lens [B] int32 (each <= T), out [B, T, H, D] bf16.
// D = 128; H % KH == 0; P >= 1.
extern "C" int flash_prefix_fwd_bf16(const void* q, const void* k, const void* v,
                                     const void* pk, const void* pv, const void* rest_lens,
                                     void* out, int B, int T, int P, int H, int KH, int d,
                                     float sm_scale, void* stream) {
  if (d != D || P < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_prefix_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TILE - 1) / TILE, H, B);
  flash_prefix_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(pk), static_cast<const bf16*>(pv),
      static_cast<const int*>(rest_lens), static_cast<bf16*>(out), T, P, H, KH, sm_scale);
  return (int)cudaGetLastError();
}
