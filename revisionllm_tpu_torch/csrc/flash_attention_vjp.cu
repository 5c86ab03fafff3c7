// Row 4, backward: dq and dk/dv of flash attention for training, q/k/v
// [B, T, H|KH, 128] bf16 with T == S. The forward with the per-row
// log-sum-exp is row 4's third kernel, flash_fwd_lse_kernel, which shares
// kernel K2's tile step in flash_attention.cu.
//
// Replaces the Pallas bodies of revisionllm_tpu/ops/flash_attention.py
// behind make_flash_mha (:526):
//   flash_dq_kernel   <- _flash_dq_kernel  :415 (pallas_call :620)
//   flash_dkv_kernel  <- _flash_dkv_kernel :464 (pallas_call :647)
// with the same maths: scores in f32 times sm_scale under the causal and
// kv_lens mask, p = exp(s - lse) rebuilt from the forward's LSE ([B, H, T]
// f32; +2e30 for a row that sees no key, so its p is 0), ds = p * (dp - delta)
// * sm_scale with delta = rowsum(dO * O) (computed outside, as JAX does at
// :608), and p / ds rounded to bf16 before each product, as the Pallas bodies
// cast them (:455, :501, :512). GQA indexes kv head h / (H / KH); the dk/dv
// block of a kv head loops over the query heads of its group and sums in f32,
// so no repeated k/v and no group-sum pass exist.
//
// What bounds them on the H100: operations at the training shape (B = 1,
// H = 32, T = 2048, d = 128, causal, full length): 3 (dq) or 4 (dk/dv)
// products of 2 * T^2 / 2 * H * d flops each, 52 and 69 us at 989 TFLOP/s
// against 15-20 us of bytes; with the live kv_lens of a training batch (a
// few hundred of 2048 columns) most tiles are skipped and bytes bound them.
//
// The design is FlashAttention-2's with Hopper's wgmma for every product
// (attention_common.cuh), and it stays two kernels: dq owns a q tile and
// loops over kv tiles; dk/dv owns a kv tile and loops over q tiles, so every
// block owns its output tile: no atomics, deterministic sums (S and dP are
// computed in both, 7 products where one fused kernel with f32 atomics on dq
// would take 5). A block is one warpgroup (4 warps, 16 rows each) over a
// 64-row tile; the tiles it walks stream through a two-stage cp.async ring in
// the 128-byte-swizzled layout.
//   dq: Q and dO sit in registers as A fragments (ldmatrix, once); per K/V
//   tile, S = Q K^T and dP = dO V^T are wgmma.m64n64k16 with K and V read
//   K-major, and stay in registers; dS is rounded to bf16 and repacked there
//   as the A fragments of dQ += dS K, wgmma.m64n128k16 with K read MN-major.
//   dk/dv: K and V stay in shared memory as the A operands of S^T = K Q^T and
//   dP^T = V dO^T (wgmma with both operands from shared memory: dK and dV,
//   64 x 128 f32 over the warpgroup, hold 128 registers a thread already);
//   Q/dO tiles with their lse and delta rows stream through the ring. P^T
//   and dS^T are rounded to bf16 and repacked in registers as the A
//   fragments of dV += P^T dO and dK += dS^T Q, dO and Q read MN-major.
// The mask is applied only on tiles that cross the diagonal, kv_len or T.
// Tiles in the causal future and tiles at or past kv_lens[b] are never
// loaded, as the Pallas kernels skip them with pl.when; causal q tiles (dq)
// and kv tiles (dk/dv) are launched longest first. Outputs leave through
// shared memory in 16-byte stores. About 100 KB of shared memory a block, so
// two blocks share an SM.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W: dq
// 0.1328 ms and dk/dv 0.1785 ms at full length (bounds 0.0521 and 0.0695
// ms, operations), 0.0562 and 0.0832 ms at kv_len 330 (PERF.md's kernel
// table).
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/flash_attention.py.

#include "attention_common.cuh"

using namespace attn;

namespace {

constexpr int STAGES = 2;  // cp.async ring depth

// the causal tiles run longest first
__device__ __forceinline__ int grid_tile(int causal) {
  return causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
}

// ------------------------------------------------------------------ dq

// STAGES x (K, V) swizzled, the padded q tile (then dq's staging), the
// padded dO tile, and slack to align the ring
constexpr size_t DQ_RING_OFF = 0;
constexpr size_t DQ_Q_OFF = STAGES * 2 * SW_TILE_BYTES;
constexpr size_t DQ_DO_OFF = DQ_Q_OFF + TILE_BYTES;
constexpr size_t DQ_SMEM_BYTES = DQ_DO_OFF + TILE_BYTES + 1024;

// one kv tile of the warpgroup: S = Q K^T and dP = dO V^T, p = exp(s - lse)
// under the mask, dS = p (dP - delta) sm_scale, dQ += dS K. Row g of a warp
// is query row0, row g + 8 is row0 + 8; lse2 is in log2 units.
template <bool MASK>
__device__ __forceinline__ void dq_step(uint32_t (&qf)[D / 16][4], uint32_t (&df)[D / 16][4],
                                        float (&acc)[D / 8][4], const unsigned char* ks,
                                        const unsigned char* vs, const float (&lse2)[2],
                                        const float (&dl)[2], int s0, int kv_len, int causal,
                                        int row0, float scale2, float sm_scale, int lane) {
  float s[TILE / 8][4], dp[TILE / 8][4];
  pin<TILE / 8>(s);
  pin<TILE / 8>(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T
    wgmma_m64n64k16(s, qf[kk], k_major(ks, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)  // dP = dO V^T
    wgmma_m64n64k16(dp, df[kk], k_major(vs, kk), kk > 0);
  wgmma_commit();
  wgmma_wait0();
  pin<TILE / 8>(s);
  pin<TILE / 8>(dp);
  pin<D / 16>(qf);
  pin<D / 16>(df);
  const int c0 = s0 + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = ex2(s[n][e] * scale2 - lse2[r]);
      if (MASK) {
        const int col = c0 + n * 8 + (e & 1), row = row0 + 8 * r;
        if (!(col < kv_len && (!causal || row >= col))) p = 0.0f;
      }
      dp[n][e] = p * (dp[n][e] - dl[r]) * sm_scale;
    }
  }
  uint32_t da[TILE / 16][4];
  pack_a<TILE>(da, dp);
  pin<D / 8>(acc);
  pin<TILE / 16>(da);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)  // dQ += dS K
    wgmma_m64n128k16_tb(acc, da[kk], mn_major(ks, kk), 1);
  wgmma_commit();
  wgmma_wait0();
  pin<D / 8>(acc);
  pin<TILE / 16>(da);
}

__global__ void __launch_bounds__(THREADS) flash_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_lens, bf16* __restrict__ dq, int T, int H, int KH,
    float sm_scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem + DQ_RING_OFF;
  bf16* qs = reinterpret_cast<bf16*>(smem + DQ_Q_OFF);
  bf16* dos = reinterpret_cast<bf16*>(smem + DQ_DO_OFF);
  const int q0 = grid_tile(causal) * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv_len = max(0, min(kv_lens[b], T));
  const int kv_end = causal ? min(kv_len, q0 + TILE) : kv_len;
  const int n_tiles = (kv_end + TILE - 1) / TILE;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KH * D;
  const size_t q_base = ((size_t)b * T + q0) * q_stride + (size_t)h * D;
  const bf16* kb = k + (size_t)b * T * kv_stride + (size_t)kh * D;
  const bf16* vb = v + (size_t)b * T * kv_stride + (size_t)kh * D;

  load_tile_async(qs, q + q_base, q_stride, T - q0);
  load_tile_async(dos, dout + q_base, q_stride, T - q0);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile_sw128(ring, kb, kv_stride, kv_len);
    load_tile_sw128(ring + SW_TILE_BYTES, vb, kv_stride, kv_len);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a(qf, qs + warp * 16 * DS, lane);
  load_a(df, dos + warp * 16 * DS, lane);

  // this lane's two rows: their lse (log2 units) and delta; rows past T get
  // the empty-row LSE, so their p is 0
  const int row0 = q0 + warp * 16 + (lane >> 2);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    const size_t off = ((size_t)b * H + h) * T + t;
    lse2[r] = (t < T ? lse[off] : LSE_EMPTY) * LOG2E;
    dl[r] = t < T ? delta[off] : 0.0f;
  }
  const float scale2 = sm_scale * LOG2E;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      unsigned char* st = ring + ((j + 1) % STAGES) * 2 * SW_TILE_BYTES;
      const size_t off = (size_t)(j + 1) * TILE * kv_stride;
      load_tile_sw128(st, kb + off, kv_stride, kv_len - (j + 1) * TILE);
      load_tile_sw128(st + SW_TILE_BYTES, vb + off, kv_stride, kv_len - (j + 1) * TILE);
    }
    cp_async_commit();
    cp_async_wait<1>();   // tile j has landed
    fence_proxy_async();  // ... and is visible to wgmma's reads
    __syncthreads();
    const int s0 = j * TILE;
    const unsigned char* ks = ring + (j % STAGES) * 2 * SW_TILE_BYTES;
    // interior tiles (wholly below kv_len and the diagonal) take no mask
    const bool full = s0 + TILE <= kv_len && (!causal || s0 + TILE - 1 <= q0);
    if (full)
      dq_step<false>(qf, df, acc, ks, ks + SW_TILE_BYTES, lse2, dl, s0, kv_len, causal, row0,
                     scale2, sm_scale, lane);
    else
      dq_step<true>(qf, df, acc, ks, ks + SW_TILE_BYTES, lse2, dl, s0, kv_len, causal, row0,
                    scale2, sm_scale, lane);
    __syncthreads();  // stage j % STAGES is free for tile j + STAGES
  }
  cp_async_wait<0>();
  // each warp stages its own 16 rows of the q tile, which only it read
  store_rows(acc, 1.0f, 1.0f, qs + warp * 16 * DS, dq + q_base + (size_t)warp * 16 * q_stride,
             q_stride, T - q0 - warp * 16, lane);
}

// ------------------------------------------------------------------ dk, dv

// the swizzled K and V tiles, STAGES x (Q, dO) swizzled (after the loop,
// dk's and dv's staging), STAGES x (64 lse, 64 delta), slack to align
constexpr size_t DKV_K_OFF = 0;
constexpr size_t DKV_V_OFF = SW_TILE_BYTES;
constexpr size_t DKV_RING_OFF = 2 * SW_TILE_BYTES;
constexpr size_t DKV_STAT_OFF = DKV_RING_OFF + STAGES * 2 * SW_TILE_BYTES;
constexpr size_t DKV_SMEM_BYTES = DKV_STAT_OFF + STAGES * 2 * TILE * 4 + 1024;
static_assert(2 * SW_TILE_BYTES >= TILE_BYTES, "a ring stage holds a padded staging tile");

// the Q/dO tile of q rows q0.. of head h into a ring stage, and their lse and
// delta rows into `stats` (64 each)
__device__ __forceinline__ void copy_q_async(unsigned char* st, float* stats, const bf16* q,
                                        const bf16* dout, const float* lse, const float* delta,
                                        int b, int h, int q0, int T, int H) {
  const size_t q_stride = (size_t)H * D;
  const size_t base = ((size_t)b * T + q0) * q_stride + (size_t)h * D;
  load_tile_sw128(st, q + base, q_stride, T - q0);
  load_tile_sw128(st + SW_TILE_BYTES, dout + base, q_stride, T - q0);
  const int i = threadIdx.x;  // one f32 a thread: lse, then delta
  const int r = i & (TILE - 1);
  const size_t off = ((size_t)b * H + h) * T + q0;
  const bool ok = q0 + r < T;
  cp_async4(stats + i, (i < TILE ? lse : delta) + off + (ok ? r : 0), ok);
}
static_assert(THREADS == 2 * TILE, "copy_q_async copies one lse or delta value a thread");

// one q tile of the warpgroup: S^T = K Q^T and dP^T = V dO^T, P^T and
// dS^T under the mask, dV += P^T dO and dK += dS^T Q. Row g of a warp is kv
// row row0, row g + 8 is row0 + 8; lse_s and dl_s hold the tile's 64 q rows.
template <bool MASK>
__device__ __forceinline__ void dkv_step(float (&dk)[D / 8][4], float (&dv)[D / 8][4],
                                         const unsigned char* ks, const unsigned char* vs,
                                         const unsigned char* qs, const unsigned char* dos,
                                         const float* lse_s, const float* dl_s, int q0, int T,
                                         int kv_len, int causal, int row0, float scale2,
                                         float sm_scale, int lane) {
  float p[TILE / 8][4], ds[TILE / 8][4];
  pin<TILE / 8>(p);
  pin<TILE / 8>(ds);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)  // S^T = K Q^T: rows kv, columns q
    wgmma_m64n64k16_ss(p, k_major(ks, kk), k_major(qs, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V dO^T
    wgmma_m64n64k16_ss(ds, k_major(vs, kk), k_major(dos, kk), kk > 0);
  wgmma_commit();
  wgmma_wait0();
  pin<TILE / 8>(p);
  pin<TILE / 8>(ds);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < TILE / 8; ++n) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + n * 8 + c);
    const float2 d2 = *reinterpret_cast<const float2*>(dl_s + n * 8 + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = ex2(p[n][e] * scale2 - (e & 1 ? l2.y : l2.x) * LOG2E);
      if (MASK) {
        const int t = q0 + n * 8 + c + (e & 1), s = row0 + 8 * (e >> 1);
        if (!(t < T && s < kv_len && (!causal || t >= s))) x = 0.0f;
      }
      p[n][e] = x;
      ds[n][e] = x * (ds[n][e] - (e & 1 ? d2.y : d2.x)) * sm_scale;
    }
  }
  uint32_t pa[TILE / 16][4], da[TILE / 16][4];
  pack_a<TILE>(pa, p);
  pack_a<TILE>(da, ds);
  pin<D / 8>(dv);
  pin<D / 8>(dk);
  pin<TILE / 16>(pa);
  pin<TILE / 16>(da);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)  // dV += P^T dO
    wgmma_m64n128k16_tb(dv, pa[kk], mn_major(dos, kk), 1);
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)  // dK += dS^T Q
    wgmma_m64n128k16_tb(dk, da[kk], mn_major(qs, kk), 1);
  wgmma_commit();
  wgmma_wait0();
  pin<D / 8>(dv);
  pin<D / 8>(dk);
  pin<TILE / 16>(pa);
  pin<TILE / 16>(da);
}

__global__ void __launch_bounds__(THREADS) flash_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_lens, bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H,
    int KH, float sm_scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ks = smem + DKV_K_OFF;
  unsigned char* vs = smem + DKV_V_OFF;
  unsigned char* ring = smem + DKV_RING_OFF;
  float* stats = reinterpret_cast<float*>(smem + DKV_STAT_OFF);
  const int s0 = grid_tile(causal) * TILE, kh = blockIdx.y, b = blockIdx.z;
  const int group = H / KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv_len = max(0, min(kv_lens[b], T));
  const size_t kv_stride = (size_t)KH * D;
  const size_t kv_base = ((size_t)b * T + s0) * kv_stride + (size_t)kh * D;
  // a kv tile at or past kv_len gets no gradient (zeros are still written);
  // causal: q rows before s0 never see this tile
  const int q_start = causal ? s0 : 0;
  const int n_q = s0 < kv_len ? (T - q_start + TILE - 1) / TILE : 0;
  const int n_tiles = group * n_q;  // (query head of the group, q tile) pairs

  load_tile_sw128(ks, k + kv_base, kv_stride, kv_len - s0);
  load_tile_sw128(vs, v + kv_base, kv_stride, kv_len - s0);
  cp_async_commit();
  if (n_tiles > 0) copy_q_async(ring, stats, q, dout, lse, delta, b, kh * group, q_start, T, H);
  cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.0f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.0f;
  }
  const int row0 = s0 + warp * 16 + (lane >> 2);
  const float scale2 = sm_scale * LOG2E;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int g = (j + 1) / n_q, q0 = q_start + ((j + 1) % n_q) * TILE;
      const int st = (j + 1) % STAGES;
      copy_q_async(ring + st * 2 * SW_TILE_BYTES, stats + st * 2 * TILE, q, dout, lse, delta, b,
              kh * group + g, q0, T, H);
    }
    cp_async_commit();
    cp_async_wait<1>();   // tile j (and the K/V tiles) have landed
    fence_proxy_async();  // ... and are visible to wgmma's reads
    __syncthreads();
    const int q0 = q_start + (j % n_q) * TILE;
    const int st = j % STAGES;
    const unsigned char* qs = ring + st * 2 * SW_TILE_BYTES;
    const float* lse_s = stats + st * 2 * TILE;
    const bool full = q0 + TILE <= T && s0 + TILE <= kv_len && (!causal || q0 >= s0 + TILE - 1);
    if (full)
      dkv_step<false>(dka, dva, ks, vs, qs, qs + SW_TILE_BYTES, lse_s, lse_s + TILE, q0, T,
                      kv_len, causal, row0, scale2, sm_scale, lane);
    else
      dkv_step<true>(dka, dva, ks, vs, qs, qs + SW_TILE_BYTES, lse_s, lse_s + TILE, q0, T,
                     kv_len, causal, row0, scale2, sm_scale, lane);
    __syncthreads();  // stage j % STAGES is free for tile j + STAGES
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it stages dk and dv
  const int valid = T - s0 - warp * 16;
  const size_t out = kv_base + (size_t)warp * 16 * kv_stride;
  bf16* stage_k = reinterpret_cast<bf16*>(ring);
  bf16* stage_v = reinterpret_cast<bf16*>(ring + 2 * SW_TILE_BYTES);
  store_rows(dka, 1.0f, 1.0f, stage_k + warp * 16 * DS, dk + out, kv_stride, valid, lane);
  store_rows(dva, 1.0f, 1.0f, stage_v + warp * 16 * DS, dv + out, kv_stride, valid, lane);
}

}  // namespace

// dynamic shared memory of a dq (which == 0) or dk/dv (1) block
extern "C" int flash_vjp_smem_bytes(int which) {
  return (int)(which == 0 ? DQ_SMEM_BYTES : DKV_SMEM_BYTES);
}

// the forward's q/k/v and kv_lens, dout [B, T, H, D] bf16, lse and delta
// [B, H, T] f32 -> dq [B, T, H, D] bf16
extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* kv_lens, void* dq,
                             int B, int T, int H, int KH, int d, float sm_scale, int causal,
                             void* stream) {
  if (d != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_dq_kernel, DQ_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TILE - 1) / TILE, H, B);
  flash_dq_kernel<<<grid, THREADS, DQ_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(kv_lens), static_cast<bf16*>(dq),
      T, H, KH, sm_scale, causal);
  return (int)cudaGetLastError();
}

// as flash_dq_bf16 -> dk, dv [B, T, KH, D] bf16 (summed over each kv head's
// query heads)
extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* kv_lens, void* dk,
                              void* dv, int B, int T, int H, int KH, int d, float sm_scale,
                              int causal, void* stream) {
  if (d != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_dkv_kernel, DKV_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TILE - 1) / TILE, KH, B);
  flash_dkv_kernel<<<grid, THREADS, DKV_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(kv_lens), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, H, KH, sm_scale, causal);
  return (int)cudaGetLastError();
}
