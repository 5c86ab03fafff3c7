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
// matches mha_reference and rows that see no key give 0 (l_safe at :115).
// The LSE entry stores lse = m + log(l) per row in f32 as [B, H, T] (JAX's
// lane-replicated [.., 128] layout is a Mosaic constraint and is not
// copied), and +2e30 for a row with l == 0 (:411), so that the backward's
// exp(s - lse) is 0 there. The prefix entry walks the prefix pk/pv
// [1, P, KH, d] (batch stride 0, every column < P visible to every row),
// then the row's own k/v [B, T, KH, d] causally in local positions below
// rest_lens[b], under one online softmax, and writes no LSE.
//
// What bounds it on the H100: bytes at the stage-1 shapes (B = 64, H = 32,
// T = S = 318, d = 128, causal): one layer reads and writes 0.67 GB of
// q/k/v/o bf16 (about 0.2 ms at 3.35 TB/s) but does only about 53 GFLOP of
// products (0.05 ms on the bf16 tensor cores). Operations at the training
// shape (B = 1, H = 32, T = 2048, causal): 34 GFLOP at full length, 35 us at
// 989 TFLOP/s against 15 us of bytes. The design, simple first: one block per
// (q tile of 64 rows, head, batch row) -- on Hopper blocks run in parallel,
// so the TPU grid's sequential kv axis becomes a loop inside the block (for
// the prefix kernel, two loops: the prefix tiles, then the causal tiles).
// Each of the 4 warps owns 16 query rows. Q K^T and P V run on the tensor
// cores through WMMA (bf16 inputs, f32 accumulation); the softmax statistics
// and the f32 output accumulator live in shared memory. Tiles in the causal
// future and tiles at or past kv_lens[b] are never loaded, as the Pallas
// kernels skip them with pl.when. P is rounded to bf16 before P V, as the
// Pallas bodies cast p to v's type.
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // kv rows per loop step
constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr float NEG_INF = -2.0e30f;
constexpr float LSE_EMPTY = 2.0e30f;  // lse of a row that sees no key

template <int D>
struct Layout {
  static constexpr int DS = D + 8;     // bf16 row stride of the q/k/v tiles
  static constexpr int SS = BKV + 4;   // f32 row stride of the score tile
  static constexpr int PS = BKV + 8;   // bf16 row stride of the P tile
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + (size_t)BQ * DS * 2;
  static constexpr size_t v_off = k_off + (size_t)BKV * DS * 2;
  static constexpr size_t s_off = v_off + (size_t)BKV * DS * 2;
  static constexpr size_t p_off = s_off + (size_t)BQ * SS * 4;
  static constexpr size_t o_off = p_off + (size_t)BQ * PS * 2;
  static constexpr size_t m_off = o_off + (size_t)BQ * D * 4;
  static constexpr size_t l_off = m_off + BQ * 4;
  static constexpr size_t a_off = l_off + BQ * 4;
  static constexpr size_t bytes = a_off + BQ * 4;
};

// the block's shared-memory tiles
template <int D>
struct Tiles {
  __nv_bfloat16 *qs, *ks, *vs, *ps;
  float *ss, *os, *m_s, *l_s, *a_s;

  __device__ explicit Tiles(unsigned char* smem) {
    using L = Layout<D>;
    qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
    ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
    vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
    ss = reinterpret_cast<float*>(smem + L::s_off);
    ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
    os = reinterpret_cast<float*>(smem + L::o_off);
    m_s = reinterpret_cast<float*>(smem + L::m_off);
    l_s = reinterpret_cast<float*>(smem + L::l_off);
    a_s = reinterpret_cast<float*>(smem + L::a_off);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// load this block's q tile (rows q0.., head h, batch row b; zeros past T)
// and reset the softmax state
template <int D>
__device__ __forceinline__ void start_block(const Tiles<D>& t, const __nv_bfloat16* __restrict__ q,
                                            int b, int h, int q0, int T, int H) {
  constexpr int DS = Layout<D>::DS, VPR = D / 8;  // 16-byte vectors per row
  const int tid = threadIdx.x;
  for (int i = tid; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8, row = q0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < T) val = *reinterpret_cast<const uint4*>(q + (((size_t)b * T + row) * H + h) * D + c);
    *reinterpret_cast<uint4*>(t.qs + r * DS + c) = val;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    t.m_s[i] = NEG_INF;
    t.l_s[i] = 0.0f;
  }
  for (int i = tid; i < BQ * D; i += THREADS) t.os[i] = 0.0f;
}

// one kv tile: rows s0 .. s0 + BKV - 1 of kb/vb ([rows, KH, D] for this
// batch row), head kh; column col is live when col < limit and, when
// causal, q0 + r >= col. Rows at or past `rows` are read as zeros.
template <int D>
__device__ __forceinline__ void kv_tile(const Tiles<D>& t, const __nv_bfloat16* __restrict__ kb,
                                        const __nv_bfloat16* __restrict__ vb, int rows, int KH,
                                        int kh, int s0, int limit, int causal, int q0,
                                        float sm_scale) {
  using L = Layout<D>;
  constexpr int DS = L::DS, SS = L::SS, PS = L::PS, VPR = D / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  __syncthreads();  // the previous tile's K, V and P are no longer read
  for (int i = tid; i < BKV * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8, s = s0 + r;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (s < rows) {
      const size_t off = ((size_t)s * KH + kh) * D + c;
      kv = *reinterpret_cast<const uint4*>(kb + off);
      vv = *reinterpret_cast<const uint4*>(vb + off);
    }
    *reinterpret_cast<uint4*>(t.ks + r * DS + c) = kv;
    *reinterpret_cast<uint4*>(t.vs + r * DS + c) = vv;
  }
  __syncthreads();

  // scores for this warp's 16 rows: S = Q K^T
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BKV / 16];
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n) wmma::fill_fragment(sacc[n], 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, t.qs + warp * 16 * DS + kk * 16, DS);
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n) {
        // K^T as a column-major B: element (d, s) at ks[s * DS + d]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
        wmma::load_matrix_sync(bf, t.ks + n * 16 * DS + kk * 16, DS);
        wmma::mma_sync(sacc[n], a, bf, sacc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n)
      wmma::store_matrix_sync(t.ss + warp * 16 * SS + n * 16, sacc[n], SS, wmma::mem_row_major);
  }
  __syncwarp();

  // online softmax over this tile, one row at a time; lane owns 2 columns;
  // masked entries get p = 0 even while a row has seen no live column
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr, row = q0 + r;
    float sv[2];
    bool ok[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = s0 + lane + 32 * u;
      ok[u] = col < limit && (!causal || row >= col);
      sv[u] = ok[u] ? t.ss[r * SS + lane + 32 * u] * sm_scale : NEG_INF;
    }
    const float m_prev = t.m_s[r];
    const float m_new = fmaxf(m_prev, warp_max(fmaxf(sv[0], sv[1])));
    const float alpha = expf(m_prev - m_new);
    const float p0 = ok[0] ? expf(sv[0] - m_new) : 0.0f;
    const float p1 = ok[1] ? expf(sv[1] - m_new) : 0.0f;
    const float psum = warp_sum(p0 + p1);
    t.ps[r * PS + lane] = __float2bfloat16(p0);
    t.ps[r * PS + lane + 32] = __float2bfloat16(p1);
    if (lane == 0) {
      t.m_s[r] = m_new;
      t.l_s[r] = alpha * t.l_s[r] + psum;
      t.a_s[r] = alpha;
    }
  }
  __syncwarp();

  // O = alpha * O + P V for this warp's rows, 16 output columns at a time
  float* scratch = t.ss + warp * 16 * SS;  // this warp's scores are consumed
#pragma unroll 1
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
    wmma::fill_fragment(oacc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, t.ps + warp * 16 * PS + kk * 16, PS);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, t.vs + kk * 16 * DS + n * 16, DS);
      wmma::mma_sync(oacc, a, bf, oacc);
    }
    wmma::store_matrix_sync(scratch, oacc, SS, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int rr = e >> 4, cc = e & 15, r = warp * 16 + rr;
      float* o = t.os + r * D + n * 16 + cc;
      *o = *o * t.a_s[r] + scratch[rr * SS + cc];
    }
    __syncwarp();
  }
}

// write o = acc / l (0 for a row with l == 0) and, unless lse == nullptr,
// lse [B, H, T]
template <int D>
__device__ __forceinline__ void finish_block(const Tiles<D>& t, __nv_bfloat16* __restrict__ out,
                                             float* __restrict__ lse, int b, int h, int q0, int T,
                                             int H) {
  const int tid = threadIdx.x;
  __syncthreads();
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, row = q0 + r;
    if (row >= T) continue;
    const float l = t.l_s[r];
    const float l_safe = l == 0.0f ? 1.0f : l;
    out[(((size_t)b * T + row) * H + h) * D + c] = __float2bfloat16(t.os[i] / l_safe);
  }
  if (lse != nullptr) {
    for (int i = tid; i < BQ; i += THREADS) {
      const int row = q0 + i;
      if (row >= T) continue;
      const float l = t.l_s[i];
      lse[((size_t)b * H + h) * T + row] = l > 0.0f ? t.m_s[i] + logf(l) : LSE_EMPTY;
    }
  }
}

// the whole forward of one block over k/v [B, S, KH, D]; lse == nullptr
// skips the LSE output
template <int D>
__device__ __forceinline__ void flash_fwd_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int S, int H, int KH,
    float sm_scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<D> t(smem);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int kv_len = min(kv_lens[b], S);
  start_block<D>(t, q, b, h, q0, T, H);

  // live kv tiles start below kv_len and, when causal, at or before the last
  // query row of this tile
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q0 + BQ);
  const size_t batch_off = (size_t)b * S * KH * D;
  for (int s0 = 0; s0 < kv_end; s0 += BKV)
    kv_tile<D>(t, k + batch_off, v + batch_off, S, KH, kh, s0, kv_len, causal, q0, sm_scale);
  finish_block<D>(t, out, lse, b, h, q0, T, H);
}

// K2 (prefill)
template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
    __nv_bfloat16* __restrict__ out, int T, int S, int H, int KH, float sm_scale, int causal) {
  flash_fwd_body<D>(q, k, v, kv_lens, out, nullptr, T, S, H, KH, sm_scale, causal);
}

// rows 4 and 5: the same, plus the per-row LSE
template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_lse_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int S, int H, int KH,
    float sm_scale, int causal) {
  flash_fwd_body<D>(q, k, v, kv_lens, out, lse, T, S, H, KH, sm_scale, causal);
}

// row 6: the prefix tiles (every column < P visible), then this row's causal
// tiles in local positions below rest_lens[b], under one online softmax
template <int D>
__global__ void __launch_bounds__(THREADS) flash_prefix_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ pk,
    const __nv_bfloat16* __restrict__ pv, const int* __restrict__ rest_lens,
    __nv_bfloat16* __restrict__ out, int T, int P, int H, int KH, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<D> t(smem);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int rest_len = min(rest_lens[b], T);
  start_block<D>(t, q, b, h, q0, T, H);
  for (int s0 = 0; s0 < P; s0 += BKV)  // batch stride 0: every row reads the same prefix
    kv_tile<D>(t, pk, pv, P, KH, kh, s0, P, 0, q0, sm_scale);
  const int kv_end = min(rest_len, q0 + BQ);
  const size_t batch_off = (size_t)b * T * KH * D;
  for (int s0 = 0; s0 < kv_end; s0 += BKV)
    kv_tile<D>(t, k + batch_off, v + batch_off, T, KH, kh, s0, rest_len, 1, q0, sm_scale);
  finish_block<D>(t, out, nullptr, b, h, q0, T, H);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// q [B, T, H, D], k/v [B, S, KH, D] bf16 contiguous, kv_lens [B] int32 (each
// <= S), out [B, T, H, D] bf16. D = 128 (Vicuna's head_dim); H % KH == 0.
extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                   const void* kv_lens, void* out, int B, int T,
                                   int S, int H, int KH, int D, float sm_scale,
                                   int causal, void* stream) {
  if (D != 128) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<128>::bytes;
  cudaError_t err = allow_smem(flash_fwd_kernel<128>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<128><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), T, S, H, KH, sm_scale, causal);
  return (int)cudaGetLastError();
}

// q [B, T, H, D], k/v [B, S, KH, D] bf16 contiguous, kv_lens [B] int32 (each
// <= S), out [B, T, H, D] bf16, lse [B, H, T] f32. D = 128; H % KH == 0.
extern "C" int flash_fwd_lse_bf16(const void* q, const void* k, const void* v,
                                  const void* kv_lens, void* out, void* lse, int B, int T,
                                  int S, int H, int KH, int D, float sm_scale, int causal,
                                  void* stream) {
  if (D != 128) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<128>::bytes;
  cudaError_t err = allow_smem(flash_fwd_lse_kernel<128>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_lse_kernel<128><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), T, S, H, KH, sm_scale,
      causal);
  return (int)cudaGetLastError();
}

// q [B, T, H, D], k/v [B, T, KH, D], prefix pk/pv [1, P, KH, D] bf16
// contiguous, rest_lens [B] int32 (each <= T), out [B, T, H, D] bf16.
// D = 128; H % KH == 0; P >= 1.
extern "C" int flash_prefix_fwd_bf16(const void* q, const void* k, const void* v,
                                     const void* pk, const void* pv, const void* rest_lens,
                                     void* out, int B, int T, int P, int H, int KH, int D,
                                     float sm_scale, void* stream) {
  if (D != 128 || P < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<128>::bytes;
  cudaError_t err = allow_smem(flash_prefix_kernel<128>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_prefix_kernel<128><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(pk),
      static_cast<const __nv_bfloat16*>(pv), static_cast<const int*>(rest_lens),
      static_cast<__nv_bfloat16*>(out), T, P, H, KH, sm_scale);
  return (int)cudaGetLastError();
}
