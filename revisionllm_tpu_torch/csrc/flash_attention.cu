// Forward attention with an online softmax: kernel K2 for the stage-1
// prefill, and the forward of row 4 (training), which also writes the
// per-row log-sum-exp. One body serves both.
//
// K2 replaces the Pallas kernel revisionllm_tpu/ops/flash_attention.py:40
// _flash_kernel (entry flash_attention :119, pallas_call :191). The row-4
// forward replaces _flash_fwd_lse_kernel :352 (entry make_flash_mha :526,
// pallas_call :584); its backward kernels are in flash_attention_vjp.cu.
// q [B, T, H, d], k/v [B, S, KH, d] bf16, per-row kv_lens [B], causal, GQA
// through kv head = h / (H / KH), f32 running max m, sum l and accumulator,
// with the same NEG_INF = -2e30 masking, so the maths matches mha_reference
// and rows that see no key give 0 (l_safe at :115). The row-4 entry stores
// lse = m + log(l) per row in f32 as [B, H, T] (JAX's lane-replicated
// [.., 128] layout is a Mosaic constraint and is not copied), and +2e30 for a
// row with l == 0 (:411), so that the backward's exp(s - lse) is 0 there.
//
// What bounds it on the H100: bytes at the stage-1 shapes (B = 64, H = 32,
// T = S = 318, d = 128, causal): one layer reads and writes 0.67 GB of
// q/k/v/o bf16 (about 0.2 ms at 3.35 TB/s) but does only about 53 GFLOP of
// products (0.05 ms on the bf16 tensor cores). Operations at the training
// shape (B = 1, H = 32, T = 2048, causal): 34 GFLOP at full length, 35 us at
// 989 TFLOP/s against 15 us of bytes. The design, simple first: one block per
// (q tile of 64 rows, head, batch row) -- on Hopper blocks run in parallel,
// so the TPU grid's sequential kv axis becomes a loop inside the block. Each
// of the 4 warps owns 16 query rows. Q K^T and P V run on the tensor cores
// through WMMA (bf16 inputs, f32 accumulation); the softmax statistics and
// the f32 output accumulator live in shared memory. Tiles in the causal
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

// the whole forward of one block; lse == nullptr skips the LSE output
template <int D>
__device__ __forceinline__ void flash_fwd_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int S, int H, int KH,
    float sm_scale, int causal) {
  using L = Layout<D>;
  constexpr int DS = L::DS, SS = L::SS, PS = L::PS;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* os = reinterpret_cast<float*>(smem + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem + L::m_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);
  float* a_s = reinterpret_cast<float*>(smem + L::a_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_len = min(kv_lens[b], S);

  for (int i = tid; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8, t = q0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < T) val = *reinterpret_cast<const uint4*>(q + (((size_t)b * T + t) * H + h) * D + c);
    *reinterpret_cast<uint4*>(qs + r * DS + c) = val;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.0f;
  }
  for (int i = tid; i < BQ * D; i += THREADS) os[i] = 0.0f;

  // live kv tiles start below kv_len and, when causal, at or before the last
  // query row of this tile
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q0 + BQ);
  const int n_tiles = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;

  for (int j = 0; j < n_tiles; ++j) {
    const int s0 = j * BKV;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BKV * VPR; i += THREADS) {
      const int r = i / VPR, c = (i % VPR) * 8, s = s0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (s < S) {
        const size_t off = (((size_t)b * S + s) * KH + kh) * D + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + r * DS + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * DS + c) = vv;
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
        wmma::load_matrix_sync(a, qs + warp * 16 * DS + kk * 16, DS);
#pragma unroll
        for (int n = 0; n < BKV / 16; ++n) {
          // K^T as a column-major B: element (d, s) at ks[s * DS + d]
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
          wmma::load_matrix_sync(bf, ks + n * 16 * DS + kk * 16, DS);
          wmma::mma_sync(sacc[n], a, bf, sacc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n)
        wmma::store_matrix_sync(ss + warp * 16 * SS + n * 16, sacc[n], SS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile, one row at a time; lane owns 2 columns;
    // masked entries get p = 0 even while a row has seen no live column
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr, t = q0 + r;
      float sv[2];
      bool ok[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = s0 + lane + 32 * u;
        ok[u] = col < kv_len && (!causal || t >= col);
        sv[u] = ok[u] ? ss[r * SS + lane + 32 * u] * sm_scale : NEG_INF;
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(sv[0], sv[1])));
      const float alpha = expf(m_prev - m_new);
      const float p0 = ok[0] ? expf(sv[0] - m_new) : 0.0f;
      const float p1 = ok[1] ? expf(sv[1] - m_new) : 0.0f;
      const float psum = warp_sum(p0 + p1);
      ps[r * PS + lane] = __float2bfloat16(p0);
      ps[r * PS + lane + 32] = __float2bfloat16(p1);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + psum;
        a_s[r] = alpha;
      }
    }
    __syncwarp();

    // O = alpha * O + P V for this warp's rows, 16 output columns at a time
    float* scratch = ss + warp * 16 * SS;  // this warp's scores are consumed
#pragma unroll 1
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::fill_fragment(oacc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, ps + warp * 16 * PS + kk * 16, PS);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, vs + kk * 16 * DS + n * 16, DS);
        wmma::mma_sync(oacc, a, bf, oacc);
      }
      wmma::store_matrix_sync(scratch, oacc, SS, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int rr = e >> 4, cc = e & 15, r = warp * 16 + rr;
        float* o = os + r * D + n * 16 + cc;
        *o = *o * a_s[r] + scratch[rr * SS + cc];
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, t = q0 + r;
    if (t >= T) continue;
    const float l = l_s[r];
    const float l_safe = l == 0.0f ? 1.0f : l;
    out[(((size_t)b * T + t) * H + h) * D + c] = __float2bfloat16(os[i] / l_safe);
  }
  if (lse != nullptr) {
    for (int i = tid; i < BQ; i += THREADS) {
      const int t = q0 + i;
      if (t >= T) continue;
      const float l = l_s[i];
      lse[((size_t)b * H + h) * T + t] = l > 0.0f ? m_s[i] + logf(l) : LSE_EMPTY;
    }
  }
}

// K2 (prefill)
template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
    __nv_bfloat16* __restrict__ out, int T, int S, int H, int KH, float sm_scale, int causal) {
  flash_fwd_body<D>(q, k, v, kv_lens, out, nullptr, T, S, H, KH, sm_scale, causal);
}

// row 4's forward (training): the same, plus the per-row LSE
template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_lse_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int H, int KH,
    float sm_scale, int causal) {
  flash_fwd_body<D>(q, k, v, kv_lens, out, lse, T, T, H, KH, sm_scale, causal);
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

// q [B, T, H, D], k/v [B, T, KH, D] bf16 contiguous, kv_lens [B] int32 (each
// <= T), out [B, T, H, D] bf16, lse [B, H, T] f32. D = 128; H % KH == 0.
extern "C" int flash_fwd_lse_bf16(const void* q, const void* k, const void* v,
                                  const void* kv_lens, void* out, void* lse, int B, int T,
                                  int H, int KH, int D, float sm_scale, int causal,
                                  void* stream) {
  if (D != 128) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<128>::bytes;
  cudaError_t err = allow_smem(flash_fwd_lse_kernel<128>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_lse_kernel<128><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), T, H, KH, sm_scale, causal);
  return (int)cudaGetLastError();
}
