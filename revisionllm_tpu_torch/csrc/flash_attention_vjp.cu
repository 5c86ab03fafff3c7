// Row 4, backward: dq and dk/dv of flash attention for training, q/k/v
// [B, T, H|KH, 128] bf16 with T == S. The forward with the per-row
// log-sum-exp is row 4's third kernel, flash_fwd_lse_kernel, which shares
// kernel K2's body in flash_attention.cu.
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
// The design, simple first: one block of 4 warps per (64-row tile, head,
// batch row); on Hopper blocks run in parallel, so the TPU grid's sequential
// axis becomes a loop inside the block. dq owns a q tile and loops over kv
// tiles; dk/dv owns a kv tile and loops over q tiles, so every block owns its
// output tile: no atomics, deterministic sums. Products run on the tensor
// cores through WMMA 16x16x16 (bf16 in, f32 accumulation), and dq, dk and dv
// accumulate in WMMA fragments (registers). Tiles in the causal future and
// tiles at or past kv_lens[b] are never loaded, as the Pallas kernels skip
// them with pl.when. wgmma and TMA come later.
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 128;         // head_dim (Vicuna)
constexpr int BQ = 64;         // query rows per tile
constexpr int BKV = 64;        // kv rows per tile
constexpr int THREADS = 128;   // 4 warps x 16 rows
constexpr int DS = D + 8;      // bf16 row stride of q/k/v/dO tiles
constexpr int SS = BKV + 4;    // f32 row stride of score tiles
constexpr int PS = BKV + 8;    // bf16 row stride of P / dS tiles
constexpr int OS = D + 4;      // f32 row stride of the output staging tile
constexpr int VPR = D / 8;     // 16-byte vectors per row
constexpr float LSE_EMPTY = 2.0e30f;  // lse of a row that sees no key

constexpr size_t TILE_BYTES = (size_t)64 * DS * 2;   // one bf16 [64, D] tile
constexpr size_t SCORE_BYTES = (size_t)64 * SS * 4;  // one f32 [64, 64] tile
constexpr size_t P_BYTES = (size_t)64 * PS * 2;      // one bf16 [64, 64] tile
static_assert(2 * SCORE_BYTES >= (size_t)64 * OS * 4, "staging tile fits two score tiles");
static_assert(BQ == BKV, "causal tile skipping assumes square tiles");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// rows [t0, t0 + 64) of head `head` of a [B, rows, heads, D] tensor into a
// [64, DS] shared tile; rows at or past `rows` are zero
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int b,
                                          int t0, int rows, int heads, int head, int tid) {
  for (int i = tid; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8, t = t0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < rows)
      val = *reinterpret_cast<const uint4*>(src + (((size_t)b * rows + t) * heads + head) * D + c);
    *reinterpret_cast<uint4*>(dst + r * DS + c) = val;
  }
}

// out[16, 64] (f32, stride SS) = a[16, D] . bt[64, D]^T, both bf16 stride DS
__device__ __forceinline__ void rows_dot_tile(const __nv_bfloat16* a, const __nv_bfloat16* bt,
                                              float* out) {
  FragC acc[BKV / 16];
#pragma unroll
  for (int n = 0; n < BKV / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, DS);
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n) {
      // bt^T as a column-major B: element (d, s) at bt[s * DS + d]
      FragBc fb;
      wmma::load_matrix_sync(fb, bt + n * 16 * DS + kk * 16, DS);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BKV / 16; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], SS, wmma::mem_row_major);
}

// acc[16, D] += p[16, 64] (bf16, stride PS) . m[64, D] (bf16, stride DS)
__device__ __forceinline__ void acc_rows_times_tile(FragC (&acc)[D / 16], const __nv_bfloat16* p,
                                                    const __nv_bfloat16* m) {
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, p + kk * 16, PS);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBr fb;
      wmma::load_matrix_sync(fb, m + kk * 16 * DS + n * 16, DS);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// one warp's 16 accumulated rows -> bf16 rows [t0 + 16 warp, ...) of head
// `head` of a [B, rows, heads, D] tensor, through the f32 staging tile
__device__ __forceinline__ void store_rows(FragC (&acc)[D / 16], float* stage,
                                           __nv_bfloat16* dst, int b, int t0, int rows,
                                           int heads, int head, int warp, int lane) {
  float* mine = stage + warp * 16 * OS;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(mine + n * 16, acc[n], OS, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int rr = e / D, c = e % D, t = t0 + warp * 16 + rr;
    if (t < rows)
      dst[(((size_t)b * rows + t) * heads + head) * D + c] = __float2bfloat16(mine[rr * OS + c]);
  }
  __syncwarp();
}

// lse and delta ([B, H, T] f32) of rows [t0, t0 + 64) into shared memory;
// rows at or past T get the empty-row LSE, so their p is 0
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dl_s, const float* lse,
                                               const float* delta, int b, int h, int H,
                                               int T, int t0, int tid) {
  for (int i = tid; i < 64; i += THREADS) {
    const int t = t0 + i;
    const size_t off = ((size_t)b * H + h) * T + t;
    lse_s[i] = t < T ? lse[off] : LSE_EMPTY;
    dl_s[i] = t < T ? delta[off] : 0.0f;
  }
}

// ------------------------------------------------------------------ dq

struct DqLayout {
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + TILE_BYTES;
  static constexpr size_t k_off = do_off + TILE_BYTES;
  static constexpr size_t v_off = k_off + TILE_BYTES;
  static constexpr size_t s_off = v_off + TILE_BYTES;
  static constexpr size_t dp_off = s_off + SCORE_BYTES;
  static constexpr size_t ds_off = dp_off + SCORE_BYTES;
  static constexpr size_t lse_off = ds_off + P_BYTES;
  static constexpr size_t dl_off = lse_off + 64 * 4;
  static constexpr size_t bytes = dl_off + 64 * 4;
};

__global__ void __launch_bounds__(THREADS) flash_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ dq, int T, int H, int KH,
    float sm_scale, int causal) {
  using L = DqLayout;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem + L::do_off);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dps = reinterpret_cast<float*>(smem + L::dp_off);
  __nv_bfloat16* dss = reinterpret_cast<__nv_bfloat16*>(smem + L::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* dl_s = reinterpret_cast<float*>(smem + L::dl_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_len = min(kv_lens[b], T);

  load_tile(qs, q, b, q0, T, H, h, tid);
  load_tile(dos, dout, b, q0, T, H, h, tid);
  load_row_stats(lse_s, dl_s, lse, delta, b, h, H, T, q0, tid);

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q0 + BQ);
  const int n_tiles = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);

  for (int j = 0; j < n_tiles; ++j) {
    const int s0 = j * BKV;
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile(ks, k, b, s0, T, KH, kh, tid);
    load_tile(vs, v, b, s0, T, KH, kh, tid);
    __syncthreads();

    rows_dot_tile(qs + warp * 16 * DS, ks, ss + warp * 16 * SS);    // S = Q K^T
    rows_dot_tile(dos + warp * 16 * DS, vs, dps + warp * 16 * SS);  // dP = dO V^T
    __syncwarp();
    for (int e = lane; e < 16 * BKV; e += 32) {
      const int rr = e / BKV, c = e % BKV, r = warp * 16 + rr;
      const int t = q0 + r, col = s0 + c;
      const bool ok = col < kv_len && (!causal || t >= col);
      const float p = ok ? expf(ss[r * SS + c] * sm_scale - lse_s[r]) : 0.0f;
      const float ds = p * (dps[r * SS + c] - dl_s[r]) * sm_scale;
      dss[r * PS + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    acc_rows_times_tile(acc, dss + warp * 16 * PS, ks);  // dQ += dS K
  }
  __syncthreads();  // the staging tile overlaps every warp's score rows
  store_rows(acc, ss, dq, b, q0, T, H, h, warp, lane);
}

// ------------------------------------------------------------------ dk, dv

struct DkvLayout {
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + TILE_BYTES;
  static constexpr size_t q_off = v_off + TILE_BYTES;
  static constexpr size_t do_off = q_off + TILE_BYTES;
  static constexpr size_t st_off = do_off + TILE_BYTES;
  static constexpr size_t dpt_off = st_off + SCORE_BYTES;
  static constexpr size_t pt_off = dpt_off + SCORE_BYTES;
  static constexpr size_t dst_off = pt_off + P_BYTES;
  static constexpr size_t lse_off = dst_off + P_BYTES;
  static constexpr size_t dl_off = lse_off + 64 * 4;
  static constexpr size_t bytes = dl_off + 64 * 4;
};

__global__ void __launch_bounds__(THREADS) flash_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int T, int H, int KH, float sm_scale, int causal) {
  using L = DkvLayout;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem + L::do_off);
  float* sts = reinterpret_cast<float*>(smem + L::st_off);
  float* dpts = reinterpret_cast<float*>(smem + L::dpt_off);
  __nv_bfloat16* pts = reinterpret_cast<__nv_bfloat16*>(smem + L::pt_off);
  __nv_bfloat16* dsts = reinterpret_cast<__nv_bfloat16*>(smem + L::dst_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* dl_s = reinterpret_cast<float*>(smem + L::dl_off);

  const int s0 = blockIdx.x * BKV;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_len = min(kv_lens[b], T);

  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.0f);
    wmma::fill_fragment(dv_acc[n], 0.0f);
  }

  // a kv tile at or past kv_len gets no gradient (zeros are still written)
  if (s0 < kv_len) {
    load_tile(ks, k, b, s0, T, KH, kh, tid);
    load_tile(vs, v, b, s0, T, KH, kh, tid);
    // causal: q rows before s0 never see this tile
    const int q_start = causal ? s0 : 0;
    for (int g = 0; g < group; ++g) {
      const int h = kh * group + g;
      for (int q0 = q_start; q0 < T; q0 += BQ) {
        __syncthreads();  // the previous q tile, its stats and P^T are no longer read
        load_tile(qs, q, b, q0, T, H, h, tid);
        load_tile(dos, dout, b, q0, T, H, h, tid);
        load_row_stats(lse_s, dl_s, lse, delta, b, h, H, T, q0, tid);
        __syncthreads();

        rows_dot_tile(ks + warp * 16 * DS, qs, sts + warp * 16 * SS);    // S^T = K Q^T
        rows_dot_tile(vs + warp * 16 * DS, dos, dpts + warp * 16 * SS);  // dP^T = V dO^T
        __syncwarp();
        for (int e = lane; e < 16 * BQ; e += 32) {
          const int rr = e / BQ, c = e % BQ, r = warp * 16 + rr;
          const int s = s0 + r, t = q0 + c;
          const bool ok = s < kv_len && t < T && (!causal || t >= s);
          const float p = ok ? expf(sts[r * SS + c] * sm_scale - lse_s[c]) : 0.0f;
          const float ds = p * (dpts[r * SS + c] - dl_s[c]) * sm_scale;
          pts[r * PS + c] = __float2bfloat16(p);
          dsts[r * PS + c] = __float2bfloat16(ds);
        }
        __syncwarp();
        acc_rows_times_tile(dv_acc, pts + warp * 16 * PS, dos);  // dV += P^T dO
        acc_rows_times_tile(dk_acc, dsts + warp * 16 * PS, qs);  // dK += dS^T Q
      }
    }
  }
  __syncthreads();  // the staging tile overlaps every warp's score rows
  float* stage = sts;
  store_rows(dk_acc, stage, dk, b, s0, T, KH, kh, warp, lane);
  store_rows(dv_acc, stage, dv, b, s0, T, KH, kh, warp, lane);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// the forward's q/k/v and kv_lens, dout [B, T, H, D] bf16, lse and delta
// [B, H, T] f32 -> dq [B, T, H, D] bf16
extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* kv_lens, void* dq,
                             int B, int T, int H, int KH, int d, float sm_scale, int causal,
                             void* stream) {
  if (d != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_dq_kernel, DqLayout::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_dq_kernel<<<grid, THREADS, DqLayout::bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_lens), static_cast<__nv_bfloat16*>(dq), T, H, KH, sm_scale,
      causal);
  return (int)cudaGetLastError();
}

// as flash_dq_bf16 -> dk, dv [B, T, KH, D] bf16 (summed over each kv head's
// query heads)
extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* kv_lens, void* dk,
                              void* dv, int B, int T, int H, int KH, int d, float sm_scale,
                              int causal, void* stream) {
  if (d != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_dkv_kernel, DkvLayout::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BKV - 1) / BKV, KH, B);
  flash_dkv_kernel<<<grid, THREADS, DkvLayout::bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_lens), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T, H, KH, sm_scale, causal);
  return (int)cudaGetLastError();
}
