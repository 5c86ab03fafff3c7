// Row 7: W4A16 matmul, out[M, N] = x[M, K] @ bf16(q4[K, N] * scale[K / 128, N]).
//
// Replaces the Pallas kernel revisionllm_tpu/ops/quant.py:580 _q4_matmul_kernel
// (entry int4_matmul :615, pallas_call :658), which q4_apply sends every matmul
// with M <= 256 of an int4 tree: on the stage-1 path, each decode-step
// projection at M = B = 64 and the lm_head.
//
// What bounds it on the H100: the packed weight bytes. At M = 64 a 4096 x
// 11008 matrix is 22.5 MB of nibbles plus 1.4 MB of group scales, about 7 us at
// 3.35 TB/s, while its 5.8 GFLOP take about 6 us on the bf16 tensor cores. So
// the design is K1's (csrc/int8_matmul.cu), which streams every weight byte
// once with enough of them in flight:
//   - each block owns BN = 128 output columns for ALL M rows; a grid axis
//     splits K so the grid fills the SMs;
//   - a 4-stage cp.async pipeline moves 64-row K tiles: 32 packed rows of W
//     (4 KB), the row of 128 group scales the tile lies in (a tile never
//     straddles a group: K tiles start at multiples of 64, groups at
//     multiples of 128), and the x tile;
//   - each landed tile is unpacked in registers: byte i of a column holds
//     rows 2i (low nibble) and 2i + 1 (high nibble), each sign-extended,
//     multiplied by its group's f32 scale and rounded to bf16, as the Pallas
//     body rounds q * scale to x's type before its dot (quant.py:603-607);
//   - the bf16 tile goes through WMMA (bf16 x bf16, f32 accumulation).
// Each K split writes f32 partial sums to a workspace; a second small kernel
// adds the splits in a fixed order and rounds to bf16, so results are
// deterministic. down_proj's K = 11008 is 86 groups = 172 tiles; the split
// plan rounds each split to whole tiles. The lm_head's N = 32000 is 250
// blocks of 128 columns.
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/quant.py,
// which mirrors the shared-memory size below when it plans the split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int GROUP = 128;     // K rows per scale row
constexpr int BN = 128;        // output columns per block
constexpr int BK = 64;         // K rows per pipeline stage (32 packed rows)
constexpr int STAGES = 4;
constexpr int THREADS = 256;   // 8 warps; warp w owns columns [16w, 16w + 16)
constexpr int XS = BK + 8;     // smem row stride (bf16) of an x stage
constexpr int WBS = BN + 8;    // smem row stride (bf16) of the widened W tile

template <int MT>
struct Smem {
  static constexpr int MP = MT * 16;
  static constexpr size_t x_bytes = (size_t)MP * XS * 2;   // one x stage
  static constexpr size_t w_bytes = (size_t)(BK / 2) * BN; // one packed W stage
  static constexpr size_t s_bytes = (size_t)BN * 4;        // one scale row
  static constexpr size_t x_off = 0;
  static constexpr size_t w_off = x_off + STAGES * x_bytes;
  static constexpr size_t s_off = w_off + STAGES * w_bytes;
  static constexpr size_t wb_off = s_off + STAGES * s_bytes;
  static constexpr size_t bytes = wb_off + (size_t)BK * WBS * 2;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int MT>
__global__ void __launch_bounds__(THREADS) q4_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ ws, int M, int K, int N, int Np,
    int k_per_split) {
  using L = Smem<MT>;
  constexpr int MP = L::MP;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L::x_off);
  uint8_t* w4 = reinterpret_cast<uint8_t*>(smem + L::w_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(smem + L::wb_off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // one stage: packed W is BK/2 x BN bytes = 256 16-byte chunks (one a
  // thread); the scale row 32 chunks; x is MP x BK bf16 = MP * 8 chunks.
  // K % 128 == 0, so a stage is never cut by k_end; columns past N and rows
  // past M are zero-filled (src-size 0).
  auto issue = [&](int slot, int k0) {
    {
      const int r = tid >> 3, col = (tid & 7) * 16;
      const bool ok = n0 + col < N;
      cp_async16(w4 + slot * L::w_bytes + r * BN + col,
                 ok ? w + (size_t)(k0 / 2 + r) * N + n0 + col : w, ok ? 16 : 0);
    }
    if (tid < BN / 4) {
      const int col = tid * 4;
      const bool ok = n0 + col < N;
      cp_async16(ss + slot * BN + col,
                 ok ? scale + (size_t)(k0 / GROUP) * N + n0 + col : scale, ok ? 16 : 0);
    }
    __nv_bfloat16* xdst = xs + slot * (L::x_bytes / 2);
#pragma unroll
    for (int j = 0; j < (MP * BK / 8 + THREADS - 1) / THREADS; ++j) {
      const int c = tid + j * THREADS;
      if (c < MP * BK / 8) {
        const int r = c >> 3, kc = (c & 7) * 8;
        const bool ok = r < M;
        cp_async16(xdst + r * XS + kc, ok ? x + (size_t)r * K + k0 + kc : x, ok ? 16 : 0);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) wmma::fill_fragment(acc[i], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s, k_begin + s * BK);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage t landed
    __syncthreads();              // everyone's, and stage t - 1 is consumed
    {
      const int tn = t + STAGES - 1;
      if (tn < nk) issue(tn % STAGES, k_begin + tn * BK);
      cp_async_commit();
    }
    // unpack stage t: packed row r (16 bytes a thread) -> W rows 2r, 2r + 1
    {
      const int slot = t % STAGES;
      const int r = tid >> 3, col = (tid & 7) * 16;
      __align__(16) uint8_t raw[16];
      *reinterpret_cast<uint4*>(raw) =
          *reinterpret_cast<const uint4*>(w4 + slot * L::w_bytes + r * BN + col);
      const float* sc = ss + slot * BN + col;
      __align__(16) __nv_bfloat16 lo[16], hi[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int b = raw[e];
        const int vlo = (b & 0xF) > 7 ? (b & 0xF) - 16 : (b & 0xF);
        const int vhi = (b >> 4) > 7 ? (b >> 4) - 16 : (b >> 4);
        lo[e] = __float2bfloat16_rn((float)vlo * sc[e]);
        hi[e] = __float2bfloat16_rn((float)vhi * sc[e]);
      }
      uint4* dlo = reinterpret_cast<uint4*>(wb + (2 * r) * WBS + col);
      uint4* dhi = reinterpret_cast<uint4*>(wb + (2 * r + 1) * WBS + col);
      dlo[0] = reinterpret_cast<const uint4*>(lo)[0];
      dlo[1] = reinterpret_cast<const uint4*>(lo)[1];
      dhi[0] = reinterpret_cast<const uint4*>(hi)[0];
      dhi[1] = reinterpret_cast<const uint4*>(hi)[1];
    }
    __syncthreads();
    const __nv_bfloat16* xt = xs + (t % STAGES) * (L::x_bytes / 2);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfrag;
      wmma::load_matrix_sync(bfrag, wb + kk * 16 * WBS + warp * 16, WBS);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> afrag;
        wmma::load_matrix_sync(afrag, xt + i * 16 * XS + kk * 16, XS);
        wmma::mma_sync(acc[i], afrag, bfrag, acc[i]);
      }
    }
  }
  cp_async_wait<0>();

  float* part = ws + (size_t)blockIdx.y * MP * Np + n0 + warp * 16;
#pragma unroll
  for (int i = 0; i < MT; ++i)
    wmma::store_matrix_sync(part + (size_t)i * 16 * Np, acc[i], Np, wmma::mem_row_major);
}

__global__ void q4_finalize_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                                   int M, int N, int Np, int MP, int splitk) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * N) return;
  const int m = idx / N;
  const int n = idx - m * N;
  float s = 0.0f;
  for (int j = 0; j < splitk; ++j) s += ws[((size_t)j * MP + m) * Np + n];
  out[idx] = __float2bfloat16(s);
}

template <int MT>
cudaError_t launch(const void* x, const void* w, const void* scale, void* ws, int M, int K,
                   int N, int Np, int splitk, int k_per_split, cudaStream_t stream) {
  static bool attr_set = false;
  const size_t smem = Smem<MT>::bytes;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        q4_matmul_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid(Np / BN, splitk);
  q4_matmul_kernel<MT><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(ws), M, K, N, Np, k_per_split);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, w [K/2, N] uint8, scale [K/128, N] f32, ws [splitk, 16*mt,
// Np] f32 with Np = N rounded up to 128, out [M, N] bf16. Requires M <= 16*mt,
// mt in {1, 2, 4, 8, 16}, K % 128 == 0, N % 16 == 0, k_per_split % 64 == 0,
// 16-byte aligned x, w and scale.
extern "C" int q4_matmul_bf16(const void* x, const void* w, const void* scale, void* ws,
                              void* out, int M, int K, int N, int mt, int splitk,
                              int k_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Np = (N + BN - 1) / BN * BN;
  cudaError_t err;
  switch (mt) {
    case 1: err = launch<1>(x, w, scale, ws, M, K, N, Np, splitk, k_per_split, s); break;
    case 2: err = launch<2>(x, w, scale, ws, M, K, N, Np, splitk, k_per_split, s); break;
    case 4: err = launch<4>(x, w, scale, ws, M, K, N, Np, splitk, k_per_split, s); break;
    case 8: err = launch<8>(x, w, scale, ws, M, K, N, Np, splitk, k_per_split, s); break;
    case 16: err = launch<16>(x, w, scale, ws, M, K, N, Np, splitk, k_per_split, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int total = M * N;
  q4_finalize_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out), M, N, Np, 16 * mt,
      splitk);
  return (int)cudaGetLastError();
}
