// K1: W8A16 matmul, out[M, N] = (x[M, K] @ int8 W[K, N]) * scale[N].
//
// Replaces the Pallas kernel revisionllm_tpu/ops/quant.py:46 _q8_matmul_kernel
// (entry int8_matmul :78, pallas_call :117), which q8_apply sends every matmul
// with M <= 256: on the stage-1 path, each decode-step projection at M = B = 64
// and the prefill lm_head.
//
// What bounds it on the H100: the int8 weight bytes. At M = 64 a 4096 x 11008
// matrix is 45 MB, about 13 us at 3.35 TB/s, while its 5.8 GFLOP take about
// 6 us on the bf16 tensor cores. So every weight byte is read from device
// memory once, and enough of them are in flight to cover the memory latency:
//   - each block owns BN = 128 output columns for ALL M rows; a grid axis
//     splits K so the grid fills the SMs (a 4096-column matrix has only 32
//     column tiles for 132 SMs);
//   - a 4-stage cp.async pipeline keeps three 64-row tiles of W (8 KB each)
//     and of x in flight per block while the tensor cores work on the fourth;
//   - each landed W tile is widened int8 -> bf16 (exact) into shared memory
//     and multiplied through WMMA (bf16 x bf16, f32 accumulation), as the
//     Pallas body runs its dot in x's type with f32 accumulation.
// Each K split writes f32 partial sums to a workspace; a second small kernel
// adds the splits in a fixed order, applies the per-column scale after the
// last K block (as the Pallas kernel does at ik == num_k_blocks - 1) and
// rounds to bf16, so results are deterministic.
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/quant.py,
// which mirrors the shared-memory size below when it plans the split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BN = 128;        // output columns per block
constexpr int BK = 64;         // K rows per pipeline stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;   // 8 warps; warp w owns columns [16w, 16w + 16)
constexpr int XS = BK + 8;     // smem row stride (bf16) of an x stage
constexpr int WBS = BN + 8;    // smem row stride (bf16) of the widened W tile

template <int MT>
struct Smem {
  static constexpr int MP = MT * 16;
  static constexpr size_t x_bytes = (size_t)MP * XS * 2;   // one x stage
  static constexpr size_t w_bytes = (size_t)BK * BN;       // one int8 W stage
  static constexpr size_t x_off = 0;
  static constexpr size_t w_off = x_off + STAGES * x_bytes;
  static constexpr size_t wb_off = w_off + STAGES * w_bytes;
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
__global__ void __launch_bounds__(THREADS) q8_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    float* __restrict__ ws, int M, int K, int N, int Np, int k_per_split) {
  using L = Smem<MT>;
  constexpr int MP = L::MP;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L::x_off);
  int8_t* w8 = reinterpret_cast<int8_t*>(smem + L::w_off);
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(smem + L::wb_off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // one stage: W is BK x BN int8 = 512 16-byte chunks (2 a thread); x is
  // MP x BK bf16 = MP * 8 chunks. Rows past k_end or M and columns past N
  // are zero-filled (src-size 0). K % 8 == 0 and splits start on multiples
  // of BK, so a chunk of 8 x values never straddles k_end.
  auto issue = [&](int slot, int k0) {
    int8_t* wdst = w8 + slot * L::w_bytes;
#pragma unroll
    for (int j = 0; j < (BK * BN / 16) / THREADS; ++j) {
      const int c = tid + j * THREADS;
      const int r = c >> 3, col = (c & 7) * 16;
      const int k = k0 + r;
      const bool ok = k < k_end && n0 + col < N;
      cp_async16(wdst + r * BN + col, ok ? w + (size_t)k * N + n0 + col : w, ok ? 16 : 0);
    }
    __nv_bfloat16* xdst = xs + slot * (L::x_bytes / 2);
#pragma unroll
    for (int j = 0; j < (MP * BK / 8 + THREADS - 1) / THREADS; ++j) {
      const int c = tid + j * THREADS;
      if (c < MP * BK / 8) {
        const int r = c >> 3, kc = (c & 7) * 8;
        const int k = k0 + kc;
        const bool ok = r < M && k < k_end;
        cp_async16(xdst + r * XS + kc, ok ? x + (size_t)r * K + k : x, ok ? 16 : 0);
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
    // widen stage t's int8 W into wb: 32 bytes a thread
    {
      const int slot = t % STAGES;
      const int r = tid >> 2, col = (tid & 3) * 32;
      const int8_t* src = w8 + slot * L::w_bytes + r * BN + col;
      __align__(16) int8_t raw[32];
      *reinterpret_cast<uint4*>(raw) = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(raw + 16) = *reinterpret_cast<const uint4*>(src + 16);
      __align__(16) __nv_bfloat162 h[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        h[e] = __floats2bfloat162_rn((float)raw[2 * e], (float)raw[2 * e + 1]);
      uint4* dst = reinterpret_cast<uint4*>(wb + r * WBS + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = reinterpret_cast<const uint4*>(h)[e];
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

__global__ void q8_finalize_kernel(const float* __restrict__ ws,
                                   const float* __restrict__ scale,
                                   __nv_bfloat16* __restrict__ out, int M, int N,
                                   int Np, int MP, int splitk) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * N) return;
  const int m = idx / N;
  const int n = idx - m * N;
  float s = 0.0f;
  for (int j = 0; j < splitk; ++j) s += ws[((size_t)j * MP + m) * Np + n];
  out[idx] = __float2bfloat16(s * scale[n]);
}

template <int MT>
cudaError_t launch(const void* x, const void* w, void* ws, int M, int K, int N,
                   int Np, int splitk, int k_per_split, cudaStream_t stream) {
  static bool attr_set = false;
  const size_t smem = Smem<MT>::bytes;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        q8_matmul_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid(Np / BN, splitk);
  q8_matmul_kernel<MT><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<float*>(ws), M, K, N, Np, k_per_split);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, w [K, N] int8, scale [N] f32, ws [splitk, 16*mt, Np] f32
// with Np = N rounded up to 128, out [M, N] bf16. Requires M <= 16*mt,
// mt in {1, 2, 4, 8, 16}, K % 8 == 0, N % 16 == 0, k_per_split % 64 == 0,
// 16-byte aligned x and w.
extern "C" int q8_matmul_bf16(const void* x, const void* w, const void* scale,
                              void* ws, void* out, int M, int K, int N, int mt,
                              int splitk, int k_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Np = (N + BN - 1) / BN * BN;
  cudaError_t err;
  switch (mt) {
    case 1: err = launch<1>(x, w, ws, M, K, N, Np, splitk, k_per_split, s); break;
    case 2: err = launch<2>(x, w, ws, M, K, N, Np, splitk, k_per_split, s); break;
    case 4: err = launch<4>(x, w, ws, M, K, N, Np, splitk, k_per_split, s); break;
    case 8: err = launch<8>(x, w, ws, M, K, N, Np, splitk, k_per_split, s); break;
    case 16: err = launch<16>(x, w, ws, M, K, N, Np, splitk, k_per_split, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int total = M * N;
  q8_finalize_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), M, N, Np, 16 * mt, splitk);
  return (int)cudaGetLastError();
}
