// Row 8: the fused W8A8 SwiGLU tail.
//   g = (xq @ Gq) * xs * gs, u = (xq @ Uq) * xs * us   (exact int32 dots)
//   h = g / (1 + exp(-g)) * u                           (f32)
//   hs = absmax_row(h) / 127, hq = clip(rint(h / hs), -127, 127)
//
// Replaces the Pallas kernel revisionllm_tpu/ops/quant.py:732 _fused_mlp_kernel
// (entry w8a8_mlp_fused :767, pallas_call :805), which models/llama.py's
// _mlp_block runs in every layer when REVISIONLLM_FUSED_MLP=1: at the stage-1
// prefill M = 64 x 301 rows, K = 4096, N = 11008.
//
// What bounds it on the H100: operations. Two int8 GEMMs of 2 M K N each,
// about 3.5e12 a layer, take 1.76 ms at 1979 TOPS; the bytes (x 79 MB, the
// weights 90 MB, hq 212 MB) take 0.1 ms. The design:
//   - int8 tensor cores through mma.sync.m16n8k32 (s8 x s8 -> s32). A block
//     owns a 128-row x 64-column tile of BOTH gate and up, which share each
//     A (xq) tile; 8 warps of 32 x 32 each; a 4-stage cp.async pipeline of
//     64-deep K tiles.
//   - The weights stay [K, N] row-major, as JAX stores them. The mma B
//     operand wants 4 consecutive k of one column in a register, so each
//     landed B tile is transposed in shared memory (4 x 4 byte blocks,
//     __byte_perm), not copied in device memory on every call.
//   - The per-row absmax runs over all N, and the Pallas kernel keeps a
//     whole [256, 11008] row block of both int32 accumulators in VMEM (22
//     MB); an H100 block has 227 KB. So this is two passes: the GEMM's
//     epilogue computes h in f32, stores it to an f32 scratch and folds the
//     row's absmax into an atomicMax over the float bits (h >= 0 after abs,
//     so the integer order is the float order, and max is order-free: the
//     result is deterministic); a second kernel divides, rounds half to even
//     and clips. The scratch costs 2 x 4 M N bytes of traffic (0.5 ms at the
//     prefill shape), against the unfused path's two int32 [M, N] products,
//     their rescale, the bf16 intermediate and its absmax/round/clip passes.
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/quant.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // rows per block
constexpr int BN = 64;         // columns per block (of gate and of up)
constexpr int BK = 64;         // K per pipeline stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;   // 8 warps: 4 along M (32 rows) x 2 along N (32 cols)
constexpr int AS = BK + 16;    // smem row stride (bytes) of an A stage
constexpr int BTS = BK + 16;   // smem row stride (bytes) of a transposed B tile

constexpr size_t A_BYTES = (size_t)BM * AS;
constexpr size_t B_BYTES = (size_t)BK * BN;   // one row-major B stage
constexpr size_t STAGE_BYTES = A_BYTES + 2 * B_BYTES;
constexpr size_t BT_OFF = STAGES * STAGE_BYTES;
constexpr size_t SMEM_BYTES = BT_OFF + 2 * (size_t)BN * BTS;

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

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 64 x 64 row-major int8 tile src (row stride BN) -> dst[n][k] (row stride
// BTS): thread t transposes the 4 x 4 block at k rows 4 (t >> 4), n columns
// 4 (t & 15).
__device__ __forceinline__ void transpose_tile(const uint8_t* src, uint8_t* dst, int tid) {
  const int kb = tid >> 4, nb = tid & 15;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src + (4 * kb) * BN + 4 * nb);
  const uint32_t w0 = s[0], w1 = s[BN / 4], w2 = s[2 * BN / 4], w3 = s[3 * BN / 4];
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
  uint8_t* d = dst + (4 * nb) * BTS + 4 * kb;
  *reinterpret_cast<uint32_t*>(d) = __byte_perm(lo01, lo23, 0x5410);
  *reinterpret_cast<uint32_t*>(d + BTS) = __byte_perm(lo01, lo23, 0x7632);
  *reinterpret_cast<uint32_t*>(d + 2 * BTS) = __byte_perm(hi01, hi23, 0x5410);
  *reinterpret_cast<uint32_t*>(d + 3 * BTS) = __byte_perm(hi01, hi23, 0x7632);
}

__global__ void __launch_bounds__(THREADS) mlp_gemm_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ xs, const int8_t* __restrict__ gq,
    const float* __restrict__ gs, const int8_t* __restrict__ uq, const float* __restrict__ us,
    float* __restrict__ h, unsigned* __restrict__ rowmax, int M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int grp = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  uint8_t* gT = smem + BT_OFF;
  uint8_t* uT = gT + (size_t)BN * BTS;

  // one stage: A 128 x 64 bytes (512 chunks, 2 a thread), gate and up 64 x
  // 64 bytes (256 chunks each). Rows past M, k past K and columns past N
  // are zero-filled; K % 16 == 0 and N % 16 == 0, so no chunk is cut.
  auto issue = [&](int slot, int k0) {
    unsigned char* st = smem + slot * STAGE_BYTES;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * THREADS;
      const int r = c >> 2, kc = (c & 3) * 16;
      const bool ok = m0 + r < M && k0 + kc < K;
      cp_async16(st + r * AS + kc, ok ? xq + (size_t)(m0 + r) * K + k0 + kc : xq, ok ? 16 : 0);
    }
    {
      const int r = tid >> 2, nc = (tid & 3) * 16;
      const bool ok = k0 + r < K && n0 + nc < N;
      const size_t off = (size_t)(k0 + r) * N + n0 + nc;
      cp_async16(st + A_BYTES + r * BN + nc, ok ? gq + off : gq, ok ? 16 : 0);
      cp_async16(st + A_BYTES + B_BYTES + r * BN + nc, ok ? uq + off : uq, ok ? 16 : 0);
    }
  };

  int accg[2][4][4], accu[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accg[i][j][e] = accu[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s, s * BK);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage t landed everywhere; stage t - 1's mma is done
    {
      const int tn = t + STAGES - 1;
      if (tn < nk) issue(tn % STAGES, tn * BK);
      cp_async_commit();
    }
    const unsigned char* st = smem + (t % STAGES) * STAGE_BYTES;
    transpose_tile(st + A_BYTES, gT, tid);
    transpose_tile(st + A_BYTES + B_BYTES, uT, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned char* ar = st + (wm * 32 + i * 16 + grp) * AS + kk + tig * 4;
        a[i][0] = *reinterpret_cast<const unsigned*>(ar);
        a[i][1] = *reinterpret_cast<const unsigned*>(ar + 8 * AS);
        a[i][2] = *reinterpret_cast<const unsigned*>(ar + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(ar + 8 * AS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + grp;
        const unsigned char* gb = gT + n * BTS + kk + tig * 4;
        const unsigned char* ub = uT + n * BTS + kk + tig * 4;
        const unsigned g0 = *reinterpret_cast<const unsigned*>(gb);
        const unsigned g1 = *reinterpret_cast<const unsigned*>(gb + 16);
        const unsigned u0 = *reinterpret_cast<const unsigned*>(ub);
        const unsigned u1 = *reinterpret_cast<const unsigned*>(ub + 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_s8(accg[i][j], a[i], g0, g1);
          mma_s8(accu[i][j], a[i], u0, u1);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: thread holds rows (grp, grp + 8) of each 16-row tile i and
  // columns (2 tig, 2 tig + 1) of each 8-column tile j
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + i * 16 + grp + 8 * half;
      float amax = 0.0f;
      if (row < M) {
        const float xsr = xs[row];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + wn * 32 + j * 8 + tig * 2;
          if (col < N) {
            float hv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float g = (float)accg[i][j][2 * half + e] * xsr * gs[col + e];
              const float u = (float)accu[i][j][2 * half + e] * xsr * us[col + e];
              hv[e] = (g / (1.0f + expf(-g))) * u;
              amax = fmaxf(amax, fabsf(hv[e]));
            }
            *reinterpret_cast<float2*>(h + (size_t)row * N + col) = make_float2(hv[0], hv[1]);
          }
        }
      }
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      if (tig == 0 && row < M) atomicMax(rowmax + row, __float_as_uint(amax));
    }
  }
}

__global__ void mlp_quant_kernel(const float* __restrict__ h, const float* __restrict__ rowmax,
                                 int8_t* __restrict__ hq, float* __restrict__ hs, int N) {
  const int row = blockIdx.x;
  const float amax = rowmax[row];
  const float s = amax > 0.0f ? amax / 127.0f : 1.0f;
  if (threadIdx.x == 0) hs[row] = s;
  const float* hr = h + (size_t)row * N;
  int8_t* qr = hq + (size_t)row * N;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    const float q = fminf(fmaxf(rintf(hr[c] / s), -127.0f), 127.0f);
    qr[c] = (int8_t)q;
  }
}

}  // namespace

// xq [M, K] int8, xs [M] f32, gq/uq [K, N] int8 row-major, gs/us [N] f32;
// h [M, N] f32 scratch, rowmax [M] zeroed f32 scratch; out hq [M, N] int8,
// hs [M] f32. Requires K % 16 == 0, N % 16 == 0, 16-byte aligned int8
// pointers.
extern "C" int w8a8_mlp_fused(const void* xq, const void* xs, const void* gq, const void* gs,
                              const void* uq, const void* us, void* h, void* rowmax, void* hq,
                              void* hs, int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        mlp_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mlp_gemm_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(gq), static_cast<const float*>(gs),
      static_cast<const int8_t*>(uq), static_cast<const float*>(us), static_cast<float*>(h),
      static_cast<unsigned*>(rowmax), M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_quant_kernel<<<M, 256, 0, s>>>(static_cast<const float*>(h),
                                     static_cast<const float*>(rowmax),
                                     static_cast<int8_t*>(hq), static_cast<float*>(hs), N);
  return (int)cudaGetLastError();
}
