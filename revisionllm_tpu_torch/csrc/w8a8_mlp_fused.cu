// Row 8: the fused W8A8 SwiGLU tail.
//   g = (xq @ Gq) * xs * gs, u = (xq @ Uq) * xs * us   (exact int32 dots)
//   h = g / (1 + exp(-g)) * u                           (f32)
//   hs = absmax_row(h) / 127, hq = clip(rint(h / hs), -127, 127)
//
// Replaces the Pallas kernel revisionllm_tpu/ops/quant.py:732 _fused_mlp_kernel
// (entry w8a8_mlp_fused :767, pallas_call :805, reference w8a8_mlp_reference
// :869), which models/llama.py's _mlp_block runs in every layer when
// REVISIONLLM_FUSED_MLP=1: at the stage-1 prefill M = 64 x 300 rows, K 4096,
// N 11008, and at M = 64 in a split decode step.
//
// What bounds it on the H100: operations. Two int8 GEMMs of 2 M K N each,
// 3.46e12 a layer at the prefill shape, take 1.750 ms at 1979 TOP/s. The
// bytes, with the scratch this design adds (x 79 MB, the weights 90 MB, their
// K-major copy written and read 180 MB, h written and read 1.69 GB, hq 211
// MB), take 0.67 ms at 3.35 TB/s. Measured by scripts/torch_fused_mlp_kernel.py
// on an NVIDIA H100 80GB HBM3 at 700.00 W: 2.964 ms a layer at the prefill
// shape (transpose 0.064, GEMM 2.582, requantization 0.368 ms), against
// 11.163 ms for the mma.sync design this replaced and 14.38 ms for two
// torch._int_mm with the epilogue in PyTorch; 0.119 ms at M = 64 (transpose
// 0.059, GEMM 0.050), against 0.129 ms for the mma.sync design. What holds
// it back: the epilogue does not overlap the products (the GEMM without it
// takes 2.03 ms), and the requantization pass reads h back.
//
// Int8 wgmma (.s32.s8.s8) reads both operands K-major from shared memory
// (the transpose flags exist only for f16/bf16). x [M, K] is K-major; the
// weights are [K, N], N-contiguous, the JAX package's layout, which the port
// keeps (configuration A's decode, row 9, reads the same tensors). The
// design, in three launches on the caller's stream:
//   1. mlp_transpose_kernel turns gate and up [K, N] into one K-major
//      scratch [2, N, K] (90 MB, 2% of the layer's time at the prefill
//      shape, half of it at M = 64): 128 x 128-byte tiles through shared
//      memory, 16-byte loads, a 4 x 4-byte prmt transpose in registers, the
//      transposed tile staged back through shared memory (swizzled) so that
//      each warp stores whole 128-byte rows (storing 16 bytes of 32 rows at
//      once ran at 1.4 TB/s, 0.13 ms); it also zeroes the row absmax, so no
//      other launch is needed for it.
//   2. mlp_gemm_kernel, warp-specialised and persistent (one block an SM,
//      walking its tiles in a grouped order):
//      - a tile is 128 rows of x x the same 128 columns of gate and of up,
//        so both products share each x tile;
//      - a producer warp issues TMA copies of x, gate^T and up^T (128 x
//        128-byte boxes, 128-byte swizzle; zeros outside the tensors cover
//        the M edge, the N edge and the K tail) into a ring of STAGES stages
//        of 48 KB, each with a full and an empty mbarrier, running ahead
//        across tiles, so one tile's epilogue overlaps the next tile's loads;
//      - two consumer warpgroups, each with 64 rows of x, issue per k32 step
//        two wgmma.m64n128k32.s32.s8.s8, gate and up, on one x descriptor
//        (128 s32 accumulators a thread; setmaxnreg moves registers from the
//        producer's warpgroup to them). Their loop only waits on a stage's
//        full barrier and releases its empty one: no __syncthreads, no
//        cp.async wait;
//      - the epilogue computes h in f32 from the accumulators ((acc * xs) *
//        gs, expf, IEEE division, as the plain version), with the tile's
//        scales asked for at its start and staged through shared memory
//        (read inside the column loop they cost 16 device-memory round
//        trips a tile, 0.57 ms a layer); it stores h to the f32 scratch
//        (each quad of lanes writes one full 32-byte sector) and folds each
//        row's absmax into an atomicMax over the float bits (h >= 0 after
//        abs, so the integer order is the float order; max is order-free,
//        so the result is deterministic);
//      - the tile order: GROUP_M row tiles walk the column tiles together
//        (row fastest inside a group), so the 132 tiles in flight share 16
//        x stripes and 9 column tiles (8 + 9 MB of L2), and the weights
//        come from device memory about once a group (150 / 16 x 90 MB =
//        0.84 GB at the prefill shape, by the sizes). Walking each stripe
//        across all column tiles (GROUP_M 1) made the GEMM 0.68 ms slower.
//   3. mlp_quant_kernel: the row's absmax needs all N columns and a block
//      holds 128, so a second pass divides, rounds half to even and clips
//      (16-byte reads of h, 4-byte writes of hq). h is never rounded to
//      bf16 or f16 before it is quantized.
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/quant.py,
// which allocates the scratch (the K-major weights, h, the row absmax).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "wonly_matmul_common.cuh"

namespace {

constexpr int BM = 128;        // x rows of a tile: two consumer warpgroups of 64
constexpr int BN = 128;        // columns of gate and of up of a tile
constexpr int BK = 128;        // k (bytes) of a ring stage: four k32 steps
constexpr int STAGES = 4;
constexpr int GROUP_M = 16;    // row tiles that walk the column tiles together
constexpr int CONSUMERS = 256; // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer's warpgroup
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int BOX = BM * BK;   // one swizzled 128 x 128-byte box: 16 KB
constexpr int STAGE = 3 * BOX; // x, gate^T, up^T
constexpr int SCALES = 2 * (2 * BN + BM / 2);  // each warpgroup's gs, us and xs of a tile
constexpr size_t SMEM = (size_t)STAGES * STAGE + SCALES * 4 + 2 * STAGES * 8 + 1024;
constexpr int TT = 128;        // a transpose tile: 128 k rows x 128 columns
constexpr int TTHREADS = 256;
constexpr int QTHREADS = 256;

static_assert(BM == BN && BK == 128, "x, gate^T and up^T stages are 128 x 128-byte boxes");
static_assert(STAGE % 1024 == 0, "swizzled boxes sit on 1024-byte boundaries");
static_assert(SMEM <= 232448, "one block an SM");

// ---------------------------------------------------------------- transpose

// gate and up [K, N] (blockIdx.z 0 and 1) -> wt [2, N, K]; zeroes rowmax [M]
__global__ void __launch_bounds__(TTHREADS) mlp_transpose_kernel(
    const int8_t* __restrict__ gq, const int8_t* __restrict__ uq, int8_t* __restrict__ wt,
    unsigned* __restrict__ rowmax, int M, int K, int N) {
  __shared__ __align__(16) uint32_t tile[TT * TT / 4];  // row k at k * 128 bytes
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TT, k0 = blockIdx.y * TT;
  const int8_t* src = blockIdx.z ? uq : gq;
  int8_t* dst = wt + (size_t)blockIdx.z * N * K;
  const int nblocks = gridDim.x * gridDim.y * gridDim.z;
  const int b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  for (int i = b * TTHREADS + tid; i < M; i += nblocks * TTHREADS) rowmax[i] = 0u;

  // 128 rows x 8 chunks of 16 bytes, 4 a thread: a warp reads 4 whole rows
#pragma unroll
  for (int j = 0; j < TT * TT / 16 / TTHREADS; ++j) {
    const int c = tid + j * TTHREADS;
    const int r = c >> 3, ch = c & 7;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < K && n0 + 16 * ch < N)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(k0 + r) * N + n0 + 16 * ch);
    reinterpret_cast<uint4*>(tile)[c] = v;
  }
  __syncthreads();
  // thread (ng = lane, kg = warp): columns 4 ng .. 4 ng + 3, k rows 16 kg ..
  // 16 kg + 15. Its 16 words are one word of 16 rows (a warp reads a whole
  // row: no bank conflict); four 4 x 4-byte transposes give, for each of
  // its 4 columns, 16 k bytes of the output row.
  const int ng = tid & 31, kg = tid >> 5;
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = tile[(16 * kg + i) * (TT / 4) + ng];
  uint32_t o[4][4];  // o[j][q]: column 4 ng + j, k 16 kg + 4 q .. + 3
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t lo01 = __byte_perm(w[4 * q], w[4 * q + 1], 0x5140);
    const uint32_t hi01 = __byte_perm(w[4 * q], w[4 * q + 1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[4 * q + 2], w[4 * q + 3], 0x5140);
    const uint32_t hi23 = __byte_perm(w[4 * q + 2], w[4 * q + 3], 0x7362);
    o[0][q] = __byte_perm(lo01, lo23, 0x5410);
    o[1][q] = __byte_perm(lo01, lo23, 0x7632);
    o[2][q] = __byte_perm(hi01, hi23, 0x5410);
    o[3][q] = __byte_perm(hi01, hi23, 0x7632);
  }
  // The output tile [128 n][128 k bytes] goes back through the same shared
  // memory, 16-byte chunk kg of row n at chunk kg ^ (n / 4 % 8), so that the
  // 8 lanes of a store phase (8 rows 4 apart) hit 8 distinct chunks; then a
  // warp writes 4 whole 128-byte rows with 16-byte stores (full sectors).
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    reinterpret_cast<uint4*>(tile)[(4 * ng + j) * 8 + (kg ^ (ng & 7))] =
        make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < TT * TT / 16 / TTHREADS; ++j) {
    const int c = tid + j * TTHREADS;
    const int r = c >> 3, ch = c & 7;
    if (n0 + r < N && k0 + 16 * ch < K)
      *reinterpret_cast<uint4*>(dst + (size_t)(n0 + r) * K + k0 + 16 * ch) =
          reinterpret_cast<const uint4*>(tile)[r * 8 + (ch ^ ((r >> 2) & 7))];
  }
}

// --------------------------------------------------------------------- GEMM

// d (= or +=, by scale_d) a . b: m64n128k32, s8 x s8 -> s32, both operands
// K-major 128-byte-swizzled tiles in shared memory
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[16][4], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// the descriptor of k32 step kk of a K-major swizzled box (its 128-byte rows
// are the operand's m or n rows): 8-row groups 1024 bytes apart, the step 32
// bytes into the row (the swizzle is applied to the address by the unit)
__device__ __forceinline__ uint64_t box_desc(const unsigned char* box, int kk) {
  return attn::sw128_desc(box + kk * 32, 16, 1024);
}

// the barrier of warpgroup wg's 128 threads alone (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// the origin of tile `tile` in the grouped order: GROUP_M row tiles (fewer in
// the last group) walk the column tiles together, row fastest
__device__ __forceinline__ void tile_origin(int tile, int m_tiles, int n_tiles, int& m0,
                                            int& n0) {
  const int per_group = GROUP_M * n_tiles;
  const int group = tile / per_group, first = group * GROUP_M;
  const int rows = min(m_tiles - first, GROUP_M);
  const int in = tile - group * per_group;
  m0 = (first + in % rows) * BM;
  n0 = (in / rows) * BN;
}

__global__ void __launch_bounds__(THREADS, 1) mlp_gemm_kernel(
    const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ CUtensorMap tmap_g,
    const __grid_constant__ CUtensorMap tmap_u, const float* __restrict__ xs,
    const float* __restrict__ gs, const float* __restrict__ us, float* __restrict__ h,
    unsigned* __restrict__ rowmax, int M, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = attn::align1024(smem_raw);
  float* scales = reinterpret_cast<float*>(smem + (size_t)STAGES * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(scales + SCALES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles, nk = (K + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      wonly::mbar_init(full + s, 1);
      wonly::mbar_init(empty + s, CONSUMERS / 32);
    }
    wonly::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // the producer's warpgroup gives its registers away; one lane fills the
    // ring, STAGES stages ahead of the consumers, across tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (warp == CONSUMERS / 32 && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, m_tiles, n_tiles, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int slot = it % STAGES;
          if (it >= STAGES) wonly::mbar_wait(empty + slot, (it / STAGES - 1) & 1);
          unsigned char* st = smem + (size_t)slot * STAGE;
          wonly::mbar_arrive_expect(full + slot, (uint32_t)STAGE);
          wonly::tma_load_2d(st, &tmap_x, kt * BK, m0, full + slot);
          wonly::tma_load_2d(st + BOX, &tmap_g, kt * BK, n0, full + slot);
          wonly::tma_load_2d(st + 2 * BOX, &tmap_u, kt * BK, n0, full + slot);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    // warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile; warp w of it
    // rows 16 w .. 16 w + 15 of those (the m64 accumulator layout)
    const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
    const int c = tid & 127;  // this thread's column and row of the scales
    float* sgs = scales + wg * (2 * BN + BM / 2);
    float* sus = sgs + BN;
    float* sxs = sus + BN;
    uint32_t accg[16][4], accu[16][4];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, m_tiles, n_tiles, m0, n0);
      // the tile's scales are asked for now and staged through shared
      // memory for the epilogue, so it waits on no device-memory load
      const float gsc = n0 + c < N ? gs[n0 + c] : 0.0f;
      const float usc = n0 + c < N ? us[n0 + c] : 0.0f;
      const int xrow = m0 + 64 * wg + c;
      const float xsc = c < BM / 2 && xrow < M ? xs[xrow] : 0.0f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int slot = it % STAGES;
        wonly::mbar_wait(full + slot, (it / STAGES) & 1);
        const unsigned char* st = smem + (size_t)slot * STAGE;
        attn::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          const uint64_t da = box_desc(st + wg * (BOX / 2), kk);
          const int acc = kt > 0 || kk > 0;
          wgmma_s8(accg, da, box_desc(st + BOX, kk), acc);
          wgmma_s8(accu, da, box_desc(st + 2 * BOX, kk), acc);
        }
        attn::wgmma_commit();
        attn::wgmma_wait0();
        attn::pin(accg);
        attn::pin(accu);
        if (lane == 0) wonly::mbar_arrive(empty + slot);
      }

      // the epilogue: register (j, 2 half + e) holds row 16 w + g + 8 half,
      // column 8 j + 2 t + e of the warpgroup's 64 x 128 tile
      wg_sync(wg);  // the previous tile's epilogue has read the scales
      sgs[c] = gsc;
      sus[c] = usc;
      if (c < BM / 2) sxs[c] = xsc;
      wg_sync(wg);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * w + g + 8 * half, row = m0 + 64 * wg + r;
        float amax = 0.0f;
        if (row < M) {
          const float xr = sxs[r];
          float* hr = h + (size_t)row * N;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            if (col < N) {
              const float2 gsc2 = *reinterpret_cast<const float2*>(sgs + 8 * j + 2 * t);
              const float2 usc2 = *reinterpret_cast<const float2*>(sus + 8 * j + 2 * t);
              float hv[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float gv = (float)(int)accg[j][2 * half + e] * xr * (e ? gsc2.y : gsc2.x);
                const float uv = (float)(int)accu[j][2 * half + e] * xr * (e ? usc2.y : usc2.x);
                hv[e] = (gv / (1.0f + expf(-gv))) * uv;
                amax = fmaxf(amax, fabsf(hv[e]));
              }
              *reinterpret_cast<float2*>(hr + col) = make_float2(hv[0], hv[1]);
            }
          }
        }
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
        if (t == 0 && row < M) atomicMax(rowmax + row, __float_as_uint(amax));
      }
    }
  }
}

// ------------------------------------------------------------ requantize

__device__ __forceinline__ uint32_t q8(float v, float s) {
  return (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(rintf(v / s), -127.0f), 127.0f);
}

// one block a row: hs = absmax / 127 (1 where absmax is 0), hq = clip(rint(h
// / hs), -127, 127); N % 4 == 0
__global__ void __launch_bounds__(QTHREADS) mlp_quant_kernel(
    const float* __restrict__ h, const unsigned* __restrict__ rowmax, int8_t* __restrict__ hq,
    float* __restrict__ hs, int N) {
  const int row = blockIdx.x;
  const float amax = __uint_as_float(rowmax[row]);
  const float s = amax > 0.0f ? amax / 127.0f : 1.0f;
  if (threadIdx.x == 0) hs[row] = s;
  const float4* hr = reinterpret_cast<const float4*>(h + (size_t)row * N);
  uint32_t* qr = reinterpret_cast<uint32_t*>(hq + (size_t)row * N);
  for (int c = threadIdx.x; c < N / 4; c += QTHREADS) {
    const float4 v = __ldcs(hr + c);
    qr[c] = q8(v.x, s) | (q8(v.y, s) << 8) | (q8(v.z, s) << 16) | (q8(v.w, s) << 24);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

// xq [M, K] int8, xs [M] f32, gq/uq [K, N] int8 row-major, gs/us [N] f32;
// scratch: wt [2, N, K] int8 (the K-major weights), h [M, N] f32, rowmax [M]
// (4 bytes a row, zeroed here); out hq [M, N] int8, hs [M] f32. Requires
// M >= 1, K % 16 == 0, N % 16 == 0, 16-byte aligned int8 pointers. Three
// launches: the transpose, the GEMM with the SwiGLU epilogue, the
// requantization.
extern "C" int w8a8_mlp_fused(const void* xq, const void* xs, const void* gq, const void* gs,
                              const void* uq, const void* us, void* wt, void* h, void* rowmax,
                              void* hq, void* hs, int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        mlp_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int sms = sm_count();
  int8_t* gt = static_cast<int8_t*>(wt);
  CUtensorMap tmap_x, tmap_g, tmap_u;
  if (sms <= 0 ||
      !wonly::encode(&tmap_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, K, M, K, BK, BM) ||
      !wonly::encode(&tmap_g, CU_TENSOR_MAP_DATA_TYPE_UINT8, gt, K, N, K, BK, BN) ||
      !wonly::encode(&tmap_u, CU_TENSOR_MAP_DATA_TYPE_UINT8, gt + (size_t)N * K, K, N, K, BK, BN))
    return (int)cudaErrorInvalidValue;

  mlp_transpose_kernel<<<dim3((N + TT - 1) / TT, (K + TT - 1) / TT, 2), TTHREADS, 0, s>>>(
      static_cast<const int8_t*>(gq), static_cast<const int8_t*>(uq), gt,
      static_cast<unsigned*>(rowmax), M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  mlp_gemm_kernel<<<tiles < sms ? tiles : sms, THREADS, SMEM, s>>>(
      tmap_x, tmap_g, tmap_u, static_cast<const float*>(xs), static_cast<const float*>(gs),
      static_cast<const float*>(us), static_cast<float*>(h), static_cast<unsigned*>(rowmax), M,
      K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_quant_kernel<<<M, QTHREADS, 0, s>>>(static_cast<const float*>(h),
                                          static_cast<const unsigned*>(rowmax),
                                          static_cast<int8_t*>(hq), static_cast<float*>(hs), N);
  return (int)cudaGetLastError();
}

// the dynamic shared memory of kernel `which` (0 the GEMM, 1 the transpose,
// 2 the requantization), for the ptxas report
extern "C" int w8a8_mlp_smem_bytes(int which) { return which == 0 ? (int)SMEM : 0; }
