// The W8A8 prefill product in three launches:
//   xq, xs = absmax_row(x) int8          (quantize_rows_kernel)
//   wt = w^T                              (kmajor_transpose_kernel)
//   out = bf16((float(xq @ w) * xs) * ws) (s8gemm_kernel)
//
// Replaces no TPU kernel: the JAX package leaves W8A8 to XLA's int8 dot
// (revisionllm_tpu/ops/quant.py quantize_activation_rows and w8a8_matmul).
// It replaces the port's PyTorch route for the same maths (ops/quant.py
// quantize_activation_rows, _int8_dot on torch._int_mm, _w8a8_scale), whose
// elementwise passes wrote the f32 quotient of the quantization, the int32
// product and two f32 scaled copies of it to device memory: about 33 bytes of
// traffic an input element and 26 an output element, two thirds of a
// stage-1 prefill's device time. Here none of them reaches device memory;
// the results are bit-equal to that route.
//
// What bounds it on the H100: the GEMM, by operations (2 M K N at 1979
// TOP/s: 1.1 ms for one of ChatGLM2-6B's FFN matrices at M = 64 x 300); the
// quantizer and the transpose by bytes (3 bytes an element of x; 2 a weight
// byte at 3.35 TB/s).
//
// 1. quantize_rows_kernel<G, V>: G threads a row (16 for rows of 128, the
//    prompt cache's head_dim; 256 for the linears' 4096, 11008 and 13696),
//    each reading V 16-byte vectors of bf16 once and keeping them in
//    registers; the row's absmax by warp shuffles (and shared memory across
//    the block's warps when G = 256); then scale = absmax x fl(1 / 127) (1
//    where the absmax is 0): PyTorch's CUDA division by a scalar, absmax /
//    127.0, multiplies by the scalar's f32 reciprocal (at::native
//    div_true_kernel_cuda), and this is its product to the bit (the CPU's
//    division rounds once, so some scales differ from the CPU's in the last
//    bit, as they did before); and q = clip(rint(x / scale), -127, 127), an
//    IEEE division (no fast maths) and the rounding half to even of
//    torch.div(x, scale).round_() by a tensor. Writes 8 bytes of int8 a
//    vector and one f32 scale a row.
// 2. kmajor_transpose_kernel: int8 wgmma (.s32.s8.s8) reads both operands
//    K-major from shared memory, and the weights are [K, N], N-contiguous
//    (the JAX package's layout, which the decode's K1 reads too), so each
//    call turns its matrix K-major into a scratch [N, K]: row 8's design
//    (csrc/w8a8_mlp_fused.cu mlp_transpose_kernel: 128 x 128-byte tiles
//    through shared memory, 16-byte loads, a 4 x 4-byte prmt transpose in
//    registers, the tile staged back swizzled so that each warp stores whole
//    128-byte rows) for one matrix.
// 3. s8gemm_kernel<NB>: row 8's GEMM structure, warp-specialised and
//    persistent (one block an SM walking its tiles in a grouped order):
//    - a tile is 128 rows of x by NB x 128 columns of w: NB 2, or 1 where
//      the wide tiles would not fill two waves (ChatGLM2's k and v, N 256);
//    - a producer warp issues TMA copies of x and of the NB boxes of w^T
//      (128 x 128-byte boxes, 128-byte swizzle; zeros outside the tensors
//      cover the M edge and the K tail, and a box past N is not copied)
//      into a ring of 192 KB (4 stages of 48 KB, or 6 of 32 KB), each stage
//      with a full and an empty mbarrier, running ahead across tiles;
//    - two consumer warpgroups of 64 rows each issue NB
//      wgmma.m64n128k32.s32.s8.s8 a k32 step on one x descriptor
//      (setmaxnreg moves registers from the producer's warpgroup to them),
//      keeping one stage's products in flight while they issue the next
//      stage's;
//    - the epilogue: the tile's scales are asked for at its start and
//      staged through shared memory (read inside the column loop they cost
//      row 8 0.57 ms a layer), then each accumulator becomes
//      bf16_rn((float_rn(acc) * xs) * ws), the order and rounding of
//      torch.mul(acc, xs).mul_(ws).to(bf16). Each warpgroup writes a box of
//      128 columns into its staging buffer (two 64 x 64 boxes with the
//      128-byte swizzle, so the 4-byte writes of a warp hit 32 banks) and
//      one thread stores it by TMA through the output's tensor map (its row
//      stride lets a product land in its column slice of a wider output,
//      the serving layout's column chunks; rows past M and columns past N
//      are not written). The stores run on while the next box is converted
//      and the next tile is multiplied: storing from registers instead (a
//      warp writing 8 rows x 16 bytes an instruction) left the GEMM at
//      52-64% of its bound, against 76-81% now (scripts/torch_w8a8_gemm.py,
//      NVIDIA H100 80GB HBM3 at 700.00 W). An f32 output (the tensor-
//      parallel down_proj of the fused MLP) is stored from registers.
//    The int32 sums are exact (|acc| <= 127^2 K), so the product equals
//    torch._int_mm's to the bit.
//
// 4. moe_w8a8_kernel<NB>: the same GEMM over DeepSeekMoE's experts (see
//    its definition); s8gemm_kernel and it share s8gemm_body, the grouped
//    walk compiled only into the latter.
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/quant.py
// (quantize_rows, w8a8_gemm) and ops/moe.py (moe_w8a8_gemm), which allocate
// the outputs and the scratch and pick NB (w8a8_tile_columns).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "wonly_matmul_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- quantize rows

constexpr int QTHREADS = 256;

__device__ __forceinline__ float absmax8(const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    m = fmaxf(m, fmaxf(fabsf(__low2float(p)), fabsf(__high2float(p))));
  }
  return m;
}

__device__ __forceinline__ uint32_t q8(float v, float s) {
  return (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
}

// two bf16 of one word -> two int8 bytes (low half first)
__device__ __forceinline__ uint32_t q8x2(uint32_t w, float s) {
  const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w);
  return q8(__low2float(p), s) | (q8(__high2float(p), s) << 8);
}

// x [M, K] bf16 -> q [M, K] int8, s [M] f32; G threads a row, each with V
// vectors of 8; K % 8 == 0, K <= 8 G V
template <int G, int V>
__global__ void __launch_bounds__(QTHREADS) quantize_rows_kernel(
    const bf16* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s, int M, int K) {
  static_assert(QTHREADS % G == 0 && (G <= 32 || G == QTHREADS), "a row is a part of a warp, or the block");
  __shared__ float wmax[QTHREADS / 32];
  const int tid = threadIdx.x, lane = tid % G;
  const long long row = (long long)blockIdx.x * (QTHREADS / G) + tid / G;
  const int nvec = K / 8;
  uint4 v[V];
  float amax = 0.0f;
  if (row < M) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * K);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + i * G;
      v[i] = c < nvec ? __ldcs(xr + c) : make_uint4(0u, 0u, 0u, 0u);
      amax = fmaxf(amax, absmax8(v[i]));
    }
  }
#pragma unroll
  for (int off = (G < 32 ? G : 32) / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (G == QTHREADS) {
    if ((tid & 31) == 0) wmax[tid >> 5] = amax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < QTHREADS / 32; ++w) amax = fmaxf(amax, wmax[w]);
  }
  if (row >= M) return;
  const float sc = amax > 0.0f ? __fmul_rn(amax, 1.0f / 127.0f) : 1.0f;
  if (lane == 0) s[row] = sc;
  uint2* qr = reinterpret_cast<uint2*>(q + row * K);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + i * G;
    if (c < nvec)
      qr[c] = make_uint2(q8x2(v[i].x, sc) | (q8x2(v[i].y, sc) << 16),
                         q8x2(v[i].z, sc) | (q8x2(v[i].w, sc) << 16));
  }
}

template <int G, int V>
cudaError_t launch_quantize(const void* x, void* q, void* s, int M, int K, cudaStream_t st) {
  constexpr int ROWS = QTHREADS / G;
  quantize_rows_kernel<G, V><<<(M + ROWS - 1) / ROWS, QTHREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), M, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- transpose

constexpr int TT = 128;  // a transpose tile: 128 k rows x 128 columns
constexpr int TTHREADS = 256;

// w [K, N] -> wt [N, K]
__global__ void __launch_bounds__(TTHREADS) kmajor_transpose_kernel(
    const int8_t* __restrict__ w, int8_t* __restrict__ wt, int K, int N) {
  __shared__ __align__(16) uint32_t tile[TT * TT / 4];  // row k at k * 128 bytes
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TT, k0 = blockIdx.y * TT;
  // 128 rows x 8 chunks of 16 bytes, 4 a thread: a warp reads 4 whole rows
#pragma unroll
  for (int j = 0; j < TT * TT / 16 / TTHREADS; ++j) {
    const int c = tid + j * TTHREADS;
    const int r = c >> 3, ch = c & 7;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < K && n0 + 16 * ch < N)
      v = __ldcs(reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + n0 + 16 * ch));
    reinterpret_cast<uint4*>(tile)[c] = v;
  }
  __syncthreads();
  // thread (ng = lane, kg = warp): columns 4 ng .. 4 ng + 3, k rows 16 kg ..
  // 16 kg + 15; four 4 x 4-byte transposes give, for each of its 4 columns,
  // 16 k bytes of the output row
  const int ng = tid & 31, kg = tid >> 5;
  uint32_t b[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) b[i] = tile[(16 * kg + i) * (TT / 4) + ng];
  uint32_t o[4][4];  // o[j][q]: column 4 ng + j, k 16 kg + 4 q .. + 3
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t lo01 = __byte_perm(b[4 * q], b[4 * q + 1], 0x5140);
    const uint32_t hi01 = __byte_perm(b[4 * q], b[4 * q + 1], 0x7362);
    const uint32_t lo23 = __byte_perm(b[4 * q + 2], b[4 * q + 3], 0x5140);
    const uint32_t hi23 = __byte_perm(b[4 * q + 2], b[4 * q + 3], 0x7362);
    o[0][q] = __byte_perm(lo01, lo23, 0x5410);
    o[1][q] = __byte_perm(lo01, lo23, 0x7632);
    o[2][q] = __byte_perm(hi01, hi23, 0x5410);
    o[3][q] = __byte_perm(hi01, hi23, 0x7632);
  }
  // back through shared memory, 16-byte chunk kg of row n at chunk kg ^ (n /
  // 4 % 8), so the 8 lanes of a store phase hit 8 distinct chunks; then a
  // warp writes 4 whole 128-byte rows
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
      *reinterpret_cast<uint4*>(wt + (size_t)(n0 + r) * K + k0 + 16 * ch) =
          reinterpret_cast<const uint4*>(tile)[r * 8 + (ch ^ ((r >> 2) & 7))];
  }
}

// --------------------------------------------------------------------- GEMM

constexpr int BM = 128;        // x rows of a tile: two consumer warpgroups of 64
constexpr int BK = 128;        // k (bytes) of a ring stage: four k32 steps
constexpr int GROUP_M = 16;    // row tiles that walk the column tiles together
constexpr int CONSUMERS = 256; // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer's warpgroup
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int BOX = BM * BK;   // one swizzled 128 x 128-byte box: 16 KB
constexpr int RING = 12 * BOX; // 192 KB of stages, whatever the tile's width
constexpr int OUT_BOX = 64 * 128;       // a bf16 output box: 64 rows x 64 columns, 8 KB
constexpr int STAGING = 2 * OUT_BOX;    // a warpgroup's 64 x 128 columns of output

template <int NB>
struct Tile {
  static constexpr int BN = 128 * NB;            // columns of w
  static constexpr int STAGE = (1 + NB) * BOX;   // x and NB boxes of w^T
  static constexpr int STAGES = RING / STAGE;    // 4 (NB 2) or 6 (NB 1)
  static constexpr int SCALES = BN + BM;         // the tile's ws, then each warpgroup's xs
  static constexpr size_t SMEM =
      (size_t)RING + 2 * STAGING + SCALES * 4 + 2 * STAGES * 8 + 1024;
  static_assert(STAGE % 1024 == 0, "swizzled boxes sit on 1024-byte boundaries");
  static_assert(SMEM <= 232448, "one block an SM");
};

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
// are the operand's m or n rows): 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t box_desc(const unsigned char* box, int kk) {
  return attn::sw128_desc(box + kk * 32, 16, 1024);
}

// the barrier of warpgroup wg's 128 threads alone (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// the barrier of both consumer warpgroups (named barrier 3)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, %0;\n" :: "n"(CONSUMERS) : "memory");
}

// the TMA store of the swizzled box at src to (c0 inner, c1 outer) of the
// tensor map `map` (elements outside the tensor are not written), in this
// thread's bulk group
__device__ __forceinline__ void tma_store_2d(const void* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(wonly::smem_addr(src))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wait until this thread's bulk stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the origin of tile `tile` in the grouped order: GROUP_M row tiles (fewer in
// the last group) walk the column tiles together, row fastest
__device__ __forceinline__ void tile_origin(int tile, int m_tiles, int n_tiles, int bn, int& m0,
                                            int& n0) {
  const int per_group = GROUP_M * n_tiles;
  const int group = tile / per_group, first = group * GROUP_M;
  const int rows = min(m_tiles - first, GROUP_M);
  const int in = tile - group * per_group;
  m0 = (first + in % rows) * BM;
  n0 = (in / rows) * bn;
}

// the boxes of w^T a tile at column n0 copies and stores: those that start
// before N
template <int NB>
__device__ __forceinline__ int live_boxes(int n0, int N) {
  return min(NB, (N - n0 + 127) / 128);
}

// out = bf16_rn((float_rn(acc) * xs) * ws), or the f32 product when out_f32;
// bf16 goes out through tmap_o (64 x 64 boxes, 128-byte swizzle), f32 by
// direct stores through the row stride ldo. GROUPED (the experts' GEMM,
// moe_w8a8_kernel): *n_mtiles row tiles are in use, row tile i belongs to
// expert tile_expert[i], whose weights are rows e N .. e N + N - 1 of
// tmap_w ([E N, K]) and whose scales are ws + e N; the rest is the dense
// kernel's path
template <int NB, bool GROUPED>
__device__ __forceinline__ void s8gemm_body(
    const CUtensorMap& tmap_x, const CUtensorMap& tmap_w, const CUtensorMap& tmap_o,
    const float* __restrict__ xs, const float* __restrict__ ws, float* __restrict__ out_f32,
    int M, int K, int N, long long ldo, const int* __restrict__ tile_expert,
    const int* __restrict__ n_mtiles) {
  using T = Tile<NB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = attn::align1024(smem_raw);
  unsigned char* staging = smem + RING;
  float* sws = reinterpret_cast<float*>(staging + 2 * STAGING);
  float* sxs = sws + T::BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(sxs + BM);
  uint64_t* empty = full + T::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m_tiles = GROUPED ? *n_mtiles : (M + BM - 1) / BM;
  const int n_tiles = (N + T::BN - 1) / T::BN;
  const int tiles = m_tiles * n_tiles, nk = (K + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
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
        tile_origin(tile, m_tiles, n_tiles, T::BN, m0, n0);
        const int live = live_boxes<NB>(n0, N);
        if (GROUPED) n0 += tile_expert[m0 / BM] * N;  // the tile's expert's rows of w^T
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int slot = it % T::STAGES;
          if (it >= T::STAGES) wonly::mbar_wait(empty + slot, (it / T::STAGES - 1) & 1);
          unsigned char* st = smem + (size_t)slot * T::STAGE;
          wonly::mbar_arrive_expect(full + slot, (uint32_t)((1 + live) * BOX));
          wonly::tma_load_2d(st, &tmap_x, kt * BK, m0, full + slot);
#pragma unroll
          for (int b = 0; b < NB; ++b)
            if (b < live) wonly::tma_load_2d(st + (1 + b) * BOX, &tmap_w, kt * BK, n0 + 128 * b,
                                             full + slot);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    // warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile; warp w of it
    // rows 16 w .. 16 w + 15 of those (the m64 accumulator layout)
    const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
    const int c = tid & 127;  // this thread's column (of each box) and row of the scales
    unsigned char* stage_out = staging + wg * STAGING;
    uint32_t acc[NB][16][4];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, m_tiles, n_tiles, T::BN, m0, n0);
      const int live = live_boxes<NB>(n0, N);
      const float* wse = GROUPED ? ws + (size_t)tile_expert[m0 / BM] * N : ws;
      // the tile's scales are asked for now and staged through shared
      // memory for the epilogue, so it waits on no device-memory load
      float wsc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int col = n0 + 128 * b + c;
        wsc[b] = wg == 0 && col < N ? wse[col] : 0.0f;
      }
      const int xrow = m0 + 64 * wg + c;
      const float xsc = c < BM / 2 && xrow < M ? xs[xrow] : 0.0f;
      // the main loop keeps one stage's products in flight while it issues
      // the next stage's, and releases each stage once its products are done
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int slot = it % T::STAGES;
        wonly::mbar_wait(full + slot, (it / T::STAGES) & 1);
        const unsigned char* st = smem + (size_t)slot * T::STAGE;
        attn::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          const uint64_t da = box_desc(st + wg * (BOX / 2), kk);
          const int accum = kt > 0 || kk > 0;
          // a box past N was not copied: its products are of stale bytes,
          // and the epilogue stores none of them
#pragma unroll
          for (int b = 0; b < NB; ++b)
            wgmma_s8(acc[b], da, box_desc(st + (1 + b) * BOX, kk), accum);
        }
        attn::wgmma_commit();
        wonly::wgmma_wait<1>();
#pragma unroll
        for (int b = 0; b < NB; ++b) attn::pin(acc[b]);
        if (kt > 0 && lane == 0) wonly::mbar_arrive(empty + (it - 1) % T::STAGES);
      }
      attn::wgmma_wait0();
#pragma unroll
      for (int b = 0; b < NB; ++b) attn::pin(acc[b]);
      if (lane == 0) wonly::mbar_arrive(empty + (it - 1) % T::STAGES);

      // the epilogue: register (j, 2 half + e) of box b holds row 16 w + g +
      // 8 half, column 128 b + 8 j + 2 t + e of the warpgroup's 64-row tile
      consumers_sync();  // the previous tile's epilogue has read the scales
      if (wg == 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b) sws[128 * b + c] = wsc[b];
      }
      if (c < BM / 2) sxs[64 * wg + c] = xsc;
      consumers_sync();
      if (!GROUPED && out_f32) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * w + g + 8 * half, row = m0 + 64 * wg + r;
          if (row >= M) continue;
          const float xr = sxs[64 * wg + r];
#pragma unroll
          for (int b = 0; b < NB; ++b) {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int cl = 128 * b + 8 * j + 2 * t, col = n0 + cl;
              if (col >= N) continue;
              const float2 s2 = *reinterpret_cast<const float2*>(sws + cl);
              *reinterpret_cast<float2*>(out_f32 + (long long)row * ldo + col) = make_float2(
                  __fmul_rn(__fmul_rn(__int2float_rn((int)acc[b][j][2 * half]), xr), s2.x),
                  __fmul_rn(__fmul_rn(__int2float_rn((int)acc[b][j][2 * half + 1]), xr), s2.y));
            }
          }
        }
        continue;
      }
      // bf16: each box of 128 columns through the warpgroup's staging
      // buffer, two 64 x 64 swizzled boxes that one thread stores by TMA
      // (rows past M and columns past N are not written); the store runs on
      // while the next box is converted and the next tile is multiplied
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b >= live) break;
        if (c == 0) bulk_wait_read();  // the previous box's store has read the buffer
        wg_sync(wg);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * w + g + 8 * half;
          const float xr = sxs[64 * wg + r];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int cl = 8 * j + 2 * t;
            const float2 s2 = *reinterpret_cast<const float2*>(sws + 128 * b + cl);
            const float v0 =
                __fmul_rn(__fmul_rn(__int2float_rn((int)acc[b][j][2 * half]), xr), s2.x);
            const float v1 =
                __fmul_rn(__fmul_rn(__int2float_rn((int)acc[b][j][2 * half + 1]), xr), s2.y);
            // 16-byte chunk j % 8 of row r of output box j / 8, at chunk
            // (j % 8) ^ (r % 8): the 128-byte swizzle (r % 8 == g)
            *reinterpret_cast<uint32_t*>(stage_out + (j >> 3) * OUT_BOX + r * 128 +
                                         (((j & 7) ^ g) << 4) + 4 * t) = wonly::pack_bf16(v0, v1);
          }
        }
        attn::fence_proxy_async();  // the writes, to the TMA unit
        wg_sync(wg);
        if (c == 0) {
          tma_store_2d(&tmap_o, stage_out, n0 + 128 * b, m0 + 64 * wg);
          tma_store_2d(&tmap_o, stage_out + OUT_BOX, n0 + 128 * b + 64, m0 + 64 * wg);
          bulk_commit();
        }
      }
    }
    if (c == 0) bulk_wait();
  }
}

template <int NB>
__global__ void __launch_bounds__(THREADS, 1) s8gemm_kernel(
    const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ CUtensorMap tmap_w,
    const __grid_constant__ CUtensorMap tmap_o, const float* __restrict__ xs,
    const float* __restrict__ ws, float* __restrict__ out_f32, int M, int K, int N,
    long long ldo) {
  s8gemm_body<NB, false>(tmap_x, tmap_w, tmap_o, xs, ws, out_f32, M, K, N, ldo, nullptr,
                         nullptr);
}

// 4. moe_w8a8_kernel<NB>: the experts' grouped GEMM of DeepSeekMoE's prefill
//    (ops/moe.py grouped_w8a8), one launch per matrix per layer. The
//    dispatch sorts the routed rows by expert, each expert's block starting
//    at a multiple of 128, so a row tile never straddles two experts; the
//    persistent grid walks (row tile, column tile) over the *n_mtiles row
//    tiles in use (read on the device: no host sync), each tile's weight
//    boxes those of its expert from the K-major [E, N, K] copy held at load,
//    the epilogue its scales. Bound: the operations, 2 x routed rows x K x N
//    at 1979 TOP/s (0.70 ms for DeepSeek-V2-Lite's gate/up product at
//    120 576 routed rows), each expert's weights read once.
template <int NB>
__global__ void __launch_bounds__(THREADS, 1) moe_w8a8_kernel(
    const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ CUtensorMap tmap_w,
    const __grid_constant__ CUtensorMap tmap_o, const float* __restrict__ xs,
    const float* __restrict__ ws, const int* __restrict__ tile_expert,
    const int* __restrict__ n_mtiles, int M, int K, int N) {
  s8gemm_body<NB, true>(tmap_x, tmap_w, tmap_o, xs, ws, nullptr, M, K, N, N, tile_expert,
                        n_mtiles);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <int NB>
cudaError_t launch_gemm(const CUtensorMap& tmap_x, const CUtensorMap& tmap_w,
                        const CUtensorMap& tmap_o, const void* xs, const void* ws, void* out,
                        int M, int K, int N, long long ldo, int out_f32, int sms,
                        cudaStream_t st) {
  using T = Tile<NB>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        s8gemm_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int tiles = ((M + BM - 1) / BM) * ((N + T::BN - 1) / T::BN);
  s8gemm_kernel<NB><<<tiles < sms ? tiles : sms, THREADS, T::SMEM, st>>>(
      tmap_x, tmap_w, tmap_o, static_cast<const float*>(xs), static_cast<const float*>(ws),
      out_f32 ? static_cast<float*>(out) : nullptr, M, K, N, ldo);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_moe(const CUtensorMap& tmap_x, const CUtensorMap& tmap_w,
                       const CUtensorMap& tmap_o, const void* xs, const void* ws,
                       const void* tile_expert, const void* n_mtiles, int M, int K, int N,
                       int sms, cudaStream_t st) {
  using T = Tile<NB>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_w8a8_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int tiles = (M / BM) * ((N + T::BN - 1) / T::BN);  // at most; the kernel reads the count
  moe_w8a8_kernel<NB><<<tiles < sms ? tiles : sms, THREADS, T::SMEM, st>>>(
      tmap_x, tmap_w, tmap_o, static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<const int*>(tile_expert), static_cast<const int*>(n_mtiles), M, K, N);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16 -> q [M, K] int8, s [M] f32 (the row's absmax x fl(1 / 127),
// 1 where it is 0). Requires M >= 1, K % 8 == 0, K <= 16384, 16-byte aligned
// x and 8-byte aligned q.
extern "C" int quantize_rows(const void* x, void* q, void* s, int M, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nvec = K / 8;
  if (M < 1 || K < 8 || K % 8 || nvec > QTHREADS * 8) return (int)cudaErrorInvalidValue;
  if (nvec <= 16) return (int)launch_quantize<16, 1>(x, q, s, M, K, st);
  if (nvec <= 32) return (int)launch_quantize<32, 1>(x, q, s, M, K, st);
  switch ((nvec + QTHREADS - 1) / QTHREADS) {
    case 1: return (int)launch_quantize<QTHREADS, 1>(x, q, s, M, K, st);
    case 2: return (int)launch_quantize<QTHREADS, 2>(x, q, s, M, K, st);
    case 3: return (int)launch_quantize<QTHREADS, 3>(x, q, s, M, K, st);
    case 4: return (int)launch_quantize<QTHREADS, 4>(x, q, s, M, K, st);
    case 5: return (int)launch_quantize<QTHREADS, 5>(x, q, s, M, K, st);
    case 6: return (int)launch_quantize<QTHREADS, 6>(x, q, s, M, K, st);
    case 7: return (int)launch_quantize<QTHREADS, 7>(x, q, s, M, K, st);
    default: return (int)launch_quantize<QTHREADS, 8>(x, q, s, M, K, st);
  }
}

// xq [M, K] int8, xs [M] f32, w [K, N] int8 row-major, ws [N] f32; scratch
// wt [N, K] int8 (the K-major weight); out [M, N] with row stride ldo
// elements, bf16 (out_f32 0) or f32 (1): out = ((float)(xq @ w) * xs) * ws.
// Requires M >= 1, K % 16 == 0, N % 16 == 0, 16-byte aligned int8 pointers,
// ldo >= N, and for bf16 a 16-byte aligned out and ldo % 8 == 0, for f32 an
// 8-byte aligned out and an even ldo; nb (1 or 2) is the tile's width in 128
// columns. Two launches: the transpose, the GEMM.
extern "C" int w8a8_gemm(const void* xq, const void* xs, const void* w, const void* ws, void* wt,
                         void* out, int M, int K, int N, long long ldo, int out_f32, int nb,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  CUtensorMap tmap_x, tmap_w, tmap_o = {};
  if (sms <= 0 || M < 1 || K % 16 || N % 16 || (nb != 1 && nb != 2) || ldo < N ||
      (!out_f32 && ldo % 8) ||
      !wonly::encode(&tmap_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, K, M, K, BK, BM) ||
      !wonly::encode(&tmap_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wt, K, N, K, BK, 128) ||
      (!out_f32 && !wonly::encode(&tmap_o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, N, M,
                                  (uint64_t)ldo * 2, 64, 64)))
    return (int)cudaErrorInvalidValue;
  kmajor_transpose_kernel<<<dim3((N + TT - 1) / TT, (K + TT - 1) / TT), TTHREADS, 0, st>>>(
      static_cast<const int8_t*>(w), static_cast<int8_t*>(wt), K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = nb == 2
            ? launch_gemm<2>(tmap_x, tmap_w, tmap_o, xs, ws, out, M, K, N, ldo, out_f32, sms, st)
            : launch_gemm<1>(tmap_x, tmap_w, tmap_o, xs, ws, out, M, K, N, ldo, out_f32, sms, st);
  return (int)err;
}

// The experts' grouped GEMM: xq [M, K] int8 and xs [M] f32 (M a multiple of
// 128: the dispatch's capacity), wt [E, N, K] int8 (each expert's weights
// K-major), ws [E, N] f32, tile_expert [M / 128] int32 (row tile i's
// expert), n_mtiles [1] int32 (the row tiles in use), out [M, N] bf16: the
// rows of tile i get ((float)(xq @ wt[e]^T) * xs) * ws[e]; rows of unused
// tiles are not written. Requires K % 16 == 0, N % 16 == 0, 16-byte aligned
// int8 pointers and out; nb as w8a8_gemm's. One launch.
extern "C" int moe_w8a8_gemm(const void* xq, const void* xs, const void* wt, const void* ws,
                             const void* tile_expert, const void* n_mtiles, void* out, int M,
                             int K, int N, int E, int nb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  CUtensorMap tmap_x, tmap_w, tmap_o;
  if (sms <= 0 || M < BM || M % BM || K % 16 || N % 16 || E < 1 || (nb != 1 && nb != 2) ||
      !wonly::encode(&tmap_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, K, M, K, BK, BM) ||
      !wonly::encode(&tmap_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wt, K, (uint64_t)E * N, K, BK,
                     128) ||
      !wonly::encode(&tmap_o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, N, M, (uint64_t)N * 2, 64,
                     64))
    return (int)cudaErrorInvalidValue;
  return (int)(nb == 2 ? launch_moe<2>(tmap_x, tmap_w, tmap_o, xs, ws, tile_expert, n_mtiles,
                                       M, K, N, sms, st)
                       : launch_moe<1>(tmap_x, tmap_w, tmap_o, xs, ws, tile_expert, n_mtiles,
                                       M, K, N, sms, st));
}

// the dynamic shared memory of the GEMM at tile width `which` (1 or 2), or of
// the quantizer and the transpose (0: none), for the ptxas report
extern "C" int w8a8_gemm_smem_bytes(int which) {
  return which == 2 ? (int)Tile<2>::SMEM : which == 1 ? (int)Tile<1>::SMEM : 0;
}
