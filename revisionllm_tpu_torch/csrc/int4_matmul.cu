// Row 7: W4A16 matmul, out[M, N] = x[M, K] @ bf16(q4[K, N] * scale[K / 128, N]).
//
// Replaces the Pallas kernel revisionllm_tpu/ops/quant.py:580 _q4_matmul_kernel
// (entry int4_matmul :615, pallas_call :658), which q4_apply sends every matmul
// with M <= 256 of an int4 tree: on the stage-1 path, each decode-step
// projection at M = B = 64 and the lm_head.
//
// What bounds it on the H100: the packed weight bytes. One decode step's 225
// launches at M = 64 (32 layers x q/k/v/o, gate/up and down, and the lm_head)
// read 3.30 GB of nibbles and 0.21 GB of group scales, and move 0.32 GB of
// x and outputs: 1.145 ms at 3.35 TB/s, while their 0.85 TFLOP take 0.86 ms
// on the bf16 tensor cores at the data sheet's peak, and widening the 6.6 G
// nibbles exactly (f32 product, one rounding) takes about 0.9 ms of issue
// slots. All three have to overlap.
//
// The design, by what held the split-K/WMMA kernel it replaces at 33.8 us
// for a 4096 x 4096 matrix (2.66 us of bytes):
//   1. One launch and no workspace. A block (one warpgroup) owns 128 output
//      columns of up to 64 rows and one range of whole K tiles of 128 rows
//      (one scale group each). The S <= 8 K splits of a column tile are one
//      thread-block cluster (cudaLaunchKernelEx, cluster dimension S along
//      the grid's y axis); each rank leaves its f32 partial tile in its own
//      shared memory and the ranks sum it over distributed shared memory in
//      rank order (csrc/wonly_matmul_common.cuh, cluster_sum_store). With S
//      = 1 the accumulators go straight to the output. No f32 partial
//      reaches device memory and no finalize kernel runs. The plan
//      (ops/quant.py, q4_plan) picks S per shape from the resident clusters;
//      the ranks' ranges differ by at most one tile.
//   2. The nibbles are widened in registers straight into the tensor cores'
//      A operand. The product is computed transposed, out^T = W^T x^T, with
//      wgmma.m64n64k16 (A from registers, B from shared memory): its A rows
//      are output columns, so byte (i, n) of q4, which holds k = 2i (low
//      nibble) and 2i + 1 (high) of column n, is one bf16x2 A register. Each
//      nibble is offset by 8 (xor), placed into the mantissa of 2^23 (prmt)
//      and made a signed f32 by one subtract, multiplied by its group's f32
//      scale and rounded once to bf16, as the Pallas body rounds q * scale
//      to x's type before its dot (quant.py:603-607). No widened tile goes
//      to shared memory.
//   3. x is read by the tensor cores, not by the threads: the x tile (64
//      rows x 128 k, 128-byte swizzled) is wgmma's B operand through a
//      descriptor, so no warp reloads x fragments, and each k16 step of x
//      feeds the block's two wgmmas (128 columns).
//   4. The x tile is twice the packed weight tile (16 KB against 8 KB a
//      stage): a block of 128 columns keeps three blocks an SM, which the
//      timings favour over 256-column blocks that would halve the x reads
//      from L2 (scripts/torch_int4_probe.py: x's copies cost little).
//   5. Latency is covered by blocks rather than by a deep ring: a 2-stage
//      cp.async ring (16-byte .cg copies) of 27 KB stages, 56 KB a block,
//      three blocks (12 warps) an SM, so about 80 KB in flight an SM; the
//      launch is a programmatic dependent launch, so the first stage's
//      weights are asked for while the previous kernel drains, and x (its
//      output) after griddepcontrol.wait.
// A 32-bit word of a packed row is 4 neighbouring columns; lane (g, t) of
// warp w reads the word of columns c0 = 32 w + 4 g of packed rows 8 kk + t
// (k 2t) and 8 kk + t + 4 (k 2t + 8), and its byte j feeds wgmma j & 1, A
// row 16 w + g + 8 (j >> 1): a fixed permutation of the block's columns
// that the epilogue undoes. Packed rows are padded to 160 B, so the quad's 4
// rows (t = 0..3) fall on banks 8 t apart and a warp's 32 word reads are
// conflict-free. The k16 steps go to the tensor cores in groups of KG, the
// next group widened while the last one runs.
//
// M above 64: the grid's z axis walks 64-row tiles of x (M <= 256 a launch,
// the wrapper's bound); each re-reads the weights, mostly from L2. Only
// REVISIONLLM_Q4_PALLAS=all sends more than 64 rows here (the prefill, off
// the main path), where a 256-row launch reads the weight bytes up to four
// times. Below 64 rows the rows past M are zeros the tensor cores multiply.
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/quant.py,
// which mirrors the shared-memory size below (q4_smem_bytes) and asks
// q4_matmul_max_clusters for the plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "wonly_matmul_common.cuh"

namespace {

using wonly::bf16;

constexpr int GROUP = 128;     // K rows per scale row
constexpr int BK = 128;        // K rows of a tile (a ring stage): one group
constexpr int BN = 128;        // output columns of a block: two wgmmas of 64
constexpr int MP = 64;         // x rows of a block: wgmma's n
constexpr int KG = 4;          // k16 steps widened between two wgmma commits
constexpr int STAGES = 2;
constexpr int THREADS = 128;   // one warpgroup
constexpr int MINB = 3;        // blocks an SM the registers are sized for
constexpr int PDL = 1;         // a programmatic dependent launch (see config)
constexpr int WS = BN + 32;    // byte row stride of a packed W stage
constexpr int RS = BN + 4;     // f32 row stride of the partial tile
constexpr size_t X_BYTES = (size_t)MP * BK * 2;     // one x stage, 128-byte swizzled
constexpr size_t W_BYTES = (size_t)(BK / 2) * WS;   // one packed W stage
constexpr size_t S_BYTES = (size_t)BN * 4;          // one scale row
constexpr size_t STAGE = (X_BYTES + W_BYTES + S_BYTES + 1023) / 1024 * 1024;
constexpr size_t RED = (size_t)MP * RS * 4;         // the partial tile
constexpr size_t SMEM = (STAGES * STAGE > RED ? STAGES * STAGE : RED) + 1024;

static_assert(BK == GROUP, "one scale row a tile");
static_assert(attn::THREADS == THREADS && attn::TILE == MP && attn::D == BK,
              "x stages are attention_common's swizzled [64, 128] tiles");
static_assert(BK / 16 % KG == 0, "whole wgmma groups a tile");

// nibble byte j of `v` (already offset to [0, 15]) as a float, minus 8
template <int J>
__device__ __forceinline__ float nib(uint32_t v) {
  return __uint_as_float(__byte_perm(v, 0x4B00u, 0x5440u | J)) - 8388616.0f;
}

// the 8 nibbles of a packed word (byte j: column j of 4; k rows 2i, 2i + 1)
// widened with the columns' scales and rounded to bf16x2: byte j into
// register R + (j >> 1) of wgmma j & 1's A fragment (R = 0: k 2t, R = 2:
// k 2t + 8; + 1: the row 8 below)
template <int R>
__device__ __forceinline__ void widen(uint32_t (&a)[2][4], uint32_t word, const float4& s) {
  const uint32_t u = word ^ 0x88888888u;
  const uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
  a[0][R] = wonly::pack_bf16(nib<0>(lo) * s.x, nib<0>(hi) * s.x);
  a[1][R] = wonly::pack_bf16(nib<1>(lo) * s.y, nib<1>(hi) * s.y);
  a[0][R + 1] = wonly::pack_bf16(nib<2>(lo) * s.z, nib<2>(hi) * s.z);
  a[1][R + 1] = wonly::pack_bf16(nib<3>(lo) * s.w, nib<3>(hi) * s.w);
}

__global__ void __launch_bounds__(THREADS, MINB)
    q4_matmul_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                     const float* __restrict__ scale, bf16* __restrict__ out, int M, int K,
                     int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = attn::align1024(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.z * MP;
  const int rows = min(MP, M - m0);
  const bf16* xb = x + (size_t)m0 * K;

  // this rank's whole tiles: ranks differ by at most one
  const int k_tiles = K / BK, S = gridDim.y, r = blockIdx.y;
  const int base = k_tiles / S, rem = k_tiles % S;
  const int nk = base + (r < rem);
  const int t0 = r * base + min(r, rem);

  auto stage = [&](int slot) { return smem + (size_t)slot * STAGE; };
  auto issue_x = [&](int slot, int i) {
    attn::load_tile_sw128(stage(slot), xb + (t0 + i) * BK, K, rows);
  };
  // the packed weights and the tile's scale row; columns past N are zeros
  auto issue_w = [&](int slot, int i) {
    uint8_t* wdst = stage(slot) + X_BYTES;
    const int k0 = (t0 + i) * BK;
#pragma unroll
    for (int j = 0; j < (BK / 2) * (BN / 16) / THREADS; ++j) {
      const int c = tid + j * THREADS;
      const int rr = c / (BN / 16), col = (c % (BN / 16)) * 16;
      const bool ok = n0 + col < N;
      wonly::cp_async16(wdst + rr * WS + col, ok ? w + (size_t)(k0 / 2 + rr) * N + n0 + col : w,
                        ok);
    }
    if (tid < BN / 4) {
      const int col = tid * 4;
      const bool ok = n0 + col < N;
      wonly::cp_async16(wdst + W_BYTES + col * 4,
                        ok ? scale + (size_t)(k0 / GROUP) * N + n0 + col : scale, ok);
    }
  };

  // acc[jj]: wgmma jj's 64 x 64 f32 tile (its rows output columns, its
  // columns x rows); warp w holds rows 16 w .. 16 w + 15
  float acc[2][8][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.0f;

  // the first stages' weights do not depend on the previous kernel in the
  // stream: they are asked for before waiting for it (x is its output)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < nk) issue_w(s, s);
  if (PDL) asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue_x(s, s);
    wonly::cp_async_commit();
  }

  // this lane's word of a packed row: columns c0 .. c0 + 3, byte j the A
  // row 16 warp + g + 8 (j >> 1) of wgmma j & 1
  const int c0 = 32 * warp + 4 * g;
  uint32_t a[2][KG][2][4];
  for (int i = 0; i < nk; ++i) {
    wonly::cp_async_wait<STAGES - 2>();  // this thread's copies of tile i landed
    attn::fence_proxy_async();           // ... and are visible to the tensor cores
    __syncthreads();                     // everyone's, and tile i - 1 is consumed
    {
      const int in = i + STAGES - 1;
      if (in < nk) {
        issue_x(in % STAGES, in);
        issue_w(in % STAGES, in);
      }
      wonly::cp_async_commit();
    }
    const unsigned char* st = stage(i % STAGES);
    const uint8_t* wt = st + X_BYTES + c0;
    const float4 sc = *reinterpret_cast<const float4*>(st + X_BYTES + W_BYTES + c0 * 4);
#pragma unroll
    for (int q = 0; q < BK / 16 / KG; ++q) {
      const int b = q & 1;
#pragma unroll
      for (int e = 0; e < KG; ++e) {
        const uint8_t* r0 = wt + (8 * (q * KG + e) + t) * WS;
        widen<0>(a[b][e], *reinterpret_cast<const uint32_t*>(r0), sc);           // k 2t
        widen<2>(a[b][e], *reinterpret_cast<const uint32_t*>(r0 + 4 * WS), sc);  // k 2t + 8
      }
      attn::wgmma_fence();
#pragma unroll
      for (int e = 0; e < KG; ++e)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          attn::wgmma_m64n64k16(acc[j], a[b][e][j], attn::k_major(st, q * KG + e), 1);
      attn::wgmma_commit();
      wonly::wgmma_wait<1>();  // group q - 1 is done: its A registers may be rewritten
#pragma unroll
      for (int e = 0; e < KG; ++e) attn::pin(a[b ^ 1][e]);
    }
    attn::wgmma_wait0();       // the tile's x stage may be refilled
#pragma unroll
    for (int e = 0; e < KG; ++e) {
      attn::pin(a[0][e]);
      attn::pin(a[1][e]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) attn::pin(acc[j]);
  wonly::cp_async_wait<0>();

  // wgmma jj's row 16 warp + g + 8 h is column c0 + 2 h + jj
  if (S == 1) {  // no split: columns c0 + 2 h and c0 + 2 h + 1 are one bf16x2
    if (n0 + c0 < N) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 8 * n + 2 * t + (e & 1);
          if (m < rows)
            *reinterpret_cast<uint32_t*>(out + (size_t)(m0 + m) * N + n0 + c0 + 2 * (e >> 1)) =
                wonly::pack_bf16(acc[0][n][e], acc[1][n][e]);
        }
    }
    return;
  }
  __syncthreads();  // the ring is free: the partial tile takes its place
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float* p = part + (8 * n + 2 * t) * RS + c0 + j;
      p[0] = acc[j][n][0];
      p[RS] = acc[j][n][1];
      p[2] = acc[j][n][2];
      p[RS + 2] = acc[j][n][3];
    }
  wonly::cluster_sum_store<MP, BN, RS, THREADS>(part, out + (size_t)m0 * N, rows, N, n0);
}

cudaError_t config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int M, int N, int splitk,
                   cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        q4_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((N + BN - 1) / BN, splitk, (M + MP - 1) / MP);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splitk;
  attr[0].val.clusterDim.z = 1;
  // programmatic dependent launch: the blocks may start while the previous
  // kernel in the stream drains; they wait for it (griddepcontrol.wait)
  // before reading x, and write nothing before that
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = PDL ? 2 : 1;
  return cudaSuccess;
}

}  // namespace

// x [M, K] bf16, w [K/2, N] uint8, scale [K/128, N] f32, out [M, N] bf16.
// Requires 1 <= M <= 256, K % 128 == 0, N % 16 == 0, splitk in {1, 2, 4,
// 8}, 16-byte aligned x, w, scale and out. One launch: grid (N / 128
// rounded up, splitk, M / 64 rounded up), clusters of splitk along y.
extern "C" int q4_matmul_bf16(const void* x, const void* w, const void* scale, void* out, int M,
                              int K, int N, int splitk, void* stream) {
  if (splitk != 1 && splitk != 2 && splitk != 4 && splitk != 8) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = config(cfg, attr, M, N, splitk, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, q4_matmul_kernel, static_cast<const bf16*>(x),
                           static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
                           static_cast<bf16*>(out), M, K, N);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the dynamic shared memory of one block (ops/quant.py mirrors it)
extern "C" int q4_matmul_smem_bytes() { return (int)SMEM; }

// how many clusters of splitk blocks can be resident at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error
extern "C" int q4_matmul_max_clusters(int splitk) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  if (config(cfg, attr, MP, BN * 16, splitk, nullptr) != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, q4_matmul_kernel, &cfg) != cudaSuccess) return -1;
  return n;
}
