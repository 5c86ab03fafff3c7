// K1: W8A16 matmul, out[M, N] = bf16((x[M, K] @ q8[K, N]) * scale[N]).
//
// Replaces the Pallas kernel revisionllm_tpu/ops/quant.py:46 _q8_matmul_kernel
// (entry int8_matmul :78, pallas_call :117), which q8_apply sends every matmul
// with M <= 256: on the stage-1 path, each decode-step projection at M = B = 64
// and the lm_head.
//
// What bounds it on the H100: the int8 weight bytes. One decode step's 225
// launches at M = 64 (32 layers x q/k/v/o, gate/up and down, and the lm_head)
// read 6.6 GB of weights and move 0.32 GB of x and outputs: 2.07 ms at
// 3.35 TB/s, while their 0.85 TFLOP take 0.86 ms on the bf16 tensor cores at
// the data sheet's peak, and widening the 6.6 G bytes to bf16 takes about
// 0.5 ms of issue slots. All three have to overlap, and with 4-11 tiles a
// block there is little time to fill a pipeline.
//
// The design (row 7's, csrc/int4_matmul.cu, carried over to int8, with a
// producer warp):
//   1. One launch and no workspace. A block owns 128 output columns of up to
//      64 rows and one range of whole K tiles of 128 rows. The S <= 8 K
//      splits of a column tile are one thread-block cluster along the grid's
//      y axis (cudaLaunchKernelEx); each rank leaves its f32 partial tile in
//      its own shared memory and the ranks sum it over distributed shared
//      memory in rank order, then scale each column and round once to bf16
//      (sum_store). With S = 1 the accumulators are scaled and stored
//      directly. The plan (ops/quant.py, q8_plan) picks S per shape from the
//      resident clusters.
//   2. The product is computed transposed, out^T = W^T x^T, with
//      wgmma.m64n64k16: A (output columns x k) from registers, x the
//      128-byte-swizzled shared-memory B operand through a descriptor, so
//      no thread loads x fragments.
//   3. The int8 weights are widened in registers straight into the A
//      registers. A bf16x2 A register holds k 2t and 2t + 1 of one column:
//      two rows of the row-major tile. Lane (g, t) of warp w reads the words
//      of columns c0 = 32 w + 4 g .. c0 + 3 in rows 2t, 2t + 1, 2t + 8 and
//      2t + 9 of a k16 step; byte j of the pair (row 2t, row 2t + 1) goes to
//      wgmma j & 1, A row 16 w + g + 8 (j >> 1): a fixed permutation of the
//      block's columns that the epilogue undoes. A prmt puts the two bytes
//      at bits 0-7 and 16-23; for a byte b, bf16 0x4300 | (b & 127) is 128 +
//      (b & 127) and 0xC300 | (b & 128) is -128 or -256 by its sign, so one
//      bf16x2 add of the two makes b exactly (4 instructions a register, no
//      conversion; wonly::s8x2 and wonly::widen, which rows 9 and 10 share).
//      The scale is applied once, after the whole K sum, as the Pallas body
//      does at ik == num_k_blocks - 1.
//   4. A producer warp runs the ring ahead: one lane issues TMA tile copies
//      (CUtensorMaps built on the host: x [M, K] bf16 in two 64 x 64 boxes,
//      W [K, N] int8 in one 128 x 128 box marked evict-first in L2, both
//      128-byte swizzled; elements outside the tensors arrive as zeros, which
//      covers the K tail, the N edge and the rows past M) into a ring of
//      STAGES stages, each with a full and an empty mbarrier. The consumer
//      warpgroup only waits for a stage's full barrier, widens and issues
//      wgmma, and releases the stage: no __syncthreads or cp.async wait is in
//      its loop. Row 7's frame (every thread copies the next stage, then
//      waits for its copies and a block barrier once a tile) was 14% slower
//      here (scripts/torch_int8_kernel.py).
//   5. The weights' 128-byte swizzle (16-byte chunk c of row r at chunk
//      c ^ (r % 8)) puts a warp's 32 word reads of one row pair on 32
//      distinct banks: rows 2t (t = 0..3) shift the chunk by 2t, so the 8
//      chunks the warp reads are distinct. No padding is needed.
//   6. Latency is covered by blocks rather than by a deep ring: 2 stages of
//      32 KB, three blocks (15 warps) an SM; deeper rings at one or two
//      blocks an SM were slower. The launch is a programmatic dependent
//      launch: the first stages' weights are asked for while the previous
//      kernel drains, and x (its output) after griddepcontrol.wait.

// M above 64: the grid's z axis walks 64-row tiles of x (M <= 256 a launch,
// the wrapper's bound); each re-reads the weights, mostly from L2. Below 64
// rows the rows past M are zeros the tensor cores multiply.
//
// moe_w8a16_kernel, DeepSeekMoE's grouped decode product, is K1's body with
// its block's expert and rows taken from the dispatch's starts (see its
// definition); the dense kernel's path does not change.
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/quant.py
// (q8_matmul_bf16) and ops/moe.py (moe_w8a16), which mirror the
// shared-memory size below (q8_smem_bytes) and ask q8_matmul_max_clusters
// for the plan.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "wonly_matmul_common.cuh"

namespace {

using wonly::bf16;

constexpr int BK = 128;        // K rows of a tile (a ring stage)
constexpr int BN = 128;        // output columns of a block: two wgmmas of 64
constexpr int MP = 64;         // x rows of a block: wgmma's n
constexpr int KG = 2;          // k16 steps widened between two wgmma commits
constexpr int STAGES = 2;
constexpr int MINB = 3;        // blocks an SM the registers are sized for
constexpr int PDL = 1;         // a programmatic dependent launch (see config)
constexpr int CONSUMERS = 128; // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int RS = BN + 4;     // f32 row stride of the partial tile
constexpr size_t X_BYTES = (size_t)MP * BK * 2;  // one x stage: two swizzled 8 KB halves
constexpr size_t W_BYTES = (size_t)BK * BN;      // one swizzled int8 W stage
constexpr size_t STAGE = X_BYTES + W_BYTES;      // a multiple of 1024
constexpr size_t RED = (size_t)MP * RS * 4;      // the partial tile
constexpr size_t BAR = STAGES * STAGE > RED ? STAGES * STAGE : RED;
constexpr size_t SMEM = BAR + 2 * STAGES * 8 + 1024;

static_assert(attn::THREADS == CONSUMERS && attn::TILE == MP && attn::D == BK,
              "x stages are attention_common's swizzled [64, 128] tiles");
static_assert(BK / 16 % KG == 0, "whole wgmma groups a tile");
static_assert(STAGE % 1024 == 0, "swizzled tiles sit on 1024-byte boundaries");

__device__ __forceinline__ void griddep_wait() {
  if (PDL) asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The split-K sum over the block's cluster of S ranks along K (its rank r =
// blockIdx.y): `part` is this rank's f32 partial tile [MP][RS]. Rank r takes
// float4s [r Q / S, (r + 1) Q / S) of the Q = MP * BN / 4 float4s of the
// tile, adds them over ranks 0..S-1 in that order, scales each column and
// stores rows < rows and columns < N of out [.., N] as bf16. A thread
// issues all its distributed-shared-memory loads (at most Q / THREADS
// float4s, rounded up to whole rounds) before its first add, so the sum
// waits for one round trip instead of one a float4.
template <int S>
__device__ __forceinline__ void sum_store(float* part, bf16* out, const float* scale, int rows,
                                          int N, int n0) {
  constexpr int PER = MP * BN / 4 / S;
  constexpr int ITER = (PER + THREADS - 1) / THREADS;
  const int r = blockIdx.y, tid = threadIdx.x;
  uint32_t src[S];
#pragma unroll
  for (int p = 0; p < S; ++p) src[p] = wonly::cluster_addr(part, p);
  float4 sc[ITER];  // the columns' scales, asked for before the barrier
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int col = ((r * PER + tid + i * THREADS) % (BN / 4)) * 4;
    if (tid + i * THREADS < PER && n0 + col < N)
      sc[i] = make_float4(scale[n0 + col], scale[n0 + col + 1], scale[n0 + col + 2],
                          scale[n0 + col + 3]);
  }
  wonly::cluster_sync();  // every rank's partial tile is written
  float4 v[ITER][S];
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int q = r * PER + tid + i * THREADS;
    const uint32_t off = (uint32_t)((q / (BN / 4)) * RS + (q % (BN / 4)) * 4) * 4;
    if (tid + i * THREADS < PER) {
#pragma unroll
      for (int p = 0; p < S; ++p) v[i][p] = wonly::ld_cluster_f4(src[p] + off);
    }
  }
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int q = r * PER + tid + i * THREADS;
    const int row = q / (BN / 4), col = (q % (BN / 4)) * 4;
    if (tid + i * THREADS < PER && row < rows && n0 + col < N) {
      float4 s = v[i][0];
#pragma unroll
      for (int p = 1; p < S; ++p) {
        s.x += v[i][p].x;
        s.y += v[i][p].y;
        s.z += v[i][p].z;
        s.w += v[i][p].w;
      }
      uint2 o;
      o.x = wonly::pack_bf16(s.x * sc[i].x, s.y * sc[i].y);
      o.y = wonly::pack_bf16(s.z * sc[i].z, s.w * sc[i].w);
      *reinterpret_cast<uint2*>(out + (size_t)row * N + n0 + col) = o;
    }
  }
  wonly::cluster_sync();  // no rank leaves while another still reads its tile
}

// The block's work; GROUPED (moe_w8a16_kernel): the grid's z axis is
// (expert e, 64-row tile j) with m_tiles tiles an expert, the block's rows
// those of e from starts[e] + 64 j (none: it returns at once), its weights
// rows e K .. e K + K - 1 of tmap_w ([E K, N]) and its scales scale + e N;
// the rest is the dense kernel's path
template <bool GROUPED>
__device__ __forceinline__ void q8_matmul_body(const CUtensorMap& tmap_x,
                                               const CUtensorMap& tmap_w,
                                               const float* __restrict__ scale,
                                               bf16* __restrict__ out, int M, int K, int N,
                                               const int* __restrict__ starts, int m_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = attn::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  int m0 = blockIdx.z * MP, rows = min(MP, M - m0), w_row = 0;
  if (GROUPED) {
    // the dispatch wrote the starts: wait for it before reading them
    griddep_wait();
    const int e = blockIdx.z / m_tiles, j = blockIdx.z % m_tiles;
    const int s0 = starts[e];
    m0 = s0 + j * MP;
    rows = min(MP, starts[e + 1] - m0);
    if (rows <= 0) return;  // every rank of the cluster alike
    w_row = e * K;
    scale += (size_t)e * N;
  }

  // this rank's whole tiles (the last may run past K): ranks differ by at
  // most one
  const int k_tiles = (K + BK - 1) / BK, S = gridDim.y, r = blockIdx.y;
  const int base = k_tiles / S, rem = k_tiles % S;
  const int nk = base + (r < rem);
  const int t0 = r * base + min(r, rem);
  auto stage = [&](int slot) { return smem + (size_t)slot * STAGE; };

  // acc[jj]: wgmma jj's 64 x 64 f32 tile (its rows output columns, its
  // columns x rows); warp w holds rows 16 w .. 16 w + 15
  float acc[2][8][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.0f;

  // this lane's words in a swizzled W stage: columns c0 .. c0 + 3 of rows
  // 2t (and 2t + 8; off_e) and 2t + 1 (and 2t + 9; off_o) of k16 step 0
  const int c0 = 32 * warp + 4 * g;
  const int off_e = 2 * t * BN + (((c0 >> 4) ^ (2 * t)) << 4) + (c0 & 15);
  const int off_o = (2 * t + 1) * BN + (((c0 >> 4) ^ (2 * t + 1)) << 4) + (c0 & 15);
  uint32_t a[2][KG][2][4];
  auto consume = [&](const unsigned char* st) {
    const unsigned char* we = st + X_BYTES + off_e;
    const unsigned char* wo = st + X_BYTES + off_o;
#pragma unroll
    for (int q = 0; q < BK / 16 / KG; ++q) {
      const int b = q & 1;
#pragma unroll
      for (int e = 0; e < KG; ++e) {
        const int kk = q * KG + e;
        const uint32_t r0 = *reinterpret_cast<const uint32_t*>(we + kk * 16 * BN);
        const uint32_t r1 = *reinterpret_cast<const uint32_t*>(wo + kk * 16 * BN);
        const uint32_t r8 = *reinterpret_cast<const uint32_t*>(we + (kk * 16 + 8) * BN);
        const uint32_t r9 = *reinterpret_cast<const uint32_t*>(wo + (kk * 16 + 8) * BN);
        wonly::widen<0>(a[b][e], r0, r1);  // k 2t, 2t + 1
        wonly::widen<2>(a[b][e], r8, r9);  // k 2t + 8, 2t + 9
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
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      wonly::mbar_init(full + s, 1);
      wonly::mbar_init(empty + s, CONSUMERS / 32);
    }
    wonly::mbar_init_fence();
  }
  __syncthreads();
  if (warp == CONSUMERS / 32) {
    // the producer: lane 0 fills the ring, STAGES tiles ahead of the
    // consumers; the weights of the first stages before the previous
    // kernel has finished, x (its output) after
    if (lane == 0) {
      // the weights are read once: first out of L2 (x and the outputs stay)
      uint64_t policy;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
      auto issue_w = [&](int slot, int i) {
        wonly::tma_load_2d_hint(stage(slot) + X_BYTES, &tmap_w, n0, w_row + (t0 + i) * BK,
                                full + slot, policy);
      };
      auto issue_x = [&](int slot, int i) {
        const int k0 = (t0 + i) * BK;
        wonly::tma_load_2d(stage(slot), &tmap_x, k0, m0, full + slot);
        wonly::tma_load_2d(stage(slot) + X_BYTES / 2, &tmap_x, k0 + BK / 2, m0, full + slot);
      };
      const int pre = min(nk, STAGES);
      for (int i = 0; i < pre; ++i) {
        wonly::mbar_arrive_expect(full + i, (uint32_t)STAGE);
        issue_w(i, i);
      }
      griddep_wait();
      for (int i = 0; i < pre; ++i) issue_x(i, i);
      for (int i = STAGES; i < nk; ++i) {
        const int slot = i % STAGES;
        wonly::mbar_wait(empty + slot, (i / STAGES - 1) & 1);
        wonly::mbar_arrive_expect(full + slot, (uint32_t)STAGE);
        issue_w(slot, i);
        issue_x(slot, i);
      }
    }
  } else {
    griddep_wait();
    for (int i = 0; i < nk; ++i) {
      const int slot = i % STAGES;
      wonly::mbar_wait(full + slot, (i / STAGES) & 1);
      consume(stage(slot));
      if (lane == 0) wonly::mbar_arrive(empty + slot);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) attn::pin(acc[j]);
  // with a split the next launch may start now: its blocks fill the SMs
  // this grid leaves free and ask for their first weights while the ranks
  // here sum (with S = 1, where the grid may fill every SM, that was slower)
  if (PDL && S > 1) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // wgmma jj's row 16 warp + g + 8 h is column c0 + 2 h + jj
  const bool consumer = tid < CONSUMERS;
  if (S == 1) {  // no split: columns c0 + 2 h and c0 + 2 h + 1 are one bf16x2
    if (consumer && n0 + c0 < N) {
      const float s0 = scale[n0 + c0], s1 = scale[n0 + c0 + 1];
      const float s2 = scale[n0 + c0 + 2], s3 = scale[n0 + c0 + 3];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 8 * n + 2 * t + (e & 1);
          const float lo = e >> 1 ? s2 : s0, hi = e >> 1 ? s3 : s1;
          if (m < rows)
            *reinterpret_cast<uint32_t*>(out + (size_t)(m0 + m) * N + n0 + c0 + 2 * (e >> 1)) =
                wonly::pack_bf16(acc[0][n][e] * lo, acc[1][n][e] * hi);
        }
    }
    return;
  }
  __syncthreads();  // the ring is free: the partial tile takes its place
  float* part = reinterpret_cast<float*>(smem);
  if (consumer) {
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
  }
  bf16* ob = out + (size_t)m0 * N;
  if (S == 2)
    sum_store<2>(part, ob, scale, rows, N, n0);
  else if (S == 4)
    sum_store<4>(part, ob, scale, rows, N, n0);
  else
    sum_store<8>(part, ob, scale, rows, N, n0);
}

__global__ void __launch_bounds__(THREADS, MINB)
    q8_matmul_kernel(const __grid_constant__ CUtensorMap tmap_x,
                     const __grid_constant__ CUtensorMap tmap_w, const float* __restrict__ scale,
                     bf16* __restrict__ out, int M, int K, int N) {
  q8_matmul_body<false>(tmap_x, tmap_w, scale, out, M, K, N, nullptr, 1);
}

// The experts' grouped W8A16 product of DeepSeekMoE's decode (ops/moe.py
// grouped_w8a16), one launch per matrix per layer: K1's block, its weight
// tile one expert's and its x rows those routed to that expert (the
// dispatch sorts them by expert; starts[E + 1]). Bound: the bytes, the
// int8 weights of each expert some row chose, once (all 64 of
// DeepSeek-V2-Lite's: 0.37 GB of gate/up and 0.18 GB of down a layer, 0.17
// ms at 3.35 TB/s), the activations and outputs beside them; blocks of an
// expert no row chose read nothing.
__global__ void __launch_bounds__(THREADS, MINB)
    moe_w8a16_kernel(const __grid_constant__ CUtensorMap tmap_x,
                     const __grid_constant__ CUtensorMap tmap_w, const float* __restrict__ scale,
                     bf16* __restrict__ out, int M, int K, int N, const int* __restrict__ starts,
                     int m_tiles) {
  q8_matmul_body<true>(tmap_x, tmap_w, scale, out, M, K, N, starts, m_tiles);
}

template <typename Kernel>
cudaError_t config(Kernel kernel, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int M,
                   int N, int splitk, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
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

// x [M, K] bf16, w [K, N] int8, scale [N] f32, out [M, N] bf16. Requires
// 1 <= M <= 256, K % 8 == 0, N % 16 == 0, splitk in {1, 2, 4, 8} and at
// most the 128-row tiles of K, 16-byte aligned x and w. One launch: grid
// (N / 128 rounded up, splitk, M / 64 rounded up), clusters of splitk along
// y.
extern "C" int q8_matmul_bf16(const void* x, const void* w, const void* scale, void* out, int M,
                              int K, int N, int splitk, void* stream) {
  if (splitk != 1 && splitk != 2 && splitk != 4 && splitk != 8) return (int)cudaErrorInvalidValue;
  CUtensorMap tmap_x, tmap_w;
  if (!wonly::encode(&tmap_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2, BK / 2,
                     MP) ||
      !wonly::encode(&tmap_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, N, BN, BK))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err =
      config(q8_matmul_kernel, cfg, attr, M, N, splitk, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, q8_matmul_kernel, tmap_x, tmap_w,
                           static_cast<const float*>(scale), static_cast<bf16*>(out), M, K, N);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the dynamic shared memory of one block (ops/quant.py mirrors it)
extern "C" int q8_matmul_smem_bytes() { return (int)SMEM; }

// how many clusters of splitk blocks can be resident at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error
extern "C" int q8_matmul_max_clusters(int splitk) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  if (config(q8_matmul_kernel, cfg, attr, MP, BN * 16, splitk, nullptr) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, q8_matmul_kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

// The experts' grouped product: x [R, K] bf16 (rows sorted by expert), w [E,
// K, N] int8, scale [E, N] f32, starts [E + 1] int32, out [R, N] bf16: rows
// starts[e] .. starts[e + 1] - 1 of out get x @ w[e] scaled by scale[e].
// m_tiles 64-row tiles an expert (its most rows, rounded up), splitk as
// q8_matmul_bf16's. One launch: grid (N / 128 rounded up, splitk, E x
// m_tiles), clusters of splitk along y.
extern "C" int moe_w8a16(const void* x, const void* w, const void* scale, const void* starts,
                         void* out, int R, int K, int N, int E, int m_tiles, int splitk,
                         void* stream) {
  if ((splitk != 1 && splitk != 2 && splitk != 4 && splitk != 8) || E < 1 || m_tiles < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tmap_x, tmap_w;
  if (!wonly::encode(&tmap_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, R, (uint64_t)K * 2, BK / 2,
                     MP) ||
      !wonly::encode(&tmap_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, (uint64_t)E * K, N, BN, BK))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = config(moe_w8a16_kernel, cfg, attr, MP * E * m_tiles, N, splitk,
                           static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, moe_w8a16_kernel, tmap_x, tmap_w,
                           static_cast<const float*>(scale), static_cast<bf16*>(out), R, K, N,
                           static_cast<const int*>(starts), m_tiles);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
