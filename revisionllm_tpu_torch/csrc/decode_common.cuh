// The parts of the whole-step decode kernels that rows 9 (decode_step.cu) and
// 10 (decode_serve.cu) share: the persistent cooperative kernel that walks the
// layers, its row, matmul and SwiGLU phases, and its launch. Each source gives
// its own attention source (row 9 reads an int8 prompt cache and a bf16 gen
// cache; row 10 one unified int8 slab): a caller of
// csrc/decode_attn_common.cuh's core (plan, issue, score) that also stores
// the new k/v, which attn_phase below runs.
//
// The kernel runs one block per SM (cudaLaunchCooperativeKernel), with the
// residual and the activations in small device buffers (L2-resident), and a
// grid-wide barrier between the phases of a layer:
//   1. rows: x += (down partials of the previous layer) * sd; h = RMSNorm(x);
//   2. q/k/v partial products;
//   3. attention per (row, head), all consumer warps on one at a time, its
//      cache tiles copied by the producer warps (attn_phase);
//   4. o partial products;
//   5. rows: x += o * so; h = RMSNorm(x);
//   6. gate and up partial products;
//   7. elementwise: m = bf16(silu(g)), m = bf16(m * u);
//   8. down partial products;
// and after the last layer one more row phase writes the hidden state out.
// That is 8 barriers a layer.
//
// The matmul phases (2, 4, 6, 8) are where the bytes go: 202 MB of int8
// weights a layer at Vicuna-7B, 60 us at 3.35 TB/s. Their design is K1's
// (csrc/int8_matmul.cu) carried into the persistent kernel:
//   1. K is cut into slices of at most KSLICE rows, whole BK-row boxes (4 for
//      K = 4096, 11 for F = 11008 or 11264), and each slice gets an equal
//      share of the blocks (bps = grid / S). Block (s, r) has its slice of
//      the bf16 activation [64, K] copied into shared memory ONCE a phase
//      (TMA, one mbarrier a [64, 128] box, 128-byte swizzled: wgmma's K-major
//      B operand, zeros past the launch's rows and past K), then walks the
//      column tiles r, r + bps, ... of 128 output columns, each the slice's
//      boxes of 128 K rows in K order, and writes f32 partial sums part[s,
//      64, Ntot]. The next phase adds the slices in a fixed order, so two
//      calls give the same bits.
//   2. A tile is computed transposed, part^T = W^T act^T, on
//      wgmma.m64n64k16: two wgmmas of 64 columns, A (columns x k) from
//      registers, the activation slice the B operand through a descriptor.
//      The int8 weights are widened in registers straight into the A
//      registers (wonly::widen: a prmt and one exact bf16x2 add), which puts
//      lane (g, t) of warp w on the tile's columns 32 w + 4 g .. + 3 of
//      rows 8 n + 2 t (+ 1): each lane stores a row's 4 columns as one 16
//      bytes, and a warp's store writes four whole 128-byte lines of part,
//      with no staging.
//   3. A producer warp: one lane issues the activation slice's copies at the
//      start of a phase (a consumer waits for a box's barrier before its first
//      product with it, so the slice lands under the first tiles), then TMA
//      copies of 128 x 128 int8 weight boxes (128-byte swizzle, evict-first in
//      L2; 3-D tensor maps (cw, K, L * N / cw) over each matrix, built on the
//      host once a call and passed in the __grid_constant__ Args, with the
//      activation's 2-D maps) into the rings of the CWG consumer
//      warpgroups, STAGES stages each with a full and an empty mbarrier. A
//      warpgroup waits for a stage's full barrier, widens, issues wgmma and
//      releases it: no block barrier in its loop. One ring a warpgroup keeps
//      each slot's boxes in one consumer's order, which the waits by parity
//      need. The rings run through the whole step: the q-th box of a ring
//      (counted over every matmul phase of every layer) sits in slot q %
//      STAGES with parity (q / STAGES) & 1, so no barrier is re-initialised,
//      and after the last box of a matmul phase the producer fills the free
//      stages with the first boxes of the next one (of this layer or the
//      next) before it joins the grid barrier: the weights do not depend on
//      the activations, so those copies overlap the barrier and the row,
//      attention and SwiGLU phases.
//   4. Each warpgroup takes its own column tiles of the block (tile j to
//      warpgroup j % CWG; the producer issues the boxes of CWG tiles in
//      turn). Splitting each tile's boxes over the warpgroups instead, with
//      their sums added in shared memory in warpgroup order, was slower
//      (PERF.md §6). The row and SwiGLU phases run on the consumer warps;
//      the producer warp meets their barriers.
// The attention phase (attn_phase) runs the decode-attention core of
// csrc/decode_attn_common.cuh on the consumer warps in `teams` teams (one a
// consumer warpgroup; fewer, larger teams when a long cache's scores do not
// fit), each on its own (row, head) items, dealt team after team and block
// after block: a team's threads make the item's q, k and v (the sum of the
// q/k/v partial slices and rope, three values a thread), then the scores,
// one shared max with the self term, and the values; the inputs of its next
// item's q, k and v (the partial slices, scales, cos and sin) are copied
// into shared memory (16-byte cp.async) while one item computes. Lane t of
// producer warp t copies team t's cache tiles into the team's ring of up
// to ASTAGES slots in the activation region, ahead across the passes and
// the items. The rings' mbarriers and counts live through the step, like the
// weight rings'.
// A matrix is stored as column chunks of `cw` columns, chunk c a contiguous
// [K, cw] block: cw = N is the standard [K, N] row-major layout, cw =
// block_n the serving pack's [nc, K, block_n]; a tile never straddles two
// chunks (cw % 128 == 0 or cw = N).
//
// The roundings are the TPU kernels': h rounds to bf16 before each weight dot;
// int8 weights are exact in bf16, accumulated in f32, then times the scale;
// the residual rounds to bf16 after each add; m = bf16(silu(g)), then
// bf16(m * u).

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "decode_attn_common.cuh"
#include "wonly_matmul_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HD = 128;        // head dim
constexpr int MP = 64;         // rows per launch (the batch, zero-padded): wgmma's n
constexpr int CWG = 3;         // consumer warpgroups
constexpr int CONSUMERS = 128 * CWG;
constexpr int PRODUCERS = CWG;          // producer warps: the weights' (0), one an attention team
constexpr int THREADS = CONSUMERS + 32 * PRODUCERS;
constexpr int WARPS = CONSUMERS / 32;    // the warps of the row and SwiGLU phases
constexpr int BN = 128;        // weight columns of a tile: two wgmmas of 64
constexpr int BK = 128;        // K rows of a weight box (a ring stage)
constexpr int KG = 2;          // k16 steps widened between two wgmma commits
constexpr int STAGES = 2;      // ring stages a consumer warpgroup
constexpr int KSLICE = 1024;   // at most this many K rows per slice
constexpr int AWARPS = WARPS;  // the attention phase's warps (of the WARPS), in teams
constexpr int ASTAGES = 4;     // the most slots of an attention team's ring
constexpr int ATILE = 12288;   // bytes of an attention ring tile (96 int8 positions)
constexpr int AGU = 2;         // position groups an attention warp takes at a time
constexpr size_t BOX = (size_t)BK * BN;          // one swizzled int8 weight box, 16 KB
constexpr size_t ACT_BOX = (size_t)MP * BK * 2;  // one [64, 128] bf16 activation box, 16 KB
constexpr size_t RING = (size_t)CWG * STAGES * BOX;
constexpr int ACT_BOXES = KSLICE / BK;  // the activation boxes of a slice, a barrier each
constexpr size_t BARS = 1024;  // the mbarriers, the producer's counts, the row phase's sums
constexpr size_t ABARS = 512;  // the attention ring's barriers, at this offset of BARS
// the shared memory besides the activation region (the 1024-byte alignment
// slack, the weight rings, the barriers); the activation region, last, holds
// a phase's activation slice or the attention phase's ring and scratch, never
// the weight rings, which are live across the grid barriers
constexpr size_t SMEM_FIXED = 1024 + RING + BARS;
constexpr size_t SMEM_MAX = 232448;  // the dynamic shared memory a block may opt in to

static_assert(attn::TILE == MP && attn::D == BK,
              "activation boxes are attention_common's swizzled [64, 128] tiles");
static_assert(BK / 16 % KG == 0, "whole wgmma groups a box");
static_assert(KSLICE % BK == 0, "slices of whole boxes");
static_assert((2 * CWG * STAGES + ACT_BOXES) * 8 + (CWG + 1) * 4 + WARPS * 4 <= ABARS &&
                  ABARS + CWG * 2 * ASTAGES * 8 <= BARS,
              "barriers, the producer's counts and the sums fit their region");
static_assert(AWARPS <= WARPS, "the attention phase runs on consumer warps");
static_assert(SMEM_FIXED + (size_t)MP * KSLICE * 2 <= SMEM_MAX, "a full slice fits shared memory");

struct Args {
  CUtensorMap tm[9];           // the weights', then act [B, D] and [B, F] (launch_step builds them)
  const int8_t* w[7];          // q, k, v, o, gate, up, down: [L, K, N] in chunks of cw columns
  int cw[7];                   // their column-chunk widths
  const float* s[7];           // their scales [L, N]
  const __nv_bfloat16* attn_norm;  // [L, D]
  const __nv_bfloat16* mlp_norm;   // [L, D]
  const int8_t* kv;            // [L, Bk, 2, H, Sp, HD] int8 (row 9: prompt; row 10: unified slab)
  const float* kvsc;           // [L, Bk, 2, H, Sp]
  __nv_bfloat16* genkv;        // row 9: [L, 2, Bk, H, Gp, HD]
  float* newkv;                // row 10: [L, 2, Bk, H, HD], this step's k (roped) and v
  const int* plen;             // [B] prompt lengths of this launch's rows
  const float* cosb;           // [B, HD / 2]
  const float* sinb;
  const __nv_bfloat16* x_in;   // [B, D]
  __nv_bfloat16* x_out;        // [B, D]
  __nv_bfloat16* xres;         // [MP, D] scratch: the residual stream
  __nv_bfloat16* act;          // [MP, max(D, F)] scratch: the matmul input
  float* part;                 // [slices, MP, N] scratch: partial sums
  int L, B, Bk, b0, D, F, H, Sp, Gp, S0, step;
  int nsc;                     // the attention phase's most positions an item (its scores)
  int teams, astages;          // its teams and each team's ring slots (launch_step sets them)
  float eps;
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ldf(const float* p) { return __ldcg(p); }

__device__ __forceinline__ float ldbf(const __nv_bfloat16* p) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(u));
}

// the barrier of the consumer warps alone (the producer warp may be issuing
// copies or waiting at the grid barrier)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K rows per slice and the number of slices of a K-deep product (mirrored
// by ops/decode_step.py to size the `part` scratch and the shared memory)
__host__ __device__ __forceinline__ int slice_rows(int K) {
  const int n = (K + KSLICE - 1) / KSLICE;
  const int r = (K + n - 1) / n;
  return (r + BK - 1) / BK * BK;
}

__host__ __device__ __forceinline__ int num_slices(int K) {
  const int r = slice_rows(K);
  return (K + r - 1) / r;
}

// the attention phase's shared memory in the activation region, a block of
// attn_team_bytes for each team: its ring (stages slots of ATILE bytes and
// their scales), then its scratch: the staged q/k/v inputs [3 S + 4][HD] (S
// K slices), q rounded to bf16, q, k and v in f32 [2 item parities][4][HD],
// the self score [2], the scores [nsc], the warps' partial outputs
// [wpt][HD], maxima and denominators [wpt] (mirrored by ops/decode_step.py)
// a slot's scale floats: a tile's positions and the 3 before them in the
// 16-byte-aligned cover of their run
constexpr int ASCL = dattn::tile_positions<ATILE>(1) + 4;

// the bytes of the 16-byte-aligned cover of scales [run, run + nv) of kvsc
// (its base is 16-byte aligned and its size a multiple of 16 bytes, so the
// cover stays inside it)
__device__ __forceinline__ uint32_t scale_cover(size_t run, int nv) {
  return (uint32_t)((((run + nv + 3) & ~(size_t)3) - (run & ~(size_t)3)) * 4);
}
__host__ __device__ inline size_t attn_ring_bytes(int stages) {
  return (size_t)stages * (ATILE + ASCL * 4);
}
__host__ __device__ inline size_t attn_stage_floats(int slices) {
  return (size_t)(3 * slices + 4) * HD;
}
__host__ __device__ inline size_t attn_scratch_bytes(int nsc, int slices, int wpt) {
  return 4 * (attn_stage_floats(slices) + (size_t)2 * 4 * HD + 2 + nsc + (size_t)wpt * (HD + 2));
}
__host__ __device__ inline size_t attn_team_bytes(int stages, int nsc, int slices, int wpt) {
  return (attn_ring_bytes(stages) + attn_scratch_bytes(nsc, slices, wpt) + 127) / 128 * 128;
}

// the attention phase's teams and each team's ring slots for items of up
// to nsc positions: the most teams (a divisor of AWARPS, at most CWG) whose
// rings get at least 2 slots beside their scratch, each up to ASTAGES;
// teams = 0 when not one team fits
inline void attn_layout(int nsc, int slices, int& teams, int& stages) {
  const size_t room = SMEM_MAX - SMEM_FIXED;
  for (teams = CWG; teams >= 1; --teams) {
    if (AWARPS % teams) continue;
    for (stages = ASTAGES; stages >= 2; --stages)
      if (teams * attn_team_bytes(stages, nsc, slices, AWARPS / teams) <= room) return;
  }
  teams = stages = 0;
}

// the dynamic shared memory of a launch: the fixed regions and the larger of
// the activation slices and the attention phase's ring and scratch
inline size_t step_smem(int D, int F, int nsc) {
  size_t act = (size_t)MP * slice_rows(D) * 2;
  const size_t act_f = (size_t)MP * slice_rows(F) * 2;
  act = act > act_f ? act : act_f;
  const int S = num_slices(D);
  int teams, stages;
  attn_layout(nsc, S, teams, stages);
  const size_t at = teams * attn_team_bytes(stages, nsc, S, AWARPS / teams);
  return SMEM_FIXED + (act > at ? act : at);
}

// ------------------------------------------------------------- row phases

// x = bf16(x + (sum of the down/o partial slices) * scale) for the rows of
// this launch (pre != nullptr), then (gamma != nullptr) act = bf16(RMSNorm(x)
// * gamma). First layer: x = x_in. Final: x_out = x. The consumer warps.
__device__ void row_phase(const Args& a, const float* pre_scale, int pre_slices,
                          const __nv_bfloat16* gamma, bool first, bool final_out,
                          float* red) {
  const int D = a.D;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    __nv_bfloat16* xr = a.xres + (size_t)b * D;
    float ss = 0.0f;
    for (int c = threadIdx.x; c < D; c += CONSUMERS) {
      float xv;
      if (first) {
        xv = __bfloat162float(a.x_in[(size_t)b * D + c]);
      } else {
        xv = ldbf(xr + c);
        if (pre_scale) {
          float acc = 0.0f;
          for (int s = 0; s < pre_slices; ++s) acc += ldf(a.part + ((size_t)s * MP + b) * D + c);
          xv = bf16r(xv + acc * pre_scale[c]);
        }
      }
      xr[c] = __float2bfloat16_rn(xv);
      if (final_out) a.x_out[(size_t)b * D + c] = __float2bfloat16_rn(xv);
      ss += xv * xv;
    }
    if (gamma) {
      ss = warp_sum(ss);
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
      consumer_sync();
      float tot = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) tot += red[w];
      const float inv = rsqrtf(tot / (float)D + a.eps);
      for (int c = threadIdx.x; c < D; c += CONSUMERS)
        a.act[(size_t)b * D + c] =
            __float2bfloat16_rn((ldbf(xr + c) * inv) * __bfloat162float(gamma[c]));
    }
    consumer_sync();
  }
}

// ---------------------------------------------------------- matmul phases

// matmul phase p of a layer: matrices first .. first + nmat - 1, each [K, N]
struct Phase {
  int first, nmat, K, N;
};

__device__ __forceinline__ Phase phase_of(const Args& a, int p) {
  return p == 0 ? Phase{0, 3, a.D, a.D}     // q, k, v
       : p == 1 ? Phase{3, 1, a.D, a.D}     // o
       : p == 2 ? Phase{4, 2, a.D, a.F}     // gate, up
                : Phase{6, 1, a.F, a.D};    // down
}

// this block's share of a phase: K slice s (rows k_begin .. + kn, nkb boxes)
// and the column tiles r, r + bps, ... (nt of them, nchunks a matrix)
struct Share {
  int s, k_begin, kn, nkb, r, bps, nchunks, nt, boxes;
};

__device__ __forceinline__ Share share_of(const Phase& p) {
  Share h;
  const int S = num_slices(p.K), kper = slice_rows(p.K);
  h.bps = gridDim.x / S;
  h.s = blockIdx.x / h.bps;
  h.r = blockIdx.x % h.bps;
  h.nchunks = (p.N + BN - 1) / BN;
  const int ntiles = p.nmat * h.nchunks;
  const bool live = h.s < S && h.r < ntiles;
  h.k_begin = h.s * kper;
  h.kn = live ? min(p.K, h.k_begin + kper) - h.k_begin : 0;
  h.nkb = (h.kn + BK - 1) / BK;
  h.nt = live ? (ntiles - 1 - h.r) / h.bps + 1 : 0;
  h.boxes = h.nt * h.nkb;
  return h;
}

// box i of the block's walk of a phase -> its tile j (of the block's nt)
// and its k box kb: rounds of CWG tiles (the last may hold fewer, m), box kb
// of each tile of a round in turn
__device__ __forceinline__ void box_of(const Share& h, int i, int& j, int& kb) {
  const int round = i / (CWG * h.nkb), q = i % (CWG * h.nkb);
  const int m = min(CWG, h.nt - round * CWG);
  kb = q / m;
  j = round * CWG + q % m;
}

// what the producer's lane keeps across the phases, in shared memory (so
// that it takes no registers of the consumers): the boxes it has issued to
// each ring, and how many of the coming phase's boxes it has issued ahead
struct Producer {
  int issued[CWG];
  int ahead;
};

// the rings: CWG x STAGES weight boxes with a full and an empty barrier
// each, and the activation boxes' barriers; a consumer thread counts the
// boxes its warpgroup's ring has taken, and keeps the parity that each
// activation box's barrier completes next in bit kb of actpar
struct Ring {
  unsigned char* box;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* act;
  Producer* prod;
  int taken;
  unsigned actpar;
};

// the producer: box i of phase p of layer l into its ring's next slot, once
// that slot's previous box has been released
__device__ __forceinline__ void issue_box(const Args& a, int l, const Phase& p, const Share& h,
                                          int i, const Ring& rg) {
  int j, kb;
  box_of(h, i, j, kb);
  const int c = h.r + j * h.bps;
  const int mat = p.first + c / h.nchunks, n0 = (c % h.nchunks) * BN;
  const int cw = a.cw[mat];
  const int w = j % CWG;  // the ring of tile j's warpgroup
  const int q = rg.prod->issued[w]++;
  const int slot = w * STAGES + q % STAGES;
  if (q >= STAGES) wonly::mbar_wait(rg.empty + slot, (q / STAGES - 1) & 1);
  wonly::mbar_arrive_expect(rg.full + slot, (uint32_t)BOX);
  // the weights are read once a step: first out of L2 (the activations,
  // the partial sums and the caches stay)
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  // the column chunk that holds columns n0 .. n0 + BN - 1, at column n0 % cw
  wonly::tma_load_3d_hint(rg.box + slot * BOX, &a.tm[mat], n0 % cw, h.k_begin + kb * BK,
                          l * (p.N / cw) + n0 / cw, rg.full + slot, policy);
}

// the producer, ahead of matmul phase p of layer l: its first boxes in walk
// order until one would wait for a slot that a box of that phase holds (so
// up to STAGES a ring; those waits are for the boxes of the phase before,
// which its consumers release). Returns how many it issued.
__device__ __forceinline__ int issue_ahead(const Args& a, int l, int p, const Ring& rg) {
  if (l >= a.L) return 0;
  const Phase ph = phase_of(a, p);
  const Share h = share_of(ph);
  int n[CWG] = {};
  int i = 0;
  for (; i < h.boxes; ++i) {
    int j, kb;
    box_of(h, i, j, kb);
    if (n[j % CWG]++ == STAGES) break;
    issue_box(a, l, ph, h, i, rg);
  }
  return i;
}

// the producer, at the start of matmul phase pi: the block's activation
// slice act[0:B, k_begin .. k_begin + kn) (row stride K) into the activation
// region as nkb [64, 128] boxes, each two swizzled 64 x 64 halves and one
// barrier; the act map's B rows and K columns zero-fill the rest. The
// activation was written by other blocks before the grid barrier: the proxy
// fence orders those generic writes before the copies' reads.
__device__ __forceinline__ void issue_slice(const Args& a, int pi, const Share& h,
                                            unsigned char* act, const Ring& rg) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  const CUtensorMap* map = &a.tm[pi == 3 ? 8 : 7];
  for (int kb = 0; kb < h.nkb; ++kb) {
    const int k0 = h.k_begin + kb * BK;
    wonly::mbar_arrive_expect(rg.act + kb, (uint32_t)ACT_BOX);
    wonly::tma_load_2d(act + kb * ACT_BOX, map, k0, 0, rg.act + kb);
    wonly::tma_load_2d(act + kb * ACT_BOX + ACT_BOX / 2, map, k0 + BK / 2, 0, rg.act + kb);
  }
}

// acc += the weight box at `w` (BK rows of the tile's 128 columns) times the
// activation box at `x`: 8 k16 steps, KG a group, the A registers of group q
// widened while group q - 1 runs. All groups are done on return (ptxas
// serialises wgmma when a group is in flight across a loop's back edge).
__device__ __forceinline__ void consume(float (&acc)[2][8][4], const unsigned char* w,
                                        const unsigned char* x, int off_e, int off_o) {
  uint32_t r[2][KG][2][4];
  const unsigned char* we = w + off_e;
  const unsigned char* wo = w + off_o;
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
      wonly::widen<0>(r[b][e], r0, r1);  // k 2t, 2t + 1
      wonly::widen<2>(r[b][e], r8, r9);  // k 2t + 8, 2t + 9
    }
    attn::wgmma_fence();
#pragma unroll
    for (int e = 0; e < KG; ++e)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        attn::wgmma_m64n64k16(acc[j], r[b][e][j], attn::k_major(x, q * KG + e), 1);
    attn::wgmma_commit();
    wonly::wgmma_wait<1>();  // group q - 1 is done: its A registers may be rewritten
#pragma unroll
    for (int e = 0; e < KG; ++e) attn::pin(r[b ^ 1][e]);
  }
  attn::wgmma_wait0();
#pragma unroll
  for (int e = 0; e < KG; ++e) {
    attn::pin(r[0][e]);
    attn::pin(r[1][e]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) attn::pin(acc[j]);
}

// the consumer warpgroup wg: wait for its ring's next box and for activation
// box kb, add their product to acc, release the weight box
__device__ __forceinline__ void take_box(float (&acc)[2][8][4], int wg, int kb,
                                         const unsigned char* act, Ring& rg, int off_e,
                                         int off_o) {
  const int q = rg.taken++;
  const int slot = wg * STAGES + q % STAGES;
  wonly::mbar_wait(rg.act + kb, (rg.actpar >> kb) & 1);
  wonly::mbar_wait(rg.full + slot, (q / STAGES) & 1);
  consume(acc, rg.box + slot * BOX, act + kb * ACT_BOX, off_e, off_o);
  if ((threadIdx.x & 31) == 0) wonly::mbar_arrive(rg.empty + slot);
}

__device__ __forceinline__ void zero(float (&acc)[2][8][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.0f;
}

// wgmma jj's row 16 w + g + 8 h is the tile's column c0 + 2 h + jj (c0 = 32 w
// + 4 g), its column 8 n + 2 t + b the launch's row: lane (g, t) holds
// columns c0 .. c0 + 3 of rows 8 n + 2 t + b as the float4 v4(acc, n, b)
__device__ __forceinline__ float4 v4(const float (&acc)[2][8][4], int n, int b) {
  return make_float4(acc[0][n][b], acc[1][n][b], acc[0][n][2 + b], acc[1][n][2 + b]);
}

// tile j's partial sums into part[s, row, mat * N + n0 + c0 ..], rows < B:
// plain 16-byte stores (the next phase reads them after the grid barrier),
// the rows' addresses stepped from one pointer
__device__ __forceinline__ void store_tile(const Args& a, const Phase& p, const Share& h, int j,
                                           const float (&acc)[2][8][4], int c0, int t) {
  const int c = h.r + j * h.bps;
  const int n0 = (c % h.nchunks) * BN;
  if (n0 + c0 >= p.N) return;
  const int Ntot = p.nmat * p.N;
  float* dst = a.part + ((size_t)h.s * MP + 2 * t) * Ntot + (c / h.nchunks) * p.N + n0 + c0;
  const int rows = a.B - 2 * t;  // this lane's rows 8 n + b that are live: 8 n + b < rows
#pragma unroll
  for (int n = 0; n < 8; ++n, dst += (size_t)8 * Ntot)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      if (8 * n + b < rows) *reinterpret_cast<float4*>(dst + b * Ntot) = v4(acc, n, b);
}

// part[s, 0:MP, mi * N + n] = act[0:MP, slice s] @ W_mi[l][slice s, n] for
// the phase's matrices. Every thread of the block calls it: the producer
// warp issues the phase's boxes and the next phase's first ones, the
// consumer warpgroups load the slice and take the boxes.
__device__ void mm_phase(const Args& a, int l, int pi, unsigned char* act, Ring& rg) {
  const Phase p = phase_of(a, pi);
  const Share h = share_of(p);
  const int tid = threadIdx.x;
  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      if (h.boxes) issue_slice(a, pi, h, act, rg);
      for (int i = rg.prod->ahead; i < h.boxes; ++i) issue_box(a, l, p, h, i, rg);
      rg.prod->ahead = issue_ahead(a, l + (pi == 3), (pi + 1) & 3, rg);
    }
    __syncwarp();
  } else if (h.boxes) {
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // this lane's words in a swizzled weight box: columns c0 .. c0 + 3 of
    // rows 2t (and 2t + 8; off_e) and 2t + 1 (and 2t + 9; off_o) of k16 step 0
    const int c0 = 32 * warp + 4 * g;
    const int off_e = 2 * t * BN + (((c0 >> 4) ^ (2 * t)) << 4) + (c0 & 15);
    const int off_o = (2 * t + 1) * BN + (((c0 >> 4) ^ (2 * t + 1)) << 4) + (c0 & 15);
    float acc[2][8][4];
    for (int j = wg; j < h.nt; j += CWG) {
      zero(acc);
      for (int kb = 0; kb < h.nkb; ++kb) take_box(acc, wg, kb, act, rg, off_e, off_o);
      store_tile(a, p, h, j, acc, c0, t);
    }
    rg.actpar ^= (1u << h.nkb) - 1;  // each activation box's barrier completed once
  }
}

// ----------------------------------------------------- SwiGLU elementwise

__device__ void silu_phase(const Args& a, int l) {
  const int F = a.F;
  const int S = num_slices(a.D);
  const int Ntot = 2 * F;
  const float* sg = a.s[4] + (size_t)l * F;
  const float* su = a.s[5] + (size_t)l * F;
  for (int idx = blockIdx.x * CONSUMERS + threadIdx.x; idx < a.B * F;
       idx += gridDim.x * CONSUMERS) {
    const int b = idx / F, c = idx - b * F;
    float g = 0.0f, u = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float* row = a.part + ((size_t)s * MP + b) * Ntot;
      g += ldf(row + c);
      u += ldf(row + F + c);
    }
    g *= sg[c];
    u *= su[c];
    const float mb = bf16r(g * (1.0f / (1.0f + expf(-g))));
    a.act[(size_t)b * F + c] = __float2bfloat16_rn(mb * u);
  }
}

// ------------------------------------------------------- attention phase

// A team's 16-byte copies (cp.async, L2 only; ttid its thread, TT its
// threads) of the inputs of item `item`'s q, k and v into `stage`: the S K
// slices' partial sums of the head's q, k and v columns [3][S][HD], their
// column scales [3][HD], and rope's cos and sin [2][HD / 2].
template <int TT>
__device__ __forceinline__ void stage_qkv(const Args& a, int l, int item, float* stage, int ttid) {
  constexpr int C4 = HD / 4;  // 16-byte chunks a row of HD floats
  const int b = item / a.H, h = item % a.H;
  const int S = num_slices(a.D), Ntot = 3 * a.D;
  const int parts = 3 * S * C4, chunks = parts + 4 * C4;
  for (int i = ttid; i < chunks; i += TT) {
    const float* src;
    if (i < parts) {
      const int w3 = i / (S * C4), sl = i / C4 % S;
      src = a.part + ((size_t)sl * MP + b) * Ntot + w3 * a.D + h * HD + 4 * (i % C4);
    } else if (i < parts + 3 * C4) {
      const int j = i - parts;
      src = a.s[j / C4] + (size_t)l * a.D + h * HD + 4 * (j % C4);
    } else {
      const int j = i - parts - 3 * C4;  // cos, then sin: HD / 8 chunks each
      src = (j < HD / 8 ? a.cosb : a.sinb) + b * (HD / 2) + 4 * (j % (HD / 8));
    }
    wonly::cp_async16(stage + 4 * i, src, true);
  }
}

// the barrier of one attention team's NW warps (ids 2 .. 2 + CWG - 1)
template <int NW>
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(2 + team), "n"(32 * NW) : "memory");
}

// The attention phase of layer l for teams of NW warps, called by every
// thread of the block with its team's ring r (attn_ring): lane 0 of
// producer warp t < teams copies team t's cache tiles (Src::plan_of,
// Src::issue) into the team's ring; team t's
// threads take items blockIdx.x + gridDim.x * (t + teams k) and, per item,
// make q, k and v in f32 from the staged inputs (thread i < 3 HD: matrix i /
// HD at dim d = i % HD, the sum of the partial slices in slice order times
// the scale; rope on q and k: x * (cos | cos) + (-x2 | x1) * (sin | sin)),
// store the new k/v (Src::store_new), run the core's score pass (q rounded
// to bf16) and value pass with one max shared by the tiles' scores and the
// f32 self term q . k_new, and write act[b, h * HD + d] =
// bf16((o + p_self * v) / (den + p_self)).
template <class Src, int NW>
__device__ void attn_team_phase(const Args& a, int l, dattn::Ring& r) {
  constexpr int TT = 32 * NW;
  const Src src{a, l, rsqrtf((float)HD)};
  const int items = a.B * a.H, teams = AWARPS / NW;
  const int first = blockIdx.x, stride = gridDim.x * teams;
  if (threadIdx.x >= CONSUMERS) {
    const int t = (threadIdx.x - CONSUMERS) >> 5;
    if (t < teams && (threadIdx.x & 31) == 0)
      dattn::produce(src, r, first + gridDim.x * t, stride, items);
    return;
  }
  const int team = threadIdx.x / TT, ttid = threadIdx.x % TT, warp = ttid >> 5, lane = ttid & 31;
  const int S = num_slices(a.D);
  float* stage = reinterpret_cast<float*>(r.data + attn_ring_bytes(a.astages));
  const float* scol = stage + 3 * S * HD;   // column scales [3][HD]
  const float* rope = scol + 3 * HD;        // cos [HD / 2], sin [HD / 2]
  float* qkv = stage + attn_stage_floats(S);
  float* sself = qkv + 2 * 4 * HD;
  float* sc = sself + 2;
  float* part = sc + a.nsc;
  float* red_max = part + NW * HD;
  float* red_den = red_max + NW;
  int item = first + gridDim.x * team;
  int plen = 0;
  if (item < items) {
    stage_qkv<TT>(a, l, item, stage, ttid);
    plen = src.plen_of(item);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  team_sync<NW>(team);
  for (int par = 0; item < items; item += stride, par ^= 1) {
    const int b = item / a.H, h = item % a.H;
    float* qb = qkv + par * 4 * HD;  // q rounded to bf16, then q, k, v in f32
#pragma unroll
    for (int k = 0; k < (3 * HD + TT - 1) / TT; ++k) {
      const int i = ttid + k * TT;
      if (i >= 3 * HD) break;
      const int w3 = i / HD, d = i % HD;
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int dd = j ? d ^ (HD / 2) : d;
        float acc = 0.0f;
        for (int sl = 0; sl < S; ++sl) acc += stage[(w3 * S + sl) * HD + dd];
        x[j] = acc * scol[w3 * HD + dd];
      }
      float v = x[0];
      if (w3 < 2) {
        const float rot = d < HD / 2 ? -x[1] : x[1];
        v = __fadd_rn(__fmul_rn(v, rope[d & (HD / 2 - 1)]),
                      __fmul_rn(rot, rope[HD / 2 + (d & (HD / 2 - 1))]));
      }
      if (w3 == 0) qb[d] = bf16r(v);
      qb[(w3 + 1) * HD + d] = v;
      if (w3) src.store_new(b, h, w3 - 1, d, v);
    }
    const dattn::Plan pl = src.plan_of(item, plen);
    team_sync<NW>(team);  // q, k and v of this item; the staged inputs are read
    const int next = item + stride;
    if (next < items) {
      stage_qkv<TT>(a, l, next, stage, ttid);
      plen = src.plen_of(next);
    }
    if (warp == 0) {
      float self = 0.0f;
#pragma unroll
      for (int e = 0; e < HD / 32; ++e) self += qb[HD + lane + 32 * e] * qb[2 * HD + lane + 32 * e];
      self = warp_sum(self) * src.scale;
      if (lane == 0) sself[par] = self;
    }
    dattn::score_pass<NW>(src, pl, qb, sc, a.nsc, red_max, r, warp);
    team_sync<NW>(team);  // the scores, the warps' maxima and the self score
    float m[1];
    const float s_self = sself[par];
    dattn::block_max<NW, Src>(red_max, s_self, m);
    dattn::value_pass<NW>(src, pl, sc, a.nsc, m, part, red_den, r, warp);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    team_sync<NW>(team);  // the warps' partial outputs and denominators; the next item's inputs
    if (ttid < HD) {
      const float ps = expf(s_self - m[0]);
      const float den = dattn::den_sum<NW, Src>(red_den, 0) + ps;
      const float o = dattn::out_sum<NW, Src>(part, 0, ttid) + ps * qb[3 * HD + ttid];
      a.act[(size_t)b * a.D + h * HD + ttid] = __float2bfloat16_rn(o / den);
    }
  }
}

// the attention phase at the launch's team count
template <class Src>
__device__ __forceinline__ void attn_phase(const Args& a, int l, dattn::Ring& r) {
  if (a.teams == CWG) attn_team_phase<Src, AWARPS / CWG>(a, l, r);
  else if (a.teams == 2 && CWG > 2) attn_team_phase<Src, AWARPS / 2>(a, l, r);
  else attn_team_phase<Src, AWARPS>(a, l, r);
}

// the ring of the calling thread's attention team (a consumer's, or a
// producer warp's), its blocks of attn_team_bytes in the activation region
// and its barriers in BARS; every thread of the block calls it once, and
// thread 0 initialises the barriers of every team
__device__ __forceinline__ dattn::Ring attn_ring(const Args& a, unsigned char* act, uint64_t* abar) {
  const int teams = a.teams ? a.teams : 1, wpt = AWARPS / teams;
  const int t = threadIdx.x < CONSUMERS ? threadIdx.x / (32 * wpt)
                                        : min((int)(threadIdx.x - CONSUMERS) >> 5, CWG - 1);
  unsigned char* base = act + t * attn_team_bytes(a.astages, a.nsc, num_slices(a.D), wpt);
  const dattn::Ring r{base, reinterpret_cast<float*>(base + (size_t)a.astages * ATILE),
                      abar + 2 * ASTAGES * t, abar + 2 * ASTAGES * t + ASTAGES, a.astages, 0, 0, 0};
  if (threadIdx.x == 0)
    for (int i = 0; i < teams; ++i) {
      dattn::Ring ri = r;
      ri.full = abar + 2 * ASTAGES * i;
      ri.empty = ri.full + ASTAGES;
      dattn::init_ring(ri, wpt);
    }
  return r;
}

template <class Attn>
__global__ void __launch_bounds__(THREADS, 1) step_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = attn::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING);
  Producer* prod = reinterpret_cast<Producer*>(full + 2 * CWG * STAGES + ACT_BOXES);
  float* red = reinterpret_cast<float*>(prod + 1);
  unsigned char* act = smem + RING + BARS;  // the slice, or the attention's scratch
  cg::grid_group grid = cg::this_grid();
  const bool consumer = threadIdx.x < CONSUMERS;
  Ring rg{smem, full, full + CWG * STAGES, full + 2 * CWG * STAGES, prod, 0, 0};
  // this thread's attention team's ring, its barriers in BARS
  dattn::Ring ar = attn_ring(a, act, reinterpret_cast<uint64_t*>(smem + RING + ABARS));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < CWG * STAGES; ++i) {
      wonly::mbar_init(rg.full + i, 1);
      wonly::mbar_init(rg.empty + i, 4);  // the warps of the ring's warpgroup
    }
#pragma unroll
    for (int i = 0; i < ACT_BOXES; ++i) wonly::mbar_init(rg.act + i, 1);
    wonly::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == CONSUMERS) {
    *prod = Producer{};
    prod->ahead = issue_ahead(a, 0, 0, rg);
  }
  const int D = a.D, F = a.F;
  const int S_D = num_slices(D), S_F = num_slices(F);
  for (int l = 0; l < a.L; ++l) {
    if (consumer)
      row_phase(a, l ? a.s[6] + (size_t)(l - 1) * D : nullptr, S_F, a.attn_norm + (size_t)l * D,
                l == 0, false, red);
    grid.sync();
    mm_phase(a, l, 0, act, rg);        // q, k, v
    grid.sync();
    attn_phase<Attn>(a, l, ar);
    // its scratch (and the producer's scale copies), before the next slice's copies into it
    if (consumer) attn::fence_proxy_async();
    grid.sync();
    mm_phase(a, l, 1, act, rg);        // o
    grid.sync();
    if (consumer)
      row_phase(a, a.s[3] + (size_t)l * D, S_D, a.mlp_norm + (size_t)l * D, false, false, red);
    grid.sync();
    mm_phase(a, l, 2, act, rg);        // gate, up
    grid.sync();
    if (consumer) silu_phase(a, l);
    grid.sync();
    mm_phase(a, l, 3, act, rg);        // down
    grid.sync();
  }
  if (consumer) row_phase(a, a.s[6] + (size_t)(a.L - 1) * D, S_F, nullptr, false, true, red);
}

// One cooperative launch of step_kernel<Attn>, one block per SM, with
// step_smem's shared memory for the attention phase's items of up to `nsc`
// positions (attn_layout's teams and rings). It builds the tensor maps first:
// weight matrix i, [L, K, N] as L * N / cw chunks [K, cw], is the 3-D tensor
// (cw, K, L * N / cw) in boxes of BN x BK; the activation, [B, D] or [B, F]
// (row stride D or F), is copied in 64 x 64 boxes.
template <class Attn>
int launch_step(Args& a, int nsc, void* stream) {
  void (*kernel)(Args) = step_kernel<Attn>;
  const int Ks[7] = {a.D, a.D, a.D, a.D, a.D, a.D, a.F};
  const int Ns[7] = {a.D, a.D, a.D, a.D, a.F, a.F, a.D};
  for (int i = 0; i < 7; ++i) {
    const cuuint64_t cw = (cuuint64_t)a.cw[i], K = (cuuint64_t)Ks[i];
    const cuuint64_t dims[3] = {cw, K, (cuuint64_t)a.L * (Ns[i] / a.cw[i])};
    const cuuint64_t strides[2] = {cw, K * cw};
    const cuuint32_t box[3] = {BN, BK, 1};
    if (!wonly::encode(&a.tm[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w[i], 3, dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 2; ++i) {
    const int K = i ? a.F : a.D;
    if (!wonly::encode(&a.tm[7 + i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.act, K, a.B,
                       (uint64_t)K * 2, BK / 2, MP))
      return (int)cudaErrorInvalidValue;
  }
  a.nsc = nsc;
  attn_layout(nsc, num_slices(a.D), a.teams, a.astages);
  if (a.teams < 1 || (size_t)a.L * a.Bk * 2 * a.H * a.Sp % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = step_smem(a.D, a.F, nsc);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // one block per SM: every slice of the widest split (F: 11 at 7B) gets
  // at least one block
  const int grid = sms;
  if (grid < num_slices(a.F) || grid < num_slices(a.D)) return (int)cudaErrorInvalidConfiguration;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(THREADS),
                                    params, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
