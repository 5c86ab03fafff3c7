// The decode-attention core that K3 (csrc/decode_attention.cu) and the
// attention phases of rows 9 and 10 (csrc/decode_step.cu and
// csrc/decode_serve.cu, inside csrc/decode_common.cuh's step kernel) run:
// one query token (or a GQA group of them) against an int8 cache with
// per-(position, head) scales, plus a bf16 piece, as a two-pass softmax with
// one shared max.
//
// What bounds it on the H100: the bytes of the int8 cache, 256 bytes a
// position (K and V) against 512 multiply-adds. A caller deals out items
// (one query head group over one kv head of one batch row) and describes each
// as up to three segments of positions, int8 with scales or bf16 without
// (K3: the prompt, then the gen slots <= step; row 9: the prompt, then the
// gen slots < step; row 10: the slab's two ranges). The design:
//   1. Bytes by bulk async copies into a ring of position tiles. A tile is
//      TB bytes of one segment (TB / 128 int8 positions, TB / 256 bf16 ones)
//      and, for int8, its positions' scales. One producer thread walks the
//      block's items in the consumers' order, K tiles then V tiles of each,
//      and issues a tile's copies on the slot's full mbarrier with their
//      byte count: the data (rows 9 and 10: one 1-D cp.async.bulk of a
//      contiguous run; K3: TMA boxes of a 4-D tensor map) and the scales
//      (rows: the 16-byte-aligned cover of the run, a 1-D bulk copy; K3: a
//      TMA box of 4 heads of its [B, S, KH] scales from a multiple of 4). A
//      TMA box that runs past the tensor in its innermost dimension never
//      completes on the H100, so no copy makes one. It runs
//      ahead of the
//      consumers as far as the ring reaches: across the max and across
//      items, so the V tiles of item i and the K tiles of item i + 1 land
//      while item i computes. A slot is refilled once every attention warp
//      has released it (empty mbarrier, one arrival a warp).
//   2. Int8 widened at full rate: a byte b becomes the f32 2^23 + (b ^ 0x80)
//      by one prmt against 0x4B00 (a word XORed with 0x80808080 first) and
//      then b by one subtraction of 2^23 + 128, exactly; no integer-to-float
//      conversion instruction. bf16 is a shift or a mask. Products and sums
//      stay f32.
//   3. All warps of a team (K3: a block's; rows 9 and 10: a consumer
//      warpgroup, or more for a long cache) on one item. Lane (kq, p) of a warp
//      holds dims [p E, p E + E) of the query (E = 128 / P) and reads the
//      same dims of position kq of a group of R = 32 / P positions; group g
//      of a tile goes to warp (groups dealt before + g) % NW, so the warps
//      share every tile; a warp takes its groups GU at a time, each dot in
//      two partial sums, so that loads, shuffles and sums overlap. Scores go
//      to shared memory; each warp's max, then
//      the block's in warp order; the value pass recomputes p = exp(s - m)
//      per position, sums the denominator from the unrounded p, rounds p *
//      v_scale (int8) or p (bf16) to bf16 and accumulates the values; the
//      warps' partial outputs and denominators are summed in warp order.
//      No atomics: two calls give the same bits.
// The order of the f32 products of an int8 score is the caller's (C::score:
// K3's (dot * scale) * k_scale, the rows' (dot * k_scale) * scale); a bf16
// score is dot * scale for all three.
//
// The passes take the team's warp count NW and the calling warp's index in
// its team. Each caller C provides: TB (tile bytes), GRP (queries a kv
// head), P (lanes a position), GU (position groups a warp takes at a time),
// SCL (scale floats a slot), SST (floats a position in a slot's scales:
// position t's K scale is at t SST + so, its V scale at t SST + sov of its
// segment), plen_of(item) and plan_of(item, plen) -> Plan, score(dot, k_scale) and
// scale, and issue(item, side, segment, first position, positions, slot
// data, slot scales, full barrier) for the producer's copies.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wonly_matmul_common.cuh"

namespace dattn {

constexpr int HD = 128;                 // head dim
constexpr int TAIL = 8;                 // positions of K3's tail box (a tile's ragged end)
constexpr float NEG_INF = -2.0e30f;
constexpr float MAGIC = 8388736.0f;     // 2^23 + 128: 0x4B0000xx - MAGIC = (int8)(xx ^ 0x80)

// n positions of one kind (int8 with scales, or bf16), their scores at
// sc[t0 ..]; the offsets of their K and V scales in a slot's scales
struct Seg {
  int n, t0, i8, so, sov;
};

// an item's segments in walk order
struct Plan {
  Seg s[3];
  int ns;
};

// positions a TB-byte tile holds of a segment's kind
template <int TB>
__host__ __device__ constexpr int tile_positions(int i8) {
  return i8 ? TB / HD : TB / (2 * HD);
}

// the ring: `stages` slots of TB bytes and SCL scale floats, a full and
// an empty barrier each; each thread counts the tiles it has issued (the
// producer) or taken (the attention warps), and the slot and parity of the
// next one
struct Ring {
  unsigned char* data;
  float* scl;
  uint64_t* full;
  uint64_t* empty;
  int stages, count, slot, phase;
};

__device__ __forceinline__ void advance(Ring& r) {
  ++r.count;
  if (++r.slot == r.stages) {
    r.slot = 0;
    r.phase ^= 1;
  }
}

// the barriers of a ring, by one thread before anyone uses them
__device__ __forceinline__ void init_ring(const Ring& r, int warps) {
  for (int i = 0; i < r.stages; ++i) {
    wonly::mbar_init(r.full + i, 1);
    wonly::mbar_init(r.empty + i, warps);
  }
  wonly::mbar_init_fence();
}

// ------------------------------------------------------------ the copies

// `bytes` contiguous bytes of global memory into shared memory, counted on
// `bar` (1-D bulk copy: 16-byte aligned, a multiple of 16 bytes)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n"
      :: "r"(wonly::smem_addr(dst)), "l"(src), "r"(bytes), "r"(wonly::smem_addr(bar)),
         "l"(policy)
      : "memory");
}

// the box at (c0, c1, c2, c3) of a 4-D tensor map (a __grid_constant__
// parameter) into dst, counted on `bar`; elements outside the tensor are zeros
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, int c0, int c1, int c2,
                                            int c3, uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n"
      :: "r"(wonly::smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(wonly::smem_addr(bar)), "l"(policy)
      : "memory");
}

// the box at (c0, c1, c2) of a 3-D tensor map
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int c0, int c1, int c2,
                                            uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%2, %3, %4}], [%5], %6;\n"
      :: "r"(wonly::smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(wonly::smem_addr(bar)), "l"(policy)
      : "memory");
}

// the cache is read once a step: first out of L2
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// The producer: the tiles of the block's items item0, item0 + step, ..
// < items, K then V of each, in segment order, each into the ring's next
// slot once the attention warps have released it. One thread calls it; it
// reads each item's prompt length one item ahead.
template <class C>
__device__ __forceinline__ void produce(const C& c, Ring& r, int item0, int step, int items) {
  int plen = item0 < items ? c.plen_of(item0) : 0;
  for (int item = item0; item < items; item += step) {
    const Plan pl = c.plan_of(item, plen);
    if (item + step < items) plen = c.plen_of(item + step);
    for (int side = 0; side < 2; ++side)
      for (int si = 0; si < pl.ns; ++si) {
        const int tp = tile_positions<C::TB>(pl.s[si].i8);
        for (int p0 = 0; p0 < pl.s[si].n; p0 += tp) {
          if (r.count >= r.stages) wonly::mbar_wait(r.empty + r.slot, r.phase ^ 1);
          c.issue(item, side, si, p0, min(tp, pl.s[si].n - p0), r.data + (size_t)r.slot * C::TB,
                  r.scl + r.slot * C::SCL, r.full + r.slot);
          advance(r);
        }
      }
  }
}

// ----------------------------------------------------------- the widening

// E int8 values of a tile row at `row` (bytes [p E, p E + E)) as exact f32;
// zeros for a position past the tile's live ones
template <int E>
__device__ __forceinline__ void widen_i8(const unsigned char* row, int p, bool ok, float (&v)[E]) {
  uint32_t w[E / 4];
  if constexpr (E == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + p * 16);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (E == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + p * 8);
    w[0] = u.x; w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(row + p * 4);
  }
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const uint32_t x = ok ? w[i] ^ 0x80808080u : 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[4 * i + j] = __uint_as_float(__byte_perm(x, 0x4B00u, 0x5440u | j)) - MAGIC;
  }
}

// E bf16 values of a tile row (bytes [2 p E, 2 p E + 2 E)) as f32
template <int E>
__device__ __forceinline__ void widen_bf16(const unsigned char* row, int p, bool ok, float (&v)[E]) {
  uint32_t w[E / 2];
  if constexpr (E == 16) {
    const uint4 a = *reinterpret_cast<const uint4*>(row + p * 32);
    const uint4 b = *reinterpret_cast<const uint4*>(row + p * 32 + 16);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w; w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else if constexpr (E == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(row + p * 16);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(row + p * 8);
    w[0] = a.x; w[1] = a.y;
  }
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const uint32_t x = ok ? w[i] : 0u;
    v[2 * i] = __uint_as_float(x << 16);
    v[2 * i + 1] = __uint_as_float(x & 0xffff0000u);
  }
}

// ------------------------------------------------------------ the passes

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the first group of a tile that warp `warp` takes, `dealt` groups having
// gone to the NW warps before it
template <int NW>
__device__ __forceinline__ int first_group(int warp, int dealt) {
  return (warp - dealt % NW + NW) % NW;
}

// The score pass over item plan `pl`'s K tiles, by the attention warps:
// q [GRP][HD] f32 in shared memory; s = C::score(q . k, k_scale) (int8) or
// (q . k) * scale (bf16) into sc[g * nsc + t]; each warp's max of its
// scores per query into red_max[warp * GRP + g].
template <int NW, class C>
__device__ __forceinline__ void score_pass(const C& c, const Plan& pl, const float* qs, float* sc, int nsc,
                           float* red_max, Ring& r, int warp) {
  constexpr int GRP = C::GRP, P = C::P, E = HD / P, R = 32 / P, SST = C::SST, GU = C::GU;
  const int lane = threadIdx.x & 31;
  const int kq = lane / P, p = lane % P;
  float q[GRP][E], mx[GRP];
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    mx[g] = NEG_INF;
#pragma unroll
    for (int e = 0; e < E; ++e) q[g][e] = qs[g * HD + p * E + e];
  }
  int dealt = 0;
  for (int si = 0; si < pl.ns; ++si) {
    const Seg s = pl.s[si];
    const int tp = tile_positions<C::TB>(s.i8);
    for (int p0 = 0; p0 < s.n; p0 += tp) {
      const int nv = min(tp, s.n - p0), ng = (nv + R - 1) / R;
      wonly::mbar_wait(r.full + r.slot, r.phase);
      const unsigned char* tile = r.data + (size_t)r.slot * C::TB;
      const float* ks = r.scl + r.slot * C::SCL;
      for (int gi = first_group<NW>(warp, dealt); gi < ng; gi += GU * NW) {
        // groups gi, gi + NW, .. (one past the tile reads row 0, unused)
        int t[GU];
        bool ok[GU];
        float v[GU][E];
#pragma unroll
        for (int u = 0; u < GU; ++u) {
          t[u] = (gi + u * NW) * R + kq;
          ok[u] = t[u] < nv;
          const int row = ok[u] ? t[u] : 0;
          if (s.i8) widen_i8<E>(tile + row * HD, p, ok[u], v[u]);
          else widen_bf16<E>(tile + row * 2 * HD, p, ok[u], v[u]);
        }
#pragma unroll
        for (int g = 0; g < GRP; ++g) {
          float d[GU];
#pragma unroll
          for (int u = 0; u < GU; ++u) {
            float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
            for (int e = 0; e < E; e += 2) {
              d0 = fmaf(q[g][e], v[u][e], d0);
              d1 = fmaf(q[g][e + 1], v[u][e + 1], d1);
            }
            d[u] = d0 + d1;
          }
#pragma unroll
          for (int o = 1; o < P; o <<= 1)
#pragma unroll
            for (int u = 0; u < GU; ++u) d[u] += __shfl_xor_sync(0xffffffffu, d[u], o);
#pragma unroll
          for (int u = 0; u < GU; ++u)
            if (ok[u]) {
              const float sv = s.i8 ? c.score(d[u], ks[t[u] * SST + s.so]) : d[u] * c.scale;
              if (p == 0) sc[g * nsc + s.t0 + p0 + t[u]] = sv;
              mx[g] = fmaxf(mx[g], sv);
            }
        }
      }
      __syncwarp();
      if (lane == 0) wonly::mbar_arrive(r.empty + r.slot);
      advance(r);
      dealt += ng;
    }
  }
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    float v = mx[g];
#pragma unroll
    for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red_max[warp * GRP + g] = v;
  }
}

// the block's max of each query's scores: the warps' in warp order, with
// `extra` (a score outside the tiles, or NEG_INF)
template <int NW, class C>
__device__ __forceinline__ void block_max(const float* red_max, float extra, float (&m)[C::GRP]) {
#pragma unroll
  for (int g = 0; g < C::GRP; ++g) {
    float v = extra;
    for (int w = 0; w < NW; ++w) v = fmaxf(v, red_max[w * C::GRP + g]);
    m[g] = v;
  }
}

// The value pass over the item's V tiles, by the attention warps: p =
// exp(s - m); the warp's sum of p per query into red_den[warp * GRP + g];
// its sum of bf16(p * v_scale) (int8) or bf16(p) (bf16) times v into
// part[(warp * GRP + g) * HD + d].
template <int NW, class C>
__device__ __forceinline__ void value_pass(const C& c, const Plan& pl, const float* sc, int nsc,
                           const float (&m)[C::GRP], float* part, float* red_den, Ring& r,
                           int warp) {
  constexpr int GRP = C::GRP, P = C::P, E = HD / P, R = 32 / P, SST = C::SST, GU = C::GU;
  const int lane = threadIdx.x & 31;
  const int kq = lane / P, p = lane % P;
  float o[GRP][E], den[GRP];
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    den[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) o[g][e] = 0.0f;
  }
  int dealt = 0;
  for (int si = 0; si < pl.ns; ++si) {
    const Seg s = pl.s[si];
    const int tp = tile_positions<C::TB>(s.i8);
    for (int p0 = 0; p0 < s.n; p0 += tp) {
      const int nv = min(tp, s.n - p0), ng = (nv + R - 1) / R;
      wonly::mbar_wait(r.full + r.slot, r.phase);
      const unsigned char* tile = r.data + (size_t)r.slot * C::TB;
      const float* vs = r.scl + r.slot * C::SCL;
      for (int gi = first_group<NW>(warp, dealt); gi < ng; gi += GU * NW) {
        int t[GU];
        bool ok[GU];
        float v[GU][E], vsc[GU];
#pragma unroll
        for (int u = 0; u < GU; ++u) {
          t[u] = (gi + u * NW) * R + kq;
          ok[u] = t[u] < nv;
          const int row = ok[u] ? t[u] : 0;
          if (s.i8) widen_i8<E>(tile + row * HD, p, ok[u], v[u]);
          else widen_bf16<E>(tile + row * 2 * HD, p, ok[u], v[u]);
          vsc[u] = ok[u] && s.i8 ? vs[t[u] * SST + s.sov] : 1.0f;
        }
#pragma unroll
        for (int g = 0; g < GRP; ++g) {
          float w[GU];
#pragma unroll
          for (int u = 0; u < GU; ++u) {
            const float pg = ok[u] ? expf(sc[g * nsc + s.t0 + p0 + t[u]] - m[g]) : 0.0f;
            if (p == 0) den[g] += pg;
            w[u] = bf16_round(s.i8 ? pg * vsc[u] : pg);
          }
#pragma unroll
          for (int e = 0; e < E; ++e) {
            float acc = o[g][e];
#pragma unroll
            for (int u = 0; u < GU; ++u) acc = fmaf(w[u], v[u][e], acc);
            o[g][e] = acc;
          }
        }
      }
      __syncwarp();
      if (lane == 0) wonly::mbar_arrive(r.empty + r.slot);
      advance(r);
      dealt += ng;
    }
  }
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
#pragma unroll
      for (int off = P; off < 32; off <<= 1) o[g][e] += __shfl_xor_sync(0xffffffffu, o[g][e], off);
      if (kq == 0) part[(warp * GRP + g) * HD + p * E + e] = o[g][e];
    }
    float d = den[g];
#pragma unroll
    for (int off = 16; off; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    if (lane == 0) red_den[warp * GRP + g] = d;
  }
}

// query g's value sum at dim d and its denominator: the warps' partials in
// warp order
template <int NW, class C>
__device__ __forceinline__ float out_sum(const float* part, int g, int d) {
  float o = 0.0f;
  for (int w = 0; w < NW; ++w) o += part[(w * C::GRP + g) * HD + d];
  return o;
}

template <int NW, class C>
__device__ __forceinline__ float den_sum(const float* red_den, int g) {
  float s = 0.0f;
  for (int w = 0; w < NW; ++w) s += red_den[w * C::GRP + g];
  return s;
}

// ---------------------------------------------------------- host helpers

// a `rank`-D tensor of `type` at `base`, innermost first (dims[i] elements,
// strides[i] bytes between steps of dimension i + 1), copied in boxes of
// box[0..rank) without swizzle; elements outside the tensor read as zeros
inline bool encode_plain(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                         const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const wonly::EncodeTiled fn = wonly::encode_tiled();
  if (!fn) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace dattn
