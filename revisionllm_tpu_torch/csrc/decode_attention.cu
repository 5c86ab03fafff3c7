// K3: single-token decode attention over [prompt | generated] for one layer.
//
// Replaces the Pallas kernel revisionllm_tpu/ops/decode_attention.py:40
// _decode_attn_kernel (entry decode_attention :145, pallas_call :170), a study
// kernel with one shared max and a two-piece softmax, and generalises it to
// what the serving path computes as einsums in
// revisionllm_tpu/models/llama.py:686-749 (decode_step_split):
//   - the prompt cache is int8 with per-(position, head) scales: k_scale is
//     folded into the score, v_scale into the probability (p1v at :727-730);
//   - the prompt is masked at pos < mask_lens[b], the gen cache at slot <= step;
//   - the bf16 gen cache already holds this step's k/v;
//   - one max is shared by both pieces, and group = H / KH queries read each
//     kv head (GQA).
// The public layout stays [B, S, KH, hd] with scales [B, S, KH] (one layer of
// the [L, B, S, KH, hd] cache); nothing is transposed per step.
//
// What bounds it on the H100: the bytes of the int8 prompt cache. At B = 64,
// S = 318, KH = 32, hd = 128 one layer-step reads about 167 MB, 50 us at
// 3.35 TB/s, against a few MFLOP. It runs csrc/decode_attn_common.cuh's core
// (the design is described there): KBLOCKS blocks an SM, each KWARPS
// attention warps and a producer warp, walk the (batch row, kv head) items
// blockIdx.x, + gridDim.x, ...; the producer copies the prompt's K and V in
// tiles of KTILE bytes with TMA (a 4-D tensor map (hd, KH, S, B), one box a
// whole tile, boxes of TAIL positions for a tile's ragged end, so positions
// past mask_lens[b] are read at most TAIL - 1 a tile) and the gen slots
// <= step the same way, into a KSTAGES-slot ring; the scales ride with their
// tiles (a box of SST heads of the 3-D tensor (KH, S, B) from a multiple of
// SST, 16-byte aligned: a box's innermost start is). The score is (q . k) * scale * k_scale; p1 * v_scale and p2 round to
// bf16 before the value sums, as the einsum path casts p1v and p2.
//
// Groups 1, 2, 4 and 8 run that core. Group 16 (ChatGLM2-6B: 32 query heads
// over 2 kv heads) has a kernel of its own, decode_attn_kernel_g16. At
// ChatGLM2's decode step (B 8, KH 2, S 428, step 11) an item is 16 queries
// over about 440 positions, and there are 16 items for 132 SMs: the work
// (1.8 MB, 29 MFLOP) is bound by latency, not by bytes. The design:
//   1. A thread-block cluster an item: the item's walk (the S prompt
//      positions, then the gen slots 0..step) is cut into `split` contiguous
//      ranges, one a block (rank), split = S + step + 1 over KG16_ROUND
//      positions rounded up, at most KG16_CLUSTER: 7 ranks and 112 blocks at
//      ChatGLM2's shape, each block one round of at most 64 positions. The
//      ranges do not depend on mask_lens, so the copies start at once; a
//      prompt position at or past mask_lens[b] is copied but never used: its
//      score, p, K and V are taken as masked or zero and its scales are not
//      read, so whatever the cache holds there (NaN included) adds nothing.
//   2. A block's 4 warps take slices of KG16_SLICE = 16 positions (a warp a
//      slice a round). Every copy of a round (K and V rows, 16-byte
//      cp.async, and the int8 prompt's scales, 4-byte cp.async, read in
//      place from [B, S, KH]: no padding, no tensor map) is issued up front
//      and waited for once; rows are staged KG16_ROW bytes apart, so the
//      lanes of a fragment load hit distinct banks. A rank of more rounds
//      streams them twice through KG16_STAGES stages: K, then K and V.
//   3. Tensor cores for the 16 queries (mma.sync m16n8k16, bf16 in, f32
//      out). Scores: q [16 x 128] as A, a K row as B, the head dims taken in
//      an order that gives lane (g, t) dims 32 t .. 32 t + 31 of its
//      position g (one 32-byte read of an int8 row), and q read in the same
//      order from global memory. Int8 is widened into bf16x2 exactly (one
//      prmt, two masks and a bf16x2 add a pair). The score is
//      (q . k) * scale * k_scale.
//   4. One max for the item, as in the plain version: each block's max of
//      each query (its warps' in warp order), exchanged over distributed
//      shared memory after a cluster barrier (ranks in order). So p =
//      exp(s - max) and its bf16 rounding are the plain version's.
//   5. Values: bf16(p * v_scale) (bf16(p) for a bf16 position) as A,
//      straight from the score fragments; V as B with output dim 16 g + j in
//      n-tile j, so a lane reads 16 contiguous dims of each of its 4 rows. A
//      position past the range is masked on p itself, so a wholly masked
//      slice, warp or rank adds nothing.
//   6. The block sums its warps' outputs and denominators in warp order;
//      after a cluster barrier each rank sums its share of the 16 x 128
//      outputs over every rank's shared memory (ld.shared::cluster) in rank
//      order, divides and stores bf16. No atomics: two calls give the same
//      bits.
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/decode_attention.py.

#include "decode_attn_common.cuh"

namespace {

using dattn::HD;

constexpr int KWARPS = 4;                  // attention warps a block
constexpr int KSTAGES = 3;                 // ring slots a block
constexpr int KBLOCKS = 4;                 // blocks an SM
constexpr int KTILE = 8192;                // bytes of a ring tile
constexpr int KGU = 2;                     // position groups a warp takes at a time
constexpr int NTHREADS = 32 * KWARPS + 32; // and the producer warp

constexpr int SST = 4;                     // heads of a scale box: floats a position (a power of 2)
constexpr int SCL = dattn::tile_positions<KTILE>(1) * SST;  // scale floats a slot

// the tensor maps: prompt k and v in boxes of a tile (0, 1) and of TAIL
// positions (2, 3); gen k and v in boxes of TAIL slots (4, 5); k and v
// scales in boxes of SST heads and a tile's positions (6, 7)
struct KArgs {
  CUtensorMap tm[8];
  const __nv_bfloat16* q;
  const float* ksc;
  const float* vsc;
  const int* lens;
  __nv_bfloat16* out;
  int B, S, G, KH, step;
  float scale;
};

template <typename PT, int GRP_>
struct K3 {
  static constexpr int TB = KTILE, GRP = GRP_, SST = ::SST, SCL = ::SCL, GU = KGU;
  static constexpr int P = GRP_ == 1 ? 8 : GRP_ == 2 ? 16 : 32;
  static constexpr int I8 = sizeof(PT) == 1;
  const KArgs& a;
  float scale;

  // the prompt (plen positions, int8 with scales or bf16; the item's head
  // in its scale box), then the gen slots 0..step (bf16), their scores at
  // plen ..
  __device__ dattn::Plan plan_of(int item, int plen) const {
    const int so = item % a.KH & (SST - 1);
    dattn::Plan p;
    p.ns = 2;
    p.s[0] = {plen, 0, I8, so, so};
    p.s[1] = {a.step + 1, plen, 0, 0, 0};
    return p;
  }
  __device__ int plen_of(int item) const { return max(0, min(__ldg(a.lens + item / a.KH), a.S)); }
  __device__ float score(float d, float ks) const { return d * scale * ks; }

  // tile (side, segment si, positions p0 .. p0 + nv - 1) of item (b, kh):
  // one box of a whole tile, or TAIL-position boxes of a ragged one, and
  // for the int8 prompt its scales
  __device__ void issue(int item, int side, int si, int p0, int nv, unsigned char* dst,
                        float* sdst, uint64_t* bar) const {
    const int b = item / a.KH, kh = item % a.KH;
    const uint64_t pol = dattn::evict_first();
    const int row = si == 0 ? HD * (int)sizeof(PT) : 2 * HD;  // bytes a position
    const bool whole = si == 0 && nv == dattn::tile_positions<TB>(I8);
    const bool scaled = si == 0 && I8;
    const int boxes = whole ? 1 : (nv + dattn::TAIL - 1) / dattn::TAIL;
    wonly::mbar_arrive_expect(bar, (uint32_t)((whole ? TB : boxes * dattn::TAIL * row)
                                              + (scaled ? SCL * 4 : 0)));
    if (whole) {
      dattn::tma_load_4d(dst, &a.tm[side], 0, kh, p0, b, bar, pol);
    } else {
      const CUtensorMap* map = &a.tm[(si == 0 ? 2 : 4) + side];
      for (int i = 0; i < boxes; ++i)
        dattn::tma_load_4d(dst + i * dattn::TAIL * row, map, 0, kh, p0 + i * dattn::TAIL, b, bar,
                           pol);
    }
    if (scaled) dattn::tma_load_3d(sdst, &a.tm[6 + side], kh & -SST, p0, b, bar, pol);
  }
};

// the barrier of the attention warps (the producer warp is not in it)
__device__ __forceinline__ void attn_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * KWARPS) : "memory");
}

// shared memory: the ring's tiles and scales, its barriers, q [2][GRP][HD]
// (by item parity), the scores [GRP][nsc], the warps' partial outputs
// [KWARPS][GRP][HD], maxima and denominators [KWARPS][GRP] (mirrored by
// ops/decode_attention.py)
__host__ __device__ constexpr size_t k3_smem(int nsc, int grp) {
  return 128 + (size_t)KSTAGES * (KTILE + SCL * 4 + 16) + 4 * (size_t)(2 * grp * HD)
         + 4 * (size_t)grp * nsc + 4 * (size_t)KWARPS * grp * (HD + 2);
}

template <typename PT, int GRP>
__global__ void __launch_bounds__(NTHREADS, KBLOCKS)
    decode_attn_kernel(const __grid_constant__ KArgs a) {
  using C = K3<PT, GRP>;
  constexpr int NT = 32 * KWARPS;
  constexpr int QCH = GRP * HD / 8;             // q's 16-byte chunks
  constexpr int CH = (QCH + NT - 1) / NT;       // ... a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (wonly::smem_addr(smem_raw) & 127)) & 127);
  const int nsc = a.S + a.G;
  dattn::Ring r;
  r.data = smem;
  r.scl = reinterpret_cast<float*>(smem + (size_t)KSTAGES * KTILE);
  r.full = reinterpret_cast<uint64_t*>(r.scl + KSTAGES * SCL);
  r.empty = r.full + KSTAGES;
  r.stages = KSTAGES;
  r.count = r.slot = r.phase = 0;
  float* qbuf = reinterpret_cast<float*>(r.empty + KSTAGES);
  float* sc = qbuf + 2 * GRP * HD;
  float* part = sc + GRP * nsc;
  float* red_max = part + KWARPS * GRP * HD;
  float* red_den = red_max + KWARPS * GRP;
  if (threadIdx.x == 0) dattn::init_ring(r, KWARPS);
  __syncthreads();
  const C c{a, a.scale};
  const int items = a.B * a.KH;
  const int tid = threadIdx.x;
  if (tid >= NT) {  // the producer warp: one thread issues the copies
    if (tid == NT) dattn::produce(c, r, blockIdx.x, gridDim.x, items);
    return;
  }
  uint4 qpre[CH];
  int plen_pre = 0;
  auto prefetch = [&](int item) {
    if (item >= items) return;
#pragma unroll
    for (int k = 0; k < CH; ++k)
      if (tid + k * NT < QCH)
        qpre[k] = __ldg(reinterpret_cast<const uint4*>(a.q + (size_t)item * GRP * HD) + tid + k * NT);
    plen_pre = c.plen_of(item);
  };
  prefetch(blockIdx.x);
  int par = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, par ^= 1) {
    float* qs = qbuf + par * GRP * HD;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int i = tid + k * NT;
      if (i < QCH) {
        const uint32_t w[4] = {qpre[k].x, qpre[k].y, qpre[k].z, qpre[k].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qs[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
          qs[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
        }
      }
    }
    const dattn::Plan pl = c.plan_of(item, plen_pre);
    attn_sync();  // q is in, the last item's outputs are read
    dattn::score_pass<KWARPS>(c, pl, qs, sc, nsc, red_max, r, tid >> 5);
    attn_sync();  // the scores and the warps' maxima
    prefetch(item + gridDim.x);
    float m[GRP];
    dattn::block_max<KWARPS, C>(red_max, dattn::NEG_INF, m);
    dattn::value_pass<KWARPS>(c, pl, sc, nsc, m, part, red_den, r, tid >> 5);
    attn_sync();  // the warps' partial outputs and denominators
    for (int i = tid; i < GRP * HD; i += NT) {
      const int g = i / HD;
      const float o = dattn::out_sum<KWARPS, C>(part, g, i % HD);
      a.out[(size_t)item * GRP * HD + i] =
          __float2bfloat16_rn(o / dattn::den_sum<KWARPS, C>(red_den, g));
    }
  }
}

template <typename PT, int GRP>
cudaError_t launch(KArgs& a, cudaStream_t stream) {
  auto kern = decode_attn_kernel<PT, GRP>;
  const size_t smem = k3_smem(a.S + a.G, GRP);
  static size_t allowed = 0;
  static int sms = 0;
  cudaError_t err;
  if (smem > allowed) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  if (!sms) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NTHREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int items = a.B * a.KH;
  const int grid = min(items, sms * min(per_sm, KBLOCKS));
  kern<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// the 4-D tensor (hd, KH, N, B) of `type` (esize bytes) at `base`, boxes of
// (hd, 1, rows, 1)
bool encode_cache(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* base, int B,
                  int N, int KH, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)KH, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)HD * esize;
  const cuuint64_t strides[3] = {row, row * KH, row * KH * N};
  const cuuint32_t box[4] = {(cuuint32_t)HD, 1, (cuuint32_t)rows, 1};
  return dattn::encode_plain(map, type, base, 4, dims, strides, box);
}

// the 3-D tensor (KH, S, B) of f32 scales at `base`, boxes of (SST, rows, 1)
bool encode_scales(CUtensorMap* map, const void* base, int B, int S, int KH, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)KH, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)KH * 4, (cuuint64_t)KH * S * 4};
  const cuuint32_t box[3] = {(cuuint32_t)SST, (cuuint32_t)rows, 1};
  return dattn::encode_plain(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, 3, dims, strides, box);
}

template <typename PT>
cudaError_t by_group(int group, KArgs& a, const void* pk, const void* pv, const void* gk,
                     const void* gv, cudaStream_t s) {
  constexpr int es = sizeof(PT);
  const CUtensorMapDataType pt = es == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int rows = dattn::tile_positions<KTILE>(es == 1);
  if (!encode_cache(&a.tm[0], pt, es, pk, a.B, a.S, a.KH, rows) ||
      !encode_cache(&a.tm[1], pt, es, pv, a.B, a.S, a.KH, rows) ||
      !encode_cache(&a.tm[2], pt, es, pk, a.B, a.S, a.KH, dattn::TAIL) ||
      !encode_cache(&a.tm[3], pt, es, pv, a.B, a.S, a.KH, dattn::TAIL) ||
      !encode_cache(&a.tm[4], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, gk, a.B, a.G, a.KH, dattn::TAIL) ||
      !encode_cache(&a.tm[5], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, gv, a.B, a.G, a.KH, dattn::TAIL))
    return cudaErrorInvalidValue;
  // the scales' rows hold KH rounded up to SST heads (a TMA stride is a
  // multiple of 16 bytes): another KH comes padded by the caller
  const int khs = (a.KH + SST - 1) / SST * SST;
  if (es == 1 && (!encode_scales(&a.tm[6], a.ksc, a.B, a.S, khs, rows) ||
                  !encode_scales(&a.tm[7], a.vsc, a.B, a.S, khs, rows)))
    return cudaErrorInvalidValue;
  switch (group) {
    case 1: return launch<PT, 1>(a, s);
    case 2: return launch<PT, 2>(a, s);
    case 4: return launch<PT, 4>(a, s);
    case 8: return launch<PT, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------- group 16

constexpr int KG16_WARPS = 4;     // warps a block
constexpr int KG16_SLICE = 16;    // positions a warp's slice (one k16 step of the value product)
constexpr int KG16_STAGES = 2;    // position rounds in flight
constexpr int KG16_CLUSTER = 8;   // ranks (blocks of a cluster) an item is split over, at most
constexpr int KG16_ROW = 272;     // bytes a staged K or V row: 256 (bf16) and 16 (banks)
constexpr int KG16_NT = 32 * KG16_WARPS;
constexpr int KG16_ROUND = KG16_WARPS * KG16_SLICE;  // positions a round (a stage)
constexpr int KG16_Q = 16;                           // queries an item
// a stage: K rows, V rows, then (k_scale, v_scale) a position
constexpr int KG16_STAGE = 2 * KG16_ROUND * KG16_ROW + KG16_ROUND * 8;
// shared memory: the stages (the warps' partial outputs [WARPS][16 x HD]
// over them once the positions are done); the inbox of the outputs this
// rank sums (every rank's share of the 16 x HD, [split][slots] float4s,
// split x slots <= 16 HD / 4 + CLUSTER), of every rank's max and sum
// [2][CLUSTER][16]; the cluster's max [16]; the warps' max and sum
// [2][WARPS][16]
constexpr int KG16_SMEM = KG16_STAGES * KG16_STAGE + (KG16_Q * HD + 4 * KG16_CLUSTER) * 4
                          + 2 * KG16_CLUSTER * KG16_Q * 4 + KG16_Q * 4 + 2 * KG16_WARPS * KG16_Q * 4;
static_assert(KG16_WARPS * KG16_Q * HD * 4 <= KG16_STAGES * KG16_STAGE, "partials fit the stages");
static_assert(KG16_NT >= 2 * KG16_ROUND, "a thread copies a round's scale");

struct GArgs {
  const __nv_bfloat16* q;
  const unsigned char* pk;
  const unsigned char* pv;
  const float* ksc;
  const float* vsc;
  const unsigned char* gk;
  const unsigned char* gv;
  const int* lens;
  __nv_bfloat16* out;
  int S, G, KH, step;
  float scale;
};

// ranks an item's walk is split over: one round of KG16_ROUND positions a
// rank while S + step + 1 allows (ops/decode_attention.py mirrors it)
__host__ __device__ constexpr int g16_split(int S, int step) {
  return (S + step + KG16_ROUND) / KG16_ROUND < KG16_CLUSTER
             ? (S + step + KG16_ROUND) / KG16_ROUND : KG16_CLUSTER;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(wonly::smem_addr(dst)), "l"(src) : "memory");
}

// stores into another block's shared memory (a cluster address from
// wonly::cluster_addr)
__device__ __forceinline__ void st_cluster_f1(uint32_t a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(a), "f"(v) : "memory");
}

__device__ __forceinline__ void st_cluster_f4(uint32_t a, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// the two halves of a cluster barrier: the arrival (relaxed: it orders no
// memory) and the wait
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// c += a (16 x 16, row major) b (16 x 8, column major): bf16 in, f32 out
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bytes J (low half) and J + 1 (high half) of x, int8, as an exact bf16x2:
// 0x4300 | (b & 127) is 128 + (b & 127), 0xC300 | (b & 128) is -128 or -256
// by the sign, and one bf16x2 add makes b (wonly::s8x2's sum)
template <int J>
__device__ __forceinline__ uint32_t s8pair(uint32_t x) {
  const uint32_t p = __byte_perm(x, 0u, J | ((J + 1) << 8));
  const uint32_t v = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t s = (p & 0x00800080u) | 0xC300C300u;
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(v), "r"(s));
  return d;
}

// dims [d0, d0 + 2 N) of a staged row as N bf16x2 words (word i: dims
// d0 + 2i (low half) and d0 + 2i + 1): int8 (i8) widened, bf16 as it is;
// zeros for a position outside the range (!live)
template <int N>
__device__ __forceinline__ void row_words(const unsigned char* row, int d0, bool i8, bool live,
                                          uint32_t (&w)[N]) {
  if (!live) {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = 0u;
  } else if (i8) {
#pragma unroll
    for (int k = 0; k < N / 8; ++k) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + d0 + 16 * k);
      const uint32_t x[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[8 * k + 2 * j] = s8pair<0>(x[j]);
        w[8 * k + 2 * j + 1] = s8pair<2>(x[j]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + 2 * d0 + 16 * k);
      w[4 * k] = u.x;
      w[4 * k + 1] = u.y;
      w[4 * k + 2] = u.z;
      w[4 * k + 3] = u.w;
    }
  }
}

// B fragments of the value product for V rows lo and hi of a slice:
// b[j] = (V[lo][16 g + j], V[hi][16 g + j]) as bf16x2, zeros for a row
// outside the range; two int8 rows pair their bytes straight (wonly::s8x2)
__device__ __forceinline__ void v_pairs(const unsigned char* lo, const unsigned char* hi, int g,
                                        bool i8lo, bool i8hi, bool livelo, bool livehi,
                                        uint32_t (&b)[HD / 8]) {
  if (i8lo && i8hi && livelo && livehi) {
    const uint4 x = *reinterpret_cast<const uint4*>(lo + 16 * g);
    const uint4 y = *reinterpret_cast<const uint4*>(hi + 16 * g);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      b[4 * k] = wonly::s8x2<0>(xs[k], ys[k]);
      b[4 * k + 1] = wonly::s8x2<1>(xs[k], ys[k]);
      b[4 * k + 2] = wonly::s8x2<2>(xs[k], ys[k]);
      b[4 * k + 3] = wonly::s8x2<3>(xs[k], ys[k]);
    }
  } else {
    uint32_t wl[8], wh[8];
    row_words<8>(lo, 16 * g, i8lo, livelo, wl);
    row_words<8>(hi, 16 * g, i8hi, livehi, wh);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      b[j] = __byte_perm(wl[j >> 1], wh[j >> 1], (j & 1) ? 0x7632u : 0x5410u);
  }
}

// q's A fragments of item `item` for this lane (g, t): k step kk holds
// words 2 kk and 2 kk + 1 of dims 32 t .. 32 t + 31 of rows g (a0, a2) and
// g + 8 (a1, a3)
__device__ __forceinline__ void load_qa(const __nv_bfloat16* q, int item, uint32_t (&qa)[HD / 16][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const uint4* q0 = reinterpret_cast<const uint4*>(q + ((size_t)item * KG16_Q + g) * HD + 32 * tq);
  const uint4* q1 = q0 + 8 * HD / 8;  // row g + 8
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 u0 = __ldg(q0 + k), u1 = __ldg(q1 + k);
    qa[2 * k][0] = u0.x; qa[2 * k][2] = u0.y; qa[2 * k + 1][0] = u0.z; qa[2 * k + 1][2] = u0.w;
    qa[2 * k][1] = u1.x; qa[2 * k][3] = u1.y; qa[2 * k + 1][1] = u1.z; qa[2 * k + 1][3] = u1.w;
  }
}

// whether walk position t of a range ending at t1 is live: a prompt
// position below the mask length, or a gen slot (the walk's S prompt
// positions, then the gen slots 0..step)
__device__ __forceinline__ bool g16_live(int t, int t1, int S, int plen) {
  return t < t1 && (t >= S || t < plen);
}

// the scores of queries g (h 0) and g + 8 (h 1) at positions 8 nt + 2t + e
// of a slice (c[nt][2 h + e]): K's B fragments from the staged rows (row j
// at krows + j KG16_ROW; the lane's position g of each n-tile), q's A
// fragments qa, then (q . k) * scale * k_scale (int8 prompt) or
// (q . k) * scale; NEG_INF where masked or past the range
template <bool I8>
__device__ __forceinline__ void slice_scores(const unsigned char* krows, const float* scl,
                                             const uint32_t (&qa)[HD / 16][4], int tw, int t1,
                                             int S, int plen, float scale, float (&c)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int j = 8 * nt + g, t = tw + j;
    uint32_t w[16];
    row_words<16>(krows + j * KG16_ROW, 32 * tq, I8 && t < S, g16_live(t, t1, S, plen), w);
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) mma16816(c[nt], qa[kk], w[2 * kk], w[2 * kk + 1]);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * nt + 2 * tq + e, t = tw + j;
      const bool live = g16_live(t, t1, S, plen), pr = live && I8 && t < S;
      const float ks = pr ? scl[2 * j] : 1.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d = c[nt][2 * h + e] * scale;
        c[nt][2 * h + e] = live ? (pr ? d * ks : d) : dattn::NEG_INF;
      }
    }
}

// Every copy of load li of a rank's range [t0, t1) of item (b, kh) into
// its stage: K rows, V rows (pass 1, or a range of one round) (a prompt row
// of PROW bytes, a gen row of 256: a thread takes one 16-byte column of
// every few rows), then the int8 prompt's (k_scale, v_scale). One round is
// loaded once and read by both passes; more rounds are loaded for each
// pass, K (pass 0) then K and V (pass 1).
template <typename PT>
__device__ __forceinline__ void g16_issue(const GArgs& a, unsigned char* smem, int li, int rounds,
                                          int t0, int t1, int b, int kh) {
  constexpr int PROW = HD * (int)sizeof(PT), PC = PROW / 16;
  const int tid = threadIdx.x;
  unsigned char* st = smem + (li % KG16_STAGES) * KG16_STAGE;
  const int rd = li % rounds, sides = li >= rounds || rounds == 1 ? 2 : 1;
  const int base = t0 + rd * KG16_ROUND, cnt = min(KG16_ROUND, t1 - base);
  const int np = max(0, min(cnt, a.S - base));
  {
    const int per = sides * PC, c = tid % per, side = c / PC, cc = c % PC;
    const unsigned char* src = (side ? a.pv : a.pk)
                               + ((size_t)(b * a.S + base) * a.KH + kh) * PROW + cc * 16;
    unsigned char* dst = st + side * KG16_ROUND * KG16_ROW + cc * 16;
    for (int p = tid / per; p < np; p += KG16_NT / per)
      wonly::cp_async16(dst + p * KG16_ROW, src + (size_t)p * a.KH * PROW, true);
  }
  if (cnt > np) {  // gen rows: slots base + np - S ..
    const int per = sides * 16, c = tid % per, side = c / 16, cc = c % 16;
    const unsigned char* src = (side ? a.gv : a.gk) + cc * 16
        + ((size_t)(b * a.G + base + np - a.S) * a.KH + kh) * (2 * HD);
    unsigned char* dst = st + (side * KG16_ROUND + np) * KG16_ROW + cc * 16;
    for (int p = tid / per; p < cnt - np; p += KG16_NT / per)
      wonly::cp_async16(dst + p * KG16_ROW, src + (size_t)p * a.KH * (2 * HD), true);
  }
  if (sizeof(PT) == 1) {
    float* sc = reinterpret_cast<float*>(st + 2 * KG16_ROUND * KG16_ROW);
    const int p = tid / sides, side = tid % sides;
    if (p < np)
      cp_async4(sc + 2 * p + side, (side ? a.vsc : a.ksc) + (size_t)(b * a.S + base + p) * a.KH + kh);
  }
}

// One item (blockIdx.y: row b, kv head kh) over a cluster of gridDim.x
// ranks (blockIdx.x): this rank's range [t0, t1) of the item's walk, in
// rounds of KG16_ROUND positions, a slice a warp. Pass 0: the scores and
// each query's max; the cluster's max. Pass 1: the scores again (kept in
// registers when there is one round), p = exp(s - max) and the value
// product. Then the sums of the warps and of the ranks.
// Lane (g, t) of a warp (g = lane / 4, t = lane % 4) holds, in the m16n8k16
// layouts: q rows g, g + 8 at dims 32 t + 4 kk .. + 3 (A of k step kk);
// K of position g of an n-tile at those dims (B); the scores of queries g,
// g + 8 at positions 2 t, 2 t + 1 of each n-tile (C, then A of the value
// product over the slice's 16 positions); V rows 2 t, 2 t + 1, 2 t + 8,
// 2 t + 9 at dim 16 g + j (B of n-tile j); outputs of queries g, g + 8 at
// dims 16 (2 t) + j and 16 (2 t + 1) + j (C of n-tile j).
template <typename PT>
__global__ void __launch_bounds__(KG16_NT, 1) decode_attn_kernel_g16(const __grid_constant__ GArgs a) {
  constexpr bool I8 = sizeof(PT) == 1;
  constexpr int OUT4 = KG16_Q * HD / 4;        // float4s of an item's output
  extern __shared__ __align__(16) unsigned char g16_smem[];
  float* part = reinterpret_cast<float*>(g16_smem);  // [WARPS][OUT4 float4s], after pass 1
  float4* inbox = reinterpret_cast<float4*>(g16_smem + KG16_STAGES * KG16_STAGE);
  float* inbox_m = reinterpret_cast<float*>(inbox + OUT4 + KG16_CLUSTER);  // [CLUSTER][16]
  float* inbox_l = inbox_m + KG16_CLUSTER * KG16_Q;                        // [CLUSTER][16]
  float* mg = inbox_l + KG16_CLUSTER * KG16_Q;                             // [16]
  float* red_m = mg + KG16_Q;                                              // [WARPS][16]
  float* red_l = red_m + KG16_WARPS * KG16_Q;                              // [WARPS][16]

  cluster_arrive_relaxed();  // this block has started (waited for before a remote store)
  const int split = gridDim.x, rank = blockIdx.x, item = blockIdx.y;
  const int b = item / a.KH, kh = item % a.KH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  uint32_t qa[HD / 16][4];
  load_qa(a.q, item, qa);
  const int plen = max(0, min(__ldg(a.lens + b), a.S));  // used first by the masks
  const int n = a.S + a.step + 1;
  const int chunk = (n + split - 1) / split;
  const int t0 = min(n, rank * chunk), t1 = min(n, t0 + chunk);
  const int rounds = (t1 - t0 + KG16_ROUND - 1) / KG16_ROUND;
  const int loads = rounds > 1 ? 2 * rounds : rounds;  // g16_issue's

#pragma unroll
  for (int li = 0; li < KG16_STAGES; ++li) {
    if (li < loads) g16_issue<PT>(a, g16_smem, li, rounds, t0, t1, b, kh);
    wonly::cp_async_commit();
  }
  const int ws = warp * KG16_SLICE;  // the warp's slice in a stage
  float c[2][4];                     // its scores

  // pass 0: each query's max over the warp's slices
  float mx[2] = {dattn::NEG_INF, dattn::NEG_INF};
  for (int rd = 0; rd < rounds; ++rd) {
    wonly::cp_async_wait<KG16_STAGES - 1>();
    __syncthreads();  // load rd has landed
    const unsigned char* st = g16_smem + (rd % KG16_STAGES) * KG16_STAGE;
    const int tw = t0 + rd * KG16_ROUND + ws;  // the slice's first position
    if (tw < t1) {
      slice_scores<I8>(st + ws * KG16_ROW,
                       reinterpret_cast<const float*>(st + 2 * KG16_ROUND * KG16_ROW) + 2 * ws,
                       qa, tw, t1, a.S, plen, a.scale, c);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) mx[r >> 1] = fmaxf(mx[r >> 1], c[nt][r]);
    }
    if (rounds > 1) {
      __syncthreads();  // the stage is read
      if (rd + KG16_STAGES < loads) g16_issue<PT>(a, g16_smem, rd + KG16_STAGES, rounds, t0, t1, b, kh);
      wonly::cp_async_commit();
    }
  }
  // the block's max (warps in order) into every rank's inbox, then the
  // cluster's (ranks in order)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  if (tq == 0) {
    red_m[warp * KG16_Q + g] = mx[0];
    red_m[warp * KG16_Q + g + 8] = mx[1];
  }
  __syncthreads();
  cluster_wait();  // every rank has started
  if (tid < KG16_Q) {
    float m = red_m[tid];
#pragma unroll
    for (int w = 1; w < KG16_WARPS; ++w) m = fmaxf(m, red_m[w * KG16_Q + tid]);
    for (int r = 0; r < split; ++r)
      st_cluster_f1(wonly::cluster_addr(inbox_m + rank * KG16_Q + tid, r), m);
  }
  wonly::cluster_sync();  // every rank's max is in
  if (tid < KG16_Q) {
    float m = inbox_m[tid];
    for (int r = 1; r < split; ++r) m = fmaxf(m, inbox_m[r * KG16_Q + tid]);
    mg[tid] = m;
  }
  __syncthreads();
  const float m[2] = {mg[g], mg[g + 8]};

  // pass 1: p = exp(s - m) (0 past the range), summed unrounded; the value
  // product's A bf16(p * v_scale) (int8 prompt) or bf16(p)
  float l[2] = {0.0f, 0.0f};
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  for (int rd = 0; rd < rounds; ++rd) {
    const int li = rounds > 1 ? rounds + rd : 0;
    if (rounds > 1) {
      wonly::cp_async_wait<KG16_STAGES - 1>();
      __syncthreads();  // load li has landed
    }
    const unsigned char* st = g16_smem + (li % KG16_STAGES) * KG16_STAGE;
    const float* scl = reinterpret_cast<const float*>(st + 2 * KG16_ROUND * KG16_ROW) + 2 * ws;
    const int tw = t0 + rd * KG16_ROUND + ws;
    if (tw < t1) {
      if (rounds > 1) {  // q again (not kept live through the pass)
        uint32_t qb[HD / 16][4];
        load_qa(a.q, item, qb);
        slice_scores<I8>(st + ws * KG16_ROW, scl, qb, tw, t1, a.S, plen, a.scale, c);
      }
      // V rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of the slice
      const unsigned char* vrows = st + (KG16_ROUND + ws) * KG16_ROW;
      uint32_t vb[2][HD / 8];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = 2 * tq + 8 * r, t = tw + j;
        v_pairs(vrows + j * KG16_ROW, vrows + (j + 1) * KG16_ROW, g, I8 && t < a.S,
                I8 && t + 1 < a.S, g16_live(t, t1, a.S, plen), g16_live(t + 1, t1, a.S, plen),
                vb[r]);
      }
      float wv[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * tq + e, t = tw + j;
          // a masked row's scale is never used (the cache past mask_lens
          // may hold anything, NaN included)
          const bool live = g16_live(t, t1, a.S, plen), pr = live && I8 && t < a.S;
          const float vs = pr ? scl[2 * j + 1] : 1.0f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p = live ? expf(c[nt][2 * h + e] - m[h]) : 0.0f;
            l[h] += p;
            wv[nt][2 * h + e] = pr ? p * vs : p;
          }
        }
      const uint32_t pa[4] = {wonly::pack_bf16(wv[0][0], wv[0][1]), wonly::pack_bf16(wv[0][2], wv[0][3]),
                              wonly::pack_bf16(wv[1][0], wv[1][1]), wonly::pack_bf16(wv[1][2], wv[1][3])};
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) mma16816(o[j], pa, vb[0][j], vb[1][j]);
    }
    if (rounds > 1) {
      __syncthreads();
      if (li + KG16_STAGES < loads) g16_issue<PT>(a, g16_smem, li + KG16_STAGES, rounds, t0, t1, b, kh);
      wonly::cp_async_commit();
    }
  }

  // the warp's sums over its lanes; its outputs over the stages (every
  // load is read, none is in flight) as float4 (h, e, jc, lane) = queries
  // g + 8 h, dims 32 t + 16 e + 4 jc .. + 3: a warp's store is 512
  // contiguous bytes
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (tq == 0) {
    red_l[warp * KG16_Q + g] = l[0];
    red_l[warp * KG16_Q + g + 8] = l[1];
  }
  __syncthreads();  // the last stage is read
  {
    float4* pw = reinterpret_cast<float4*>(part) + warp * OUT4 + lane;
#pragma unroll
    for (int r = 0; r < 4; ++r)  // r = 2 h + e
#pragma unroll
      for (int jc = 0; jc < 4; ++jc)
        pw[(r * 4 + jc) * 32] = make_float4(o[4 * jc][r], o[4 * jc + 1][r], o[4 * jc + 2][r],
                                            o[4 * jc + 3][r]);
  }
  __syncthreads();
  // the block's outputs and sums, its warps' in warp order, into their
  // owners' inboxes: float4 k to rank k % split, slot k / split of this
  // rank's row of the inbox
  const int slots = (OUT4 + split - 1) / split;
  for (int k = tid; k < OUT4; k += KG16_NT) {
    const float4* pk = reinterpret_cast<const float4*>(part) + k;
    float4 s = pk[0];
#pragma unroll
    for (int w = 1; w < KG16_WARPS; ++w) {
      const float4 v = pk[w * OUT4];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    st_cluster_f4(wonly::cluster_addr(inbox + rank * slots + k / split, k % split), s);
  }
  if (tid < KG16_Q) {
    float s = red_l[tid];
#pragma unroll
    for (int w = 1; w < KG16_WARPS; ++w) s += red_l[w * KG16_Q + tid];
    for (int r = 0; r < split; ++r)
      st_cluster_f1(wonly::cluster_addr(inbox_l + rank * KG16_Q + tid, r), s);
  }
  wonly::cluster_sync();  // every rank's outputs and sums are in
  // this rank's float4s, summed over the ranks in rank order, divided, bf16
  for (int k = rank + split * tid; k < OUT4; k += split * KG16_NT) {
    const int ln = k % 32, jc = (k / 32) % 4, e = (k / 128) % 2, h = k / 256;
    const int row = ln / 4 + 8 * h, d0 = 32 * (ln % 4) + 16 * e + 4 * jc;
    float4 s = inbox[k / split];
    float den = inbox_l[row];
    for (int r = 1; r < split; ++r) {
      const float4 v = inbox[r * slots + k / split];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      den += inbox_l[r * KG16_Q + row];
    }
    uint2 u;
    u.x = wonly::pack_bf16(s.x / den, s.y / den);
    u.y = wonly::pack_bf16(s.z / den, s.w / den);
    *reinterpret_cast<uint2*>(a.out + ((size_t)item * KG16_Q + row) * HD + d0) = u;
  }
}

template <typename PT>
cudaError_t config_g16(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int split, int items,
                       cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel_g16<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, KG16_SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(split, items, 1);
  cfg.blockDim = dim3(KG16_NT);
  cfg.dynamicSmemBytes = KG16_SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename PT>
cudaError_t launch_g16(const GArgs& a, int items, cudaStream_t stream) {
  if (items < 1 || items > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = config_g16<PT>(cfg, attr, g16_split(a.S, a.step), items, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, decode_attn_kernel_g16<PT>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename PT>
int max_clusters_g16(int split) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (config_g16<PT>(cfg, attr, split, 1, nullptr) != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, decode_attn_kernel_g16<PT>, &cfg) != cudaSuccess) return -1;
  return n;
}

}  // namespace

// q [B, KH, group, hd] bf16; prompt k/v [B, S, KH, hd] int8 (prompt_int8 = 1,
// scales [B, S, KHS] f32; groups 1-8: KHS = KH rounded up to a multiple of
// 4, the heads past KH unread; group 16: KHS = KH) or bf16 (prompt_int8 = 0,
// scales null); gen k/v [B, G, KH, hd] bf16; mask_lens [B] int32;
// 0 <= step < G; out [B, KH, group, hd] bf16. hd = 128 (Vicuna's and
// ChatGLM2's head_dim), group in {1, 2, 4, 8, 16}; 16-byte aligned
// pointers.
extern "C" int decode_attn_bf16(const void* q, const void* pk, const void* pv,
                                const void* ksc, const void* vsc, const void* gk,
                                const void* gv, const void* mask_lens, void* out,
                                int B, int S, int G, int KH, int group, int hd,
                                int prompt_int8, int step, float scale, void* stream) {
  if (hd != HD || step < 0 || step >= G) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group == 16) {
    const GArgs g{static_cast<const __nv_bfloat16*>(q), static_cast<const unsigned char*>(pk),
                  static_cast<const unsigned char*>(pv), static_cast<const float*>(ksc),
                  static_cast<const float*>(vsc), static_cast<const unsigned char*>(gk),
                  static_cast<const unsigned char*>(gv), static_cast<const int*>(mask_lens),
                  static_cast<__nv_bfloat16*>(out), S, G, KH, step, scale};
    return (int)(prompt_int8 ? launch_g16<int8_t>(g, B * KH, s)
                             : launch_g16<__nv_bfloat16>(g, B * KH, s));
  }
  KArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.ksc = static_cast<const float*>(ksc);
  a.vsc = static_cast<const float*>(vsc);
  a.lens = static_cast<const int*>(mask_lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B; a.S = S; a.G = G; a.KH = KH; a.step = step; a.scale = scale;
  const cudaError_t err = prompt_int8 ? by_group<int8_t>(group, a, pk, pv, gk, gv, s)
                                      : by_group<__nv_bfloat16>(group, a, pk, pv, gk, gv, s);
  return (int)err;
}

// group 16: the ranks an item is split over at S and step (the grid is
// (split, B * KH), clusters of split along x), the dynamic shared memory of
// a block, and how many clusters of `split` blocks can be resident at once
// (cudaOccupancyMaxActiveClusters; -1 on an error)
extern "C" int decode_attn_g16_split(int S, int step) { return g16_split(S, step); }

extern "C" int decode_attn_g16_smem_bytes() { return KG16_SMEM; }

extern "C" int decode_attn_g16_max_clusters(int split, int prompt_int8) {
  return prompt_int8 ? max_clusters_g16<int8_t>(split) : max_clusters_g16<__nv_bfloat16>(split);
}
