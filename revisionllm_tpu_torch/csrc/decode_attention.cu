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
__global__ void __launch_bounds__(NTHREADS, KBLOCKS) decode_attn_kernel(const __grid_constant__ KArgs a) {
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
  if (es == 1 && (!encode_scales(&a.tm[6], a.ksc, a.B, a.S, a.KH, rows) ||
                  !encode_scales(&a.tm[7], a.vsc, a.B, a.S, a.KH, rows)))
    return cudaErrorInvalidValue;
  switch (group) {
    case 1: return launch<PT, 1>(a, s);
    case 2: return launch<PT, 2>(a, s);
    case 4: return launch<PT, 4>(a, s);
    case 8: return launch<PT, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, KH, group, hd] bf16; prompt k/v [B, S, KH, hd] int8 (prompt_int8 = 1,
// scales [B, S, KH] f32) or bf16 (prompt_int8 = 0, scales null); gen k/v
// [B, G, KH, hd] bf16; mask_lens [B] int32; 0 <= step < G; out [B, KH, group, hd]
// bf16. hd = 128 (Vicuna's head_dim), group in {1, 2, 4, 8}; 16-byte aligned
// pointers.
extern "C" int decode_attn_bf16(const void* q, const void* pk, const void* pv,
                                const void* ksc, const void* vsc, const void* gk,
                                const void* gv, const void* mask_lens, void* out,
                                int B, int S, int G, int KH, int group, int hd,
                                int prompt_int8, int step, float scale, void* stream) {
  if (hd != HD || step < 0 || step >= G) return (int)cudaErrorInvalidValue;
  KArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.ksc = static_cast<const float*>(ksc);
  a.vsc = static_cast<const float*>(vsc);
  a.lens = static_cast<const int*>(mask_lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B; a.S = S; a.G = G; a.KH = KH; a.step = step; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = prompt_int8 ? by_group<int8_t>(group, a, pk, pv, gk, gv, s)
                                      : by_group<__nv_bfloat16>(group, a, pk, pv, gk, gv, s);
  return (int)err;
}
