// The building blocks of the weight-only decode matmuls that do not depend
// on how the weights are packed: row 7 (csrc/int4_matmul.cu, W4A16) and K1
// (csrc/int8_matmul.cu, W8A16). The tensor-core pieces they use (wgmma with
// A from registers and x as a 128-byte-swizzled B operand, its descriptors
// and fences, the swizzled tile loader) are csrc/attention_common.cuh's.
// Here:
//   - the cp.async ring helpers (16-byte .cg copies, zero-filled past the
//     live rows and columns);
//   - the mbarriers and the TMA tile copies of a ring filled by a producer
//     warp (K1, row 8, the matmul phases of rows 9 and 10 in
//     csrc/decode_common.cuh): a full and an empty barrier a stage, waits by
//     phase parity, and the host's encoding of a 2-D or 3-D tensor map;
//   - the exact widening of int8 weight pairs into wgmma's bf16x2 A
//     registers (K1 and rows 9 and 10);
//   - the bf16x2 packing and a wait for all but N wgmma groups;
//   - the split-K reduction across a thread-block cluster (row 7; K1 has its
//     own, which scales the columns): every rank leaves its f32 partial tile
//     in its own shared memory, and rank r sums its 1/S slice of the tile
//     over ranks 0..S-1, in rank order, through distributed shared memory,
//     then rounds and stores it as bf16. No partial sum reaches device
//     memory, and the order of the sums is fixed, so the result is
//     deterministic.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wonly {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; when !pred nothing is
// read and the 16 bytes are zero (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the other threads and to
// the async proxy (the TMA unit) before anyone uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` more of asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed. A wait of
// more than 2^32 clocks (seconds) traps, so a broken ring ends the kernel
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 == 0) t0 = now;
    else if (now - t0 > (1ll << 32)) __trap();
  }
}

// the TMA copy of the box at (c0 inner, c1 outer) of the tensor map `map`
// (a __grid_constant__ kernel parameter) into dst, counted on `bar`;
// elements outside the tensor are zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_addr(bar))
      : "memory");
}

// tma_load_2d with an L2 eviction policy (from createpolicy)
__device__ __forceinline__ void tma_load_2d_hint(void* dst, const void* map, int c0, int c1,
                                                 uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%2, %3}], [%4], %5;\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// tma_load_2d_hint for a 3-D tensor map: the box at (c0 inner, c1, c2 outer)
__device__ __forceinline__ void tma_load_3d_hint(void* dst, const void* map, int c0, int c1, int c2,
                                                 uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%2, %3, %4}], [%5], %6;\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// ------------------------------------------------ int8 into wgmma's A operand

// byte J of `lo` and of `hi` (signed int8) as the bf16x2 (lo, hi), exactly:
// a prmt puts the two bytes at bits 0-7 and 16-23; for a byte b, bf16 0x4300
// | (b & 127) is 128 + (b & 127) and 0xC300 | (b & 128) is -128 or -256 by
// its sign, so one bf16x2 add of the two makes b (no conversion instruction)
template <int J>
__device__ __forceinline__ uint32_t s8x2(uint32_t lo, uint32_t hi) {
  const uint32_t p = __byte_perm(lo, hi, J | (J << 4) | ((J + 4) << 8) | ((J + 4) << 12));
  const uint32_t v = (p & 0x007F007Fu) | 0x43004300u;  // 128 + (b & 127)
  const uint32_t s = (p & 0x00800080u) | 0xC300C300u;  // -128, or -256 for b < 0
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(v), "r"(s));
  return d;
}

// the words of rows k (lo) and k + 1 (hi), byte j column c0 + j, into
// register R (0: k 2t, 2: k 2t + 8) and R + 1 (the row 8 below) of the A
// fragments of wgmma 0 and 1: A row 16 w + g + 8 h of wgmma jj is then
// column c0 + 2 h + jj of the tile (lane (g, t) of warp w reading columns
// c0 = 32 w + 4 g .. c0 + 3)
template <int R>
__device__ __forceinline__ void widen(uint32_t (&a)[2][4], uint32_t lo, uint32_t hi) {
  a[0][R] = s8x2<0>(lo, hi);
  a[1][R] = s8x2<1>(lo, hi);
  a[0][R + 1] = s8x2<2>(lo, hi);
  a[1][R + 1] = s8x2<3>(lo, hi);
}

// ------------------------------------------------------- tensor maps (host)

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime (so a
// library needs no link against libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a tensor of `rank` <= 3 dimensions of `type` at `base`, innermost first:
// dims[i] elements along dimension i, strides[i] bytes between steps of
// dimension i + 1; copied in boxes of box[0..rank) with the 128-byte
// swizzle; elements outside the tensor read as zeros
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                   const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 2-D row-major tensor [outer, inner] of `type` at `base` (row stride
// row_bytes), copied in boxes of [box_outer, box_inner]
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t inner,
                   uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  return encode(map, type, base, 2, dims, strides, box);
}

// wait until at most N of this thread's committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the cluster barrier: every thread of every block of the cluster arrives
// (its shared-memory writes released) and waits (the others' acquired)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of `p` (this block's shared memory) in block `rank`'s shared
// memory, for ld.shared::cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a) : "memory");
  return v;
}

// The split-K sum over the block's cluster of S <= 8 blocks along the K
// axis (its rank r = blockIdx.y, S = gridDim.y). `part` is this rank's f32
// partial tile [MP][RS] in shared memory (columns [0, BN) live), written by
// the block. Rank r takes float4s [r Q / S, (r + 1) Q / S) of the Q = MP *
// BN / 4 float4s of the tile, adds them over ranks 0..S-1 in that order and
// stores rows < rows and columns < N of out [.., N] (row stride N) as bf16.
// Each float4's S reads (distributed shared memory, ld.shared::cluster) are
// issued together, so a float4 costs one latency.
template <int MP, int BN, int RS, int THREADS>
__device__ __forceinline__ void cluster_sum_store(float* part, bf16* out, int rows, int N,
                                                  int n0) {
  const int S = gridDim.y, r = blockIdx.y;
  uint32_t src[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) src[p] = cluster_addr(part, p < S ? p : r);
  cluster_sync();  // every rank's partial tile is written
  constexpr int Q = MP * BN / 4;
  const int q0 = r * Q / S, q1 = (r + 1) * Q / S;
#pragma unroll 2
  for (int q = q0 + threadIdx.x; q < q1; q += THREADS) {
    const int row = q / (BN / 4), col = (q % (BN / 4)) * 4;
    const uint32_t off = (uint32_t)(row * RS + col) * 4;
    float4 v[8];
#pragma unroll
    for (int p = 0; p < 8; ++p)
      if (p < S) v[p] = ld_cluster_f4(src[p] + off);
    float4 s = v[0];
#pragma unroll
    for (int p = 1; p < 8; ++p)
      if (p < S) {
        s.x += v[p].x;
        s.y += v[p].y;
        s.z += v[p].z;
        s.w += v[p].w;
      }
    if (row < rows && n0 + col < N) {
      uint2 o;
      o.x = pack_bf16(s.x, s.y);
      o.y = pack_bf16(s.z, s.w);
      *reinterpret_cast<uint2*>(out + (size_t)row * N + n0 + col) = o;
    }
  }
  cluster_sync();  // no rank leaves while another still reads its tile
}

}  // namespace wonly
