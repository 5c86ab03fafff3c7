// The tensor-core, ldmatrix, cp.async and wgmma building blocks of the
// attention kernels: csrc/flash_attention.cu (K2, the forward of rows 4 and
// 5, row 6) and csrc/flash_attention_vjp.cu (row 4's dq and dk/dv). They
// replace the Pallas bodies of revisionllm_tpu/ops/flash_attention.py:
// _flash_kernel :40, _flash_fwd_lse_kernel :352, _flash_dq_kernel :415,
// _flash_dkv_kernel :464 and _flash_prefix_kernel :859; each source names its
// own, with what bounds it and its time on the card.
//
// What bounds them on the H100: operations at the training shape (B 1,
// H 32, T 2048, causal, full length), bytes at the stage-1 shapes and at the
// training batch's kv_len of 330. Measured by chip_smoke.py on an NVIDIA H100
// 80GB HBM3 at 700.00 W: row 4's forward 0.1200 ms and dq + dk/dv 0.3113 ms
// at full length (1.1536 and 2.0031 ms with the WMMA design this replaced).
//
// The design is FlashAttention-2's, for head_dim 128 on sm_90a, with every
// product on Hopper's wgmma (the route taken; TMA is not used):
//   - a block of one warpgroup (4 warps) owns a 64-row tile; each warp owns
//     16 of its rows;
//   - the tiles it walks arrive through a two-stage ring of cp.async copies
//     (16 B, .cg, zero-filled past the live rows) in the layout wgmma reads
//     with 128-byte swizzling (load_tile_sw128), so tile j + 1 lands while
//     tile j is computed;
//   - products are wgmma.m64nNk16 bf16 -> f32: B (and for dk/dv's first two
//     products A) read by the tensor cores from a swizzled tile through a
//     descriptor, K-major or MN-major (transposed) as the product needs; A
//     otherwise from registers. The C layout of wgmma's accumulator, per
//     warp, is N / 8 m16n8 tiles, and two adjacent ones are the A layout of
//     one k16 step, so a score tile is rounded to bf16 and fed to the next
//     product without leaving the registers;
//   - a row's statistics live in the 4 lanes of a quad (two shuffles);
//   - tiles that are read by ldmatrix (the q and dO tiles whose rows become A
//     fragments) or that stage an output are padded to a row stride of
//     D + 8 bf16 (272 B), which puts the 8 row addresses of every ldmatrix
//     phase on distinct banks.
//
// The m16n8k16 fragment layouts, lane = 4 g + t (g = lane / 4, t = lane % 4),
// which wgmma.m64nNk16 keeps per warp (warp w: rows 16 w .. 16 w + 15):
//   A (16 x 16, row major), 4 x b32: a0 (g, 2t..2t+1), a1 (g + 8, 2t..),
//     a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..);
//   C (16 x 8, f32), 4 floats: c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

using bf16 = __nv_bfloat16;

constexpr int D = 128;         // head_dim (Vicuna)
constexpr int DS = D + 8;      // bf16 row stride of a shared tile
constexpr int TILE = 64;       // rows of a q or kv tile
constexpr int THREADS = 128;   // 4 warps x 16 rows
constexpr int TILE_ELEMS = TILE * DS;
constexpr size_t TILE_BYTES = (size_t)TILE_ELEMS * 2;
constexpr float NEG_INF = -2.0e30f;
constexpr float LSE_EMPTY = 2.0e30f;  // lse of a row that sees no key
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; when !pred nothing is
// read and the 16 bytes are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

// 4 bytes, the same way (for f32 rows whose start is not 16-byte aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// a [TILE, D] bf16 tile whose row r starts at src + r * stride (elements)
// into dst [TILE][DS]; rows at or past `valid` are zero. Row 0 of src must
// be addressable (it is what a zero-filled copy names).
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, size_t stride,
                                                int valid) {
#pragma unroll
  for (int k = 0; k < TILE * (D / 8) / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int r = i >> 4, c = (i & 15) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * DS + c, ok ? src + r * stride + c : src, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the offset (elements, in a tile of row stride DS) of this lane's
// ldmatrix.x4 row address for the A fragment of 16 rows x 16 columns
// (matrices: rows 0-7 / 8-15 x columns 0-7, then the same x columns 8-15 ->
// a0..a3)
__device__ __forceinline__ int a_lane_off(int lane) {
  return (lane & 15) * DS + (lane >> 4) * 8;
}
// the 8 A fragments (k steps over D) of 16 rows x D at `rows` (stride DS)
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* rows, int lane) {
  const bf16* p = rows + a_lane_off(lane);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(a[kk], p + kk * 16);
}

// the A fragments (N / 16 k steps) of a [16 x N] f32 accumulator, rounded
// to bf16
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&s)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a warp's 16 accumulated rows, row g scaled by lo and row g + 8 by hi, as
// bf16 through its 16 rows of `stage` (stride DS) to dst, whose row r starts
// at dst + r * stride; rows at or past `valid` are not written. 16-byte
// stores, a warp writing two whole 256-byte rows per instruction.
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float lo, float hi,
                                           bf16* stage, bf16* dst, size_t stride, int valid,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * DS + n * 8 + 2 * t) =
        pack_bf16(acc[n][0] * lo, acc[n][1] * lo);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * DS + n * 8 + 2 * t) =
        pack_bf16(acc[n][2] * hi, acc[n][3] * hi);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 16 * (D / 8) / 32; ++k) {
    const int i = lane + 32 * k;
    const int r = i >> 4, c = (i & 15) * 8;
    if (r < valid)
      *reinterpret_cast<uint4*>(dst + r * stride + c) =
          *reinterpret_cast<const uint4*>(stage + r * DS + c);
  }
  __syncwarp();
}

// ------------------------------------------------------------------ wgmma

// bytes of one [TILE, D] bf16 tile in the 128-byte-swizzled layout
constexpr int SW_TILE_BYTES = TILE * D * 2;

// a [TILE, D] bf16 tile, row r at src + r * stride (elements), into the
// layout wgmma reads with 128-byte swizzling: two halves of 64 columns, 8 KB
// each, row r of a half at r * 128 B and its 16-byte chunk c at chunk
// c ^ (r % 8). dst is 1024-byte aligned; rows at or past `valid` are zero.
__device__ __forceinline__ void load_tile_sw128(unsigned char* dst, const bf16* src, size_t stride,
                                                int valid) {
#pragma unroll
  for (int k = 0; k < TILE * (D / 8) / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int r = i >> 4, c = i & 15;
    const bool ok = r < valid;
    unsigned char* p = dst + (c >> 3) * (TILE * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    cp_async16(p, ok ? src + r * stride + c * 8 : src, ok);
  }
}

// the descriptor of a 128-byte-swizzled wgmma operand at p: lbo and sbo in
// bytes. K-major (a tile's rows are the operand's n rows, its columns the k
// depth): p = half * 8 KB + k step * 32 B, sbo = 1024 (8 rows), lbo unused.
// MN-major (the tile's rows are the k depth): p = k step * 2 KB (16 rows),
// lbo = 8 KB (the next 64 columns of n), sbo = 1024 (the next 8 rows of k).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// orders this thread's completed cp.async writes to shared memory before the
// tensor cores' (async proxy) reads of it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma reads or writes across the fence, commit and wait
template <int N>
__device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[n][e])::"memory");
}

// d (= or +=, by scale_d) a . b: m64n64k16 with A from registers and B
// K-major from shared memory
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d += a . b: m64n128k16 with A from registers and B MN-major from shared
// memory (transposed); scale_d 1 accumulates
__device__ __forceinline__ void wgmma_m64n128k16_tb(float (&d)[16][4], const uint32_t (&a)[4],
                                                    uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (= or +=, by scale_d) a . b: m64n64k16 with A and B K-major from shared
// memory
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[8][4], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// the descriptor of k step kk (16 deep) of a swizzled tile read K-major (its
// rows are the operand's m or n rows), and of one read MN-major (its rows
// are the k depth)
__device__ __forceinline__ uint64_t k_major(const unsigned char* tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * (TILE * 128) + (kk & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mn_major(const unsigned char* tile, int kk) {
  return sw128_desc(tile + kk * 2048, 8192, 1024);
}

// the first 1024-byte boundary at or after p (swizzled tiles sit on one)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// 2^x, flushing denormal results to 0 (the softmax's p and alpha)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace attn
