// The parts of the whole-step decode kernels that rows 9 (decode_step.cu) and
// 10 (decode_serve.cu) share: the persistent cooperative kernel that walks the
// layers, its row, matmul and SwiGLU phases, and its launch. Each source gives
// its own attention phase (row 9 reads an int8 prompt cache and a bf16 gen
// cache; row 10 one unified int8 slab) as a struct with a static device
// function `run(a, l, smem)`.
//
// The kernel runs one block per SM (cudaLaunchCooperativeKernel), with the
// residual and the activations in small device buffers (L2-resident), and a
// grid-wide barrier between the phases of a layer:
//   1. rows: x += (down partials of the previous layer) * sd; h = RMSNorm(x);
//   2. q/k/v partial products;
//   3. attention per (row, head), one warp each (the source's own);
//   4. o partial products;
//   5. rows: x += o * so; h = RMSNorm(x);
//   6. gate and up partial products;
//   7. elementwise: m = bf16(silu(g)), m = bf16(m * u);
//   8. down partial products;
// and after the last layer one more row phase writes the hidden state out.
// That is 8 barriers a layer.
//
// The matmul phases (2, 4, 6, 8) are where the bytes go. Each splits K into
// slices of at most 1024 (4 for K = 4096, 11 for F = 11008 or 11264) and gives
// each slice an equal share of the blocks; a block loads its slice of the
// [64, K] bf16 activation into shared memory ONCE, then streams 128-column
// int8 weight tiles of that slice (a 4-stage cp.async ring of 64 x 128 tiles),
// widens them to bf16 (exact) and runs WMMA with f32 accumulation, writing f32
// partial sums [slice, 64, N]. The consumer phase adds the slices in a fixed
// order, so results are deterministic. A matrix is stored as column chunks of
// `cw` columns, chunk c a contiguous [K, cw] block: cw = N is the standard
// [K, N] row-major layout, cw = block_n the serving pack's [nc, K, block_n].
//
// The roundings are the TPU kernels': h rounds to bf16 before each weight dot;
// int8 weights are exact in bf16, accumulated in f32, then times the scale;
// the residual rounds to bf16 after each add; m = bf16(silu(g)), then
// bf16(m * u).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cg = cooperative_groups;
using namespace nvcuda;

namespace {

constexpr int HD = 128;        // head dim
constexpr int MP = 64;         // rows per launch (the batch, zero-padded)
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BN = 128;        // weight columns per tile
constexpr int BK = 64;         // K rows per pipeline stage
constexpr int STAGES = 4;
constexpr int KSLICE = 1024;   // at most this many K rows per slice
constexpr int WBS = BN + 8;    // smem row stride (bf16) of the widened W tile
constexpr int UNROLL = 8;      // keys a lane loads before it uses them

struct Args {
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
  float eps;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ldf(const float* p) { return __ldcg(p); }

__device__ __forceinline__ float ldbf(const __nv_bfloat16* p) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(u));
}

// byte i of w as a sign-extended int8, and the low / high bf16 of w, as f32
__device__ __forceinline__ float i8_at(unsigned w, int i) {
  return (float)((int)(w << (24 - 8 * i)) >> 24);
}
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// sum over e of q[e] * (16 int8 values of v)
__device__ __forceinline__ float dot_i8x16(const float* q, const uint4& v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  float d = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) d += q[i] * i8_at(w[i >> 2], i & 3);
  return d;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// K rows per slice and the number of slices of a K-deep product (mirrored
// by ops/decode_step.py to size the `part` scratch)
__host__ __device__ __forceinline__ int slice_rows(int K) {
  const int n = (K + KSLICE - 1) / KSLICE;
  const int r = (K + n - 1) / n;
  return (r + BK - 1) / BK * BK;
}

__host__ __device__ __forceinline__ int num_slices(int K) {
  const int r = slice_rows(K);
  return (K + r - 1) / r;
}

// shared memory of a matmul phase: the activation slice, the W ring, the
// widened W tile
__host__ __device__ __forceinline__ size_t mm_smem(int kper) {
  return (size_t)MP * (kper + 8) * 2 + (size_t)STAGES * BK * BN + (size_t)BK * WBS * 2;
}

// q, k and v of (row b, head h) for the attention phase, f32: the sums of
// the q/k/v partial slices times the column scales, then rope on q and k
// (x * (cos | cos) + (-x2 | x1) * (sin | sin)). Lane d % 32 returns dims
// lane + 32 e in qr/kr/vr[e] and leaves all 128 dims of each in qs/ks/vs.
__device__ __forceinline__ void qkv_rope(const Args& a, int l, int b, int h, float* qs,
                                         float* ks, float* vs, float qr[4], float kr[4]) {
  const int lane = threadIdx.x & 31;
  const int D = a.D;
  const int S_qkv = num_slices(D);
  const int Ntot = 3 * D;
  float raw[3][4];
#pragma unroll
  for (int w3 = 0; w3 < 3; ++w3) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = lane + 32 * e;
      const int col = w3 * D + h * HD + d;
      float acc = 0.0f;
      for (int s = 0; s < S_qkv; ++s) acc += ldf(a.part + ((size_t)s * MP + b) * Ntot + col);
      raw[w3][e] = acc * a.s[w3][(size_t)l * D + h * HD + d];
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    qs[lane + 32 * e] = raw[0][e];
    ks[lane + 32 * e] = raw[1][e];
    vs[lane + 32 * e] = raw[2][e];
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = lane + 32 * e;
    const int i = d & (HD / 2 - 1);
    const float c = a.cosb[b * (HD / 2) + i], sn = a.sinb[b * (HD / 2) + i];
    const float qrot = d < HD / 2 ? -qs[d + HD / 2] : qs[d - HD / 2];
    const float krot = d < HD / 2 ? -ks[d + HD / 2] : ks[d - HD / 2];
    qr[e] = __fadd_rn(__fmul_rn(qs[d], c), __fmul_rn(qrot, sn));
    kr[e] = __fadd_rn(__fmul_rn(ks[d], c), __fmul_rn(krot, sn));
  }
  __syncwarp();
}

// ------------------------------------------------------------- row phases

// x = bf16(x + (sum of the down/o partial slices) * scale) for the rows of
// this launch (pre != nullptr), then (gamma != nullptr) act = bf16(RMSNorm(x)
// * gamma). First layer: x = x_in. Final: x_out = x.
__device__ void row_phase(const Args& a, const float* pre_scale, int pre_slices,
                          const __nv_bfloat16* gamma, bool first, bool final_out,
                          float* red) {
  const int D = a.D;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    __nv_bfloat16* xr = a.xres + (size_t)b * D;
    float ss = 0.0f;
    for (int c = threadIdx.x; c < D; c += THREADS) {
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
      __syncthreads();
      float tot = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) tot += red[w];
      const float inv = rsqrtf(tot / (float)D + a.eps);
      for (int c = threadIdx.x; c < D; c += THREADS)
        a.act[(size_t)b * D + c] =
            __float2bfloat16_rn((ldbf(xr + c) * inv) * __bfloat162float(gamma[c]));
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------- matmul phases

// part[s, 0:MP, mi * N + n] = act[0:MP, slice s] @ W_mi[l][slice s, n] for
// the nmat matrices W_mi (each [K, N]), mi * N + n < Ntot = nmat * N.
__device__ void mm_phase(const Args& a, int l, int first_mat, int nmat, int K, int N,
                         unsigned char* smem) {
  const int kper = slice_rows(K);
  const int S = num_slices(K);
  const int bps = gridDim.x / S;
  const int s = blockIdx.x / bps, r = blockIdx.x % bps;
  if (s >= S) return;
  const int k_begin = s * kper;
  const int k_end = min(K, k_begin + kper);
  const int kn = k_end - k_begin;
  const int AS = kper + 8;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* w8 = reinterpret_cast<int8_t*>(smem + (size_t)MP * AS * 2);
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(w8 + STAGES * BK * BN);
  const int tid = threadIdx.x, warp = tid >> 5;

  // the activation slice, rows past B zero-filled (cp.async.cg reads L2)
  for (int c = tid; c < MP * (kn / 8); c += THREADS) {
    const int row = c / (kn / 8), kc = (c % (kn / 8)) * 8;
    const bool ok = row < a.B;
    cp_async16(As + row * AS + kc, ok ? a.act + (size_t)row * K + k_begin + kc : a.act,
               ok ? 16 : 0);
  }
  cp_async_commit();

  const int nchunks = (N + BN - 1) / BN;
  const int nk = (kn + BK - 1) / BK;
  const int Ntot = nmat * N;
  for (int c = r; c < nmat * nchunks; c += bps) {
    const int mi = c / nchunks, n0 = (c % nchunks) * BN;
    const int cw = a.cw[first_mat + mi];
    // the column chunk that holds columns n0 .. n0 + BN - 1, at column n0 % cw
    const int8_t* W = a.w[first_mat + mi] + (size_t)l * K * N + (size_t)(n0 / cw) * K * cw +
                      n0 % cw;
    auto issue = [&](int slot, int k0) {
#pragma unroll
      for (int j = 0; j < (BK * BN / 16) / THREADS; ++j) {
        const int cc = tid + j * THREADS;
        const int rr = cc >> 3, col = (cc & 7) * 16;
        const int k = k0 + rr;
        const bool ok = k < k_end && n0 + col < N;
        cp_async16(w8 + slot * BK * BN + rr * BN + col, ok ? W + (size_t)k * cw + col : W,
                   ok ? 16 : 0);
      }
    };
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.0f);
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nk) issue(st, k_begin + st * BK);
      cp_async_commit();
    }
    for (int t = 0; t < nk; ++t) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      {
        const int tn = t + STAGES - 1;
        if (tn < nk) issue(tn % STAGES, k_begin + tn * BK);
        cp_async_commit();
      }
      {
        const int rr = tid >> 2, col = (tid & 3) * 32;
        const int8_t* src = w8 + (t % STAGES) * BK * BN + rr * BN + col;
        __align__(16) int8_t raw[32];
        *reinterpret_cast<uint4*>(raw) = *reinterpret_cast<const uint4*>(src);
        *reinterpret_cast<uint4*>(raw + 16) = *reinterpret_cast<const uint4*>(src + 16);
        __align__(16) __nv_bfloat162 hv[16];
#pragma unroll
        for (int e = 0; e < 16; ++e)
          hv[e] = __floats2bfloat162_rn((float)raw[2 * e], (float)raw[2 * e + 1]);
        uint4* dst = reinterpret_cast<uint4*>(wb + rr * WBS + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = reinterpret_cast<const uint4*>(hv)[e];
      }
      __syncthreads();
      const int kb = t * BK;  // offset of this stage inside the slice
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if (kb + kk * 16 >= kn) break;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfrag;
        wmma::load_matrix_sync(bfrag, wb + kk * 16 * WBS + warp * 16, WBS);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> afrag;
          wmma::load_matrix_sync(afrag, As + i * 16 * AS + kb + kk * 16, AS);
          wmma::mma_sync(acc[i], afrag, bfrag, acc[i]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring and wb are free for the next chunk
    if (n0 + warp * 16 < N) {
      float* dst = a.part + (size_t)s * MP * Ntot + mi * N + n0 + warp * 16;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::store_matrix_sync(dst + (size_t)i * 16 * Ntot, acc[i], Ntot, wmma::mem_row_major);
    }
  }
  cp_async_wait<0>();
}

// ----------------------------------------------------- SwiGLU elementwise

__device__ void silu_phase(const Args& a, int l) {
  const int F = a.F;
  const int S = num_slices(a.D);
  const int Ntot = 2 * F;
  const float* sg = a.s[4] + (size_t)l * F;
  const float* su = a.s[5] + (size_t)l * F;
  for (int idx = blockIdx.x * THREADS + threadIdx.x; idx < a.B * F; idx += gridDim.x * THREADS) {
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

template <class Attn>
__global__ void __launch_bounds__(THREADS, 1) step_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[WARPS];
  cg::grid_group grid = cg::this_grid();
  const int D = a.D, F = a.F;
  const int S_D = num_slices(D), S_F = num_slices(F);
  for (int l = 0; l < a.L; ++l) {
    row_phase(a, l ? a.s[6] + (size_t)(l - 1) * D : nullptr, S_F, a.attn_norm + (size_t)l * D,
              l == 0, false, red);
    grid.sync();
    mm_phase(a, l, 0, 3, D, D, smem);           // q, k, v
    grid.sync();
    Attn::run(a, l, smem);
    grid.sync();
    mm_phase(a, l, 3, 1, D, D, smem);           // o
    grid.sync();
    row_phase(a, a.s[3] + (size_t)l * D, S_D, a.mlp_norm + (size_t)l * D, false, false, red);
    grid.sync();
    mm_phase(a, l, 4, 2, D, F, smem);           // gate, up
    grid.sync();
    silu_phase(a, l);
    grid.sync();
    mm_phase(a, l, 6, 1, F, D, smem);           // down
    grid.sync();
  }
  row_phase(a, a.s[6] + (size_t)(a.L - 1) * D, S_F, nullptr, false, true, red);
}

// One cooperative launch of step_kernel<Attn>, one block per SM, with the
// larger of the matmul phases' and the attention phase's shared memory.
template <class Attn>
int launch_step(const Args& a, size_t smem_attn, void* stream) {
  void (*kernel)(Args) = step_kernel<Attn>;
  size_t smem = mm_smem(slice_rows(a.D));
  const size_t smem_f = mm_smem(slice_rows(a.F));
  smem = smem > smem_f ? smem : smem_f;
  smem = smem > smem_attn ? smem : smem_attn;
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
  Args args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(THREADS),
                                    params, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
