// Row 9: the whole L-layer decode step in one launch (REVISIONLLM_MEGAKERNEL).
//
// Replaces the Pallas kernel revisionllm_tpu/ops/decode_step.py:135
// _decode_kernel (entry decode_step_fused :493, pallas_call :539), which
// models/generation.py runs once per decode step in place of decode_step_split's
// ~225 kernel launches and glue: RMSNorm; int8 q/k/v/o/gate/up/down with
// per-column scales; rope; attention over [int8 prompt (per-position, per-head
// scales) | bf16 gen slots < step | self]; SwiGLU; residuals; each layer's new
// k/v written into gen slot `step`. Vicuna-7B: B 64, D 4096, H = KH 32, hd 128,
// F 11008, S ~ 301, G 12, MHA.
//
// What bounds it on the H100: bytes. A step streams 6.48 GB of int8 layer
// weights and, at B 64, about 5 GB of prompt KV: about 3.5 ms at 3.35 TB/s. The
// split path is paced by the host instead (about 17 ms a step).
//
// The TPU kernel walks the layers as a sequential grid on one core, with the
// residual stream in VMEM. Hopper has no sequential grid, so this is a
// persistent cooperative kernel: one block per SM (cudaLaunchCooperativeKernel),
// the residual and the activations in small device buffers (L2-resident), and
// a grid-wide barrier between the phases of a layer:
//   1. rows: x += (down partials of the previous layer) * sd; h = RMSNorm(x);
//   2. q/k/v partial products;
//   3. attention per (row, head), one warp each: q/k/v = partials * scale,
//      rope, the new k/v into gen slot `step` (the mask is slot < step, so
//      that slot is never read in the same step), scores, one shared max,
//      values;
//   4. o partial products;
//   5. rows: x += o * so; h = RMSNorm(x);
//   6. gate and up partial products;
//   7. elementwise: m = bf16(silu(g)), m = bf16(m * u);
//   8. down partial products;
// and after the last layer one more row phase writes the hidden state out.
// That is 8 barriers a layer.
//
// The matmul phases (2, 4, 6, 8) are where the bytes go. Each splits K into
// slices of at most 1024 (4 for K = 4096, 11 for F = 11008) and gives each
// slice an equal share of the blocks; a block loads its slice of the [64, K]
// bf16 activation into shared memory ONCE, then streams 128-column int8
// weight chunks of that slice (a 4-stage cp.async ring of 64 x 128 tiles),
// widens them to bf16 (exact) and runs WMMA with f32 accumulation, writing f32
// partial sums [slice, 64, N]. The consumer phase adds the slices in a fixed
// order, so results are deterministic. The activation is read from L2 once per
// block per phase, not once per chunk.
//
// The roundings are the TPU kernel's (decode_step.py:198-480), which are not
// decode_step_split's: h rounds to bf16 before each weight dot; int8 weights
// are exact in bf16, accumulated in f32, then times the scale; q, k and v stay
// f32; prompt scores are bf16 q . int8 K times k_scale times hd^-0.5; gen
// scores bf16 q . bf16 cache; the self term f32 q . k_new; one shared max;
// p1 * v_scale and p2 round to bf16 before their value dots; the self value
// term is f32; the divide uses the unrounded denominator; the residual rounds
// to bf16 after each add; m = bf16(silu(g)), then bf16(m * u).
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/decode_step.py.

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
constexpr int BN = 128;        // weight columns per chunk
constexpr int BK = 64;         // K rows per pipeline stage
constexpr int STAGES = 4;
constexpr int KSLICE = 1024;   // at most this many K rows per slice
constexpr int WBS = BN + 8;    // smem row stride (bf16) of the widened W tile
constexpr int UNROLL = 8;      // prompt keys a lane loads before it uses them

struct Args {
  const int8_t* w[7];          // q, k, v, o, gate, up, down: [L, K, N] int8
  const float* s[7];           // their scales [L, N]
  const __nv_bfloat16* attn_norm;  // [L, D]
  const __nv_bfloat16* mlp_norm;   // [L, D]
  const int8_t* kv;            // [L, Bk, 2, H, Sp, HD] int8 prompt cache
  const float* kvsc;           // [L, Bk, 2, H, Sp]
  __nv_bfloat16* genkv;        // [L, 2, Bk, H, Gp, HD]
  const int* plen;             // [B] prompt lengths of this launch's rows
  const float* cosb;           // [B, HD / 2]
  const float* sinb;
  const __nv_bfloat16* x_in;   // [B, D]
  __nv_bfloat16* x_out;        // [B, D]
  __nv_bfloat16* xres;         // [MP, D] scratch: the residual stream
  __nv_bfloat16* act;          // [MP, max(D, F)] scratch: the matmul input
  float* part;                 // [slices, MP, N] scratch: partial sums
  int L, B, Bk, b0, D, F, H, Sp, Gp, step;
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

// sum over e of q[e] * (16 int8 values of v), and of q[e] * (8 bf16 values of v)
__device__ __forceinline__ float dot_i8x16(const float* q, const uint4& v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  float d = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) d += q[i] * i8_at(w[i >> 2], i & 3);
  return d;
}
__device__ __forceinline__ float dot_bf16x8(const float* q, const uint4& v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  float d = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) d += q[2 * i] * bf_lo(w[i]) + q[2 * i + 1] * bf_hi(w[i]);
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
    const int8_t* W = a.w[first_mat + mi] + (size_t)l * K * N;
    auto issue = [&](int slot, int k0) {
#pragma unroll
      for (int j = 0; j < (BK * BN / 16) / THREADS; ++j) {
        const int cc = tid + j * THREADS;
        const int rr = cc >> 3, col = (cc & 7) * 16;
        const int k = k0 + rr;
        const bool ok = k < k_end && n0 + col < N;
        cp_async16(w8 + slot * BK * BN + rr * BN + col, ok ? W + (size_t)k * N + n0 + col : W,
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

// ------------------------------------------------------- attention phase

// One warp per (row, head). Lanes are 4 key groups x 8 parts of 16 dims:
// lane = 8 kq + p reads dims [16 p, 16 p + 16) of keys j = kq (mod 4).
__device__ void attn_phase(const Args& a, int l, unsigned char* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kq = lane >> 3, p = lane & 7;
  const int D = a.D, H = a.H, Sp = a.Sp, Gp = a.Gp, step = a.step;
  const int S_qkv = num_slices(D);
  const int Ntot = 3 * D;
  const float scale = rsqrtf((float)HD);
  float* wsm = reinterpret_cast<float*>(smem) + (size_t)warp * (3 * HD + Sp + Gp);
  float* qs = wsm;
  float* ks = qs + HD;
  float* vs = ks + HD;
  float* sc = vs + HD;
  float* p2s = sc + Sp;
  for (int item = blockIdx.x * WARPS + warp; item < a.B * H; item += gridDim.x * WARPS) {
    const int b = item / H, h = item % H;
    const int bg = a.b0 + b;
    // q, k, v = (sum of slices) * scale, f32
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
    // rope on q and k: x * (cos | cos) + (-x2 | x1) * (sin | sin), f32
    float qr[4], kr[4];
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
    __nv_bfloat16* gk = a.genkv + ((((size_t)l * 2 + 0) * a.Bk + bg) * H + h) * Gp * HD;
    __nv_bfloat16* gv = a.genkv + ((((size_t)l * 2 + 1) * a.Bk + bg) * H + h) * Gp * HD;
    float self = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = lane + 32 * e;
      qs[d] = qr[e];
      ks[d] = kr[e];
      self += qr[e] * kr[e];
      gk[(size_t)step * HD + d] = __float2bfloat16_rn(kr[e]);
      gv[(size_t)step * HD + d] = __float2bfloat16_rn(vs[d]);
    }
    const float s_self = warp_sum(self) * scale;
    __syncwarp();
    float qb[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) qb[e] = bf16r(qs[16 * p + e]);

    const int plen = a.plen[b];
    const size_t kvrow = ((size_t)l * a.Bk + bg) * 2;
    const int8_t* Kp = a.kv + ((kvrow + 0) * H + h) * (size_t)Sp * HD;
    const int8_t* Vp = a.kv + ((kvrow + 1) * H + h) * (size_t)Sp * HD;
    const float* ksc = a.kvsc + ((kvrow + 0) * H + h) * (size_t)Sp;
    const float* vsc = a.kvsc + ((kvrow + 1) * H + h) * (size_t)Sp;

    // prompt scores: UNROLL batches of 4 keys in flight a lane
    float m = s_self;
    for (int j0 = 0; j0 < plen; j0 += 4 * UNROLL) {
      uint4 kraw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + 4 * u + kq;
        kraw[u] = j < plen ? __ldg(reinterpret_cast<const uint4*>(Kp + (size_t)j * HD + 16 * p))
                           : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float dot = dot_i8x16(qb, kraw[u]);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        const int j = j0 + 4 * u + kq;
        if (j < plen) {
          const float sj = (dot * __ldg(ksc + j)) * scale;
          if (p == 0) sc[j] = sj;
          m = fmaxf(m, sj);
        }
      }
    }
    // gen scores over slots < step: bf16 q . bf16 cache
    for (int j0 = 0; j0 < step; j0 += 4) {
      const int j = j0 + kq;
      float dot = 0.0f;
      if (j < step) {
        const uint4* src = reinterpret_cast<const uint4*>(gk + (size_t)j * HD + 16 * p);
        dot = dot_bf16x8(qb, src[0]) + dot_bf16x8(qb + 8, src[1]);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      if (j < step) {
        const float sj = dot * scale;
        if (p == 0) p2s[j] = sj;
        m = fmaxf(m, sj);
      }
    }
    m = warp_max(m);
    __syncwarp();
    // probabilities: the denominator from the unrounded p, the value
    // weights rounded to bf16 (p1 after the v_scale product)
    float sum1 = 0.0f, sum2 = 0.0f;
    for (int j = lane; j < plen; j += 32) {
      const float pj = expf(sc[j] - m);
      sum1 += pj;
      sc[j] = bf16r(pj * __ldg(vsc + j));
    }
    for (int j = lane; j < step; j += 32) {
      const float pj = expf(p2s[j] - m);
      sum2 += pj;
      p2s[j] = bf16r(pj);
    }
    const float ps = expf(s_self - m);
    const float denom = (warp_sum(sum1) + warp_sum(sum2)) + ps;
    __syncwarp();
    // values: lane accumulates dims [16 p, 16 p + 16) over keys j = kq (mod 4)
    float o1[16], o2[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) o1[e] = o2[e] = 0.0f;
    for (int j0 = 0; j0 < plen; j0 += 4 * UNROLL) {
      uint4 vraw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + 4 * u + kq;
        vraw[u] = j < plen ? __ldg(reinterpret_cast<const uint4*>(Vp + (size_t)j * HD + 16 * p))
                           : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + 4 * u + kq;
        const float wj = j < plen ? sc[j] : 0.0f;
        const unsigned w[4] = {vraw[u].x, vraw[u].y, vraw[u].z, vraw[u].w};
#pragma unroll
        for (int e = 0; e < 16; ++e) o1[e] += wj * i8_at(w[e >> 2], e & 3);
      }
    }
    for (int j0 = 0; j0 < step; j0 += 4) {
      const int j = j0 + kq;
      if (j < step) {
        const float wj = p2s[j];
        const uint4* src = reinterpret_cast<const uint4*>(gv + (size_t)j * HD + 16 * p);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint4 u4 = src[half];
          const unsigned w[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o2[8 * half + 2 * i] += wj * bf_lo(w[i]);
            o2[8 * half + 2 * i + 1] += wj * bf_hi(w[i]);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      o1[e] += __shfl_xor_sync(0xffffffffu, o1[e], 8);
      o1[e] += __shfl_xor_sync(0xffffffffu, o1[e], 16);
      o2[e] += __shfl_xor_sync(0xffffffffu, o2[e], 8);
      o2[e] += __shfl_xor_sync(0xffffffffu, o2[e], 16);
    }
    if (kq == 0) {
      __nv_bfloat16* out = a.act + (size_t)b * D + h * HD + 16 * p;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float o3 = ps * vs[16 * p + e];
        out[e] = __float2bfloat16_rn(((o1[e] + o2[e]) + o3) / denom);
      }
    }
    __syncwarp();
  }
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

__global__ void __launch_bounds__(THREADS, 1) decode_step_kernel(Args a) {
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
    attn_phase(a, l, smem);
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

}  // namespace

// w: 7 int8 weight pointers [L, K, N] (q, k, v, o, gate, up, down); s: their
// f32 scales [L, N]; norms bf16 [L, D]; kv int8 [L, Bk, 2, H, Sp, 128], kvsc
// f32 [L, Bk, 2, H, Sp]; genkv bf16 [L, 2, Bk, H, Gp, 128]; this launch takes
// rows b0 .. b0 + B - 1 (B <= 64) of the caches, whose plen/cos/sin/x_in/x_out
// pointers start at row b0. Requires D = H * 128, D % 128 == 0, F % 16 == 0,
// 16-byte aligned pointers, 0 <= step < Gp.
extern "C" int decode_step_fused(void* const* w, void* const* s, const void* attn_norm,
                                 const void* mlp_norm, const void* kv, const void* kvsc,
                                 void* genkv, const void* plen, const void* cosb,
                                 const void* sinb, const void* x_in, void* x_out, void* xres,
                                 void* act, void* part, int L, int B, int Bk, int b0, int D,
                                 int F, int H, int Sp, int Gp, int step, float eps,
                                 void* stream) {
  if (B < 1 || B > MP || D != H * HD || step < 0 || step >= Gp) return (int)cudaErrorInvalidValue;
  Args a;
  for (int i = 0; i < 7; ++i) {
    a.w[i] = static_cast<const int8_t*>(w[i]);
    a.s[i] = static_cast<const float*>(s[i]);
  }
  a.attn_norm = static_cast<const __nv_bfloat16*>(attn_norm);
  a.mlp_norm = static_cast<const __nv_bfloat16*>(mlp_norm);
  a.kv = static_cast<const int8_t*>(kv);
  a.kvsc = static_cast<const float*>(kvsc);
  a.genkv = static_cast<__nv_bfloat16*>(genkv);
  a.plen = static_cast<const int*>(plen);
  a.cosb = static_cast<const float*>(cosb);
  a.sinb = static_cast<const float*>(sinb);
  a.x_in = static_cast<const __nv_bfloat16*>(x_in);
  a.x_out = static_cast<__nv_bfloat16*>(x_out);
  a.xres = static_cast<__nv_bfloat16*>(xres);
  a.act = static_cast<__nv_bfloat16*>(act);
  a.part = static_cast<float*>(part);
  a.L = L; a.B = B; a.Bk = Bk; a.b0 = b0; a.D = D; a.F = F; a.H = H; a.Sp = Sp; a.Gp = Gp;
  a.step = step; a.eps = eps;

  size_t smem = mm_smem(slice_rows(D));
  const size_t smem_f = mm_smem(slice_rows(F));
  const size_t smem_attn = (size_t)WARPS * (3 * HD + Sp + Gp) * 4;
  smem = smem > smem_f ? smem : smem_f;
  smem = smem > smem_attn ? smem : smem_attn;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(decode_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_step_kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // one block per SM: every slice of the widest split (F: 11 at 7B) gets
  // at least one block
  const int grid = sms;
  if (grid < num_slices(F) || grid < num_slices(D)) return (int)cudaErrorInvalidConfiguration;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(decode_step_kernel), dim3(grid),
                                    dim3(THREADS), params, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
