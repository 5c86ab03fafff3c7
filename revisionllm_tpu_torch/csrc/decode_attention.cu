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
// S = 318, KH = 32, hd = 128 one layer-step reads 167 MB, about 50 us at
// 3.35 TB/s, against a few MFLOP. The design: one block per (kv head, batch
// row), 2048 blocks at those shapes. A warp reads one 128-byte position row
// per load (lane = 4 int8 values) and positions at or past mask_lens[b] are
// never read. Scores and probabilities stay in shared memory; the value pass
// keeps f32 partial outputs in registers and sums the 4 warps at the end.
// Probabilities are rounded to bf16 before the value product, as the einsum
// path casts p1v and p2 to the activation type.
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/decode_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int U = 4;  // positions a warp loads before it reduces
constexpr float NEG_INF = -2.0e30f;

template <typename PT, int E>
__device__ __forceinline__ void load_row(const PT* p, float (&o)[E]);

template <>
__device__ __forceinline__ void load_row<int8_t, 4>(const int8_t* p, float (&o)[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  o[0] = c.x; o[1] = c.y; o[2] = c.z; o[3] = c.w;
}

template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 4>(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename PT, int HD, int GRP>
__global__ void __launch_bounds__(THREADS) decode_attn_kernel(
    const __nv_bfloat16* __restrict__ q, const PT* __restrict__ pk,
    const PT* __restrict__ pv, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const __nv_bfloat16* __restrict__ gk,
    const __nv_bfloat16* __restrict__ gv, const int* __restrict__ mask_lens,
    __nv_bfloat16* __restrict__ out, int S, int G, int KH, int step, float scale) {
  constexpr int E = HD / 32;  // head dims per lane
  extern __shared__ __align__(16) float sm[];
  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int plen = max(0, min(mask_lens[b], S));
  const int glen = min(step + 1, G);
  const int n = S + G;
  float* sc = sm;                // [GRP][S + G] scores, then bf16-rounded weights
  float* red = sm + GRP * n;     // [NW][GRP] partial max / sum
  float* part = red + NW * GRP;  // [NW][GRP][HD] partial outputs

  float qr[GRP][E];
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    const __nv_bfloat16* qp = q + (((size_t)b * KH + kh) * GRP + g) * HD + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) qr[g][e] = __bfloat162float(qp[e]);
  }

  // scores: s1 = (q . k) * scale * k_scale over the prompt, s2 = (q . k) * scale
  // over the gen slots <= step
  for (int s0 = warp * U; s0 < plen; s0 += NW * U) {
    float kv[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      if (s < plen) {
        load_row<PT, E>(pk + (((size_t)b * S + s) * KH + kh) * HD + lane * E, kv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kv[u][e] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      if (s >= plen) break;  // uniform across the warp
      const float ks = ksc ? ksc[((size_t)b * S + s) * KH + kh] : 1.0f;
#pragma unroll
      for (int g = 0; g < GRP; ++g) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) d += qr[g][e] * kv[u][e];
        d = warp_sum(d);
        if (lane == 0) sc[g * n + s] = d * scale * ks;
      }
    }
  }
  for (int j = warp; j < glen; j += NW) {
    float kv[E];
    load_row<__nv_bfloat16, E>(gk + (((size_t)b * G + j) * KH + kh) * HD + lane * E, kv);
#pragma unroll
    for (int g = 0; g < GRP; ++g) {
      float d = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) d += qr[g][e] * kv[e];
      d = warp_sum(d);
      if (lane == 0) sc[g * n + S + j] = d * scale;
    }
  }
  __syncthreads();

  // one max shared by both pieces
  float m[GRP];
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    float mx = NEG_INF;
    for (int s = tid; s < plen; s += THREADS) mx = fmaxf(mx, sc[g * n + s]);
    for (int j = tid; j < glen; j += THREADS) mx = fmaxf(mx, sc[g * n + S + j]);
    mx = warp_max(mx);
    if (lane == 0) red[warp * GRP + g] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    float mx = red[g];
    for (int w = 1; w < NW; ++w) mx = fmaxf(mx, red[w * GRP + g]);
    m[g] = mx;
  }
  __syncthreads();

  // p = exp(s - m); the denominator sums p in f32; the value weights are
  // p * v_scale (prompt) and p (gen), rounded to bf16
  float den[GRP];
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    float sum = 0.0f;
    for (int s = tid; s < plen; s += THREADS) {
      const float p = expf(sc[g * n + s] - m[g]);
      sum += p;
      const float vs = vsc ? vsc[((size_t)b * S + s) * KH + kh] : 1.0f;
      sc[g * n + s] = round_bf16(p * vs);
    }
    for (int j = tid; j < glen; j += THREADS) {
      const float p = expf(sc[g * n + S + j] - m[g]);
      sum += p;
      sc[g * n + S + j] = round_bf16(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) red[warp * GRP + g] = sum;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    float sum = 0.0f;
    for (int w = 0; w < NW; ++w) sum += red[w * GRP + g];
    den[g] = sum;
  }

  // o = (sum_s w1[s] v[s] + sum_j w2[j] gv[j]) / den
  float acc[GRP][E];
#pragma unroll
  for (int g = 0; g < GRP; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  for (int s0 = warp * U; s0 < plen; s0 += NW * U) {
    float vv[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      if (s < plen) {
        load_row<PT, E>(pv + (((size_t)b * S + s) * KH + kh) * HD + lane * E, vv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) vv[u][e] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      if (s >= plen) break;
#pragma unroll
      for (int g = 0; g < GRP; ++g) {
        const float w = sc[g * n + s];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += w * vv[u][e];
      }
    }
  }
  for (int j = warp; j < glen; j += NW) {
    float vv[E];
    load_row<__nv_bfloat16, E>(gv + (((size_t)b * G + j) * KH + kh) * HD + lane * E, vv);
#pragma unroll
    for (int g = 0; g < GRP; ++g) {
      const float w = sc[g * n + S + j];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] += w * vv[e];
    }
  }
#pragma unroll
  for (int g = 0; g < GRP; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) part[(warp * GRP + g) * HD + lane * E + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < GRP * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float o = 0.0f;
    for (int w = 0; w < NW; ++w) o += part[(w * GRP + g) * HD + d];
    out[(((size_t)b * KH + kh) * GRP + g) * HD + d] = __float2bfloat16(o / den[g]);
  }
}

template <typename PT, int HD, int GRP>
cudaError_t launch(const void* q, const void* pk, const void* pv, const void* ksc,
                   const void* vsc, const void* gk, const void* gv,
                   const void* mask_lens, void* out, int B, int S, int G, int KH,
                   int step, float scale, cudaStream_t stream) {
  const size_t smem = ((size_t)GRP * (S + G) + NW * GRP + (size_t)NW * GRP * HD) * sizeof(float);
  auto kern = decode_attn_kernel<PT, HD, GRP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(KH, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const PT*>(pk),
      static_cast<const PT*>(pv), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const __nv_bfloat16*>(gk),
      static_cast<const __nv_bfloat16*>(gv), static_cast<const int*>(mask_lens),
      static_cast<__nv_bfloat16*>(out), S, G, KH, step, scale);
  return cudaGetLastError();
}

template <typename PT, int HD>
cudaError_t by_group(int group, const void* q, const void* pk, const void* pv,
                     const void* ksc, const void* vsc, const void* gk, const void* gv,
                     const void* mask_lens, void* out, int B, int S, int G, int KH,
                     int step, float scale, cudaStream_t s) {
  switch (group) {
    case 1: return launch<PT, HD, 1>(q, pk, pv, ksc, vsc, gk, gv, mask_lens, out, B, S, G, KH, step, scale, s);
    case 2: return launch<PT, HD, 2>(q, pk, pv, ksc, vsc, gk, gv, mask_lens, out, B, S, G, KH, step, scale, s);
    case 4: return launch<PT, HD, 4>(q, pk, pv, ksc, vsc, gk, gv, mask_lens, out, B, S, G, KH, step, scale, s);
    case 8: return launch<PT, HD, 8>(q, pk, pv, ksc, vsc, gk, gv, mask_lens, out, B, S, G, KH, step, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, KH, group, hd] bf16; prompt k/v [B, S, KH, hd] int8 (prompt_int8 = 1,
// scales [B, S, KH] f32) or bf16 (prompt_int8 = 0, scales null); gen k/v
// [B, G, KH, hd] bf16; mask_lens [B] int32; 0 <= step < G; out [B, KH, group, hd]
// bf16. hd = 128 (Vicuna's head_dim), group in {1, 2, 4, 8}.
extern "C" int decode_attn_bf16(const void* q, const void* pk, const void* pv,
                                const void* ksc, const void* vsc, const void* gk,
                                const void* gv, const void* mask_lens, void* out,
                                int B, int S, int G, int KH, int group, int hd,
                                int prompt_int8, int step, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd != 128) return (int)cudaErrorInvalidValue;
  if (prompt_int8)
    err = by_group<int8_t, 128>(group, q, pk, pv, ksc, vsc, gk, gv, mask_lens, out, B, S, G, KH, step, scale, s);
  else
    err = by_group<__nv_bfloat16, 128>(group, q, pk, pv, ksc, vsc, gk, gv, mask_lens, out, B, S, G, KH, step, scale, s);
  return (int)err;
}
