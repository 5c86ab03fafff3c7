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
// persistent cooperative kernel with a grid-wide barrier between the phases of
// a layer; decode_common.cuh holds it and its row, matmul and SwiGLU phases
// (shared with row 10, decode_serve.cu; the matmul phases are wgmma products
// of int8 weights widened in registers, fed by a TMA producer warp), which
// read the standard [L, K, N] weights here. This file gives the attention
// phase: one warp per (row, head)
// computes q/k/v = partials * scale and rope, writes the new k/v into gen slot
// `step` (the mask is slot < step, so that slot is never read in the same
// step), then scores, one shared max, values.
//
// The roundings are the TPU kernel's (decode_step.py:198-480), which are not
// decode_step_split's: q, k and v stay f32; prompt scores are bf16 q . int8 K
// times k_scale times hd^-0.5; gen scores bf16 q . bf16 cache; the self term
// f32 q . k_new; one shared max; p1 * v_scale and p2 round to bf16 before their
// value dots; the self value term is f32; the divide uses the unrounded
// denominator.
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/decode_step.py.

#include "decode_common.cuh"

namespace {

// sum over e of q[e] * (8 bf16 values of v)
__device__ __forceinline__ float dot_bf16x8(const float* q, const uint4& v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  float d = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) d += q[2 * i] * bf_lo(w[i]) + q[2 * i + 1] * bf_hi(w[i]);
  return d;
}

// One warp per (row, head). Lanes are 4 key groups x 8 parts of 16 dims:
// lane = 8 kq + p reads dims [16 p, 16 p + 16) of keys j = kq (mod 4).
struct GenCacheAttn {
  static __device__ void run(const Args& a, int l, unsigned char* smem) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int kq = lane >> 3, p = lane & 7;
    const int H = a.H, Sp = a.Sp, Gp = a.Gp, step = a.step;
    const float scale = rsqrtf((float)HD);
    float* wsm = reinterpret_cast<float*>(smem) + (size_t)warp * (3 * HD + Sp + Gp);
    float* qs = wsm;
    float* ks = qs + HD;
    float* vs = ks + HD;
    float* sc = vs + HD;
    float* p2s = sc + Sp;
    for (int item = attn_item(warp); warp < a.awarps && item < a.B * H;
         item += attn_stride(a)) {
      const int b = item / H, h = item % H;
      const int bg = a.b0 + b;
      float qr[4], kr[4];
      qkv_rope(a, l, b, h, qs, ks, vs, qr, kr);
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
        __nv_bfloat16* out = a.act + (size_t)b * a.D + h * HD + 16 * p;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float o3 = ps * vs[16 * p + e];
          out[e] = __float2bfloat16_rn(((o1[e] + o2[e]) + o3) / denom);
        }
      }
      __syncwarp();
    }
  }
};

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
  Args a{};
  const int widths[7] = {D, D, D, D, F, F, D};
  for (int i = 0; i < 7; ++i) {
    a.w[i] = static_cast<const int8_t*>(w[i]);
    a.cw[i] = widths[i];
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
  return launch_step<GenCacheAttn>(a, (3 * HD + Sp + Gp) * 4, stream);
}
