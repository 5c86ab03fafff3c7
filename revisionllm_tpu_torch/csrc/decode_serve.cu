// Row 10: the whole L-layer decode step over the serving layout in one launch
// (REVISIONLLM_SERVE).
//
// Replaces the Pallas kernel revisionllm_tpu/ops/decode_serve.py:227
// _serve_kernel (entry decode_step_serve :481, pallas_call :530), which
// models/generation.py runs once per decode step when the weights are packed
// by pack_serving_weights: RMSNorm; int8 q/k/v/o/gate/up as column chunks
// [L, nc, D, block_n] and down as row chunks [L, ncf, block_f, D], with
// per-column scales; rope; attention over one unified int8 slab [L, B, 2, H,
// Sp, hd] with per-(position, head) scales, which holds the prompt at [0,
// plen_b) and the tokens generated so far at [S0, S0 + step); SwiGLU;
// residuals. It writes each layer's new k (roped) and v in f32 to newkv [L, 2,
// B, H, hd]; ops/decode_serve.land_new_kv quantizes them into the slab at S0 +
// step after the launch, as JAX does outside its pallas_call. Vicuna-7B: B 64,
// D 4096, H = KH 32, hd 128, F 11008 padded to Fp 11264, S0 ~ 301, step <= 11,
// MHA.
//
// What bounds it on the H100: bytes. A step streams 6.6 GB of int8 layer
// weights (with the padding) and, at B 64 and step 11, about 5 GB of the slab
// and its scales: about 3.5 ms at 3.35 TB/s, as for row 9.
//
// The design is row 9's (decode_common.cuh): one persistent cooperative
// launch, one block per SM, grid barriers between the phases of a layer,
// K-sliced matmul phases that load the activation slice into shared memory
// once per phase, slice sums in a fixed order. What the layout changes:
//   - column chunk c of a matrix is a contiguous [D, block_n] block, so the
//     matmul phase's tensor map walks chunks of cw = block_n columns (3-D:
//     (block_n, D, L * nc)) and a 128-column tile is one box of one chunk;
//     down's row chunks are the row-major [Fp, D] matrix that row 9 reads
//     (cw = D);
//   - the padded gate/up columns have zero weights and zero scale and down's
//     padded rows are zero, so they add exact zeros; the kernel runs over Fp
//     and does not skip them;
//   - attention reads the slab at [0, plen_b) and [S0, S0 + step) only, never
//     the dead range [plen_b, S0) or a position past S0 + step; the
//     generated keys are int8 with scales like the prompt's, so one loop walks
//     both ranges, and the per-warp scores in shared memory hold S0 + step
//     values, not Sp.
//
// The roundings are the TPU kernel's (decode_serve.py:285-465): q, k and v
// stay f32; scores are bf16 q . int8 K times k_scale times hd^-0.5 over both
// ranges; the self term f32 q . k_new; one shared max; p * v_scale rounds to
// bf16 before the value dot; o = (o1 + ps * v) / denom with the unrounded
// denominator.
//
// Plain C interface, bound with ctypes by revisionllm_tpu_torch/ops/decode_serve.py.

#include "decode_common.cuh"

namespace {

// One warp per (row, head). Lanes are 4 key groups x 8 parts of 16 dims:
// lane = 8 kq + p reads dims [16 p, 16 p + 16) of keys t = kq (mod 4). Key t
// of a row is slab position t for t < plen, S0 + t - plen after.
struct SlabAttn {
  static __device__ void run(const Args& a, int l, unsigned char* smem) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int kq = lane >> 3, p = lane & 7;
    const int H = a.H, Sp = a.Sp, S0 = a.S0, step = a.step;
    const float scale = rsqrtf((float)HD);
    float* wsm = reinterpret_cast<float*>(smem) + (size_t)warp * (3 * HD + S0 + step);
    float* qs = wsm;
    float* ks = qs + HD;
    float* vs = ks + HD;
    float* sc = vs + HD;
    for (int item = attn_item(warp); warp < a.awarps && item < a.B * H;
         item += attn_stride(a)) {
      const int b = item / H, h = item % H;
      const int bg = a.b0 + b;
      float qr[4], kr[4];
      qkv_rope(a, l, b, h, qs, ks, vs, qr, kr);
      float* nk = a.newkv + ((((size_t)l * 2 + 0) * a.Bk + bg) * H + h) * HD;
      float* nv = a.newkv + ((((size_t)l * 2 + 1) * a.Bk + bg) * H + h) * HD;
      float self = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = lane + 32 * e;
        qs[d] = qr[e];
        self += qr[e] * kr[e];
        nk[d] = kr[e];
        nv[d] = vs[d];
      }
      const float s_self = warp_sum(self) * scale;
      __syncwarp();
      float qb[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) qb[e] = bf16r(qs[16 * p + e]);

      const int plen = min(a.plen[b], S0);
      const int n = plen + step;
      const size_t kvrow = ((size_t)l * a.Bk + bg) * 2;
      const int8_t* Kp = a.kv + ((kvrow + 0) * H + h) * (size_t)Sp * HD;
      const int8_t* Vp = a.kv + ((kvrow + 1) * H + h) * (size_t)Sp * HD;
      const float* ksc = a.kvsc + ((kvrow + 0) * H + h) * (size_t)Sp;
      const float* vsc = a.kvsc + ((kvrow + 1) * H + h) * (size_t)Sp;
      auto pos = [&](int t) { return t < plen ? t : S0 + (t - plen); };

      // scores: UNROLL batches of 4 keys in flight a lane
      float m = s_self;
      for (int t0 = 0; t0 < n; t0 += 4 * UNROLL) {
        uint4 kraw[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int t = t0 + 4 * u + kq;
          kraw[u] = t < n ? __ldg(reinterpret_cast<const uint4*>(Kp + (size_t)pos(t) * HD + 16 * p))
                          : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          float dot = dot_i8x16(qb, kraw[u]);
          dot += __shfl_xor_sync(0xffffffffu, dot, 1);
          dot += __shfl_xor_sync(0xffffffffu, dot, 2);
          dot += __shfl_xor_sync(0xffffffffu, dot, 4);
          const int t = t0 + 4 * u + kq;
          if (t < n) {
            const float st = (dot * __ldg(ksc + pos(t))) * scale;
            if (p == 0) sc[t] = st;
            m = fmaxf(m, st);
          }
        }
      }
      m = warp_max(m);
      __syncwarp();
      // probabilities: the denominator from the unrounded p, the value
      // weights p * v_scale rounded to bf16
      float sum = 0.0f;
      for (int t = lane; t < n; t += 32) {
        const float pt = expf(sc[t] - m);
        sum += pt;
        sc[t] = bf16r(pt * __ldg(vsc + pos(t)));
      }
      const float ps = expf(s_self - m);
      const float denom = warp_sum(sum) + ps;
      __syncwarp();
      // values: lane accumulates dims [16 p, 16 p + 16) over keys t = kq (mod 4)
      float o1[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) o1[e] = 0.0f;
      for (int t0 = 0; t0 < n; t0 += 4 * UNROLL) {
        uint4 vraw[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int t = t0 + 4 * u + kq;
          vraw[u] = t < n ? __ldg(reinterpret_cast<const uint4*>(Vp + (size_t)pos(t) * HD + 16 * p))
                          : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int t = t0 + 4 * u + kq;
          const float wt = t < n ? sc[t] : 0.0f;
          const unsigned w[4] = {vraw[u].x, vraw[u].y, vraw[u].z, vraw[u].w};
#pragma unroll
          for (int e = 0; e < 16; ++e) o1[e] += wt * i8_at(w[e >> 2], e & 3);
        }
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        o1[e] += __shfl_xor_sync(0xffffffffu, o1[e], 8);
        o1[e] += __shfl_xor_sync(0xffffffffu, o1[e], 16);
      }
      if (kq == 0) {
        __nv_bfloat16* out = a.act + (size_t)b * a.D + h * HD + 16 * p;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          out[e] = __float2bfloat16_rn((o1[e] + ps * vs[16 * p + e]) / denom);
      }
      __syncwarp();
    }
  }
};

}  // namespace

// w: 7 int8 weight pointers, q/k/v/o/gate/up as column chunks [L, nc, D,
// block_n], down as row chunks [L, ncf, block_f, D] (= [L, Fp, D]); s: their
// f32 scales [L, N] (N = D, or Fp for gate/up); norms bf16 [L, D]; kv int8
// [L, Bk, 2, H, Sp, 128], kvsc f32 [L, Bk, 2, H, Sp], the unified slab;
// newkv f32 [L, 2, Bk, H, 128]; this launch takes rows b0 .. b0 + B - 1 (B <=
// 64) of the slab and of newkv, whose plen/cos/sin/x_in/x_out pointers start
// at row b0. Requires D = H * 128, block_n % 128 == 0 dividing D and Fp,
// Fp % 16 == 0, 16-byte aligned pointers, 0 <= step, S0 + step < Sp, and
// prompt lengths <= S0 (a larger one is read as S0).
extern "C" int decode_step_serve(void* const* w, void* const* s, const void* attn_norm,
                                 const void* mlp_norm, const void* kv, const void* kvsc,
                                 void* newkv, const void* plen, const void* cosb,
                                 const void* sinb, const void* x_in, void* x_out, void* xres,
                                 void* act, void* part, int L, int B, int Bk, int b0, int D,
                                 int Fp, int H, int Sp, int S0, int step, int block_n, float eps,
                                 void* stream) {
  if (B < 1 || B > MP || D != H * HD || step < 0 || S0 + step >= Sp || block_n % BN != 0 ||
      D % block_n != 0 || Fp % block_n != 0 || Fp % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  for (int i = 0; i < 7; ++i) {
    a.w[i] = static_cast<const int8_t*>(w[i]);
    a.cw[i] = i < 6 ? block_n : D;
    a.s[i] = static_cast<const float*>(s[i]);
  }
  a.attn_norm = static_cast<const __nv_bfloat16*>(attn_norm);
  a.mlp_norm = static_cast<const __nv_bfloat16*>(mlp_norm);
  a.kv = static_cast<const int8_t*>(kv);
  a.kvsc = static_cast<const float*>(kvsc);
  a.newkv = static_cast<float*>(newkv);
  a.plen = static_cast<const int*>(plen);
  a.cosb = static_cast<const float*>(cosb);
  a.sinb = static_cast<const float*>(sinb);
  a.x_in = static_cast<const __nv_bfloat16*>(x_in);
  a.x_out = static_cast<__nv_bfloat16*>(x_out);
  a.xres = static_cast<__nv_bfloat16*>(xres);
  a.act = static_cast<__nv_bfloat16*>(act);
  a.part = static_cast<float*>(part);
  a.L = L; a.B = B; a.Bk = Bk; a.b0 = b0; a.D = D; a.F = Fp; a.H = H; a.Sp = Sp; a.S0 = S0;
  a.step = step; a.eps = eps;
  return launch_step<SlabAttn>(a, (3 * HD + S0 + step) * 4, stream);
}
