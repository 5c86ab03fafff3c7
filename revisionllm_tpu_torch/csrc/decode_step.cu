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
// a layer; decode_common.cuh holds it and its row, matmul, SwiGLU and
// attention phases (shared with row 10, decode_serve.cu; the matmul phases
// are wgmma products of int8 weights widened in registers, fed by a TMA
// producer warp, the attention phase runs csrc/decode_attn_common.cuh's
// core), which read the standard [L, K, N] weights here. This file gives the
// attention phase's source: an item (row, head) is its prompt, plen int8
// positions with scales, and the gen slots < step in bf16, each a contiguous
// run of the packed caches that the producer warp copies with 1-D bulk
// copies; the new k/v go into gen slot `step` (the mask is slot < step, so
// that slot is never read in the same step).
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

struct GenCacheAttn {
  static constexpr int TB = ATILE, GRP = 1, P = 8, SST = 1, SCL = ASCL, GU = AGU;
  const Args& a;
  int l;
  float scale;

  __device__ int plen_of(int item) const { return max(0, min(a.plen[item / a.H], a.Sp)); }
  // the prompt (int8; its K and V scale runs' offsets in their aligned
  // covers, run_of's first index % 4), then the gen slots < step (bf16)
  __device__ dattn::Plan plan_of(int item, int plen) const {
    dattn::Plan p;
    p.ns = 2;
    p.s[0] = {plen, 0, 1, (int)(run_of(item, 0, 0, 0) & 3), (int)(run_of(item, 1, 0, 0) & 3)};
    p.s[1] = {a.step, plen, 0, 0, 0};
    return p;
  }
  // the first index of positions p0 .. of K or V (side) of the item's
  // prompt in kv [L, Bk, 2, H, Sp, HD] (times HD) and kvsc, or of its gen
  // slots in genkv [L, 2, Bk, H, Gp, HD] (times HD)
  __device__ size_t run_of(int item, int side, int si, int p0) const {
    const int bg = a.b0 + item / a.H, h = item % a.H;
    return si == 0 ? ((((size_t)l * a.Bk + bg) * 2 + side) * a.H + h) * a.Sp + p0
                   : ((((size_t)l * 2 + side) * a.Bk + bg) * a.H + h) * a.Gp + p0;
  }
  __device__ float score(float d, float ks) const { return (d * ks) * scale; }

  // the run of K or V (side) of (row, head) of layer l: prompt positions p0
  // .. p0 + nv - 1 and their scales (scale_cover), or gen slots
  __device__ void issue(int item, int side, int si, int p0, int nv, unsigned char* dst,
                        float* sdst, uint64_t* bar) const {
    const size_t run = run_of(item, side, si, p0);
    const uint64_t pol = dattn::evict_first();
    const uint32_t bytes = (uint32_t)nv * HD * (si == 0 ? 1 : 2);
    if (si == 0) {
      const uint32_t sbytes = scale_cover(run, nv);
      wonly::mbar_arrive_expect(bar, bytes + sbytes);
      dattn::bulk_load(dst, a.kv + run * HD, bytes, bar, pol);
      dattn::bulk_load(sdst, a.kvsc + (run & ~(size_t)3), sbytes, bar, pol);
    } else {
      wonly::mbar_arrive_expect(bar, bytes);
      dattn::bulk_load(dst, a.genkv + run * HD, bytes, bar, pol);
    }
  }

  // this step's k (which 0, roped) or v (1) at dim d into gen slot `step`
  __device__ void store_new(int b, int h, int which, int d, float v) const {
    const size_t slot = ((((size_t)l * 2 + which) * a.Bk + a.b0 + b) * a.H + h) * a.Gp + a.step;
    a.genkv[slot * HD + d] = __float2bfloat16_rn(v);
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
  return launch_step<GenCacheAttn>(a, Sp + Gp, stream);
}
