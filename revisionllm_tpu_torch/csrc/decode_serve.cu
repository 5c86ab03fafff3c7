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
//     the dead range [plen_b, S0) or a position past S0 + step: an item is
//     two int8 segments for csrc/decode_attn_common.cuh's core, each a
//     contiguous run of the slab that the producer warp copies with 1-D
//     bulk copies, and the scores in shared memory hold S0 + step values,
//     not Sp.
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

// Key t of a row is slab position t for t < plen, S0 + t - plen after.
struct SlabAttn {
  static constexpr int TB = ATILE, GRP = 1, P = 8, SST = 1, SCL = ASCL, GU = AGU;
  const Args& a;
  int l;
  float scale;

  __device__ int plen_of(int item) const { return max(0, min(a.plen[item / a.H], a.S0)); }
  // the slab's two ranges (int8; their K and V scale runs' offsets in
  // their aligned covers, run_of's first index % 4)
  __device__ dattn::Plan plan_of(int item, int plen) const {
    dattn::Plan p;
    p.ns = 2;
    p.s[0] = {plen, 0, 1, (int)(run_of(item, 0, 0, 0) & 3), (int)(run_of(item, 1, 0, 0) & 3)};
    p.s[1] = {a.step, plen, 1, (int)(run_of(item, 0, 1, 0) & 3), (int)(run_of(item, 1, 1, 0) & 3)};
    return p;
  }
  // the first index of slab positions p0 .. of range si (the second from S0)
  // of K or V (side) of the item in kv (times HD) and kvsc
  __device__ size_t run_of(int item, int side, int si, int p0) const {
    const int bg = a.b0 + item / a.H, h = item % a.H;
    return ((((size_t)l * a.Bk + bg) * 2 + side) * a.H + h) * a.Sp + (si == 0 ? 0 : a.S0) + p0;
  }
  __device__ float score(float d, float ks) const { return (d * ks) * scale; }

  // slab positions p0 .. p0 + nv - 1 of range si of K or V (side), and
  // their scales (scale_cover)
  __device__ void issue(int item, int side, int si, int p0, int nv, unsigned char* dst,
                        float* sdst, uint64_t* bar) const {
    const size_t run = run_of(item, side, si, p0);
    const uint32_t sbytes = scale_cover(run, nv);
    const uint64_t pol = dattn::evict_first();
    wonly::mbar_arrive_expect(bar, (uint32_t)nv * HD + sbytes);
    dattn::bulk_load(dst, a.kv + run * HD, (uint32_t)nv * HD, bar, pol);
    dattn::bulk_load(sdst, a.kvsc + (run & ~(size_t)3), sbytes, bar, pol);
  }

  // this step's k (which 0, roped) or v (1) at dim d, f32, into newkv
  __device__ void store_new(int b, int h, int which, int d, float v) const {
    a.newkv[((((size_t)l * 2 + which) * a.Bk + a.b0 + b) * a.H + h) * HD + d] = v;
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
  return launch_step<SlabAttn>(a, S0 + step, stream);
}
