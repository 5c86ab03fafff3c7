"""K3 at group 16 (csrc/decode_attention.cu, decode_attn_kernel_g16:
ChatGLM2-6B's 32 query heads over 2 kv heads) emulated in numpy on the CPU:

- the split of each (row, kv head) item's walk (the S prompt positions,
  masked at mask_lens, then the gen slots 0..step) over the ranks of a
  thread-block cluster, in rounds of slices of 16 positions, a slice a warp;
- the mma.sync m16n8k16 fragments each lane owns (q and K in the permuted
  head-dim order, the scores as the value product's A, V with output dim
  16 g + j in n-tile j), multiplied as whole tiles;
- the item's one max: each block's (its warps' in warp order), exchanged
  over the cluster in rank order; p masked on itself past the rank's range,
  the block's sums of its warps in warp order and the cluster's in rank
  order.

The emulation is held against decode_attention_plain and, run inside the
port's decode_step_split, against JAX's decode_step_split at group 16 (KH 2
and KH 1, steps 0 and 11, a P-tuning prefix: mask_lens above prompt_lens),
with a rank whose positions are all masked and with ranks of several
rounds. A source check ties the kernel's constants to their Python mirror.
No GPU is needed."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.config import LlamaConfig as JCfg
from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu_torch.config import LlamaConfig as TCfg
from revisionllm_tpu_torch.models import llama as tllama
from revisionllm_tpu_torch.ops import decode_attention as TDA

from torch_parity import to_torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
K3SRC = (ROOT / "revisionllm_tpu_torch" / "csrc" / "decode_attention.cu").read_text()
HD, GRP = 128, 16
F32 = np.float32
NEG_INF = F32(-2.0e30)


def const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", K3SRC).group(1))


def bf16_round(x):
    """Round-to-nearest-even f32 -> bf16 -> f32."""
    u = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(F32)


# ------------------------------------------------ the m16n8k16 fragments

LANE = np.arange(32)
G_, T_ = LANE // 4, LANE % 4
HALF = np.arange(2)
# A (16 x 16): register r, half i of lane (g, t) holds (row, k):
# r0 (g, 2t + i), r1 (g + 8, 2t + i), r2 (g, 2t + 8 + i), r3 (g + 8, 2t + 8 + i)
A_ROW = np.broadcast_to(np.stack([G_, G_ + 8, G_, G_ + 8], 1)[:, :, None], (32, 4, 2))
A_COL = np.stack([2 * T_, 2 * T_, 2 * T_ + 8, 2 * T_ + 8], 1)[:, :, None] + HALF
# B (16 x 8): register r, half i: (k 2t + 8r + i, n g)
B_ROW = np.stack([2 * T_, 2 * T_ + 8], 1)[:, :, None] + HALF
B_COL = np.broadcast_to(G_[:, None, None], (32, 2, 2))
# C (16 x 8): register r: (g + 8 (r >> 1), 2t + (r & 1))
C_ROW = np.stack([G_, G_, G_ + 8, G_ + 8], 1)
C_COL = np.stack([2 * T_, 2 * T_ + 1, 2 * T_, 2 * T_ + 1], 1)


def mma(a, b):
    """The m16n8k16 product of lane fragments a [..., 32, 4, 2] and b [...,
    32, 2, 2] (bf16 values) as C fragments [..., 32, 4] (f32): the tiles
    are assembled from the lanes by the layouts, multiplied, and handed
    back by C's layout."""
    A = np.zeros(a.shape[:-3] + (16, 16), F32)
    B = np.zeros(b.shape[:-3] + (16, 8), F32)
    A[..., A_ROW, A_COL] = a
    B[..., B_ROW, B_COL] = b
    return np.matmul(A, B)[..., C_ROW, C_COL]


def q_dims(kk):
    """[32, 4, 2]: the head dim of q's A fragment of k step kk, register r,
    half i: 32 t + 4 kk + 2 (r >> 1) + i (rows g for r 0 and 2, g + 8 for 1
    and 3): one 64-byte read of a bf16 row a lane."""
    return (32 * T_[:, None, None] + 4 * kk + 2 * (np.arange(4) >> 1)[None, :, None]
            + HALF[None, None, :])


def k_dims(kk):
    """[32, 2, 2]: the head dim of K's B fragment (register r, half i) of k
    step kk: 32 t + 4 kk + 2 r + i, for the lane's position g of the n-tile
    (one 32-byte read of an int8 row, 64 of a bf16 one)."""
    return 32 * T_[:, None, None] + 4 * kk + 2 * np.arange(2)[None, :, None] + HALF


def out_dims(j):
    """[32, 4]: the output dim of C register r of n-tile j of the value
    product: 16 (2t + (r & 1)) + j (V's B column g holds dim 16 g + j)."""
    return 16 * (2 * T_[:, None] + (np.arange(4) & 1)[None, :]) + j


def test_fragments_cover_every_element_once():
    """A, B and C each lane-owned once; q's and K's head dims agree and
    cover the 128 dims once over a lane's k steps and the quad; V's n
    columns and the outputs' dims cover 128 once."""
    for rows, cols, shape in ((A_ROW, A_COL, (16, 16)), (B_ROW, B_COL, (16, 8)),
                              (C_ROW, C_COL, (16, 8))):
        seen = np.zeros(shape, int)
        np.add.at(seen, (rows, cols), 1)
        assert (seen == 1).all()
    for kk in range(HD // 16):
        # A's k = 2t + 8s + i must be read at the same dim as B's k = 2t + 8s + i
        qd = q_dims(kk)
        kd = k_dims(kk)
        np.testing.assert_array_equal(qd[:, [0, 2]], kd)
        np.testing.assert_array_equal(qd[:, [1, 3]], kd)
    per_g = np.concatenate([k_dims(kk)[G_ == 0].reshape(-1) for kk in range(HD // 16)])
    assert sorted(per_g.tolist()) == list(range(HD))
    v = np.stack([16 * G_ + j for j in range(HD // 8)])  # [n-tile, lane]
    assert sorted(v[:, T_ == 0].reshape(-1).tolist()) == list(range(HD))
    out = np.stack([out_dims(j) for j in range(HD // 8)])  # [n-tile, lane, r]
    seen = np.zeros((16, HD), int)
    for j in range(HD // 8):
        np.add.at(seen, (C_ROW, out[j]), 1)
    assert (seen == 1).all()


def test_fragment_products_are_the_dot_products():
    """q . k and p . V through the fragments equal the plain products."""
    rng = np.random.default_rng(0)
    q = bf16_round(rng.normal(size=(16, HD)))
    k = rng.integers(-128, 128, (16, HD)).astype(F32)
    c = sum(mma(q[A_ROW, q_dims(kk)], np.stack([k[8 * nt + B_COL, k_dims(kk)]
                                                 for nt in range(2)]))
            for kk in range(HD // 16))  # [2 n-tiles, 32, 4]
    s = np.zeros((16, 16), F32)
    for nt in range(2):
        s[C_ROW, 8 * nt + C_COL] = c[nt]
    np.testing.assert_allclose(s, q @ k.T, rtol=1e-6, atol=1e-3)
    w = bf16_round(rng.random((16, 16)))
    v = rng.integers(-128, 128, (16, HD)).astype(F32)
    pa = np.stack([w[A_ROW[:, r], A_COL[:, r]] for r in range(4)], 1)
    o = np.zeros((16, HD), F32)
    for j in range(HD // 8):
        vb = v[B_ROW, 16 * B_COL + j]
        o[C_ROW, out_dims(j)] = mma(pa, vb)
    np.testing.assert_allclose(o, w @ v, rtol=1e-6, atol=1e-3)


# ------------------------------------------------------- the emulation


def g16_ranges(n, split):
    """Each rank's [t0, t1) of an item's walk of n = S + step + 1 positions
    (the S prompt positions, masked at mask_lens, then the gen slots
    0..step): ceil(n / split) a rank, the last ones short or empty (the
    kernel's t0 and t1)."""
    chunk = -(-n // split)
    return [(min(n, r * chunk), min(n, r * chunk + chunk)) for r in range(split)]


def slice_scores(qa, kw, ksw, prw, lvw, tw, t1, scale):
    """A warp's scores of a slice starting at walk position tw (range end
    t1): [2 n-tiles, 32 lanes, 4] C fragments, register r for query g + 8 (r
    >> 1) at position 8 nt + 2t + (r & 1); NEG_INF where masked (lvw) or
    past the range. Also the positions, whether each is live and an int8
    prompt one."""
    n = kw.shape[0]
    pos = tw + np.arange(TDA.KG16_SLICE)
    idx = np.minimum(pos, n - 1)
    ks = kw[idx] * ((pos < t1) & lvw[idx])[:, None]  # zeros where masked
    kb = np.stack([np.stack([ks[8 * nt + B_COL, k_dims(kk)] for kk in range(HD // 16)])
                   for nt in range(2)])  # [nt, kk, 32, 2, 2]
    c = np.zeros((2, 32, 4), F32)
    for kk in range(HD // 16):
        c = c + mma(qa[kk][None], kb[:, kk])
    tp = tw + 8 * np.arange(2)[:, None, None] + 2 * T_[None, :, None] + (np.arange(4) & 1)
    tc = np.minimum(tp, n - 1)
    live = (tp < t1) & lvw[tc]
    pr = live & prw[tc]
    d = (c * F32(scale)).astype(F32)
    s = np.where(live, np.where(pr, d * np.where(pr, ksw[tc], F32(1)), d), NEG_INF).astype(F32)
    return s, tc, live, pr


def emulate_item(q, kw, vw, ksw, vsw, prw, lvw, split, scale):
    """One item through decode_attn_kernel_g16 as its lanes run it. q [16,
    HD] (bf16 values); the walk's K and V rows kw, vw [n, HD] (int8 or bf16
    values: the S prompt positions, then the gen slots 0..step), their k and
    v scales ksw, vsw [n], prw [n] (True where the position is an int8
    prompt one) and lvw [n] (True where it is live: a prompt position below
    the mask length, or a gen slot). Returns (out [16, HD] bf16 values, each
    rank's max [split, 16])."""
    n = kw.shape[0]
    WARPS, SLICE, ROUND = TDA.KG16_WARPS, TDA.KG16_SLICE, TDA.KG16_ROUND
    qa = np.stack([q[A_ROW, q_dims(kk)] for kk in range(HD // 16)])  # [kk, 32, 4, 2]
    ranges = g16_ranges(n, split)

    def slices(t0, t1, w):
        return [t0 + rd * ROUND + w * SLICE for rd in range(-(-(t1 - t0) // ROUND))
                if t0 + rd * ROUND + w * SLICE < t1]

    # pass 0: each warp's max (its lanes, then the quad), the block's in warp
    # order, the cluster's in rank order
    bms = []
    for t0, t1 in ranges:
        bm = np.full(GRP, NEG_INF, F32)
        for w in range(WARPS):
            mx = np.full((32, 2), NEG_INF, F32)
            for tw in slices(t0, t1, w):
                s = slice_scores(qa, kw, ksw, prw, lvw, tw, t1, scale)[0]
                mx = np.maximum(mx, np.stack([s[:, :, [0, 1]].max(axis=(0, 2)),
                                              s[:, :, [2, 3]].max(axis=(0, 2))], 1))
            for o_ in (1, 2):
                mx = np.maximum(mx, mx[LANE ^ o_])
            bm = np.maximum(bm, np.concatenate([mx[T_ == 0, 0], mx[T_ == 0, 1]]))
        bms.append(bm)
    m = np.full(GRP, NEG_INF, F32)
    for bm in bms:
        m = np.maximum(m, bm)
    mrow = np.stack([m[G_], m[G_], m[G_ + 8], m[G_ + 8]], 1)[None]  # [1, 32, 4]
    # pass 1: p, its sums and the value product; the warps' sums in warp
    # order, the ranks' in rank order
    acc = np.zeros((GRP, HD), F32)
    ll = np.zeros(GRP, F32)
    for t0, t1 in ranges:
        ob = np.zeros((GRP, HD), F32)
        lb = np.zeros(GRP, F32)
        for w in range(WARPS):
            l_run = np.zeros((32, 2), F32)
            o = np.zeros((HD // 8, 32, 4), F32)
            for tw in slices(t0, t1, w):
                s, tc, live, pr = slice_scores(qa, kw, ksw, prw, lvw, tw, t1, scale)
                p = np.where(live, np.exp(s - mrow), F32(0)).astype(F32)
                for nt in range(2):  # the kernel's order: nt, then e, each h
                    for e in range(2):
                        l_run = (l_run + p[nt][:, [e, 2 + e]]).astype(F32)
                wv = bf16_round(np.where(pr, p * np.where(pr, vsw[tc], F32(1)), p))
                # A of the value product: r0 (nt 0, h 0), r1 (0, 1), r2 (1, 0), r3 (1, 1)
                pa = np.stack([wv[0][:, [0, 1]], wv[0][:, [2, 3]], wv[1][:, [0, 1]],
                               wv[1][:, [2, 3]]], 1)
                pos = tw + np.arange(SLICE)
                idx = np.minimum(pos, n - 1)
                vs = vw[idx] * ((pos < t1) & lvw[idx])[:, None]
                vb = np.stack([vs[B_ROW, 16 * B_COL + j] for j in range(HD // 8)])
                o = o + mma(pa[None], vb)
            for o_ in (1, 2):
                l_run = (l_run + l_run[LANE ^ o_]).astype(F32)
            part = np.zeros((GRP, HD), F32)
            for j in range(HD // 8):
                part[C_ROW, out_dims(j)] = o[j]
            ob = (ob + part).astype(F32)
            lb = (lb + np.concatenate([l_run[T_ == 0, 0], l_run[T_ == 0, 1]])).astype(F32)
        acc = (acc + ob).astype(F32)
        ll = (ll + lb).astype(F32)
    return bf16_round(acc / ll[:, None]), np.stack(bms)


def g16_emulated(q, pk, pv, ks, vs, gk, gv, lens, step, ranks=None):
    """K3 at group 16 through the emulated kernel, item by item: [B, KH,
    16, HD] (bf16 values). `ranks`, if a list, gets each item's (ranges,
    the ranks' maxima)."""
    B, KH, group, hd = q.shape
    assert group == GRP and hd == HD
    S = pk.shape[1]
    i8 = ks is not None
    split = TDA.g16_split(S, step)
    out = np.zeros(q.shape, F32)
    n = S + step + 1
    for b in range(B):
        plen = int(min(max(lens[b], 0), S))
        lvw = (np.arange(n) < plen) | (np.arange(n) >= S)
        for kh in range(KH):
            kw = np.concatenate([pk[b, :, kh].astype(F32), gk[b, :step + 1, kh]])
            vw = np.concatenate([pv[b, :, kh].astype(F32), gv[b, :step + 1, kh]])
            one = np.ones(step + 1, F32)
            ksw = np.concatenate([ks[b, :, kh], one]) if i8 else np.ones(n, F32)
            vsw = np.concatenate([vs[b, :, kh], one]) if i8 else np.ones(n, F32)
            prw = np.arange(n) < S if i8 else np.zeros(n, bool)
            out[b, kh], m = emulate_item(q[b, kh], kw, vw, ksw, vsw, prw, lvw, split, HD ** -0.5)
            if ranks is not None:
                ranks.append(([(t0, t1, bool(lvw[t0:t1].any()))
                               for t0, t1 in g16_ranges(n, split)], m))
    return out


def g16_inputs(B, KH, S, G, seed, quant=True):
    """bf16-valued q and gen cache (f32 arrays), an int8 prompt with scales
    in [0.005, 0.025) (or a bf16 one)."""
    rng = np.random.default_rng(seed)
    q = bf16_round(rng.normal(size=(B, KH, GRP, HD)))
    gk, gv = (bf16_round(rng.normal(size=(B, G, KH, HD))) for _ in range(2))
    if quant:
        pk, pv = (rng.integers(-127, 128, (B, S, KH, HD)).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.025, (B, S, KH)).astype(F32) for _ in range(2))
    else:
        pk, pv = (bf16_round(rng.normal(size=(B, S, KH, HD))) for _ in range(2))
        ks = vs = None
    return q, pk, pv, ks, vs, gk, gv


def plain(q, pk, pv, ks, vs, gk, gv, lens, step):
    t = torch.from_numpy
    bf = torch.bfloat16
    return TDA.decode_attention_plain(
        t(q).to(bf), t(pk) if ks is not None else t(pk).to(bf),
        t(pv) if ks is not None else t(pv).to(bf), None if ks is None else t(ks),
        None if vs is None else t(vs), t(gk).to(bf), t(gv).to(bf), t(lens), step).float().numpy()


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def hold(got, want):
    """The rows 4-6 limits on K3's output (chip_smoke.hold_k3): relative L2
    within 1e-2 whole and 2e-2 on each (row, head, query) vector, and the
    kernel check's max abs error of 1e-2. Both sides round p * v_scale and
    p to bf16 against the same max; the scores and sums are f32 in another
    order, so a weight one f32 ulp from a bf16 boundary may round the other
    way."""
    assert rel_l2(got, want) <= 1e-2
    g2, w2 = got.reshape(-1, HD), want.reshape(-1, HD)
    per = np.linalg.norm(g2 - w2, axis=1) / np.linalg.norm(w2, axis=1)
    assert per.max() <= 2e-2
    assert np.abs(got - want).max() <= 1e-2


# ChatGLM2-6B's decode step: 300 prompt positions after a P-tuning prefix
# of 128 (mask_lens = prompt_lens + 128), 12 gen slots
GLM_S, GLM_G = 300 + 128, 12


@pytest.mark.parametrize("KH", [2, 1])
@pytest.mark.parametrize("step", [0, 11])
def test_emulated_g16_matches_plain_at_chatglm2s_shape(KH, step):
    """S 428, live lengths 408-428 (the prefix's 128 in each), one round a
    rank."""
    B = 2
    args = g16_inputs(B, KH, GLM_S, GLM_G, seed=10 * KH + step)
    lens = np.array([GLM_S, GLM_S - 20], np.int32)
    assert TDA.g16_split(GLM_S, step) == 7
    ranks = []
    got = g16_emulated(*args, lens, step, ranks)
    hold(got, plain(*args, lens, step))
    assert all(t1 - t0 <= TDA.KG16_ROUND for rr, _ in ranks for t0, t1, _ in rr)


@pytest.mark.parametrize("step", [0, 11])
def test_emulated_g16_with_wholly_masked_ranks(step):
    """Short live lengths (mask_lens 0 and 3 of S 428) leave ranks whose
    positions are all masked, and slices part masked: such a rank's max is
    NEG_INF and it adds nothing to the sums."""
    args = g16_inputs(2, 2, GLM_S, GLM_G, seed=30 + step)
    lens = np.array([3, 0], np.int32)
    ranks = []
    got = g16_emulated(*args, lens, step, ranks)
    masked = [m for rr, ms in ranks for (_, _, live), m in zip(rr, ms) if not live]
    assert masked and all((m == NEG_INF).all() for m in masked)
    hold(got, plain(*args, lens, step))
    assert np.isfinite(got).all()


def test_emulated_g16_never_uses_the_cache_past_the_mask():
    """The kernel copies the prompt rows past mask_lens (its ranges do not
    depend on the lengths) but never uses them: NaN scales and any int8
    there leave the output finite and equal to the plain version's on the
    cache with those scales at 1 (where the plain version's p1 * v_scale is
    0 * 1; with NaN it would be NaN)."""
    B, KH, step = 2, 2, 11
    q, pk, pv, ks, vs, gk, gv = g16_inputs(B, KH, GLM_S, GLM_G, seed=37)
    lens = np.array([GLM_S - 60, 150], np.int32)
    past = np.arange(GLM_S)[None, :] >= lens[:, None]
    clean = [np.where(past[..., None], F32(1), t) for t in (ks, vs)]
    dirty = [np.where(past[..., None], F32(np.nan), t) for t in (ks, vs)]
    pk2, pv2 = (np.where(past[..., None, None], np.int8(-128), t) for t in (pk, pv))
    got = g16_emulated(q, pk2, pv2, *dirty, gk, gv, lens, step)
    assert np.isfinite(got).all()
    hold(got, plain(q, pk, pv, *clean, gk, gv, lens, step))


def test_emulated_g16_over_several_rounds():
    """S 1100: 8 ranks of 140 positions, three rounds each, streamed twice
    through the stages (K for the max, then K and V)."""
    S, step = 1100, 5
    args = g16_inputs(1, 2, S, 8, seed=41)
    lens = np.array([S - 3], np.int32)
    ranks = []
    got = g16_emulated(*args, lens, step, ranks)
    assert TDA.g16_split(S, step) == TDA.KG16_CLUSTER
    assert max(t1 - t0 for rr, _ in ranks for t0, t1, _ in rr) > 2 * TDA.KG16_ROUND
    hold(got, plain(*args, lens, step))


def test_emulated_g16_bf16_prompt():
    """KV8 off: a bf16 prompt cache, every position bf16."""
    args = g16_inputs(2, 2, 200, GLM_G, seed=43, quant=False)
    lens = np.array([200, 137], np.int32)
    hold(g16_emulated(*args, lens, 7), plain(*args, lens, 7))


def test_emulated_g16_is_deterministic():
    args = g16_inputs(1, 1, 150, 4, seed=47)
    lens = np.array([150], np.int32)
    np.testing.assert_array_equal(g16_emulated(*args, lens, 2), g16_emulated(*args, lens, 2))


# ------------------------------------------------ the source and mirror


def test_g16_constants_match_the_source():
    """The kernel's constants, its split and its shared memory against
    ops/decode_attention.py's mirror; its name is one the profiler counts
    as K3 (chip_smoke.KERNEL_GROUPS)."""
    for name in ("KG16_WARPS", "KG16_SLICE", "KG16_STAGES", "KG16_CLUSTER", "KG16_ROW"):
        assert const(name) == getattr(TDA, name), name
    assert "decode_attn_kernel_g16" in K3SRC
    body = re.search(r"constexpr int g16_split\(int S, int step\) \{\s*return (.*?);\s*\}",
                     K3SRC, re.S).group(1)
    cond, rest = body.split("?")
    then, other = rest.split(":")
    env = {"KG16_ROUND": TDA.KG16_ROUND, "KG16_CLUSTER": TDA.KG16_CLUSTER}

    def c_eval(expr, S, step):
        return eval(" ".join(expr.split()).replace("/", "//"), {}, {**env, "S": S, "step": step})

    for S in (1, 63, 64, 300, 428, 511, 512, 513, 4084):
        for step in (0, 11, 63):
            want = c_eval(then, S, step) if c_eval(cond, S, step) else c_eval(other, S, step)
            assert TDA.g16_split(S, step) == want
    # the shared memory: the stages (K and V rows, two scales a position),
    # the inbox of a rank's outputs and of every rank's max and sum, the
    # cluster's max, the warps' max and sum
    smem = re.search(r"constexpr int KG16_SMEM = (.*?);", K3SRC, re.S).group(1)
    stage = 2 * TDA.KG16_ROUND * TDA.KG16_ROW + TDA.KG16_ROUND * 8
    env.update(KG16_STAGE=stage, KG16_STAGES=TDA.KG16_STAGES, KG16_Q=16, HD=HD,
               KG16_WARPS=TDA.KG16_WARPS)
    want = (TDA.KG16_STAGES * stage + (16 * HD + 4 * TDA.KG16_CLUSTER) * 4
            + 2 * TDA.KG16_CLUSTER * 16 * 4 + 16 * 4 + 2 * TDA.KG16_WARPS * 16 * 4)
    assert eval(" ".join(smem.split()), {}, env) == want <= TDA.SMEM_MAX
    import chip_smoke

    pattern = dict((label, pat) for label, pat in chip_smoke.KERNEL_GROUPS)["K3 decode_attention"]
    assert re.search(pattern, "(anonymous namespace)::decode_attn_kernel_g16<signed char>(GArgs)")


@pytest.mark.parametrize("n", [1, 5, 55, 64, 440, 441, 1000])
def test_g16_ranges_cover_the_walk_once(n):
    for split in range(1, TDA.KG16_CLUSTER + 1):
        rr = g16_ranges(n, split)
        assert rr[0][0] == 0 and rr[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(rr, rr[1:]))
        assert all(t1 - t0 <= -(-n // split) for t0, t1 in rr)


def test_chatglm2_shape_fills_the_card_in_one_wave_of_rounds():
    """B 8, KH 2, S 428, step 11: 7 ranks, 112 blocks, each one round."""
    split = TDA.g16_split(GLM_S, 11)
    assert split * 8 * 2 == 112
    assert all(t1 - t0 <= TDA.KG16_ROUND for t0, t1 in g16_ranges(GLM_S + 12, split))


# ------------------------------------- inside decode_step_split, against JAX


def _glm_cfgs(KH):
    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_layers=1,
              num_heads=GRP * KH, num_kv_heads=KH, head_dim=HD, dtype="float32",
              rope_fraction=0.5, rope_interleaved=True, qkv_bias=True)
    return JCfg(**kw), TCfg(**kw)


def _emulated_k3(q, pk, pv, ks, vs, gk, gv, lens, step):
    """decode_attention's contract, by the emulated kernel: q and the gen
    cache rounded to bf16 as the card's model hands them over."""
    f = lambda t: None if t is None else t.float().numpy()  # noqa: E731
    out = g16_emulated(bf16_round(f(q)), f(pk).astype(np.int8) if ks is not None else f(pk),
                       f(pv).astype(np.int8) if ks is not None else f(pv), f(ks), f(vs),
                       bf16_round(f(gk)), bf16_round(f(gv)), lens.numpy(), int(step))
    return torch.from_numpy(out).to(q.dtype)


@pytest.mark.parametrize("KH", [2, 1])
def test_decode_step_split_at_group_16_matches_jax(KH, monkeypatch):
    """One ChatGLM2-geometry layer (group 16, head_dim 128, interleaved half
    rotary, q/k/v biases) in f32 over an int8 prompt cache with a 128-position
    P-tuning prefix (mask_lens = prompt_lens + 128, rope on prompt_lens):
    the port's decode_step_split with K3 emulated against JAX's at steps 0
    and 11. The emulation rounds q, the gen cache and the weights to bf16
    where JAX keeps f32: logits within 2e-2 of the largest."""
    jcfg, tcfg = _glm_cfgs(KH)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(KH), jnp.float32)
    rng = np.random.default_rng(50 + KH)
    layers = dict(jp["layers"])
    for name in ("q_bias", "k_bias", "v_bias"):
        layers[name] = jnp.asarray(0.3 * rng.normal(size=layers[name].shape), jnp.float32)
    jp = {**jp, "layers": layers}
    tp = to_torch(jp)
    B, P, G = 2, 128, GLM_G
    S = 60 + P
    prompt_lens = np.array([60, 41], np.int32)
    mask_lens = prompt_lens + P
    pkv = {"k": rng.integers(-127, 128, (1, B, S, KH, HD)).astype(np.int8),
           "v": rng.integers(-127, 128, (1, B, S, KH, HD)).astype(np.int8),
           "k_scale": rng.uniform(0.005, 0.025, (1, B, S, KH)).astype(F32),
           "v_scale": rng.uniform(0.005, 0.025, (1, B, S, KH)).astype(F32)}
    gen = {n: bf16_round(rng.normal(size=(1, B, G, KH, HD))) for n in ("k", "v")}
    monkeypatch.setattr(tllama, "decode_attention", _emulated_k3)
    for step in (0, 11):
        tok = (rng.normal(size=(B, 1, jcfg.hidden_size)) * 0.5).astype(F32)
        want, _ = jllama.decode_step_split(
            jcfg, jp, {k: jnp.asarray(v) for k, v in pkv.items()}, jnp.asarray(prompt_lens),
            {k: jnp.asarray(v) for k, v in gen.items()}, jnp.asarray(step, jnp.int32),
            jnp.asarray(tok), mask_lens=jnp.asarray(mask_lens))
        got, _ = tllama.decode_step_split(
            tcfg, tp, {k: torch.from_numpy(v) for k, v in pkv.items()},
            torch.from_numpy(prompt_lens), {k: torch.from_numpy(v.copy()) for k, v in gen.items()},
            step, torch.from_numpy(tok), mask_lens=torch.from_numpy(mask_lens))
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 2e-2, (step, err)


@pytest.mark.parametrize("cut", ["g16empty", "g16nocopy", "g16nomax", "g16nosum", "g16time"])
def test_k3_probe_group16_cuts_find_their_lines(cut, tmp_path, monkeypatch):
    """scripts/torch_decode_attention_kernel.py's group-16 cuts and its
    clock instrument each edit the kernel's own lines (an edit whose line is
    gone stops the probe); the instrument marks every interval."""
    import sys

    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_decode_attention_kernel as k3_probe

    monkeypatch.setattr(k3_probe, "OUT", tmp_path)
    (src, spec, _), = k3_probe.sources({"v": cut}).values()
    assert spec == cut and src != K3SRC
    edits = k3_probe.G16_TIME if cut == "g16time" else k3_probe.G16_CUTS[cut]
    for old, new in edits:
        assert old in K3SRC and (new in src)
    assert (src.count("clock64()") == len(k3_probe.G16_MARKS) + 1) == (cut == "g16time")


def test_output_staging_and_owners_cover_the_item_once():
    """The kernel's staging of a warp's outputs (float4 k = (r 4 + jc) 32 +
    lane: C register r = 2h + e of n-tiles 4 jc .. 4 jc + 3), the reader's
    inverse (row ln / 4 + 8 h, dims 32 (ln % 4) + 16 e + 4 jc ..), and the
    owners (float4 k to rank k % split, slot k / split of each rank's row of
    the inbox) cover the 16 x 128 outputs once, inside the inbox."""
    out4 = GRP * HD // 4
    seen = np.zeros((GRP, HD), int)
    for r in range(4):
        for jc in range(4):
            k = (r * 4 + jc) * 32 + LANE
            ln, jc_, e, h = k % 32, (k // 32) % 4, (k // 128) % 2, k // 256
            row, d0 = ln // 4 + 8 * h, 32 * (ln % 4) + 16 * e + 4 * jc_
            for c in range(4):  # the writer's C fragments against the reader's inverse
                np.testing.assert_array_equal(row, C_ROW[:, r])
                np.testing.assert_array_equal(d0 + c, out_dims(4 * jc + c)[:, r])
                np.add.at(seen, (row, d0 + c), 1)
    assert (seen == 1).all()
    for split in range(1, TDA.KG16_CLUSTER + 1):
        slots = -(-out4 // split)
        assert split * slots <= out4 + TDA.KG16_CLUSTER
        owned = sorted(k for o in range(split) for k in range(o, out4, split))
        assert owned == list(range(out4))


def test_glm_step_ab_needs_a_card(monkeypatch):
    """scripts/torch_glm_step_ab.py exits 3 and prints nothing without CUDA."""
    import sys

    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_glm_step_ab as ab

    monkeypatch.setattr(sys, "argv", ["torch_glm_step_ab.py", str(ROOT)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ab.main() == 3
