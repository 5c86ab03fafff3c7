"""The decode-attention core (csrc/decode_attn_common.cuh) that K3
(csrc/decode_attention.cu) and the attention phases of rows 9 and 10
(csrc/decode_common.cuh) run, emulated in numpy on the CPU:

- the tile walk of the three callers (K3: the prompt, then the gen slots <=
  step; row 9: the prompt, then the gen slots < step; row 10: the slab's
  ranges [0, plen) and [S0, S0 + step)), with every copy's coordinates and
  byte count, run against the caches at ragged prompt lengths, at a tile's
  tail, at row 10's two ranges and at step 0;
- the ring's (slot, parity) sequence over items, passes and layers against
  an emulation of the mbarriers, copies landing out of order and the
  producer and the warps interleaved at random: no slot is refilled before
  every warp has released it, and every warp reads the tile it expects;
- the full-rate widening (one prmt against 0x4B00 and one subtraction),
  exact for all 256 int8 values, and the bf16 one;
- the warps' split of every tile's position groups, each position once, and
  the passes with their lane layout and fixed-order sums.

The emulated core is held against decode_attention_plain, JAX's
decode_attention_reference and its Pallas kernel in interpret mode at a
small width with group 1 and 4, and, run inside the rows' step, against
decode_step_fused_plain and decode_step_serve_plain at 2 layers of D 256.
No GPU is needed."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.ops import decode_attention as JDA
from revisionllm_tpu_torch.ops import decode_attention as TDA
from revisionllm_tpu_torch.ops import decode_serve as TDSV
from revisionllm_tpu_torch.ops import decode_step as TDS

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parent.parent / "revisionllm_tpu_torch" / "csrc"
CORE = (CSRC / "decode_attn_common.cuh").read_text()
K3SRC = (CSRC / "decode_attention.cu").read_text()
COMMON = (CSRC / "decode_common.cuh").read_text()


def const(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


HD, TAIL = const(CORE, "HD"), const(CORE, "TAIL")
MAGIC = np.float32(float(re.search(r"constexpr float MAGIC = ([\d.]+)f;", CORE).group(1)))
KWARPS, KSTAGES, KBLOCKS, KTILE, K3_SST, KGU = (const(K3SRC, n) for n in
                                                ("KWARPS", "KSTAGES", "KBLOCKS", "KTILE", "SST", "KGU"))
ATILE, ASTAGES, CWG, AGU = (const(COMMON, n) for n in ("ATILE", "ASTAGES", "CWG", "AGU"))
AWARPS = 4 * CWG  # AWARPS = WARPS: every consumer warp, in teams
TEAM = 4          # the rows' team at the stage-1 prompt: one consumer warpgroup
NEG_INF = np.float32(-2.0e30)
F32 = np.float32


def tile_positions(TB, i8):
    return TB // HD if i8 else TB // (2 * HD)


def lanes_of(group):
    """K3's lanes a position (P) for a GQA group; the rows use P = 8."""
    return 8 if group == 1 else 16 if group == 2 else 32


# ----------------------------------------------------------- plans, walks


def plan_k3(plen, step, i8=1):
    return [(plen, 0, i8), (step + 1, plen, 0)]


def plan_row9(plen, step):
    return [(plen, 0, 1), (step, plen, 0)]


def plan_row10(plen, step):
    return [(plen, 0, 1), (step, plen, 1)]


def walk(plan, TB):
    """The tiles of an item in the producer's (and every warp's) order:
    (side, segment, first position, live positions)."""
    return [(side, si, p0, min(tile_positions(TB, i8), n - p0))
            for side in (0, 1) for si, (n, _, i8) in enumerate(plan)
            for p0 in range(0, n, tile_positions(TB, i8))]


def first_group(warp, dealt, nw):
    return (warp - dealt % nw + nw) % nw


def groups_of(warp, dealt, ng, nw, gu):
    """The groups of a tile that a warp takes, gu a loop iteration."""
    return [tuple(gi + u * nw for u in range(gu))
            for gi in range(first_group(warp, dealt, nw), ng, gu * nw)]


PLANS = {"k3": plan_k3, "row9": plan_row9, "row10": plan_row10}


@pytest.mark.parametrize("caller", sorted(PLANS))
@pytest.mark.parametrize("plen,step", [(280, 11), (64, 0), (65, 1), (127, 5), (1, 0), (0, 3),
                                       (318, 11)])
def test_tile_walk_covers_each_position_once(caller, plen, step):
    """Every position of every segment is in exactly one tile a side, in
    order, a tile never holds more than its kind's positions, and the
    groups of each tile go to the warps once each (the second of a pair
    past the tile is dropped)."""
    TB = KTILE if caller == "k3" else ATILE
    plan = PLANS[caller](plen, step)
    tiles = walk(plan, TB)
    for side in (0, 1):
        for si, (n, _, i8) in enumerate(plan):
            got = [p for s_, s2, p0, nv in tiles if s_ == side and s2 == si
                   for p in range(p0, p0 + nv)]
            assert got == list(range(n))
            assert all(nv <= tile_positions(TB, i8) for s_, s2, _, nv in tiles if s2 == si)
    for nw, P, gu in ((KWARPS, 8, KGU), (KWARPS, 32, KGU), (TEAM, 8, AGU), (AWARPS // 2, 8, AGU),
                      (AWARPS, 8, AGU), (TEAM, 8, 1), (TEAM, 8, 4)):
        R = 32 // P
        dealt = 0
        for side, si, p0, nv in tiles:
            ng = -(-nv // R)
            seen = [g for w in range(nw) for grp in groups_of(w, dealt, ng, nw, gu) for g in grp
                    if g < ng]
            assert sorted(seen) == list(range(ng))
            dealt += ng


# ------------------------------------------------------------- the copies


def tma_box(tensor, start, box):
    """A TMA box of `tensor` (numpy, outermost first) at `start`
    (outermost first): elements outside the tensor read as zeros."""
    out = np.zeros(box, tensor.dtype)
    src = tuple(slice(max(0, s), min(d, s + b)) for s, b, d in zip(start, box, tensor.shape))
    dst = tuple(slice(sl.start - s, sl.stop - s) for sl, s in zip(src, start))
    out[dst] = tensor[src]
    return out


def k3_copies(a, item, side, si, p0, nv, i8=1):
    """K3's issue(): (slot rows [.., HD], slot scales [.., SST] or None, the
    byte count expected on the full barrier, the device-memory bytes of
    positions at or past the segment's end that the boxes read)."""
    KH = a["pk"].shape[2]
    b, kh = divmod(item, KH)
    es = 1 if i8 else 2
    row = HD * es if si == 0 else 2 * HD
    src = (a["pk"], a["pv"])[side] if si == 0 else (a["gk"], a["gv"])[side]
    whole = si == 0 and nv == tile_positions(KTILE, i8)
    rows = tile_positions(KTILE, i8) if whole else -(-nv // TAIL) * TAIL
    data = np.concatenate([tma_box(src, (b, p, kh, 0), (1, TAIL if not whole else rows, 1, HD))
                           .reshape(-1, HD) for p in
                           ([p0] if whole else range(p0, p0 + rows, TAIL))])
    tx = rows * row
    n_seg = src.shape[1]
    extra = max(0, min(p0 + rows, n_seg) - (p0 + nv)) * row
    scl = None
    if si == 0 and i8:
        sc = (a["ks"], a["vs"])[side]
        box = tile_positions(KTILE, 1)
        scl = tma_box(sc, (b, p0, kh & -K3_SST), (1, box, K3_SST))[0][:, kh % K3_SST:]
        tx += box * K3_SST * 4
    return data, scl, tx, extra


@pytest.mark.parametrize("i8", [1, 0])
@pytest.mark.parametrize("plen,step", [(280, 11), (64, 0), (70, 2), (5, 0), (127, 7)])
def test_k3_copies_are_the_cache_rows(i8, plen, step):
    """K3's boxes put prompt position p0 + t (t < nv) of (b, kh) at slot
    row t and its scale at slot scale t (SST floats a position from a head
    that is a multiple of SST, the item's at kh % SST), gen slot j the same; positions past the segment read at
    most TAIL - 1 rows a tile (zeros past S), and the byte count on the
    barrier is the boxes' (out-of-bound fills included)."""
    rng = np.random.default_rng(plen + 7 * step + i8)
    B, S, KH, G = 2, 130, 6, 12
    dt = np.int8 if i8 else np.float32
    a = {"pk": rng.integers(-127, 128, (B, S, KH, HD)).astype(dt),
         "pv": rng.integers(-127, 128, (B, S, KH, HD)).astype(dt),
         "gk": rng.normal(size=(B, G, KH, HD)).astype(F32),
         "gv": rng.normal(size=(B, G, KH, HD)).astype(F32),
         "ks": rng.uniform(0.005, 0.025, (B, S, KH)).astype(F32),
         "vs": rng.uniform(0.005, 0.025, (B, S, KH)).astype(F32)}
    plen = min(plen, S)
    for item in (0, KH - 1, B * KH - 1):
        b, kh = divmod(item, KH)
        for side, si, p0, nv in walk(plan_k3(plen, step, i8), KTILE):
            data, scl, tx, extra = k3_copies(a, item, side, si, p0, nv, i8)
            src = (a["pk"], a["pv"])[side] if si == 0 else (a["gk"], a["gv"])[side]
            np.testing.assert_array_equal(data[:nv], src[b, p0:p0 + nv, kh])
            row = HD * (1 if i8 else 2) if si == 0 else 2 * HD
            assert extra <= (TAIL - 1) * row
            assert tx == data.size * (1 if si == 0 and i8 else 2) + (
                tile_positions(KTILE, 1) * K3_SST * 4 if scl is not None else 0)
            if scl is not None:
                np.testing.assert_array_equal(scl[:nv, 0], (a["ks"], a["vs"])[side][b, p0:p0 + nv, kh])


def row_copies(a, l, item, side, si, p0, nv, row):
    """Rows 9 and 10's issue(): (slot bytes as rows, slot scales from the
    run's first one, barrier byte count). Row 9: the prompt run of kv [L,
    Bk, 2, H, Sp, HD] and the gen run of genkv [L, 2, Bk, H, Gp, HD]; row
    10: the slab's range si (the second from S0). The scales are the
    16-byte-aligned cover of the run (scale_cover), the run's first at
    offset run % 4 (the segment's so or sov: p0 is a multiple of 4)."""
    kv, kvsc = a["kv"], a["kvsc"]
    L, Bk, _, H, Sp, _ = kv.shape
    b, h = divmod(item, H)
    if row == 9 and si == 1:
        run = (((l * 2 + side) * Bk + b) * H + h) * a["genkv"].shape[4] + p0
        data = a["genkv"].reshape(-1, HD)[run:run + nv]
        return data, None, nv * 2 * HD
    run = (((l * Bk + b) * 2 + side) * H + h) * Sp + (a["S0"] if si == 1 else 0) + p0
    data = kv.reshape(-1, HD)[run:run + nv]
    lo, hi = run & ~3, (run + nv + 3) & ~3
    assert hi <= kvsc.size and hi - lo <= tile_positions(ATILE, 1) + 4 and p0 % 4 == 0
    cover = kvsc.reshape(-1)[lo:hi]
    return data, cover[run - lo:], nv * HD + (hi - lo) * 4


@pytest.mark.parametrize("row", [9, 10])
@pytest.mark.parametrize("plen,step", [(280, 11), (64, 0), (65, 1), (3, 0), (128, 6), (300, 2)])
def test_row_copies_are_the_runs(row, plen, step):
    """Each 1-D bulk copy of rows 9 and 10 is one contiguous run of a
    (row, head)'s K or V (16-byte aligned, a multiple of 16 bytes) holding
    exactly the tile's positions; the scale box starts at the run's first
    position; row 10's second range starts at S0, and no copy reads the
    dead range [plen, S0) or past S0 + step; a full-length prompt's last
    scale cover ends inside the scales (the tensor's end)."""
    rng = np.random.default_rng(plen * 13 + step + row)
    L, B, H, G = 2, 2, 2, 12
    S0 = 300 if row == 10 else 0
    Sp = S0 + G + 4 if row == 10 else 300
    a = {"kv": rng.integers(-127, 128, (L, B, 2, H, Sp, HD)).astype(np.int8),
         "kvsc": rng.uniform(0.005, 0.025, (L, B, 2, H, Sp)).astype(F32),
         "genkv": rng.normal(size=(L, 2, B, H, 16, HD)).astype(F32), "S0": S0}
    plen = min(plen, Sp if row == 9 else S0 - 10)
    plan = plan_row9(plen, step) if row == 9 else plan_row10(plen, step)
    for l in range(L):
        for item in range(B * H):
            b, h = divmod(item, H)
            for side, si, p0, nv in walk(plan, ATILE):
                data, scl, tx = row_copies(a, l, item, side, si, p0, nv, row)
                es = 2 if row == 9 and si == 1 else 1
                assert (nv * HD * es) % 16 == 0 and tx >= nv * HD * es
                if row == 9 and si == 1:
                    np.testing.assert_array_equal(data, a["genkv"][l, side, b, h, p0:p0 + nv])
                    continue
                pos = (S0 if si == 1 else 0) + p0
                assert pos + nv <= (plen if si == 0 else S0 + step) and (si == 0 or pos >= S0)
                np.testing.assert_array_equal(data, a["kv"][l, b, side, h, pos:pos + nv])
                np.testing.assert_array_equal(scl[:nv], a["kvsc"][l, b, side, h, pos:pos + nv])


# ---------------------------------------------------------------- the ring


class Mbar:
    """An mbarrier: `count` arrivals and the expected bytes complete a
    phase; wait(parity) passes once the phase of that parity is done."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.done = count, count, 0, 0

    def arrive(self, tx=0):
        self.tx += tx
        self.pending -= 1
        self._check()

    def complete_tx(self, n):
        self.tx -= n
        self._check()

    def _check(self):
        assert self.pending >= 0
        if self.pending == 0 and self.tx == 0:
            self.done += 1
            self.pending = self.count

    def ready(self, parity):
        return (self.done & 1) != parity


@pytest.mark.parametrize("caller,stages,nw", [("k3", KSTAGES, KWARPS), ("row9", 2, TEAM),
                                              ("row10", 2, TEAM), ("row10", 3, AWARPS // 2),
                                              ("row9", ASTAGES, AWARPS), ("k3", 2, 2)])
def test_ring_through_items_and_layers(caller, stages, nw):
    """The producer and the warps walk the same tiles (several items of
    random plans, 2 layers with the counts carried over); copies land out
    of order; the producer and the warps take turns at random. The
    (slot, parity) of the n-th tile is (n % stages, n // stages & 1) on
    both sides, no slot is refilled before every warp released it, and
    every warp reads the tile it expects."""
    rng = np.random.default_rng(stages * 31 + nw)
    TB = KTILE if caller == "k3" else ATILE
    items = [PLANS[caller](int(rng.integers(0, 200)), int(rng.integers(0, 12))) for _ in range(5)]
    seq = [t for _ in range(2) for plan in items for t in walk(plan, TB)]
    full = [Mbar(1) for _ in range(stages)]
    empty = [Mbar(nw) for _ in range(stages)]
    slot_tile = [None] * stages
    released = [set(range(nw)) for _ in range(stages)]
    in_flight = []  # (slot, bytes, tile) issued, not landed
    prod = 0
    warp_pos = [0] * nw
    while min(warp_pos) < len(seq):
        choice = int(rng.integers(0, 3))
        if choice == 0 and prod < len(seq):
            s, par = prod % stages, (prod // stages) & 1
            if prod < stages or empty[s].ready(par ^ 1):
                assert released[s] == set(range(nw)), "refilled before every warp released it"
                released[s] = set()
                full[s].arrive(tx=1000)
                in_flight.append((s, 1000, prod))
                prod += 1
        elif choice == 1 and in_flight:
            s, n, tile = in_flight.pop(int(rng.integers(0, len(in_flight))))
            slot_tile[s] = tile
            full[s].complete_tx(n)
        else:
            w = int(rng.integers(0, nw))
            n = warp_pos[w]
            if n < len(seq) and full[n % stages].ready((n // stages) & 1):
                assert slot_tile[n % stages] == n
                released[n % stages].add(w)
                empty[n % stages].arrive()
                warp_pos[w] += 1
    assert prod == len(seq)


# ------------------------------------------------------------ the widening


def widen_i8(words):
    """A uint32 array's 4 bytes each as f32 (..., 4): prmt of (w ^
    0x80808080) against 0x4B00 with selector 0x5440 | j, minus MAGIC."""
    x = words.astype(np.uint32) ^ np.uint32(0x80808080)
    out = [(np.uint32(0x4B000000) | ((x >> np.uint32(8 * j)) & np.uint32(0xFF))).view(F32) - MAGIC
           for j in range(4)]
    return np.stack(out, axis=-1)


def widen_bf16(words):
    w = words.astype(np.uint32)
    return np.stack([(w << np.uint32(16)).view(F32), (w & np.uint32(0xFFFF0000)).view(F32)], -1)


def test_widening_is_exact():
    """Every int8 value, in every byte of a word, widens to itself exactly;
    bf16 pairs widen to their f32 values."""
    vals = np.arange(-128, 128, dtype=np.int8)
    for j in range(4):
        words = np.zeros((256, 4), np.int8)
        words[:, j] = vals
        got = widen_i8(words.view(np.uint32)[:, 0])
        np.testing.assert_array_equal(got[:, j], vals.astype(F32))
    assert "0x5440u | j" in CORE and "0x4B00u" in CORE and "0x80808080u" in CORE
    rng = np.random.default_rng(3)
    bf = (rng.normal(size=64).astype(F32).view(np.uint32) & np.uint32(0xFFFF0000)).view(F32)
    pairs = (bf.view(np.uint32) >> np.uint32(16)).astype(np.uint16).view(np.uint32)
    np.testing.assert_array_equal(widen_bf16(pairs).reshape(-1), bf)


# --------------------------------------------------------- the passes


def bf16_round(x):
    """Round-to-nearest-even f32 -> bf16 -> f32."""
    u = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(F32)


def butterfly(x, axis, width, step=1):
    """The xor-shuffle sum of `x` over lanes `step`, 2 `step`, .. <
    `width` along `axis` (lane index i adds lane i ^ o, o = step, 2 step,
    ..): every lane ends with the same f32 sum, in the kernel's order."""
    o = step
    n = x.shape[axis]
    while o < width:
        x = x + np.take(x, np.arange(n) ^ (o // step), axis=axis)
        o <<= 1
    return x


def emulate_item(q, segs, nw, P, TB, score, scale, extra_max=NEG_INF, gu=2):
    """One item through the core's passes as the warps run them. q [GRP,
    HD] f32 (bf16 values); segs: (k [n, HD], v [n, HD] as f32 values, ks,
    vs (None for bf16), i8, t0), in walk order. Returns (o [GRP, HD], the
    warps' partial outputs summed in warp order, m [GRP], den [GRP], the
    warps' sums in warp order), without the caller's extra term; each warp
    takes its groups gu at a time."""
    GRP, E, R = q.shape[0], HD // P, 32 // P
    nsc = sum(s[0].shape[0] for s in segs)
    sc = np.zeros((GRP, max(nsc, 1)), F32)
    tiles = [(si, p0, min(tile_positions(TB, s[4]), s[0].shape[0] - p0))
             for si, s in enumerate(segs) for p0 in range(0, s[0].shape[0], tile_positions(TB, s[4]))]
    qr = q.reshape(GRP, P, E)

    def group(arr, p0, nv, g_idx):
        """Positions t = g R + kq of a tile: the lanes' values [R, P, E]
        (zeros past the tile's live positions), t, live."""
        t = g_idx * R + np.arange(R)
        ok = t < nv
        rows = np.where(ok[:, None], arr[p0 + np.minimum(t, nv - 1)], 0).astype(F32)
        return rows.reshape(R, P, E), t, ok

    # score pass
    red_max = np.full((nw, GRP), NEG_INF, F32)
    dealt = 0
    for si, p0, nv in tiles:
        k, _, ks, _, i8, t0 = segs[si]
        ng = -(-nv // R)
        for w in range(nw):
            for grp in groups_of(w, dealt, ng, nw, gu):
                for g_idx in grp:
                    v, t, ok = group(k, p0, nv, g_idx)
                    for g in range(GRP):
                        d0 = np.zeros((R, P), F32)
                        d1 = np.zeros((R, P), F32)
                        for e in range(0, E, 2):  # exact products: fmaf rounds once
                            d0 = d0 + qr[g][None, :, e] * v[:, :, e]
                            d1 = d1 + qr[g][None, :, e + 1] * v[:, :, e + 1]
                        d = butterfly(d0 + d1, 1, P)[:, 0]
                        for r_ in np.nonzero(ok)[0]:
                            sv = score(d[r_], ks[p0 + t[r_]]) if i8 else F32(d[r_] * scale)
                            sc[g, t0 + p0 + t[r_]] = sv
                            red_max[w, g] = max(red_max[w, g], sv)
        dealt += ng
    m = np.maximum(red_max.max(axis=0), extra_max).astype(F32)
    # value pass
    o_acc = np.zeros((nw, GRP, R, P, E), F32)
    den_acc = np.zeros((nw, GRP, R), F32)  # the lanes p == 0 of each kq
    dealt = 0
    for si, p0, nv in tiles:
        _, vv, _, vsc, i8, t0 = segs[si]
        ng = -(-nv // R)
        for w in range(nw):
            for grp in groups_of(w, dealt, ng, nw, gu):
                ws, vals = [], []
                for g_idx in grp:
                    v, t, ok = group(vv, p0, nv, g_idx)
                    tt = t0 + p0 + np.minimum(t, nv - 1)
                    pg = np.where(ok[None, :], np.exp(sc[:, tt] - m[:, None]), 0).astype(F32)
                    den_acc[w] = den_acc[w] + pg
                    if i8:
                        pg = pg * np.where(ok, vsc[p0 + np.minimum(t, nv - 1)], 1).astype(F32)
                    ws.append(bf16_round(pg))
                    vals.append(v)
                for wu, vu in zip(ws, vals):
                    o_acc[w] = o_acc[w] + wu[:, :, None, None] * vu[None]
        dealt += ng
    out = np.zeros((GRP, HD), F32)
    den = np.zeros(GRP, F32)
    for w in range(nw):
        part = butterfly(o_acc[w], 1, R)[:, 0].reshape(GRP, HD)  # lanes kq == 0
        lanes = np.zeros((GRP, 32), F32)
        lanes[:, ::P] = den_acc[w]
        out = out + part
        den = den + butterfly(lanes, 1, 32)[:, 0]
    return out, m, den


def k3_emulated(q, pk, pv, ks, vs, gk, gv, lens, step):
    """K3 through the emulated core, item by item: [B, KH, group, hd]."""
    B, KH, group, _ = q.shape
    S = pk.shape[1]
    scale = F32(HD ** -0.5)
    out = np.zeros(q.shape, F32)
    i8 = ks is not None
    for b in range(B):
        plen = int(min(max(lens[b], 0), S))
        for kh in range(KH):
            segs = [(pk[b, :plen, kh].astype(F32), pv[b, :plen, kh].astype(F32),
                     ks[b, :plen, kh] if i8 else None, vs[b, :plen, kh] if i8 else None, int(i8), 0),
                    (gk[b, :step + 1, kh], gv[b, :step + 1, kh], None, None, 0, plen)]
            o, _, den = emulate_item(q[b, kh], segs, KWARPS, lanes_of(group), KTILE,
                                     lambda d, k_: F32(F32(d * scale) * k_), scale, gu=KGU)
            out[b, kh] = bf16_round(o / den[:, None])
    return out


def k3_inputs(B, KH, group, S, G, seed, quant=True):
    """bf16-valued q and caches (f32 arrays), an int8 prompt with scales."""
    rng = np.random.default_rng(seed)
    q = bf16_round(rng.normal(size=(B, KH, group, HD)))
    gk, gv = (bf16_round(rng.normal(size=(B, G, KH, HD))) for _ in range(2))
    if quant:
        pk, pv = (rng.integers(-127, 128, (B, S, KH, HD)).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.025, (B, S, KH)).astype(F32) for _ in range(2))
    else:
        pk, pv = (bf16_round(rng.normal(size=(B, S, KH, HD))) for _ in range(2))
        ks = vs = None
    return q, pk, pv, ks, vs, gk, gv


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("step", [0, 5])
def test_emulated_k3_matches_plain(group, step):
    """The emulated core against K3's plain version on bf16 inputs with an
    int8 prompt (lengths across a tile's tail and a whole tile): both round
    p1 * v_scale and p2 to bf16 and sum in f32 in another order, so a
    weight one f32 ulp from a bf16 boundary may round the other way:
    relative L2 within 2e-3 (measured about 1e-5), each output within 2e-2."""
    B, KH, S, G = 2, 2, 140, 8
    q, pk, pv, ks, vs, gk, gv = k3_inputs(B, KH, group, S, G, seed=group + step)
    lens = np.array([140, 67], np.int32)
    got = k3_emulated(q, pk, pv, ks, vs, gk, gv, lens, step)
    t = torch.from_numpy
    want = TDA.decode_attention_plain(
        t(q).to(torch.bfloat16), t(pk), t(pv), t(ks), t(vs), t(gk).to(torch.bfloat16),
        t(gv).to(torch.bfloat16), t(lens), step).float().numpy()
    assert rel_l2(got, want) <= 2e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


def _head_major(x):
    return jnp.asarray(np.ascontiguousarray(np.swapaxes(x, 1, 2)))


@pytest.mark.parametrize("group", [1, 4])
def test_emulated_k3_matches_jax_reference(group):
    """bf16 prompt (KV8 off): the emulated core against JAX's
    decode_attention_reference in f32, which does not round p to bf16:
    relative L2 within 5e-3 (bf16 weights: about 2^-9 a weight)."""
    B, KH, S, G, step = 2, 2, 70, 6, 3
    q, pk, pv, _, _, gk, gv = k3_inputs(B, KH, group, S, G, seed=11 + group, quant=False)
    lens = np.array([70, 33], np.int32)
    got = k3_emulated(q, pk, pv, None, None, gk, gv, lens, step)
    want = np.asarray(JDA.decode_attention_reference(
        jnp.asarray(q), _head_major(pk), _head_major(pv), _head_major(gk), _head_major(gv),
        jnp.asarray(lens), jnp.asarray(step, jnp.int32)))
    assert rel_l2(got, want) <= 5e-3


def test_emulated_k3_matches_pallas_interpret():
    """group 1, hd 128 (the Pallas kernel's own case), interpret mode,
    bf16 caches: relative L2 within 5e-3 (the Pallas kernel keeps p in f32)."""
    B, KH, S, G, step = 2, 3, 40, 4, 2
    q, pk, pv, _, _, gk, gv = k3_inputs(B, KH, 1, S, G, seed=21, quant=False)
    lens = np.array([40, 11], np.int32)
    got = k3_emulated(q, pk, pv, None, None, gk, gv, lens, step)
    want = np.asarray(JDA.decode_attention(
        jnp.asarray(q), _head_major(pk), _head_major(pv), _head_major(gk), _head_major(gv),
        jnp.asarray(lens, jnp.int32), jnp.asarray(step, jnp.int32), interpret=True))
    assert rel_l2(got, want) <= 5e-3


def test_emulated_passes_are_deterministic_and_warp_count_free():
    """The fixed orders: the same item gives the same bits twice, and a
    different warp count or groups an iteration moves the result by f32
    reassociation only."""
    q, pk, pv, ks, vs, gk, gv = k3_inputs(1, 1, 1, 150, 6, seed=5)
    segs = [(pk[0, :150, 0].astype(F32), pv[0, :150, 0].astype(F32), ks[0, :, 0], vs[0, :, 0], 1, 0),
            (gk[0, :4, 0], gv[0, :4, 0], None, None, 0, 150)]
    score = lambda d, k_: F32(F32(d * F32(HD ** -0.5)) * k_)  # noqa: E731
    a = emulate_item(q[0, 0], segs, 4, 8, KTILE, score, F32(HD ** -0.5))
    b = emulate_item(q[0, 0], segs, 4, 8, KTILE, score, F32(HD ** -0.5))
    c = emulate_item(q[0, 0], segs, 12, 8, KTILE, score, F32(HD ** -0.5), gu=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(a[0] / a[2][:, None], c[0] / c[2][:, None], rtol=1e-5, atol=1e-6)


# ------------------------------------------------- the rows' attention phases


def _tree(rng, L, D, F):
    """A standard int8 layer tree of L layers (decode_step_fused_plain's)."""
    shapes = {"q_proj": (D, D), "k_proj": (D, D), "v_proj": (D, D), "o_proj": (D, D),
              "gate_proj": (D, F), "up_proj": (D, F), "down_proj": (F, D)}
    layers = {n: {"q8": torch.from_numpy(rng.integers(-127, 128, (L, K, N)).astype(np.int8)),
                  "scale": torch.from_numpy(rng.uniform(0.001, 0.003, (L, N)).astype(F32))}
              for n, (K, N) in shapes.items()}
    for n in ("attn_norm", "mlp_norm"):
        layers[n] = torch.from_numpy(bf16_round(rng.uniform(0.8, 1.2, (L, D))))
    return {"layers": layers}


def _rope(t, cos_full, sin_full, B, H):
    t3 = t.reshape(B, H, HD)
    rot = torch.cat([-t3[..., HD // 2:], t3[..., : HD // 2]], dim=-1).reshape(B, H * HD)
    return t * cos_full + rot * sin_full


def _step(layers, mm, x, cos, sin, eps, attend, store):
    """decode_step_fused_plain's and decode_step_serve_plain's layer loop
    with the attention given: attend(l, q, k, v) -> o [B, H, HD] f32;
    store(l, k, v) keeps the new k/v; mm(h, name, l) the matmul."""
    L = layers["attn_norm"].shape[0]
    B, D = x.shape
    H = D // HD
    cos_full = torch.cat([cos, cos], dim=-1).float().repeat(1, H)
    sin_full = torch.cat([sin, sin], dim=-1).float().repeat(1, H)
    xres = x.clone()
    for l in range(L):
        h = TDS._rms_norm_bf16(xres, layers["attn_norm"][l], eps)
        q = _rope(mm(h, "q_proj", l), cos_full, sin_full, B, H).reshape(B, H, HD)
        k = _rope(mm(h, "k_proj", l), cos_full, sin_full, B, H).reshape(B, H, HD)
        v = mm(h, "v_proj", l).reshape(B, H, HD)
        o = attend(l, q, k, v)
        store(l, k, v)
        attn = o.reshape(B, D).to(torch.bfloat16)
        xres = (xres.float() + mm(attn, "o_proj", l)).to(x.dtype)
        h = TDS._rms_norm_bf16(xres, layers["mlp_norm"][l], eps)
        g = mm(h, "gate_proj", l)
        mbuf = (g * torch.sigmoid(g)).to(torch.bfloat16)
        mbuf = (mbuf.float() * mm(h, "up_proj", l)).to(torch.bfloat16)
        xres = (xres.float() + mm(mbuf, "down_proj", l)).to(x.dtype)
    return xres


def _emulated_rows_attention(q, k, v, segs_of, scale):
    """The rows' attention phase through the emulated core, item by item:
    q rounded to bf16 for the dots, the f32 self term in the max and the
    denominator, o = (o + p_self * v) / (den + p_self)."""
    B, H, _ = q.shape
    qn, kn, vn = (t.numpy().astype(F32) for t in (q, k, v))
    out = np.zeros((B, H, HD), F32)
    for b in range(B):
        for h in range(H):
            s_self = F32(F32(np.dot(qn[b, h], kn[b, h])) * scale)
            o, m, den = emulate_item(bf16_round(qn[b, h])[None], segs_of(b, h), TEAM, 8, ATILE,
                                     lambda d, ks: F32(F32(d * ks) * scale), scale, s_self, AGU)
            ps = F32(np.exp(s_self - m[0]))
            out[b, h] = (o[0] + ps * vn[b, h]) / (den[0] + ps)
    return torch.from_numpy(out)


def _hidden_close(got, want):
    """Both sides run the same matmuls and roundings; the attention's sums
    run in another order and a bf16 weight may round the other way: the
    hidden state within relative L2 5e-3 and 2e-2 of its largest value."""
    g, w = got.float().numpy(), want.float().numpy()
    assert rel_l2(g, w) <= 5e-3
    np.testing.assert_allclose(g, w, rtol=0, atol=2e-2 * np.abs(w).max())


@pytest.mark.parametrize("step", [0, 3])
def test_emulated_row9_attention_in_the_step(step):
    """Row 9 at 2 layers of D 256 (2 heads), F 384, B 3 ragged prompts over
    a tile's tail: the plain step rebuilt with its own attention equals
    decode_step_fused_plain bit for bit; with the emulated core (the prompt
    and the bf16 gen slots < step as its two segments) it holds it."""
    rng = np.random.default_rng(40 + step)
    L, B, D, F, Sp, Gp, eps = 2, 3, 256, 384, 70, 8, 1e-5
    H = D // HD
    params = _tree(rng, L, D, F)
    layers = params["layers"]
    kv = torch.from_numpy(rng.integers(-127, 128, (L, B, 2, H, Sp, HD)).astype(np.int8))
    kvsc = torch.from_numpy(rng.uniform(0.005, 0.025, (L, B, 2, H, Sp)).astype(F32))
    genkv = torch.from_numpy(bf16_round(rng.normal(size=(L, 2, B, H, Gp, HD)) * 0.5))
    lens = torch.tensor([70, 64, 37], dtype=torch.int32)
    x = torch.from_numpy(bf16_round(rng.normal(size=(B, D))))
    ang = rng.uniform(0, 3, (B, HD // 2)).astype(F32)
    cos, sin = torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))
    scale = HD ** -0.5
    s_live = torch.arange(Sp)[None, None, :] < lens[:, None, None]
    g_live = torch.arange(Gp)[None, None, :] < step

    def mm(h_bf, name, l):
        w = layers[name]
        return (h_bf.float() @ w["q8"][l].float()) * w["scale"][l].float()

    def attend_plain(l, q, k, v):  # decode_step_fused_plain's attention
        qb = q.to(torch.bfloat16).float()
        s1 = torch.einsum("bhd,bhsd->bhs", qb, kv[l, :, 0].float()) * kvsc[l, :, 0] * scale
        s1 = torch.where(s_live, s1, torch.full_like(s1, float(NEG_INF)))
        s2 = torch.einsum("bhd,bhgd->bhg", qb, genkv[l, 0].to(torch.bfloat16).float()) * scale
        s2 = torch.where(g_live, s2, torch.full_like(s2, float(NEG_INF)))
        s_self = (q * k).sum(dim=-1, keepdim=True) * scale
        m = torch.maximum(torch.maximum(s1.amax(-1, keepdim=True), s2.amax(-1, keepdim=True)),
                          s_self)
        p1, p2, ps = torch.exp(s1 - m), torch.exp(s2 - m), torch.exp(s_self - m)
        denom = p1.sum(-1, keepdim=True) + p2.sum(-1, keepdim=True) + ps
        p1v = (p1 * kvsc[l, :, 1]).to(torch.bfloat16).float()
        o1 = torch.einsum("bhs,bhsd->bhd", p1v, kv[l, :, 1].float())
        o2 = torch.einsum("bhg,bhgd->bhd", p2.to(torch.bfloat16).float(),
                          genkv[l, 1].to(torch.bfloat16).float())
        return (o1 + o2 + ps * v) / denom

    def attend_emulated(l, q, k, v):
        def segs_of(b, h):
            plen = int(min(lens[b], Sp))
            return [(kv[l, b, 0, h, :plen].numpy().astype(F32), kv[l, b, 1, h, :plen].numpy().astype(F32),
                     kvsc[l, b, 0, h, :plen].numpy(), kvsc[l, b, 1, h, :plen].numpy(), 1, 0),
                    (genkv[l, 0, b, h, :step].numpy(), genkv[l, 1, b, h, :step].numpy(), None, None, 0,
                     plen)]
        return _emulated_rows_attention(q, k, v, segs_of, F32(scale))

    def store(gkv):
        def f(l, k, v):
            gkv[l, 0, :, :, step] = k.to(gkv.dtype)
            gkv[l, 1, :, :, step] = v.to(gkv.dtype)
        return f

    want, want_kv = TDS.decode_step_fused_plain(params, {"kv": kv, "kvsc": kvsc}, genkv.clone(),
                                                lens, step, x, cos, sin, eps)
    g1 = genkv.clone()
    rebuilt = _step(layers, mm, x, cos, sin, eps, attend_plain, store(g1))
    np.testing.assert_array_equal(rebuilt.numpy(), want.numpy())
    np.testing.assert_array_equal(g1.numpy(), want_kv.numpy())
    got = _step(layers, mm, x, cos, sin, eps, attend_emulated, store(genkv.clone()))
    _hidden_close(got, want)


@pytest.mark.parametrize("step", [0, 4])
def test_emulated_row10_attention_in_the_step(step):
    """Row 10 at 2 layers of D 256 on the packed tree (block 128), a slab
    with s0 = 66 and garbage in the dead range and past s0 + step: the
    plain step rebuilt with its own attention equals
    decode_step_serve_plain bit for bit; with the emulated core (the slab's
    [0, plen) and [s0, s0 + step) as two int8 segments) it holds it."""
    rng = np.random.default_rng(50 + step)
    L, B, D, F, s0, eps = 2, 3, 256, 384, 66, 1e-5
    H, Sp = D // HD, 80
    params = _tree(rng, L, D, F)
    packed = TDSV.pack_serving_weights(params["layers"], block_n=128, block_f=128)
    slab = {"kv": torch.from_numpy(rng.integers(-127, 128, (L, B, 2, H, Sp, HD)).astype(np.int8)),
            "kvsc": torch.from_numpy(rng.uniform(0.005, 0.025, (L, B, 2, H, Sp)).astype(F32))}
    kv, kvsc = slab["kv"], slab["kvsc"]
    lens = torch.tensor([66, 64, 9], dtype=torch.int32)
    x = torch.from_numpy(bf16_round(rng.normal(size=(B, D))))
    ang = rng.uniform(0, 3, (B, HD // 2)).astype(F32)
    cos, sin = torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))
    scale = HD ** -0.5
    pos = torch.arange(Sp)[None, None, :]
    valid = (pos < lens[:, None, None]) | ((pos >= s0) & (pos < s0 + step))

    def mm(h_bf, name, l):
        if name == "down_proj":
            q8r = packed["down_proj"]["q8r"][l]
            BF = q8r.shape[1]
            acc = h_bf[:, :BF].float() @ q8r[0].float()
            for j in range(1, q8r.shape[0]):
                acc = acc + h_bf[:, j * BF:(j + 1) * BF].float() @ q8r[j].float()
            return acc * packed["down_proj"]["scale"][l].float()
        w = packed[name]
        acc = torch.einsum("bk,ckn->bcn", h_bf.float(), w["q8c"][l].float())
        return acc.reshape(B, -1) * w["scale"][l].float()

    def attend_plain(l, q, k, v):  # decode_step_serve_plain's attention
        qb = q.to(torch.bfloat16).float()
        s1 = torch.einsum("bhd,bhsd->bhs", qb, kv[l, :, 0].float()) * kvsc[l, :, 0] * scale
        s1 = torch.where(valid, s1, torch.full_like(s1, float(NEG_INF)))
        s_self = (q * k).sum(dim=-1, keepdim=True) * scale
        m = torch.maximum(s1.amax(-1, keepdim=True), s_self)
        p1, ps = torch.exp(s1 - m), torch.exp(s_self - m)
        denom = p1.sum(-1, keepdim=True) + ps
        p1v = (p1 * kvsc[l, :, 1]).to(torch.bfloat16).float()
        o1 = torch.einsum("bhs,bhsd->bhd", p1v, kv[l, :, 1].float())
        return (o1 + ps * v) / denom

    def attend_emulated(l, q, k, v):
        def segs_of(b, h):
            plen = int(min(lens[b], s0))
            rng_ = (slice(0, plen), slice(s0, s0 + step))
            return [(kv[l, b, 0, h, r].numpy().astype(F32), kv[l, b, 1, h, r].numpy().astype(F32),
                     kvsc[l, b, 0, h, r].numpy(), kvsc[l, b, 1, h, r].numpy(), 1,
                     0 if i == 0 else plen) for i, r in enumerate(rng_)]
        return _emulated_rows_attention(q, k, v, segs_of, F32(scale))

    layers = {**params["layers"], "attn_norm": packed["attn_norm"], "mlp_norm": packed["mlp_norm"]}
    args = (lens, step, x, cos, sin, s0, eps)
    want, _ = TDSV.decode_step_serve_plain(packed, {k_: t.clone() for k_, t in slab.items()}, *args)
    rebuilt = _step(layers, mm, x, cos, sin, eps, attend_plain, lambda *a: None)
    np.testing.assert_array_equal(rebuilt.numpy(), want.numpy())
    got = _step(layers, mm, x, cos, sin, eps, attend_emulated, lambda *a: None)
    _hidden_close(got, want)
