"""The matmul phases of the whole-step decode kernels (rows 9 and 10,
csrc/decode_common.cuh) emulated in numpy on the CPU:

- the slice plan and each block's walk of (matrix, column tile, k box),
  with the TMA box coordinates over the standard [L, K, N], the packed
  [L, nc, K, block_n] and the row-chunked down [L, Fp, D] layouts, at every
  K tail and N edge;
- the rings' (slot, parity) sequence over every matmul phase of two
  layers, run against an emulation of the mbarriers: the producer's copies
  ahead of each phase, copies that land out of order and a random
  interleaving of the producer and the consumer warpgroups;
- the activation slice's TMA layout as wgmma's swizzled B operand, the widened
  A registers (K1's, csrc/wonly_matmul_common.cuh, emulated in
  tests/test_torch_int8_fragments.py), the column permutation's inverse in
  the epilogue and its float4 stores into part[s, row, col].

The emulated phases are held against decode_step_fused_plain's matmul
arithmetic and the JAX package's Pallas int8 matmul in interpret mode at 2
layers of D 256, F 688 and B <= 64, at the header's CWG consumer
warpgroups and at 2, which the phase script measures too. No GPU is
needed."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import revisionllm_tpu.models.llama as jllama
from revisionllm_tpu.config import LlamaConfig as JCfg
from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu_torch.config import LlamaConfig as TCfg
from revisionllm_tpu_torch.ops import decode_serve as TDSV
from revisionllm_tpu_torch.ops import decode_step as TDS

from test_torch_int8_fragments import COLS, G, T, a_fragments, w_stage
from torch_parity import to_torch

HEADER = (Path(__file__).resolve().parent.parent / "revisionllm_tpu_torch" / "csrc"
          / "decode_common.cuh").read_text()


def const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER).group(1))


MP, CWG, BN, BK, STAGES, KSLICE, ASTAGES, ATILE = (
    const(n) for n in ("MP", "CWG", "BN", "BK", "STAGES", "KSLICE", "ASTAGES", "ATILE"))
AWARPS = 4 * CWG  # the attention phase runs on every consumer warp (AWARPS = WARPS)
SMS = 132  # the H100's SMs: one block each
# (first matrix, matrices, K, N) of the four matmul phases, K and N as "D" or "F"
PHASES = ((0, 3, "D", "D"), (3, 1, "D", "D"), (4, 2, "D", "F"), (6, 1, "F", "D"))
CWGS = [CWG, 2]  # as shipped, and the phase script's variant


def slice_rows(K, kslice=KSLICE):
    n = -(-K // kslice)
    return -(-(-(-K // n)) // BK) * BK


def num_slices(K, kslice=KSLICE):
    return -(-K // slice_rows(K, kslice))


def phase_dims(p, D, F):
    first, nmat, k, n = PHASES[p]
    return first, nmat, D if k == "D" else F, D if n == "D" else F


def share_of(block, grid, K, N, nmat, kslice=KSLICE):
    """The kernel's share_of: block (s, r)'s K slice and column tiles."""
    S, kper = num_slices(K, kslice), slice_rows(K, kslice)
    bps = grid // S
    s, r = divmod(block, bps)
    nchunks = -(-N // BN)
    ntiles = nmat * nchunks
    live = s < S and r < ntiles
    k_begin = s * kper
    kn = min(K, k_begin + kper) - k_begin if live else 0
    nkb = -(-kn // BK)
    nt = (ntiles - 1 - r) // bps + 1 if live else 0
    return dict(s=s, k_begin=k_begin, kn=kn, nkb=nkb, r=r, bps=bps, nchunks=nchunks, nt=nt,
                boxes=nt * nkb)


def box_of(h, i, cwg):
    """The kernel's box_of: box i of the block's walk -> (tile j, k box kb)."""
    rnd, q = divmod(i, cwg * h["nkb"])
    m = min(cwg, h["nt"] - rnd * cwg)
    return rnd * cwg + q % m, q // m


def walk(block, grid, l, p, D, F, cws, cwg=CWG, kslice=KSLICE):
    """Block `block`'s boxes of matmul phase p of layer l, in the producer's
    order: dicts of the tile, k box, ring, matrix, its columns n0 and K rows
    k0, and the TMA coordinates (inner column, K row, layer * nc + chunk) in
    the matrix's 3-D tensor map (cw, K, L * N / cw)."""
    first, nmat, K, N = phase_dims(p, D, F)
    h = share_of(block, grid, K, N, nmat, kslice)
    out = []
    for i in range(h["boxes"]):
        j, kb = box_of(h, i, cwg)
        c = h["r"] + j * h["bps"]
        mat, n0 = first + c // h["nchunks"], (c % h["nchunks"]) * BN
        cw = cws[mat]
        out.append(dict(i=i, j=j, kb=kb, ring=j % cwg, mat=mat, n0=n0,
                        k0=h["k_begin"] + kb * BK, s=h["s"],
                        coords=(n0 % cw, h["k_begin"] + kb * BK, l * (N // cw) + n0 // cw)))
    return h, out


# ------------------------------------------------------------- the mirrors


def test_mirrors_follow_the_header():
    """ops/decode_step.py's mirror of the geometry (it sizes `part` and
    checks the shared memory) and the slice plan agree with the header."""
    assert (TDS.ROWS_PER_LAUNCH, TDS.KSLICE, TDS.BK) == (MP, KSLICE, BK)
    assert (TDS.CONSUMER_WARPGROUPS, TDS.STAGES, TDS.ATTN_WARPS) == (CWG, STAGES, AWARPS)
    assert "constexpr int AWARPS = WARPS;" in HEADER
    assert (TDS.ATTN_STAGES, TDS.ATTN_TILE) == (ASTAGES, ATILE)
    assert TDS.SMEM_FIXED == 1024 + CWG * STAGES * BK * BN + 1024
    for K in (256, 688, 768, 1000, 4096, 4104, 11008, 11264):
        assert TDS._slice_rows(K) == slice_rows(K) and TDS._slices(K) == num_slices(K)
        assert slice_rows(K) % BK == 0 and slice_rows(K) <= KSLICE
    # Vicuna-7B: 4 slices of 1024 for D; 11 for F and Fp, the last of F 768
    assert [(num_slices(K), slice_rows(K)) for K in (4096, 11008, 11264)] == [
        (4, 1024), (11, 1024), (11, 1024)]
    # the kernels-phase shape fits (row 9: Sp 318 and Gp 16; row 10: s0 + step)
    # with a team a consumer warpgroup, under the activation slice
    for F, nsc in ((11008, 318 + 16), (11264, 318 + 11)):
        smem = TDS.step_smem_bytes(4096, F, nsc)
        assert smem == TDS.SMEM_FIXED + MP * 1024 * 2 <= TDS.SMEM_MAX
        assert TDS.attn_layout(nsc, 4) == (CWG, 2)
    assert TDS.SMEM_MAX == int(re.search(r"constexpr size_t SMEM_MAX = (\d+);", HEADER).group(1))


@pytest.mark.parametrize("positions,layout", [("context", (2, 2)), (3744, (2, 2)), (3745, (2, 2)),
                                              (6880, (1, 4))],
                         ids=["model-context", "last-at-8-warps", "first-at-7-warps",
                              "longest-before-the-rings"])
@pytest.mark.parametrize("row", [9, 10])
def test_long_caches_launch(row, positions, layout):
    """A cache of every length Vicuna-7B supports launches on every consumer
    warp: the attention phase runs as many teams (of the consumer warps) as
    have a ring of at least 2 slots beside their scratch (the staged q/k/v
    inputs, one f32 score a position) in the activation region, each ring
    up to ASTAGES slots: 3 teams at the stage-1 prompt, 2 at the model's 4096,
    1 past it. Row 9's positions are Sp +
    Gp; row 10's are s0 + step < Sp, so its longest is the context less one.
    The ids are the lengths that mattered before: 3744 and 3745 were the
    last at eight attention warps and the first at seven, 6880 the longest
    before the weight rings held shared memory through the step."""
    cfg = TCfg()
    n = positions
    if positions == "context":
        n = cfg.max_position_embeddings - (row == 10)
    F = cfg.intermediate_size if row == 9 else -(-cfg.intermediate_size // 1024) * 1024
    room = TDS.SMEM_MAX - TDS.SMEM_FIXED
    teams, stages = layout
    assert TDS.attn_layout(n, 4) == layout  # D 4096: 4 K slices
    assert teams * TDS.attn_team_bytes(stages, n, 4, 4 * CWG // teams) <= room
    assert stages == ASTAGES or teams * TDS.attn_team_bytes(stages + 1, n, 4, 4 * CWG // teams) > room
    assert (teams + 1) * TDS.attn_team_bytes(2, n, 4, 4 * CWG // (teams + 1)) > room
    assert TDS.step_smem_bytes(cfg.hidden_size, F, n) <= TDS.SMEM_MAX


# ---------------------------------------------------------- the walk, TMA


@pytest.mark.parametrize("cwg", CWGS)
@pytest.mark.parametrize("D,F,grid,kslice", [(4096, 11008, SMS, KSLICE), (4096, 11264, SMS, KSLICE),
                                             (256, 688, SMS, KSLICE), (256, 688, 5, 256)],
                         ids=["vicuna", "vicuna-Fp", "small", "small-sliced"])
def test_walk_covers_every_weight_once(D, F, grid, kslice, cwg):
    """Over the blocks of a grid, each phase's boxes cover every (matrix,
    128-column tile, K row) exactly once, each inside its block's slice,
    each tile's k boxes in K order on its warpgroup's ring."""
    cws = [D] * 4 + [F] * 2 + [D]
    for p in range(4):
        first, nmat, K, N = phase_dims(p, D, F)
        seen = np.zeros((nmat, -(-N // BN), -(-K // BK)), np.int32)
        for block in range(grid):
            h, boxes = walk(block, grid, 0, p, D, F, cws, cwg, kslice)
            tiles = {}
            for b in boxes:
                assert h["k_begin"] <= b["k0"] < h["k_begin"] + h["kn"]
                seen[b["mat"] - first, b["n0"] // BN, b["k0"] // BK] += 1
                tiles.setdefault(b["j"], []).append(b)
            for j, tb in tiles.items():
                assert [b["kb"] for b in tb] == list(range(h["nkb"]))
                assert {b["ring"] for b in tb} == {j % cwg}
        assert (seen == 1).all()


def test_plan_at_the_vicuna_shapes():
    """The blocks' shares at Vicuna-7B (132 SMs): every slice has its blocks
    (33 for D's 4 slices, 12 for F's 11), and the most boxes a block takes
    in each phase (q/k/v, o, gate/up, down)."""
    most = []
    for p in range(4):
        _, nmat, K, N = phase_dims(p, 4096, 11008)
        shares = [share_of(b, SMS, K, N, nmat) for b in range(SMS)]
        assert {h["bps"] for h in shares} == {SMS // num_slices(K)}
        assert sum(h["boxes"] for h in shares) == nmat * (N // BN) * (K // BK)
        most.append(max(h["boxes"] for h in shares))
    assert most == [24, 8, 48, 24]


def tma_box(stored3, coords):
    """The [BK, BN] box a TMA copy of the 3-D tensor stored3 [L * nc, K, cw]
    brings at coords (inner, row, outer); zeros outside the tensor."""
    c0, c1, c2 = coords
    box = np.zeros((BK, BN), np.int8)
    live = stored3[c2, c1:c1 + BK, c0:c0 + BN]
    box[:live.shape[0], :live.shape[1]] = live
    return box


@pytest.fixture(scope="module")
def small():
    """2 layers of D 256, F 688 (5 whole tiles and 48 columns; K tail 48)
    quantized by the JAX package, in both packages' trees, and the serving
    pack with block_n 128 (Fp 768)."""
    jcfg = JCfg(vocab_size=256, hidden_size=256, intermediate_size=688, num_layers=2,
                num_heads=2, num_kv_heads=2, head_dim=128, dtype="float32")
    qp = JQ.quantize_llama_params(jllama.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32))
    tp = to_torch(qp)
    packed = TDSV.pack_serving_weights(tp["layers"], block_n=128, block_f=128)
    return qp, tp, packed


NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def layouts(tp, packed, layout):
    """(the 7 matrices as the kernel's tensor maps see them, [L * nc, K, cw],
    their cw, the logical [L, K, N] weights, their scales [L, N], F)."""
    std = [tp["layers"][n]["q8"].numpy() for n in NAMES]
    if layout == "standard":
        scales = [tp["layers"][n]["scale"].numpy() for n in NAMES]
        return [w.reshape(-1, *w.shape[1:]) for w in std], [w.shape[2] for w in std], std, \
            scales, std[4].shape[2]
    stored, cws, logical = [], [], []
    for n in NAMES[:6]:
        w = packed[n]["q8c"].numpy()                       # [L, nc, K, block_n]
        L, nc, K, bn = w.shape
        stored.append(w.reshape(L * nc, K, bn))
        cws.append(bn)
        logical.append(w.transpose(0, 2, 1, 3).reshape(L, K, nc * bn))
    down = packed["down_proj"]["q8r"].numpy()              # [L, ncf, block_f, D]
    L, ncf, bf, D = down.shape
    stored.append(down.reshape(L, ncf * bf, D))
    cws.append(D)
    logical.append(down.reshape(L, ncf * bf, D))
    scales = [packed[n]["scale"].numpy() for n in NAMES]
    return stored, cws, logical, scales, logical[4].shape[2]


@pytest.mark.parametrize("layout", ["standard", "packed"])
def test_tma_boxes_are_the_tiles(small, layout):
    """Each box's coordinates in its matrix's 3-D tensor map bring exactly
    the weights of its K rows and 128 columns of layer l (zeros past K and
    N, as TMA reads outside the tensor), in both layouts; the packed
    layout's padded gate/up columns and down rows are zeros."""
    _, tp, packed = small
    stored, cws, logical, _, F = layouts(tp, packed, layout)
    D = logical[0].shape[1]
    for l in range(2):
        for p in range(4):
            first, nmat, K, N = phase_dims(p, D, F)
            for block in range(8):
                _, boxes = walk(block, 8, l, p, D, F, cws)
                for b in boxes:
                    want = np.zeros((BK, BN), np.int8)
                    live = logical[b["mat"]][l, b["k0"]:b["k0"] + BK, b["n0"]:b["n0"] + BN]
                    want[:live.shape[0], :live.shape[1]] = live
                    np.testing.assert_array_equal(tma_box(stored[b["mat"]], b["coords"]), want)
    if layout == "packed":
        assert not logical[4][:, :, 688:].any() and not logical[6][:, 688:].any()


# ---------------------------------------------------------------- the rings


def run_rings(block, grid, D, F, L, cwg, stages, rng):
    """One block's rings through the matmul phases of L layers, with an
    emulation of the mbarriers (a phase completes on each copy's landing
    (full) and on each release (empty); a wait by parity passes when the
    completed count's parity differs from it), a random interleaving of the
    producer lane and the consumer warpgroups, the copies landing in random
    order, and a barrier for everyone after each phase. Fails on a deadlock,
    on a consumer reading a slot that does not hold its box, and on a copy
    into a slot whose box is not released. Returns each ring's (slot,
    parity) sequence and the producer's copies ahead of each phase."""
    cws = [D] * 4 + [F] * 2 + [D]
    phases = [(l, p) for l in range(L) for p in range(4)]
    walks = [walk(block, grid, l, p, D, F, cws, cwg)[1] for l, p in phases]
    nslot = cwg * stages
    full_c, empty_c = [0] * nslot, [0] * nslot
    holds = [None] * nslot          # the box that landed last in each slot
    released = [None] * nslot       # the box released last
    flight = {}                     # slot -> the box in flight
    issued = [0] * cwg
    taken = [0] * cwg
    seq = [[] for _ in range(cwg)]
    ahead_counts = []               # the boxes of each phase issued before it
    cons = [{"n": 0} for _ in range(cwg)]

    def boxes_of(k, w):
        return [b for b in walks[k] if b["ring"] == w]

    def producer_plan(k, start):
        """The producer's copies in phase k: its boxes from `start` on, then
        the first ones of phase k + 1 (stopping at the first box whose ring
        already has STAGES of that phase); and how many of those."""
        plan = [(k, b) for b in walks[k][start:]]
        n = [0] * cwg
        nxt = 0
        if k + 1 < len(walks):
            for b in walks[k + 1]:
                if n[b["ring"]] == stages:
                    break
                n[b["ring"]] += 1
                plan.append((k + 1, b))
                nxt += 1
        return plan, nxt

    # the first copies, at the kernel's start, then phase 0's own pass
    plan = []
    for b in walks[0]:
        if sum(x["ring"] == b["ring"] for _, x in plan) == stages:
            break
        plan.append((0, b))
    ahead_counts.append(len(plan))
    more, ahead = producer_plan(0, len(plan))
    ahead_counts.append(ahead)
    pending = plan + more
    at_barrier = [False] * (cwg + 1)
    k = 0
    while k < len(walks):
        actions = []
        if pending:
            kk, b = pending[0]
            w = b["ring"]
            q = issued[w]
            slot = w * stages + q % stages
            if slot not in flight and (q < stages or empty_c[slot] % 2 != ((q // stages - 1) & 1)):
                actions.append("issue")
        elif not at_barrier[cwg]:
            actions.append("producer_done")
        for w in range(cwg):
            mine = boxes_of(k, w)
            if cons[w]["n"] < len(mine):
                q = taken[w]
                slot = w * stages + q % stages
                if full_c[slot] % 2 != ((q // stages) & 1):
                    actions.append(("take", w))
            elif not at_barrier[w]:
                actions.append(("consumer_done", w))
        if flight:
            actions.append("land")
        if not actions:
            if all(at_barrier):
                k += 1
                at_barrier = [False] * (cwg + 1)
                for c in cons:
                    c["n"] = 0
                if k < len(walks):
                    pending, ahead = producer_plan(k, ahead)
                    ahead_counts.append(ahead)
                continue
            raise AssertionError(f"deadlock in phase {k} of block {block}")
        act = actions[rng.integers(len(actions))]
        if act == "issue":
            kk, b = pending.pop(0)
            w = b["ring"]
            q = issued[w]
            slot = w * stages + q % stages
            if q >= stages:
                assert released[slot] == (w, q - stages), "a copy into a slot not released"
                # a copy ahead of its phase waits only for the phase before
                assert kk == k or released[slot] is not None
            flight[slot] = (w, q, kk, b["i"])
            issued[w] += 1
            if kk > k:
                assert sum(1 for _, qq, k2, _ in flight.values() if k2 > k) <= cwg * stages
        elif act == "producer_done":
            at_barrier[cwg] = True
        elif act == "land":
            slot = list(flight)[rng.integers(len(flight))]
            holds[slot] = flight.pop(slot)
            full_c[slot] += 1
        elif act[0] == "take":
            w = act[1]
            q = taken[w]
            slot = w * stages + q % stages
            want = boxes_of(k, w)[cons[w]["n"]]
            assert holds[slot][:2] == (w, q) and holds[slot][2:] == (k, want["i"]), \
                "a consumer read a slot that does not hold its box"
            seq[w].append((q % stages, (q // stages) & 1))
            taken[w] += 1
            cons[w]["n"] += 1
            released[slot] = (w, q)
            empty_c[slot] += 1
        else:
            at_barrier[act[1]] = True
    assert not flight and issued == taken
    return seq, ahead_counts


@pytest.mark.parametrize("cwg", CWGS)
@pytest.mark.parametrize("D,F,grid,blocks", [(256, 688, 5, range(5)),
                                             (4096, 11008, SMS, (0, 32, 33, 77, 131))],
                         ids=["small", "vicuna"])
def test_rings_through_two_layers(D, F, grid, blocks, cwg):
    """The rings run through all 8 matmul phases of two layers without a
    reset: each ring's slots come in turn, each slot's parity alternates,
    every consumer reads the box it expects though copies land out of
    order, and the producer's copies ahead of a phase (at most STAGES a
    ring) wait only for boxes the phase before releases."""
    rng = np.random.default_rng(D + grid + 7 * cwg)
    for block in blocks:
        seq, ahead = run_rings(block, grid, D, F, 2, cwg, STAGES, rng)
        for w in range(cwg):
            n = len(seq[w])
            assert seq[w] == [(q % STAGES, (q // STAGES) & 1) for q in range(n)]
        cws = [D] * 4 + [F] * 2 + [D]
        assert len(ahead) == 9                 # phases 0-7, and none after the last
        assert ahead[8] == 0
        for k, got in enumerate(ahead[:8]):
            _, boxes = walk(block, grid, k // 4, k % 4, D, F, cws, cwg)
            rings = [b["ring"] for b in boxes[:got]]
            assert all(rings.count(w) <= STAGES for w in range(cwg))
            assert got == len(boxes) or rings.count(boxes[got]["ring"]) == STAGES


# ------------------------------------------------ fragments and the epilogue


def slice_smem(act, B, k_begin, nkb):
    """The activation region after the producer's issue_slice: activation
    box kb is the two TMA copies of the act map ([B, K] bf16 in 64 x 64
    boxes, 128-byte swizzle) at columns k_begin + 128 kb and + 64: half h,
    row r, 16-byte chunk c at h * 8 KB + r * 128 + (c ^ (r % 8)) * 16, zeros
    for rows >= B and columns >= K."""
    K = act.shape[1]
    smem = np.zeros(nkb * MP * BK * 2, np.uint8)
    bits = torch.from_numpy(np.ascontiguousarray(act)).to(torch.bfloat16).view(torch.int16)
    bits = bits.numpy().view(np.uint8).reshape(act.shape[0], -1)
    for kb in range(nkb):
        for half in range(2):
            k0 = k_begin + kb * BK + half * 64
            for r in range(B):
                for c in range(8):
                    k = k0 + 8 * c
                    if k >= K:
                        continue
                    dst = kb * MP * BK * 2 + half * MP * 128 + r * 128 + ((c ^ (r & 7)) << 4)
                    smem[dst:dst + 16] = bits[r, 2 * k:2 * k + 16]
    return smem


def b_operand(smem, kb, kk):
    """wgmma's B operand [64 rows, 16 k] of k16 step kk of activation box kb
    as attn::k_major's descriptor reads it: the 128-byte-swizzled K-major
    tile, logical chunk c of row r at physical chunk c ^ (r % 8)."""
    out = np.zeros((MP, 16), np.float32)
    base = kb * MP * BK * 2 + (kk >> 2) * (MP * 128)
    for r in range(MP):
        for e in range(16):
            byte = (kk & 3) * 32 + 2 * e
            addr = base + r * 128 + ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15)
            half = int(smem[addr]) | (int(smem[addr + 1]) << 8)
            out[r, e] = np.array([half << 16], np.uint32).view(np.float32)[0]
    return out


def epilogue(Dacc, part_rows, B, N, n0, col0):
    """The kernel's store_tile: lane (g, t) of warp w stores, for rows 8 n +
    2 t + b < B, the float4 (D0[r, m], D1[r, m], D0[r + 8, m], D1[r + 8, m]),
    r = 16 w + g, at columns c0 .. c0 + 3 (c0 = 32 w + 4 g) of the tile.
    Returns the set of (row, column) written."""
    written = set()
    for w in range(4):
        c0 = 32 * w + 4 * G
        for n in range(8):
            for b in range(2):
                rows = 8 * n + 2 * T + b
                v = np.stack([Dacc[0][16 * w + G, rows], Dacc[1][16 * w + G, rows],
                              Dacc[0][16 * w + G + 8, rows], Dacc[1][16 * w + G + 8, rows]], -1)
                for lane in range(32):
                    if rows[lane] < B and n0 + c0[lane] < N:
                        cols = col0 + c0[lane] + np.arange(4)
                        part_rows[rows[lane], cols] = v[lane]
                        written.update((int(rows[lane]), int(c)) for c in cols)
    return written


def test_epilogue_undoes_the_permutation():
    """The lane layout of the accumulators and the float4 stores put wgmma
    jj's row 16 w + g + 8 h (column 32 w + 4 g + 2 h + jj of the tile,
    COLS) at its column, each (row < B, column < N) once, as 16-byte runs
    of 4 columns; a warp's store instruction covers 4 rows x 128 bytes."""
    Dacc = np.random.default_rng(0).normal(size=(2, 64, MP)).astype(np.float32)
    part = np.full((MP, BN), np.nan, np.float32)
    written = epilogue(Dacc, part, 37, 100, 0, 0)
    assert written == {(r, c) for r in range(37) for c in range(100)}
    for jj in range(2):
        np.testing.assert_array_equal(part[:37, COLS[jj][COLS[jj] < 100]],
                                      Dacc[jj][COLS[jj] < 100, :37].T)
    for w in range(4):
        for n in range(8):
            rows, c0 = 8 * n + 2 * T, 32 * w + 4 * G
            starts = {(int(r), int(c)) for r, c in zip(rows, c0)}
            assert len({r for r, _ in starts}) == 4 and all(
                sorted(c for r2, c in starts if r2 == r) == list(range(32 * w, 32 * w + 32, 4))
                for r in {r for r, _ in starts})


def test_activation_slice_is_the_b_operand():
    """The TMA copies of the slice lay it out as the swizzled K-major B
    operand that attn::k_major describes: every k16 step of every box reads
    act[row, k] for rows < B and K columns < kn, and zeros past them (the
    rows past B, NaN here, never reach the products)."""
    rng = np.random.default_rng(1)
    K, B, k_begin, kn = 688, 5, 512, 176
    act = rng.normal(size=(MP, K)).astype(np.float32)
    act[B:] = np.nan
    act = torch.from_numpy(act).to(torch.bfloat16).float().numpy()
    nkb = -(-kn // BK)
    smem = slice_smem(act, B, k_begin, nkb)
    for kb in range(nkb):
        for kk in range(BK // 16):
            got = b_operand(smem, kb, kk)
            k0 = kb * BK + kk * 16
            want = np.zeros((MP, 16), np.float32)
            live = max(0, min(16, kn - k0))
            want[:B, :live] = act[:B, k_begin + k0:k_begin + k0 + live]
            np.testing.assert_array_equal(got, want)


def emulate_phase(act, B, l, p, stored, cws, D, F, grid, cwg, kslice=KSLICE):
    """part [S, MP, Ntot] of matmul phase p of layer l as the blocks compute
    it: each block's slice through the act map's copies, its boxes through
    the TMA coordinates, the widened A fragments, the B descriptor reads,
    f32 accumulation box by box, and the epilogue's stores."""
    first, nmat, K, N = phase_dims(p, D, F)
    S = num_slices(K, kslice)
    part = np.full((S, MP, nmat * N), np.nan, np.float32)
    afr = {}
    for block in range(grid):
        h, boxes = walk(block, grid, l, p, D, F, cws, cwg, kslice)
        if not boxes:
            continue
        smem = slice_smem(act, B, h["k_begin"], h["nkb"])
        acc = {}
        for b in boxes:
            key = (b["mat"], b["coords"])
            if key not in afr:
                flat = w_stage(tma_box(stored[b["mat"]], b["coords"]), 0, 0)
                afr[key] = [a_fragments(flat, kk) for kk in range(BK // 16)]
            Dw = acc.setdefault(b["j"], np.zeros((2, 64, MP), np.float32))
            for kk in range(BK // 16):
                Dw[:] = (Dw + afr[key][kk] @ b_operand(smem, b["kb"], kk).T).astype(np.float32)
        for j, total in acc.items():
            c = h["r"] + j * h["bps"]
            mi, n0 = c // h["nchunks"], (c % h["nchunks"]) * BN
            epilogue(total, part[h["s"]], B, N, n0, mi * N + n0)
    return part


@pytest.mark.parametrize("cwg", CWGS)
@pytest.mark.parametrize("layout", ["standard", "packed"])
@pytest.mark.parametrize("B,grid,kslice", [(64, SMS, KSLICE), (5, 4, 256)],
                         ids=["B64", "B5-sliced"])
def test_emulated_phases_match_plain_and_pallas(small, layout, B, grid, kslice, cwg):
    """Every matmul phase of both layers, emulated block by block, summed
    over its slices in order and times the column scales, against the plain
    version's arithmetic ((h.float() @ q8.float()) * scale, as
    decode_step_fused_plain's and decode_step_serve_plain's matmuls) and
    the JAX package's int8_matmul in interpret mode, within 1e-5 of the
    largest output: the int8 x bf16 products are exact in f32, only the
    order of the f32 sums differs. B 5 on 4 blocks with slices of 256 walks
    several tiles and slices a block and the K tail of a slice."""
    qp, tp, packed = small
    stored, cws, logical, scales, F = layouts(tp, packed, layout)
    D = logical[0].shape[1]
    rng = np.random.default_rng(B + grid)
    for l in range(2):
        for p in range(4):
            first, nmat, K, N = phase_dims(p, D, F)
            act = rng.normal(size=(MP, K)).astype(np.float32)
            act[B:] = np.nan                           # rows past B are never read
            act = torch.from_numpy(act).to(torch.bfloat16).float().numpy()
            part = emulate_phase(act, B, l, p, stored, cws, D, F, grid, cwg, kslice)
            assert np.isfinite(part[:, :B]).all()
            got = part[0, :B].copy()
            for s in range(1, part.shape[0]):          # the consumers' fixed order
                got = (got + part[s, :B]).astype(np.float32)
            for m in range(nmat):
                mat = first + m
                out = got[:, m * N:(m + 1) * N] * scales[mat][l]
                h = torch.from_numpy(act[:B]).to(torch.bfloat16)
                plain = ((h.float() @ torch.from_numpy(logical[mat][l]).float())
                         * torch.from_numpy(scales[mat][l]).float()).numpy()
                top = np.abs(plain).max()
                np.testing.assert_allclose(out, plain, rtol=0, atol=1e-5 * top)
                if layout == "standard":
                    pallas = np.asarray(JQ.int8_matmul(
                        jnp.asarray(act[:B]), jnp.asarray(logical[mat][l]),
                        jnp.asarray(scales[mat][l]), block_m=64, block_n=128, block_k=1024,
                        interpret=True))
                    np.testing.assert_allclose(out, pallas, rtol=0, atol=1e-5 * top)
