"""The model's weights, made from the seed on the device: the benchmark's
inputs, handed to the program (which derives its int8 or int4 weights
from them) and drawn again, layer by layer, by the plain reference.

Every leaf group has a generator of its own, seeded from (seed, tag), so
one layer can be drawn again without the layers before it. A layer's
seven matrices come from one torch.randn call."""

from __future__ import annotations

import hashlib
import math

import torch

# (name, input size, output size) by the dims' keys, in the order drawn
MATRICES = (
    ("q_proj", "hidden", "q_out"),
    ("k_proj", "hidden", "kv_out"),
    ("v_proj", "hidden", "kv_out"),
    ("o_proj", "q_out", "hidden"),
    ("gate_proj", "hidden", "ffn"),
    ("up_proj", "hidden", "ffn"),
    ("down_proj", "ffn", "hidden"),
)


def sub_seed(seed: int, tag: str) -> int:
    h = hashlib.blake2b(f"{int(seed)}/{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << 63) - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def sizes(dims):
    return {"hidden": dims["hidden"], "q_out": dims["heads"] * dims["head_dim"],
            "kv_out": dims["kv_heads"] * dims["head_dim"], "ffn": dims["ffn"]}


def matrix_shapes(dims):
    s = sizes(dims)
    return [(name, s[a], s[b]) for name, a, b in MATRICES]


def layer_matrices(dims, seed: int, i: int, device):
    """{name: f32 [in, out]} of layer i, N(0, 1/in), views of one draw."""
    shapes = matrix_shapes(dims)
    flat = torch.randn(sum(a * b for _, a, b in shapes), generator=generator(seed, f"layer{i}",
                                                                              device),
                       device=device)
    out, off = {}, 0
    for name, a, b in shapes:
        out[name] = flat[off: off + a * b].view(a, b).mul_(a ** -0.5)
        off += a * b
    return out


def layer_vectors(dims, seed: int, i: int, device):
    """Layer i's norms (1 + N(0, 0.1^2)) and, with qkv_bias, its q/k/v
    biases (N(0, 0.5^2)), in bfloat16."""
    g = generator(seed, f"layer{i}/vectors", device)
    D, s = dims["hidden"], sizes(dims)
    out = {n: (1 + 0.1 * torch.randn(D, generator=g, device=device)).to(torch.bfloat16)
           for n in ("attn_norm", "mlp_norm")}
    if dims["qkv_bias"]:
        for n, w in (("q_bias", "q_out"), ("k_bias", "kv_out"), ("v_bias", "kv_out")):
            out[n] = (0.5 * torch.randn(s[w], generator=g, device=device)).to(torch.bfloat16)
    return out


def embed(dims, seed: int, device) -> torch.Tensor:
    g = generator(seed, "embed", device)
    return (0.02 * torch.randn((dims["vocab"], dims["hidden"]), generator=g, device=device)
            ).to(torch.bfloat16)


def final_norm(dims, seed: int, device) -> torch.Tensor:
    g = generator(seed, "final_norm", device)
    return (1 + 0.1 * torch.randn(dims["hidden"], generator=g, device=device)).to(torch.bfloat16)


def lm_head(dims, seed: int, device) -> torch.Tensor:
    """f32 [hidden, vocab], N(0, 1/hidden)."""
    g = generator(seed, "lm_head", device)
    return torch.randn((dims["hidden"], dims["vocab"]), generator=g, device=device).mul_(
        dims["hidden"] ** -0.5)


def adapter(acfg, hidden: int, seed: int, device):
    """The T2V ClipEncoder's parameters in bfloat16, in the tree the
    program takes ({"w": [in, out], "b"} linears, lists of layer dicts):
    xavier-uniform linears with N(0, 0.02^2) biases, LayerNorms
    1 + N(0, 0.1^2) and N(0, 0.1^2), the CLS token and its position N(0, 1)."""
    g = generator(seed, "adapter", device)
    d, f = acfg["d_model"], acfg["ffn_dim"]

    def lin(a, b):
        bound = math.sqrt(6.0 / (a + b))
        w = (torch.rand((a, b), generator=g, device=device) * 2 - 1) * bound
        return {"w": w.to(torch.bfloat16),
                "b": (0.02 * torch.randn(b, generator=g, device=device)).to(torch.bfloat16)}

    def layer():
        out = {n: lin(d, d) for n in ("wq", "wk", "wv", "wo")}
        out["ffn1"], out["ffn2"] = lin(d, f), lin(f, d)
        for n in ("norm1", "norm2"):
            out[f"{n}_w"] = (1 + 0.1 * torch.randn(d, generator=g, device=device)).to(
                torch.bfloat16)
            out[f"{n}_b"] = (0.1 * torch.randn(d, generator=g, device=device)).to(torch.bfloat16)
        return out

    tree = {
        "global_token": torch.randn(d, generator=g, device=device).to(torch.bfloat16),
        "global_pos": torch.randn(d, generator=g, device=device).to(torch.bfloat16),
        "enc_layers": [layer() for _ in range(acfg["num_layers"])],
    }
    if acfg["clip_adapter_text"]:
        tree["t2v_layers"] = [layer() for _ in range(acfg["num_layers"])]
    tree["mm_projector"] = lin(d, hidden)
    return tree
