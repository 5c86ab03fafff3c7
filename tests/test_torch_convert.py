"""Port parity for the checkpoint conversion (revisionllm_tpu_torch/
models/convert.py) against revisionllm_tpu/models/convert.py on the same
files: HF Llama weights from .safetensors shards and .bin, the projector and
ClipEncoder key surgery, PEFT LoRA directories from both packages' exporters
and the full assembly with its bf16 merges; the converted tree against HF
LlamaForCausalLM's logits (tiny f32 Llama: hidden 64, 2 layers, 4 heads)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.config import AdapterConfig as JAdapter
from revisionllm_tpu.config import LoraConfig as JLora
from revisionllm_tpu.models import convert as jconv
from revisionllm_tpu.models import revisionllm as jrl
from revisionllm_tpu.train import checkpoint as jckpt
from revisionllm_tpu_torch.config import AdapterConfig as TAdapter
from revisionllm_tpu_torch.config import LlamaConfig as TCfg
from revisionllm_tpu_torch.config import LoraConfig as TLora
from revisionllm_tpu_torch.models import adapter as tadapter
from revisionllm_tpu_torch.models import convert as tconv
from revisionllm_tpu_torch.models import llama as tllama
from revisionllm_tpu_torch.train import checkpoint as tckpt

from torch_parity import CPU, to_torch

safetensors = pytest.importorskip("safetensors")
from safetensors import safe_open  # noqa: E402
from safetensors.numpy import save_file as save_np  # noqa: E402
from safetensors.torch import save_file as save_pt  # noqa: E402

torch.set_num_threads(2)

HF_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=256,
             rms_norm_eps=1e-5, rope_theta=10000.0)


def assert_trees_equal(want, got, path=""):
    """Same structure, and every leaf the same dtype and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_trees_equal(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_trees_equal(w, g, f"{path}/{i}")
    else:
        w, g = np.asarray(want), np.asarray(got)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g, w), path


def f32_tree(tree):
    """A JAX tree (bf16 arrays included) as f32 NumPy arrays."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def hf_tiny():
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM

    torch.manual_seed(0)
    model = LlamaForCausalLM(HFConfig(**HF_KW, attn_implementation="eager")).eval()
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, state


@pytest.fixture(scope="module")
def hf_dir(hf_tiny, tmp_path_factory):
    """The tiny model as an HF directory: config.json and two f32 shards."""
    model, state = hf_tiny
    d = tmp_path_factory.mktemp("hf")
    model.config.to_json_file(str(d / "config.json"))
    names = sorted(state)
    for i, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        save_np({k: state[k] for k in part}, str(d / f"model-0000{i + 1}-of-00002.safetensors"))
    return str(d)


def test_llama_config_from_hf_matches_jax(hf_dir):
    want = jconv.llama_config_from_hf(hf_dir)
    got = tconv.llama_config_from_hf(hf_dir)
    assert got.__dict__ == want.__dict__
    assert got.num_layers == 2 and got.head_dim == 16


def test_convert_llama_matches_jax(hf_tiny, hf_dir):
    _, state = hf_tiny
    cfg = tconv.llama_config_from_hf(hf_dir)
    jcfg = jconv.llama_config_from_hf(hf_dir)
    for dtype in (np.float32, np.float16):
        got = tconv.convert_llama(state, cfg, dtype)
        assert_trees_equal(jconv.convert_llama(state, jcfg, dtype), got)
        assert all(a.flags.c_contiguous for a in jax.tree.leaves(got))
    # the keys may lack the "model." prefix
    bare = {k.removeprefix("model."): v for k, v in state.items()}
    assert_trees_equal(jconv.convert_llama(state, jcfg), tconv.convert_llama(bare, cfg))


def test_converted_logits_match_hf(hf_tiny):
    model, state = hf_tiny
    cfg = TCfg(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
               num_heads=4, num_kv_heads=4, head_dim=16, dtype="float32")
    params = tconv.convert_llama(state, cfg)
    from revisionllm_tpu_torch.models.weights import params_from_numpy

    params = params_from_numpy(params, CPU)
    ids = torch.tensor([[1, 5, 9, 44, 100, 7, 3, 21]])
    with torch.no_grad():
        want = model(ids).logits.numpy()
        hidden = tllama.forward_hidden(cfg, params, tllama.embed_tokens(params, ids),
                                       torch.arange(ids.shape[1])[None])
        got = tllama.logits_from_hidden(params, hidden).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_load_hf_llama_state_matches_jax(hf_tiny, hf_dir, tmp_path):
    """Two f32 shards, two f16 shards and a .bin: the same arrays and types
    as JAX's reader."""
    _, state = hf_tiny
    f16 = tmp_path / "f16"
    f16.mkdir()
    names = sorted(state)
    for i, part in enumerate((names[:5], names[5:])):
        save_np({k: state[k].astype(np.float16) for k in part},
                str(f16 / f"model-0000{i + 1}-of-00002.safetensors"),
                metadata={"format": "pt"})
    binary = tmp_path / "bin"
    binary.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in state.items()},
               str(binary / "pytorch_model.bin"))
    for d in (hf_dir, str(f16), str(binary)):
        want = jconv.load_hf_llama_state(d)
        assert_trees_equal(want, tconv.load_hf_llama_state(d))
    assert tconv.load_hf_llama_state(str(f16))["lm_head.weight"].dtype == np.float16
    with pytest.raises(FileNotFoundError):
        tconv.load_hf_llama_state(str(tmp_path))


def test_safetensors_reader_matches_safe_open(tmp_path):
    """The port's own reader against safetensors.safe_open: f32, f16, int
    and an empty tensor exactly, bf16 read as f32."""
    rng = np.random.default_rng(0)
    arrays = {"a": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float16),
              "c": rng.integers(-100, 100, size=(2, 3, 4)).astype(np.int8),
              "d": np.arange(6, dtype=np.int64).reshape(3, 2),
              "e": np.zeros((0, 4), np.float32)}
    path = str(tmp_path / "x.safetensors")
    save_np(arrays, path, metadata={"format": "np"})
    got = tconv.read_safetensors(path)
    with safe_open(path, framework="np") as f:
        assert_trees_equal({k: f.get_tensor(k) for k in f.keys()}, got)
    assert_trees_equal(arrays, got)

    bf = {"w": torch.randn(4, 6).to(torch.bfloat16), "v": torch.randn(9).to(torch.bfloat16)}
    path = str(tmp_path / "bf16.safetensors")
    save_pt(bf, path)
    got = tconv.read_safetensors(path)
    with safe_open(path, framework="pt") as f:
        assert_trees_equal({k: f.get_tensor(k).float().numpy() for k in f.keys()}, got)


def test_strip_projector_keys_matches_jax():
    rng = np.random.default_rng(0)
    for prefix in ("mm_projector.", "model.mm_projector.",
                   "base_model.model.model.mm_projector."):
        raw = {prefix + "weight": rng.normal(size=(4, 3)), prefix + "bias": rng.normal(size=4),
               "model.layers.0.other": rng.normal(size=2),
               "model.cross_attn.x": rng.normal(size=1)}
        got = tconv._strip_projector_keys(raw)
        assert_trees_equal(jconv._strip_projector_keys(raw), got)
        assert set(got) == {"weight", "bias", "x"}


def _torch_layer_state(d, f, seed):
    torch.manual_seed(seed)
    layer = torch.nn.ModuleDict({
        "self_attn": torch.nn.MultiheadAttention(d, 4, dropout=0.0),
        "linear1": torch.nn.Linear(d, f), "linear2": torch.nn.Linear(f, d),
        "norm1": torch.nn.LayerNorm(d), "norm2": torch.nn.LayerNorm(d)}).eval()
    sd = {f"L.{k}": v.detach().numpy() for k, v in layer.state_dict().items()}
    return layer, sd


def test_mha_layer_matches_jax_and_torch():
    """_convert_mha_layer: JAX's tree, and the port's post-norm encoder layer
    on it against torch's MultiheadAttention layer (tests/test_convert.py's
    check of JAX)."""
    d, f, B, L = 32, 64, 2, 7
    layer, sd = _torch_layer_state(d, f, 1)
    got = tconv._convert_mha_layer("L", sd, d, np.float32)
    assert_trees_equal(jconv._convert_mha_layer("L", sd, d, np.float32), got)

    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.normal(size=(B, L, d)).astype(np.float32))
    pos = tadapter.sine_positions(torch.ones(B, L), d)
    with torch.no_grad():
        s, p = src.permute(1, 0, 2), pos.permute(1, 0, 2)
        x = layer["norm1"](s + layer["self_attn"](s + p, s + p, value=s)[0])
        want = layer["norm2"](x + layer["linear2"](torch.relu(layer["linear1"](x))))
        out = tadapter._encoder_layer_post(to_torch(got), src, pos, torch.ones(B, L, dtype=bool), 4)
    np.testing.assert_allclose(out.numpy(), want.permute(1, 0, 2).numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t2v", [False, True])
def test_convert_clip_adapter_matches_jax(t2v):
    """A ClipEncoder tree written by JAX's exporter converts back to itself,
    in both packages, with and without the T2V encoder."""
    kw = dict(d_model=16, num_heads=4, num_layers=2, ffn_dim=32, hidden_size=64,
              clip_adapter_text=t2v, hierarchy=False, feature_mode="temporal")
    tree = f32_tree(jrl.init_vision_params(JAdapter(**kw), jax.random.PRNGKey(3), d_in=16))
    state = {}
    jckpt._export_vision(state, tree["mm_projector"], "model.mm_projector")
    raw = {k: v.numpy() for k, v in state.items()}
    got = tconv.convert_clip_adapter(raw, TAdapter(**kw))
    assert_trees_equal(jconv.convert_clip_adapter(raw, JAdapter(**kw)), got)
    assert_trees_equal(tree["mm_projector"], got)
    assert ("t2v_layers" in got) == t2v


def test_convert_mlp_projector_matches_jax():
    rng = np.random.default_rng(1)
    for prefix in ("", "model.mm_projector."):
        raw = {prefix + "weight": rng.normal(size=(64, 16)).astype(np.float32),
               prefix + "bias": rng.normal(size=(64,)).astype(np.float32)}
        got = tconv.convert_mlp_projector(raw)
        assert_trees_equal(jconv.convert_mlp_projector(raw), got)
        assert got["w"].shape == (16, 64)


def _lora_tree(names, seed, L=2, D=64, F=128, r=4):
    rng = np.random.default_rng(seed)
    dims = {"q_proj": (D, D), "k_proj": (D, D), "v_proj": (D, D), "o_proj": (D, D),
            "gate_proj": (D, F), "up_proj": (D, F), "down_proj": (F, D)}
    return {"layers": {n: {"a": rng.normal(size=(L, dims[n][0], r)).astype(np.float32) * 0.3,
                           "b": rng.normal(size=(L, r, dims[n][1])).astype(np.float32) * 0.3}
                       for n in names}}


def _export(side, out, lora, names, vision=None):
    """Write a stage directory with JAX's exporter (side "jax") or the
    port's."""
    if side == "jax":
        jckpt.export_reference_artifacts(out, lora, JLora(r=4, alpha=8, target_patterns=names),
                                         vision)
    else:
        tckpt.export_reference_artifacts(
            out, to_torch(lora), TLora(r=4, alpha=8, target_patterns=names),
            None if vision is None else to_torch(vision))
    return out


@pytest.mark.parametrize("side", ["jax", "port"])
def test_convert_peft_lora_matches_jax(hf_dir, tmp_path, side):
    names = ("q_proj", "v_proj", "gate_proj", "down_proj")
    lora = _lora_tree(names, 5)
    d = _export(side, str(tmp_path / side), lora, names)
    # a projection that not every layer has is dropped in both packages
    extra = torch.load(os.path.join(d, "adapter_model.bin"), weights_only=True)
    extra["base_model.model.model.layers.0.self_attn.k_proj.lora_A.weight"] = torch.ones(4, 64)
    extra["base_model.model.model.layers.0.self_attn.k_proj.lora_B.weight"] = torch.ones(64, 4)
    torch.save(extra, os.path.join(d, "adapter_model.bin"))
    jtree, jcfg = jconv.convert_peft_lora(d, jconv.llama_config_from_hf(hf_dir))
    ttree, tcfg = tconv.convert_peft_lora(d, tconv.llama_config_from_hf(hf_dir))
    assert_trees_equal(jtree, ttree)
    assert_trees_equal(lora, ttree)
    assert (tcfg.r, tcfg.alpha, tcfg.dropout, tcfg.target_patterns) == \
        (jcfg.r, jcfg.alpha, jcfg.dropout, jcfg.target_patterns) == (4, 8, 0.05, names)
    os.remove(os.path.join(d, "adapter_model.bin"))
    with pytest.raises(FileNotFoundError):
        tconv.convert_peft_lora(d, tconv.llama_config_from_hf(hf_dir))


BF16_ULP_SHARE = 1e-3   # places of a merged matrix where the two merges may differ


def assert_within_one_bf16_ulp(want, got, merged):
    """Leaves equal, except the LoRA-merged matrices (`merged`), which may
    differ by one bf16 ulp at under BF16_ULP_SHARE of their places: the two
    f32 einsums of A @ B sum in different orders. Returns the share."""
    shares = []
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        w = np.asarray(w, np.float32)
        assert g.dtype == np.float32 and g.shape == w.shape, path
        name = jax.tree_util.keystr(path)
        if not any(f"'{m}'" in name for m in merged):
            assert np.array_equal(g, w), name
            continue
        diff = g != w
        ulp = np.maximum(*(np.ldexp(np.float32(1), np.frexp(a)[1] - 8) for a in (w, g)))
        assert (np.abs(g - w)[diff] <= ulp[diff]).all(), name
        shares.append(diff.mean())
    assert max(shares) < BF16_ULP_SHARE, shares
    return max(shares)


def _assemble(tmp_path, kind):
    """A stage-2 directory from JAX's exporter (q/v LoRA and a saved
    projector of `kind`) and a stage-3 one from the port's (all seven
    linears, no projector)."""
    if kind == "mlp":
        acfg = dict(kind="mlp", hidden_size=64, hierarchy=False)
        vision = f32_tree(jrl.init_vision_params(JAdapter(**acfg), jax.random.PRNGKey(4),
                                                 d_in=16))
    else:
        acfg = dict(d_model=16, num_heads=4, num_layers=2, ffn_dim=32, hidden_size=64,
                    clip_adapter_text=True, hierarchy=False, feature_mode="temporal")
        vision = f32_tree(jrl.init_vision_params(JAdapter(**acfg), jax.random.PRNGKey(4),
                                                 d_in=16))
    s2 = _export("jax", str(tmp_path / f"s2_{kind}"), _lora_tree(("q_proj", "v_proj"), 6),
                 ("q_proj", "v_proj"), vision)
    names = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
    s3 = _export("port", str(tmp_path / "s3"), _lora_tree(names, 7), names)
    return acfg, vision, s2, s3


@pytest.mark.parametrize("kind", ["clip_encoder", "mlp"])
def test_load_pretrained_matches_jax(hf_dir, tmp_path, kind):
    """Base, then the stage-2 LoRA (JAX's exporter) with its projector as
    the fallback, then the stage-3 LoRA (the port's exporter), all in bf16:
    JAX's values after the bf16 rounding, to one bf16 ulp at under 0.1% of
    a merged matrix's places (measured: see CHANGES.md)."""
    acfg, vision, s2, s3 = _assemble(tmp_path, kind)
    jcfg, jparams, jvision = jconv.load_pretrained(hf_dir, JAdapter(**acfg), stage2_lora=s2,
                                                   stage3_lora=s3, dtype=jnp.bfloat16)
    tcfg, tparams, tvision = tconv.load_pretrained(hf_dir, TAdapter(**acfg), stage2_lora=s2,
                                                   stage3_lora=s3, dtype=torch.bfloat16)
    assert tcfg.__dict__ == jcfg.__dict__
    assert_within_one_bf16_ulp(jparams, tparams, ("q_proj", "k_proj", "v_proj", "o_proj",
                                                  "gate_proj", "up_proj", "down_proj"))
    assert_trees_equal(f32_tree(jvision), tvision)
    rounded = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32), vision)
    assert_trees_equal(rounded, tvision)
    # the merges changed the base: the stage-3 LoRA reaches every linear
    base = tconv.load_pretrained(hf_dir, TAdapter(**acfg), dtype=torch.bfloat16)[1]
    for name in ("q_proj", "down_proj"):
        assert not np.array_equal(base["layers"][name], tparams["layers"][name])
    # and in f32 the port equals JAX's f32 merge to f32 rounding
    jp32 = jconv.load_pretrained(hf_dir, JAdapter(**acfg), stage2_lora=s2)[1]
    tp32 = tconv.load_pretrained(hf_dir, TAdapter(**acfg), stage2_lora=s2)[1]
    np.testing.assert_allclose(tp32["layers"]["q_proj"], np.asarray(jp32["layers"]["q_proj"]),
                               rtol=1e-6, atol=1e-6)
    assert_trees_equal(f32_tree(jp32["layers"]["up_proj"]), tp32["layers"]["up_proj"])


def test_load_pretrained_keeps_the_explicit_projector(hf_dir, tmp_path):
    """An explicit mm_projector_path wins over a stage directory's saved
    projector, and a saved projector of the other kind is never adopted."""
    acfg, vision, s2, _ = _assemble(tmp_path, "clip_encoder")
    mlp_cfg, mlp_vision, s2_mlp, _ = _assemble(tmp_path, "mlp")
    proj = str(tmp_path / "mm_projector.bin")
    state = {}
    jckpt._export_vision(state, vision["mm_projector"], "model.mm_projector")
    torch.save(state, proj)
    for kw in (dict(mm_projector_path=proj, stage2_lora=s2_mlp),   # explicit over saved
               dict(stage2_lora=s2_mlp),                           # other kind: not adopted
               dict(mm_projector_path=proj)):
        _, _, jv = jconv.load_pretrained(hf_dir, JAdapter(**acfg), dtype=jnp.bfloat16, **kw)
        _, _, tv = tconv.load_pretrained(hf_dir, TAdapter(**acfg), dtype=torch.bfloat16, **kw)
        if jv is None:
            assert tv is None and "mm_projector_path" not in kw
        else:
            assert_trees_equal(f32_tree(jv), tv)
            assert "t2v_layers" in tv["mm_projector"]
    # an mlp adapter ignores a stage directory's ClipEncoder
    _, _, tv = tconv.load_pretrained(hf_dir, TAdapter(**mlp_cfg), stage2_lora=s2)
    assert tv is None
