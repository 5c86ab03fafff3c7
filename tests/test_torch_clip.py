"""Port parity: models/clip.py against revisionllm_tpu's CLIP and against a
transformers CLIPModel on the same weights, on the CPU in f32.

The CLIPModel is built from a local tiny config (as tests/test_clip.py
builds one; nothing is downloaded): two heads in the vision tower and one in
the text tower, widths 64 a head as convert_hf_clip assumes, and the largest
vocabulary id as EOT, so that HF's EOS pooling and CLIP's argmax pooling
pick the same token. Features agree within 1e-5 of their largest entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.models import clip as jclip
from revisionllm_tpu_torch.models import clip as tclip
from revisionllm_tpu_torch.models.weights import params_from_numpy

pytest.importorskip("transformers")
TOL = 1e-5
IDS = np.array([[49, 3, 7, 98, 0, 0], [49, 5, 98, 0, 0, 0], [49, 98, 0, 0, 0, 0]], np.int64)


@pytest.fixture(scope="module")
def hf_clip():
    from transformers import CLIPConfig, CLIPModel

    cfg = CLIPConfig(
        text_config=dict(vocab_size=99, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=1,
                         max_position_embeddings=16, eos_token_id=98),
        vision_config=dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                           num_attention_heads=2, image_size=28, patch_size=14),
        projection_dim=32,
    )
    torch.manual_seed(0)
    model = CLIPModel(cfg).eval()
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, state


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), err


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _leaves(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, list):
        return {p: v for i, x in enumerate(tree) for p, v in _leaves(x, f"{path}/{i}").items()}
    return {path: tree}


def test_convert_hf_clip_matches_jax(hf_clip):
    _, state = hf_clip
    got, want = _leaves(tclip.convert_hf_clip(state)), _leaves(jclip.convert_hf_clip(state))
    assert set(got) == set(want) and len(want) > 40
    for k in want:
        assert type(got[k]) is type(want[k]), k
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert got["/visual/num_heads"] == 2 and got["/text/num_heads"] == 1
    dev = params_from_numpy(tclip.convert_hf_clip(state), "cpu")
    assert type(dev["visual"]["patch_size"]) is int and dev["visual"]["patch_size"] == 14
    assert type(dev["text"]["num_heads"]) is int and dev["visual"]["proj"].dtype == torch.float32


def test_encode_image_matches_jax_and_hf(hf_clip):
    model, state = hf_clip
    pixels = np.random.default_rng(0).normal(size=(3, 3, 28, 28)).astype(np.float32)
    params = params_from_numpy(tclip.convert_hf_clip(state), "cpu")
    got = tclip.encode_image(params, torch.from_numpy(pixels)).numpy()
    assert got.shape == (3, 32)
    _close(got, jclip.encode_image(jclip.convert_hf_clip(state), jnp.asarray(pixels)))
    with torch.no_grad():
        out = model.get_image_features(pixel_values=torch.from_numpy(pixels))
    _close(got, getattr(out, "pooler_output", out).numpy())


def test_encode_text_matches_jax_and_hf(hf_clip):
    """The dual return: per-token features and the EOT-pooled one."""
    model, state = hf_clip
    params = params_from_numpy(tclip.convert_hf_clip(state), "cpu")
    got = tclip.encode_text(params, torch.from_numpy(IDS))
    want = jclip.encode_text(jclip.convert_hf_clip(state), jnp.asarray(IDS))
    assert got["last_hidden_state"].shape == (3, 6, 32) and got["pooler_output"].shape == (3, 32)
    for k in ("last_hidden_state", "pooler_output"):
        _close(got[k].numpy(), want[k])
    with torch.no_grad():
        out = model.get_text_features(input_ids=torch.from_numpy(IDS))
    _close(got["pooler_output"].numpy(), getattr(out, "pooler_output", out).numpy())
    eot = IDS.argmax(1)
    for b in range(3):
        assert torch.equal(got["pooler_output"][b], got["last_hidden_state"][b, eot[b]])


def test_quick_gelu():
    x = torch.linspace(-6, 6, 101)
    np.testing.assert_allclose(tclip.quick_gelu(x).numpy(),
                               np.asarray(jclip.quick_gelu(jnp.asarray(x.numpy()))), rtol=1e-6,
                               atol=1e-7)
