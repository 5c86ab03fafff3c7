"""Model sizes of a Llama-family config.json (HF keys), as the harness and
the plain reference use them."""


def dims(cfg):
    heads = cfg["num_attention_heads"]
    return {
        "vocab": cfg["vocab_size"],
        "hidden": cfg["hidden_size"],
        "ffn": cfg["intermediate_size"],
        "layers": cfg["num_hidden_layers"],
        "heads": heads,
        "kv_heads": cfg.get("num_key_value_heads", heads),
        "head_dim": cfg["hidden_size"] // heads,
        "eps": cfg["rms_norm_eps"],
        "rope_theta": cfg.get("rope_theta", 10000.0),
        "rope_fraction": 1.0,
        "rope_interleaved": False,
        "qkv_bias": False,
    }
