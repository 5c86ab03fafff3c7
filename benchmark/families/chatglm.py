"""Model sizes of a ChatGLM2 config.json (its own keys): multi-query groups
of kv heads, q/k/v biases, and the rotary over half of each head in
interleaved (even, odd) pairs (the original_rope of modeling_chatglm.py)."""


def dims(cfg):
    heads = cfg["num_attention_heads"]
    return {
        "vocab": cfg["padded_vocab_size"],
        "hidden": cfg["hidden_size"],
        "ffn": cfg["ffn_hidden_size"],
        "layers": cfg["num_layers"],
        "heads": heads,
        "kv_heads": cfg["multi_query_group_num"] if cfg.get("multi_query_attention") else heads,
        "head_dim": cfg["kv_channels"],
        "eps": cfg["layernorm_epsilon"],
        "rope_theta": 10000.0,
        "rope_fraction": 0.5,
        "rope_interleaved": True,
        "qkv_bias": bool(cfg.get("add_qkv_bias")),
    }
