"""Model sizes of a DeepSeek-V2 config.json (HF `deepseek_v2` keys): the
keys the dense families give (the tests' small cells shrink those), and
the latent attention's, the experts' and YaRN's."""


def dims(cfg):
    heads = cfg["num_attention_heads"]
    rs = cfg.get("rope_scaling") or {}
    yarn = rs.get("type") == "yarn"
    return {
        "vocab": cfg["vocab_size"],
        "hidden": cfg["hidden_size"],
        "ffn": cfg["intermediate_size"],
        "layers": cfg["num_hidden_layers"],
        "heads": heads,
        "kv_heads": cfg.get("num_key_value_heads", heads),
        "head_dim": cfg["v_head_dim"],
        "eps": cfg["rms_norm_eps"],
        "rope_theta": float(cfg.get("rope_theta", 10000.0)),
        "kv_lora": cfg["kv_lora_rank"],
        "qk_nope": cfg["qk_nope_head_dim"],
        "qk_rope": cfg["qk_rope_head_dim"],
        "v_head": cfg["v_head_dim"],
        "experts": cfg["n_routed_experts"],
        "shared": cfg["n_shared_experts"],
        "top_k": cfg["num_experts_per_tok"],
        "moe_ffn": cfg["moe_intermediate_size"],
        "dense_layers": cfg["first_k_dense_replace"],
        "routed_scaling": float(cfg.get("routed_scaling_factor", 1.0)),
        "norm_topk": bool(cfg.get("norm_topk_prob", False)),
        "rope_factor": float(rs["factor"]) if yarn else 1.0,
        "rope_original": int(rs.get("original_max_position_embeddings", 4096)),
        "beta_fast": float(rs.get("beta_fast", 32)),
        "beta_slow": float(rs.get("beta_slow", 1)),
        "mscale": float(rs.get("mscale", 1)),
        "mscale_all_dim": float(rs.get("mscale_all_dim", 0)),
    }
