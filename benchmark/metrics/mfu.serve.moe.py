"""mfu.serve.moe: the least time the chip could do the window's model
arithmetic in, on DeepSeek-V2 (benchlib.roofline_moe.query_least_s: each
query's live windows through the adapter, the int8 prefill with MLA
decompressed and 6 routed plus the shared experts, the f32 router, the
lm_head and the decode steps with MLA absorbed, each at the precision the
configuration runs it), as a share of the untraced window's seconds on the
host's clock. Moves queries_per_s."""

from benchlib.roofline_moe import query_least_s


def read(run):
    cell, recs = run["cell"], run["records"]
    if not recs or not run["window_s"] or "kv_lora" not in cell["dims"]:
        return None
    ev = cell["traffic"]["eval"]
    least = sum(query_least_s(cell["dims"], cell["adapter"], r["windows"], r["live"],
                              r["text_tokens"], ev["num_frames"], ev["max_new_tokens"])
                for r in recs)
    return 100.0 * least / run["window_s"]
