"""Small cells for the CPU tests: a BENCHMARK.json cell with its model and
traffic cut to toy sizes (every width shrunk, the structure kept), and the
helpers that run it."""

import copy

from benchlib.cell import cell as find_cell

SMALL_DIMS = {"hidden": 128, "ffn": 256, "layers": 2, "heads": 4, "head_dim": 32,
              "vocab": 32000}
SMALL_ADAPTER = {"d_model": 32, "num_heads": 4, "ffn_dim": 64}
SMALL_MIX = {"movie_frames": 200, "feature_dim": 32, "movies": 2, "queries_per_movie": 2,
             "sentence_words": [3, 5], "query_tokens_max": 6,
             "trace_queries": 1, "check_queries": 2}
SMALL_EVAL = {"batch": 8, "max_new_tokens": 4, "debug_window": 10, "num_frames": 16}


def small_cell(workload, limits=None):
    c = copy.deepcopy(find_cell(workload))
    # as many query heads a kv head as the model has, or all of them on one
    kv = max(1, c["dims"]["kv_heads"] * SMALL_DIMS["heads"] // c["dims"]["heads"])
    c["dims"].update(SMALL_DIMS, kv_heads=kv)
    c["adapter"].update(SMALL_ADAPTER)
    c["traffic"].update(SMALL_MIX)
    c["traffic"]["eval"].update(SMALL_EVAL)
    if limits is not None:
        c["limits"] = limits
    return c
