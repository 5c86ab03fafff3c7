"""prefill_useful_pct: the share of the positions the prefill computes
that a query needs: the `engine.chunk` spans' live_positions (the live
rows' prompt lengths) over their positions (rows x the plan's length,
padded rows and the decode's reserved positions included), in %
(eval/engine.py). Spans on, profiler off (benchlib.spans). Moves
queries_per_s."""

from benchlib.spans import traced


def read(run):
    got = traced(run)
    if not got:
        return None
    chunks = [r["attrs"] for r in got["records"] if r["name"] == "engine.chunk"]
    total = sum(c.get("positions", 0) for c in chunks)
    if not total:
        return None
    return 100.0 * sum(c.get("live_positions", 0) for c in chunks) / total
