"""device_idle_pct.serve: the share of the traced window in which no
operation ran on the device: 1 - the union of the device's intervals on
the profiler's timeline over the window, in %. Moves queries_per_s."""


def read(run):
    tr = run["trace"]
    if not tr or not tr["ops"] or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
