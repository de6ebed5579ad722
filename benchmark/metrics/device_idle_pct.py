"""device_idle_pct: the share of the profiled replays' span, from the first
device operation to the last, in which no kernel, copy or memset ran."""

from metrics._replays import ops_per_replay


def read(ctx):
    ops = ops_per_replay(ctx)
    if ops is None or ops["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - ops["busy_s"] / ops["span_s"])
