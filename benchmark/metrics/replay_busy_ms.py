"""replay_busy_ms: device ms per frame in which some kernel, copy or memset
ran, in the traced run's profiled graph replays: the frame's device work
without the idle gaps between its nodes. It stands beside frames_per_s,
which also carries those gaps."""

from metrics._replays import ops_per_replay


def read(ctx):
    ops = ops_per_replay(ctx)
    if ops is None or ops["busy_s"] <= 0:
        return None
    return 1e3 * ops["busy_s"] / ctx["replays"]
