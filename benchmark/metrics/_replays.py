"""Shared by the replay readers: the device operations of the traced run's
profiled graph replays, per replay."""

from harness.trace import busy_and_span


def ops_per_replay(ctx):
    ops = ctx.get("replay_ops")
    if not ops:
        return None
    busy, span = busy_and_span(ops)
    n = ctx["replays"]
    return {"kernels": sum(1 for o in ops if o[3] == "kernel") / n,
            "busy_s": busy, "span_s": span}


def kernel_seconds(ctx, word: str):
    """Device seconds per replay of the kernels whose name holds `word`."""
    ops = ctx.get("replay_ops")
    if not ops:
        return None
    return sum(o[2] for o in ops if word in o[0]) / 1e6 / ctx["replays"]
