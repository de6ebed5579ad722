"""graph_kernels: kernels the device ran per frame in the traced run's
profiled graph replays (frame.py::GraphFrame), from the profiler's trace."""

from metrics._replays import ops_per_replay


def read(ctx):
    ops = ops_per_replay(ctx)
    if ops is None:
        return None
    return ops["kernels"]
