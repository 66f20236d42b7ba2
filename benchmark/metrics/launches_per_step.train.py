"""Device kernels per train step in the traced stretch (rank 0's), counted
from the profiler: the program's kernels and PyTorch's alike."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or not tr or not ctx.get("steps") or tr["busy_s"] <= 0:
        return None
    return tr["kernel_count"] / ctx["steps"]
