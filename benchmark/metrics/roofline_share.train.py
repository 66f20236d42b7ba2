"""Share (%) of the device's busy time in the traced stretch that the EGNN
work it ran needed at least: per block the larger of its FLOPs over the
cell's peak and its bytes over HBM bandwidth, at each molecule's true atom
count (harness/flops.py); train cells."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or not tr or tr["busy_s"] <= 0 or not ctx.get("least_s"):
        return None
    return 100.0 * ctx["least_s"] / tr["busy_s"]
