"""Useful model FLOPs of the traced run's untraced steps (at each
molecule's true atom count) over their host seconds, over the chips' dense
tensor-core peak of the cell's precision (%); train cells. The traced
stretch is left out: the profiler slows the host there."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("untraced_s") or not ctx.get("useful_flops"):
        return None
    return 100.0 * ctx["useful_flops"] / ctx["untraced_s"] / (ctx["chips"] * ctx["peak_flops"])
