"""Share (%) of the traced stretch in which nothing ran on the device (1
minus the union of its operations' intervals over the wall time; rank 0's
in a data-parallel cell); train cells."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
