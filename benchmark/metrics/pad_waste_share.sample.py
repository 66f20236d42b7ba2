"""Share (%) of the pair slots the traced stretch's sampling chunks were
dispatched with (rows x pad^2, a bucket's repeated rows included) that no
atom pair of a requested molecule fills: 100 x (1 - ``sample.pairs`` /
``sample.pair_slots``), the program's counters; sample cells."""

from harness import program_spans as PS


def read(ctx):
    return PS.pad_waste(ctx, "sample", "sample")
