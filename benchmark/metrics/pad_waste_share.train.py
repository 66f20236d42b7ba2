"""Share (%) of the pair slots the traced stretch's train steps were issued
with (rows x pad^2) that no atom pair of a molecule fills: 100 x (1 -
``train.pairs`` / ``train.pair_slots``), the program's counters; train
cells."""

from harness import program_spans as PS


def read(ctx):
    return PS.pad_waste(ctx, "train", "train")
