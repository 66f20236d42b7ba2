"""Milliseconds the training loop waits for its next batch from the
prefetch thread in the traced stretch: the mean of the program's
``train.data_wait`` spans; train cells."""

from harness import program_spans as PS


def read(ctx):
    return PS.per_span_ms(ctx, "train", "train.data_wait", "train.data_wait")
