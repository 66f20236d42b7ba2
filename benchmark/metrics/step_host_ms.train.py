"""Host milliseconds a train step takes to issue in the traced stretch: the
mean of the program's ``train.step`` spans (zero_grad to EMA, not waiting
for the device); train cells."""

from harness import program_spans as PS


def read(ctx):
    return PS.per_span_ms(ctx, "train", "train.step", "train.step")
