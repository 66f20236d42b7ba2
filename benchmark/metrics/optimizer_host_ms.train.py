"""Host milliseconds a train step spends outside the model in the traced
stretch: the program's ``train.zero_grad``, ``train.clip``,
``train.optimizer`` (AMSGrad) and ``train.ema`` spans over its
``train.step`` count; train cells."""

from harness import program_spans as PS


def read(ctx):
    return PS.per_span_ms(ctx, "train", "train.step", "train.zero_grad", "train.clip",
                          "train.optimizer", "train.ema")
