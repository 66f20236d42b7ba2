"""Host milliseconds a sampling call spends before its first dispatch and
after its last copy to the host, when the card has nothing of it queued:
the program's ``sample.setup`` and ``sample.assemble`` spans over its
``sample.call`` count in the traced stretch; sample cells."""

from harness import program_spans as PS


def read(ctx):
    return PS.per_span_ms(ctx, "sample", "sample.call", "sample.setup", "sample.assemble")
