"""Mean ms a batch of the card's time in the layer-route read convolvers:
the port's ``scorer.read_conv_layers`` records (one a batch: the sum, over
its read convolvers that take the layer route, of the card's clock after
less before, stamped by the card into the batch's own outputs, so replays
of one captured graph each carry their own), stamped with the batch's
start, over the measured window of the traced run.

None on the CPU, from a port that stamps nothing, or where no batch took
the layer route."""

from h100_bench.program_spans import window_mean


def read(ctx):
    return window_mean(ctx, "scorer.read_conv_layers")
