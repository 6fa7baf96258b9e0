"""The mean of the program's ``phase.d2h`` spans over the window's parses (the
packed columns' copy to the host; on the card its device interval), in ms."""

from bench.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "phase.d2h")
