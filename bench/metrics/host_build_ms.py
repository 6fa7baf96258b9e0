"""The mean of the program's ``phase.host_build`` spans over the window's parses, in ms."""

from bench.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "phase.host_build")
