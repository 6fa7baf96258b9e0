"""The mean of the program's ``parse.plan`` spans over the window's parses (a
text's classes and its bucket, on the host), in ms."""

from bench.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "parse.plan")
