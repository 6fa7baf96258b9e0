"""The share of the window in which no operation ran on the device, in %: the
reader of every ``device_idle.<kind>`` metric."""

from bench.readers import idle_pct


def read(run):
    return idle_pct(run)
