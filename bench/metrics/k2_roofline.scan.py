"""K2's share of its roofline over the window's parses: the least time of the
work the parses needed by the frozen counts (``bench/counts.py``), over the
device time the trace gives K2's kernels, in %."""

from bench.readers import kernel_s, scan_least_s, share


def read(run):
    return share(scan_least_s(run, "k2"), kernel_s(run, "k2"))
