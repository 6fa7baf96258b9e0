"""K1's share of its roofline over the window's batched piece reaches: the least
time of each step's launch by the frozen counts (``bench/counts.py``), over the
device time the trace gives K1's kernels, in %."""

from bench.readers import kernel_s, share, tail_k1_least_s


def read(run):
    return share(tail_k1_least_s(run), kernel_s(run, "k1"))
