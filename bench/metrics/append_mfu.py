"""A whole append's share of the card's peak: the sum over the window's appends
of each one's least time by the frozen counts (its piece's reach and the
compose that folds it in), over the sum of their latencies, in %."""

from bench import counts
from bench.readers import share


def read(run):
    t = run.tables
    least = sum(counts.seconds(*counts.append(chars, t["k"], t["lp"], t["ell"]))
                for _, chars in run.appends)
    return share(least, sum(lat for lat, _ in run.appends))
