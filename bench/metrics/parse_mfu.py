"""A whole parse's share of the card's peak: the sum over the window's parses of
each one's least time by the frozen counts (K1, the join and K2's operations;
the text in and the packed columns out), over the sum of their wall times, in %."""

from bench import counts
from bench.readers import share


def read(run):
    t = run.tables
    least = sum(counts.seconds(*counts.parse(n, C, k, t["lp"], t["n_tables"], t["ell"]))
                for _, n, (C, k) in run.parses)
    return share(least, sum(wall for wall, _, _ in run.parses))
