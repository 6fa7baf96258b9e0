"""Request-log lines ``METHOD /path NNN outcome\\n``: the method and the outcome
drawn uniformly from their lists, a path of 0 to ``path_len_max`` characters
drawn uniformly from ``path_alphabet``, a status uniform in 0 … ``status_max``
printed with three digits.  A text of ``n`` bytes takes whole lines while more
than ``fill_margin`` bytes are left, then one line ``GET /aaa… 200 ok\\n`` that
fills it exactly.  Any concatenation of such texts is again one."""

import numpy as np


def make(n_bytes: int, r: np.random.Generator, spec: dict) -> bytes:
    methods = [m.encode() for m in spec["methods"]]
    outcomes = [o.encode() for o in spec["outcomes"]]
    alphabet = np.frombuffer(spec["path_alphabet"].encode(), dtype=np.uint8)
    lmax = int(spec["path_len_max"])
    margin = int(spec["fill_margin"])
    if n_bytes <= margin:
        raise ValueError(f"a log text needs more than {margin} bytes, got {n_bytes}")
    mw, ow = max(map(len, methods)), max(map(len, outcomes))
    meth = np.zeros((len(methods), mw), dtype=np.uint8)
    for i, m in enumerate(methods):
        meth[i, :len(m)] = np.frombuffer(m, dtype=np.uint8)
    outc = np.zeros((len(outcomes), ow), dtype=np.uint8)
    for i, o in enumerate(outcomes):
        outc[i, :len(o)] = np.frombuffer(o, dtype=np.uint8)
    shortest = min(map(len, methods)) + min(map(len, outcomes)) + 8
    L = n_bytes // shortest + 2          # more lines than can fit
    # one row a line, zero where a field is shorter than its width; no
    # field byte is zero, so dropping the zeros leaves the lines
    rows = np.zeros((L, mw + 2 + lmax + 5 + ow + 1), dtype=np.uint8)
    rows[:, :mw] = meth[r.integers(0, len(methods), size=L)]
    c = mw
    rows[:, c], rows[:, c + 1] = ord(" "), ord("/")
    c += 2
    plen = r.integers(0, lmax + 1, size=L)
    path = alphabet[r.integers(0, len(alphabet), size=(L, lmax))]
    path[np.arange(lmax)[None, :] >= plen[:, None]] = 0
    rows[:, c:c + lmax] = path
    c += lmax
    status = r.integers(0, int(spec["status_max"]) + 1, size=L)
    rows[:, c] = ord(" ")
    for i, div in enumerate((100, 10, 1)):
        rows[:, c + 1 + i] = ord("0") + (status // div) % 10
    rows[:, c + 4] = ord(" ")
    c += 5
    rows[:, c:c + ow] = outc[r.integers(0, len(outcomes), size=L)]
    rows[:, -1] = ord("\n")
    lens = (rows != 0).sum(axis=1)
    before = np.cumsum(lens) - lens
    m = int(np.searchsorted(before, n_bytes - margin, side="left"))
    body = rows[:m][rows[:m] != 0].tobytes()
    fill = n_bytes - len(body) - len(b"GET / 200 ok\n")
    out = body + b"GET /" + b"a" * fill + b" 200 ok\n"
    assert len(out) == n_bytes
    return out
