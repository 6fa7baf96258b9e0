"""Characters drawn uniformly from ``alphabet``, with ``anchor`` set
``anchor_from_end`` characters before the end."""

import numpy as np


def make(n_bytes: int, r: np.random.Generator, spec: dict) -> bytes:
    alphabet = np.frombuffer(spec["alphabet"].encode(), dtype=np.uint8)
    text = alphabet[r.integers(0, len(alphabet), size=n_bytes)]
    text[-int(spec["anchor_from_end"])] = ord(spec["anchor"])
    return text.tobytes()
