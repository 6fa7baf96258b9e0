"""Text grammars, one module a grammar: ``make(n_bytes, rng, spec)`` returns a
text of ``n_bytes`` bytes of the grammar a configuration's ``"text"`` names."""
