"""Logical-axis sharding rules over the parse mesh (``sharding``)."""
