"""Mesh construction over the ranks of a ``torch.distributed`` group (``mesh``)."""
