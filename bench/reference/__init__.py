"""The benchmark's plain reference: a frozen copy of the parser's front-end and
the clean parse forest in plain PyTorch (``forest.py``)."""
