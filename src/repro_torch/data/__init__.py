"""Seekable training data (``pipeline``) and REgen sampling (``regen``)."""
