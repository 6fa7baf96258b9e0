"""LM serving: the RE-constrained decode engine and the continuous batcher."""
