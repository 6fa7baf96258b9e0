"""The decoder LM backbone (config, layers, Mamba-2 SSD, MoE, model) for serving and
training."""
