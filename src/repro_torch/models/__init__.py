"""The decoder LM backbone (config, layers, Mamba-2 SSD, model) for serving."""
