"""The LM: layers, decoder stack and model entry points (dense decoder)."""
