"""Layers, AdaLN conditioning, attention projections and the paged KV cache."""
