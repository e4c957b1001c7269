"""Model families (so far the dense decoder)."""
