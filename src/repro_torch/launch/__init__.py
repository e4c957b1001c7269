"""Entry points (so far the static serving engine)."""
