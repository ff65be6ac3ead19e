"""Optimizers of the port (AdamW, the JAX package's arithmetic)."""
