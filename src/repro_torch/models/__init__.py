"""The dense decoder-only LM of the JAX package's LEGACY model stack, on
its serving side (prefill and decode)."""
