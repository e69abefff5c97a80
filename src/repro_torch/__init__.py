"""PyTorch/CUDA port of the SMSCC dynamic-SCC serving path (see README).

The JAX package ``repro`` is the reference; this package imports none of
it.  Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
