"""Segment and bag primitives of the port (``repro.graph`` in the JAX
package)."""
