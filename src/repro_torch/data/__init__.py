"""Deterministic, seeded synthetic data streams (``data/pipeline.py``)."""
