"""The fault-tolerant training loop (``train/trainer.py``)."""
