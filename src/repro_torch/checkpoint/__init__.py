"""Checkpoints of the PyTorch port, in the JAX package's sharded format
(see ``checkpointing.py``)."""
