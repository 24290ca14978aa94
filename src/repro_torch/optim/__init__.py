"""Optimizers of the port (``optim.adamw``)."""
