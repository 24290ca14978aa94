"""Synthetic training data of the port (``data.pipeline``; its draws in ``data.prng``)."""
