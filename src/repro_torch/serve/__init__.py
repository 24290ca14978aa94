"""Batched serving of the port's models (``serve.engine``)."""
