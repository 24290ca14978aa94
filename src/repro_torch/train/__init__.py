"""The port's train step (``train.step``)."""
