"""One reader a metric, ``<metric>.py`` with ``read(record) -> float |
None``, and the frozen arithmetic they share (``_yardstick.py``)."""
