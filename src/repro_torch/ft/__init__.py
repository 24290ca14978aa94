"""Fault tolerance of the port: the restart loop (``ft.restart``) and straggler detection (``ft.straggler``)."""
