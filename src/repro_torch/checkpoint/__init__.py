"""Step-granular checkpoints of the port (``checkpoint.store``)."""
