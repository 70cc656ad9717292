"""Multi-worker execution of the port: only ``multihost`` so far."""
