"""Multi-worker execution of the port: ``multihost`` (shot-sharded
workers and their part files) and ``scheduler`` (shots over devices)."""
