"""Multi-worker and multi-device execution of the port: ``multihost``
(shot-sharded workers and their part files), ``scheduler`` (shots over
devices), ``mesh`` / ``sharding`` (a (data, model) mesh over a
``torch.distributed`` group, the sharded embedder and train step) and
``dryrun`` (the sharded paths end to end, and the rank launcher)."""
