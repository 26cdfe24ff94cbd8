"""Runtime layer: fault tolerance (port of ``repro/runtime``; sharding,
activation hints and pipeline parallelism come with distribution)."""
