"""Runtime layer (port of ``repro/runtime``): fault tolerance, the
sharding rules and their activation hints, and GPipe pipeline
parallelism."""
