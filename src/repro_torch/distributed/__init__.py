"""What the serving tier needs of the JAX package's ``distributed/``:
atomic on-disk checkpoints (``checkpoint``) and the shard placement and
heartbeat bookkeeping of its fault handling (``fault``)."""
