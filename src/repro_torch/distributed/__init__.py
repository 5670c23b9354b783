"""The single-card part of the JAX package's ``distributed/``: atomic
on-disk checkpoints (``checkpoint``), and shard placement, heartbeats and the
checkpointed training loop (``fault``)."""
