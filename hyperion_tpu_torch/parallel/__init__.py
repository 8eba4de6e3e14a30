"""Parallel layouts of the port — `hyperion_tpu/parallel/`: the
per-parameter placements (`partition.partition_specs`, the JAX rules
over the JAX layout of each torch parameter) and their appliers (DDP,
FSDP2, tensor parallelism)."""
