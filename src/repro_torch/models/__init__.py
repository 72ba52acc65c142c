"""Model layers, the single-shard MoE and the paged decoder steps."""
