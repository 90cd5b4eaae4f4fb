"""Cross-shard building blocks: the top-k merge of a sharded search and
the int8 compressed all-reduce (``collectives``), the logical-axis rules,
the one-process mesh and its placement (``sharding``), and the GPipe
pipeline (``pipeline``)."""
