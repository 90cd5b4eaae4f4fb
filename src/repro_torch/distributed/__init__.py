"""Cross-shard building blocks: the top-k merge of a sharded search."""
