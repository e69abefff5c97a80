"""Durability: the write-ahead op log, graph snapshots and the durable
writer."""
