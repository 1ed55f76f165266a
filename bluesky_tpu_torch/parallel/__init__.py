"""Device-mesh parallelism: the shard modes of the sparse backend on a
single-process mesh (``sharding``)."""
