"""Device-mesh parallelism: the shard modes of the sparse backend, mesh
epochs and the ensemble mesh (``sharding``), and the joins of a job of
several processes on ``torch.distributed`` (``dist``)."""
