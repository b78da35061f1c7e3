"""Context parallelism over point shards (port of `dgcnn_tpu/parallel/`):
one process per shard in a `torch.distributed` group (`mesh`, `launch`),
the ring and gather collectives (`collectives`) and the graph ops a
point-sharded model runs (`context_parallel`)."""
