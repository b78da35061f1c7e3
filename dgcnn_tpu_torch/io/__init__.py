from dgcnn_tpu_torch.io.batching import Batch, BucketBatcher, pad_events, prefetch
from dgcnn_tpu_torch.io.readers import Event, IOBase
from dgcnn_tpu_torch.io.synthetic import SyntheticIO, make_event

__all__ = [
    "Batch",
    "BucketBatcher",
    "pad_events",
    "prefetch",
    "Event",
    "IOBase",
    "SyntheticIO",
    "make_event",
]
