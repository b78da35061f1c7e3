from dgcnn_tpu_torch.io import native
from dgcnn_tpu_torch.io.batching import Batch, BucketBatcher, pad_events, prefetch
from dgcnn_tpu_torch.io.readers import CSVIO, Event, H5IO, IOBase, NPZIO, io_factory
from dgcnn_tpu_torch.io.synthetic import SyntheticIO, make_event, write_canonical
from dgcnn_tpu_torch.io.writeback import SegmentWriter

__all__ = [
    "native",
    "Batch",
    "BucketBatcher",
    "pad_events",
    "prefetch",
    "CSVIO",
    "Event",
    "H5IO",
    "IOBase",
    "NPZIO",
    "io_factory",
    "SyntheticIO",
    "make_event",
    "write_canonical",
    "SegmentWriter",
]
