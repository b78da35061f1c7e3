from dgcnn_tpu_torch.utils.timing import Timer, device_memory_stats, trace

__all__ = ["Timer", "device_memory_stats", "trace"]
