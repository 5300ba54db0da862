"""Stream sharding over several devices (zaru_tpu/parallel): a tracker's
streams split over a 1-D mesh of devices, each shard stepped on its own
device with no collectives; data-parallel training lives in
:func:`zaru_tpu_torch.train.make_data_parallel_train_step`."""

from .mesh import Replicated, ShardedFaceTracker, Sharded, ShardedTracker, StreamSharding, stream_mesh

__all__ = ["Replicated", "ShardedFaceTracker", "Sharded", "ShardedTracker", "StreamSharding", "stream_mesh"]
