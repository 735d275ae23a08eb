"""Frame data-parallelism over a list of devices, with the fusion
gather and the batch reduction (port of repas_tpu/parallel)."""
from repas_tpu_torch.parallel.mesh import (frames_mesh, shard_batch,
                                           sharded_frame_pipeline,
                                           fuse_views_allgather,
                                           batch_stats_psum)

__all__ = ["frames_mesh", "shard_batch", "sharded_frame_pipeline",
           "fuse_views_allgather", "batch_stats_psum"]
