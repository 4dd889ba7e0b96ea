"""Multi-device scoring with ``torch.distributed``: ``sharding`` (the mesh,
its collectives and the sharded scoring steps) and ``launch`` (``run_ranks``,
which starts the ranks on one host)."""

from .launch import run_ranks
from .sharding import (Mesh, image_pair_sharding, make_mesh, predict_video_source,
                       shard_loss_fn, shard_scoring_fn, video_block_sharding)

__all__ = ["Mesh", "image_pair_sharding", "make_mesh", "predict_video_source", "run_ranks",
           "shard_loss_fn", "shard_scoring_fn", "video_block_sharding"]
