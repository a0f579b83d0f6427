"""Data parallelism over ``torch.distributed`` (:mod:`.mesh`): training
and serving."""

from renderloom_torch.parallel.mesh import (all_reduce_mean, count_share,
                                            gather_batch, init,
                                            init_from_env,
                                            local_batch, mean_metrics,
                                            process_shard,
                                            rank_zero_first, replicate,
                                            run_ranks, shard_batch, shutdown,
                                            times_world, torchrun, world)

__all__ = ["all_reduce_mean", "count_share", "gather_batch", "init",
           "init_from_env",
           "local_batch", "mean_metrics", "process_shard",
           "rank_zero_first", "replicate",
           "run_ranks", "shard_batch", "shutdown", "times_world", "torchrun",
           "world"]
