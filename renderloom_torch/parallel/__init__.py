"""Data parallelism over ``torch.distributed`` (:mod:`.mesh`): training
and serving; tensor-parallel layer splitting."""

from renderloom_torch.parallel.mesh import (all_reduce_mean, count_share,
                                            gather_batch, init,
                                            init_from_env,
                                            local_batch, mean_metrics,
                                            process_shard,
                                            rank_zero_first, replicate,
                                            run_ranks, shard_batch,
                                            shard_params_tp, shutdown,
                                            times_world, torchrun, tp_split,
                                            world)

__all__ = ["all_reduce_mean", "count_share", "gather_batch", "init",
           "init_from_env",
           "local_batch", "mean_metrics", "process_shard",
           "rank_zero_first", "replicate",
           "run_ranks", "shard_batch", "shard_params_tp", "shutdown",
           "times_world", "torchrun", "tp_split", "world"]
