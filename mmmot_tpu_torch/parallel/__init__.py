from mmmot_tpu_torch.parallel.mesh import (ParallelConfig, gather_sequences,
                                           init_distributed, make_mesh,
                                           replicate, shard_batch,
                                           shard_sequences)
