from diner_tpu_torch.parallel.mesh import (all_reduce_grads_,
                                           all_reduce_sum_, barrier,
                                           broadcast_module_, is_main,
                                           process_local_slice, rank,
                                           world_size)
from diner_tpu_torch.parallel.multihost import init_multihost

__all__ = ["all_reduce_grads_", "all_reduce_sum_", "barrier",
           "broadcast_module_", "init_multihost", "is_main",
           "process_local_slice", "rank", "world_size"]
