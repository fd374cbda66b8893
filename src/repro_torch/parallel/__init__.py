from .sharding import (NamedSharding, PartitionSpec, Rules, active_mesh,
                       dp_axes, maybe_shard, set_mesh)
from .compression import (ef_allreduce, ef_allreduce_tree, init_errors,
                          quantize_int8, dequantize_int8,
                          make_compressed_value_and_grad, init_pod_errors)

__all__ = ["Rules", "dp_axes", "maybe_shard",
           "ef_allreduce", "ef_allreduce_tree", "init_errors",
           "quantize_int8", "dequantize_int8",
           "make_compressed_value_and_grad", "init_pod_errors",
           "PartitionSpec", "NamedSharding", "set_mesh", "active_mesh"]
