"""The sharded index, on one device or one rank per card — ``repro.distributed``."""
from repro_torch.distributed.ann import (
    DistParams,
    ShardedSession,
    ShardMesh,
    distributed_delete,
    distributed_insert,
    distributed_query,
    gather_state,
    init_sharded_state,
    make_consolidate_step,
    make_delete_step,
    make_insert_step,
    make_query_step,
    shard_block,
    topk_union,
)
from repro_torch.distributed.compression import (
    compressed_psum,
    dequantize,
    quantize_int8,
    wire_bytes_saved,
)
from repro_torch.distributed.elastic import gather_alive, reshard

__all__ = [
    "DistParams",
    "ShardMesh",
    "ShardedSession",
    "compressed_psum",
    "dequantize",
    "distributed_delete",
    "distributed_insert",
    "distributed_query",
    "gather_alive",
    "gather_state",
    "init_sharded_state",
    "make_consolidate_step",
    "make_delete_step",
    "make_insert_step",
    "make_query_step",
    "quantize_int8",
    "reshard",
    "shard_block",
    "topk_union",
    "wire_bytes_saved",
]
