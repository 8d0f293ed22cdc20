"""Parallel layer: device mesh, shardings, sharded executor, EP lookups,
the elastic split ladder and the multi-process runner."""

from .embedding_sharding import (
    MODEL_PARTITION_RULES,
    match_partition_rules,
    partition_rules_for,
    sharded_field_embed,
    tree_path_str,
)
from .elastic import ElasticController, ElasticMeshExecutor
from .executor import ShardedExecutor, shard_map_score
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    candidate_sharding,
    make_mesh,
    replicated,
    vocab_sharding,
)
from .multihost import MultiHostRunner, global_mesh, init_distributed
from .sharding import batch_shardings, param_shardings, place_params

__all__ = [
    "MultiHostRunner",
    "global_mesh",
    "init_distributed",
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "candidate_sharding",
    "replicated",
    "vocab_sharding",
    "param_shardings",
    "batch_shardings",
    "place_params",
    "ShardedExecutor",
    "ElasticMeshExecutor",
    "ElasticController",
    "shard_map_score",
    "sharded_field_embed",
    "MODEL_PARTITION_RULES",
    "match_partition_rules",
    "partition_rules_for",
    "tree_path_str",
]
