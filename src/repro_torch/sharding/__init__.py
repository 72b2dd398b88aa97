"""Logical-axis sharding over a ``DeviceMesh`` (port of ``repro/sharding``)."""
from repro_torch.sharding.rules import (  # noqa: F401
    ShardingCtx,
    current_ctx,
    make_rules,
    partition_spec,
    shard,
    sharding_for_spec,
    tree_shardings,
    use_sharding,
)
