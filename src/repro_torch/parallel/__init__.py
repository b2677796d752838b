"""``repro_torch.parallel`` — logical-axis sharding rules and each rank's
blocks (port of ``repro.parallel``)."""
from repro_torch.parallel.sharding import (DataParallel, Parallel, Rules, gather_fsdp,
                                           gather_tree, global_norm, make_rules,
                                           named_sharding, reduce_data_parallel, shard_tree,
                                           spec_for, tree_specs)

__all__ = ['DataParallel', 'Parallel', 'Rules', 'gather_fsdp', 'gather_tree', 'global_norm',
           'make_rules', 'named_sharding', 'reduce_data_parallel', 'shard_tree', 'spec_for',
           'tree_specs']
