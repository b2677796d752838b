"""``repro_torch.parallel`` — logical-axis sharding rules and each rank's
blocks (port of ``repro.parallel``)."""
from repro_torch.parallel.sharding import (Parallel, Rules, gather_tree, make_rules,
                                           named_sharding, shard_tree, spec_for, tree_specs)

__all__ = ['Parallel', 'Rules', 'gather_tree', 'make_rules', 'named_sharding', 'shard_tree',
           'spec_for', 'tree_specs']
