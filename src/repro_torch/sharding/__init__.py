"""``repro_torch.sharding`` — the logical-axis rules (``sharding/rules.py``)
that lay the LM scaffold's params, optimizer state, caches and activations
out as DTensors over a ``torch.distributed`` device mesh."""
from repro_torch.sharding.rules import (NamedSharding, PartitionSpec, Rules,
                                        spec_placements, tree_shardings)

__all__ = ["NamedSharding", "PartitionSpec", "Rules", "spec_placements",
           "tree_shardings"]
