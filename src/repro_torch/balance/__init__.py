"""Skew-aware planning (port of ``repro.balance``): key profile ->
ShardPlan -> capacities, with the planner registry."""
from repro_torch.balance.capacity import CapSuggestion, suggest_caps
from repro_torch.balance.planners import (LEGACY_PARTITIONERS, Partitioner,
                                          ShardPlan, as_plan,
                                          available_partitioners,
                                          get_partitioner, imbalance_ratio,
                                          plan_from_profile, plan_shards,
                                          realized_comparisons,
                                          register_partitioner,
                                          validate_plan)
from repro_torch.balance.profile import KeyProfile, profile_keys

__all__ = [
    "KeyProfile", "profile_keys", "ShardPlan", "as_plan", "plan_shards",
    "plan_from_profile", "validate_plan", "Partitioner",
    "register_partitioner", "get_partitioner", "available_partitioners",
    "imbalance_ratio", "realized_comparisons", "LEGACY_PARTITIONERS",
    "CapSuggestion", "suggest_caps",
]
