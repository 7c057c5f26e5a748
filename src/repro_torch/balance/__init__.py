"""Skew-aware planning (port of the legacy path of ``repro.balance``):
key profile -> ShardPlan -> capacities."""
from repro_torch.balance.capacity import CapSuggestion, suggest_caps
from repro_torch.balance.planners import (LEGACY_PARTITIONERS, ShardPlan,
                                          as_plan, imbalance_ratio,
                                          plan_from_profile,
                                          plan_shards, realized_comparisons,
                                          validate_plan)
from repro_torch.balance.profile import KeyProfile, profile_keys

__all__ = [
    "KeyProfile", "profile_keys", "ShardPlan", "as_plan", "plan_shards",
    "plan_from_profile", "validate_plan",
    "imbalance_ratio", "realized_comparisons", "LEGACY_PARTITIONERS",
    "CapSuggestion", "suggest_caps",
]
