"""Fault tolerance (port of ``repro.resilience``): so far the overflow
ladder; checkpointed streaming and fault injection are ROADMAP M8."""
from repro_torch.resilience.retry import (CapacityOverflowError,
                                          ResilienceStats, autosize_caps,
                                          run_with_recovery)

__all__ = ["CapacityOverflowError", "ResilienceStats", "autosize_caps",
           "run_with_recovery"]
