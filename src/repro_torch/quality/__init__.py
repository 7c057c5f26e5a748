"""repro_torch.quality — ground-truth match-quality measurement (port of
``repro.quality``; host numpy, as in the reference).

  * ``QualityMetrics`` / ``evaluate`` — pairs-completeness, pairs-quality,
    reduction ratio and F-measure of any resolve result against a gold
    pair set (packed-uint64 set algebra, no Python pair loops);
  * ``attach`` — surface those metrics on ``ERMetrics.quality``;
  * ``weff_for_keys`` — the adaptive-window map: per-entity effective
    windows from a ``KeyProfile``'s block densities (the device band and
    the host oracle both consume it).

The labeled corpus generator lives in ``repro_torch.data.truth``.
"""
from repro_torch.quality.adaptive import weff_for_keys
from repro_torch.quality.metrics import QualityMetrics, attach, evaluate

__all__ = ["QualityMetrics", "attach", "evaluate", "weff_for_keys"]
