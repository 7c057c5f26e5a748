"""Helpers the readers share: span seconds per request of the window."""
from __future__ import annotations


def per_request(reading, name: str, own: bool = False):
    """Seconds of the spans called ``name`` (their self time with
    ``own``) in the window, per request completed; None without them."""
    found = [s for s in reading.window.spans if s.name == name]
    calls = len(reading.outcome.calls)
    if not found or not calls:
        return None
    return sum(s.self_s if own else s.t1 - s.t0 for s in found) / calls


def idle_percent(reading):
    """Share of the window in which no operation ran on the device, %."""
    w = reading.window
    if not w.device_ops or w.seconds <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.seconds)
