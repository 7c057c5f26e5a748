"""Peak device memory reserved in the window, GB (peak statistics reset
at the window's start): one chunk's shard program, its graph pool and the
edit-DP buffer, not the corpus."""


def read(reading):
    peak = reading.window.peak_window_bytes
    return peak / 1e9 if peak else None
