"""Peak device memory reserved in the window, GB (peak statistics reset
at the window's start): graph pools and the edit-DP buffer set it."""


def read(reading):
    peak = reading.window.peak_window_bytes
    return peak / 1e9 if peak else None
