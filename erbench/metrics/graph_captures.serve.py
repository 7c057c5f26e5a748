"""Delta programs first run and captured inside the window (the change of
``ServeStats.traces``); 0 in a steady window."""


def read(reading):
    return reading.outcome.extra.get("traces")
