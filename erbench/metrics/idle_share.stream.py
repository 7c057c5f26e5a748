"""Share of the window in which no operation ran on the device, %."""
from erbench.metrics.spans import idle_percent


def read(reading):
    return idle_percent(reading)
