"""Records resolved per second: whole resolves completed in
the window times the corpus's records, over the window's seconds."""


def read(reading):
    out = reading.outcome
    return out.records / reading.window.seconds if out.records else None
