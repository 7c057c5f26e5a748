"""Index compactions per service batch in the window (the change of
``ServeStats.compactions`` over the change of ``ServeStats.batches``)."""


def read(reading):
    x = reading.outcome.extra
    return x["compactions"] / x["batches"] if x.get("batches") else None
