"""Blocks the k-way merge yields a stream (the program's ``merge_blocks``
counter over the window, per stream): one per sorted run holding a key,
so the merge's work grows with keys x runs, not with the corpus."""


def read(reading):
    blocks = reading.outcome.extra.get("merge_blocks")
    calls = len(reading.outcome.calls)
    return blocks / calls if blocks is not None and calls else None
