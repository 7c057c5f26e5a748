"""Traffic kind ``stream``: one client deduplicating the configuration's
corpus out of core with ``repro_torch.stream.resolve_stream``, back to
back, as a batch job whose corpus is larger than its device does.

Set-up makes the corpus from the seed and cuts it, in eid order (the
order a file is read in), into host chunks of the configuration's
``stream.chunk_rows`` (the same share of a corpus cut to ``n`` rows in a
test).  Each request is ``res = stream.resolve_stream(iter(chunks), cfg,
chunk_size=chunk_rows, spool_dir=d)``, ``d`` a fresh directory under
``$TMPDIR`` (``stream.spool`` is "disk"), removed before the request
ends.  The warm-up is one cold stream; the window, the loop and the
comparison of the pair sets are the resolve driver's (``closed_loop``).

The check adds two of the configuration's out-of-core guarantees, each
the largest over the window's streams:

  * ``device_share``: ``StreamStats.chunk_device_bytes`` over
    ``corpus_bytes``, held to one (chunk + w - 1)-row window with its row
    index, over the corpus (``guarantee_limits``; at a test's ``n`` the
    same fraction for its rows);
  * ``unspooled_bytes``: ``max(0, 2 * corpus_bytes - spooled_bytes)``,
    0 when every raw chunk and every sorted run went to disk.

Under ``--trace 1`` the run's ``extra`` holds ``merge_blocks``, the
program's counter of the k-way merge's blocks in the window, where the
program keeps one.
"""
from __future__ import annotations

import math
import shutil
import tempfile

from erbench.data import corpus
from erbench.drivers.resolve import closed_loop


def chunk_rows(ctx, n: int) -> int:
    """Native rows a chunk: the configuration's, or its share of ``n``."""
    spec = ctx.config["stream"]["chunk_rows"]
    full = ctx.config["corpus"]["n"]
    return spec if n == full else math.ceil(n * spec / full)


def device_share_limit(ctx, n: int, chunk: int, row_bytes: float) -> float:
    """The ``device_share`` limit: the configuration's at its own size,
    else (chunk + w - 1) rows of ``row_bytes`` and a 4-byte index over
    ``n`` rows."""
    if n == ctx.config["corpus"]["n"]:
        return ctx.config["guarantee_limits"]["device_share"]
    rows = chunk + ctx.config["er"]["window"] - 1
    return rows * (row_bytes + 4) / (n * row_bytes)


def drive(ctx):
    from repro_torch import obs, stream
    from erbench.harness import er_config

    host = corpus.make(ctx.config, ctx.seed, n=ctx.n)
    n = int(host["key"].shape[0])
    chunk = chunk_rows(ctx, n)
    chunks = [corpus.rows(host, slice(s, s + chunk))
              for s in range(0, n, chunk)]
    row_bytes = (host["key"].nbytes + host["eid"].nbytes
                 + host["valid"].nbytes
                 + sum(v.nbytes for v in host["payload"].values())) / n
    cfg = er_config(ctx.config)
    if ctx.config["stream"]["spool"] != "disk":
        raise ValueError("the stream driver spools to disk only")
    stats, tracers = [], set()

    def call():
        tracer = obs.current_tracer()
        if tracer is not None:
            tracers.add(tracer)
        d = tempfile.mkdtemp(prefix="erbench-spool-")
        try:
            res = stream.resolve_stream(iter(chunks), cfg, chunk_size=chunk,
                                        spool_dir=d, device=ctx.device)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        stats.append(res.stream)
        return res

    out = closed_loop(ctx, host, call)
    window_stats = stats[1:]        # the first stream is the warm-up
    out.extra["chunk_rows"] = chunk
    for t in tracers:
        blocks = t.metrics.to_dict().get("merge_blocks")
        if blocks is not None:
            out.extra["merge_blocks"] = blocks["value"]
    compare = out.check

    def check():
        checks = compare()
        share = max(s.chunk_device_bytes / s.corpus_bytes
                    for s in window_stats)
        unspooled = max(max(0, 2 * s.corpus_bytes - s.spooled_bytes)
                        for s in window_stats)
        limits = ctx.config["guarantee_limits"]
        checks["device_share"] = (share, device_share_limit(
            ctx, n, chunk, row_bytes))
        checks["unspooled_bytes"] = (unspooled, limits["unspooled_bytes"])
        return checks

    out.check = check
    return out
