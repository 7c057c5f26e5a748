"""K1's share of its roofline in a stream: the least time the card could
take for the rows one chunk needs, (chunk + w - 1) plus the shards' halos
r(w - 1) (``erbench/roofline.py``), over K1's mean device time per launch
in the window, in % of the H100 SXM data sheet's peaks."""
from erbench import roofline

KERNEL = "fused_band"


def read(reading):
    times = [b - a for name, a, b in reading.window.device_ops
             if KERNEL in name]
    chunk = reading.outcome.extra.get("chunk_rows")
    if not times or not chunk:
        return None
    er, corpus = reading.config["er"], reading.config["corpus"]
    work = roofline.k1_work(chunk + er["window"] - 1, er["num_shards"],
                            er["window"], corpus["feat_dim"],
                            corpus["sig_words"])
    least = roofline.bound_s(work["bytes"], work["ops"])
    return 100.0 * least / (sum(times) / len(times))
