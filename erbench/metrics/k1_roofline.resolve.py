"""K1's share of its roofline: the least time the card could take for the
work the corpus needs (``erbench/roofline.py``), over K1's mean device
time per launch in the window, in % of the H100 SXM data sheet's peaks
(the card's power limit is written beside the reading in PERF.md)."""
from erbench import roofline

KERNEL = "fused_band"


def read(reading):
    times = [b - a for name, a, b in reading.window.device_ops
             if KERNEL in name]
    n = reading.outcome.extra.get("n_records")
    if not times or not n:
        return None
    er, corpus = reading.config["er"], reading.config["corpus"]
    work = roofline.k1_work(n, er["num_shards"], er["window"],
                            corpus["feat_dim"], corpus["sig_words"])
    least = roofline.bound_s(work["bytes"], work["ops"])
    return 100.0 * least / (sum(times) / len(times))
