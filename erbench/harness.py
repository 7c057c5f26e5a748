"""One run of one cell: set-up, warm-up, the measured window, the check.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``erbench/configs/<config>.json``,
its traffic mix in ``erbench/traffic/<traffic>.json`` (whose ``kind``
names the driver in ``erbench/drivers/``), the limits of its check in
``erbench/limits/<cell>.json``, and each metric's reader in
``erbench/metrics/<metric>.py``.  A new cell or metric adds files and
entries; nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "erbench"

# modules that may not be loaded in the process that prints a result,
# compared with each loaded module's whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str, bench: dict | None = None) -> dict:
    for w in (bench or spec())["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return load_json(HERE / "limits" / f"{cell}.json")


def reader(metric: str):
    """The ``read(reading)`` function of ``erbench/metrics/<metric>.py``:
    the metric's value, or None where the run holds nothing to read."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_name = "erbench_metric_" + metric.replace(".", "_").replace("-", "_")
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.read


def metrics_of(cell: str, group: str, bench: dict) -> list:
    """The metrics of ``group`` ("end_to_end" or "per_layer") that ``cell``
    reports: those with no ``workloads`` key and those that list it."""
    return [m for m in bench[group]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def er_config(cfg: dict, **extra):
    """The program's ``ERConfig`` for a configuration's ``er`` block and
    its matcher spec."""
    from repro_torch.api import ERConfig
    from repro_torch.core.match import CascadeMatcher, Matcher
    m = cfg["matcher"]
    matcher = CascadeMatcher(
        matchers=tuple(Matcher(field=x["field"], kind=x["kind"],
                               weight=float(x["weight"]),
                               cost=float(x["cost"]))
                       for x in m["matchers"]),
        threshold=float(m["threshold"]))
    return ERConfig(matcher=matcher, **cfg["er"], **extra)


@dataclass
class Context:
    """What a driver is handed: the cell, its files, the run's seed and
    length, the device, the window, and ``n`` (a record count overriding
    the configuration's, for tests on the CPU)."""
    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    device: str
    window: object
    n: int | None = None


@dataclass
class Outcome:
    """What a driver returns: the work done in the window (``records``
    resolved or ``edits`` served), requests ``attempted`` and ``failed``,
    one record per request (``calls``), counters read around the window
    (``extra``), and ``check()``, which compares the window's answers with
    the reference and returns {name: (value, limit)}."""
    attempted: int
    failed: int
    calls: list
    check: object
    records: int = 0
    edits: int = 0
    extra: dict = field(default_factory=dict)


@dataclass
class Reading:
    """What a metric's reader reads: the run's ``Outcome``, its
    ``window.Window`` (spans and device operations when traced), and the
    set-up seconds."""
    cell: str
    config: dict
    traffic: dict
    window: object
    outcome: Outcome
    setup_s: float


def device_info(device: str) -> dict:
    import torch
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": None}


def run(cell: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", n: int | None = None,
        started: float | None = None) -> dict:
    """One run of ``cell``; returns the result line as a dict (``checks``
    last).  ``started``: the host clock at the process's start, so that
    ``setup_s`` covers the imports too."""
    from erbench.window import Window
    started = time.perf_counter() if started is None else started
    bench = spec()
    w = workload(cell, bench)
    cfg, mix = config(w["config"]), traffic(w["traffic"])
    win = Window(trace=trace, device=device)
    ctx = Context(cell=cell, config=cfg, traffic=mix, limits=limits(cell),
                  seed=seed, seconds=seconds, device=device, window=win,
                  n=n)
    driver = importlib.import_module(f"erbench.drivers.{mix['kind']}")
    out = driver.drive(ctx)
    setup_s = win.t0 - started
    dev = device_info(device)
    if device == "cuda":
        dev["memory_peak_bytes"] = max(win.peak_setup_bytes,
                                       win.peak_window_bytes)
    result = {"correct": False, "attempted": out.attempted,
              "failed": out.failed, "metrics": {}, "device": dev}
    reading = Reading(cell=cell, config=cfg, traffic=mix, window=win,
                      outcome=out, setup_s=setup_s)
    group = "per_layer" if trace else "end_to_end"
    for m in metrics_of(cell, group, bench):
        v = reader(m["name"])(reading)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    if trace:
        dev["busy_s"] = win.busy_s()
        dev["window_s"] = win.seconds
        result["breakdown"] = win.breakdown()
    t_check = time.perf_counter()
    checks = out.check()
    print(f"erbench: set-up {setup_s:.3f} s, window {win.seconds:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s; requests (s): "
          + " ".join(f"{c['t1'] - c['t0']:.3f}" for c in out.calls[:64]),
          file=sys.stderr)
    result["correct"] = bool(out.attempted > 0 and out.failed == 0 and all(
        v <= lim for v, lim in checks.values()))
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
