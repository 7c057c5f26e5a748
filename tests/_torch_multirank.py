"""Programs of the multi-rank shard_map tests (``test_torch_shard_map.py``),
each run in a process of its own:

    python tests/_torch_multirank.py rank RANK WORLD STORE OUT
        one rank of the port: joins a gloo group of WORLD ranks on the
        FileStore STORE, resolves every case with ``runner="shard_map"``
        and writes its results to OUT (.npz)
    python tests/_torch_multirank.py reference WORLD OUT
        the reference: WORLD forced XLA host devices, every case with its
        ``shard_map`` runner over them, results to OUT

Both build the same corpus from one numpy seed.  A rank imports neither
``jax`` nor ``repro``.
"""
from __future__ import annotations

import os
import sys
from datetime import timedelta

import numpy as np

N, W, NK, SEED = 400, 6, 128, 5
N_LHS, N_RHS, W_LINK = 300, 120, 5
CASES = {f"{v}-{e}": dict(variant=v, band_engine=e)
         for v in ("srp", "repsn", "jobsn") for e in ("scan", "pallas")}
CASES["link-repsn"] = dict(variant="repsn", window=W_LINK, link=True)
FIELDS = ("load", "overflow", "cand_count", "cand_overflow",
          "matcher_evals", "pair_overflow", "pruned")


def config_kw(case: dict, world: int, runner: str) -> dict:
    """The ERConfig kwargs of a case (``link`` is not one of them)."""
    kw = dict(window=W, num_shards=world, hops=world - 1, runner=runner)
    kw.update({k: v for k, v in case.items() if k != "link"})
    return kw


def corpus(synth, make):
    """(entities, lhs, rhs) from ``SEED`` with either package's
    ``synth_entities`` and ``make_entities``."""
    ents = synth(np.random.default_rng(SEED), N, n_keys=NK, dup_frac=0.3)
    rng = np.random.default_rng(9)
    lhs = synth(rng, N_LHS, n_keys=96, dup_frac=0.0)
    take = rng.permutation(N_LHS)[:N_RHS]
    host = lambda x: x.cpu().numpy() if hasattr(x, "cpu") else \
        np.asarray(x)
    rhs = make(host(lhs["key"])[take], np.arange(N_RHS, dtype=np.int32),
               payload={k: host(v)[take] for k, v in lhs["payload"].items()})
    return ents, lhs, rhs


def record(out: dict, name: str, res) -> None:
    """A result's pair sets (sorted (k, 2) int64) and counters."""
    for f, pairs in (("blocked", res.blocking.pairs),
                     ("matched", res.matches)):
        out[f"{name}:{f}"] = np.array(sorted(pairs), np.int64).reshape(-1, 2)
    for f in FIELDS:
        out[f"{name}:{f}"] = np.asarray(getattr(res.blocking, f), np.int64)


def run_cases(api, ents, lhs, rhs, world: int, **call_kw) -> dict:
    out = {}
    for name, case in CASES.items():
        cfg = api.ERConfig(**config_kw(case, world, "shard_map"))
        res = api.link(lhs, rhs, cfg, **call_kw) if case.get("link") \
            else api.resolve(ents, cfg, **call_kw)
        record(out, name, res)
    return out


def rank_main(rank: int, world: int, store: str, path: str) -> None:
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.core import entities as E
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        ents, lhs, rhs = corpus(
            lambda *a, **k: E.synth_entities(*a, device="cpu", **k),
            lambda *a, **k: E.make_entities(*a, device="cpu", **k))
        np.savez(path, **run_cases(api, ents, lhs, rhs, world,
                                   device="cpu"))
    finally:
        dist.destroy_process_group()


def reference_main(world: int, path: str) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count="
                               f"{world}")
    import jax

    from repro import api
    from repro.core import entities as E
    mesh = jax.make_mesh((world,), ("data",))
    ents, lhs, rhs = corpus(E.synth_entities, E.make_entities)
    np.savez(path, **run_cases(api, ents, lhs, rhs, world, mesh=mesh))


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
    else:
        reference_main(int(sys.argv[2]), sys.argv[3])
