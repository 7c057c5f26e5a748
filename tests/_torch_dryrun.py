"""Programs of the dry-run tests (``test_torch_dryrun.py``,
``test_torch_trace_analysis.py``), each run in a process of its own:

    python tests/_torch_dryrun.py port OUT
        the port's fake traces: the smoke cells (CELLS) on a (2, 2) mesh
        of a 4-rank fake group and one smoke cell on each production mesh
        of the 512-rank fake world (``launch.dryrun``), after
        ``make_production_mesh`` is called with no group at all; then
        the smoke steps of PLAIN on a world-size-1 gloo (1, 1) mesh (plain
        tensors), each traced under a fake mode and run for real, both
        recorded (the CPU's form of ``chip_smoke.py``'s phase dryrun)
    python tests/_torch_dryrun.py port-ops OUT
        the single-op programs on rank 0 of a 4-rank fake group
    python tests/_torch_dryrun.py rank RANK WORLD STORE OUT
        one of 4 gloo ranks on a FileStore: the smoke train cell GLOO run
        for real on the (2, 2) mesh, recorded on rank 0 by the dry run's
        recorder
    python tests/_torch_dryrun.py reference OUT
        the reference on 4 forced XLA host devices: the smoke cells
        through ``repro.launch.dryrun.build_cell`` and the compile and
        ``hlo_analysis.analyze`` lines of its ``run_cell`` on an
        ``Auto``-axis (2, 2) ``jax.sharding.Mesh``
    python tests/_torch_dryrun.py reference-ops OUT
        the single-op programs on 4 forced XLA host devices
        (``shard_map`` for the collectives)

Results are JSON.  The port's processes import neither ``jax`` nor
``repro``.
"""
from __future__ import annotations

import json
import sys
import traceback
from datetime import timedelta

MESH, AXES = (2, 2), ("data", "model")
# the smoke cells: (arch, kind, seq, batch, run overrides); micro-batches
# cut to 2 (the defaults' 4 and 16 need more rows than a smoke batch)
CELLS = (("phi4-mini-3.8b", "train", 64, 8, {"microbatch": 2}),
         ("phi4-mini-3.8b", "prefill", 64, 4, None),
         ("qwen3-moe-235b-a22b", "train", 64, 8, {"microbatch": 2}))
GLOO = 0                 # the cell of CELLS run for real on gloo ranks
# (arch, kind, seq, batch): dry-run and run for real on a (1, 1) mesh
PLAIN = (("gemma2-9b", "prefill", 64, 2), ("qwen3-moe-235b-a22b", "train",
                                           64, 2))
# smoke cells on the production meshes: (mesh, arch, kind, seq, batch, run
# overrides); the multi-pod decode looks its tokens up with the batch split
# over two mesh dims ("pod", "data"), and the multi-pod MoE train step has
# micro-batches of 16 rows over those 32 ranks (as qwen3-moe's train_4k)
PRODUCTION = (("single", "phi4-mini-3.8b", "prefill", 64, 32, None),
              ("multi", "phi4-mini-3.8b", "prefill", 64, 32, None),
              ("multi", "qwen3-moe-235b-a22b", "decode", 64, 64, None),
              ("multi", "qwen3-moe-235b-a22b", "train", 16, 32,
               {"microbatch": 2}))
# the single-op programs: f32 operands of these shapes; a collective's
# operand is each rank's (8, 16) shard of a (32, 16) array
MM = ((8, 16), (16, 3))
BMM = ((5, 8, 16), (5, 16, 3))
COLL = (8, 16)
COLLECTIVES = ("psum", "all_gather", "psum_scatter", "all_to_all",
               "ppermute")


def _shape(kind, seq, batch):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(f"smoke_{kind}", seq, batch, kind)


def _port_cell(arch, kind, seq, batch, ov, mesh, mesh_kind="test"):
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch import dryrun as D
    rec = D.run_cell(smoke_variant(get_config(arch)), _shape(kind, seq, batch),
                     mesh_kind, mesh=mesh, device="cpu", save=False,
                     run_overrides=ov)
    return rec


def port_ops_main(path: str) -> None:
    """The single-op programs on rank 0 of a 4-rank fake group."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.perf import trace_analysis as T
    out = {}

    def run(name, fn):
        rec = T.OpRecorder()
        with FakeTensorMode(), rec:
            fn()
        out[name] = T.analyze(rec)

    run("mm", lambda: torch.empty(MM[0]) @ torch.empty(MM[1]))
    run("bmm", lambda: torch.empty(BMM[0]) @ torch.empty(BMM[1]))

    def ppermute():
        x, y = torch.empty(COLL), torch.empty(COLL)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1),
                                         dist.P2POp(dist.irecv, y, 3)]):
            w.wait()

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        n = dist.get_world_size()
        run("psum", lambda: dist.all_reduce(torch.empty(COLL)))
        run("all_gather", lambda: dist.all_gather_into_tensor(
            torch.empty((COLL[0] * n, COLL[1])), torch.empty(COLL)))
        run("psum_scatter", lambda: dist.reduce_scatter_tensor(
            torch.empty((COLL[0] // n, COLL[1])), torch.empty(COLL)))
        run("all_to_all", lambda: dist.all_to_all_single(
            torch.empty(COLL), torch.empty(COLL)))
        run("ppermute", ppermute)
    finally:
        dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(out, f)


def port_main(path: str) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import dryrun as D
    from repro_torch.launch import make_mesh_compat, make_production_mesh
    out = {"no_group": {}}
    for multi in (False, True):
        try:
            make_production_mesh(multi_pod=multi, device="cpu")
            out["no_group"][str(multi)] = None
        except Exception as e:  # noqa: BLE001 — the error is the result
            out["no_group"][str(multi)] = f"{type(e).__name__}: {e}"
    out["initialized_after"] = dist.is_initialized()

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_mesh_compat(MESH, AXES, device="cpu")
        out["cells"] = [_port_cell(*c, mesh) for c in CELLS]
    finally:
        dist.destroy_process_group()
    out["production"] = [_port_cell(arch, kind, seq, batch, ov,
                                    D.production_mesh(mk, "cpu"), mk)
                         for mk, arch, kind, seq, batch, ov in PRODUCTION]
    dist.destroy_process_group()
    out["plain"] = [_plain(*c) for c in PLAIN]
    dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(out, f)


def _plain(arch, kind, seq, batch):
    """A smoke step on a world-size-1 gloo (1, 1) mesh, traced under a fake
    mode and run for real (seeded weights), both recorded."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.perf import trace_analysis as T
    from repro_torch.sharding import Rules
    from repro_torch.train import steps as S
    rules = Rules(make_host_mesh(device="cpu"), fsdp=True)
    cfg = smoke_variant(get_config(arch))
    run = RunConfig(model=cfg, shape=_shape(kind, seq, batch),
                    remat="block")
    cpu = torch.device("cpu")
    toks = torch.randint(0, cfg.vocab_size, (batch, seq),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    if kind == "train":
        step = S.make_train_step(cfg, run, rules)
        trees = ((D.shapes_of(S.train_state_init, 0, cfg, torch.bfloat16,
                              device=cpu), S.train_state_specs(cfg)),
                 (S.train_batch_shapes(cfg, run),
                  S.train_batch_spec(cfg, run)))
        real = (S.train_state_init(0, cfg, torch.bfloat16, device="cpu"),
                {"tokens": toks, "labels": toks.clone()})
    else:
        step = S.make_prefill_step(cfg, run, rules)
        trees = ((D.shapes_of(lm.lm_init, 0, cfg, torch.bfloat16,
                              device=cpu), lm.lm_specs(cfg)),
                 (S.serve_batch_shapes(cfg, run, decode=False),
                  S.serve_batch_spec(cfg, decode=False)),
                 (S.cache_shapes(cfg, run), lm.cache_specs(cfg)))
        real = (lm.lm_init(0, cfg, torch.bfloat16, device="cpu"),
                {"tokens": toks},
                lm.cache_init(cfg, batch, seq, torch.bfloat16, device="cpu"))
    mode = FakeTensorMode()
    fake = tuple(D.fake_shards(mode, sh, S.resolve_shardings(rules, spec, sh),
                               cpu) for sh, spec in trees)
    recs = {"fake": D.trace(step, fake, mode), "real": D.trace(step, real)}
    return {k: {"ops": dict(r.ops), "analysis": T.analyze(r),
                "memory_analysis": T.memory_analysis(r)}
            for k, r in recs.items()}


def rank_main(rank: int, world: int, store: str, path: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import make_mesh_compat
    from repro_torch.perf import trace_analysis as T
    from repro_torch.train import steps as S
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        arch, kind, seq, batch, ov = CELLS[GLOO]
        mesh = make_mesh_compat(MESH, AXES, device="cpu")
        cfg, shp, run = D.run_config(smoke_variant(get_config(arch)),
                                     _shape(kind, seq, batch), ov)
        rules = D.cell_rules(cfg, shp, run, mesh)
        state = S.train_state_init(0, cfg, torch.bfloat16, device="cpu")
        state = S.place_tree(state, S.resolve_shardings(
            rules, S.train_state_specs(cfg), state))
        gen = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                             dtype=torch.int32)
        batch_tree = {"tokens": rules.shard_input(toks, ("batch", None)),
                      "labels": rules.shard_input(toks, ("batch", None))}
        rec = D.trace(S.make_train_step(cfg, run, rules), (state, batch_tree))
        if rank == 0:
            with open(path, "w") as f:
                json.dump({"analysis": T.analyze(rec),
                           "memory_analysis": T.memory_analysis(rec)}, f)
    finally:
        dist.destroy_process_group()


def _force_host_devices():
    import os
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")


def reference_main(path: str) -> None:
    _force_host_devices()
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import ARCHS, smoke_variant
    from repro.configs.base import ShapeConfig
    from repro.launch import dryrun as D
    from repro.perf import hlo_analysis

    D.get_config = lambda a: smoke_variant(ARCHS[a])
    D.SHAPES = {f"smoke_{kind}": ShapeConfig(f"smoke_{kind}", seq, batch,
                                             kind)
                for _, kind, seq, batch, _ in CELLS}
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(MESH), AXES)
    out = {"cells": []}
    for arch, kind, _, _, ov in CELLS:
        # run_cell's lines (dryrun.py:173-196) on this mesh
        fn, args_sds, in_sh = D.build_cell(arch, f"smoke_{kind}", mesh,
                                           run_overrides=ov)
        with mesh:
            jf = jax.jit(fn, in_shardings=in_sh, donate_argnums=(0,))
            compiled = jf.lower(*args_sds).compile()
            ma = compiled.memory_analysis()
            hlo = compiled.as_text()
        out["cells"].append({
            "memory_analysis": {"argument_size_in_bytes":
                                int(ma.argument_size_in_bytes)},
            "analysis": hlo_analysis.analyze(hlo)})
    with open(path, "w") as f:
        json.dump(out, f)


def reference_ops_main(path: str) -> None:
    _force_host_devices()
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P
    from repro.perf import hlo_analysis
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    def compiled_text(f, *shapes):
        return jax.jit(f).lower(*[jax.ShapeDtypeStruct(s, jnp.float32)
                                  for s in shapes]).compile().as_text()

    out = {"mm": hlo_analysis.analyze(compiled_text(lambda a, b: a @ b, *MM)),
           "bmm": hlo_analysis.analyze(compiled_text(lambda a, b: a @ b,
                                                     *BMM))}
    n = 4
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    bodies = {
        "psum": lambda x: jax.lax.psum(x, "x"),
        "all_gather": lambda x: jax.lax.all_gather(x, "x", tiled=True),
        "psum_scatter": lambda x: jax.lax.psum_scatter(x, "x", tiled=True),
        "all_to_all": lambda x: jax.lax.all_to_all(x, "x", 0, 0,
                                                   tiled=True),
        "ppermute": lambda x: jax.lax.ppermute(
            x, "x", [(i, (i + 1) % n) for i in range(n)]),
    }
    for name, body in bodies.items():
        f = shard_map(body, mesh=mesh, in_specs=P("x"), out_specs=P("x"))
        out[name] = hlo_analysis.analyze(compiled_text(
            f, (COLL[0] * n, COLL[1])))
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    try:
        if sys.argv[1] == "rank":
            rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                      sys.argv[5])
        else:
            {"port": port_main, "port-ops": port_ops_main,
             "reference": reference_main,
             "reference-ops": reference_ops_main}[sys.argv[1]](sys.argv[2])
    except Exception:
        traceback.print_exc()
        sys.exit(1)
