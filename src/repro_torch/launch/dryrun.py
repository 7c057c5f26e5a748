"""Multi-pod dry run of the LM scaffold — port of ``repro.launch.dryrun``.

For every (architecture x input shape x mesh) cell the reference compiles
``jit(step).lower(ShapeDtypeStructs).compile()`` on the 16 x 16
single-pod and the 2 x 16 x 16 multi-pod mesh of 512 forced host devices,
and records XLA's memory and cost analyses and the HLO's collectives.  The
port runs eager PyTorch: nothing is compiled, so a cell is traced instead.
Its step runs once

  * on rank 0 of a ``fake`` process group of 512 ranks
    (``torch.testing._internal.distributed.fake_pg``: its collectives move
    nothing and wait on no one),
  * under ``FakeTensorMode`` (no memory allocated, no kernel launched),
  * on fake local shards of its arguments built from their shapes and
    spec trees (``build_cell``: the counterpart of ``jax.eval_shape``;
    Qwen3-MoE-235B's 470 GB of bf16 parameters are never allocated),

while ``perf.trace_analysis.OpRecorder`` records every op rank 0
dispatches, with its shapes.  The record gives what the reference reads
from HLO (``trace_analysis.analyze``: dot FLOPs and bytes, collective bytes
per kind) and from XLA's analyses (``memory_analysis`` from the live
storages; ``flops`` from ``torch.utils.flop_counter``'s rules in place of
``cost_analysis``).  Loops run unrolled, so the counts are exact.  A
prefill on the card's device type traces K4's route as one op,
``repro_torch::local_attn`` (its shape rule is registered with it in
``kernels.ops``); on ``--device cpu`` the route is the plain scan, as it is
on the CPU.

One process, one fake world of 512 ranks: the multi-pod mesh is the whole
world and the single-pod mesh a ``new_group`` of its first 256 ranks, as
the reference's 512 forced devices serve its 256-device mesh.  One process
is chosen over a subprocess per mesh kind because a fake group costs
nothing to keep, and a sweep then starts Python and imports torch once.

Torch's DTensor builds a small index tensor and reads it on the host to
place a ``_StridedShard`` (a layout its sharding propagation may pick in a
backward); under fake mode that read fails, so ``fake_safe_dtensor`` runs
that one function outside the fake mode while a cell is traced.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape prefill_32k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --jobs 8
(a cell is host work on one core, ~0.3 ms an op: a prefill_32k or a
train_4k cell unrolls ~10^6 ops, and ``--jobs`` traces cells side by side)
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.models.modules import tree_map
from repro_torch.perf import trace_analysis
from repro_torch.sharding import local as SL
from repro_torch.sharding.rules import Rules
from repro_torch.train import steps as S

ART_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
# the fake world: the multi-pod mesh's ranks
WORLD = 512

#: the reference's memory-safe defaults for the full-size train cells
#: (full remat + micro-batches), so that both packages trace the same cells
TRAIN_DEFAULTS = {"remat": "full", "microbatch": 4}

#: the reference's per-arch micro-batch bumps for the largest models
ARCH_TRAIN_OVERRIDES = {
    "qwen1.5-110b": {"microbatch": 8},
    "qwen3-moe-235b-a22b": {"microbatch": 16},
    "mixtral-8x22b": {"microbatch": 8},
    "recurrentgemma-9b": {"microbatch": 8},
}


# -- the fake world ----------------------------------------------------------------

def fake_world() -> None:
    """Make this process rank 0 of a fake process group of WORLD ranks
    (started here when no group exists; an existing one must be it)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if str(dist.get_backend()) != "fake" or \
                dist.get_world_size() != WORLD:
            raise RuntimeError(
                f"a dry run needs a fake process group of {WORLD} ranks; "
                f"this process has a {dist.get_backend()} group of "
                f"{dist.get_world_size()}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)


_MESHES: dict = {}


def production_mesh(kind: str, device=None):
    """The single-pod ("single") or multi-pod ("multi") mesh on the fake
    world (started if needed), its tensors on ``device`` (None: the
    card).  Kept per world, so a sweep lays each mesh out once."""
    import torch.distributed as dist
    fake_world()
    dev = "cuda" if device is None else str(torch.device(device).type)
    key = (dist.group.WORLD, kind, dev)
    if key not in _MESHES:
        if kind == "multi":
            group = dist.group.WORLD
        else:
            group = dist.new_group(list(range(WORLD // 2)))
        _MESHES[key] = make_production_mesh(multi_pod=kind == "multi",
                                            group=group, device=device)
    return _MESHES[key]


@contextlib.contextmanager
def fake_safe_dtensor():
    """Run DTensor's ``_StridedShard.local_shard_size_and_offset`` (which
    reads an index tensor it builds) outside the fake mode; restored on
    exit.  A torch without that method is left as it is."""
    try:
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor.placement_types import _StridedShard
        orig = _StridedShard.__dict__["local_shard_size_and_offset"]
    except (ImportError, KeyError):
        yield
        return

    def outside_fake(self, *a, **kw):
        with unset_fake_temporarily():
            return orig(self, *a, **kw)

    _StridedShard.local_shard_size_and_offset = outside_fake
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


# -- cells -------------------------------------------------------------------------

def run_config(arch, shape, run_overrides=None):
    """(ModelConfig, ShapeConfig, RunConfig) of a cell: ``arch`` and
    ``shape`` are names (or configs), the train defaults and the arch's
    bumps applied as the reference applies them."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    overrides = dict(TRAIN_DEFAULTS) if shp.kind == "train" else {}
    if shp.kind == "train":
        overrides.update(ARCH_TRAIN_OVERRIDES.get(cfg.name, {}))
    overrides.update(run_overrides or {})
    return cfg, shp, RunConfig(model=cfg, shape=shp, **overrides)


def cell_rules(cfg, shp, run, mesh) -> Rules:
    """The reference's rules of a cell: training shards params as
    ``run.fsdp`` says; serving shards them over the data axis too where
    model-axis TP alone leaves more than 8 GB of bf16 params a device;
    ``long_500k`` is context-parallel."""
    if shp.kind == "train":
        fsdp = run.fsdp
    else:
        fsdp = cfg.param_count() * 2 / 16 > 8e9
    return Rules(mesh, fsdp=fsdp,
                 seq_shard_kv=run.seq_shard_kv and shp.kind != "train",
                 context_parallel=shp.name == "long_500k",
                 seq_parallel=run.seq_parallel and shp.kind != "decode")


def shapes_of(fn, *args, **kwargs):
    """The ``ShapeDtype`` tree of ``fn``'s result, run under a fake mode of
    its own (nothing allocated): ``jax.eval_shape``'s counterpart."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = fn(*args, **kwargs)
        return tree_map(lambda t: S.ShapeDtype(tuple(t.shape), t.dtype), out)


def fake_shards(mode, shapes, shardings, device):
    """A tree of fake tensors of ``mode``: each leaf this rank's local
    shard of its ``ShapeDtype`` laid out by its ``NamedSharding``, as a
    DTensor where the mesh is spread (the whole leaf where it is not)."""
    if isinstance(shapes, dict):
        return {k: fake_shards(mode, shapes[k], shardings[k], device)
                for k in shapes}
    if not shardings.dtensors:
        with mode:
            return torch.empty(shapes.shape, dtype=shapes.dtype,
                               device=device)
    dm, pl = shardings.device_mesh, shardings.placements
    local, _ = SL.local_shape_and_offset(shapes.shape, dm, pl)
    with mode:
        t = torch.empty(local, dtype=shapes.dtype, device=device)
    return SL.from_local(t, dm, pl, shapes.shape)


def build_cell(arch, shape, mesh, *, run_overrides=None, device=None):
    """Returns ``(fn, args, fake_mode)``: the cell's step and its
    arguments as fake local shards of ``fake_mode`` on ``device`` (None:
    the card), laid out by the spec trees on ``mesh``.  The reference's
    cells: a train step on (state, batch), a prefill on (params, batch,
    cache), a decode on (params, tokens, cache, cache_pos) with
    ``cache_pos`` a Python int, the cache's length (the reference traces a
    0-d int32 there: its 4 bytes are in its arguments, not in these)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    cfg, shp, run = run_config(arch, shape, run_overrides)
    rules = cell_rules(cfg, shp, run, mesh)
    mode = FakeTensorMode()

    def shards(shapes, specs):
        return fake_shards(mode, shapes, S.resolve_shardings(
            rules, specs, shapes), dev)

    if shp.kind == "train":
        fn = S.make_train_step(cfg, run, rules)
        state = shapes_of(S.train_state_init, 0, cfg, torch.bfloat16,
                          device=dev)
        return fn, (shards(state, S.train_state_specs(cfg)),
                    shards(S.train_batch_shapes(cfg, run),
                           S.train_batch_spec(cfg, run))), mode

    params = shards(shapes_of(lm.lm_init, 0, cfg, torch.bfloat16,
                              device=dev), lm.lm_specs(cfg))
    cache = shards(S.cache_shapes(cfg, run), lm.cache_specs(cfg))
    if shp.kind == "prefill":
        fn = S.make_prefill_step(cfg, run, rules)
        batch = shards(S.serve_batch_shapes(cfg, run, decode=False),
                       S.serve_batch_spec(cfg, decode=False))
        return fn, (params, batch, cache), mode
    fn = S.make_decode_step(cfg, run, rules)
    tokens = shards(S.ShapeDtype((shp.global_batch, 1), torch.int32),
                    ("batch", None))
    return fn, (params, tokens, cache, shp.seq_len), mode


def trace(fn, args, mode=None):
    """Run ``fn(*args)`` once under an ``OpRecorder`` (inside ``mode``, a
    ``FakeTensorMode``, where given: a dry run) and return the recorder.
    Without ``mode`` the step runs for real, recorded the same way."""
    rec = trace_analysis.OpRecorder()
    rec.watch_arguments(args)
    with contextlib.ExitStack() as stack:
        if mode is not None:
            stack.enter_context(fake_safe_dtensor())
            stack.enter_context(mode)
        stack.enter_context(rec)
        out = fn(*args)
    rec.watch_outputs(out)
    return rec


def run_cell(arch: str, shape: str, mesh_kind: str, *, save: bool = True,
             run_overrides=None, tag: str = "", device=None,
             mesh=None) -> dict:
    """Trace one cell and return its record (written to ART_DIR with
    ``save``).  ``mesh``: a mesh of the caller's instead of the production
    one of ``mesh_kind``.  A failing cell is recorded with
    ``status: "error"`` and its traceback."""
    t0 = time.time()
    rec = {"arch": getattr(arch, "name", arch),
           "shape": getattr(shape, "name", shape), "mesh": mesh_kind,
           "devices": None, "status": "ok", "tag": tag}
    try:
        if mesh is None:
            mesh = production_mesh(mesh_kind, device)
        rec["devices"] = math.prod(mesh.sizes)
        fn, args, mode = build_cell(arch, shape, mesh,
                                    run_overrides=run_overrides,
                                    device=device)
        t_built = time.time()
        r = trace(fn, args, mode)
        t_traced = time.time()
        rec["flops"] = float(r.flops)
        rec["memory_analysis"] = trace_analysis.memory_analysis(r)
        rec["analysis"] = trace_analysis.analyze(r)
        rec["collectives"] = dict(
            rec["analysis"]["collectives"],
            total_bytes=rec["analysis"]["collective_bytes"])
        rec["ops"] = dict(sorted(r.ops.items()))
        rec["build_s"] = round(t_built - t0, 2)
        rec["trace_s"] = round(t_traced - t_built, 2)
        cfg = run_config(arch, shape, run_overrides)[0]
        rec["model_params"] = cfg.param_count()
        rec["active_params"] = cfg.active_param_count()
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    if save:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        path = ART_DIR / f"{rec['arch']}_{rec['shape']}_{mesh_kind}" \
                         f"{suffix}.json"
        path.write_text(json.dumps(rec, indent=1))
        rec["artifact"] = str(path)
    return rec


def _run_cells(jobs, n: int, **kw):
    """Each (arch, shape, mesh) of ``jobs`` traced by ``run_cell``: here,
    one after another, or with ``n`` above 1 in ``n`` worker processes, a
    fresh one per cell, the largest cells first (a sweep's time goes to
    its train and prefill cells); yields the records as they come."""
    if n <= 1:
        for arch, shape, mk in jobs:
            yield run_cell(arch, shape, mk, **kw)
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed
    order = {"train": 0, "prefill": 1, "decode": 2}
    jobs = sorted(jobs, key=lambda j: (order[SHAPES[j[1]].kind],
                                       -get_config(j[0]).param_count()))
    with ProcessPoolExecutor(n, mp_context=multiprocessing.get_context(
            "spawn"), max_tasks_per_child=1) as pool:
        futs = [pool.submit(run_cell, *j, **kw) for j in jobs]
        for f in as_completed(futs):
            yield f.result()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default=None,
                    help="device type of the traced tensors (default: the "
                         "CUDA card; 'cpu' traces the CPU's route)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a fresh process "
                         "(a trace is host work on one core)")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(a.name, s.name) for a, s, skip in cells() if skip is None]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        todo = [(args.arch, args.shape)]

    jobs = []
    for arch, shape in todo:
        for mk in meshes:
            suffix = f"_{args.tag}" if args.tag else ""
            path = ART_DIR / f"{arch}_{shape}_{mk}{suffix}.json"
            if args.skip_existing and path.exists() and \
                    json.loads(path.read_text()).get("status") == "ok":
                print(f"[skip] {arch} x {shape} x {mk}")
                continue
            jobs.append((arch, shape, mk))
    recs = []
    for rec in _run_cells(jobs, args.jobs, tag=args.tag, device=args.device):
        recs.append(rec)
        cell = f"{rec['arch']} x {rec['shape']} x {rec['mesh']}"
        if rec["status"] == "ok":
            an = rec["analysis"]
            print(f"[ok]   {cell}: "
                  f"dot_flops={an['dot_flops']:.3e}/dev "
                  f"kernel_flops={an['kernel_flops']:.3e}/dev "
                  f"coll={an['collective_bytes']:.3e}B/dev "
                  f"trace={rec['trace_s']}s", flush=True)
            print("       memory_analysis:", rec["memory_analysis"],
                  flush=True)
        else:
            print(f"[FAIL] {cell}: {rec['error']}", flush=True)
    return recs


if __name__ == "__main__":
    main()
