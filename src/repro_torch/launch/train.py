"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
— port of ``repro.launch.train``: data -> SN dedup -> the checkpointed
train loop, on the CUDA card unless ``--device`` says otherwise.

As the reference's, it lays the state out with ``Rules(make_host_mesh(
model=--model-axis), fsdp=True)`` at every ``--model-axis``: the mesh is
(world / N, N) ("data", "model") over the ranks of the process group.
One process (no group started by the caller, no ``WORLD_SIZE`` above 1 in
the environment) is the (1, 1) mesh, on a world-size-1 group it starts
and destroys (NCCL on the card, gloo with ``--device cpu``); its layouts
are whole tensors, which stay plain (no DTensor dispatch).  More ranks:
start them with a launcher that sets the ``torch.distributed`` environment
(``torchrun --nproc-per-node 4 -m repro_torch.launch.train --model-axis
2``; each rank takes the card of its ``LOCAL_RANK``), or start the group
in each process yourself and call ``main``.  Every rank builds the same
state from the seed and keeps its shards; rank 0 prints the summary.

Under the rules the MoE archs take the reference's capacity dispatch
(``models.moe``), which drops tokens over an expert's capacity, on one
device too."""
from __future__ import annotations

import argparse
import os
import tempfile
from dataclasses import replace

import torch

from repro_torch.configs import ARCHS, get_config, smoke_variant
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.data.corpus import TokenBatcher, dedup_corpus, synth_corpus
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding.rules import Rules
from repro_torch.train import optim, steps
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.loop import LoopConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b",
                    choices=sorted(ARCHS))
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"],
                    help="smoke: tiny; 100m: ~100M-param variant; full: "
                         "the assigned config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--dedup", action="store_true",
                    help="run the SN dedup stage on the corpus first")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    import torch.distributed as dist
    dev = resolve_device(args.device)
    started = not dist.is_initialized()
    if started and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        rules = Rules(make_host_mesh(model=args.model_axis, device=dev),
                      fsdp=True)
        return _run(args, dev, rules, dist.get_rank() == 0)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, dev, rules, rank0: bool):
    import torch.distributed as dist

    base = get_config(args.arch)
    if args.preset == "smoke":
        cfg = smoke_variant(base)
    elif args.preset == "100m":
        cfg = hundred_m_variant(base)
    else:
        cfg = base

    shape = ShapeConfig("cli", args.seq_len, args.batch, "train")
    run = RunConfig(model=cfg, shape=shape, remat="block", microbatch=0)
    oc = optim.OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                         total_steps=args.steps)

    # -- data: synthetic corpus (+ the paper's dedup stage) ------------------
    docs = synth_corpus(0, n_docs=4096, doc_len=args.seq_len,
                        vocab=cfg.vocab_size, dup_frac=0.25)
    if args.dedup:
        res = dedup_corpus(docs, r=4, window=10, device=dev)
        if rank0:
            print(f"[dedup] pairs={res.n_pairs} dropped={res.n_dropped} "
                  f"gini={res.gini:.2f} overflow={res.overflow}")
        docs = docs[res.keep]
    batcher = TokenBatcher(docs, seq_len=args.seq_len,
                           global_batch=args.batch)

    train_step = steps.make_train_step(cfg, run, rules, oc)
    state = steps.train_state_init(0, cfg, torch.bfloat16, device=dev)
    state_sh = steps.resolve_shardings(
        rules, steps.train_state_specs(cfg), state)
    state = steps.place_tree(state, state_sh)

    ckpt = Checkpointer(args.ckpt_dir, async_save=True)
    if not args.resume and rank0:
        # fresh run: clear stale manifest
        for p in list(ckpt.dir.glob("step_*.npz")) + \
                list(ckpt.dir.glob("manifest.json")):
            p.unlink()
    dist.barrier()
    lc = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every)
    state, stats = train_loop(train_step, state, batcher, ckpt, lc,
                              shardings=state_sh)
    if rank0:
        print(f"[done] steps={stats.steps} "
              f"final_loss={stats.losses[-1]:.4f} "
              f"first_loss={stats.losses[0]:.4f} "
              f"restores={stats.restores}")
    return stats


def hundred_m_variant(base: ModelConfig) -> ModelConfig:
    """~100M-param member of the same family (example end-to-end driver)."""
    period = len(base.pattern)
    n_layers = max(period, (12 // period) * period)
    kwargs = dict(
        n_layers=n_layers, d_model=768,
        n_heads=12, n_kv_heads=min(base.n_kv_heads, 4),
        head_dim=64, d_ff=2048 if base.d_ff else 0,
        vocab_size=32_768)
    if base.moe is not None:
        kwargs["moe"] = replace(base.moe, n_experts=8, top_k=2,
                                expert_d_ff=512)
    if base.rglru_dim:
        kwargs["rglru_dim"] = 768
    if base.window_size:
        kwargs["window_size"] = 128
    return replace(base, **kwargs)


if __name__ == "__main__":
    main()
