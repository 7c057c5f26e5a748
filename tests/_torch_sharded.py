"""Programs of the multi-rank sharding tests (``test_torch_sharded.py``),
each run in a process of its own on one inputs file that the test writes
(``write_inputs``: seeded numpy data, the reference's initial states):

    python tests/_torch_sharded.py rank RANK WORLD STORE INPUTS OUT CKPT
        one rank of the port: joins a gloo group of WORLD ranks on the
        FileStore STORE, lays a (2, 2) ("data", "model") mesh over them,
        runs every case with the port's sharding rules, saves and restores
        a sharded checkpoint under CKPT, runs the train launcher at
        ``--model-axis 2``, and writes its results to OUT
    python tests/_torch_sharded.py reference INPUTS OUT
        the reference: 4 forced XLA host devices on a (2, 2)
        ``jax.sharding.Mesh`` (axes ``Auto``), every case with its rules

Results are whole (``full_tensor``) numpy arrays in a pickle.  A rank
imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import os
import pickle
import sys
from datetime import timedelta

import numpy as np

MESH = (2, 2)
AXES = ("data", "model")
# the expert-parallel and the width-parallel MoE; fsdp on for one, off
# for the other
MOE = {"ep": ("qwen3-moe-235b-a22b", True), "tp": ("mixtral-8x22b", False)}
MOE_SHAPE = (2, 64)
TRAIN = ("gemma2-9b", "qwen3-moe-235b-a22b")
TRAIN_B, TRAIN_S, TRAIN_MB = 4, 32, 2        # gemma2 in 2 micro-batches
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# the recurrent mixers under the rules, against the port's own unsharded
# forward on the same params (the reference holds them in test_torch_lm_*)
RECURRENT = ("recurrentgemma-9b", "xlstm-350m")
SERVE = "gemma2-9b"
SERVE_B, SERVE_S, SERVE_T, DECODE = 2, 16, 32, 4
LAUNCH = dict(arch="phi4-mini-3.8b", steps=3, seq=32, batch=4)


def launch_argv(ckpt_dir: str, model_axis: int) -> list:
    return ["--arch", LAUNCH["arch"], "--preset", "smoke",
            "--steps", str(LAUNCH["steps"]), "--seq-len", str(LAUNCH["seq"]),
            "--batch", str(LAUNCH["batch"]), "--model-axis",
            str(model_axis), "--ckpt-dir", ckpt_dir]


def train_run(cfg, arch: str, RunConfig, ShapeConfig):
    mb = TRAIN_MB if arch == "gemma2-9b" else 0
    return RunConfig(model=cfg, shape=ShapeConfig("t", TRAIN_S, TRAIN_B,
                                                  "train"),
                     remat="block", microbatch=mb)


def moe_grad_keys(p: dict) -> list:
    keys = ["wg", "w_gate", "w_up", "w_down"]
    if "shared" in p:
        keys += [f"shared/{k}" for k in sorted(p["shared"])]
    return keys


def _get(p: dict, key: str):
    for part in key.split("/"):
        p = p[part]
    return p


def write_inputs(path: str) -> None:
    """Seeded inputs of every case: the MoE weights and skewed tokens, the
    reference's f32 train states and serve params, batches and prompts."""
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS, smoke_variant
    from repro.models import lm as rlm
    from repro.models import moe as rmoe
    from repro.train import steps as rsteps
    tree = lambda t: jax.tree.map(np.asarray, t)
    out = {"moe": {}, "train": {}}
    for name, (arch, _) in MOE.items():
        cfg = smoke_variant(ARCHS[arch])
        p = tree(rmoe.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32))
        p["wg"] = p["wg"].copy()
        p["wg"][:, 0] += 0.5                      # skew: expert 0 overflows
        x = np.abs(np.random.default_rng(0).normal(
            size=MOE_SHAPE + (cfg.d_model,))).astype(np.float32)
        out["moe"][name] = {"params": p, "x": x}
    for arch in TRAIN:
        cfg = smoke_variant(ARCHS[arch])
        rng = np.random.default_rng(1)
        toks = rng.integers(0, cfg.vocab_size,
                            size=(TRAIN_B, TRAIN_S)).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((TRAIN_B, 1), -1, np.int32)], axis=1)
        out["train"][arch] = {
            "state": tree(rsteps.train_state_init(jax.random.PRNGKey(0),
                                                  cfg, jnp.float32)),
            "batch": {"tokens": toks, "labels": labels}}
    cfg = smoke_variant(ARCHS[SERVE])
    out["serve"] = {
        "params": tree(rlm.lm_init(jax.random.PRNGKey(2), cfg, jnp.float32)),
        "prompt": np.random.default_rng(3).integers(
            0, cfg.vocab_size, size=(SERVE_B, SERVE_S)).astype(np.int32)}
    with open(path, "wb") as f:
        pickle.dump(out, f)


# -- the port's ranks ----------------------------------------------------------

def rank_main(rank: int, world: int, store: str, inputs: str, path: str,
              ckpt: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch import make_mesh_compat
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import lm
    from repro_torch.models import moe as tmoe
    from repro_torch.models.convert import (from_reference_params,
                                            train_state_from_reference)
    from repro_torch.models.modules import tree_items, tree_map
    from repro_torch.sharding import Rules
    from repro_torch.train import optim, steps
    from repro_torch.train.checkpoint import Checkpointer
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    with open(inputs, "rb") as f:
        data = pickle.load(f)
    out = {}
    whole = lambda t: t.full_tensor().detach().numpy() \
        if hasattr(t, "full_tensor") else t.detach().numpy()
    try:
        mesh = make_mesh_compat(MESH, AXES, device="cpu")

        for name, (arch, fsdp) in MOE.items():
            cfg = smoke_variant(ARCHS[arch])
            rules = Rules(mesh, fsdp=fsdp)
            case = data["moe"][name]
            p = tree_map(torch.from_numpy, case["params"])
            p = steps.place_tree(p, steps.resolve_shardings(
                rules, tmoe.moe_specs(cfg), p))
            x = rules.shard_input(torch.from_numpy(case["x"]),
                                  ("batch", None, None))
            leaves = [_get(p, k) for k in moe_grad_keys(p)]
            for w in leaves:
                w.requires_grad_(True)
            y, aux, drop = tmoe.moe_apply(p, x, cfg, rules=rules)
            loss = (y * y).sum().full_tensor() + aux.full_tensor()
            grads = torch.autograd.grad(loss, leaves)
            out[f"moe/{name}"] = {
                "y": whole(y), "aux": float(aux.full_tensor()),
                "drop": float(drop.full_tensor()),
                "grads": {k: whole(g) for k, g in
                          zip(moe_grad_keys(p), grads)}}

        rules = Rules(mesh, fsdp=True)
        for arch in TRAIN:
            cfg = smoke_variant(ARCHS[arch])
            case = data["train"][arch]
            state = train_state_from_reference(case["state"], cfg,
                                               device="cpu")
            sh = steps.resolve_shardings(rules, steps.train_state_specs(cfg),
                                         state)
            state = steps.place_tree(state, sh)
            step = steps.make_train_step(
                cfg, train_run(cfg, arch, RunConfig, ShapeConfig), rules,
                optim.OptConfig(**OPT))
            state, m = step(state, case["batch"])
            out[f"train/{arch}"] = {
                "metrics": {k: float(v) for k, v in m.items()},
                "state": {k: whole(t) for k, t in tree_items(state)}}
            if arch == "gemma2-9b":
                # a sharded checkpoint, written in the background, and
                # back onto the mesh
                ck = Checkpointer(ckpt, async_save=True)
                ck.save(1, state)
                back = ck.restore(1, state, device="cpu", shardings=sh)
                shd = dict(tree_items(sh))
                out["ckpt"] = {
                    "placements_equal": all(
                        tuple(t.placements) == shd[k].placements
                        for k, t in tree_items(back)),
                    "values_equal": all(
                        np.array_equal(whole(t), out[f"train/{arch}"]
                                       ["state"][k])
                        for k, t in tree_items(back))}

        for arch in RECURRENT:
            cfg = smoke_variant(ARCHS[arch])
            params = lm.lm_init(0, cfg, torch.float32, device="cpu")
            case = data["train"][TRAIN[0]]["batch"]
            got = {}
            for name, r in (("plain", None), ("rules", rules)):
                p = params if r is None else steps.place_tree(
                    params, steps.resolve_shardings(r, lm.lm_specs(cfg),
                                                    params))
                items = tree_items(p)
                for _, t in items:
                    t.requires_grad_(True)
                loss, _ = lm.lm_loss(p, cfg, case, rules=r, remat="none",
                                     device="cpu")
                grads = torch.autograd.grad(loss, [t for _, t in items])
                got[name] = {"loss": float(loss), "grads": {
                    k: whole(g) for (k, _), g in zip(items, grads)}}
                for _, t in items:
                    t.requires_grad_(False)
            out[f"recurrent/{arch}"] = got

        cfg = smoke_variant(ARCHS[SERVE])
        rules = Rules(mesh, fsdp=True, seq_shard_kv=True)
        run = RunConfig(model=cfg, shape=ShapeConfig("s", SERVE_T, SERVE_B,
                                                     "prefill"))
        params = from_reference_params(data["serve"]["params"], cfg,
                                       device="cpu")
        params = steps.place_tree(params, steps.resolve_shardings(
            rules, lm.lm_specs(cfg), params))
        cache = lm.cache_init(cfg, SERVE_B, SERVE_T, torch.float32,
                              device="cpu")
        cache = steps.place_tree(cache, steps.resolve_shardings(
            rules, lm.cache_specs(cfg), cache))
        tok, cache = steps.make_prefill_step(cfg, run, rules)(
            params, {"tokens": data["serve"]["prompt"]}, cache)
        toks = [tok.numpy()]
        decode = steps.make_decode_step(cfg, run, rules)
        for i in range(DECODE):
            tok, cache = decode(params, tok[:, None], cache, SERVE_S + i + 1)
            toks.append(tok.numpy())
        out["serve"] = {"tokens": np.stack(toks, axis=1),
                        "cache_local_t": int(cache["b1"]["k"].to_local()
                                             .shape[2])}

        stats = tlaunch.main(launch_argv(ckpt + "_launch", 2) +
                             ["--device", "cpu"])
        out["launch"] = {"losses": list(stats.losses)}
        with open(path, "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# -- the reference -------------------------------------------------------------

def reference_main(inputs: str, path: str) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import ARCHS, smoke_variant
    from repro.configs.base import RunConfig, ShapeConfig
    from repro.models import lm as rlm
    from repro.models import moe as rmoe
    from repro.sharding.rules import Rules
    from repro.train import optim, steps
    with open(inputs, "rb") as f:
        data = pickle.load(f)
    mesh = Mesh(np.array(jax.devices()).reshape(MESH), AXES)
    keyed = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                       jax.tree_util.tree_flatten_with_path(t)[0]}
    out = {}
    with mesh:
        for name, (arch, fsdp) in MOE.items():
            cfg = smoke_variant(ARCHS[arch])
            rules = Rules(mesh, fsdp=fsdp)
            case = data["moe"][name]
            keys = moe_grad_keys(case["params"])

            def f(leaves, rest, x):
                p = jax.tree.map(lambda a: a, rest)
                for k, w in zip(keys, leaves):
                    parts = k.split("/")
                    d = p
                    for part in parts[:-1]:
                        d = d[part]
                    d[parts[-1]] = w
                y, aux, drop = rmoe.moe_apply(p, x, cfg, rules=rules)
                return jnp.sum(y * y) + aux, (y, aux, drop)
            leaves = [_get(case["params"], k) for k in keys]
            (_, (y, aux, drop)), g = jax.jit(jax.value_and_grad(
                f, has_aux=True))(leaves, case["params"], case["x"])
            out[f"moe/{name}"] = {
                "y": np.asarray(y), "aux": float(aux), "drop": float(drop),
                "grads": {k: np.asarray(v) for k, v in zip(keys, g)}}

        rules = Rules(mesh, fsdp=True)
        for arch in TRAIN:
            cfg = smoke_variant(ARCHS[arch])
            case = data["train"][arch]
            state = case["state"]
            sh = steps.resolve_shardings(rules, steps.train_state_specs(cfg),
                                         state)
            state = jax.tree.map(jax.device_put, state, sh)
            step = jax.jit(steps.make_train_step(
                cfg, train_run(cfg, arch, RunConfig, ShapeConfig), rules,
                optim.OptConfig(**OPT)))
            state, m = step(state, case["batch"])
            out[f"train/{arch}"] = {
                "metrics": {k: float(v) for k, v in m.items()},
                "state": keyed(state)}

        cfg = smoke_variant(ARCHS[SERVE])
        rules = Rules(mesh, fsdp=True, seq_shard_kv=True)
        run = RunConfig(model=cfg, shape=ShapeConfig("s", SERVE_T, SERVE_B,
                                                     "prefill"))
        params = data["serve"]["params"]
        params = jax.tree.map(jax.device_put, params, steps.resolve_shardings(
            rules, rlm.lm_specs(cfg), params))
        cache = rlm.cache_init(cfg, SERVE_B, SERVE_T, jnp.float32)
        cache = jax.tree.map(jax.device_put, cache, steps.resolve_shardings(
            rules, rlm.cache_specs(cfg), cache))
        prefill = jax.jit(steps.make_prefill_step(cfg, run, rules))
        decode = jax.jit(steps.make_decode_step(cfg, run, rules))
        tok, cache = prefill(params, {"tokens": data["serve"]["prompt"]},
                             cache)
        toks = [np.asarray(tok)]
        for i in range(DECODE):
            tok, cache = decode(params, tok[:, None], cache,
                                jnp.int32(SERVE_S + i + 1))
            toks.append(np.asarray(tok))
        out["serve"] = {"tokens": np.stack(toks, axis=1)}
    with open(path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5], sys.argv[6], sys.argv[7])
    else:
        reference_main(sys.argv[2], sys.argv[3])
