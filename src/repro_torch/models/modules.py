"""Minimal functional module system — port of ``repro.models.modules``.

Params are nested dicts of tensors with the reference's tree layout; every
module is an ``*_init`` / ``*_apply`` function pair.  An init draws from
an explicit ``torch.Generator`` (``key``) on the generator's device, so the
port's weights are its own: a parity test carries the reference's weights
across with ``models.convert.from_reference_params`` instead.  The logical
sharding specs (``*_specs``) come with the sharding rules (M12b-2).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

DEFAULT_INIT_SCALE = 0.02


def no_rules(rules, where: str) -> None:
    """The port runs the single-device path only: sharding rules are
    M12b-2's."""
    if rules is not None:
        raise NotImplementedError(
            f"{where}: sharding rules are not ported yet (M12b-2, the "
            f"sharding slice); pass rules=None")


def _normal(key: torch.Generator, shape, dtype,
            scale: float = DEFAULT_INIT_SCALE) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in f32 on the generator's device, then cast
    (the reference's ``_normal``)."""
    x = torch.randn(tuple(shape), generator=key, device=key.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


# -- dense ------------------------------------------------------------------

def dense_init(key, in_dim: int, out_dim: int, dtype, *, bias: bool = False,
               scale: Optional[float] = None):
    scale = DEFAULT_INIT_SCALE if scale is None else scale
    p = {"w": _normal(key, (in_dim, out_dim), dtype, scale)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=key.device)
    return p


def dense_apply(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# -- norms ------------------------------------------------------------------

def norm_init(key, dim: int, dtype, *, kind: str = "rmsnorm"):
    dev = key.device
    if kind == "rmsnorm":                               # gemma-style (1+scale)
        return {"scale": torch.zeros((dim,), dtype=dtype, device=dev)}
    return {"scale": torch.ones((dim,), dtype=dtype, device=dev),
            "bias": torch.zeros((dim,), dtype=dtype, device=dev)}


def norm_apply(p, x, *, kind: str = "rmsnorm", eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * (1.0 + p["scale"].float())).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# -- embedding ---------------------------------------------------------------

def embed_init(key, vocab: int, dim: int, dtype):
    return {"table": _normal(key, (vocab, dim), dtype, 1.0 / math.sqrt(dim))}


def embed_apply(p, tokens):
    return p["table"][tokens]


def unembed_apply(p, x):
    """Tied read-out: (B,S,D) @ (V,D)^T."""
    return x @ p["table"].to(x.dtype).T


# -- activations --------------------------------------------------------------

def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# -- tree helpers --------------------------------------------------------------

def tree_map(fn, tree):
    """``fn`` over every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_items(tree, prefix: str = ""):
    """(key, leaf) of every leaf in the reference's leaf order (dict keys
    sorted, as ``jax.tree_util`` flattens a dict), each key the string
    ``jax.tree_util.keystr`` gives its path, as in
    ``['params']['embed']['table']``."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def stack_init(init_fn, key, n: int):
    """``n`` draws of ``init_fn(key)`` stacked on a leading axis (the layer
    groups the LM loops over), filled one draw at a time so that the peak
    is the stack plus one draw."""
    first = init_fn(key)
    out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)

    def put(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k])
        else:
            dst.copy_(src)

    put(tree_map(lambda x: x[0], out), first)
    del first
    for i in range(1, n):
        put(tree_map(lambda x, i=i: x[i], out), init_fn(key))
    return out


def param_count(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def param_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))
