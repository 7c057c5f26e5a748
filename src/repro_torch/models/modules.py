"""Minimal functional module system — port of ``repro.models.modules``.

Params are nested dicts of tensors with the reference's tree layout; every
module is an ``*_init`` / ``*_apply`` function pair plus a ``*_specs``
function returning the same-structure tree of *logical* sharding axis
tuples (resolved by ``repro_torch.sharding.Rules``).  An init draws from
an explicit ``torch.Generator`` (``key``) on the generator's device, so the
port's weights are its own: a parity test carries the reference's weights
across with ``models.convert.from_reference_params`` instead.

With ``rules`` the applies take DTensors laid out on the rules' mesh
(``train.steps.place_tree``) and PyTorch's DTensor dispatch runs the
dense maths; the bodies that the reference runs per shard go through
``repro_torch.sharding.local``.  On a mesh of size-1 axes they take the
plain tensors (``sharding.Rules.dtensors``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import is_logical_leaf

DEFAULT_INIT_SCALE = 0.02


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


def dense_specs(in_axis: Optional[str], out_axis: Optional[str],
                *, bias: bool = False):
    s = {"w": (in_axis, out_axis)}
    if bias:
        s["b"] = (out_axis,)
    return s


def matmul(x, w):
    """``x @ w``; of two DTensors, on each rank's own shards
    (``sharding.local.matmul``)."""
    from repro_torch.sharding.local import is_dtensor, matmul as local_mm
    if is_dtensor(x) and is_dtensor(w):
        return local_mm(x, w)
    return x @ w


def dense_apply(p, x):
    y = matmul(x, p["w"].to(x.dtype))
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


def norm_specs(kind: str = "rmsnorm"):
    if kind == "rmsnorm":
        return {"scale": ("none",)}
    return {"scale": ("none",), "bias": ("none",)}


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


def embed_specs():
    # vocab-sharded only: the d_model dim stays whole (the reference's
    # choice: sharding it too makes the token lookup repartition badly)
    return {"table": ("vocab", None)}


def embed_apply(p, tokens):
    """``table[tokens]``; of two DTensors, on each rank's own shards
    (``sharding.local.embedding``)."""
    from repro_torch.sharding.local import embedding, is_dtensor
    if is_dtensor(tokens) and is_dtensor(p["table"]):
        return embedding(p["table"], tokens)
    return p["table"][tokens]


def embed_onehot_apply(p, tokens, rules):
    """Distributed embedding as one_hot @ table (the reference's): with a
    vocab-sharded table the lookup is a shard-local contraction plus a
    sum over the vocab shards, and its table gradient one more.  ``tokens``
    is a DTensor on the rules' mesh (a plain tensor on a mesh of size-1
    axes); each rank builds the one-hot of its own tokens over its own
    vocab shard only (the one-hot laid out as ("batch", None, "vocab")),
    in the table's dtype (exact: one 1 per row)."""
    from repro_torch.sharding.local import (from_local, is_dtensor,
                                            local_shape_and_offset)
    table = p["table"]
    v = table.shape[0]
    if not is_dtensor(tokens):
        oh = torch.zeros(tuple(tokens.shape) + (v,), dtype=table.dtype,
                         device=tokens.device)
        oh.scatter_(-1, tokens.long()[..., None], 1)
        return matmul(oh, table)
    shape = tuple(tokens.shape) + (v,)
    mesh = tokens.device_mesh
    want = rules.placements(("batch", None, "vocab"), shape)
    tokens = rules.constrain(tokens, ("batch", None))
    (_, _, n), (_, _, lo) = local_shape_and_offset(shape, mesh, want)
    ids = tokens.to_local().long() - lo
    inside = ((ids >= 0) & (ids < n))[..., None].to(table.dtype)
    oh = torch.zeros(tuple(ids.shape) + (n,), dtype=table.dtype,
                     device=ids.device)
    oh.scatter_(-1, ids.clamp(0, max(n - 1, 0))[..., None], inside)
    return matmul(from_local(oh, mesh, want, shape), table)


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


def spec_map(fn, spec_tree):
    """``fn`` over every logical spec of a nested dict of specs."""
    if is_logical_leaf(spec_tree):
        return fn(spec_tree)
    return {k: spec_map(fn, v) for k, v in spec_tree.items()}


def prepend_layer_axis(spec_tree):
    """Add the stacked ('layers') axis in front of every leaf's logical
    spec."""
    return spec_map(lambda t: ("layers",) + t, spec_tree)


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
