"""The reference's parameter, cache and train-state trees as the port's.

``repro.models.lm.lm_init`` and ``cache_init`` build nested dicts with the
same keys and shapes as the port's ``lm_init`` and ``cache_init`` (layer
groups stacked on a leading axis), and ``repro.train.steps.
train_state_init`` the same ``{"params", "opt": {"m", "v", "step"}}`` as
the port's.  These functions take such a tree with numpy arrays at its
leaves (``np.asarray`` of each reference leaf; bfloat16 leaves included)
and give the port's tensors, so that both packages compute (and train)
from the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.modules import tree_leaves, tree_map


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: exact via f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def from_reference_params(tree, cfg, *, device=None):
    """The reference's ``lm_init`` tree (numpy leaves) as the port's
    params, on ``device`` (default: the CUDA card), leaf dtypes kept.  The
    keys and the group axis are checked against ``cfg``."""
    dev = resolve_device(device)
    _check_groups(tree, cfg)
    return tree_map(lambda x: _tensor(x, dev), tree)


def train_state_from_reference(tree, cfg, *, device=None):
    """The reference's ``train_state_init`` tree (numpy leaves: params in
    their dtype, f32 moments shaped as the params, an int32 step) as the
    port's train state, on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    if set(tree) != {"params", "opt"} or \
            set(tree["opt"]) != {"m", "v", "step"}:
        raise ValueError(f"train state keys {sorted(tree)}, opt "
                         f"{sorted(tree.get('opt', {}))}")
    for part in (tree["params"], tree["opt"]["m"], tree["opt"]["v"]):
        _check_groups(part, cfg)
    return tree_map(lambda x: _tensor(x, dev), tree)


def cache_from_reference(tree, cfg, *, device=None):
    """The reference's ``cache_init`` tree (numpy leaves) as the port's
    cache, on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    want = lm.cache_init(cfg, 1, 1, device="meta")
    if set(tree) != set(want):
        raise ValueError(f"cache keys {sorted(tree)} != {sorted(want)}")
    for blk in want:
        for leaf, w in want[blk].items():
            got = np.shape(tree[blk][leaf])
            if got[0] != cfg.n_groups or len(got) != w.dim():
                raise ValueError(f"cache {blk}.{leaf}: shape {got} for "
                                 f"{cfg.n_groups} groups of {w.dim() - 1}-d "
                                 f"leaves")
    return tree_map(lambda x: _tensor(x, dev), tree)


def _check_groups(tree, cfg) -> None:
    want = {"embed", "groups", "final_norm"} | (
        set() if cfg.tie_embeddings else {"head"})
    if set(tree) != want:
        raise ValueError(f"params keys {sorted(tree)} != {sorted(want)}")
    blocks = {f"b{i}" for i in range(len(cfg.pattern))}
    if set(tree["groups"]) != blocks:
        raise ValueError(f"groups {sorted(tree['groups'])} != "
                         f"{sorted(blocks)}")
    for leaf in tree_leaves(tree["groups"]):
        if np.shape(leaf)[0] != cfg.n_groups:
            raise ValueError(f"a group leaf of shape {np.shape(leaf)} for "
                             f"{cfg.n_groups} groups")
