"""Port parity for the LM's data and optimizer: ``TokenBatcher``'s
batches, ``lr_at`` over both schedules, ``global_norm`` and
``adamw_update`` on a random tree of 1-D, 2-D and stacked leaves — against
the reference on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import corpus as rcorpus  # noqa: E402
from repro.train import optim as ropt  # noqa: E402
from repro_torch.data import corpus as tcorpus  # noqa: E402
from repro_torch.models.modules import tree_items  # noqa: E402
from repro_torch.train import optim as topt  # noqa: E402

# lr_at: the same f32 operations on the step; cos may differ by an ulp
LR_RTOL = 1e-6
# global_norm: f32 sums of ~10^4 squares in another order
NORM_RTOL = 1e-6
# adamw_update: f32 elementwise ops in the reference's order; the leaves
# are O(1) and move by lr * O(1) per step (XLA may fuse a multiply-add)
UPDATE_ATOL = 1e-6


def test_token_batcher_batches_equal():
    docs = rcorpus.synth_corpus(3, 64, doc_len=24, vocab=97)
    np.testing.assert_array_equal(
        tcorpus.synth_corpus(3, 64, doc_len=24, vocab=97), docs)
    ref = rcorpus.TokenBatcher(docs, seq_len=16, global_batch=5, seed=2)
    port = tcorpus.TokenBatcher(docs, seq_len=16, global_batch=5, seed=2)
    assert port.n_sequences == ref.n_sequences
    for step in (0, 1, 7, 1000):
        want, got = ref.batch(step), port.batch(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_at_matches_reference(schedule):
    oc = dict(lr=3e-4, warmup_steps=7, total_steps=50, min_lr_ratio=0.1,
              schedule=schedule)
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.array([float(ropt.lr_at(ropt.OptConfig(**oc), jnp.int32(s)))
                     for s in steps])
    got = np.array([float(topt.lr_at(topt.OptConfig(**oc),
                                     torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=LR_RTOL, atol=0)
    assert float(topt.lr_at(topt.OptConfig(**oc), 3)) == \
        pytest.approx(float(want[3]), rel=LR_RTOL)


def _tree(rng, dtype=np.float32):
    """1-D leaves (a norm scale, a bias), 2-D (a dense weight) and stacked
    3-D / 2-D group leaves, as the LM's param trees have them."""
    def n(*shape):
        return rng.normal(size=shape).astype(dtype)
    return {"embed": {"table": n(11, 6)},
            "final_norm": {"scale": n(6)},
            "groups": {"b0": {"mixer": {"wq": {"w": n(3, 6, 8), "b": n(3, 8)}},
                              "norm1": {"scale": n(3, 6)}}},
            "head": {"b": n(5)}}


def _to_port(tree):
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_global_norm_matches_reference():
    tree = _tree(np.random.default_rng(0))
    want = float(ropt.global_norm(tree))
    got = float(topt.global_norm(_to_port(tree)))
    assert got == pytest.approx(want, rel=NORM_RTOL)


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clipped", "no-clip"])
def test_adamw_update_matches_reference(clip):
    rng = np.random.default_rng(1)
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip,
              weight_decay=0.1)
    params = _tree(rng)
    ref_p, ref_o = params, ropt.adamw_init(params)
    port_p = _to_port(params)
    port_o = topt.adamw_init(port_p)
    assert port_o["step"].dtype == torch.int32 and int(port_o["step"]) == 0
    kept = {k: v for k, v in tree_items(port_p)}
    for _ in range(3):
        grads = _tree(rng)
        ref_p, ref_o, rm = ropt.adamw_update(grads, ref_o, ref_p,
                                             ropt.OptConfig(**oc))
        out_p, out_o, tm = topt.adamw_update(_to_port(grads), port_o, port_p,
                                             topt.OptConfig(**oc))
        # in place: the same tensors come back, updated
        assert out_p is port_p and out_o is port_o
        assert float(tm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=NORM_RTOL)
        assert float(tm["lr"]) == pytest.approx(float(rm["lr"]),
                                                rel=LR_RTOL)
    assert int(port_o["step"]) == int(ref_o["step"]) == 3
    for part, (got, want) in {"params": (port_p, ref_p),
                              "m": (port_o["m"], ref_o["m"]),
                              "v": (port_o["v"], ref_o["v"])}.items():
        want_items = dict(tree_items(_np(want)))
        for k, t in tree_items(got):
            np.testing.assert_allclose(t.numpy(), want_items[k], rtol=0,
                                       atol=UPDATE_ATOL,
                                       err_msg=f"{part}{k}")
    for k, t in tree_items(port_p):
        assert t is kept[k]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_weight_decay_only_on_leaves_of_two_or_more_dims():
    """With zero gradients the update is the decay alone: 1-D leaves keep
    their values, 2-D and stacked leaves (the stacked norm scales
    included) shrink by lr * weight_decay."""
    params = _to_port(_tree(np.random.default_rng(2)))
    before = {k: t.clone() for k, t in tree_items(params)}
    grads = _to_port(_np_zeros(params))
    oc = topt.OptConfig(lr=0.5, warmup_steps=0, schedule="constant",
                        weight_decay=0.1)
    topt.adamw_update(grads, topt.adamw_init(params), params, oc)
    for k, t in tree_items(params):
        want = before[k] * (1 - 0.5 * 0.1) if t.dim() >= 2 else before[k]
        np.testing.assert_allclose(t.numpy(), want.numpy(), rtol=1e-6,
                                   err_msg=k)


def _np_zeros(tree):
    if isinstance(tree, dict):
        return {k: _np_zeros(v) for k, v in tree.items()}
    return np.zeros(tuple(tree.shape), np.float32)


def test_update_in_slices_equals_whole_leaf(monkeypatch):
    """The update runs a leaf in slices of UPDATE_SLICE elements: a slice
    smaller than every leaf gives the same numbers as whole leaves."""
    rng = np.random.default_rng(3)
    params, grads = _tree(rng), _tree(rng)
    oc = topt.OptConfig(lr=1e-2, warmup_steps=1)
    whole_p = _to_port(params)
    topt.adamw_update(_to_port(grads), topt.adamw_init(whole_p), whole_p, oc)
    monkeypatch.setattr(topt, "UPDATE_SLICE", 5)
    sliced_p = _to_port(params)
    topt.adamw_update(_to_port(grads), topt.adamw_init(sliced_p), sliced_p,
                      oc)
    for (k, a), (_, b) in zip(tree_items(whole_p), tree_items(sliced_p)):
        assert torch.equal(a, b), k
