"""The port's sharding rules (``repro_torch.sharding.Rules``) and spec trees
against the reference's, without ranks: ``Rules`` reads only a mesh's axis
names and sizes, so both packages resolve against the same shape-only
stand-in meshes.

For each of the ten archs at its full configuration, each mesh
((4, 2) ("data", "model"), ("data",) 8, ("model",) 2, (2, 4, 2) ("pod",
"data", "model")) and each set of flags (FSDP on and off,
``seq_shard_kv``, ``context_parallel``, ``seq_parallel``), every leaf of
``train_state_specs``, ``cache_specs``, ``train_batch_spec`` and
``serve_batch_spec`` is resolved against the reference's shapes (dims an
axis does not divide included), and the port's ``PartitionSpec`` equals
the reference's entry by entry; the spec trees themselves are equal.
Then the specs' DTensor placements (``Rules.sharding``) and
``constrain`` on a plain tensor."""
import functools
from types import SimpleNamespace

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.sharding.rules import Rules as RRules  # noqa: E402
from repro.train import steps as rsteps  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.sharding import PartitionSpec, Rules  # noqa: E402
from repro_torch.sharding import spec_placements  # noqa: E402
from repro_torch.sharding.rules import is_logical_leaf  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

MESHES = {
    "data4-model2": (("data", "model"), (4, 2)),
    "data8": (("data",), (8,)),
    "model2": (("model",), (2,)),
    "pod2-data4-model2": (("pod", "data", "model"), (2, 4, 2)),
}
FLAGS = {
    "fsdp": dict(fsdp=True),
    "no-fsdp": dict(fsdp=False),
    "seq-shard-kv": dict(fsdp=True, seq_shard_kv=True),
    "context-parallel": dict(fsdp=False, context_parallel=True),
    "seq-parallel": dict(fsdp=True, seq_parallel=True),
}
# a batch of 6 rows, which "data" (4, 8) does not divide, and a sequence
# the model axis does divide
SHAPE = dict(seq_len=64, global_batch=6)


def _mesh(name):
    axes, sizes = MESHES[name]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))


@functools.lru_cache(maxsize=None)
def _reference_shapes(arch):
    """The reference's (state, cache, train batch, prefill, decode) shapes
    at ``arch``'s full configuration (nothing allocated)."""
    cfg = RARCHS[arch]
    run = RRun(model=cfg, shape=RShape("t", SHAPE["seq_len"],
                                       SHAPE["global_batch"], "train"))
    state = jax.eval_shape(lambda: rsteps.train_state_init(
        jax.random.PRNGKey(0), cfg))
    return (state, rsteps.cache_shapes(cfg, run),
            rsteps.train_batch_shapes(cfg, run),
            rsteps.serve_batch_shapes(cfg, run, decode=False),
            rsteps.serve_batch_shapes(cfg, run, decode=True))


def _specs(steps, lm, cfg, run):
    return (steps.train_state_specs(cfg), lm.cache_specs(cfg),
            steps.train_batch_spec(cfg, run),
            steps.serve_batch_spec(cfg, decode=False),
            steps.serve_batch_spec(cfg, decode=True))


def _leaves(tree, path=""):
    if is_logical_leaf(tree):
        yield path, tree
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], f"{path}/{k}")


def _shape_at(tree, path):
    return tuple(_at(tree, path).shape)


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(RARCHS))
def test_resolved_specs_equal_reference(arch, mesh, flags):
    shapes = _reference_shapes(arch)
    run = RRun(model=RARCHS[arch], shape=RShape("t", 64, 6, "train"))
    want_trees = _specs(rsteps, rlm, RARCHS[arch], run)
    got_trees = _specs(tsteps, tlm, ARCHS[arch], run)
    rrules = RRules(_mesh(mesh), **FLAGS[flags])
    trules = Rules(_mesh(mesh), **FLAGS[flags])
    assert trules.table == rrules.table
    for want_tree, got_tree, shape_tree in zip(want_trees, got_trees,
                                               shapes):
        assert got_tree == want_tree               # the spec trees
        # the port's resolution of the whole tree (its NamedShardings)
        resolved = tsteps.resolve_shardings(trules, got_tree, shape_tree)
        leaves = list(_leaves(want_tree))
        assert leaves
        for path, logical in leaves:
            dims = _shape_at(shape_tree, path)
            want = tuple(rrules.spec(logical, dims))
            got = trules.spec(logical, dims)
            assert isinstance(got, PartitionSpec)
            assert tuple(got) == want, (path, logical, dims)
            assert tuple(_at(resolved, path).spec) == want, path


def _at(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k] if k else tree
    return tree


def test_some_dims_are_not_divided():
    """The stand-in shapes include dims an axis does not divide (the
    batch of 6 over "data" 4), which the spec drops to replicated."""
    rules = Rules(_mesh("data4-model2"))
    assert tuple(rules.spec(("batch", None), (6, 64))) == (None, None)
    assert tuple(rules.spec(("batch", None), (8, 64))) == ("data", None)
    assert tuple(rules.spec(("batch", None))) == ("data", None)


@pytest.mark.parametrize("mesh,spec,want", [
    ("data4-model2", PartitionSpec("data", None, "model"),
     ("S0", "S2")),
    ("data4-model2", PartitionSpec(None, ("data", "model")), ("S1", "S1")),
    ("pod2-data4-model2", PartitionSpec(("pod", "data"), None, "model"),
     ("S0", "S0", "S2")),
    ("pod2-data4-model2", PartitionSpec(), ("R", "R", "R")),
    ("model2", PartitionSpec(None, "model"), ("S1",)),
])
def test_sharding_placements(mesh, spec, want):
    from torch.distributed.tensor import Replicate, Shard
    axes = MESHES[mesh][0]
    pl = spec_placements(axes, spec)
    assert pl == tuple(Replicate() if w == "R" else Shard(int(w[1:]))
                       for w in want)
    # Rules.sharding gives the spec's placements
    rules = Rules(_mesh(mesh))
    sh = rules.sharding(("batch", None, "vocab"), (8, 3, 256))
    assert sh.placements == spec_placements(axes, sh.spec)


def test_sharding_placements_refuse_out_of_order_axes():
    with pytest.raises(ValueError, match="order"):
        spec_placements(("data", "model"), PartitionSpec(("model", "data")))


def test_constrain_plain_tensor_only_on_size_one_axes():
    x = torch.zeros(4, 3)
    ones = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 1, "model": 1})
    assert Rules(ones).constrain(x, ("batch", "vocab")) is x
    with pytest.raises(ValueError, match="plain tensor"):
        Rules(_mesh("data4-model2")).constrain(x, ("batch", "vocab"))
    # a replicated spec needs no layout on any mesh
    assert Rules(_mesh("data4-model2")).constrain(x, (None, None)) is x
