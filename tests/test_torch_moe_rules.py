"""The MoE under sharding rules on one device, and the train launcher that
builds them: with any ``rules`` the reference's ``moe_apply`` takes its
``shard_map`` body (capacity per expert, drops), also on a 1 x 1 mesh,
where ``rules=None`` runs the single-device oracle (no capacity).  The
reference's launcher always builds rules, so a MoE arch trains through
the capacity body on one device; the port's launcher does the same.

The probe: smoke Qwen3-MoE, tokens ``|N(0, 1)|`` of shape (2, 64, d) from
seed 0 and the router's expert-0 column raised by 0.5, so that expert 0
overflows its capacity."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import Mesh  # noqa: E402
from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.sharding.rules import Rules as RRules  # noqa: E402
from repro_torch.configs import ARCHS, smoke_variant  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.modules import tree_map  # noqa: E402
from repro_torch.sharding import Rules  # noqa: E402
from repro_torch.sharding import local as SL  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ARCH = "qwen3-moe-235b-a22b"
# the probe's dropped share on one device with rules (the reference's)
PROBE_DROP = 0.1875
# the reference's bound for its sharded MoE against one device
MOE_RTOL, AUX_ATOL = 2e-4, 1e-5


@pytest.fixture(scope="module")
def host_mesh():
    """The port's (1, 1) ("data", "model") mesh on a world-size-1 gloo
    group, destroyed after the module unless one existed before."""
    import torch.distributed as dist

    from repro_torch.launch import make_host_mesh
    started = not dist.is_initialized()
    yield make_host_mesh(device="cpu")
    if started:
        dist.destroy_process_group()


def _probe():
    rcfg = rsmoke(RARCHS[ARCH])
    p = jax.tree.map(np.asarray, rmoe.moe_init(jax.random.PRNGKey(0), rcfg,
                                               jnp.float32))
    p["wg"] = p["wg"].copy()
    p["wg"][:, 0] += 0.5
    x = np.abs(np.random.default_rng(0).normal(
        size=(2, 64, rcfg.d_model))).astype(np.float32)
    return rcfg, p, x


def _tensors(p):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), p)


def test_skewed_moe_on_one_device_mesh_equals_reference(host_mesh):
    rcfg, p, x = _probe()
    cfg = smoke_variant(ARCHS[ARCH])
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with mesh:
        y_r, aux_r, drop_r = jax.jit(lambda p, x: rmoe.moe_apply(
            p, x, rcfg, rules=RRules(mesh)))(p, x)
    y_n, aux_n, drop_n = rmoe.moe_apply(p, x, rcfg, rules=None)
    assert float(drop_r) == PROBE_DROP and float(drop_n) == 0.0

    # on the (1, 1) mesh the layout is the whole tensor: the leaves stay
    # plain tensors, and the MoE takes its capacity body all the same
    rules = Rules(host_mesh)
    tp = _tensors(p)
    tp = tsteps.place_tree(tp, tsteps.resolve_shardings(
        rules, tmoe.moe_specs(cfg), tp))
    xt = rules.shard_input(torch.from_numpy(x), ("batch", None, None))
    assert not any(SL.is_dtensor(t) for t in [xt] + list(tp.values()))
    y, aux, drop = tmoe.moe_apply(tp, xt, cfg, rules=rules)
    assert float(drop) == PROBE_DROP
    scale = max(float(np.abs(np.asarray(y_r)).max()), 1.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r),
                               rtol=0, atol=MOE_RTOL * scale)
    assert abs(float(aux) - float(aux_r)) < AUX_ATOL
    # the fault the launcher had: without rules the oracle drops nothing
    # and its output is another function's
    y0, _, drop0 = tmoe.moe_apply(_tensors(p), torch.from_numpy(x), cfg)
    assert float(drop0) == 0.0
    np.testing.assert_allclose(y0.numpy(), np.asarray(y_n), rtol=0,
                               atol=MOE_RTOL * scale)
    assert float(np.abs(y0.numpy() - np.asarray(y_r)).max()) > \
        10 * MOE_RTOL * scale


def test_launcher_builds_rules_and_moe_takes_the_capacity_body(
        tmp_path, monkeypatch):
    calls = {"capacity": 0, "oracle": 0}
    body, oracle = tmoe._local_moe, tmoe._local_moe_nodist

    def counted(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f
    monkeypatch.setattr(tmoe, "_local_moe", counted("capacity", body))
    monkeypatch.setattr(tmoe, "_local_moe_nodist", counted("oracle", oracle))
    from repro_torch.launch import train as tlaunch
    stats = tlaunch.main(["--arch", ARCH, "--preset", "smoke", "--device",
                          "cpu", "--steps", "2", "--seq-len", "16",
                          "--batch", "2", "--ckpt-dir", str(tmp_path)])
    assert stats.steps == 2 and np.all(np.isfinite(stats.losses))
    assert calls["capacity"] > 0 and calls["oracle"] == 0


def test_k4_wrapper_refuses_a_dtensor(host_mesh):
    """K4 takes plain tensors: under rules the attention hands it each
    rank's local heads, and a DTensor is never taken silently."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import ops
    q = distribute_tensor(torch.zeros(2, 256, 64), host_mesh.device_mesh,
                          (Replicate(), Replicate()))
    with pytest.raises(TypeError, match="plain tensors"):
        ops.local_attn(q, q, q, window=64)
