"""The port stands alone: ``repro_torch`` imports neither ``jax`` nor the
reference package ``repro``, and its entry points default to the CUDA card
and raise where there is none (never dropping to the CPU on their own)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api as TA  # noqa: E402
from repro_torch.core import entities as TE  # noqa: E402

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def test_import_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.api, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.build, repro_torch.kernels.ref\n"
        "import repro_torch.balance, repro_torch.quality, repro_torch.data\n"
        "import repro_torch.core.keys, repro_torch.stream, repro_torch.perf\n"
        "import repro_torch.resilience.checkpoint\n"
        "import repro_torch.resilience.faults\n"
        "import repro_torch.obs, repro_torch.serve\n"
        "import repro_torch.launch, repro_torch.launch.mesh\n"
        "import repro_torch.perf.cache, repro_torch.core.collectives\n"
        "import repro_torch.configs, repro_torch.configs.gemma2_9b\n"
        "import repro_torch.models, repro_torch.models.lm\n"
        "import repro_torch.models.convert, repro_torch.train\n"
        "import repro_torch.train.steps, repro_torch.train.optim\n"
        "import repro_torch.train.checkpoint, repro_torch.train.loop\n"
        "import repro_torch.launch.train\n"
        "import repro_torch.sharding, repro_torch.sharding.rules\n"
        "import repro_torch.sharding.local\n"
        "import repro_torch.launch.dryrun, repro_torch.perf.trace_analysis\n"
        "import repro_torch.core.pipeline\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


FAKE_PG = "torch.testing._internal.distributed.fake_pg"


def test_fake_pg_only_inside_dryrun():
    """torch's private fake process group is imported by one module, the
    dry run, and there only inside its functions (never at import)."""
    importers = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        top = {id(n) for n in tree.body}
        for node in ast.walk(tree):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            if any(n.startswith(FAKE_PG) for n in names):
                importers.append((str(path.relative_to(PKG)),
                                  id(node) in top))
    assert importers and all(p == "launch/dryrun.py" and not at_top
                             for p, at_top in importers), importers
    code = ("import sys, repro_torch.launch.dryrun\n"
            f"print({FAKE_PG!r} in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "False", out.stdout


def test_chip_smoke_imports_no_jax_or_reference():
    smoke = PKG.parents[1] / "chip_smoke.py"
    for mod in _imported_modules(smoke):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


def _ents():
    return TE.synth_entities(np.random.default_rng(0), 40, n_keys=8)


def test_entry_points_default_to_cuda_and_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = TA.ERConfig(window=3, num_shards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.resolve(_ents(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.link(_ents(), _ents(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.VmapRunner(2).run_raw(_ents(), np.array([3], np.int32), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.ShardMapRunner()
    # the explicit CPU request runs
    res = TA.resolve(_ents(), cfg, device="cpu")
    assert res.blocking.pairs


def test_lm_entry_points_default_to_cuda_and_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import lm
    cfg = smoke_variant(get_config("gemma2-9b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.lm_init(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.cache_init(cfg, 1, 8)
    params = lm.lm_init(0, cfg, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.forward(params, cfg, tokens=toks)
    # the explicit CPU request runs
    logits, _, _ = lm.forward(params, cfg, tokens=toks, device="cpu")
    assert logits.shape == (1, 8, cfg.vocab_size)


def test_train_entry_points_default_to_cuda_and_raise_without_card(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch import train as launch
    from repro_torch.train import steps
    from repro_torch.train.checkpoint import Checkpointer
    cfg = smoke_variant(get_config("phi4-mini-3.8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.train_state_init(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--ckpt-dir", str(tmp_path)])
    state = steps.train_state_init(0, cfg, device="cpu")
    ck = Checkpointer(tmp_path)
    ck.save(1, state)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.restore(1, state)
    # the explicit CPU request runs
    assert ck.restore(1, state, device="cpu")["opt"]["step"].dtype == \
        torch.int32


def test_kernel_wrapper_raises_for_non_cpu_non_cuda_tensors():
    from repro_torch.kernels import ops
    feat = torch.zeros((1, 4, 2), device="meta")
    sig = torch.zeros((1, 4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.fused_cheap_band(feat, sig, window=2, w_cos=1.0, w_jac=1.0)
