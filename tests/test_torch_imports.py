"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro``."""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "src", "repro_torch")
SUBPACKAGES = ["baselines", "checkpoint", "compute", "configs", "core",
               "data", "dist", "ft", "io", "kernels", "launch", "models",
               "obs", "plan", "runtime", "serve", "store", "train"]
# `import jax…`, `from jax…`, `import repro`/`repro.x`, `from repro.x` — but
# never `repro_torch`
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))",
    re.MULTILINE)


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_graph_has_no_jax_and_no_repro():
    modules = ["repro_torch"] + [f"repro_torch.{s}" for s in SUBPACKAGES]
    modules += ["repro_torch.core.index", "repro_torch.core.join",
                "repro_torch.core.bipartite", "repro_torch.io.prefetcher",
                "repro_torch.store.striped_store",
                "repro_torch.plan.cost_model", "repro_torch.plan.estimator",
                "repro_torch.plan.planner",
                "repro_torch.kernels._build", "repro_torch.device",
                "repro_torch.kernels.flash_attention",
                "repro_torch.models.convert", "repro_torch.models.moe",
                "repro_torch.models.ssm", "repro_torch.models.rglru",
                "repro_torch.models.encdec", "repro_torch.serve.engine",
                "repro_torch.serve.scheduler",
                "repro_torch.serve.query_service",
                "repro_torch.serve.replica", "repro_torch.serve.router",
                "repro_torch.ft.atomic", "repro_torch.ft.phases",
                "repro_torch.ft.fault", "repro_torch.obs.metrics",
                "repro_torch.obs.export", "repro_torch.obs.live",
                "repro_torch.obs.dash", "repro_torch.obs.webhook",
                "repro_torch.core.distributed", "repro_torch.ft.join_ckpt",
                "repro_torch.data.dedup", "repro_torch.data.pipeline",
                "repro_torch.checkpoint.checkpoint",
                "repro_torch.train.optimizer",
                "repro_torch.train.grad_compress",
                "repro_torch.train.train_loop", "repro_torch.launch.steps",
                "repro_torch.launch.train", "repro_torch.launch.roofline",
                "repro_torch.launch.op_cost", "repro_torch.launch.census",
                "repro_torch.launch.census_join",
                "repro_torch.launch.mesh", "repro_torch.dist.sharding",
                "repro_torch.dist.pipeline", "repro_torch.models.moe_a2a",
                "repro_torch.launch.dryrun", "repro_torch.launch.dryrun_join",
                "repro_torch.launch.collectives",
                "repro_torch.dist.tensor_parallel"]
    code = ("import sys, importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "", out.stdout


def test_sources_never_import_jax_or_repro():
    files = _port_sources()
    assert len(files) > 20 and any(f.endswith("chip_smoke.py") for f in files)
    for path in files:
        with open(path) as f:
            src = f.read()
        hits = FORBIDDEN.findall(src)
        assert not hits, f"{path}: {hits}"


@pytest.mark.parametrize("line,bad", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("from jax import numpy", True), ("    from repro.core import x", True),
    ("import repro.kernels", True), ("import repro", True),
    ("from repro_torch.core import x", False), ("import repro_torch", False),
    ("import jaxlib_like_name", False), ("# from repro.core import", False),
])
def test_forbidden_pattern(line, bad):
    assert bool(FORBIDDEN.search(line)) == bad


def test_fake_backend_only_in_the_dry_run():
    """torch's fake process group, in which no collective moves data, is
    joined by the dry-run alone (``launch/dryrun.py`` through
    ``ensure_world``); ``launch/mesh.py`` defines it."""
    users = set()
    for path in _port_sources():
        with open(path) as f:
            src = f.read()
        if "init_fake_world(" in src or '"fake"' in src:
            users.add(os.path.relpath(path, ROOT))
    assert users == {os.path.join("src", "repro_torch", "launch", f)
                     for f in ("mesh.py", "dryrun.py")}, users
