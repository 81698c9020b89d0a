"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def test_port_files_exist():
    assert len(PORT_FILES) >= 12
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_reference(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_slice_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.models.kmeans, repro_torch.streaming.engine\n"
        "import repro_torch.pilot.backends.torchdevice, repro_torch.kernels._build\n"
        "import repro_torch.launch.serve, repro_torch.models.model\n"
        "import repro_torch.models.ssm, repro_torch.kernels.ssd_scan.ops\n"
        "import repro_torch.kernels.ssd_scan.ref, repro_torch.configs.mamba2_130m\n"
        "import repro_torch.sim.des, repro_torch.pilot.backends.serverless\n"
        "import repro_torch.pilot.backends.hpcsim, repro_torch.streaming.producer\n"
        "import repro_torch.streaming.faults, repro_torch.core.miniapp\n"
        "import repro_torch.sim.batched, repro_torch.core.whatif\n"
        "import repro_torch.pilot.backends.federated, repro_torch.kernels.lockstep_scan.ops\n"
        "import repro_torch.models.rglru, repro_torch.models.moe\n"
        "import repro_torch.configs.recurrentgemma_2b, repro_torch.configs.qwen3_moe_235b_a22b\n"
        "import repro_torch.configs.granite_moe_3b_a800m\n"
        "import repro_torch.data.pipeline, repro_torch.training.optimizer\n"
        "import repro_torch.training.train_loop, repro_torch.training.checkpoint\n"
        "import repro_torch.launch.steps, repro_torch.launch.train\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "from repro_torch.configs.base import list_configs\n"
        "assert len(list_configs()) == 10\n"
        "from repro_torch.pilot.api import PilotComputeService, PilotDescription\n"
        "pcs = PilotComputeService(seed=0)\n"
        "for url in ('torch://', 'serverless://aws-sim', 'hpc://wrangler-sim'):\n"
        "    pcs.submit_pilot(PilotDescription(resource=url, attrs={'device': 'cpu'}))\n"
        "pcs.submit_pilot(PilotDescription(resource='federated://mix', attrs={'federation':\n"
        "    {'members': [{'machine': 'serverless'}, {'machine': 'wrangler'}]}}))\n"
        "from repro_torch.core.miniapp import StreamExperiment, run_experiment\n"
        "assert run_experiment(StreamExperiment(n_messages=8)).processed == 8\n"
        "from repro_torch.core.miniapp import AdaptationExperiment, run_plan\n"
        "exp = AdaptationExperiment(scaling_policy='reactive', horizon_s=20.0)\n"
        "assert run_plan(exp).fast_path\n"
        "from repro_torch.configs.base import get_config\n"
        "from repro_torch.launch.train import train\n"
        "res = train(get_config('qwen2-0.5b', reduced=True), steps=2, batch=2, seq=8,\n"
        "            device='cpu', log=lambda line: None)\n"
        "assert len(res.losses) == 2\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    _run_clean(code)


def _run_clean(code: str) -> None:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"


def test_what_the_pool_workers_import_loads_no_jax():
    """A pooled sweep's workers re-import ``core.streaminsight`` (and the
    launcher is the main module they re-import): neither may pull in
    ``jax`` or the JAX package."""
    _run_clean(
        "import sys\n"
        "import repro_torch.core.streaminsight, repro_torch.launch.characterize\n"
        "import repro_torch.pilot.backends.local\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
