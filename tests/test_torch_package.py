"""The port stands alone: nothing in src/repro_torch or chip_smoke.py
imports jax or the JAX package, serving the smoke config loads neither,
and the port's config copies equal the JAX package's field for field."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_serving_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "from repro_torch.launch import serve\n"
        "serve.main(['--smoke', '--device', 'cpu', '--rounds', '1',\n"
        "            '--batch', '2', '--max-new', '2'])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_configs_equal_the_jax_package():
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    for name, cfg in configs.ARCHS.items():
        want = jconfigs.ARCHS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want), name
        assert dataclasses.asdict(configs.smoke_variant(cfg)) == \
            dataclasses.asdict(jconfigs.smoke_variant(want)), name
        assert cfg.hd == want.hd and cfg.param_count() == \
            want.param_count(), name
    assert [dataclasses.asdict(s) for s in configs.SHAPES] == \
        [dataclasses.asdict(s) for s in jconfigs.SHAPES]
