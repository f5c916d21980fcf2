"""Recompute roofline reports from saved dry-run counts without running
the step again (when the report itself changes): the JAX package's
``launch/reanalyze.py``, reading ``counts.json`` where JAX reads its HLO.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze [dir ...]

Each cell directory (``runs/dryrun/<arch>--<shape>--<mesh>/``) holds the
``meta.json`` and ``counts.json`` that ``launch/dryrun.py`` saved; the
configs come from ``meta.json`` (a smoke variant or a cut shape as it
ran), mp and dp from its saved mesh shape (16 and 16, or 16 and 32, on
the production meshes, where JAX fixes mp at 16).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict

from ..configs.base import ArchConfig, ShapeConfig
from . import roofline as rl


def report(meta: Dict, record: Dict) -> Dict:
    """The roofline report of a saved cell."""
    cfg = dict(meta["arch_config"])
    cfg["block_pattern"] = tuple(cfg.get("block_pattern") or ())
    arch = ArchConfig(**cfg)
    shape = ShapeConfig(**meta["shape_config"])
    sizes = meta["mesh_shape"]
    return rl.roofline_report(
        record, chips=meta["chips"], arch=arch, shape=shape,
        n_params=meta["params"], n_active=meta["active_params"],
        mp=sizes.get("model", 1),
        dp=sizes.get("data", 1) * sizes.get("pod", 1),
        accum=meta.get("accum", 1))


def reanalyze_dir(root: Path) -> None:
    for d in sorted(root.iterdir()):
        meta_p, counts_p = d / "meta.json", d / "counts.json"
        if not (meta_p.exists() and counts_p.exists()):
            continue
        info = json.loads(meta_p.read_text())
        roof = report(info, json.loads(counts_p.read_text()))
        info["roofline"] = roof
        meta_p.write_text(json.dumps(info, indent=1, default=float))
        print(f"{d.name}: {roof['dominant']}-bound "
              f"c={roof['compute_s']*1e3:.3f}ms "
              f"m={roof['memory_s']*1e3:.3f}ms "
              f"x={roof['collective_s']*1e3:.3f}ms "
              f"frac={roof['roofline_fraction']:.3f}")


def main(argv=None) -> None:
    from .dryrun import RUNS
    dirs = [Path(p) for p in (sys.argv[1:] if argv is None else argv)] \
        or [RUNS]
    for d in dirs:
        reanalyze_dir(d)


if __name__ == "__main__":
    main()
