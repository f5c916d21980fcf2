"""Production mesh construction on ``torch.distributed``: the JAX
package's ``launch/mesh.py``, built by ``init_device_mesh``.

  single-pod: (16, 16)        ("data", "model")        = 256 ranks
  multi-pod:  (2, 16, 16)     ("pod", "data", "model") = 512 ranks

One rank drives one card; NCCL puts no two ranks on one card, so a node
of N cards runs N ranks (``torchrun --nproc_per_node=N``), and one card
gives world size 1.  The process group must be up before a mesh is made
(``init_distributed``); a mesh whose size is not the world size raises.
Meshes are on CUDA unless the caller passes ``device="cpu"`` (gloo
ranks, as the tests run).
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from .. import resolve_device


def init_distributed(device="cuda", *, timeout_s: float = 600.0
                     ) -> Tuple[int, int]:
    """Join the process group that ``torchrun`` (or the caller) describes
    in the environment: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT.  NCCL on CUDA, with this rank's card set to LOCAL_RANK;
    gloo on the CPU.  Returns (rank, world size)."""
    dev = resolve_device(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
              device="cuda"):
    """A mesh of ``shape`` with axes ``names`` over the whole world."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the world has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def mesh_for_shape(devices: int, *, model_parallel: int = 0
                   ) -> Tuple[int, int]:
    """The (data, model) shape ``make_mesh_for`` builds."""
    mp = model_parallel or max(1, min(4, devices))
    while devices % mp:
        mp -= 1
    return devices // mp, mp


def make_mesh_for(devices: int, *, model_parallel: int = 0, device="cuda"):
    """Best-effort ("data", "model") mesh for an arbitrary rank count
    (tests, smoke)."""
    return make_mesh(mesh_for_shape(devices, model_parallel=model_parallel),
                     ("data", "model"), device)


MESH_NAMES = ("single", "multi")


def make_named_mesh(name: str, device="cuda"):
    assert name in MESH_NAMES, name
    return make_production_mesh(multi_pod=(name == "multi"), device=device)
