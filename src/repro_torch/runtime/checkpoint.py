"""Zerrow-backed checkpointing: content-dedup tensor store + async save.

The checkpoint store applies the paper's ideas to training state across
*time* instead of across DAG nodes:

  * resharing-in-time — tensors are content-addressed (blake2 of bytes);
    a step-N checkpoint only writes tensors that changed since step M
    (e.g. frozen embeddings, optimizer `count`, data-pipeline state), the
    rest are references.  Exactly SIPC's reference-vs-copy decision, with
    hashing standing in for address-range inspection (we cannot inspect
    device memory identity across steps).
  * de-anonymization — host arrays fetched from the device are handed to
    the writer by reference (no host-side copy) before it flushes them
    to disk.
  * async save — a writer thread drains a queue; training continues.

This is the PyTorch port's copy of the JAX package's
``runtime/checkpoint.py``.  A snapshot is written in the JAX package's
layout, with the same manifest paths: ``save`` takes the port's train
state (``{"params": the model, "opt", "step"}``), fetches it to the host
once and writes it as the JAX train state pytree
(``models.convert.train_state_to_jax``: params stacked by layer group),
so either package restores the other's snapshots.  Any other pytree of
tensors or arrays is written leaf for leaf.  ``restore(like=...)`` puts
each leaf on the device of ``like``'s leaf, and loads a port train state
into ``like``'s model.  Resharding onto a mesh (``shardings=``) waits for
ROADMAP.md queue 1, item 8.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models import convert


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


class CheckpointStore:
    def __init__(self, root: str, *, async_io: bool = True):
        self.root = root
        os.makedirs(os.path.join(root, "blobs"), exist_ok=True)
        self.async_io = async_io
        self._q: "queue.Queue" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.stats = {"blobs_written": 0, "blobs_reused": 0,
                      "bytes_written": 0, "bytes_reused": 0}
        if async_io:
            self._writer = threading.Thread(target=self._drain, daemon=True)
            self._writer.start()

    # -- write path ---------------------------------------------------------
    def save(self, step: int, state) -> Dict[str, Any]:
        """Snapshot a port train state, or any pytree of tensors and
        arrays.  Returns the manifest (also written to disk).  With
        async_io the heavy writes happen on the writer thread."""
        manifest = {"step": step, "time": time.time(), "tensors": {}}
        for path, leaf in _leaf_paths(_to_host(state)):
            arr = np.asarray(leaf)
            h = hashlib.blake2b(arr.tobytes(), digest_size=16).hexdigest()
            blob = os.path.join(self.root, "blobs", h + ".npy")
            manifest["tensors"][path] = {
                "hash": h, "dtype": str(arr.dtype), "shape": list(arr.shape)}
            if os.path.exists(blob):
                self.stats["blobs_reused"] += 1    # resharing-in-time
                self.stats["bytes_reused"] += arr.nbytes
                continue
            self.stats["blobs_written"] += 1
            self.stats["bytes_written"] += arr.nbytes
            if self.async_io:
                self._q.put((blob, arr))
            else:
                self._write_blob(blob, arr)
        mpath = os.path.join(self.root, f"step-{step:08d}.json")
        if self.async_io:
            self._q.put((mpath, manifest))
        else:
            self._write_manifest(mpath, manifest)
        return manifest

    def _write_blob(self, path: str, arr: np.ndarray) -> None:
        tmp = path + ".tmp"
        np.save(tmp, arr, allow_pickle=False)
        os.replace(tmp + ".npy" if not tmp.endswith(".npy") else tmp, path)

    def _write_manifest(self, path: str, manifest: dict) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, path)

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                path, payload = item
                if isinstance(payload, dict):
                    self._write_manifest(path, payload)
                else:
                    self._write_blob(path, payload)
            except BaseException as e:        # surfaced on flush()
                self._error = e
            finally:
                self._q.task_done()

    def flush(self) -> None:
        if self.async_io:
            self._q.join()
        if self._error:
            raise self._error

    def close(self) -> None:
        self.flush()
        if self._writer is not None:
            self._q.put(None)
            self._writer.join(timeout=5)
            self._writer = None

    # -- read path ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = [int(f[5:13]) for f in os.listdir(self.root)
                 if f.startswith("step-") and f.endswith(".json")]
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None, *, like=None,
                shardings=None):
        """Load a snapshot.  ``like``: a pytree giving the structure (and
        the leaf order); each leaf comes back as a tensor on the device of
        ``like``'s tensor, or as a numpy array where ``like`` holds one.
        A port train state as ``like`` has its model's parameters
        overwritten with the snapshot's, in place, and the returned state
        holds that model.  Without ``like``: the flat {path: array} dict."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...): resharding onto a mesh comes with "
                "ROADMAP.md queue 1, item 8")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints in " + self.root)
        mpath = os.path.join(self.root, f"step-{step:08d}.json")
        with open(mpath) as f:
            manifest = json.load(f)

        flat = {}
        for path, meta in manifest["tensors"].items():
            blob = os.path.join(self.root, "blobs", meta["hash"] + ".npy")
            flat[path] = np.load(blob, allow_pickle=False)

        if like is None:
            return flat, manifest
        if _is_train_state(like):
            tree = convert.nest({path[1:]: a for path, a in flat.items()})
            return convert.train_state_from_jax(tree, like["params"]), \
                manifest
        return _unflatten(flat, like), manifest


def _is_train_state(tree) -> bool:
    return isinstance(tree, dict) and isinstance(tree.get("params"),
                                                 nn.Module)


def _to_host(state):
    """The pytree ``save`` writes: a port train state in the JAX layout,
    any other tensor fetched to the host."""
    if _is_train_state(state):
        return convert.train_state_to_jax(state)
    if isinstance(state, dict):
        return {k: _to_host(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_host(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True).numpy()
    return state


def _unflatten(flat: Dict[str, np.ndarray], like, prefix: str = ""):
    """``like``'s structure with the snapshot's leaves; each tensor leaf
    on the device of ``like``'s."""
    if isinstance(like, dict):
        return {k: _unflatten(flat, like[k], f"{prefix}/{k}")
                for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(flat, v, f"{prefix}/{i}")
                          for i, v in enumerate(like))
    if prefix not in flat:
        raise KeyError(f"{prefix}: not in the snapshot")
    arr = flat[prefix]
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(like.device)
    return arr
