"""Training input pipeline built ON Zerrow — the integration point between
the paper's system and the LM framework.

Per epoch, per shard:   loader node (zarquet -> Arrow, DeCache-shared)
                    [-> join+filter node against the corpus metadata
                        table when ``meta_path`` is set (the metadata
                        loader deserializes once for every shard DAG)]
                     -> pack node (tokenize + pack to a flat id column)
and per step a *zero-copy row-slice* of the packed column is reshared out
of the pipeline (paper Fig 6 'slice': no new bytes) and handed to the
trainer, which moves it to its device (``torch.from_numpy(...).to(dev)``
in ``launch/train.py``).  Multiple trainers / epochs / eval jobs reading the same
shard share one physical copy through the DeCache (paper Fig 5), and
intermediate memory is governed by the RM's admission + eviction.

Shards may also be *streams* (``zarquet.StreamWriter`` output, see
``make_text_stream``): each committed row group gets its own
load→[joinf]→pack DAG pinned with ``row_groups=(g,)``, so a shard that
grew since the last epoch recomputes only its new micro-batches' cones
while every old group fingerprint-hits the manifest.

This is the PyTorch port's own copy of the JAX package's
``data/pipeline.py``, over the port's Zerrow core: the code is the same,
and the fused join stage reaches the relational kernels through the
port's ``core.kdispatch`` (on the card unless ``kdispatch.set_device
("cpu")`` asked for the CPU; spawned Flight workers take the parent's
device).  Batches stay numpy, bit for bit the reference's.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..core import (BufferStore, DAG, NodeSpec, RMConfig,
                    ResourceManager, SipcReader, Table, Column,
                    make_executor)
from ..core import ops, zarquet

PAD = 0


def byte_tokenize(text_col: Column) -> np.ndarray:
    """Byte-level tokenizer: utf8 column -> flat int32 ids (+1 offset so 0
    stays PAD)."""
    lo, hi = int(text_col.offsets[0]), int(text_col.offsets[-1])
    return text_col.values[lo:hi].astype(np.int32) + 1


def pack_fn(tables: List[Table], batch: int, seq_len: int) -> Table:
    """Tokenize + pack one shard to a flat id column, truncated to whole
    (batch, seq_len+1) spans.  Module-level (not a bound method) so a
    ``functools.partial`` of it pickles across the Flight process
    boundary in ``workers_mode='process'``."""
    ids = byte_tokenize(tables[0].combine().batches[0].column("text"))
    span = batch * (seq_len + 1)
    n = (len(ids) // span) * span
    return Table.from_pydict({"ids": ids[:n]})


def _keep_mask(batch, col: str) -> np.ndarray:
    """Right-side mask for the fused corpus filter: metadata rows whose
    keep flag is nonzero.  Module-level so the partial pickles."""
    return batch.column(col).to_numpy() != 0


def join_filter_fn(tables: List[Table], on: str = "doc",
                   keep_col: str = "keep") -> Table:
    """The pipeline's join-shaped stage: inner-join a text shard
    (``tables[0]``) with the corpus metadata table (``tables[1]``) on the
    document id and keep only rows whose ``keep_col`` is nonzero — the
    metadata-driven corpus filter every curated training set runs.
    Runs as the *fused* ``ops.filter_join``: the keep mask composes into
    the join's build-side selection, so the filtered intermediate table
    is never materialized (one gather per payload column instead of
    two).  Metadata payloads (e.g. the dict-encoded ``lang``) ride
    through the join with their dictionaries reshared by reference.
    Module-level so a partial of it crosses the Flight process
    boundary."""
    return ops.filter_join(
        tables[0], tables[1], on=on, how="inner",
        right_mask=functools.partial(_keep_mask, col=keep_col))


#: ops.filter_join is reached through the ``ops`` module attribute, which
#: node fingerprints do not chase — declare it (it chains to its
#: relational vkernels, incl. filter_join_gather) so a join/kernel edit
#: invalidates cached 'joinf' outputs instead of serving stale tables
join_filter_fn.__fp_includes__ = (ops.filter_join, _keep_mask)


def _gen_text_table(rng, base: int, rows: int) -> Table:
    words = ["the", "quick", "brown", "fox", "jumps", "over", "lazy",
             "dog", "zero", "copy", "arrow", "pipeline", "kernel",
             "memory", "shared", "data"]
    texts = [" ".join(rng.choice(words, size=rng.integers(8, 24)))
             for _ in range(rows)]
    return Table.from_pydict({
        "doc": np.arange(base, base + rows, dtype=np.int64),
        "text": texts})


def make_text_shards(root: str, n_shards: int, rows_per_shard: int,
                     seed: int = 0) -> List[str]:
    """Synthetic corpus shards (zarquet files with 'doc' id + 'text'
    columns; doc ids are globally unique across shards so a metadata
    table written by ``make_doc_meta`` joins against every shard)."""
    rng = np.random.default_rng(seed)
    paths = []
    os.makedirs(root, exist_ok=True)
    for s in range(n_shards):
        t = _gen_text_table(rng, s * rows_per_shard, rows_per_shard)
        p = os.path.join(root, f"shard-{s:04d}.zq")
        zarquet.write_table(p, t)
        paths.append(p)
    return paths


def make_text_stream(root: str, n_batches: int, rows_per_batch: int,
                     seed: int = 0, base_doc: int = 0) -> str:
    """Synthetic *streaming* corpus shard: the same 'doc'+'text' schema
    as ``make_text_shards``, but committed as ``n_batches`` row groups
    through ``zarquet.StreamWriter`` — the shape an ingest frontier
    produces.  Append more micro-batches later by reopening the path
    with ``StreamWriter``; the pipeline recomputes only the new groups'
    cones."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    p = os.path.join(root, "stream-shard.zq")
    with zarquet.StreamWriter(p) as w:
        for b in range(n_batches):
            w.ingest(_gen_text_table(rng, base_doc + b * rows_per_batch,
                                     rows_per_batch))
            w.flush()
    return p


def make_doc_meta(root: str, n_docs: int, keep_frac: float = 0.75,
                  seed: int = 1) -> str:
    """Write the corpus metadata table (doc id, keep flag, language tag)
    the join-shaped pipeline stage filters against.  ``lang`` is low-
    cardinality on purpose: loaded with ``dict_columns=('lang',)`` its
    dictionary reshares through every per-shard join."""
    rng = np.random.default_rng(seed)
    langs = np.array(["en", "de", "fr", "ja"])
    t = Table.from_pydict({
        "doc": np.arange(n_docs, dtype=np.int64),
        "keep": (rng.random(n_docs) < keep_frac).astype(np.int64),
        "lang": list(langs[rng.integers(0, len(langs), size=n_docs)]),
    })
    os.makedirs(root, exist_ok=True)
    p = os.path.join(root, "meta.zq")
    zarquet.write_table(p, t)
    return p


@dataclass
class PipelineConfig:
    batch: int = 8
    seq_len: int = 256
    memory_limit: Optional[int] = None
    vocab: int = 257            # bytes + PAD
    workers: int = 1            # sched worker-pool size: >1 overlaps shard
    #                           # decompression across loader nodes
    reader_threads: Optional[int] = None   # per-shard zarquet reader pool:
    #                                      # column-chunk decompression
    #                                      # fan-out inside one load (None =
    #                                      # auto; 1 = serial)
    workers_mode: str = "thread"   # 'process': loader + pack run in
    #                              # spawned OS processes over the Flight
    #                              # data plane (compute scales past the
    #                              # GIL; store becomes file-backed)
    cache_root: Optional[str] = None   # persistent content-addressed cache
    #                                  # dir: re-runs adopt unchanged
    #                                  # shards' load/pack outputs from the
    #                                  # manifest instead of recomputing
    #                                  # (store becomes durable/file-backed)
    meta_path: Optional[str] = None    # corpus metadata table (see
    #                                  # make_doc_meta): adds a join-shaped
    #                                  # stage per shard — inner-join on
    #                                  # 'doc', keep rows with keep != 0 —
    #                                  # before packing; the metadata
    #                                  # loader is DeCache-shared across
    #                                  # every shard DAG


class ZerrowDataPipeline:
    """Iterator of {tokens, labels} numpy batches, Zerrow underneath."""

    def __init__(self, shard_paths: List[str], cfg: PipelineConfig,
                 store: Optional[BufferStore] = None,
                 rm: Optional[ResourceManager] = None):
        self.paths = list(shard_paths)
        self.cfg = cfg
        backing = ("file" if cfg.workers_mode == "process" or cfg.cache_root
                   else "ram")
        self.store = store or BufferStore(backing=backing,
                                          root=cfg.cache_root)
        self.rm = rm or ResourceManager(
            self.store, RMConfig(memory_limit=cfg.memory_limit,
                                 policy="adaptive",
                                 workers=cfg.workers,
                                 workers_mode=cfg.workers_mode,
                                 reader_threads=cfg.reader_threads,
                                 cache_root=cfg.cache_root))
        self.ex = make_executor(self.store, self.rm, workers=cfg.workers)
        self._owned_msgs: List = []

    # -- one shard -> packed ids message -----------------------------------
    def _pack_fn(self) -> "functools.partial[Table]":
        return functools.partial(pack_fn, batch=self.cfg.batch,
                                 seq_len=self.cfg.seq_len)

    def _shard_groups(self, path: str) -> Optional[int]:
        """Committed row-group count of a *stream* shard, None for batch
        shards (``write_table`` output)."""
        groups = zarquet.read_footer(path).get("groups")
        return None if groups is None else len(groups)

    def _run_shards(self, paths: List[str]) -> List:
        """One DAG per shard, submitted together: with ``workers > 1`` the
        loader decompressions overlap in the executor's worker pool.
        With ``meta_path`` each DAG grows a metadata loader (one DeCache-
        shared deserialization for all shards) and a join+filter stage
        between load and pack.

        A *stream* shard (``StreamWriter`` output) becomes one DAG per
        committed row group, each loader pinned with ``row_groups=(g,)``:
        packing is per-micro-batch, and because committed groups'
        content hashes never change, re-running after an append
        fingerprint-hits every old group's load→[joinf]→pack cone and
        recomputes only the new tail (with ``cache_root`` set)."""
        dags = []
        fn = self._pack_fn()
        meta = self.cfg.meta_path
        for path in paths:
            n_groups = self._shard_groups(path)
            size = os.path.getsize(path)
            est = max(size * 8 // (n_groups or 1), 1 << 20)
            # projection pruning (same loader knob core/plan's optimizer
            # targets): without the metadata join only 'text' is ever
            # read, so the 'doc' id column is never decoded; the join
            # needs the id, so the meta path loads the full shard
            cols = None if meta else ("text",)
            units = [None] if n_groups is None else \
                [(g,) for g in range(n_groups)]
            for rg in units:
                nodes = [NodeSpec("load", source=path, est_mem=est,
                                  columns=cols, row_groups=rg)]
                pack_dep = "load"
                if meta:
                    nodes.append(NodeSpec(
                        "meta", source=meta, dict_columns=("lang",),
                        est_mem=max(os.path.getsize(meta) * 8, 1 << 20)))
                    nodes.append(NodeSpec(
                        "joinf", fn=join_filter_fn,
                        deps=["load", "meta"], est_mem=est))
                    pack_dep = "joinf"
                nodes.append(NodeSpec("pack", fn=fn, deps=[pack_dep],
                                      est_mem=est // 2, keep_output=True))
                tag = "" if rg is None else f"@g{rg[0]}"
                dags.append(DAG(nodes,
                                name=f"pipe-{os.path.basename(path)}{tag}"))
        self.ex.run(dags)
        # keep_output=True: the packed messages survive DAG completion;
        # we own their release
        msgs = [d.nodes["pack"].output for d in dags]
        self._owned_msgs.extend(msgs)
        return msgs

    # -- batches ---------------------------------------------------------------
    def batches(self, epochs: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        B, S = self.cfg.batch, self.cfg.seq_len
        span = B * (S + 1)
        group = max(1, self.cfg.workers)
        for _ in range(epochs):
            for g in range(0, len(self.paths), group):
                # NOTE: loader output is DeCache-shared; epoch 2+ and any
                # concurrent consumer reuse the same physical Arrow data
                for msg in self._run_shards(self.paths[g:g + group]):
                    reader = SipcReader(self.store)
                    packed = reader.read_table(msg)
                    col = packed.combine().batches[0].column("ids")
                    n = col.length
                    for i in range(n // span):
                        # zero-copy slice (reshared view of the packed
                        # buffer)
                        window = col.slice(i * span, (i + 1) * span)
                        arr = window.values.reshape(B, S + 1)
                        yield {"tokens": np.ascontiguousarray(arr[:, :-1]),
                               "labels": np.ascontiguousarray(arr[:, 1:])}
                    msg.release()
                    self._owned_msgs.remove(msg)
                    for fid in list(msg.files_referenced()):
                        f = self.store.files.get(fid)
                        if f is not None and f.refcount == 0 \
                                and not f.decache_pinned:
                            self.store.delete_file(fid)

    def stats(self) -> dict:
        return {"decache_hits": self.rm.decache.hits,
                "loads": self.ex.load_runs,
                "cache_hits": self.ex.cache_hits,
                **self.rm.cache_stats,
                **self.store.stats.snapshot()}

    def close(self) -> None:
        self.ex.close()
        self.store.close()
