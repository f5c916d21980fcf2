"""The port's training input pipeline (``repro_torch.data.pipeline``)
against the JAX package's, on the CPU.

The same synthetic corpus files go through both ``ZerrowDataPipeline``s:
every {tokens, labels} batch must be equal bit for bit, in thread mode,
through spawned Flight workers, with the metadata join (the port's runs
its hash and gather kernels' plain versions), over a streaming shard of
row groups, and on a re-run against a persistent cache, where nothing is
loaded again.
"""

import os

import pytest

from repro.data import pipeline as r_pipe
from repro_torch.core import kdispatch
from repro_torch.data import pipeline as t_pipe

PKGS = {"repro": r_pipe, "repro_torch": t_pipe}


@pytest.fixture(autouse=True)
def cpu_kernels():
    with kdispatch.using_device("cpu"):
        yield


def run(pipe_mod, paths, **cfg):
    """Every batch of one epoch as (dtype, shape, bytes) per key, and the
    pipeline's stats."""
    pipe = pipe_mod.ZerrowDataPipeline(
        paths, pipe_mod.PipelineConfig(batch=2, seq_len=24, **cfg))
    try:
        out = [{k: (v.dtype.str, v.shape, v.tobytes())
                for k, v in sorted(b.items())} for b in pipe.batches()]
        return out, pipe.stats()
    finally:
        pipe.close()


@pytest.fixture()
def corpus(tmp_path):
    d = str(tmp_path / "corpus")
    shards = r_pipe.make_text_shards(d, n_shards=3, rows_per_shard=300,
                                     seed=2)
    return d, shards, r_pipe.make_doc_meta(d, n_docs=900, keep_frac=0.6,
                                           seed=3)


def test_corpus_files_are_the_same(tmp_path):
    for name, mod in PKGS.items():
        d = str(tmp_path / name)
        mod.make_text_shards(d, n_shards=2, rows_per_shard=50, seed=5)
        mod.make_doc_meta(d, n_docs=100, seed=6)
        mod.make_text_stream(d, n_batches=3, rows_per_batch=20, seed=7)
    names = sorted(os.listdir(tmp_path / "repro"))
    assert names == sorted(os.listdir(tmp_path / "repro_torch"))
    assert {"shard-0000.zq", "shard-0001.zq", "meta.zq",
            "stream-shard.zq"} <= set(names)
    for n in names:
        assert (tmp_path / "repro" / n).read_bytes() == \
            (tmp_path / "repro_torch" / n).read_bytes(), n


@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_thread_batches_match_reference(corpus, meta):
    _, shards, meta_path = corpus
    kw = dict(workers=2, meta_path=meta_path if meta else None)
    got, gstats = run(t_pipe, shards, **kw)
    want, wstats = run(r_pipe, shards, **kw)
    assert got == want and len(got) > 0
    assert gstats["loads"] == wstats["loads"] == len(shards) + meta


def test_metadata_join_drops_the_filtered_docs(corpus):
    _, shards, meta_path = corpus
    full, _ = run(t_pipe, shards)
    kept, _ = run(t_pipe, shards, meta_path=meta_path)
    # keep_frac 0.6 over documents of 8-24 words: about 0.6 of the tokens
    assert 0.45 < len(kept) / len(full) < 0.75


def test_stream_shard_row_groups_match_reference(tmp_path, corpus):
    _, _, meta_path = corpus
    stream = t_pipe.make_text_stream(str(tmp_path / "stream"), n_batches=4,
                                     rows_per_batch=80, seed=9)
    for meta in (None, meta_path):
        got, gstats = run(t_pipe, [stream], meta_path=meta)
        want, _ = run(r_pipe, [stream], meta_path=meta)
        assert got == want and len(got) > 0
        # one DAG a committed row group, each with its own loader
        assert gstats["loads"] == 4 + (meta is not None)


def test_cache_root_rerun_loads_nothing(tmp_path, corpus):
    _, shards, meta_path = corpus
    out = {}
    for name, mod in PKGS.items():
        root = str(tmp_path / f"cache-{name}")
        first, s1 = run(mod, shards, meta_path=meta_path, cache_root=root)
        again, s2 = run(mod, shards, meta_path=meta_path, cache_root=root)
        assert again == first
        assert s1["loads"] > 0 and s2["loads"] == 0, name
        out[name] = first
    assert out["repro_torch"] == out["repro"]


def test_process_batches_match_reference(corpus):
    _, shards, meta_path = corpus
    kw = dict(workers=2, meta_path=meta_path)
    got, _ = run(t_pipe, shards, workers_mode="process", **kw)
    want, _ = run(r_pipe, shards, workers_mode="process", **kw)
    thread, _ = run(t_pipe, shards, **kw)
    assert got == want == thread and len(got) > 0
