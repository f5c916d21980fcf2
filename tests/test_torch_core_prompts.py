"""The port's Zerrow prompt source against the JAX package's, on the CPU.

``ZerrowPromptSource`` reads zarquet prompt shards through a Zerrow DAG
per shard (a load and a pass-through node whose buffers are all
reshared), in thread mode and through spawned Flight workers, and yields
the same byte-tokenized prompt arrays, in the same batches, as the JAX
package's; the serve launcher serves them end to end.
"""

import os

import numpy as np
import pytest

from repro.serve import engine as r_engine
from repro_torch.core import kdispatch
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve as t_serve
from repro_torch.serve import engine as t_engine


@pytest.fixture(autouse=True)
def cpu_kernels():
    with kdispatch.using_device("cpu"):
        yield


def prompts(engine, paths, mode, batch=5, max_prompt_len=None):
    src = engine.ZerrowPromptSource(paths, batch=batch, max_new=3,
                                    workers=2, workers_mode=mode,
                                    max_prompt_len=max_prompt_len)
    try:
        out = [[(r.prompt.dtype.str, r.prompt.tobytes(), r.max_new)
                for r in reqs] for reqs in src.batches()]
        return out, src.missed_shards
    finally:
        src.close()


def test_shards_are_the_same_files(tmp_path):
    a = t_engine.make_prompt_shards(str(tmp_path / "port"), 3, 7, seed=4)
    b = r_engine.make_prompt_shards(str(tmp_path / "ref"), 3, 7, seed=4)
    assert [os.path.basename(p) for p in a] == \
        [os.path.basename(p) for p in b]
    for x, y in zip(a, b):
        with open(x, "rb") as fx, open(y, "rb") as fy:
            assert fx.read() == fy.read()


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_prompt_batches_match_reference(tmp_path, mode):
    paths = r_engine.make_prompt_shards(str(tmp_path / "shards"), 3, 11)
    got = prompts(t_engine, paths, mode)
    want = prompts(r_engine, paths, mode)
    assert got == want
    batches, missed = got
    assert missed == 0 and sum(len(b) for b in batches) == 33
    assert [len(b) for b in batches] == [5] * 6 + [3]


def test_prompts_are_the_byte_tokenized_texts(tmp_path):
    from repro_torch.core import zarquet
    paths = t_engine.make_prompt_shards(str(tmp_path), 2, 6)
    texts = [t for p in paths for t in zarquet.read_table(p)
             .to_pydict()["text"]]
    (batches, _), = [prompts(t_engine, paths, "thread", batch=4,
                             max_prompt_len=20)]
    got = [np.frombuffer(b, np.dtype(dt)) for reqs in batches
           for dt, b, _ in reqs]
    want = [(np.frombuffer(t.encode(), np.uint8).astype(np.int32) + 1)[:20]
            for t in texts]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_launcher_serves_prompt_shards_on_cpu(tmp_path, monkeypatch, mode,
                                              capsys):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    engine = t_serve.main(["--smoke", "--device", "cpu", "--prompt-shards",
                           "2", "--prompts-per-shard", "6", "--batch", "4",
                           "--max-seq", "64", "--max-new", "3",
                           "--rounds", "3", "--workers", "2",
                           "--workers-mode", mode])
    out = capsys.readouterr().out
    assert out.count("round ") == 3
    assert engine.stats["decode_steps"] == 9
    assert all(v == 0 for v in kops.launch_counts.values())   # CPU: plain
    assert os.path.isdir(tmp_path / "zerrow-prompts")
