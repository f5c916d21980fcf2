"""The port's int8 gradient compression (``runtime/compression.py``)
against the JAX package's: ``quantize_int8`` bit for bit; 20 rounds of
``compress_grads_allreduce`` over 2 gloo CPU ranks against
``compress_grads_psum(n_pods=2)`` under ``shard_map`` on 2 host devices
(a subprocess, as ``tests/test_integration.py`` runs its meshes), the
same codes and float32 values to the rounding XLA adds (``RES_ULPS``); the
JAX test's bounded-error property; and the compressed train step on 4
ranks, a (2, 1, 2) ("pod", "data", "model") mesh, against the JAX
compressed step on 4 host devices, with its int8 codes and scales held
bit for bit to a plain recomputation from the grads it captured.

The JAX compressed step fails on the installed jax under DEFAULT_RULES:
its model constrains activations to ("pod", "data") inside a
``shard_map`` manual over "pod" (ROADMAP.md queue 3, item v).  So it
runs here with "batch" mapped to "data" alone, which is what the port's
rules give on a pod's ("data", "model") sub-mesh."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import sharded_ref as ref  # noqa: E402
import torch_ranks  # noqa: E402
from repro.runtime import compression as jcompression  # noqa: E402
from repro_torch.models.convert import flatten_paths  # noqa: E402
from repro_torch.runtime import compression  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SHAPES = {"w": (64, 48), "b": (48,), "e": (33, 7)}
ROUNDS = 20
#: The JAX reference is compiled: XLA turns its division by the constant
#: qmax into a multiply by the reciprocal (the scale up to 1.5 ulp off the
#: IEEE quotient, which the port computes) and fuses the residual's
#: g - q * scale into one multiply-add.  The codes agree; the synced
#: values differ by the scale's rounding (at most 1.5 ulp measured), and
#: the residuals, which carry the difference from round to round, by at
#: most 6.8 ulps of the largest grad over 20 rounds (measured).
RES_ULPS = 16


def _jax_subprocess(code: str, devices: int, out: str):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), os.path.dirname(__file__)]))
    r = subprocess.run([sys.executable, "-c", code, out], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]


def test_quantize_int8_is_bit_for_bit():
    rng = np.random.default_rng(0)
    for scale in (1e-6, 1e-3, 1.0, 1e4):
        x = (rng.normal(size=(257, 19)) * scale).astype(np.float32)
        x[0, :3] = 0.0
        for arr in (x, np.zeros_like(x)):
            jq, js = jcompression.quantize_int8(jnp.asarray(arr))
            q, s = compression.quantize_int8(torch.from_numpy(arr))
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            assert s.dtype == torch.float32
            assert np.float32(s.item()).tobytes() == \
                np.asarray(js, np.float32).tobytes()
            np.testing.assert_array_equal(
                compression.dequantize_int8(q, s).numpy(),
                np.asarray(jcompression.dequantize_int8(jq, js)))


JAX_ROUNDS = r"""
import sys
import numpy as np, jax
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.runtime.compression import compress_grads_psum, init_residual
data = np.load(sys.argv[1] + ".in.npz")
grads = {k: jax.numpy.asarray(data[k]) for k in data.files}   # (2, ...)
res = init_residual(grads)
mesh = make_mesh((2,), ("pod",))
f = jax.jit(shard_map(lambda g, r: compress_grads_psum(g, r, "pod",
                                                       n_pods=2),
                      mesh=mesh, in_specs=(P("pod"), P("pod")),
                      out_specs=(P("pod"), P("pod")), check_vma=False))
out = {}
for i in range(%d):
    synced, res = f(grads, res)
    for k in grads:
        out[f"synced/{i}/{k}"] = np.asarray(synced[k])
        out[f"res/{i}/{k}"] = np.asarray(res[k])
np.savez(sys.argv[1], **out)
"""


def test_twenty_rounds_over_two_ranks_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-4, 1))
              .astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(2)]
    out = str(tmp_path / "rounds")
    np.savez(out + ".in.npz", **{k: np.stack([g[k] for g in grads])
                                 for k in SHAPES})
    group = torch_ranks.Ranks(torch_ranks.compress_steps, 2, grads, 2)
    _jax_subprocess(JAX_ROUNDS % ROUNDS, 2, out)
    ranks = group.results()
    want = np.load(out + ".npz")
    ulp = 2.0 ** -23
    for rank, rounds in enumerate(ranks):
        for i, (synced, res) in enumerate(rounds):
            for k in SHAPES:
                ws = want[f"synced/{i}/{k}"][rank]
                wr = want[f"res/{i}/{k}"][rank]
                # the same codes: synced values differ by the scale's
                # rounding alone
                np.testing.assert_allclose(synced[k], ws, rtol=2 * ulp,
                                           atol=0, err_msg=f"{i} {k}")
                assert np.abs(res[k] - wr).max() <= \
                    RES_ULPS * ulp * np.abs(grads[rank][k]).max(), (i, k)


def test_error_feedback_keeps_the_sum_bounded():
    """tests/test_runtime.py's property on the port: int8 + error
    feedback, one pod, 20 rounds; the accumulated error stays under
    twice the largest grad."""
    g = torch.from_numpy((np.random.default_rng(0).normal(size=(256,))
                          * 1e-3).astype(np.float32))
    res = compression.init_residual({"w": g})
    total_true, total_sync = np.zeros(256), np.zeros(256)
    for _ in range(ROUNDS):
        synced, res = compression.compress_grads_allreduce(
            {"w": g}, res, None, n_pods=1)
        total_true += g.numpy()
        total_sync += synced["w"].numpy()
    assert np.abs(total_true - total_sync).max() < \
        2 * float(np.abs(g.numpy()).max())


def test_codes_are_captured_and_the_range_holds():
    """``codes`` receives each key's int8 codes and scale; the range is
    +-(127 // n_pods)."""
    g = {"w": torch.linspace(-3, 3, 101)}
    for n_pods in (1, 2, 4):
        codes = {}
        synced, res = compression.compress_grads_allreduce(
            g, compression.init_residual(g), None, n_pods=n_pods,
            codes=codes)
        q, scale = codes["w"]
        assert q.dtype == torch.int8
        assert int(q.abs().max()) == 127 // n_pods
        torch.testing.assert_close(synced["w"], q.float() * scale,
                                   rtol=0, atol=0)
        torch.testing.assert_close(res["w"], g["w"] - q.float() * scale,
                                   rtol=0, atol=0)


JAX_STEP = r"""
import sys, json
import numpy as np, jax, jax.numpy as jnp
import sharded_ref as ref
from repro.compat import make_mesh
from repro.sharding.partition import (DEFAULT_RULES, shardings_for_tree,
                                      use_mesh)
from repro.train import trainstep
from repro_torch.models.convert import flatten_paths
data = np.load(sys.argv[1] + ".in.npz")
batch = {k: jnp.asarray(data[k]) for k in data.files}
mesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
rules = DEFAULT_RULES.with_overrides(batch="data")
japi, st = ref.jax_state("adamw", seed=3, grad_compression=True)
with use_mesh(mesh, rules):
    st = jax.device_put(st, shardings_for_tree(
        trainstep.state_axes(japi, grad_compression=True), mesh, rules, st))
    step = jax.jit(trainstep.make_train_step(
        japi, mesh=mesh, grad_compression=True, accum=ref.ACCUM,
        **ref.KW_COMPRESS))
    st, m = step(st, batch)
np.savez(sys.argv[1], **flatten_paths(ref.host(st)))
json.dump({k: float(v) for k, v in m.items()},
          open(sys.argv[1] + ".json", "w"))
"""


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("compressed") / "step")
    batches = ref.make_batches(14, n=1)
    np.savez(out + ".in.npz", **batches[0])
    first = ref.host(ref.jax_state("adamw", seed=3,
                                   grad_compression=True)[1])
    runs = [{"name": "pods", "mesh": ((2, 1, 2), ("pod", "data", "model")),
             "rules": "DEFAULT_RULES", "optimizer": "adamw",
             "accum": ref.ACCUM, "compress": True, "state": first,
             "batches": batches, "kw": ref.KW_COMPRESS, "capture": True}]
    group = torch_ranks.Ranks(torch_ranks.train_runs, 4, runs)
    _jax_subprocess(JAX_STEP, 4, out)
    no_res = {k: v for k, v in first.items() if k != "residual"}
    plain = ref.port_run("adamw", no_res, batches, kw=ref.KW_COMPRESS)
    with open(out + ".json") as f:
        jm = json.load(f)
    return ([r["pods"] for r in group.results()], dict(np.load(out + ".npz")),
            jm, plain)


def test_compressed_step_codes_are_bit_for_bit(compressed):
    """Each pod's codes and the shared scale, recomputed plainly (numpy,
    float32) from the grads and residuals the step captured."""
    ranks = compressed[0]
    pods = (ranks[0][3], ranks[2][3])         # one rank of each pod
    for path in pods[0]["grads"]:
        x = [p["grads"][path] + p["residual"][path] for p in pods]
        amax = max(np.abs(v).max() for v in x)
        scale = np.float32(amax) / np.float32(63) + np.float32(1e-12)
        for p, v in zip(pods, x):
            q = np.clip(np.rint(v / scale), -63, 63).astype(np.int8)
            got_q, got_scale = p["codes"][path]
            np.testing.assert_array_equal(got_q, q, err_msg=path)
            assert np.float32(got_scale) == scale, path
    # the ranks of one pod captured the same (whole) tensors
    for a, b in ((ranks[0][3], ranks[1][3]), (ranks[2][3], ranks[3][3])):
        for path in a["grads"]:
            np.testing.assert_array_equal(a["grads"][path],
                                          b["grads"][path])


def test_compressed_step_matches_jax(compressed):
    """The 4-rank compressed step against the JAX one.  Both quantize
    grads that agree to about 1e-7; where such a value lies next to a
    rounding boundary its code differs by one, so the element's residual
    differs by one quantum (the scale) and its first moment by
    (1 - b1) * scale / n_pods the other way.  Those elements are found
    by their residual, counted (at most 4 of about 80,000) and checked
    to be exactly such flips; every other element is held to the
    trajectory bound."""
    ranks, want, jm, _ = compressed
    got = flatten_paths(ranks[0][1])
    assert sorted(got) == sorted(want)
    flips = 0
    for path in [p for p in want if p.startswith("residual/")]:
        leaf = path[len("residual/"):]
        dr = got[path].astype(np.float64) - want[path]
        flip = np.abs(dr) > np.abs(want[path]).max()
        flips += int(flip.sum())
        dmu = (got["opt/mu/" + leaf].astype(np.float64)
               - want["opt/mu/" + leaf])
        np.testing.assert_allclose(dmu[flip], -0.1 * dr[flip] / 2,
                                   rtol=1e-3, err_msg=leaf)
        for key in (path, "opt/mu/" + leaf, "opt/nu/" + leaf,
                    "params/" + leaf):
            assert ref.rel_l2(got[key][~flip], want[key][~flip]) <= \
                ref.TRAJ_TOL, key
    assert flips <= 4
    metrics = ranks[0][0][0]
    np.testing.assert_allclose(metrics["grad_norm"], jm["grad_norm"],
                               rtol=ref.TRAJ_TOL)
    assert metrics["lr"] == jm["lr"]


def test_compressed_step_loss_is_the_global_mean(compressed):
    """Every pod reports the mean loss over the global batch: the
    unsharded step's (the JAX step reports one pod's own; queue 3 item
    v)."""
    ranks, _, _, plain = compressed
    for out in ranks:
        assert out[2] == []
        assert abs(out[0][0]["loss"] - plain[1][0]["loss"]) <= \
            ref.SHARD_TOL * abs(plain[1][0]["loss"])
