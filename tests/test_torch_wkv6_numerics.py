"""The numerics contract of the bf16 tensor-core WKV-6 kernel, on the CPU.

``csrc/wkv6.cu`` computes the bf16 recurrence in the chunked form on the
tensor cores and cannot run here.  ``kernel_twin`` repeats its arithmetic
in plain PyTorch: chunks of C = 16 tokens (the last one padded with r = k =
v = 0 and w = 1); per column n the running products d_in[t] = prod_{j<t}
w_j, d_tail[t] = prod_{j>t} w_j and d_total; a chunk that decays by at least
THETA = 2^-96 in every column takes the factorised A = (r d_in)(k /
d_in[s + 1])^T (the reference point of the decays at the chunk's start;
the kernel's reciprocal is the card's MUFU.RCP, within an ulp of the
twin's), any other computes A pair by pair from w; the bonus
sum_n r_t u k_t on A's diagonal; every f32 operand (r d_in, k / d_in,
k d_tail, A and the state) as the sum of three bf16 parts, each the
rounding of what the parts before it leave; the product of an f32 operand
with a bf16 one as three bf16 products, of two f32 operands as the six
whose parts' orders sum to less than three, with f32 accumulation; each
chunk's part of the state summed on its own and then added to the decayed
state; the state in f32.

On the same inputs made from a numpy seed (bf16 r, k, v), the twin is held
to the JAX Pallas kernel in interpret mode (chunk 16, at the shapes of
tests/test_torch_scans.py) and to the JAX oracle ``wkv6_ref`` at ragged
lengths and at decays near 1, at the model's e^-4 floor and down to 1e-30,
at 2e-2 on the bf16 output and 1e-4 (rtol = atol) on the f32 state: the
bounds that hold the CUDA kernel to the port's ``ref.wkv6_ref`` on the card
(chip_smoke.py, tests/test_torch_gpu.py).  Where w is near 1 the state
misses 1e-4 with the f32 operands rounded once to bf16 (and the output
misses 2e-2), and comes within 1.6x of the bound with two parts of k
d_tail: the third part is what gives the state its margin.  With a large
state (as a served rwkv6-3b prefill builds) the output's state term
(r d_in) S keeps 2^-17 of each term with two parts, and many more outputs
are then not the float64 value correctly rounded than the f32 oracle's;
with three parts no more than the oracle's.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

C, THETA = 16, 2.0 ** -96
OUT_TOL, STATE_TOL = 2e-2, 1e-4

# (B, S, H, N) of tests/test_torch_scans.py's Pallas cases, run at chunk 16
PALLAS_CASES = [(1, 32, 2, 16), (2, 64, 4, 32), (1, 48, 2, 64)]
DECAYS = ("near 1", "floor", "tiny", "mixed")


def inputs(seed, B, S, H, N, decay="pallas"):
    """r, k, v (float32 arrays of bf16 values), w, u, state.  w: uniform in
    [0.05, 0.999] as tests/test_kernels.py draws it, or near 1 (1 - 1e-3
    z), at the model's floor (e^-4 (1 + 0.05 z)), tiny (log-uniform in
    [1e-30, 1e-3]) or mixed (the model's range with one token in twenty
    tiny)."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def bf16(a):
        return torch.from_numpy(a.astype(f)).bfloat16().float().numpy()
    r = bf16(rng.normal(size=(B, S, H, N)) * 0.5)
    k = bf16(rng.normal(size=(B, S, H, N)) * 0.5)
    v = bf16(rng.normal(size=(B, S, H, N)))
    z = rng.uniform(size=(B, S, H, N))
    tiny = 10.0 ** rng.uniform(-30, -3, size=(B, S, H, N))
    w = {"pallas": rng.uniform(0.05, 0.999, (B, S, H, N)),
         "near 1": 1.0 - 1e-3 * z,
         "floor": np.exp(-4.0) * (1.0 + 0.05 * z),
         "tiny": tiny,
         "mixed": np.where(rng.uniform(size=(B, S, H, 1)) < 0.05, tiny,
                           np.exp(-4.0) + (1.0 - np.exp(-4.0)) * z)}[decay]
    u = (rng.normal(size=(H, N)) * 0.1).astype(f)
    state = (rng.normal(size=(B, H, N, N)) * 0.1).astype(f)
    return [r, k, v, w.astype(f), u, state]


def split(x, parts):
    """x as the sum of ``parts`` bf16 values: its rounding to bf16, then
    the rounding of each rest."""
    out, rest = [], x
    for _ in range(parts):
        out.append(rest.bfloat16().float())
        rest = rest - out[-1]
    return out


def mm_bf16(x, y, parts):
    """x @ y for f32 x and bf16-valued y: one bf16 product per part."""
    return sum(p @ y for p in split(x, parts=parts))


def mm_f32(x, y, parts):
    """x @ y for f32 x and y: the products of parts i, j with i + j <
    parts (six at three parts, three at two)."""
    xs, ys = split(x, parts=parts), split(y, parts=parts)
    return sum(xs[i] @ ys[j] for i in range(parts)
               for j in range(parts - i))


def direct_a(r, k, w):
    """A[t, s] = sum_n r_t k_s prod_{s<j<t} w_j (s < t), 0 elsewhere, as
    the kernel forms it in a chunk that decays too fast: r_t k_s, then
    times each w_j in turn.  r, k, w: (B, H, C, N)."""
    A = torch.zeros(r.shape[:2] + (C, C))
    for t in range(C):
        for s in range(t):
            p = r[:, :, t] * k[:, :, s]
            for j in range(s + 1, t):
                p = p * w[:, :, j]
            A[:, :, t, s] = p.sum(-1)
    return A


def kernel_twin(r, k, v, w, u, state=None, *, parts=3, kd_parts=None):
    """The bf16 kernel's arithmetic in plain PyTorch, with ``parts`` bf16
    parts of every f32 operand (the kernel's ``ChunkTiles::PARTS``; k
    d_tail takes ``kd_parts``, by default as many).  r, k, v: float32
    (B, S, H, N) tensors of bf16 values; w float32 (B, S, H, N); u (H, N);
    state (B, H, N, N) or None.  Returns (out float32 before its bf16
    cast, state float32) and the number of chunks that took the pair by
    pair A."""
    kd_parts = kd_parts or parts
    B, S, H, N = r.shape
    st = torch.zeros(B, H, N, N) if state is None else state.clone()
    rh, kh, vh, wh = (x.transpose(1, 2) for x in (r, k, v, w))  # (B,H,S,N)
    outs, slow = [], 0
    for t0 in range(0, S, C):
        nc = min(C, S - t0)

        def chunk(x, fill):
            pad = torch.full((B, H, C - nc, N), fill)
            return torch.cat([x[:, :, t0:t0 + nc], pad], dim=2)
        rc, kc, vc, wc = (chunk(x, f) for x, f in
                          ((rh, 0.0), (kh, 0.0), (vh, 0.0), (wh, 1.0)))
        din = [torch.ones(B, H, N)]
        for t in range(C):
            din.append(din[-1] * wc[:, :, t])
        dtail = [torch.ones(B, H, N)]
        for t in range(C - 1, 0, -1):
            dtail.insert(0, dtail[0] * wc[:, :, t])
        fast = (din[C] >= THETA).all(-1)                  # (B, H)
        slow += int((~fast).sum())
        q1 = rc * torch.stack(din[:C], 2)
        kk = kc * (1.0 / torch.stack(din[1:], 2))
        kd = kc * torch.stack(dtail, 2)
        A = torch.where(fast[..., None, None],
                        mm_f32(q1, kk.transpose(-1, -2), parts),
                        direct_a(rc, kc, wc))
        A = torch.tril(A, -1) + torch.diag_embed((rc * (u[None, :, None] *
                                                        kc)).sum(-1))
        outs.append((mm_bf16(A, vc, parts) + mm_f32(q1, st, parts))
                    [:, :, :nc])
        st = st * din[C][..., None] + mm_bf16(kd.transpose(-1, -2), vc,
                                              kd_parts)
    return torch.cat(outs, 2).transpose(1, 2), st, slow


def twin(arrays, parts=3, kd_parts=None):
    """The twin on numpy inputs: (out rounded to bf16, state) as float32
    numpy arrays, and the number of chunks that took the pair by pair A."""
    out, st, slow = kernel_twin(*(None if a is None else torch.from_numpy(a)
                                  for a in arrays), parts=parts,
                                kd_parts=kd_parts)
    return out.bfloat16().float().numpy(), st.numpy(), slow


def jax_call(fn, arrays, **kw):
    r, k, v, w, u, state = arrays
    out, st = fn(*(jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)),
                 jnp.asarray(w), jnp.asarray(u),
                 None if state is None else jnp.asarray(state), **kw)
    return np.asarray(out, np.float32), np.asarray(st, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def pallas_case(B, S, H, N, with_state):
    arrays = inputs(B * S + N, B, S, H, N)
    if not with_state:
        arrays[5] = None
    return (arrays, jax_call(jops.wkv6, arrays, chunk=16),
            jax_call(jref.wkv6_ref, arrays))


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("B,S,H,N", PALLAS_CASES)
def test_twin_matches_pallas_and_oracle(B, S, H, N, with_state):
    arrays, pallas, oracle = pallas_case(B, S, H, N, with_state)
    out, st, slow = twin(arrays)
    assert slow == 0 and np.isfinite(out).all()
    for want, want_st in (pallas, oracle):
        close(out, want, OUT_TOL)
        close(st, want_st, STATE_TOL)


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("S", [1, C - 1, C + 1, 37])
def test_twin_matches_oracle_at_the_edges(S, decay):
    arrays = inputs(S, 2, S, 2, 64, decay)
    out, st, slow = twin(arrays)
    want, want_st = jax_call(jref.wkv6_ref, arrays)
    assert out.shape == want.shape and np.isfinite(out).all()
    close(out, want, OUT_TOL)
    close(st, want_st, STATE_TOL)
    # the model's floor keeps every chunk factorised; w down to 1e-30 not
    assert (slow == 0) == (decay in ("near 1", "floor"))


def test_the_factorised_a_overflows_where_the_pair_by_pair_a_is_taken():
    """At w = 1e-30 the factors of A leave f32's range: the chunks that the
    twin computes pair by pair are ones that the factorised form gets
    wrong."""
    arrays = inputs(3, 1, C, 2, 16, "tiny")
    rc, kc, wc = (torch.from_numpy(a).transpose(1, 2)
                  for a in (arrays[0], arrays[1], arrays[3]))
    incl = torch.cumprod(wc, 2)                    # d_in[t + 1]
    assert (incl[:, :, -1] < THETA).all()
    factorised = torch.tril((rc * incl / wc) @ (kc / incl).transpose(-1, -2),
                            -1)
    exact = direct_a(rc, kc, wc)
    assert not torch.isfinite(factorised).all() or not torch.allclose(
        factorised, exact, rtol=1e-2, atol=1e-2)
    *_, slow = twin(arrays)
    assert slow == 2


def test_low_parts_keep_the_state_within_its_bound():
    """w near 1 over 512 tokens: the state sums 512 terms.  With the
    kernel's parts the twin's state is within 1e-4 of the oracle with room
    to spare; with two parts of k d_tail it is closer to the bound than the
    kernel may be; with every f32 operand rounded once to bf16 (one part)
    neither the state nor the output holds."""
    arrays = inputs(5, 1, 512, 2, 64, "near 1")
    want, want_st = jax_call(jref.wkv6_ref, arrays)

    def excess(st):       # max |diff| / (1 + |want|), against 1e-4
        return (np.abs(st - want_st) / (1 + np.abs(want_st))).max()
    out, st, _ = twin(arrays)
    close(out, want, OUT_TOL)
    close(st, want_st, STATE_TOL)
    assert excess(st) < STATE_TOL / 4
    _, st2, _ = twin(arrays, kd_parts=2)
    assert STATE_TOL / 2 < excess(st2) < STATE_TOL
    out1, st1, _ = twin(arrays, parts=1)
    assert excess(st1) > 100 * STATE_TOL
    assert (np.abs(out1 - want) / (1 + np.abs(want))).max() > OUT_TOL


def float64_ref(arrays):
    """The recurrence in float64 (numpy), out (B, S, H, N) float64."""
    r, k, v, w, u, state = (None if a is None else a.astype(np.float64)
                            for a in arrays)
    B, S, H, N = r.shape
    st = np.zeros((B, H, N, N)) if state is None else state
    out = np.empty((B, S, H, N))
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        out[:, t] = np.einsum("bhn,bhnm->bhm", r[:, t],
                              st + u[None, :, :, None] * kv)
        st = st * w[:, t, :, :, None] + kv
    return out


def test_three_parts_round_the_output_as_the_f32_oracle_does():
    """A large state, as a served rwkv6-3b prefill builds one (w in [0.97,
    1), r, k, v of scale 2 over 512 tokens: |S| up to about 95, |out| up to
    1800): with two parts the output's state term (r d_in) S keeps 2^-17 of
    each term, and many times more outputs than the f32 oracle's are not the
    float64 value correctly rounded; with three parts no more than twice
    the oracle's.  Both stay within the output's 2e-2."""
    rng = np.random.default_rng(11)
    shape = (1, 512, 2, 64)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float() \
            .numpy()
    r, k, v = (bf16(rng.normal(size=shape) * 2.0) for _ in range(3))
    w = (1.0 - 0.03 * rng.uniform(size=shape)).astype(np.float32)
    u = (rng.normal(size=shape[2:]) * 0.1).astype(np.float32)
    arrays = [r, k, v, w, u, None]
    exact = torch.from_numpy(float64_ref(arrays)).bfloat16()

    def misrounded(out):
        return int((torch.from_numpy(out).bfloat16() != exact).sum())
    oracle, _ = jax_call(jref.wkv6_ref, arrays)
    out3, _, _ = twin(arrays)
    out2, _, _ = twin(arrays, parts=2)
    for out in (out3, out2):
        close(out, oracle, OUT_TOL)
    assert 0 < misrounded(out3) <= 2 * misrounded(oracle)
    assert misrounded(out2) > 8 * misrounded(oracle)
