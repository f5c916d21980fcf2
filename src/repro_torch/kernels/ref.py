"""Plain PyTorch versions of the hand-written kernels (the allclose ground
truth, and the path a wrapper takes for tensors on the CPU)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Naive full-matrix attention.  q: (B,S,H,hd); k,v: (B,T,KV,hd).

    Masked scores take the finite ``NEG_INF`` (not -inf) and the math runs
    in float32, as in the JAX oracle; the result has q's dtype."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bskgh,btkh->bskgt", qg, k.float()) * (hd ** -0.5)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgt,btkh->bskgh", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def rglru_ref(a, b, h0=None):
    """Sequential linear recurrence h_t = a_t * h_{t-1} + b_t in float32
    (the JAX oracle ``ref.rglru_ref``).  a, b: (B, S, W), S >= 1; h0: (B, W)
    or None (zeros).  Returns (h (B, S, W), h_last (B, W)), float32."""
    B, S, W = a.shape
    h = torch.zeros((B, W), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    a, b = a.float(), b.float()
    hs = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def wkv6_ref(r, k, v, w, u, state=None):
    """Sequential WKV-6 in float32 (the JAX oracle ``ref.wkv6_ref``), per
    (batch, head): o_t = r_t (diag(u) k_t v_t^T + S);  S <- diag(w_t) S +
    k_t v_t^T.  r, k, v, w: (B, S, H, N), S >= 1; u: (H, N); state:
    (B, H, N, N) or None (zeros).  Returns (out in r's dtype, final state
    float32)."""
    B, S, H, N = r.shape
    st = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device) \
        if state is None else state.float()
    u = u.float()[None, :, :, None]
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B, H, N, N)
        outs.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], st + u * kv))
        st = st * wf[:, t, :, :, None] + kv
    return torch.stack(outs, dim=1).to(r.dtype), st


def take_rows_ref(values, indices):
    """Row gather: out[i] = values[indices[i]] (the JAX oracle
    ``ref.take_rows_ref``).  values: (R, W); indices: (M,) int32 or int64
    in [0, R).  Plain indexing copies each element's bits."""
    return values[indices]


def dict_decode_ref(codes, dictionary):
    """Dictionary decode: out[i] = dictionary[codes[i]] (the JAX oracle
    ``ref.dict_decode_ref``), the same row gather."""
    return dictionary[codes]


# --------------------------------------------------------------------------
# relational kernels: bits in 64-bit signed words
# --------------------------------------------------------------------------
#
# torch has no right shift for uint64 on the CPU, so these work on int64
# words that carry the uint64 bits: shifts are arithmetic and then masked
# to be logical, and multiplies wrap in two's complement, which gives the
# uint64 product's bits.  Every constant is a Python int (no tensor made
# from the host), so the functions can be captured in a CUDA graph.

SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _s64(u: int) -> int:
    """The int64 whose bits are the uint64 ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


GOLDEN = _s64(0x9E3779B97F4A7C15)
_M1 = _s64(0xBF58476D1CE4E5B9)
_M2 = _s64(0x94D049BB133111EB)
INT64_MIN = -(1 << 63)


def _shr(h, s: int):
    """Logical right shift of int64 words."""
    return (h >> s) & ((1 << (64 - s)) - 1)


def mix64_ref(h):
    """splitmix64 finalizer over int64 words (vkernels._mix64)."""
    h = h ^ _shr(h, 30)
    h = h * _M1
    h = h ^ _shr(h, 27)
    h = h * _M2
    return h ^ _shr(h, 31)


def words_ref(x, sign_extend: bool = False):
    """A 1/2/4/8-byte tensor as int64 words: its bits zero-extended, or
    its integer values sign-extended when ``sign_extend`` and signed."""
    w = x.element_size()
    s = x.view(SIGNED[w]).to(torch.int64)
    if w < 8 and not (sign_extend and x.dtype.is_signed):
        s = s & ((1 << (8 * w)) - 1)
    return s


def prep_bits_ref(x):
    """Bits of each element as an int64 word, zero-extended, float -0.0
    made +0.0 (vkernels.hash_fixed's preparation)."""
    b = words_ref(x)
    if x.dtype.is_floating_point:
        w = x.element_size()
        sign = INT64_MIN if w == 8 else 1 << (8 * w - 1)
        b = torch.where(b == sign, 0, b)
    return b


def hash_fixed_ref(x):
    """uint64 splitmix64 hash of each element's bits, as int64 words."""
    return mix64_ref(prep_bits_ref(x) ^ GOLDEN)


def combine_ref(cols, mix_first: bool = False):
    """Ordered fold of the rows of an int64 (ncols, n) tensor of 64-bit
    words: h = GOLDEN, h = mix(h * GOLDEN ^ c_j) for each row j in order;
    ``mix_first`` hashes each row's raw bits first (hash_keys)."""
    h = torch.full((cols.shape[1],), GOLDEN, dtype=torch.int64,
                   device=cols.device)
    for c in cols:
        if mix_first:
            c = mix64_ref(c ^ GOLDEN)
        h = mix64_ref((h * GOLDEN) ^ c)
    return h


def sentinel_gather_ref(src, idx, fill: int):
    """out[i] = src[idx[i]], or the element whose bits, read as a signed
    integer of src's width, are ``fill`` where idx[i] == -1; bits are
    copied through a signed view."""
    s = src.view(SIGNED[src.element_size()])
    if s.numel() == 0:              # then every index is a -1 miss
        return torch.full(idx.shape, fill, dtype=s.dtype,
                          device=idx.device).view(src.dtype)
    return torch.where(idx >= 0, s[idx.clamp(min=0)], fill).view(src.dtype)


def segreduce_ref(op: str, values, order, starts, valid):
    """(acc, counts) of one segment reduction in the convention of the
    segreduce kernel: group g spans sorted positions [starts[g],
    starts[g + 1]) of ``order``; acc holds 64-bit result words (wrapping
    sums; extremes with the type's sentinel for an all-null group;
    uint64 bits as int64), counts the non-null rows, both int64 (G,)."""
    n, G = order.numel(), starts.numel()
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    if valid is None:
        counts = ends - starts
    else:
        cs = torch.cat([starts.new_zeros(1),
                        torch.cumsum(valid[order].to(torch.int64), 0)])
        counts = cs[ends] - cs[starts]
    if op == "count":
        return counts, counts
    v = words_ref(values, sign_extend=True)[order]
    if op == "sum":
        if valid is not None:
            v = torch.where(valid[order], v, 0)
        cs = torch.cat([starts.new_zeros(1), torch.cumsum(v, 0)])
        return cs[ends] - cs[starts], counts
    flip = values.dtype == torch.uint64      # order uint64 as signed words
    if flip:
        v = v ^ INT64_MIN
    w = 8 * values.element_size()
    if values.dtype.is_signed:
        lo, hi = -(1 << (w - 1)), (1 << (w - 1)) - 1
    else:
        lo, hi = 0, (1 << w) - 1
    sentinel = hi if op == "min" else lo
    if flip:
        sentinel = _s64(sentinel) ^ INT64_MIN
    if valid is not None:
        v = torch.where(valid[order], v, sentinel)
    pos = torch.arange(n, device=order.device)
    seg = torch.searchsorted(starts, pos, right=True) - 1
    acc = torch.full((G,), sentinel, dtype=torch.int64, device=order.device)
    acc = acc.scatter_reduce(0, seg, v, "amin" if op == "min" else "amax")
    return (acc ^ INT64_MIN if flip else acc), counts


def segreduce_many_ref(hows, values, order, starts, valid, n=None):
    """The plain version of one fused segreduce launch, composed from
    ``segreduce_ref``: ({how: acc} for each op of ``hows`` but the count,
    counts).  ``order`` may be None for a count alone with no validity
    mask, with ``n`` the number of rows."""
    if order is None:
        ends = torch.cat([starts[1:], starts.new_full((1,), n)])
        return {}, ends - starts
    _, counts = segreduce_ref("count", None, order, starts, valid)
    return {h: segreduce_ref(h, values, order, starts, valid)[0]
            for h in hows if h != "count"}, counts
