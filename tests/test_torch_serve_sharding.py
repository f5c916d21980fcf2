"""The pieces of the port's serving under a mesh that need no ranks, on
the CPU: ``ModelAPI.cache_specs`` and both forms of ``cache_axes``
against the JAX package's for all six families (the int8 KV cache too),
``build_model``'s cache, ``_serve_param_specs`` against the JAX one, the
split-K decode (``decode_partials`` on each length part, then
``combine_partials``) against the one-part ``decode_attention``, the
cache writes of one length part (``write_part``) against the unsharded
write, and the KV heads a rank's query heads take in prefill
(``_kv_of_heads``).  The ranks' runs are in
``tests/test_torch_sharded_serve.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.models.api import ModelAPI as JModelAPI  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.api import ModelAPI, build_model  # noqa: E402
from repro_torch.models.convert import flatten_paths  # noqa: E402
from repro_torch.models.lm import block_kinds  # noqa: E402

FAMILIES = ["smollm-135m", "qwen3-moe-30b-a3b", "recurrentgemma-9b",
            "rwkv6-3b", "internvl2-26b", "whisper-medium"]
#: split-K against one part, float32, relative L2: the parts' sums of
#: exp(s - m_p) and the combine reorder float32 sums of at most T terms
SPLIT_TOL = 1e-5


def pair(name, kv):
    jcfg = dataclasses.replace(jconfigs.ARCHS[name], kv_cache_dtype=kv)
    tcfg = dataclasses.replace(configs.ARCHS[name], kv_cache_dtype=kv)
    return jcfg, tcfg


def decode_shape(package_configs):
    """A decode shape of ``package_configs`` (either package's) at B 8 and
    a cache of 4096."""
    s = next(s for s in package_configs.SHAPES if s.kind == "decode")
    return dataclasses.replace(s, seq_len=4096, global_batch=8)


def unstack(tree):
    """Each JAX axes tuple without its leading None."""
    if isinstance(tree, dict):
        return {k: unstack(v) for k, v in tree.items()}
    assert tree[0] is None, tree
    return tuple(tree[1:])


def same(spec, jspec, what):
    assert tuple(spec.shape) == tuple(jspec.shape), what
    assert str(spec.dtype).removeprefix("torch.") == str(jspec.dtype), what


@pytest.mark.parametrize("kv", ["model", "int8"])
@pytest.mark.parametrize("name", FAMILIES)
def test_cache_specs_and_axes_equal_the_jax_package(name, kv):
    """One sub-block's (or decoder layer's) cache spec is the JAX stacked
    one without the group dim, for every key, shape and dtype; the
    per-sub-block axes are the JAX axes without their leading None; the
    stacked axes are the JAX ones; and ``init_cache`` on the meta device
    makes exactly these specs (an int 0 for "len")."""
    jcfg, tcfg = pair(name, kv)
    japi, api = JModelAPI(jcfg), ModelAPI(tcfg, device="meta")
    jshape, shape = decode_shape(jconfigs), decode_shape(configs)
    jspecs, specs = japi.cache_specs(jshape), api.cache_specs(shape)
    jaxes, axes = japi.cache_axes(), api.cache_axes(stacked=False)
    assert api.cache_axes() == jaxes
    if tcfg.is_encdec:
        (jself, jcross), (tself, tcross) = jspecs, specs
        (jsa, jca), (tsa, tca) = jaxes, axes
        L = tcfg.n_layers
        assert len(tself) == len(tcross) == len(tsa) == len(tca) == L
        for i in range(L):
            for k in ("k", "v", "len"):
                same(tself[i][k], jax.tree.map(
                    lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype),
                    jself[k]), (i, k))
            assert tsa[i] == unstack(jsa)
            for t, j in zip(tcross[i], jcross):
                same(t, jax.ShapeDtypeStruct(j.shape[1:], j.dtype), i)
            assert tca[i] == tuple(unstack(a) for a in jca)
        return
    kinds = block_kinds(tcfg)
    k = len(kinds)
    G = jax.tree.leaves(jspecs)[0].shape[0]
    assert len(specs) == len(axes) == G * k
    for j, (spec, ax) in enumerate(zip(specs, axes)):
        jb = jspecs[f"b{j % k}"]
        jflat, tflat = flatten_paths(jb), flatten_paths(spec)
        assert sorted(jflat) == sorted(tflat), (j, sorted(jflat))
        for path, js in jflat.items():
            assert js.shape[0] == G
            same(tflat[path], jax.ShapeDtypeStruct(js.shape[1:], js.dtype),
                 (j, path))
        assert ax == unstack(jaxes[f"b{j % k}"])
    made = ModelAPI(tcfg, device="meta").model.init_cache(
        shape.global_batch, shape.seq_len)
    for spec, cache in zip(specs, made):
        for path, s in flatten_paths(spec).items():
            t = flatten_paths(cache)[path]
            if not s.shape:
                assert t == 0, path
            else:
                assert tuple(t.shape) == s.shape and t.dtype == s.dtype


def test_build_model_is_cached_on_the_config():
    cfg = configs.smoke_variant(configs.ARCHS["smollm-135m"])
    a = build_model(cfg, "meta")
    assert build_model(cfg, "meta") is a
    assert build_model(dataclasses.replace(cfg), "meta") is a   # equal
    other = build_model(dataclasses.replace(cfg, n_layers=4), "meta")
    assert other is not a and len(other.model.blocks) == 4
    assert isinstance(a, ModelAPI) and a.device.type == "meta"


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_param_specs_equal_the_jax_package(name):
    """bf16 for every floating leaf, the JAX layout and shapes."""
    jspecs = flatten_paths(jdryrun._serve_param_specs(
        JModelAPI(jconfigs.smoke_variant(jconfigs.ARCHS[name]))))
    api = ModelAPI(configs.smoke_variant(configs.ARCHS[name]), device="meta")
    specs = flatten_paths(dryrun._serve_param_specs(api))
    assert sorted(specs) == sorted(jspecs)
    for path, s in specs.items():
        same(s, jspecs[path], path)
    f32 = flatten_paths(dryrun._param_specs(api))
    assert all(s.dtype == torch.float32 for s in f32.values())


def qkv(seed, B=3, T=32, H=4, KV=2, hd=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, 1, H, hd, generator=g) * 2
    k = torch.randn(B, T, KV, hd, generator=g) * 2
    v = torch.randn(B, T, KV, hd, generator=g)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def split_k(q, k, v, cache_len, P):
    """decode_partials on P length parts, combined."""
    T = k.shape[1]
    n = T // P
    parts = [attention.decode_partials(q, k[:, i:i + n], v[:, i:i + n],
                                       cache_len, offset=i)
             for i in range(0, T, n)]
    m, l, o = (torch.stack(x) for x in zip(*parts))
    out = attention.combine_partials(m, l, o)
    B, _, H, hd = q.shape
    return out.reshape(B, 1, H, hd).to(q.dtype), m


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


# cache_len 20 ends inside a part and leaves a part wholly past it at 4
# and 8 parts; 1 masks all but one position; 32 is a full (or wrapped
# ring) cache; a (B,) cache_len mixes them per row
CACHE_LENS = [20, 1, 32, "rows"]


@pytest.mark.parametrize("cache_len", CACHE_LENS)
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_combine_partials_matches_decode_attention(P, cache_len):
    q, k, v = qkv(P)
    cl = torch.tensor([1, 20, 32]) if cache_len == "rows" else cache_len
    want = attention.decode_attention(q, k, v, cl)
    got, m = split_k(q, k, v, cl, P)
    assert torch.isfinite(got).all()
    assert rel(got, want) <= SPLIT_TOL
    # a part wholly past cache_len has the max NEG_INF and weight 0 (m
    # (P, B, 1, KV, G): one query)
    T, n = k.shape[1], k.shape[1] // P
    limit = cl.reshape(-1, 1, 1, 1) if isinstance(cl, torch.Tensor) else cl
    past = torch.arange(0, T, n).reshape(P, 1, 1, 1, 1) >= torch.as_tensor(
        limit)
    w = torch.exp(m - m.amax(dim=0))
    assert torch.equal(w[past.expand_as(m)],
                       torch.zeros_like(w[past.expand_as(m)]))
    assert (m[past.expand_as(m)] == attention.NEG_INF).all()


def test_combine_partials_on_a_wrapped_ring():
    """A hybrid ring past its wrap: slots 0 .. len % T - 1 hold the
    newest tokens, all T valid; split over 4 parts it is the one-part
    attention, and the same when the newest slots are written part by
    part (``write_part``) as each rank would."""
    q, k, v = qkv(5, T=32)
    T, P = 32, 4
    newk, newv = torch.randn(3, 3, 2, 16), torch.randn(3, 3, 2, 16)
    whole_k, whole_v = k.clone(), v.clone()
    parts_k = [p.clone() for p in k.split(T // P, dim=1)]
    parts_v = [p.clone() for p in v.split(T // P, dim=1)]
    for j, length in enumerate((33, 34, 35)):      # slots 1, 2, 3
        slot = (length - 1) % T
        whole_k[:, slot:slot + 1] = newk[:, j:j + 1]
        whole_v[:, slot:slot + 1] = newv[:, j:j + 1]
        for i, (pk, pv) in enumerate(zip(parts_k, parts_v)):
            attention.write_part(pk, newk[:, j:j + 1], slot, i * T // P)
            attention.write_part(pv, newv[:, j:j + 1], slot, i * T // P)
    assert torch.equal(torch.cat(parts_k, 1), whole_k)
    want = attention.decode_attention(q, whole_k, whole_v, T)
    got, _ = split_k(q, torch.cat(parts_k, 1), torch.cat(parts_v, 1), T, P)
    assert rel(got, want) <= SPLIT_TOL


def test_combine_partials_int8_cache():
    """The int8 cache dequantised part by part is the whole cache
    dequantised: the split-K of the codes and scales equals the one-part
    decode on them."""
    q, k, v = qkv(7)
    kq, ks = attention.quant_kv(k)
    vq, vs = attention.quant_kv(v)
    kd = attention.dequant_kv(kq, ks, torch.float32)
    vd = attention.dequant_kv(vq, vs, torch.float32)
    want = attention.decode_attention(q, kd, vd, 27)
    for P in (2, 4, 8):
        got, _ = split_k(q, kd, vd, 27, P)
        assert rel(got, want) <= SPLIT_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_part_writes_equal_the_unsharded_write(P, dtype):
    """Prefill's write of n positions from 0 and a decode append at every
    slot, done part by part with each part's offset, give the unsharded
    cache bit for bit, and an append changes exactly one part."""
    B, T, KV, hd = 2, 32, 2, 4
    g = torch.Generator().manual_seed(P)

    def draw(*shape):
        x = torch.randn(*shape, generator=g) * 50
        return x.to(dtype) if dtype == torch.int8 else x
    n_part = T // P
    for n in (1, 5, 16, 30, 32):
        src = draw(B, n, KV, hd)
        whole = torch.zeros(B, T, KV, hd, dtype=dtype)
        whole[:, :n] = src
        parts = [torch.zeros(B, n_part, KV, hd, dtype=dtype)
                 for _ in range(P)]
        for i, part in enumerate(parts):
            attention.write_part(part, src, 0, i * n_part)
        assert torch.equal(torch.cat(parts, 1), whole), n
    for slot in range(T):
        one = draw(B, 1, KV, hd)
        before = [p.clone() for p in parts]
        whole[:, slot:slot + 1] = one
        for i, part in enumerate(parts):
            attention.write_part(part, one, slot, i * n_part)
        assert torch.equal(torch.cat(parts, 1), whole), slot
        changed = [i for i, (a, b) in enumerate(zip(before, parts))
                   if not torch.equal(a, b)]
        assert changed == [slot // n_part], (slot, changed)


# (H, KV, model ranks): the smoke MoE on a model axis of 4 (KV 2
# replicated under H 4), qwen3-moe's and recurrentgemma-9b's served
# heads, internvl2-26b's G 6, and a G that no block of heads aligns to
HEADS = [(4, 2, 4), (4, 2, 2), (32, 4, 2), (32, 4, 4), (16, 1, 2),
         (16, 1, 4), (48, 8, 4), (12, 2, 4), (6, 3, 2)]


@pytest.mark.parametrize("H,KV,mp", HEADS)
def test_each_rank_takes_the_kv_heads_of_its_query_heads(H, KV, mp):
    """Rank r's query heads r*H/mp .. use KV head h // G; k holds the KV
    heads the rank has (its own block where KV divides by mp, else all):
    the heads ``_kv_of_heads`` gives, grouped as flash groups them, are
    those, and flash on the rank's slice is the whole attention's slice
    of heads."""
    G, Hl = H // KV, H // mp
    B, S, hd = 1, 6, 16
    g = torch.Generator().manual_seed(H * 100 + KV * 10 + mp)
    q = torch.randn(B, S, H, hd, generator=g)
    k = torch.randn(B, S, KV, hd, generator=g)
    v = torch.randn(B, S, KV, hd, generator=g)
    whole = attention.ops.flash_attention(q, k, v, causal=True)
    sharded_kv = KV % mp == 0
    for r in range(mp):
        h0 = r * Hl
        k0 = r * (KV // mp) if sharded_kv else 0
        kl = k[:, :, k0:k0 + KV // mp] if sharded_kv else k
        vl = v[:, :, k0:k0 + KV // mp] if sharded_kv else v
        ks, vs = attention._kv_of_heads(kl, vl, h0, Hl, G, k0)
        Gl = Hl // ks.shape[2]
        for j in range(Hl):
            assert torch.equal(ks[:, :, j // Gl], k[:, :, (h0 + j) // G])
            assert torch.equal(vs[:, :, j // Gl], v[:, :, (h0 + j) // G])
        out = attention.ops.flash_attention(q[:, :, h0:h0 + Hl], ks, vs,
                                            causal=True)
        np.testing.assert_allclose(out.numpy(),
                                   whole[:, :, h0:h0 + Hl].numpy(),
                                   rtol=1e-6, atol=1e-6)


# -- an uneven split of the length (1500 frames in 8 parts) -------------------

FRAMES, PARTS = 1500, 8


def chunk_ranges(T: int, P: int):
    """(offset, length) of each of DTensor's P shards of T positions, as
    ``torch.chunk`` cuts them: 188 x 7 and 184 for 1500 in 8."""
    out, off = [], 0
    for c in torch.arange(T).chunk(P):
        out.append((off, c.numel()))
        off += c.numel()
    return out


@pytest.mark.parametrize("Sq", [1, 3])
def test_split_k_over_an_uneven_cross_cache(Sq):
    """whisper's cross cache of 1500 frames split as DTensor splits it over
    a model axis of 8, each part scored from its own offset and length:
    one decode query (Sq 1) or a prefill's queries (Sq 3) against every
    frame, within SPLIT_TOL of one part and of ``chunked_attention``."""
    g = torch.Generator().manual_seed(28)
    B, H, KV, hd = 2, 4, 2, 16
    q = torch.randn(B, Sq, H, hd, generator=g) * 2
    k = torch.randn(B, FRAMES, KV, hd, generator=g) * 2
    v = torch.randn(B, FRAMES, KV, hd, generator=g)
    ranges = chunk_ranges(FRAMES, PARTS)
    assert [n for _, n in ranges] == [188] * 7 + [184]

    def split(rs):
        parts = [attention.decode_partials(q, k[:, o:o + n], v[:, o:o + n],
                                           FRAMES, o) for o, n in rs]
        m, l, o = (torch.stack(x) for x in zip(*parts))
        return attention.combine_partials(m, l, o).reshape(B, Sq, H, hd)
    got, one = split(ranges), split([(0, FRAMES)])
    assert torch.isfinite(got).all()
    assert rel(got, one) <= SPLIT_TOL
    assert rel(got, attention.chunked_attention(q, k, v, causal=False)) \
        <= SPLIT_TOL


def test_shard_range_gives_each_rank_its_uneven_shard():
    """On each rank of a fake world of 8, a cross cache of 1500 frames
    sharded over "model" (and ``zeros_placed``'s) holds the rank's own
    length at its own offset, never 1500 / 8."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.sharding import partition
    shape = (2, FRAMES, 2, 16)
    for rank, (off, n) in enumerate(chunk_ranges(FRAMES, PARTS)):
        with dryrun.fake_world((PARTS,), ("model",), rank=rank) as mesh:
            t = distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                  [Shard(1)], src_data_rank=None)
            assert partition.shard_range(t, 1) == (off, n)
            assert t.to_local().shape[1] == n
            z = partition.zeros_placed(
                shape, partition.NamedSharding(mesh, (None, "model")),
                device="meta")
            assert z.to_local().shape[1] == n
            assert partition.shard_range(z, 1) == (off, n)
