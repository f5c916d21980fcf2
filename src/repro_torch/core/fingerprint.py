"""Deterministic node fingerprints for cross-run differential caching.

A node's fingerprint is a sha256 over everything that determines its
output value:

    hash(op code/version, op params, input fingerprints,
         source file content hash)

computed in topo order so a change anywhere in the upstream cone — the op
itself, a captured parameter, a dependency, or the bytes of a zarquet
source file — changes the fingerprints of exactly the downstream nodes
that would produce different data.  A re-run of a DAG over mostly-
unchanged inputs therefore hits the manifest for every node outside the
diff and recomputes only the changed partitions (the Bauplan pre-print's
re-run-DAGs-over-mostly-unchanged-inputs workload).

Op identity is the *code object* — bytecode, consts, names, captured
closure/partial values, and directly-referenced module globals (helper
functions by their code, constants by value) — not the function's name
or address, so an identical lambda re-created next run fingerprints
identically, while editing the op body (or a value it closes over, or a
helper it calls by name) invalidates it.  Attributes reached *through a
module object* (``ops.dict_encode``) are not chased — bump
``FP_VERSION`` after editing shared library code, or have the op
declare its module-attr dependencies in ``__fp_includes__`` (a tuple of
callables folded into the op's identity — how ``ops.join`` binds itself
to the relational vkernels).  Ops that expose
neither code nor stable state (builtins, callables with ``__dict__`` we
cannot canonicalize) fingerprint as None and are simply never cached —
correctness over coverage.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import re
import types
from typing import Dict, List, Optional

import numpy as np

#: bump to invalidate every cached output on a format/semantics change
FP_VERSION = 1

#: file content hashes, keyed (path, size, mtime_ns) — cleared by
#: reset_caches() (benchmarks simulate fresh processes with it)
_FILE_HASH_CACHE: Dict[tuple, str] = {}

#: per-row-group content hashes of stream zarquet footers, same key
#: discipline as _FILE_HASH_CACHE (an append changes size/mtime, so the
#: new footer is re-read exactly once)
_GROUP_HASH_CACHE: Dict[tuple, List[Optional[str]]] = {}

_ADDR_REPR = re.compile(r" at 0x[0-9a-fA-F]+")


class _UnstableValue(Exception):
    """A value whose only representation embeds a memory address: it can
    never fingerprint deterministically across processes.  Raised so the
    op becomes uncacheable (None) instead of silently never-hitting —
    which would also append a fresh dead record to the journal per run."""


def _json_default(o) -> str:
    # numpy arrays get a full content hash: their repr truncates large
    # arrays ('...'), which would collide different parameter values
    if isinstance(o, np.ndarray):
        a = np.ascontiguousarray(o)
        return (f"ndarray:{a.dtype}:{a.shape}:"
                f"{hashlib.sha256(a.tobytes()).hexdigest()}")
    if isinstance(o, (np.generic,)):
        return f"npscalar:{o.dtype}:{o.item()!r}"
    r = repr(o)
    if _ADDR_REPR.search(r):
        raise _UnstableValue(r)
    return r


def _stable(obj) -> str:
    """Canonical text for parameter-ish values (sorted keys; ndarrays by
    content hash; repr escape hatch for anything else non-JSON — but an
    address-bearing repr raises, marking the op uncacheable)."""
    try:
        return json.dumps(obj, sort_keys=True, default=_json_default)
    except (TypeError, ValueError):
        return _json_default(obj)


def reset_caches() -> None:
    """Drop the in-memory hash caches (fresh-process simulation)."""
    _FILE_HASH_CACHE.clear()
    _GROUP_HASH_CACHE.clear()


def file_fingerprint(path: str) -> str:
    """Content hash of a source file, cached by (path, size, mtime_ns)."""
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_size, st.st_mtime_ns)
    h = _FILE_HASH_CACHE.get(key)
    if h is not None:
        return h
    d = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            d.update(chunk)
    h = d.hexdigest()
    _FILE_HASH_CACHE[key] = h
    return h


def source_fingerprint(path: str, row_groups=None) -> str:
    """Content identity of a loader's source.

    Whole-file loads hash the file bytes (``file_fingerprint``).  A
    row-group-scoped load of a *stream* zarquet file instead hashes the
    selected groups' per-group content hashes from the committed footer:
    committed group extents are immutable, so these identities are
    stable across appends — an append leaves every existing loader's
    fingerprint (and its cached output) intact and invalidates only
    consumers of the new tail.  Selection order matters (the output is
    one batch per group, in order).  Group-scoped reads of files without
    per-group hashes (batch files) fall back to whole-file content plus
    the selection."""
    if row_groups is None:
        return file_fingerprint(path)
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_size, st.st_mtime_ns)
    hashes = _GROUP_HASH_CACHE.get(key)
    if hashes is None:
        from . import zarquet
        meta = zarquet.read_footer(path)
        hashes = [g.get("hash") for g in (meta.get("groups") or ())]
        _GROUP_HASH_CACHE[key] = hashes
    sel = []
    for g in row_groups:
        if not 0 <= g < len(hashes) or hashes[g] is None:
            return (f"{file_fingerprint(path)}"
                    f":rg{','.join(str(i) for i in row_groups)}")
        sel.append(hashes[g])
    return "rg:" + hashlib.sha256(";".join(sel).encode()).hexdigest()


def code_fingerprint(fn, _seen=None) -> Optional[str]:
    """Identity of an op: its code object, captured values, and the
    module globals it references directly by name (helper functions by
    *their* code, constants by value — one level; attributes reached
    through a module object, e.g. ``ops.foo``, are not chased: bump
    ``FP_VERSION`` after editing shared library code).  None when the
    callable has no introspectable code or depends on a value whose only
    representation embeds a memory address (never cached)."""
    try:
        return _code_fingerprint(fn, _seen)
    except _UnstableValue:
        return None


def _code_fingerprint(fn, _seen=None) -> Optional[str]:
    if fn is None:
        return f"loader:v{FP_VERSION}"          # the generic loader op
    if _seen is None:
        _seen = set()
    if id(fn) in _seen:                         # mutually-recursive helpers
        return "recursive"
    _seen.add(id(fn))
    if isinstance(fn, functools.partial):
        inner = _code_fingerprint(fn.func, _seen)
        if inner is None:
            return None
        return hashlib.sha256(
            f"partial|{inner}|"
            f"{_stable([_canon_value(a, _seen) for a in fn.args])}|"
            f"{_stable({k: _canon_value(v, _seen) for k, v in (fn.keywords or {}).items()})}"
            .encode()).hexdigest()
    code = getattr(fn, "__code__", None)
    if code is None:
        call = getattr(type(fn), "__call__", None)
        code = getattr(call, "__code__", None)
        if code is None:
            return None
    parts = [_canon_code(code)]
    closure = getattr(fn, "__closure__", None)
    if closure:
        try:
            parts.append(_stable([_canon_value(c.cell_contents, _seen)
                                  for c in closure]))
        except ValueError:              # empty cell: recursion guard
            return None
    defaults = getattr(fn, "__defaults__", None)
    if defaults:
        parts.append(_stable([_canon_value(d, _seen) for d in defaults]))
    g = getattr(fn, "__globals__", None)
    if g:
        for name in sorted(set(code.co_names) & set(g)):
            v = g[name]
            if isinstance(v, types.ModuleType):
                continue                # module-attr chains: FP_VERSION
            parts.append(f"g:{name}={_stable(_canon_value(v, _seen))}")
    # explicit dependency declaration: callables reached through a module
    # attribute (``vkernels.hash_keys``) are invisible to the direct-
    # global scan above; an op can declare them in ``__fp_includes__`` so
    # editing the kernel invalidates the op's cached outputs.  A
    # *callable* __fp_includes__ is invoked at fingerprint time to
    # produce the tuple — how the relational ops bind to the device
    # ``kdispatch`` currently runs on and, on ``cuda``, to the CUDA
    # sources they launch, so a device flip or a kernel edit changes the
    # fingerprint (kdispatch.fp_includes_join)
    includes = getattr(fn, "__fp_includes__", ()) or ()
    if callable(includes):
        includes = includes() or ()
    for i, dep in enumerate(includes):
        inner = _code_fingerprint(dep, _seen)
        if inner is None:
            return None
        parts.append(f"inc{i}:{inner}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def _canon_code(code) -> str:
    """Address-free canonical text of a code object (consts may hold
    nested code objects whose repr embeds a memory address)."""
    consts = [_canon_code(c) if isinstance(c, types.CodeType)
              else _stable(c) for c in code.co_consts]
    return "|".join([code.co_code.hex(), _stable(consts),
                     _stable(code.co_names), str(code.co_argcount)])


def _canon_value(v, _seen=None):
    """Captured values: canonicalize nested callables via their code, not
    their (address-bearing) repr, and ndarrays by content hash.  A
    code-less callable falls back to its own repr — stable for classes
    and builtins ('<class ...>', '<built-in ...>'); anything
    address-bearing raises and the op becomes uncacheable."""
    if isinstance(v, types.CodeType):
        return _canon_code(v)
    if isinstance(v, np.ndarray):
        return _json_default(v)
    if callable(v):
        return _code_fingerprint(v, _seen) or _json_default(v)
    return v


def node_fingerprint(spec, input_fps: List[str],
                     salt: str = "") -> Optional[str]:
    """Fingerprint one node from its spec + its inputs' fingerprints.
    None (uncacheable) when the op has no code identity, any input is
    uncacheable, or the source file is unreadable."""
    if any(fp is None for fp in input_fps):
        return None
    op = code_fingerprint(spec.fn)
    if op is None:
        return None
    source_fp = None
    row_groups = getattr(spec, "row_groups", None)
    if spec.source is not None:
        try:
            source_fp = source_fingerprint(spec.source, row_groups)
        except (OSError, ValueError, AssertionError):
            return None
    payload_dict = {
        "v": FP_VERSION, "op": op, "source": source_fp,
        "dict_columns": sorted(spec.dict_columns),
        "inputs": input_fps, "salt": salt}
    # loader column subsets (projection pruning) change the output table,
    # so they change the fingerprint; the key is omitted entirely for
    # full loads so pre-existing manifests keep hitting
    cols = getattr(spec, "columns", None)
    if cols is not None:
        payload_dict["columns"] = sorted(cols)
    # likewise row-group subsets (streaming ingest): selection order is
    # output order, so the key keeps the given order; omitted for
    # whole-file loads so pre-existing manifests keep hitting
    if row_groups is not None:
        payload_dict["row_groups"] = [int(g) for g in row_groups]
    payload = json.dumps(payload_dict, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()


def fingerprint_dag(dag, salt: str = "") -> Dict[str, Optional[str]]:
    """Assign ``NodeState.fingerprint`` for every node, topo order."""
    out: Dict[str, Optional[str]] = {}
    for name in dag.topo_order():
        st = dag.nodes[name]
        st.fingerprint = node_fingerprint(
            st.spec, [out[d] for d in st.spec.deps], salt=salt)
        out[name] = st.fingerprint
    return out
