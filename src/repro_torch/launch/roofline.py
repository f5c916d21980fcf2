"""Roofline analysis of a step as torch runs it, on the H100: the JAX
package's ``launch/roofline.py`` (TPU v5e constants, a walk over XLA's
HLO text) for the port, which has no HLO.

Three terms per (arch x shape x mesh), in seconds:

    compute    = counted FLOPs / card's peak for their unit
                 (989 TFLOP/s bf16 on the tensor cores, 67 float32)
    memory     = analytic HBM bytes per card / 3.35 TB/s
    collective = collective payload per card / link rate
                 (450 GB/s NVLink within a node of 8, 50 GB/s across nodes)

``StepCounter`` counts one run of the step, per device (the local shards
of every DTensor, as XLA's per-device SPMD program counts):

- products by the formulas of ``torch.utils.flop_counter`` (its
  ``flop_registry``: mm, bmm, addmm, baddbmm, convolutions, attention),
  split by unit: bf16 and float16 inputs on the tensor cores, the rest on
  the CUDA cores (float32 products run there: torch leaves TF32 off);
- bytes as the sum over ops of their inputs and outputs (views move
  nothing), the counterpart of ``hlo_bytes_upper_bound``: no reuse;
- the hand-written kernels from their own wrappers (``kernels/ops.py``
  reports ``kernels/costs.py``'s count for each call and hides its own
  ATen ops, so its plain version on the CPU is not counted): a step
  counts the same on ``cuda``, ``cpu`` and ``meta``;
- collectives from the functional collectives DTensor issues (and the
  c10d ops of a direct ``dist.all_reduce``), by kind, group size and
  whether the group spans nodes; each one's payload by the JAX ring
  accounting (``collective_payload``): all-reduce 2(n-1)/n of its output,
  all-gather, reduce-scatter and all-to-all (n-1)/n, permute 1;
- the live local storages the step allocates, for its peak memory;
- copies between the host and the card apart (``host_copy_bytes``): on
  the CPU they are no op at all.

``analytic_model``, ``analytic_hbm_bytes`` and ``kv_cache_bytes`` are the
JAX package's, verbatim: the independent cross-check of every cell.
``roofline_report`` gives the JAX keys (the ``hlo_*`` ones hold the
counted step's numbers) without ``xla_cost_*``; the JAX package's
``cpu_promotion_bytes`` (f32 staging copies XLA's CPU backend makes) has
no counterpart, as no XLA compiles the step.
"""

from __future__ import annotations

import weakref
from collections import Counter
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import ops

# -- hardware constants: NVIDIA H100 Tensor Core GPU datasheet, SXM5 -------
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
F32_FLOPS = 67e12            # float32, CUDA cores
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s a direction, NVLink 4 within a node
NIC_BW = 50e9                # bytes/s, one 400 Gb/s NDR NIC a card
CARDS_PER_NODE = 8

TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)

#: functional collective (or c10d op) -> the JAX kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast_": "collective-permute",
}
#: ops that move no bytes of their own
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd"}


def collective_payload(kind: str, out_bytes: float, n: int) -> float:
    """Bytes a card sends for one collective over ``n`` cards whose output
    holds ``out_bytes`` on it: the JAX ring accounting
    (``HloAnalyzer._coll_payload``)."""
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * out_bytes * frac
    if kind == "collective-permute":
        return float(out_bytes)
    return out_bytes * frac


def _tensors(tree):
    """The plain tensors of a tree (DTensors as their local shards; a
    module's parameters and buffers)."""
    if isinstance(tree, torch.nn.Module):
        yield from _tensors(list(tree.parameters()) + list(tree.buffers()))
    elif isinstance(tree, DTensor):
        yield tree.to_local()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group(args) -> Optional[Tuple[int, bool]]:
    """(size, spans nodes) of the process group a collective's args name:
    a functional collective's group name, or a c10d op's group."""
    for a in args:
        pg = None
        if isinstance(a, str):
            try:
                pg = dist.distributed_c10d._resolve_process_group(a)
            except (KeyError, RuntimeError, ValueError):
                continue
        elif hasattr(a, "size") and hasattr(a, "rank") \
                and not isinstance(a, torch.Tensor):
            pg = a
        if pg is None:
            continue
        try:
            ranks = dist.get_process_group_ranks(pg)
        except (RuntimeError, ValueError):
            ranks = list(range(pg.size()))
        nodes = {r // CARDS_PER_NODE for r in ranks}
        return len(ranks), len(nodes) > 1
    return None


class StepCounter(TorchDispatchMode):
    """Count what runs inside ``with StepCounter(args) as c:`` (see the
    module docstring); ``args`` are the step's inputs (the weights, the
    batch, the caches or train state), whose local bytes are its argument
    bytes and whose storages are not counted as allocated.  ``record()``
    gives the counts as plain data, which ``roofline_report`` and
    ``launch/reanalyze.py`` read."""

    def __init__(self, args=None):
        super().__init__()
        self.flops = {"tensor_cores": 0.0, "cuda_cores": 0.0}
        self.nbytes = 0.0
        self.host_copy_bytes = 0.0
        self.kernels: Dict[str, Dict] = {}
        self.collectives: Dict[Tuple, Dict] = {}
        self.ops: Counter = Counter()
        self._hidden = 0
        self._known: Dict[int, weakref.ref] = {}
        self.arg_bytes = 0
        for t in _tensors(args):
            st = t.untyped_storage()
            if id(st) not in self._known:
                self._known[id(st)] = weakref.ref(st)
                self.arg_bytes += st.nbytes()
        self._live: Dict[int, int] = {}
        self.live_bytes = self.peak_bytes = 0

    # -- what the kernel wrappers call --------------------------------------
    def __enter__(self):
        ops.cost_counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.cost_counters.remove(self)
        return super().__exit__(*exc)

    def hide(self) -> None:
        self._hidden += 1

    def show(self) -> None:
        self._hidden -= 1

    def add_kernel(self, name: str, cost, out) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0, "tensor_cores":
                                           cost.tensor_cores})
        k["calls"] += 1
        k["flops"] += cost.flops
        k["bytes"] += cost.nbytes
        self._track(out)

    # -- memory ------------------------------------------------------------
    def _is_arg(self, st) -> bool:
        ref = self._known.get(id(st))
        return ref is not None and ref() is st

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._live or self._is_arg(st):
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += self._live[key]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def memory(self, out) -> Dict[str, int]:
        """Bytes per device: the arguments', the peak of what the step
        allocated beyond them (temp), what of it ``out`` holds (output)
        and what of ``out`` lies in the arguments' storages (alias: the
        caches a decode step updates in place)."""
        seen, output, alias = set(), 0, 0
        for t in _tensors(out):
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            if self._is_arg(st):
                alias += st.nbytes()
            else:
                output += st.nbytes()
        return {"arg_bytes_per_device": self.arg_bytes,
                "temp_bytes_per_device": self.peak_bytes,
                "output_bytes_per_device": output,
                "alias_bytes_per_device": alias,
                "peak_bytes_per_device": self.arg_bytes + self.peak_bytes}

    # -- the ops -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs first and sends its local ops (and the
            # collectives of its redistributions) back through this mode
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._hidden or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            # a kernel wrapper's own ops, or DTensor's sharding
            # propagation, which runs each op it has not planned yet on
            # fake tensors of the global shapes
            return out
        name = func._overloadpacket.__name__
        if name in ("_to_copy", "copy_") and self._crosses(args, out):
            # a table made on the host and copied to the card (RoPE's
            # frequencies): a PCIe transfer, and no op at all on the CPU
            self.host_copy_bytes += sum(_nbytes(t) for t in _tensors(out))
            self._track(out)
            return out
        self.ops[str(func._overloadpacket)] += 1
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            self._collective(kind, args, out)
        elif func._overloadpacket in flop_registry:
            n = flop_registry[func._overloadpacket](*args, **kwargs,
                                                    out_val=out)
            first = next(_tensors(args), None)
            unit = "tensor_cores" if first is not None \
                and first.dtype in TENSOR_CORE_DTYPES else "cuda_cores"
            self.flops[unit] += n
        if name not in _FREE and not func.is_view:
            self.nbytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.nbytes += sum(_nbytes(t) for t in _tensors(out))
        self._track(out)
        return out

    @staticmethod
    def _crosses(args, out) -> bool:
        devices = {t.device.type for t in _tensors((args, out))}
        return "cpu" in devices and len(devices) > 1

    def _collective(self, kind: str, args, out) -> None:
        group = _group(args)
        if group is None:
            return
        n, spans = group
        key = (kind, n, spans)
        c = self.collectives.setdefault(key, {"calls": 0, "bytes": 0.0})
        c["calls"] += 1
        c["bytes"] += sum(_nbytes(t) for t in _tensors(out))

    def record(self) -> Dict:
        """The counts as plain data (JSON)."""
        return {
            "flops": dict(self.flops),
            "bytes": self.nbytes,
            "host_copy_bytes": self.host_copy_bytes,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "collectives": [
                {"kind": k, "group_size": n, "spans_nodes": s, **v}
                for (k, n, s), v in sorted(self.collectives.items())],
            "ops": dict(sorted(self.ops.items())),
        }


def counted_flops(record: Dict) -> Tuple[float, float]:
    """(tensor-core, CUDA-core) FLOPs of a record, its kernels' included."""
    tc, cc = record["flops"]["tensor_cores"], record["flops"]["cuda_cores"]
    for k in record["kernels"].values():
        if k["tensor_cores"]:
            tc += k["flops"]
        else:
            cc += k["flops"]
    return tc, cc


def counted_bytes(record: Dict) -> float:
    return record["bytes"] + sum(k["bytes"]
                                 for k in record["kernels"].values())


def collective_terms(record: Dict) -> Tuple[float, float, Dict[str, float]]:
    """(payload bytes a card sends, seconds at the link rates, payload by
    kind)."""
    total = secs = 0.0
    by_kind: Dict[str, float] = {}
    for c in record["collectives"]:
        p = collective_payload(c["kind"], c["bytes"], c["group_size"])
        total += p
        secs += p / (NIC_BW if c["spans_nodes"] else NVLINK_BW)
        by_kind[c["kind"]] = by_kind.get(c["kind"], 0.0) + p
    return total, secs, by_kind


# --------------------------------------------------------------------------
# analytic cross-check model (the JAX package's, verbatim)
# --------------------------------------------------------------------------

def analytic_model(arch, shape, n_params: int, n_active: int) -> Dict:
    """MODEL_FLOPS and exact byte counts from the config."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * S
        flops = 6.0 * n_active * tokens
        # + attention quadratic term 12·L·d·S²·B (dense archs)
        if arch.family not in ("ssm",):
            n_attn = arch.n_layers
            if arch.family == "hybrid" and arch.block_pattern:
                n_attn = arch.n_layers // len(arch.block_pattern) * \
                    arch.block_pattern.count("attn")
            eff_S = min(S, arch.local_window) if arch.family == "hybrid" \
                else S
            flops += 12.0 * n_attn * arch.n_heads * arch.hd * eff_S * B * S
        bytes_ = 2 * n_params * 4        # rough: read+write fp32 grads/opt
    elif shape.kind == "prefill":
        tokens = B * S
        flops = 2.0 * n_active * tokens
        if arch.family not in ("ssm",):
            flops += 4.0 * arch.n_layers * arch.n_heads * arch.hd * S * S * B
        bytes_ = n_params * 2
    else:  # decode: one token per sequence
        tokens = B
        flops = 2.0 * n_active * tokens
        bytes_ = n_params * 2 + kv_cache_bytes(arch, shape)
    return {"model_flops": flops, "model_bytes": float(bytes_),
            "tokens": tokens}


def analytic_hbm_bytes(arch, shape, *, chips: int, mp: int, dp: int,
                       accum: int, n_params: int) -> float:
    """Per-chip HBM traffic estimate for one step.

    train: per microbatch each chip reads its model-shard of the gathered
    f32 weights twice (fwd + bwd), plus optimizer state r/w, the remat
    carry write+read+recompute, and the (transient) logits.
    serve:  bf16 weight read per step + KV cache read(+write).
    """
    P = float(n_params)
    L = arch.n_layers + arch.encoder_layers
    if shape.kind == "train":
        w = accum * 2 * (P / mp) * 4
        opt = 10 * (P / chips) * 4
        tokens_chip = shape.global_batch * shape.seq_len / dp
        act = 3 * L * tokens_chip * arch.d_model * 2
        logits = 3 * (tokens_chip / accum) * (arch.vocab / mp) * 4
        return w + opt + act + logits
    if shape.kind == "prefill":
        w = 2 * (P / mp) * 2
        kv = 2 * kv_cache_bytes(arch, shape) / chips
        # flash tiles re-read KV once per q-block column pass (~S/bq)
        return w + kv * 2
    # decode: one token; weights + cache dominate utterly
    w = (P / mp) * 2
    kv = 2 * kv_cache_bytes(arch, shape) / chips
    return w + kv


def kv_cache_bytes(arch, shape) -> float:
    B, S = shape.global_batch, shape.seq_len
    if arch.family == "ssm":
        N = arch.rwkv_head_dim
        H = arch.d_model // N
        return arch.n_layers * B * (H * N * N * 4 + 2 * arch.d_model * 2)
    eff = S
    n_attn = arch.n_layers
    extra = 0.0
    if arch.family == "hybrid" and arch.block_pattern:
        k = len(arch.block_pattern)
        n_attn = arch.n_layers // k * arch.block_pattern.count("attn")
        n_rec = arch.n_layers - n_attn
        eff = min(S, arch.local_window or S)
        w = arch.lru_width or arch.d_model
        extra = n_rec * B * (w * 4 + (arch.conv_width - 1) * w * 2)
    per_layer = 2 * B * eff * arch.n_kv_heads * arch.hd * 2
    total = n_attn * per_layer + extra
    if arch.is_encdec:
        total += 2 * arch.n_layers * B * S * arch.n_kv_heads * arch.hd * 2
    return float(total)


# --------------------------------------------------------------------------
# report
# --------------------------------------------------------------------------

def roofline_report(record: Dict, *, chips: int, arch, shape,
                    n_params: int, n_active: int, mp: int = 16,
                    dp: Optional[int] = None, accum: int = 1) -> Dict:
    """The JAX report's keys from a ``StepCounter.record()`` (per device),
    and the port's own: the FLOPs by unit and the kernels' counts."""
    tc, cc = counted_flops(record)
    flops = tc + cc
    dp = dp if dp is not None else max(chips // mp, 1)
    compute_s = tc / PEAK_FLOPS + cc / F32_FLOPS
    hbm_bytes = analytic_hbm_bytes(arch, shape, chips=chips, mp=mp, dp=dp,
                                   accum=accum, n_params=n_params)
    memory_s = hbm_bytes / HBM_BW
    coll_bytes, coll_s, by_kind = collective_terms(record)
    model = analytic_model(arch, shape, n_params, n_active)
    model_flops_per_chip = model["model_flops"] / chips
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    useful = model_flops_per_chip / flops if flops else 0.0
    bound = max(terms.values())
    return {
        "chips": chips,
        "hlo_flops_per_chip": flops,
        "hbm_bytes_per_chip": hbm_bytes,
        "hlo_bytes_upper_bound": counted_bytes(record),  # per-op sum
        "collective_bytes_per_chip": coll_bytes,
        "collective_by_kind": by_kind,
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops_total": model["model_flops"],
        "model_bytes_total": model["model_bytes"],
        "useful_flop_fraction": useful,
        "step_time_bound_s": bound,
        "roofline_fraction": (model_flops_per_chip / PEAK_FLOPS) / bound
        if bound else 0.0,           # useful-compute time / bound (≈ MFU cap)
        "tokens": model["tokens"],
        "flops_tensor_cores": tc,
        "flops_cuda_cores": cc,
        "kernels": record["kernels"],
    }
