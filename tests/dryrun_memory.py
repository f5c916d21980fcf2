"""A cell's memory per device on meta, in the port and in the JAX package,
side by side: the port's dry-run peak (``repro_torch.launch.dryrun``)
with the largest storages live at that peak, by the op that made them,
and the JAX package's ``memory_analysis()`` of the same cell, both cut to
the same depth (``--no-jax``: the port's alone, at any depth).  Not a
test (pytest collects ``test_*.py`` only); it lives here because it
imports both packages.  It is also a check: it exits 1 when a storage
shaped like the global batch's embedding (B, S, d) is live at the port's
peak, or when the port's temp a device is above twice the JAX package's
on the same mesh.

    PYTHONPATH=src python tests/dryrun_memory.py --arch nemotron-4-340b \\
        --shape prefill_32k --layers 2 --mesh single multi

``port_peak`` imports no JAX (the JAX dry-run, imported by ``jax_memory``
alone, sets 512 host devices for its process), so a test may call it.
"""
import argparse
import collections
import dataclasses
import sys

from repro_torch.configs import SHAPES_BY_NAME, get_arch
from repro_torch.launch import dryrun, roofline


def port_peak(arch, shape: str, mesh: str, top=6):
    """The port's lower_cell on meta, and the largest storages live when
    its counter reached the peak: [(bytes, count, (op, shape, dtype))],
    the ``top`` largest (None: all)."""
    made, snap, cur = {}, {}, [None]
    dispatch = roofline.StepCounter.__torch_dispatch__
    track = roofline.StepCounter._track

    def named_dispatch(self, func, types, args=(), kwargs=None):
        prev, cur[0] = cur[0], func._overloadpacket.__name__
        try:
            return dispatch(self, func, types, args, kwargs)
        finally:
            cur[0] = prev

    def noted_track(self, out):
        before, peak = set(self._live), self.peak_bytes
        track(self, out)
        for t in roofline._tensors(out):
            key = id(t.untyped_storage())
            if key in self._live and key not in before:
                made[key] = (cur[0], tuple(t.shape), str(t.dtype)[6:],
                             self._live[key])
        if self.peak_bytes > peak:
            snap["live"] = [made.get(k) for k in self._live]

    roofline.StepCounter.__torch_dispatch__ = named_dispatch
    roofline.StepCounter._track = noted_track
    try:
        ok, info = dryrun.lower_cell(arch, shape, mesh, save=False)
    finally:
        roofline.StepCounter.__torch_dispatch__ = dispatch
        roofline.StepCounter._track = track
    size, count = collections.Counter(), collections.Counter()
    for m in filter(None, snap.get("live", [])):
        size[m[:3]] += m[3]
        count[m[:3]] += 1
    return ok, info, [(b, count[k], k) for k, b in size.most_common(top)]


def jax_memory(name: str, layers: int, shape: str, mesh: str) -> dict:
    from repro.launch import dryrun as jax_dryrun  # sets 512 host devices
    get = jax_dryrun.get_arch
    jax_dryrun.get_arch = lambda n: dataclasses.replace(get(n),
                                                        n_layers=layers)
    try:
        ok, info = jax_dryrun.lower_cell(name, shape, mesh, save=False)
    finally:
        jax_dryrun.get_arch = get
    return {k: v for k, v in info.items() if k.endswith("bytes_per_device")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--mesh", nargs="+", default=["single", "multi"])
    ap.add_argument("--no-jax", action="store_true")
    args = ap.parse_args()
    arch = dataclasses.replace(get_arch(args.arch), n_layers=args.layers)
    cell = SHAPES_BY_NAME[args.shape]
    whole = (cell.global_batch, cell.seq_len, arch.d_model)
    failed = []
    for mesh in args.mesh:
        ok, info, live = port_peak(arch, args.shape, mesh, top=None)
        temp = info["temp_bytes_per_device"]
        print(f"port {args.arch} x {args.shape} x {mesh}, {args.layers} "
              f"layers: ok {ok}, arg {info['arg_bytes_per_device']} B, "
              f"temp {temp} B a device; live at the peak:")
        for b, n, (op, shp, dt) in live[:6]:
            print(f"  {b} B in {n} storage(s) from {op} {shp} {dt}")
        big = [k for _, _, k in live if k[1] == whole]
        if big:
            failed.append(f"{mesh}: {whole} live at the peak: {big}")
        if args.no_jax:
            continue
        jax = jax_memory(args.arch, args.layers, args.shape, mesh)
        jtemp = jax["temp_bytes_per_device"]
        print(f"jax  {args.arch} x {args.shape} x {mesh}, {args.layers} "
              f"layers: {jax}; the port's temp {temp / jtemp:.3f} x JAX's")
        if temp > 2 * jtemp:
            failed.append(f"{mesh}: temp {temp} B over twice JAX's "
                          f"{jtemp} B")
    print(f"gate: {failed or 'met'}")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
