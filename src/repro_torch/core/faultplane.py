"""Unified fault-injection plane — one deterministic injector for every
crash/stall/corruption hook in the runtime.

The ad-hoc ``ZERROW_CRASH=<point>:<n>`` SIGKILL machinery that grew inside
``core/manifest.py`` is promoted here and generalized: the manifest publish
sequence, the ``zarquet.StreamWriter`` commit sequence, the flight worker
loop, the flight client, the executor's dispatch path and the ingest
refresh loop all report *fault points* to one :class:`FaultPlane`, which
decides — deterministically — whether anything fires.

Configuration is env-driven (inherited by spawned flight workers, which is
how cross-process injection works) or programmatic (current process only):

    ZERROW_FAULTS="<point>=<action>[:<arg>][@<sel>][,<point>=...]"

      action   kill           SIGKILL the process at the point
               raise          raise FaultInjected at the point
               delay:<s>      sleep s seconds, then continue (slow worker)
               stall:<s>      sleep s seconds, then continue — same effect,
                              separate name: used on socket paths where the
                              sleep is meant to push a peer past its reply
                              deadline (timeout-path testing)
               torn           returned to the call site, which performs its
                              own partial write and then calls :func:`kill`
                              (torn-tail crash points)
               corrupt        returned to the call site, which flips bytes
                              in the artifact it is about to produce
      sel      @n             fire on the n-th hit and every later one
                              (matches the legacy ZERROW_CRASH counting)
               @/n            fire on every n-th hit (periodic)
               @p<f>s<seed>   fire with probability f per hit, from a
                              dedicated random.Random(seed) — seedable, so
                              two processes given the same seed and hit
                              order inject identically
      default  @1 (every hit)

    ZERROW_CRASH="<point>:<n>"   legacy spelling, still honored:
      equivalent to "<point>=kill@n" — or "<point>=torn@n" when the point
      name contains "torn" (the call site tears its own write).

Programmatic use (tests): ``PLANE.install("stream_pre_sidecar", "raise")``,
``PLANE.reset()``.  Hit counters are per-process; ``fire`` is cheap when
nothing is installed (two env lookups + a dict probe), so production paths
keep their hooks permanently.

This module also hosts :class:`StragglerDetector` — the per-key EWMA +
median-factor straggler test shared by the flight worker pool's health
tracking and the training loop's ``runtime.fault.FleetMonitor``, so the
two cannot drift apart.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["FaultInjected", "FaultPlane", "FaultSpec", "PLANE",
           "StragglerDetector", "corrupt_file", "fire", "kill",
           "register_hook", "HOOKS"]


class FaultInjected(RuntimeError):
    """Raised at a fault point armed with the ``raise`` action."""


#: catalog of registered fault points -> description (the hook catalog
#: rendered in docs/ARCHITECTURE.md "Overload & fault model"); modules
#: register their points at import so the catalog is always current
HOOKS: Dict[str, str] = {}


def register_hook(point: str, description: str) -> str:
    HOOKS[point] = description
    return point


@dataclass
class FaultSpec:
    """One armed fault: what fires at a point, and when."""
    point: str
    action: str = "kill"          # kill|raise|delay|stall|torn|corrupt
    arg: float = 0.0              # seconds for delay/stall
    at: int = 1                   # fire when hits >= at ...
    every: Optional[int] = None   # ... or on every n-th hit instead
    p: Optional[float] = None     # ... or Bernoulli(p) per hit (seeded)
    seed: int = 0
    count: Optional[int] = None   # max total fires (None = unlimited)

    def __post_init__(self):
        self._rng = random.Random(self.seed) if self.p is not None else None
        self._fired = 0

    def armed(self, hits: int) -> bool:
        if self.count is not None and self._fired >= self.count:
            return False
        if self.p is not None:
            hot = self._rng.random() < self.p
        elif self.every is not None:
            hot = hits % self.every == 0
        else:
            hot = hits >= self.at
        if hot:
            self._fired += 1
        return hot


_ACTIONS = ("kill", "raise", "delay", "stall", "torn", "corrupt")


def _parse_spec(tok: str) -> Optional[FaultSpec]:
    """Parse one ``point=action[:arg][@sel]`` token; None when malformed
    (injection config errors must never take the runtime down)."""
    try:
        point, _, rest = tok.strip().partition("=")
        if not point or not rest:
            return None
        sel = ""
        if "@" in rest:
            rest, _, sel = rest.partition("@")
        action, _, arg = rest.partition(":")
        if action not in _ACTIONS:
            return None
        spec = FaultSpec(point, action, float(arg or 0.0))
        if sel.startswith("/"):
            spec.every = max(int(sel[1:]), 1)
        elif sel.startswith("p"):
            body = sel[1:]
            p, _, seed = body.partition("s")
            spec.p = min(max(float(p), 0.0), 1.0)
            spec.seed = int(seed or 0)
            spec.__post_init__()         # rebuild the seeded rng
        elif sel:
            spec.at = max(int(sel), 1)
        return spec
    except (ValueError, TypeError):
        return None


def _parse_env(faults: str, crash: str) -> Dict[str, FaultSpec]:
    specs: Dict[str, FaultSpec] = {}
    if crash:
        point, _, n = crash.partition(":")
        action = "torn" if "torn" in point else "kill"
        specs[point] = FaultSpec(point, action, at=int(n or 1))
    for tok in faults.split(","):
        if not tok.strip():
            continue
        spec = _parse_spec(tok)
        if spec is not None:
            specs[spec.point] = spec
    return specs


class FaultPlane:
    """Deterministic fault injector: per-point hit counters + armed specs.

    Programmatic specs (``install``) apply to this process; env specs
    (``ZERROW_FAULTS`` / legacy ``ZERROW_CRASH``) are re-read whenever the
    variables change, so a test can arm a point after import and a spawned
    worker inherits the parent's injection config through its environment.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: Dict[str, FaultSpec] = {}
        self._hits: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._env_raw: Tuple[str, str] = ("", "")
        self._env_specs: Dict[str, FaultSpec] = {}

    # -- configuration -----------------------------------------------------
    def install(self, point: str, action: str = "kill", arg: float = 0.0,
                at: int = 1, every: Optional[int] = None,
                p: Optional[float] = None, seed: int = 0,
                count: Optional[int] = None) -> FaultSpec:
        """Arm one fault point programmatically (this process only)."""
        assert action in _ACTIONS, f"unknown fault action {action!r}"
        spec = FaultSpec(point, action, arg, at, every, p, seed, count)
        with self._lock:
            self._specs[point] = spec
        return spec

    def remove(self, point: str) -> None:
        with self._lock:
            self._specs.pop(point, None)

    def reset(self) -> None:
        """Drop every programmatic spec and all hit/fire counters."""
        with self._lock:
            self._specs.clear()
            self._hits.clear()
            self._fired.clear()
            self._env_raw = ("", "")
            self._env_specs = {}

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def fired(self, point: str) -> int:
        with self._lock:
            return self._fired.get(point, 0)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {"hits": dict(self._hits), "fired": dict(self._fired)}

    # -- the hot path ------------------------------------------------------
    def _spec_for(self, point: str) -> Optional[FaultSpec]:
        spec = self._specs.get(point)
        if spec is not None:
            return spec
        raw = (os.environ.get("ZERROW_FAULTS", ""),
               os.environ.get("ZERROW_CRASH", ""))
        if raw != self._env_raw:
            self._env_specs = _parse_env(*raw)
            self._env_raw = raw
        return self._env_specs.get(point)

    def fire(self, point: str) -> Optional[str]:
        """Report one hit at ``point``.  Executes kill/raise/delay/stall
        in place; returns the action name for torn/corrupt (the call site
        applies those itself), the executed action's name for delay/stall,
        or None when nothing was armed."""
        with self._lock:
            spec = self._spec_for(point)
            if spec is None:
                return None       # unarmed: a dict probe + two env reads
            self._hits[point] = hits = self._hits.get(point, 0) + 1
            if not spec.armed(hits):
                return None
            self._fired[point] = self._fired.get(point, 0) + 1
            action, arg = spec.action, spec.arg
        if action == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if action == "raise":
            raise FaultInjected(f"injected fault at {point!r}")
        if action in ("delay", "stall"):
            time.sleep(arg)
        return action


#: the process-wide plane (workers get their own via env inheritance)
PLANE = FaultPlane()


def fire(point: str) -> Optional[str]:
    """Module-level convenience: ``faultplane.fire("stream_pre_footer")``."""
    return PLANE.fire(point)


def kill() -> None:
    """SIGKILL this process — the second half of a torn-write fault (the
    call site writes its partial record first, then dies)."""
    os.kill(os.getpid(), signal.SIGKILL)


def corrupt_file(path: str, offset: int = 0, nbytes: int = 1) -> None:
    """Flip ``nbytes`` bytes of ``path`` in place (bit-rot simulation for
    corrupt-object detection tests).  Never used on live store files —
    content-addressed objects are hard links to them, so corrupting an
    object at rest means corrupting it *between* runs, after the writer
    process exited."""
    with open(path, "r+b") as fh:
        fh.seek(offset)
        chunk = fh.read(nbytes)
        fh.seek(offset)
        fh.write(bytes(b ^ 0xFF for b in chunk))


# --------------------------------------------------------------------------
# shared straggler detection
# --------------------------------------------------------------------------

class StragglerDetector:
    """Per-key service-time EWMA + median-factor straggler test.

    One implementation for both consumers so the two cannot drift:

      * ``runtime.fault.FleetMonitor`` — training-fleet heartbeats (keys
        are worker ids, samples are step times);
      * ``core.flight.worker.FlightWorkerPool.health`` — serving-plane
        request service times (keys are worker pids).

    ``update`` folds one sample into the key's EWMA; ``flag`` returns the
    keys whose EWMA exceeds ``factor`` x the population median (needing at
    least ``min_peers`` populated keys, since a median over fewer is
    noise).  Thread-safe: pool receiver threads update concurrently.
    """

    def __init__(self, alpha: float = 0.3, factor: float = 1.7,
                 min_peers: int = 3):
        self.alpha = alpha
        self.factor = factor
        self.min_peers = min_peers
        self._lock = threading.Lock()
        self._ewma: Dict[object, float] = {}

    def update(self, key, sample: float) -> float:
        with self._lock:
            prev = self._ewma.get(key, 0.0)
            cur = sample if prev == 0 \
                else self.alpha * sample + (1 - self.alpha) * prev
            self._ewma[key] = cur
            return cur

    def ewma(self, key) -> float:
        with self._lock:
            return self._ewma.get(key, 0.0)

    def drop(self, key) -> None:
        with self._lock:
            self._ewma.pop(key, None)

    def flag(self, keys: Optional[Iterable] = None
             ) -> Tuple[List, float]:
        """Returns ``(stragglers, median)`` over ``keys`` (default: every
        key with a populated EWMA)."""
        with self._lock:
            pop = {k: v for k, v in self._ewma.items()
                   if v > 0 and (keys is None or k in keys)} \
                if keys is None or not isinstance(keys, (set, frozenset)) \
                else {k: self._ewma[k] for k in keys
                      if self._ewma.get(k, 0.0) > 0}
        if len(pop) < self.min_peers:
            return [], 0.0
        times = sorted(pop.values())
        median = times[len(times) // 2]
        return ([k for k, v in pop.items() if v > self.factor * median],
                median)
