"""Eviction: victim selection + the rollback/limitdrop/adaptive mechanisms
(paper §3.3, Fig 3a RM:uncache / RM:rollback / RM:limitdrop).

An :class:`EvictionPolicy` owns

  * the *memory-freeing sequence*: first uncache zero-reference DeCache
    entries, then evict completed-node outputs one by one;
  * the *victim order* (shared by all mechanisms): least-progressed DAG
    first, ties broken by DAG id descending (the next DAG the scheduler
    will pick is needed soonest), deepest output first within a DAG
    ('rollback the pipeline');
  * the *mechanism* applied to a victim (``evict``), which is what the
    subclasses differ in.

Policies register themselves in :data:`POLICIES` and are selected by name
via ``RMConfig(policy=...)``.  Share-awareness: mechanisms operate on
virtual Arrow artifacts; underlying files are freed only when refcounts
hit zero (the RM's ``_gc``), so resharing never causes use-after-free.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple, Type

from ..dag import COMPLETE, DONE, EVICTED, NodeState

POLICIES: Dict[str, Type["EvictionPolicy"]] = {}


def register_eviction(cls: Type["EvictionPolicy"]) -> Type["EvictionPolicy"]:
    POLICIES[cls.name] = cls
    return cls


def get_eviction(name: str, rm) -> "EvictionPolicy":
    try:
        return POLICIES[name](rm)
    except KeyError:
        raise KeyError(f"unknown eviction policy {name!r}; "
                       f"choose from {sorted(POLICIES)}") from None


class EvictionPolicy:
    """Base: uncache sequencing + victim ordering.  ``rm`` is the owning
    ResourceManager (accounting: counters, completed set, refcount GC)."""

    name = ""
    evicts_outputs = True     # False: only kernel swap / nothing (baselines)

    MAX_EVICTIONS_PER_ALLOC = 8   # bound eviction storms: past this the
    #                             # node runs over budget instead of the RM
    #                             # rolling back half the fleet's progress
    MAX_RERUNS = 4                # progress guard: a node re-run more than
    #                             # this many times keeps its output until
    #                             # its consumers have run (see ``victims``)

    def __init__(self, rm):
        self.rm = rm

    # -- the memory-freeing sequence (paper §3.3) -------------------------
    def free_memory(self, need: int, protect: Optional[NodeState] = None,
                    extra_protect: FrozenSet[Tuple[int, str]] = frozenset(),
                    ) -> int:
        rm = self.rm
        freed = 0
        # 1) uncache DeCache entries with no active references
        for e in rm.decache.uncache_candidates():
            if freed >= need:
                return freed
            freed += rm.decache.uncache(e)
            rm.evictions["uncache"] += 1
        # 2) evict outputs of the lowest-priority completed nodes.  Only
        # *productive* evictions count toward the storm bound: a victim
        # that frees nothing (already-spilled durable output, sandbox-
        # less limitdrop target) must not eat the budget and starve the
        # reclaimable victims behind it.
        if not self.evicts_outputs:
            return freed
        n_evicted = 0
        for st in self.victims(protect, extra_protect):
            if freed >= need:
                break
            if n_evicted >= self.MAX_EVICTIONS_PER_ALLOC:
                # storm bound tripped: the node runs over budget rather
                # than the RM rolling back half the fleet's progress.
                # Counted so the overload bench can prove the eviction
                # loop degraded (bounded) instead of livelocking.
                rm.evictions["storm_breaks"] += 1
                break
            got = self.evict(st)
            freed += got
            if got > 0:
                n_evicted += 1
        return freed

    # -- victim selection --------------------------------------------------
    def victims(self, protect: Optional[NodeState] = None,
                extra_protect: Iterable[Tuple[int, str]] = (),
                ) -> List[NodeState]:
        """Eviction candidates in victim order.  ``protect`` shields the
        dependencies of the node about to run; ``extra_protect`` shields
        (dag_id, node_name) pairs depended on by in-flight nodes."""
        rm = self.rm
        protected = set(extra_protect)
        if protect is not None:
            protected |= {(protect.dag.id, d) for d in protect.spec.deps}
        # keep_output nodes are excluded: their message is promised to an
        # external consumer after the run, and a rolled-back sink with no
        # un-run children would never be re-executed (data loss) — newly
        # reachable now that consumers submit multi-DAG groups per run
        cands = [st for st in rm.completed_nodes
                 if st.status in COMPLETE and st.output is not None
                 and not st.output.released
                 and not st.spec.keep_output
                 and (st.dag.id, st.name) not in protected
                 and not (st.is_loader and rm.decache.enabled)
                 and not self.pinned(st)]
        # Victim order: lowest-priority = scheduled LAST.  Least-progressed
        # DAG first; ties broken by dag id DESCENDING (the scheduler picks
        # ascending ids, so the highest id is needed latest — evicting the
        # next-to-run DAG's frontier would thrash).  Within a DAG, deepest
        # output first — releasing the pipeline frontier is what actually
        # frees exclusively-owned files ('rollback the pipeline', §3.3).
        progress = {}
        for st in cands:
            d = st.dag
            if d.id not in progress:
                done = sum(1 for n in d.nodes.values()
                           if n.status in COMPLETE)
                progress[d.id] = done / max(len(d.nodes), 1)
        cands.sort(key=lambda st: (progress[st.dag.id], -st.dag.id,
                                   -st.depth))
        return cands

    def pinned(self, st: NodeState) -> bool:
        """The progress guard.  Under a schedule that interleaves DAGs
        (breadth, fair), rollback can evict a node's output to make room
        for a peer's node, re-run it for its consumer, and evict it again
        for the peer, forever: each of two chains' loaders re-ran without
        end, and no consumer ran.  A node that has run more than
        ``MAX_RERUNS`` + 1 times therefore pins its output, the input of
        its consumers, until every consumer has run.  Where the JAX
        package's scheduler finishes (the matrix of policies and schedules
        in tests/test_torch_core_sched.py), no node re-runs more than
        twice, so the guard changes nothing there."""
        if st.runs <= self.MAX_RERUNS + 1:
            return False
        return any(st.dag.nodes[c].status != DONE
                   for c in st.dag.children[st.name])

    # -- the mechanism -----------------------------------------------------
    def evict(self, st: NodeState) -> int:
        """Apply this policy's mechanism to one victim; return bytes freed."""
        raise NotImplementedError

    def spill(self, st: NodeState) -> int:
        """Durable outputs (published in / adopted from the manifest) are
        *spilled*: resident mappings dropped, bytes kept in the content-
        addressed objects.  The node stays in ``completed_nodes`` — a
        reader may fault the output back to resident, after which it
        must be spillable again."""
        rm = self.rm
        freed = 0
        for fid in st.output.files_referenced():
            freed += rm.store.swap_out_file(fid)
        if freed > 0:
            rm.evictions["spill"] += 1
        return freed


@register_eviction
class NoEviction(EvictionPolicy):
    """Admission only — no RM-driven eviction at all."""

    name = "none"
    evicts_outputs = False

    def evict(self, st: NodeState) -> int:
        return 0


@register_eviction
class KswapEviction(EvictionPolicy):
    """Baseline: leave memory pressure to the store's global LRU kswap."""

    name = "kswap"
    evicts_outputs = False

    def evict(self, st: NodeState) -> int:
        return 0


@register_eviction
class RollbackEviction(EvictionPolicy):
    """RM:rollback — delete a completed node's outputs; re-execute the node
    later if un-run children still need them (cascading up the pipeline if
    its own inputs were GC'd).

    Durable outputs (published in — or adopted from — the persistent
    manifest) are *spilled* instead of discarded: the resident mappings
    are dropped and the bytes stay in the content-addressed object files,
    so reclaiming memory never costs a recompute that a disk read can
    serve (counted separately in ``rm.evictions['spill']``)."""

    name = "rollback"

    def evict(self, st: NodeState) -> int:
        rm = self.rm
        if rm.is_durable(st):
            return self.spill(st)
        freed = rm._resident_of(st.output)
        msg = st.output
        st.output = None
        msg.release()
        rm._gc(msg)
        # re-execution is only scheduled if un-run children still need the
        # output (otherwise the release is pure GC; a later cascading
        # rollback can still resurrect it via the executor's dep repair)
        kids = [st.dag.nodes[c] for c in st.dag.children[st.name]]
        if any(k.status != DONE for k in kids):
            st.transition(EVICTED)
        rm.evictions["rollback"] += 1
        if st in rm.completed_nodes:
            rm.completed_nodes.remove(st)
        return freed


@register_eviction
class LimitDropEviction(EvictionPolicy):
    """RM:limitdrop — drop the node sandbox's cgroup limit so its tmpfs
    output swaps to disk; restore the limit afterwards."""

    name = "limitdrop"

    def evict(self, st: NodeState) -> int:
        rm = self.rm
        if st.sandbox is None:
            # adopted (CACHED) outputs have no sandbox; durable ones can
            # still be spilled.  Anything else is unevictable by this
            # mechanism: drop it from the candidate set so it cannot
            # clog the victim list forever.
            if rm.is_durable(st):
                return self.spill(st)
            if st in rm.completed_nodes:
                rm.completed_nodes.remove(st)
            return 0
        swapped = st.sandbox.drop_limit_and_swap()
        rm.evictions["limitdrop"] += 1
        if st in rm.completed_nodes:
            rm.completed_nodes.remove(st)   # only evict once
        return swapped


@register_eviction
class AdaptiveEviction(EvictionPolicy):
    """Pick rollback vs limit-dropping per node from the ratio of its
    execution latency to its output size (threshold ≈ 1/swap bandwidth,
    tuned offline — paper §3.3)."""

    name = "adaptive"

    def __init__(self, rm):
        super().__init__(rm)
        self._rollback = RollbackEviction(rm)
        self._limitdrop = LimitDropEviction(rm)

    def evict(self, st: NodeState) -> int:
        ratio = st.exec_latency / max(st.output_bytes, 1)
        if ratio > self.rm.cfg.adaptive_threshold:
            return self._limitdrop.evict(st)
        return self._rollback.evict(st)
