"""Cost-based unified lowering: one static cost model over every path.

The four fast planner paths (shard / multiplex / fuse / hotkeys) grew up
as opt-in annotations with hand-written, mutually exclusive gates.  This
module turns them into *candidates*: for each query it enumerates the
eligible lowerings — including compositions the annotation gates forbid
— scores each with static shape/arity costs (batch width, window size,
partition cardinality, automaton node count, mesh size), and picks the
cheapest.  Explicit annotations act as pins that override the model;
`@app:plan(auto='true')` turns the model on for un-annotated apps.

The scores are per-batch, in arbitrary dispatch-microsecond-like units.
They only ever pick WHICH bit-identical lowering runs — a mis-scored
constant costs throughput, never correctness: every candidate the model
selects still has to pass the real eligibility gate of its path, and the
per-path fallback discipline (log.warning + counted reason) covers any
gap between the model's static view and the gate's exact one.

Composition precedence when several pinned annotations apply to one
query (the implemented build order, now documented and counted):

    fuse > shard > multiplex > hotkeys

i.e. the fusion pre-pass claims chain members before the per-query loop
runs; mesh-sharded state does not multiplex; the hotkey router only
wraps single-device dense state.  A pinned path losing to another pin is
counted on the statistics feed (plannerConflicts / plannerConflictReason).

Port of the JAX package's ``planner/costmodel.py``: records in legacy
mode (the annotations steer the planner), pinned mode (a live re-plan's
pins) or, under ``@app:plan(auto='true')``, auto mode (the cheapest
feasible candidate steers it, and ``planner/monitor.py`` re-scores it
with what the statistics feed observed).  The sharded candidates are
enumerated where ``@app:execution(devices=)`` declares a mesh.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional

from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.query_api import (
    JoinInputStream,
    Query,
    SingleInputStream,
    StateInputStream,
    WindowHandler,
)

log = logging.getLogger("siddhi_tpu_torch")

# -- static cost constants (per batch, arbitrary units) ----------------------
# Calibrated against the relative magnitudes the bench suite observes:
# dispatch/junction overheads dominate small batches, per-event terms
# dominate large ones.  BATCH_HINT is the planning-time batch width; the
# PlanMonitor re-scores with the OBSERVED batch width at runtime.

DISPATCH = 60.0          # per-batch host dispatch + callback overhead
JUNCTION_HOP = 90.0      # EventBatch build + junction publish between queries
H2D = 25.0               # host->device staging setup per batch
HOST_PER_EVENT = 0.5     # host engine per-event cost
DEVICE_PER_EVENT = 0.004  # device engine per-event cost
DENSE_NODE_PER_EVENT = 0.002  # dense NFA per-event per-automaton-node cost
SHARD_COLLECTIVE = 18.0  # per-batch collective cost, scaled by log2(mesh)
HOTKEY_ROUTER = 8.0      # sketch update + batch split per batch
HOTKEY_SKEW = 0.6        # prior: traffic share the scan slots absorb
WINDOW_LEN_HINT = 256    # window width assumed when not statically known
BATCH_HINT = 4096        # planning-time batch width


class QueryTraits:
    """Static shape facts the scorer reads — extracted from the AST only
    (no engines built), so classification can never fail an app build."""

    __slots__ = ("kind", "tumbling_batch", "aggregating", "window_len",
                 "n_nodes", "n_stages", "output_rate")

    def __init__(self, kind: str):
        self.kind = kind                # 'single' | 'state' | 'join' | 'other'
        self.tumbling_batch = False     # lengthBatch/timeBatch window
        self.aggregating = False        # group by / having / aggregators
        self.window_len = WINDOW_LEN_HINT
        self.n_nodes = 2                # automaton node count (state kind)
        self.n_stages = 1               # fused-chain stage count
        self.output_rate = False


class PlanCandidate:
    __slots__ = ("path", "cost", "feasible", "reason")

    def __init__(self, path: str, cost: float, feasible: bool = True,
                 reason: str = ""):
        self.path = path
        self.cost = cost
        self.feasible = feasible
        self.reason = reason

    def to_dict(self) -> Dict[str, object]:
        return {"path": self.path, "cost": round(self.cost, 3),
                "feasible": self.feasible, "reason": self.reason}


class PlanRecord:
    """The chosen plan for one query: candidates with costs, the pick,
    the pin that forced it (if any), the realized lowering, and the
    re-plan history — the `/siddhi-plan/<app>` payload."""

    __slots__ = ("name", "mode", "candidates", "chosen", "predicted_cost",
                 "pinned", "actual", "replans", "traits")

    def __init__(self, name: str, mode: str = "legacy"):
        self.name = name
        self.mode = mode            # 'auto' | 'pinned' | 'legacy'
        self.candidates: List[PlanCandidate] = []
        self.chosen = "host"
        self.predicted_cost = 0.0
        self.pinned: Optional[str] = None
        self.actual: Optional[str] = None
        self.replans: List[Dict[str, object]] = []
        self.traits: Optional[QueryTraits] = None

    def candidate(self, path: str) -> Optional[PlanCandidate]:
        for c in self.candidates:
            if c.path == path:
                return c
        return None

    def components(self) -> List[str]:
        return self.chosen.split("+")

    def note_replan(self, old: str, new: str, forced: bool, reason: str):
        self.replans.append({"from": old, "to": new, "forced": forced,
                             "reason": reason})

    def to_dict(self) -> Dict[str, object]:
        return {
            "mode": self.mode,
            "chosen": self.chosen,
            "predictedCost": round(self.predicted_cost, 3),
            "pinned": self.pinned,
            "actual": self.actual,
            "candidates": [c.to_dict() for c in self.candidates],
            "rejected": [c.to_dict() for c in self.candidates
                         if not c.feasible],
            "replans": list(self.replans),
        }


# -- trait extraction --------------------------------------------------------


def _window_traits(handlers, traits: QueryTraits):
    for h in handlers:
        if not isinstance(h, WindowHandler):
            continue
        if h.name in ("lengthBatch", "timeBatch"):
            traits.tumbling_batch = True
        for a in h.args:
            v = getattr(a, "value", None)
            if isinstance(v, int) and v > 0:
                traits.window_len = v
                break


def classify_query(app_planner, query: Query) -> QueryTraits:
    """AST-only classification; defensive — never raises."""
    try:
        from siddhi_tpu_torch.planner.query_planner import has_aggregators

        s = query.input_stream
        if isinstance(s, SingleInputStream):
            traits = QueryTraits("single")
            _window_traits(s.handlers, traits)
        elif isinstance(s, StateInputStream):
            traits = QueryTraits("state")
            traits.n_nodes = max(2, _count_state_nodes(s))
        elif isinstance(s, JoinInputStream):
            traits = QueryTraits("join")
        else:
            traits = QueryTraits("other")
        sel = query.selector
        traits.aggregating = bool(sel.group_by) or sel.having is not None \
            or has_aggregators(sel)
        traits.output_rate = query.output_rate is not None
        return traits
    except Exception:  # noqa: BLE001 — classification must never fail a build
        log.debug("cost model: classification failed; host-only traits",
                  exc_info=True)
        return QueryTraits("other")


def _count_state_nodes(st) -> int:
    """Approximate automaton node count: stream leaves of the state tree."""
    n = 0
    stack = [getattr(st, "state_element", None) or st]
    seen = set()
    while stack:
        el = stack.pop()
        if el is None or id(el) in seen:
            continue
        seen.add(id(el))
        if isinstance(getattr(el, "stream", None), SingleInputStream):
            n += 1
        for attr in ("element", "left", "right", "first", "second",
                     "elements", "state_element", "stream_elements"):
            child = getattr(el, attr, None)
            if isinstance(child, (list, tuple)):
                stack.extend(child)
            elif child is not None:
                stack.append(child)
    return n


# -- scoring -----------------------------------------------------------------


def score_path(path: str, traits: QueryTraits, ctx, batch: float) -> float:
    """Per-batch cost of ``path`` under the static model.  ``batch`` is
    the assumed batch width (BATCH_HINT at plan time; the PlanMonitor
    passes the observed width when re-scoring)."""
    nd = ctx.tpu_devices or 1
    collective = SHARD_COLLECTIVE * max(1.0, math.log2(nd)) if nd > 1 else 0.0
    slots = max(2, ctx.multiplex_slots)
    dense_ev = DENSE_NODE_PER_EVENT * traits.n_nodes * batch
    cost = 0.0
    for comp in path.split("+"):
        if comp == "host":
            cost += DISPATCH + HOST_PER_EVENT * batch \
                + 0.001 * traits.window_len
        elif comp == "device":
            cost += DISPATCH + H2D + DEVICE_PER_EVENT * batch
        elif comp == "dense":
            cost += DISPATCH + H2D + dense_ev
        elif comp == "multiplex":
            # seat amortization: the shared engine's dispatch + transfer
            # setup is paid once per cycle across every seated tenant
            cost += (DISPATCH + H2D) / slots + DEVICE_PER_EVENT * batch
        elif comp == "fuse":
            # a fused chain replaces per-stage dispatch + junction hops
            # with one dispatch; stages still cost their device step
            cost += DISPATCH + H2D \
                + traits.n_stages * DEVICE_PER_EVENT * batch \
                - (traits.n_stages - 1) * JUNCTION_HOP
        elif comp == "shard":
            # shard divides the per-event work already accumulated and
            # adds the collective
            cost = cost / nd + DISPATCH * (1 - 1 / nd) + collective
        elif comp == "hotkey":
            # the scan slots absorb the skewed share at device-query
            # rates; the dense residual shrinks by the same share
            cost -= dense_ev * HOTKEY_SKEW
            cost += HOTKEY_ROUTER + DEVICE_PER_EVENT * batch * HOTKEY_SKEW
        else:
            cost += DISPATCH
    return max(cost, 0.1)


def _check_composable(path: str, traits: QueryTraits, ctx):
    """Eligibility pre-gate for a candidate path; raises
    SiddhiAppCreationError with the rejection reason.  Mirrors (in the
    static vocabulary) the real per-path gates, plus the compositions
    that are enumerated but not yet lowerable."""
    comps = path.split("+")
    if "multiplex" in comps and "hotkey" in comps:
        raise SiddhiAppCreationError(
            "multiplex+hotkey is not composable yet: the router's state "
            "handoff assumes a dedicated engine's row ownership, shared "
            "seats would interleave promoted rows across tenants")
    if "hotkey" in comps and "shard" in comps:
        raise SiddhiAppCreationError(
            "hotkey+shard is not composable yet: the promote/demote "
            "state handoff assumes single-device partition rows")
    if "multiplex" in comps and "shard" in comps:
        raise SiddhiAppCreationError(
            "mesh-sharded state does not multiplex: seats are packed on "
            "one device engine")
    if "shard" in comps and not ctx.tpu_devices:
        raise SiddhiAppCreationError(
            "no device mesh declared (@app:execution devices='N')")
    if "multiplex" in comps:
        if traits.kind == "single" and not traits.tumbling_batch:
            raise SiddhiAppCreationError(
                "multiplex seats tumbling lengthBatch/timeBatch queries")
        if traits.kind == "state" and traits.aggregating:
            raise SiddhiAppCreationError(
                "aggregating patterns do not multiplex")
        if traits.output_rate:
            raise SiddhiAppCreationError(
                "rate-limited queries do not multiplex")
    if "hotkey" in comps and traits.aggregating:
        raise SiddhiAppCreationError(
            "hotkey scan slots serve passthrough selects only")
    if "fuse" in comps and traits.n_stages < 2:
        raise SiddhiAppCreationError("not part of a fusable chain")


def _paths_for(traits: QueryTraits, ctx) -> List[str]:
    if traits.kind == "single":
        paths = ["host", "device", "multiplex"]
        if ctx.tpu_devices:
            paths += ["device+shard", "multiplex+shard"]
    elif traits.kind == "state":
        paths = ["host", "dense", "multiplex", "dense+hotkey"]
        if ctx.tpu_devices:
            paths += ["dense+shard", "dense+hotkey+shard",
                      "multiplex+hotkey"]
        else:
            paths += ["multiplex+hotkey"]
    else:
        paths = ["host"]
    return paths


def build_plan_record(app_planner, query: Query, name: str) -> PlanRecord:
    """Enumerate + score the candidate lowerings for one query.

    Pins win over the model: a replan override (ctx.plan_pins) pins the
    exact path; legacy annotations pin their path in non-auto mode.  In
    auto mode the cheapest feasible candidate is chosen.  Every
    infeasible candidate is recorded (and — for the not-yet-composable
    compositions — counted as a planner fallback) so `/siddhi-plan`
    shows WHY a path was not taken.
    """
    ctx = app_planner.app_context
    sm = ctx.statistics_manager
    traits = classify_query(app_planner, query)
    pin_override = (getattr(ctx, "plan_pins", None) or {}).get(name)
    mode = ("pinned" if pin_override is not None
            else "auto" if getattr(ctx, "plan_auto", False) else "legacy")
    rec = PlanRecord(name, mode)
    rec.traits = traits

    if ctx.execution_mode != "tpu":
        rec.candidates.append(
            PlanCandidate("host", score_path("host", traits, ctx,
                                             BATCH_HINT)))
        rec.chosen = "host"
        rec.predicted_cost = rec.candidates[0].cost
        return rec

    for path in _paths_for(traits, ctx):
        cost = score_path(path, traits, ctx, BATCH_HINT)
        try:
            _check_composable(path, traits, ctx)
        except SiddhiAppCreationError as e:
            # a cost-gate rejection is counted like any fallback; the
            # port logs it at DEBUG, so its fallback WARNINGs stay the
            # device paths' (ROADMAP.md §3 pin 15)
            log.debug(
                "query '%s': cost model rejected candidate '%s': %s",
                name, path, e)
            if sm is not None:
                sm.record_planner_fallback(name, f"{path}: {e}")
            rec.candidates.append(PlanCandidate(path, cost, False, str(e)))
            continue
        rec.candidates.append(PlanCandidate(path, cost))

    feasible = [c for c in rec.candidates if c.feasible]
    best = min(feasible, key=lambda c: c.cost) if feasible \
        else rec.candidates[0]
    if pin_override is not None:
        rec.pinned = pin_override
        rec.chosen = pin_override
        c = rec.candidate(pin_override)
        rec.predicted_cost = c.cost if c is not None else \
            score_path(pin_override, traits, ctx, BATCH_HINT)
    elif mode == "auto":
        rec.chosen = best.path
        rec.predicted_cost = best.cost
    else:
        # legacy: annotations steer the planner directly; record what
        # they pin so the REST dump explains the realized lowering
        pins = [p for p, on in (("fuse", ctx.fuse),
                                ("shard", bool(ctx.tpu_devices)),
                                ("multiplex", ctx.multiplex),
                                ("hotkeys", ctx.hotkeys)) if on]
        rec.pinned = "+".join(pins) if pins else None
        rec.chosen = best.path
        rec.predicted_cost = best.cost
    return rec


def fused_plan_record(name: str, ctx, n_stages: int,
                      sharded: bool = False) -> PlanRecord:
    """PlanRecord for a query the fusion pre-pass claimed (the per-query
    enumeration never sees chain members)."""
    traits = QueryTraits("single")
    traits.n_stages = max(2, n_stages)
    mode = "auto" if getattr(ctx, "plan_auto", False) else "legacy"
    rec = PlanRecord(name, mode)
    rec.traits = traits
    path = "fuse+shard" if sharded else "fuse"
    for p in ("host", "device", "fuse"):
        rec.candidates.append(
            PlanCandidate(p, score_path(p, traits, ctx, BATCH_HINT)))
    if sharded:
        rec.candidates.append(
            PlanCandidate("fuse+shard",
                          score_path("fuse+shard", traits, ctx, BATCH_HINT)))
    rec.chosen = path
    c = rec.candidate(path)
    rec.predicted_cost = c.cost if c is not None else 0.0
    rec.pinned = "fuse" if ctx.fuse and mode == "legacy" else None
    return rec
