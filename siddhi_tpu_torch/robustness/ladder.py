"""Unified degradation ladder: trade speed for stability, in order.

Under sustained pressure (deep async junction queues, admission
shedding, watchdog near-misses) the app demotes its OWN lowerings one
rung at a time.  The port's ladder has one rung:

1. ``fuse``      → junction     (fused chains off)

The reference's ladder first takes ``kernels`` (its Pallas kernels off,
the XLA step on) and ``devtables`` (device columns off, host tables
on).  The port has no such rungs: its dense engines always run their
kernel on the card and its device tables stay on the device, so no
demotion trades a hand-written kernel for a plain twin or moves work
to the host.  An app with ``@app:kernels`` or ``@app:devtables`` and
no fused chain has a zero-rung ladder here (``ROADMAP.md`` §3).

Each demotion (and each re-promotion once pressure clears) is a
counted, forced ``runtime.replan()`` with the CURRENT pins — the same
pause/snapshot/rebuild/replay protocol the planner uses, so outputs
stay bit-identical across every rung.  The ladder only ever steps
through features the app actually enabled; apps with none of them have
a zero-rung ladder and the ladder is inert.

Hysteresis follows the ``PlanMonitor`` discipline: demote when the
pressure signal holds at/above the high-water mark for ``dwell``
consecutive watchdog ticks, re-promote only after it holds at/below
the low-water mark for ``2 * dwell`` ticks — pressure must clear by a
margin and stay clear, so the ladder never flip-flops at the
boundary.
"""

from __future__ import annotations

import logging

log = logging.getLogger("siddhi_tpu_torch")

#: demotion order — attribute names on the app context (fused→junction)
DEMOTE_ORDER = ("fuse",)


def apply_degradation(app_context, level: int) -> list:
    """Disable the first ``level`` ENABLED features of ``DEMOTE_ORDER``
    on ``app_context`` (the replacement context a ``replan`` is about
    to build through).  Returns the feature names it turned off.

    Deriving the rung set from the context's own annotation flags keeps
    this deterministic across rebuilds: the same app string always
    yields the same enabled-feature list, so level N always means the
    same demotions.
    """
    demoted = []
    remaining = int(level)
    for feature in DEMOTE_ORDER:
        if remaining <= 0:
            break
        if getattr(app_context, feature, False):
            setattr(app_context, feature, False)
            demoted.append(feature)
            remaining -= 1
    return demoted


class DegradationLadder:
    """Pressure-driven demote/promote controller for one app.

    ``observe(pressure)`` is called once per watchdog tick with a
    normalized pressure signal in ``[0, 1]``; the ladder decides
    whether to move one rung and drives ``runtime.replan`` itself.
    """

    HIGH_WATER = 0.85
    LOW_WATER = 0.25

    def __init__(self, runtime, stats, high=HIGH_WATER, low=LOW_WATER,
                 dwell: int = 3):
        self.runtime = runtime
        self.stats = stats
        self.high = float(high)
        self.low = float(low)
        self.dwell = int(dwell)
        ctx = runtime.app_context
        #: rungs available to THIS app — only annotation-enabled
        #: features.  On a context rebuilt at degrade level > 0 the
        #: demoted flags read False, so the rungs the level consumed
        #: come from the context's degraded_features record instead —
        #: without it a demoted ladder would lose those rungs and never
        #: re-promote.
        demoted = getattr(ctx, "degraded_features", ())
        self.features = [f for f in DEMOTE_ORDER
                         if getattr(ctx, f, False) or f in demoted]
        self._hot_ticks = 0
        self._cool_ticks = 0

    @property
    def level(self) -> int:
        return getattr(self.runtime.app_context, "degrade_level", 0)

    def observe(self, pressure: float) -> bool:
        """One tick: returns True when a rung was taken (either way)."""
        if not self.features:
            return False
        if pressure >= self.high:
            self._hot_ticks += 1
            self._cool_ticks = 0
        elif pressure <= self.low:
            self._cool_ticks += 1
            self._hot_ticks = 0
        else:
            self._hot_ticks = 0
            self._cool_ticks = 0
        if self._hot_ticks >= self.dwell and \
                self.level < len(self.features):
            return self._step(+1, pressure)
        if self._cool_ticks >= 2 * self.dwell and self.level > 0:
            return self._step(-1, pressure)
        return False

    def _step(self, direction: int, pressure: float) -> bool:
        ctx = self.runtime.app_context
        new_level = self.level + direction
        verb = "demote" if direction > 0 else "promote"
        rung = self.features[max(new_level, self.level) - 1]
        try:
            ctx.degrade_level = new_level
            self.runtime.replan(
                dict(ctx.plan_pins), forced=True,
                reason=(f"degradation ladder {verb}: level {new_level} "
                        f"({rung}), pressure {pressure:.2f}"))
        except Exception as e:  # noqa: BLE001 — counted + logged, ladder stays live
            ctx.degrade_level = new_level - direction
            log.warning(
                "app '%s': ladder %s to level %d failed: %s",
                ctx.name, verb, new_level, e)
            sm = ctx.statistics_manager
            if sm is not None:
                sm.record_planner_fallback(
                    ctx.name, f"ladder {verb} failed: {e}")
            return False
        if direction > 0:
            self.stats.ladder_demotions += 1
        else:
            self.stats.ladder_promotions += 1
        self._hot_ticks = 0
        self._cool_ticks = 0
        log.warning(
            "app '%s': degradation ladder %sd to level %d (%s), "
            "pressure %.2f", ctx.name, verb, new_level, rung, pressure)
        return True

    def describe(self) -> dict:
        return {
            "level": self.level,
            "rungs": list(self.features),
            "demoted": self.features[:self.level],
            "high_water": self.high,
            "low_water": self.low,
            "dwell_ticks": self.dwell,
        }
