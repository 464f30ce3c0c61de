"""Online plan refinement: live re-lowering from the statistics feed.

Port of the JAX package's ``planner/monitor.py``.  The cost model
(``planner/costmodel.py``) scores candidates at plan time with a static
batch-width hint.  ``PlanMonitor`` closes the loop: it reads the
statistics feed (each query's latency tracker, whose events over
batches are the observed batch width, and the hot-key router's routed
events) and re-scores the active plan's candidates with what the app
actually sees.  When an alternative's cost beats the active plan's
re-scored cost by the hysteresis margin (``@app:plan(hysteresis=
'0.3')``: 30% cheaper), it calls ``SiddhiAppRuntime.replan`` with the
winner as a pin; the re-plan protocol (pause, rebuild, replay the whole
journal) keeps the switch bit-exact, so a wrong decision costs
throughput, never correctness.

A switched query comes back pinned in the replacement build, so the
monitor never flip-flops it: one observed-cost correction a query, with
the hysteresis margin guarding the trigger.  ``decide()`` is the seam
without side effects that the tests drive; the interval sweep
(``@app:plan(interval='5 sec')``) calls ``maybe_replan()`` on a timer
thread that ``stop()`` joins.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError

log = logging.getLogger("siddhi_tpu_torch")

#: latency batches required before the observed width is trusted
MIN_BATCHES = 3


class PlanMonitor:
    def __init__(self, runtime, hysteresis: Optional[float] = None,
                 interval_ms: Optional[int] = None):
        self.runtime = runtime
        ctx = runtime.app_context
        self.hysteresis = (ctx.plan_hysteresis if hysteresis is None
                           else float(hysteresis))
        self.interval_ms = (ctx.plan_interval_ms if interval_ms is None
                            else int(interval_ms))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- observability reads (each a test seam) -----------------------------

    def observed_batch(self, name: str) -> Optional[float]:
        """Observed mean batch width of query ``name``; None until the
        latency tracker has seen enough batches to trust it."""
        sm = self.runtime.app_context.statistics_manager
        lt = sm.latency.get(name) if sm is not None else None
        if lt is None or lt.batches < MIN_BATCHES:
            return None
        return max(1.0, lt.events / lt.batches)

    def observed_skew(self, name: str) -> Optional[float]:
        """Observed hot-traffic share from the query's hot-key router
        (routed events over all events): it replaces the model's static
        skew prior while the router is live."""
        sm = self.runtime.app_context.statistics_manager
        if sm is None:
            return None
        router = sm.hotkey_routers.get(name)
        lt = sm.latency.get(name)
        if router is None or lt is None or lt.events <= 0:
            return None
        try:
            routed = float(router.hot_metrics().get("hotkeyRoutedEvents", 0))
        except Exception:  # noqa: BLE001 — telemetry must not kill the loop
            return None
        return min(1.0, routed / lt.events)

    # -- the decision -------------------------------------------------------

    def decide(self) -> Dict[str, str]:
        """Re-score every auto-planned query with observed widths; return
        ``{query: path}`` pins for those whose active plan is beaten by
        more than the hysteresis margin.  No side effects."""
        from siddhi_tpu_torch.planner import costmodel as cm

        ctx = self.runtime.app_context
        sm = ctx.statistics_manager
        if sm is None:
            return {}
        pins: Dict[str, str] = {}
        for name, rec in list(sm.plans.items()):
            # pins stay pinned (our own past switches too); annotation
            # apps never switch on their own
            if rec.mode != "auto" or rec.traits is None:
                continue
            batch = self.observed_batch(name)
            if batch is None:
                continue
            traits = rec.traits
            skew = self.observed_skew(name)

            def cost_of(path: str) -> float:
                c = cm.score_path(path, traits, ctx, batch)
                if skew is not None and "hotkey" in path.split("+"):
                    # the router's observed hot share for the static
                    # prior: undo the prior's dense-residual credit and
                    # scan debit, apply both at the observed share
                    dense_ev = (cm.DENSE_NODE_PER_EVENT
                                * traits.n_nodes * batch)
                    c += dense_ev * (cm.HOTKEY_SKEW - skew)
                    c += (cm.DEVICE_PER_EVENT * batch
                          * (skew - cm.HOTKEY_SKEW))
                return max(c, 0.1)

            active = rec.actual or rec.chosen
            active_cost = cost_of(active)
            best_path = None
            best_cost = 0.0
            for cand in rec.candidates:
                if cand.path == active:
                    continue
                try:
                    cm._check_composable(cand.path, traits, ctx)
                except SiddhiAppCreationError:
                    continue
                c = cost_of(cand.path)
                if best_path is None or c < best_cost:
                    best_path, best_cost = cand.path, c
            if best_path is None:
                continue
            if best_cost * (1.0 + self.hysteresis) < active_cost:
                log.info(
                    "plan monitor: query '%s' active '%s' costs %.1f "
                    "observed vs %.1f for '%s' — past the %.0f%% "
                    "hysteresis margin", name, active, active_cost,
                    best_cost, best_path, self.hysteresis * 100)
                pins[name] = best_path
        return pins

    def maybe_replan(self) -> bool:
        """One monitor tick: decide, and re-lower live when warranted.
        Refusals (no journal, journal overflow) are counted by
        ``replan``; here they skip the tick."""
        pins = self.decide()
        if not pins:
            return False
        try:
            self.runtime.replan(
                pins, forced=False,
                reason="observed cost exceeded a cheaper candidate by "
                       "the hysteresis margin")
            return True
        except Exception:
            log.warning("plan monitor: re-plan attempt failed",
                        exc_info=True)
            return False

    # -- interval sweep -----------------------------------------------------

    def start(self):
        if self._thread is not None or self.interval_ms <= 0:
            return
        self._stop.clear()
        t = threading.Thread(
            target=self._loop,
            name=f"plan-monitor-{self.runtime.name}", daemon=True)
        self._thread = t
        t.start()

    def _loop(self):
        interval_s = self.interval_ms / 1000.0
        while not self._stop.wait(interval_s):
            try:
                self.maybe_replan()
            except Exception:
                log.exception("plan monitor tick failed")
            except BaseException as e:
                # a simulated crash on the monitor thread: stop ticking
                log.error("plan monitor stopped: %s", e)
                break

    def stop(self):
        self._stop.set()
        t = self._thread
        # replan() tears the old runtime down, which stops the monitor:
        # never join the thread running this
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2)
        self._thread = None
