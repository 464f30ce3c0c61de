"""Eligibility gate and wiring for the skew-aware hot-key router.

Port of the JAX package's ``planner/hotkeys.py``.  ``@app:hotkeys(...)``
asks the planner to wrap eligible partitioned dense pattern queries in a
``HotKeyRouterRuntime`` (``core/hotkey_router.py``).

The gate is narrower than the dense gate: the scan's exactness contract
(events of one node interchangeable, state = per-lane youngest start +
count) holds only for every-headed linear filter chains selecting
final-node attributes.  Every rejection raises
``SiddhiAppCreationError`` with a distinct reason; ``try_wrap_hotkey``
records that reason on the query and leaves it on the dense path.  That
is routing, not a device fallback: both halves run on the card.
"""

from __future__ import annotations

import logging
from typing import Optional

from siddhi_tpu_torch.core.exceptions import (
    KernelUnavailableError,
    SiddhiAppCreationError,
)
from siddhi_tpu_torch.core.hotkey_router import HotKeyRouterRuntime
from siddhi_tpu_torch.ops.hotkey_scan import HotKeyScanEngine
from siddhi_tpu_torch.planner.kernels import check_scan_kernel_available

log = logging.getLogger("siddhi_tpu_torch")


def check_hotkey_eligible(st, dense_engine) -> None:
    """Gates beyond what the scan engine's own constructor enforces
    (linear every-headed chain, single stream, boolean device-evaluable
    filters, 2..32 nodes — see ``ops/nfa_scan._chain_nodes``).  Raises
    with a distinct reason."""
    if len(dense_engine.stream_keys) != 1:
        raise SiddhiAppCreationError(
            "hotkey routing: multi-stream chains have per-stream steps "
            "the scan cannot interleave — dense path kept")
    if dense_engine.has_deadlines:
        raise SiddhiAppCreationError(
            "hotkey routing: absent/deadline nodes need per-chain "
            "timers; the scan holds only youngest-start per lane — "
            "dense path kept")
    if dense_engine.alloc.slots:
        raise SiddhiAppCreationError(
            "hotkey routing: captured attributes from non-final nodes "
            "are not representable in youngest-start/count state — "
            "dense path kept")
    for _name, src in dense_engine.out_spec:
        if not (isinstance(src, tuple) and src[0] == "cand"):
            raise SiddhiAppCreationError(
                "hotkey routing: select references a non-final-node "
                "attribute — dense path kept")


def build_hotkey_router(ctx, definitions, st, dense_runtime,
                        query_name: str) -> HotKeyRouterRuntime:
    """Construct the scan engine + router for an eligible query; raises
    SiddhiAppCreationError (with the reason) when ineligible."""
    engine = dense_runtime.engine
    check_hotkey_eligible(st, engine)
    sid = engine.stream_keys[0]
    stream_def = definitions.get(sid)
    if stream_def is None:
        raise SiddhiAppCreationError(
            f"hotkey routing: stream '{sid}' has no definition")
    # the scan ctor re-runs the chain walk + filter check and raises
    # its own distinct reasons (sequence, within, non-filter handlers,
    # non-device-evaluable filters, ...)
    scan = HotKeyScanEngine(st, stream_def, n_slots=ctx.hotkey_k,
                            device=engine.device)
    return HotKeyRouterRuntime(
        dense_runtime, scan, promote=ctx.hotkey_promote,
        demote=ctx.hotkey_demote, query_name=query_name)


def try_wrap_hotkey(ctx, definitions, st, dense_runtime, query_name: str
                    ) -> Optional[HotKeyRouterRuntime]:
    """The planner hook: the router on success; None when the query is
    outside the scan class, with the reason in
    ``ctx.hotkey_fallbacks[query_name]``.  A card whose scan kernel does
    not build or launch raises: that is no routing decision."""
    try:
        router = build_hotkey_router(ctx, definitions, st, dense_runtime,
                                     query_name)
    except KernelUnavailableError:
        raise
    except SiddhiAppCreationError as e:
        log.warning(
            "query '%s': @app:hotkeys requested but query is outside "
            "the scan class, staying dense: %s", query_name, e)
        ctx.hotkey_fallbacks[query_name] = str(e)
        return None
    check_scan_kernel_available(router._scan)
    return router
