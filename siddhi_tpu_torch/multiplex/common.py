"""Shared helpers for multiplex tenant adapters.

Port of the JAX package's ``multiplex/common.py``.

Fault semantics mirror the dedicated engines': each tenant keeps its
OWN ``FaultInjector`` (the group engine runs with ``faults=None``), so
a tenant's injected ingest/emit faults retry and exhaust exactly like
its dedicated runtime would — without ever stalling the other seats.
"""

from __future__ import annotations

import logging
import time

from siddhi_tpu_torch.core.exceptions import TransferFaultError

log = logging.getLogger(__name__)


def retry_guard(fi, site: str) -> None:
    """Per-tenant transient-fault gate with the staged_put retry ladder.

    Checks ``site`` on the tenant's injector, retrying transient
    transfer faults with the same bounded backoff as
    ``core/ingest_stage.staged_put`` (attempts / scale from the
    injector's knobs).  Exhaustion re-raises, which the caller
    propagates out of that tenant's receive/drain path only.
    """
    if fi is None:
        return
    attempts = fi.transfer_retry_attempts
    attempt = 0
    backoff = None
    while True:
        try:
            fi.check(site)
            if attempt:
                fi.stats.drains_recovered += 1
            return
        except TransferFaultError:
            if attempt >= attempts:
                raise
            attempt += 1
            fi.stats.transfer_retries += 1
            if backoff is None:
                from siddhi_tpu_torch.transport.retry import BackoffRetryCounter

                backoff = BackoffRetryCounter(scale=fi.transfer_retry_scale)
            wait_s = backoff.get_time_interval_ms() / 1000.0
            backoff.increment()
            log.warning(
                "multiplex: transient fault at %s (attempt %d/%d), "
                "retrying in %.3fs", site, attempt, attempts, wait_s)
            if wait_s > 0:
                time.sleep(wait_s)
