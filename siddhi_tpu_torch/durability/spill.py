"""Journal spill sink: overflowed input-journal segments go to the store.

Port of the JAX package's ``durability/spill.py``.

Before this existed, a full :class:`~siddhi_tpu_torch.util.faults.InputJournal`
dropped its oldest entry and poisoned replay — long checkpoint intervals
forfeited crash recovery.  The sink gives the journal a second tier: on
overflow it pickles the coldest segment of entries and hands it to the
persistence store's journal-segment API
(``save_journal_segment`` / ``load_journal_segments`` /
``prune_journal_segments``); replay stitches spilled + in-memory
segments back into one contiguous sequence.

The sink resolves the store lazily from the manager context (a store
configured after app creation still works) and degrades cleanly: no
store, or a store without the segment API, means ``spill`` returns
False and the journal falls back to the old drop-and-gap behavior.

Store writes go through the ``journal.spill`` fault choke point with the
same bounded retry ladder as checkpoint writes; ``journal.spill.mid``
fires AFTER the segment is durable but BEFORE the journal trims memory —
the mid-spill crash point of the matrix (recovery then sees the segment
and the untrimmed entries overlap; stitching dedups by sequence number).
"""

from __future__ import annotations

import logging
import pickle
import time
from typing import Any, List, Optional, Tuple

from siddhi_tpu_torch.core.exceptions import (
    ConnectionUnavailableError,
    TransferFaultError,
)
from siddhi_tpu_torch.util.faults import (
    DEFAULT_TRANSFER_RETRY_ATTEMPTS,
    DEFAULT_TRANSFER_RETRY_SCALE,
)

log = logging.getLogger("siddhi_tpu_torch.durability")

_RETRYABLE = (TransferFaultError, ConnectionUnavailableError, OSError)


class JournalSpillSink:
    """Bridges one app's InputJournal to the persistence store."""

    def __init__(self, siddhi_context, app_name: str, app_context=None):
        self.siddhi_context = siddhi_context
        self.app_name = app_name
        # carries the CURRENT runtime's fault injector; the planner
        # re-attaches a fresh sink on every (re)build so a post-crash
        # replacement runtime's chaos config applies
        self.app_context = app_context

    def _store(self):
        store = getattr(self.siddhi_context, "persistence_store", None)
        if store is None or not hasattr(store, "save_journal_segment"):
            return None
        return store

    def supported(self) -> bool:
        return self._store() is not None

    def _injector(self):
        return getattr(self.app_context, "fault_injector", None) \
            if self.app_context is not None else None

    def spill(self, seq0: int, seq1: int,
              entries: List[Tuple[int, str, Any]], stats=None) -> bool:
        """Persist ``entries`` (seqs ``seq0..seq1``) as one segment.
        True on success; False when unsupported or the store keeps
        faulting (the journal then falls back to dropping).  A ``crash``
        fault propagates — mid-spill kills are the point."""
        store = self._store()
        if store is None:
            return False
        payload = pickle.dumps(entries, protocol=pickle.HIGHEST_PROTOCOL)
        fi = self._injector()
        attempts = (fi.transfer_retry_attempts if fi is not None
                    else DEFAULT_TRANSFER_RETRY_ATTEMPTS)
        scale = (fi.transfer_retry_scale if fi is not None
                 else DEFAULT_TRANSFER_RETRY_SCALE)
        last: Optional[Exception] = None
        for attempt in range(max(1, attempts)):
            try:
                if fi is not None:
                    fi.check("journal.spill")
                store.save_journal_segment(self.app_name, seq0, seq1,
                                           payload)
                if fi is not None:
                    # segment durable, journal memory not yet trimmed:
                    # the matrix's mid-spill crash point
                    fi.check("journal.spill.mid")
                return True
            except _RETRYABLE as e:
                last = e
                if stats is not None:
                    stats.spill_retries += 1
                if fi is not None:
                    fi.notify(e)
                if attempt + 1 < max(1, attempts):
                    time.sleep(scale * (2 ** attempt))
        log.warning("durability: app '%s' journal spill of seqs %d..%d "
                    "failed after retries (%s); falling back to drop",
                    self.app_name, seq0, seq1, last)
        return False

    def load_segments(self) -> Optional[List[Tuple[int, int, List]]]:
        """[(seq0, seq1, entries)] oldest first; None when the segments
        cannot be read (replay is then refused rather than gapped)."""
        store = self._store()
        if store is None:
            return None
        try:
            raw = store.load_journal_segments(self.app_name)
        except Exception as e:
            log.warning("durability: app '%s' journal segments are "
                        "unreadable (%s)", self.app_name, e)
            return None
        out = []
        for seq0, seq1, payload in raw:
            try:
                out.append((seq0, seq1, pickle.loads(payload)))
            except Exception as e:
                log.warning("durability: app '%s' journal segment "
                            "%d..%d is corrupt (%s)", self.app_name,
                            seq0, seq1, e)
                return None
        return out

    def prune(self, upto_seq: int):
        store = self._store()
        if store is not None:
            store.prune_journal_segments(self.app_name, upto_seq)

    def clear(self):
        store = self._store()
        if store is not None:
            store.clear_journal(self.app_name)
