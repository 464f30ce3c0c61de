"""The host-sync rule's dynamic twin: every synchronising call on the card.

The JAX package holds its device-to-host contract at run time with
``jax.transfer_guard("disallow")`` around the event loop: an implicit
transfer raises, while ``jax.device_get`` (the count-gated drain) stays
allowed.  ``SyncGuard`` is the port's counterpart.  Eager PyTorch hides
syncs that XLA never has — boolean-mask indexing, ``nonzero``, a
non-pinned copy — so the guard does not stop at the ``.item()`` forms
the static rule sees:

- ``__enter__`` sets ``torch.cuda.set_sync_debug_mode("warn")`` (when a
  card is present), a warnings filter of ``"always"`` for the sync
  warning (TORCH_WARN text would otherwise show once a call site) and a
  ``showwarning`` hook; ``__exit__`` restores the filters, the hook and
  the previous mode, in ``finally``.  ``"error"`` mode would abort the
  very fetches the contract allows, as ``transfer_guard`` allows
  ``device_get``, so the guard records and the caller judges.
- The hook attributes each sync to the innermost frame of the
  ``siddhi_tpu_torch`` package on the stack of the thread that made it
  (the mode is process-wide; drain, ``@async``, scheduler and monitor
  threads sync too, each on its own stack), as an allowlist-style key
  ``siddhi_tpu_torch/<path>:<Class.method>``.  A sync with no such frame
  (the caller's own code) is keyed ``<outside>``.
- A sync is **sanctioned** if its scope is the count-gated drain
  (``core/emit_queue.py`` ``fetch_coalesced``), the staging put
  (``core/ingest_stage.py`` ``staged_put`` / ``_put``), a scope the
  host-sync allowlist names, or an entry of ``ON_CARD_SYNCS`` in
  ``allowlists.py``, whose entries carry their own justifications;
  ``unused_on_card_syncs()`` lists the entries a run never hit, so the
  list can only shrink.
"""

from __future__ import annotations

import collections
import os
import re
import sys
import threading
import warnings
from pathlib import Path
from typing import Dict, Optional

from .allowlists import ALLOWLISTS, ON_CARD_SYNCS

#: the package whose frames a sync is attributed to
PACKAGE_ROOT = Path(__file__).resolve().parent.parent
#: TORCH_WARN's text for a synchronising CUDA call (sync debug mode)
SYNC_MESSAGE = "called a synchronizing CUDA operation"
_SYNC_RE = re.compile(r".*" + re.escape(SYNC_MESSAGE))

DRAIN = ("siddhi_tpu_torch/core/emit_queue.py:fetch_coalesced",)
STAGING = ("siddhi_tpu_torch/core/ingest_stage.py:staged_put",
           "siddhi_tpu_torch/core/ingest_stage.py:_put")
OUTSIDE = "<outside>"
# code objects of the guard itself are never the attributed frame
_SELF = Path(__file__).resolve()


def _scope(code) -> str:
    """A code object's allowlist scope: its qualified name with the
    ``<locals>`` links and comprehension/lambda frames dropped, as
    ``ModuleIndex.qualname`` names the enclosing def."""
    parts = [p for p in code.co_qualname.split(".")
             if not p.startswith("<")]
    return ".".join(parts) or "<module>"


def _innermost(frame, root: Path):
    """The innermost frame under ``root`` from ``frame`` outwards."""
    prefix = str(root) + os.sep
    skip = str(_SELF)
    while frame is not None:
        path = frame.f_code.co_filename
        if path.startswith(prefix) and path != skip:
            return frame
        frame = frame.f_back
    return None


def attribute(frame, root: Path = PACKAGE_ROOT) -> str:
    """The key of the innermost frame under ``root`` from ``frame``
    outwards, or ``OUTSIDE``."""
    hit = _innermost(frame, root)
    if hit is None:
        return OUTSIDE
    rel = Path(hit.f_code.co_filename).relative_to(root.parent).as_posix()
    return f"{rel}:{_scope(hit.f_code)}"


def bucket(key: str, on_card: Optional[Dict[str, str]] = None) -> Optional[str]:
    """Why a sync at ``key`` is sanctioned (``drain``, ``staging``,
    ``allowlist``, ``on_card``), or None."""
    if key in DRAIN:
        return "drain"
    if key in STAGING:
        return "staging"
    if key in ALLOWLISTS["host-sync-hazard"]:
        return "allowlist"
    if key in (ON_CARD_SYNCS if on_card is None else on_card):
        return "on_card"
    return None


class SyncGuard:
    """Context manager: records every synchronising CUDA call made while
    it is open, by attributed scope.

    ``counts``: key -> syncs; ``threads``: key -> names of the threads
    that made them; ``lines``: key -> line of the attributed frame ->
    syncs.  Syncs with no frame of the package count under ``OUTSIDE``.
    ``unsanctioned()`` and ``by_bucket()`` read ``counts`` by ``bucket``.
    """

    def __init__(self, root: Path = PACKAGE_ROOT,
                 on_card: Optional[Dict[str, str]] = None):
        self.root = Path(root)
        self.on_card = ON_CARD_SYNCS if on_card is None else on_card
        self.counts: collections.Counter = collections.Counter()
        self.threads: Dict[str, set] = collections.defaultdict(set)
        self.lines: Dict[str, collections.Counter] = \
            collections.defaultdict(collections.Counter)
        self._lock = threading.Lock()
        self._catcher = None
        self._prev_show = None
        self._prev_mode = None

    # -- recording ---------------------------------------------------------

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if _SYNC_RE.match(str(message)):
            self.record(sys._getframe(1))
            return
        self._prev_show(message, category, filename, lineno, file, line)

    def record(self, frame) -> str:
        """Counts one sync at the innermost package frame from ``frame``."""
        key = attribute(frame, self.root)
        hit = _innermost(frame, self.root)
        with self._lock:
            self.counts[key] += 1
            self.threads[key].add(threading.current_thread().name)
            if hit is not None:
                self.lines[key][hit.f_lineno] += 1
        return key

    # -- the context -------------------------------------------------------

    def __enter__(self):
        import torch

        self._catcher = warnings.catch_warnings()
        self._catcher.__enter__()
        warnings.filterwarnings("always", message=_SYNC_RE.pattern)
        self._prev_show = warnings.showwarning
        warnings.showwarning = self._show
        if torch.cuda.is_available():
            self._prev_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        try:
            if self._prev_mode is not None:
                torch.cuda.set_sync_debug_mode(self._prev_mode)
        finally:
            self._catcher.__exit__(*exc)
        return False

    # -- verdicts ----------------------------------------------------------

    def by_bucket(self) -> Dict[str, int]:
        out: Dict[str, int] = collections.Counter()
        for key, n in self.counts.items():
            out[bucket(key, self.on_card) or
                ("outside" if key == OUTSIDE else "unsanctioned")] += n
        return dict(out)

    def unsanctioned(self) -> Dict[str, int]:
        return {k: n for k, n in self.counts.items()
                if k != OUTSIDE and bucket(k, self.on_card) is None}

    def on_card_hits(self) -> set:
        return {k for k in self.counts if k in self.on_card}


def unused_on_card_syncs(guards, on_card: Optional[Dict[str, str]] = None
                         ) -> list:
    """Entries of ``ON_CARD_SYNCS`` no guard in ``guards`` recorded."""
    table = ON_CARD_SYNCS if on_card is None else on_card
    hit = set()
    for g in guards:
        hit |= g.on_card_hits()
    return sorted(set(table) - hit)
