"""Built-in rules — importing this package registers them all.

Catalog (one module per rule):

- ``host_sync``       — ``host-sync-hazard``: D2H materialization
  (``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/``.to("cpu")``,
  ``torch.cuda.synchronize``, ``np.asarray``) only through the
  count-gated emit drain; ``analysis/sync_guard.py`` is its dynamic
  twin on the card
- ``ingest_put``      — ``ingest-put-bypass``: H2D puts
  (``.to(<device>)``, ``.cuda()``, ``torch.as_tensor(..., device=)``,
  ``.copy_(<host>)``) only through ``staged_put``
- ``broad_except``    — ``broad-except-swallow``: no fault vanishes
  without a log/counter
- ``lock_discipline`` — ``lock-discipline``: attributes shared between a
  thread-entry function and the main batch path stay under the lock
  (MRO-aware: mixin threads and inherited methods resolve)
- ``jit_purity``      — ``jit-purity``: no host clock / logging / fault
  hooks / stats writes / materialization inside the engines' step
  callables (the closures the step builders return, the engines' step
  methods), helpers in other modules included
- ``retrace``         — ``retrace-hazard``: no un-memoized step-builder
  or ``kernels/build.load`` call on per-batch functions, including
  helpers called across modules
- ``fallback_discipline`` — ``fallback-discipline``: every
  ``except SiddhiAppCreationError`` fallback gate reaches both a
  ``log.warning`` and a counted ``record_*_fallback`` stats write
- ``thread_lifecycle`` — ``thread-lifecycle``: every Thread/Timer is
  daemon or joined/cancelled on an owner-class shutdown path
- ``bounded_queues`` — ``bounded-queue-discipline``: every deque/Queue
  in ``core/``, ``transport/`` and ``robustness/`` carries an explicit
  bound (``maxlen=``/``maxsize=``) or an allowlist justification
- ``lockset_race`` — ``lockset-race``: flow-sensitive Eraser-style
  cross-thread write check (per-statement must-hold locksets over the
  CFG; subsumes the lexical lock-discipline pass)
- ``lock_order`` — ``lock-order-deadlock``: cycles in the global
  lock-acquisition-order graph, plus held non-reentrant re-acquires
- ``barrier_flush`` — ``barrier-flush-completeness``: every barrier
  method reaches a flush of every bounded queue its class owns
"""

# NOTE: lockset_race MUST import (= register = run) before
# lock_discipline — the lexical rule consults the flow rule's reported
# keys to emit shared conflicts once (lockset wins).
from . import (  # noqa: F401
    bounded_queues,
    broad_except,
    fallback_discipline,
    host_sync,
    ingest_put,
    jit_purity,
    lockset_race,
    lock_discipline,
    lock_order,
    barrier_flush,
    retrace,
    thread_lifecycle,
)
