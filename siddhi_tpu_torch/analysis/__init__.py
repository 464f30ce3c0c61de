"""siddhi_tpu_torch.analysis — unified static-analysis pass for the engine's
un-typeable invariants.

The engine's performance and crash-recovery guarantees rest on contracts
the type system cannot see: device→host transfers only through the
count-gated drain (``core/emit_queue.py``), H2D puts only through
``staged_put`` (``core/ingest_stage.py``), no fault swallowed without a
log line or counter, no host clock / logging / materialization inside a
jitted step, no compile-cache churn on the per-batch path, no
cross-thread attribute write outside the engine lock, every planner
fallback both logged and counted, and every thread daemon-or-joined.

This package enforces them as one reusable pass — the compile-time
analog of the paper's query-validation phase:

- ``index``      — single-parse-per-module ``ModuleIndex`` with
                   qualified-name scope resolution shared by every rule,
                   memoized on ``(path, mtime, size)``
- ``project``    — whole-program ``ProjectIndex``: import maps, C3 MRO
                   over project-local classes, conservative call graph
- ``framework``  — ``Rule`` base class + registry, ``Finding``,
                   allowlists with required justifications, stale-entry
                   expiry
- ``rules/``     — one module per rule (twelve registered: the
                   reference's catalog, four of them re-pointed at
                   torch's constructs)
- ``reporting``  — text / JSON / SARIF 2.1.0 reporters, ``--baseline``
                   support
- ``__main__``   — ``python -m siddhi_tpu_torch.analysis`` CLI (also exposed
                   as the ``siddhi-tpu-torch-analysis`` console script)
- ``sync_guard`` — the host-sync rule's dynamic twin on the card
                   (``torch.cuda.set_sync_debug_mode``), the port's
                   counterpart of ``jax.transfer_guard("disallow")``

Run ``python -m siddhi_tpu_torch.analysis --list-rules`` for the catalog.
"""

from .framework import (  # noqa: F401
    Allowlist,
    Finding,
    Rule,
    all_rules,
    get_rule,
    register,
    run_rules,
)
from .index import ModuleIndex, index_package  # noqa: F401

# importing the subpackage registers every built-in rule
from . import rules  # noqa: F401,E402

__all__ = [
    "Allowlist",
    "Finding",
    "ModuleIndex",
    "Rule",
    "all_rules",
    "get_rule",
    "index_package",
    "register",
    "run_rules",
]
