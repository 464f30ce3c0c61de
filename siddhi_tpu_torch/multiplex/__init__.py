"""Multi-tenant engine multiplexing: pack many apps' compatible queries
into shared device engines.

Port of the JAX package's ``multiplex/``.

Production traffic is thousands of small SiddhiApps, not one giant
query.  Dedicated lowering gives every query its own engine, so a card
serving 1k tenants pays 1k dispatches and 1k tiny batches a step.  This
package stacks a TENANT axis onto the existing device state layouts so
one device step serves every compatible tenant at once — the CAMA idea (arXiv 2112.00267: many
automata packed into shared state arrays) applied to both device-query
accumulator rows and dense-NFA partition rows:

- ``fingerprint``: canonical structural hash of a query (pattern
  skeleton / window kind + size, aggregator set, dtype lanes, filter
  constants, relevant ``@app:execution`` knobs) — two queries multiplex
  iff their fingerprints are equal, which guarantees the FIRST tenant's
  engine is exactly the engine every member would have built.
- ``registry``: manager-level ``MultiplexRegistry`` (one per
  ``SiddhiManager``, held on ``SiddhiContext`` so it survives app
  crashes) mapping fingerprint -> open groups with free tenant slots.
- ``tumbling_group``: ``TumblingMultiplexGroup`` packs N tenants'
  tumbling-window accumulator rows into one ``[T*G, ...]`` row bank of
  a shared :class:`~siddhi_tpu_torch.ops.device_query.DeviceQueryEngine`;
  one accumulate step a staging cycle.
- ``dense_group``: ``DenseMultiplexGroup`` gives each tenant one
  partition row of a shared
  :class:`~siddhi_tpu_torch.ops.dense_nfa.DensePatternEngine`; T tenants'
  events collapse from T single-event collision rounds into rounds of
  T partition-disjoint events.
- ``planner``: ``MultiplexPlanner``, hooked from
  ``planner/query_planner.py`` inside the ``@app:execution('tpu')``
  gates: tries a group seat first and falls back to the dedicated
  engines with its reason (``AppContext.multiplex_fallbacks``).

Activation is opt-in per app: ``@app:multiplex()`` (optionally
``slots='N'``, the per-group tenant capacity, default 8).  Per-tenant
fault isolation, Emit/IngestStats and snapshot/restore ride the
adapters (`MultiplexTenantRuntime` / `DenseMultiplexTenantRuntime`),
which present the same runtime surface as the dedicated
``DeviceQueryRuntime`` / ``DensePatternRuntime`` so barriers, stats
wiring and crash recovery work unchanged.
"""

from siddhi_tpu_torch.multiplex.fingerprint import query_fingerprint, reads_clock
from siddhi_tpu_torch.multiplex.registry import MultiplexRegistry
from siddhi_tpu_torch.multiplex.planner import MultiplexPlanner

__all__ = [
    "MultiplexPlanner",
    "MultiplexRegistry",
    "query_fingerprint",
    "reads_clock",
]
