"""siddhi_tpu_torch — the PyTorch/CUDA port of siddhi_tpu.

A second package beside the JAX one, ported one slice at a time (see
ROADMAP.md).  It imports ``torch`` and ``numpy`` and nothing of JAX or of
the JAX package; the tests hold it bit for bit against that package.

The slices so far:

- ``compile_pattern`` builds a ``DensePatternEngine`` for capture-free
  ``every`` chains, which steps a whole batch in one hand-written CUDA
  kernel on the card (``kernels/csrc/dense_batch.cu``: each partition's
  events in order, its state row in place) and in its plain torch
  version on the CPU;
- ``SiddhiManager`` runs partitioned pattern apps end to end through
  the dense runtime and, under ``@app:hotkeys``, the skew router, whose
  hot keys ride the fused scan kernel (``kernels/csrc/scan_chain.cu``);
- ``SiddhiManager`` runs ``define aggregation`` apps, whose device
  bucket bank adds each batch through the segmented-reduce kernel
  (``kernels/csrc/bank_scatter.cu``); ``rt.aggregations[...].find`` and
  ``rt.query`` pull from them;
- ``SiddhiManager`` runs plain SiddhiQL queries on the host query
  runtime and, under ``@app:execution('tpu')``, on the device query
  path (``compile_query`` builds its engine alone): filters, running
  aggregates, sliding and tumbling windows and group by as torch ops,
  inside a partition too;
- the product path's ``ingest.depth``/``emit.depth`` take ``'auto'``,
  ``rt.pattern_state()`` reads each pattern engine's occupancy, and
  ``compile_scan_pattern`` builds the single-key max-plus scan engine;
- ``define function`` scripts, ``SiddhiManager.set_extension`` (custom
  functions, windows, aggregators, stream processors) and the
  manager's validate, sandbox, attribute and registry APIs;
- joins, tables, named windows, triggers and on-demand queries;
- persistence: ``SiddhiManager.set_persistence_store`` with one of the
  stores below, ``rt.persist()`` (sync, or async through the checkpoint
  writer), ``rt.restore_last_revision()`` and, under
  ``@app:faults(journal=...)``, restore-and-replay of the input journal;
- stream-graph fusion, device tables, multiplexing, transports and the
  operations layer (statistics, tracing, overload control, live
  re-plans, the service);
- the mesh: ``@app:execution('tpu', devices='N')`` shards partitioned
  patterns and device queries over N shards (``parallel/``), and
  ``@app:plan(auto='true')`` lets the cost model choose each query's
  lowering, re-planned live by the plan monitor.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from siddhi_tpu_torch.core.manager import SiddhiManager
from siddhi_tpu_torch.durability import DurableFileSystemPersistenceStore
from siddhi_tpu_torch.ops.device_query import compile_query
from siddhi_tpu_torch.ops.dense_nfa import (
    compile_pattern,
    state_from_numpy,
    state_to_numpy,
)
from siddhi_tpu_torch.ops.nfa_scan import compile_scan_pattern
from siddhi_tpu_torch.util.persistence import (
    FileSystemPersistenceStore,
    IncrementalFileSystemPersistenceStore,
    InMemoryPersistenceStore,
    PersistenceStore,
)

__all__ = ["DurableFileSystemPersistenceStore", "FileSystemPersistenceStore",
           "InMemoryPersistenceStore", "IncrementalFileSystemPersistenceStore",
           "PersistenceStore", "SiddhiManager", "compile_pattern",
           "compile_query", "compile_scan_pattern", "state_from_numpy",
           "state_to_numpy"]
