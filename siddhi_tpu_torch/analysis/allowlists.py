"""Curated per-rule allowlists — every entry says WHY it is sanctioned.

Keys are line-number-free (``<relpath>:<Class.method-or-attr>``) so
unrelated edits don't churn the lists, and entries EXPIRE: one that no
longer matches a finding fails the run as ``stale-allowlist`` (see
``framework.Allowlist.split``), so these lists only ever shrink when
the code improves.  An entry marked "(as the reference's)" sanctions a
site where the port does what the JAX package does at the same place,
under the JAX package's own justification.

Bucket vocabulary (the JAX package's, plus the port's own):

- ``host-sync-hazard``: *ingest* — converting HOST inputs (cols/ts/
  keys) before staged_put; *drain* — the coalesced fetch +
  deferred-emit materializers; *barrier* — snapshot/restore/purge/
  timer paths, already behind drain(); *probe* — a plan-time kernel
  check, once per app.  In the port most of these calls are
  ``.tolist()`` / ``.item()`` / ``np.asarray`` on numpy values: the
  rule cannot type a receiver, so the scope is named here.
- ``ingest-put-bypass``: *staging* — the sanctioned wrapper itself;
  *mesh* — moves between shards' devices (device to device, no host
  data); *state* — engine state placement at restore/demotion
  barriers; *scalar* — a filter's value handed to ``torch.as_tensor``:
  a device tensor (no copy) or, for a constant condition, one python
  scalar, never batch data; *index* — a host row list placed as an
  index for a barrier or a slow-polled read.
"""

_E = "siddhi_tpu_torch/core/emit_queue.py"
_DP = "siddhi_tpu_torch/core/dense_pattern.py"
_HR = "siddhi_tpu_torch/core/hotkey_router.py"
_DQ = "siddhi_tpu_torch/ops/device_query.py"
_DN = "siddhi_tpu_torch/ops/dense_nfa.py"
_FG = "siddhi_tpu_torch/ops/fused_graph.py"
_SH = "siddhi_tpu_torch/parallel/device_shard.py"
_M = "siddhi_tpu_torch/parallel/mesh.py"
_DT = "siddhi_tpu_torch/devtable/storage.py"

_KEYS = ("ingest: interns the HOST key column (`keys.tolist()` on a "
         "numpy array) into table slots")
_SCALAR = ("scalar: torch.as_tensor of a compiled filter's value — a "
           "device tensor already (no copy), or one python scalar of a "
           "constant condition; never batch data")

_CHUNK = "(as the reference's) ingest: converts HOST chunk inputs " \
    "before staged_put"

ALLOWLISTS = {
    "host-sync-hazard": {
        # the sites where the port does what the reference does
        f"{_E}:fetch_coalesced":
            "(as the reference's) drain: THE sanctioned coalesced "
            "device→host fetch (one .cpu().numpy() a dtype group)",
        "siddhi_tpu_torch/core/device_single.py:"
        "DeviceQueryRuntime.process_stream_batch":
            "(as the reference's) ingest: converts HOST batch cols/ts "
            "before staged_put",
        f"{_DP}:DensePatternRuntime.intern_keys":
            "(as the reference's) ingest: host-side key interning before "
            "device routing",
        f"{_DP}:DensePatternRuntime._intern_keys_dict":
            "(as the reference's) ingest: host-side key interning before "
            "device routing",
        f"{_DP}:DensePatternRuntime._rebuild_key_index":
            "(as the reference's) ingest: host-side key-index rebuild on "
            "purge",
        f"{_DP}:DensePatternRuntime.process_stream_batch":
            "(as the reference's) ingest: converts HOST batch cols/ts "
            "before staged_put",
        f"{_DP}:DensePatternRuntime.purge_idle":
            "(as the reference's) barrier: idle purge, behind drain()",
        f"{_DP}:DensePatternRuntime.restore":
            "(as the reference's) barrier: restore path, behind drain()",
        f"{_DQ}:_split_i64":
            "(as the reference's) ingest: splits HOST int64 cols into "
            "device i32 lanes",
        f"{_DQ}:DeviceQueryEngine._host_env":
            "(as the reference's) ingest: HOST lane view for the null-safe "
            "probe",
        f"{_DQ}:DeviceQueryEngine._intern_groups":
            "(as the reference's) ingest: host-side group interning",
        f"{_DQ}:DeviceQueryEngine._intern_wgroups":
            "(as the reference's) ingest: host-side window-group interning",
        f"{_DQ}:DeviceQueryEngine.host_lane_cols":
            "(as the reference's) ingest: HOST lane materialization for "
            "host fallbacks",
        f"{_DQ}:DeviceQueryEngine._host_filter_mask":
            "(as the reference's) ingest: null-safe HOST filter probe",
        f"{_DQ}:DeviceQueryEngine.process_batch_deferred":
            "(as the reference's) ingest: converts HOST batch inputs "
            "before staged_put",
        f"{_DQ}:DeviceQueryEngine._deferred_chunk": _CHUNK,
        f"{_DQ}:DeviceQueryEngine._acc_segment":
            "(as the reference's) ingest: converts HOST segment inputs "
            "before the acc step",
        f"{_DQ}:DeviceQueryEngine._out_columns":
            "(as the reference's) drain: deferred-emit column "
            "materializer",
        f"{_DQ}:DeviceQueryEngine.host_restore":
            "(as the reference's) barrier: restore path, behind drain()",
        f"{_DQ}:DeferredDeviceEmit.materialize":
            "(as the reference's) drain: deferred-emit materializer (runs "
            "on fetched host arrays)",
        f"{_DQ}:DeferredDeviceEmit._concat_parts":
            "(as the reference's) drain: deferred-emit materializer (runs "
            "on fetched host arrays)",
        f"{_DN}:DensePatternEngine.prepare_cols":
            "(as the reference's) ingest: converts HOST batch cols before "
            "staged_put",
        f"{_DN}:DensePatternEngine.process_deferred":
            "(as the reference's) ingest: converts HOST batch inputs "
            "before staged_put",
        f"{_SH}:ShardedDeviceQueryEngine.process_batch_deferred":
            "(as the reference's) ingest: converts HOST batch inputs "
            "before staged_put",
        f"{_SH}:ShardedDeviceQueryEngine._deferred_chunk": _CHUNK,
        f"{_SH}:ShardedDeviceQueryEngine._sliding_chunk": _CHUNK,
        f"{_SH}:ShardedDeviceQueryEngine._acc_segment":
            "(as the reference's) ingest: converts HOST segment inputs "
            "before the acc step",
        f"{_M}:route_to_shards":
            "(as the reference's) ingest: host-side shard routing of HOST "
            "batches",
        f"{_M}:ShardedPatternEngine.process_deferred":
            "(as the reference's) ingest: converts HOST batch inputs "
            "before device placement",
        # the port's own sites
        f"{_DP}:DensePatternRuntime._emit_deferred":
            "drain: the deferred-emit materializer indexes the HOST batch's "
            "raw key column with the fetched emit rows",
        "siddhi_tpu_torch/core/fused_graph.py:"
        "FusedChainRuntime.process_stream_batch":
            "ingest: converts HOST batch cols/ts before staged_put "
            "(as the reference's DeviceQueryRuntime.process_stream_batch)",
        f"{_HR}:HotKeyRouterRuntime._route_cycle":
            "ingest: `.tolist()` of np.unique over the HOST key column",
        f"{_HR}:SpaceSavingSketch.update":
            "ingest: the host-side heavy-hitter sketch over numpy keys and "
            "counts",
        f"{_HR}:_put_row":
            "ingest: np.asarray of one python value before its staged_put "
            "(a promotion/demotion row write)",
        f"{_DT}:DeviceTable._host_upsert": _KEYS,
        f"{_DT}:DeviceTable._key_slots": _KEYS,
        f"{_DT}:DeviceTable.delete_keys": _KEYS,
        f"{_DT}:DeviceTable.insert": _KEYS,
        f"{_DT}:DeviceTable.upsert": _KEYS,
        f"{_DT}:DeviceTable.column_env":
            "ingest: the HOST slot list as an int64 array before the "
            "device gather",
        f"{_DT}:DeviceTable.rows_batch":
            "ingest: the HOST slot list as an int64 array before the "
            "device gather",
        f"{_DT}:DeviceTable.restore":
            "barrier: restore path, behind drain()",
        "siddhi_tpu_torch/kernels/probe.py:kernels_available":
            "probe: the plan-time kernel check waits once for the probe "
            "kernel so a launch fault fails app creation, not a batch",
        f"{_DN}:DensePatternEngine._process_general":
            "ingest: `.tolist()` of the HOST collision-round bounds "
            "(numpy, from partition_rounds)",
        f"{_DN}:state_from_numpy":
            "barrier: restore path, behind drain()",
        f"{_DQ}:_lane":
            "ingest: a HOST constant of a compiled expression, filled on "
            "the device (np.asarray(...).item() of a python scalar)",
        f"{_DQ}:DeviceQueryEngine._gk_vals":
            "ingest: host-side numeric group keys of the interned groups",
        f"{_DQ}:DeviceQueryEngine._intern_rows":
            "ingest: host-side exact interning of HOST key columns",
        f"{_DQ}:DeviceQueryEngine.purge_idle_ids":
            "barrier: key purge, behind drain() (host id tables)",
        f"{_DQ}:DeviceQueryEngine.reset_rows":
            "barrier: key purge, behind drain(); HOST row lists before "
            "staged_put",
        f"{_DQ}:DeviceQueryEngine.state_from_host":
            "barrier: restore path, behind drain()",
        f"{_FG}:FusedGraphEngine._host_batch":
            "ingest: converts HOST batch cols into lanes before staged_put",
        f"{_FG}:FusedGraphEngine.process_batch_deferred":
            "ingest: converts HOST batch ts before staged_put",
        "siddhi_tpu_torch/ops/hotkey_scan.py:scan_state_from_numpy":
            "barrier: restore path, behind drain()",
        f"{_SH}:ShardedDeviceQueryEngine.purge_idle_keys":
            "barrier: key purge, behind drain(); HOST row lists",
        f"{_SH}:ShardedDeviceQueryEngine.state_from_host":
            "barrier: restore path, behind drain()",
        f"{_M}:ShardedPatternEngine.state_from_host":
            "barrier: restore path, behind drain()",
        f"{_M}:split_rows":
            "ingest: host-side shard routing of HOST row lists",
    },
    "ingest-put-bypass": {
        "siddhi_tpu_torch/core/ingest_stage.py:_put":
            "staging: the sanctioned wrapper's leaf copier (staged_put "
            "arms ingest.put and counts, then calls it)",
        f"{_HR}:_put_row":
            "index: one host row number as the index of a promotion/"
            "demotion row write; the value itself goes through staged_put",
        "siddhi_tpu_torch/core/join.py:DeviceJoinProbe._device_mask":
            _SCALAR,
        "siddhi_tpu_torch/devtable/join.py:DevTableJoinRuntime.probe":
            _SCALAR,
        f"{_DT}:DeviceTable._demote":
            "state: the live slots of a table being demoted to the host, "
            "a one-time barrier",
        f"{_DT}:DeviceTable.column_env":
            "index: the HOST slot list of a pull or join as a gather "
            "index, not event data",
        f"{_DT}:DeviceTable.rows_batch":
            "index: the HOST slot list of a pull as a gather index, not "
            "event data",
        f"{_DT}:DeviceTable.snapshot":
            "state: a snapshot's slot list, a barrier behind drain()",
        "siddhi_tpu_torch/kernels/dense_step.py:build_packed_nfa.step":
            _SCALAR,
        f"{_DN}:DensePatternEngine.active_sum":
            "index: slow-polled gauge rows (pattern_state), not ingest",
        f"{_DN}:DensePatternEngine.filter_matrix": _SCALAR,
        f"{_DN}:DensePatternEngine.make_general_step.eval_ok": _SCALAR,
        "siddhi_tpu_torch/ops/hotkey_scan.py:"
        "HotKeyScanEngine._filter_matrix": _SCALAR,
        "siddhi_tpu_torch/ops/hotkey_scan.py:scan_state_from_numpy":
            "state: restore placement, a barrier behind drain()",
        "siddhi_tpu_torch/ops/nfa_scan.py:ScanPatternEngine._filter_matrix":
            _SCALAR,
        f"{_SH}:ShardedDeviceQueryEngine._count":
            "mesh: gathers each shard's count onto the first card "
            "(device to device, no host data)",
        f"{_SH}:ShardedDeviceQueryEngine.init_state":
            "state: one-time engine state placement on each shard's card, "
            "not ingest",
        f"{_M}:ShardedPatternEngine._psum":
            "mesh: gathers each shard's partial sum onto the first card "
            "(device to device, no host data)",
        f"{_M}:ShardedPatternEngine.active_sum":
            "index: slow-polled gauge rows (pattern_state), not ingest",
        f"{_M}:ShardedState.__getitem__":
            "mesh: a whole-state read concatenates the shards onto the "
            "first card (device to device; snapshots and tests only)",
    },
    "broad-except-swallow": {
        # empty: every broad swallow on the processing path logs,
        # counts, or re-routes today
    },
    "lock-discipline": {
        # empty: every conflict the lexical pass can see is also seen —
        # and reported once — by the flow-sensitive lockset-race rule
        # below (the wrapper stands down on shared keys)
    },
    "lockset-race": {
        "siddhi_tpu_torch/core/app_runtime.py:SiddhiAppRuntime._snapshot_svc":
            "(as the reference's) replan() clears the lazy cache from the "
            "main path, but only inside the process-lock barrier with "
            "sources paused, device emits drained, and the persist daemon "
            "flushed — no thread entry can race the clear; the lazy "
            "re-init itself is idempotent (same service rebuilt from the "
            "same parts)",
        "siddhi_tpu_torch/core/app_runtime.py:SiddhiAppRuntime._durab_stats":
            "(as the reference's) replan() clears the lazy cache from the "
            "main path, but only inside the process-lock barrier with the "
            "persist daemon flushed; re-init is idempotent",
        "siddhi_tpu_torch/core/app_runtime.py:SiddhiAppRuntime._ckpt_writer":
            "(as the reference's) replan() clears the lazy cache from the "
            "main path, but only inside the process-lock barrier with the "
            "persist daemon flushed; re-init is idempotent",
        "siddhi_tpu_torch/robustness/watchdog.py:Watchdog._last_progress":
            "(as the reference's) single-writer lifecycle handshake: "
            "start() stamps it once BEFORE the daemon thread exists "
            "(Thread.start is the happens-before edge), and every later "
            "write is from the daemon thread itself (_tick/_trip) — there "
            "is never a concurrent second writer, and a float store is "
            "GIL-atomic",
    },
    "lock-order-deadlock": {
        # empty: the global acquisition-order graph is acyclic today
        # (process_lock strictly outermost, component locks leaf-only)
    },
    "barrier-flush-completeness": {
        # empty: StreamJunction.stop flushes _ring, Sink.shutdown
        # flushes _spool
    },
    "jit-purity": {
        # the helper scan reaches kernel wrappers whose int()/float()/
        # bool() casts act on STATIC values (python scalars, config
        # sets); the cast heuristic cannot prove staticness without type
        # inference, so each is sanctioned by hand:
        "siddhi_tpu_torch/kernels/bank_scatter.py:_bits":
            "int(identity)/float(identity) of the python identity scalar "
            "(0, +-inf) packed into the kernel's 32-bit argument",
        "siddhi_tpu_torch/kernels/dense_batch.py:_plan":
            "int(within is not None)/int(within or 0): python config "
            "ints passed to the plan entry point",
        "siddhi_tpu_torch/kernels/dense_step.py:packed_step":
            "int(within is not None)/int(within or 0): python config "
            "ints passed to the kernel launch",
        f"{_DQ}:DeviceQueryEngine._running_step":
            "bool(kinds & {...}) on a python set of aggregation kinds — "
            "static config (as the reference's make_step.step)",
        f"{_DQ}:_lane":
            "np.asarray(x).item() only on a python constant (a tensor "
            "takes the other branch): no device value is read",
        "siddhi_tpu_torch/kernels/dense_batch.py:batch_step_plain":
            "the kernel's plain twin, which runs where its tensors are "
            "CPU tensors; on the card batch_step launches the kernel and "
            "the twin runs only in the kernel check, off the main path",
    },
    "retrace-hazard": {
        f"{_FG}:FusedGraphEngine.step":
            "self.dense.make_general_step(k) returns the engine's "
            "_general_cache entry after the first build; the receiver is "
            "an engine attribute the call graph cannot type",
        f"{_M}:ShardedPatternEngine.process_deferred":
            "eng.make_general_step(k) returns the engine's _general_cache "
            "entry after the first build; the receiver is a local the "
            "call graph cannot type",
    },
    "fallback-discipline": {
        # note_fallback (planner/app_planner.py:629) counts through
        # getattr(sm, f"record_{family}_fallback"), which the call graph
        # cannot follow; tests/test_torch_analysis.py holds every family
        # the port passes to it to a recorder and a context dict
        "siddhi_tpu_torch/core/app_runtime.py:SiddhiAppRuntime._build_table":
            "log.warning, then note_fallback(ctx, 'devtable', ...) "
            "counts it at planner/app_planner.py:629 note_fallback "
            "(record_devtable_fallback through getattr)",
        "siddhi_tpu_torch/multiplex/planner.py:MultiplexPlanner.try_single":
            "delegates to self._fallback: log.warning, then "
            "note_fallback(ctx, 'multiplex', ...) counts it at "
            "planner/app_planner.py:629 (record_multiplex_fallback "
            "through getattr)",
        "siddhi_tpu_torch/multiplex/planner.py:MultiplexPlanner.try_state":
            "delegates to self._fallback: log.warning, then "
            "note_fallback(ctx, 'multiplex', ...) counts it at "
            "planner/app_planner.py:629 (record_multiplex_fallback "
            "through getattr)",
        "siddhi_tpu_torch/planner/hotkeys.py:try_wrap_hotkey":
            "log.warning, then note_fallback(ctx, 'hotkey', ...) counts "
            "it at planner/app_planner.py:629 (record_hotkey_fallback "
            "through getattr)",
        "siddhi_tpu_torch/planner/query_planner.py:plan_join":
            "log.warning, then note_fallback(ctx, 'devtable', ...) counts "
            "it at planner/app_planner.py:629 (record_devtable_fallback "
            "through getattr)",
        "siddhi_tpu_torch/planner/query_planner.py:plan_output":
            "log.warning, then note_fallback(ctx, 'devtable', ...) counts "
            "it at planner/app_planner.py:629 (record_devtable_fallback "
            "through getattr)",
        "siddhi_tpu_torch/core/join.py:DeviceJoinProbe._check":
            "not a fallback gate: a condition variable the scope cannot "
            "resolve is left out of the lane set; the compile below then "
            "raises out of _check, and plan_join logs the WARNING and "
            "counts it (note_device_fallback -> record_device_fallback)",
        "siddhi_tpu_torch/planner/costmodel.py:build_plan_record":
            "counted (record_planner_fallback) but logged at DEBUG on "
            "purpose: the port's fallback WARNINGs stay the device "
            "paths' own, which the differential tests compare with the "
            "reference's (ROADMAP.md, the port notes of item 15 (b))",
        "siddhi_tpu_torch/planner/monitor.py:PlanMonitor.decide":
            "(as the reference's) the skipped candidate was already "
            "counted (record_planner_fallback) at plan time by "
            "costmodel.build_plan_record (logged there at DEBUG, see its "
            "entry); decide() re-checks the same static composability "
            "every tick only to keep infeasible paths out of the "
            "re-score — repeating the count each tick would inflate the "
            "fallback counters without new events",
        "siddhi_tpu_torch/planner/fusion.py:_try_lower_chain":
            "(as the reference's) delegates to the `fallback` callback "
            "built in plan_fused_chains (log.warning + note_fallback(ctx, "
            "'fused', ...) -> record_fused_fallback) and passed as a "
            "parameter — parameter-passed callables are outside the call "
            "graph's documented resolution scope",
    },
    "thread-lifecycle": {
        # empty: every spawn site is daemon=True or joined/cancelled on
        # a shutdown path today
    },
    "bounded-queue-discipline": {
        "siddhi_tpu_torch/core/stream.py:StreamJunction.__init__":
            "the @async ring is bounded by back-pressure, not maxlen: "
            "send() waits on the app-lock condition while it holds "
            "buffer_size batches (the reference's "
            "queue.Queue(maxsize=buffer_size) blocks the same way); a "
            "maxlen deque would drop the oldest batch instead",
    },
}

#: syncs the card's sync guard (``analysis/sync_guard.py``) sanctions
#: outside the count-gated drain, the staging put and the host-sync
#: allowlist: ``rel:scope`` -> why.  The guard's card run reports every
#: entry it never hit, so the list can only shrink.
ON_CARD_SYNCS = {
    # empty: on the card, every sync of chip_smoke.py's four guarded
    # main-path apps lies in the staging put or the count-gated drain
}
