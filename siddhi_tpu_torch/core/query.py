"""Query runtime: receiver -> processor chain -> selector -> rate limiter
-> output callback.

Port of the JAX package's ``core/query.py``, itself a re-design of the
reference ``core/query/`` (QueryRuntimeImpl.java:43,
ProcessStreamReceiver.java:44, FilterProcessor.java:32,
QuerySelector.java:44): operators transform columnar numpy batches
instead of walking pooled event chunks, and per-group aggregation runs
as segmented vectorized runs rather than per-event executor calls.  It
is host code in both packages.  Host queries run the whole chain here;
a dense pattern query's matches, fetched to the host by the dense
runtime's count-gated emit path, enter at the selector: a passthrough
one, or the aggregating form (group by, having, aggregators) with its
per-key state on the partition axis.  The reference's input journal,
latency tracker, debugger and join sides are later slices of the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from siddhi_tpu_torch.core import event as ev
from siddhi_tpu_torch.core.event import EventBatch, events_from_batch
from siddhi_tpu_torch.core.exceptions import (
    SiddhiAppCreationError,
    SiddhiAppRuntimeError,
)
from siddhi_tpu_torch.core.stream import QueryCallback, StreamJunction
from siddhi_tpu_torch.ops.aggregators import AggExecutor
from siddhi_tpu_torch.planner.host_expr import N_KEY, TS_KEY, CompiledExpression
from siddhi_tpu_torch.query_api import AttrType


def build_env(batch: EventBatch, key_map: Optional[Dict[str, str]] = None) -> Dict:
    """Build the expression-eval environment from a batch.

    ``key_map`` maps env keys -> batch column names (identity when None).
    """
    if key_map is None:
        env = dict(batch.columns)
    else:
        env = {k: batch.columns[v] for k, v in key_map.items()}
    env[TS_KEY] = batch.timestamps
    env[N_KEY] = len(batch)
    return env


def format_group_keys(key_cols: List[np.ndarray], rows) -> List:
    """Host group-key IDENTITY format, shared by the selector and the
    device engines (key equality drives per-group state and rate-limit
    dedup): scalar for one key column, tuple otherwise, numpy scalars
    unboxed."""
    if len(key_cols) == 1:
        c = key_cols[0]
        return [c[i].item() if isinstance(c[i], np.generic) else c[i]
                for i in rows]
    return [
        tuple(c[i].item() if isinstance(c[i], np.generic) else c[i]
              for c in key_cols)
        for i in rows
    ]


class Processor:
    def process(self, batch: EventBatch, now: int) -> EventBatch:
        raise NotImplementedError


class FilterProcessor(Processor):
    """Drops rows whose boolean condition is false
    (reference: query/processor/filter/FilterProcessor.java:32)."""

    def __init__(self, condition: CompiledExpression, key_map: Optional[Dict[str, str]] = None):
        if condition.type != AttrType.BOOL:
            raise SiddhiAppCreationError("filter condition must be boolean")
        self.condition = condition
        self.key_map = key_map

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        if len(batch) == 0:
            return batch
        mask = np.broadcast_to(
            np.asarray(self.condition.fn(build_env(batch, self.key_map))), (len(batch),)
        )
        # control events (RESET/TIMER) always pass through
        keep = mask | (batch.types >= ev.TIMER)
        if keep.all():
            return batch
        return batch.mask(keep)


class WindowChainProcessor(Processor):
    """Adapts a WindowProcessor into the chain."""

    def __init__(self, window):
        self.window = window

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        return self.window.process(batch, now)


class StreamFunctionChainProcessor(Processor):
    """#ns:fn(...) stream processors (extension SPI)."""

    def __init__(self, fn):
        self.fn = fn

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        return self.fn.process(batch, now)


# ---------------------------------------------------------------------------
# Selector
# ---------------------------------------------------------------------------


class AggBinding:
    """One aggregator call inside the select clause: env key it publishes,
    the executor, and the compiled argument (None == count())."""

    def __init__(self, env_key: str, executor: AggExecutor, arg: Optional[CompiledExpression]):
        self.env_key = env_key
        self.executor = executor
        self.arg = arg


class SelectItem:
    def __init__(self, name: str, compiled: CompiledExpression):
        self.name = name
        self.compiled = compiled


class QuerySelector:
    """Projection + group-by + aggregation + having + order-by/limit
    (reference: query/selector/QuerySelector.java:44,76-205).

    ``batch_mode`` mirrors the reference's batched group-by processing
    (ProcessingMode.BATCH): with a batch window upstream, only the last
    row per group of each flush produces output.
    """

    def __init__(
        self,
        output_stream_id: str,
        items: Optional[List[SelectItem]],  # None == select *
        output_attribute_names: List[str],
        aggregations: List[AggBinding],
        group_keys: List[CompiledExpression],
        having: Optional[CompiledExpression],
        order_by: List[Tuple[str, bool]],
        limit: Optional[int],
        offset: Optional[int],
        batch_mode: bool = False,
    ):
        self.output_stream_id = output_stream_id
        self.items = items
        self.output_attribute_names = output_attribute_names
        self.aggregations = aggregations
        self.group_keys = group_keys
        self.having = having
        self.order_by = order_by
        self.limit = limit
        self.offset = offset
        self.batch_mode = batch_mode
        # group key -> {agg index -> state dict}
        self.group_states: Dict = {}
        # partitioned dense patterns set this True: each incoming match
        # row carries its partition key (aux["partition_keys"]), which is
        # prepended to the group id so ONE shared selector keeps per-key
        # aggregation state — the dense analog of the host's per-key
        # selector instances (PartitionStateHolder + GROUP_BY_KEY)
        self.partition_axis = False

    # -- state plumbing (snapshot contract) ---------------------------------

    def snapshot(self) -> Dict:
        return {"group_states": self.group_states}

    def restore(self, state: Dict):
        self.group_states = state["group_states"]

    # -- processing ---------------------------------------------------------

    def drop_partition_keys(self, keys) -> None:
        """Discard per-key aggregation state for purged partition keys
        (partition-axis selectors; host analog: the per-key instance —
        selector included — is destroyed on idle purge)."""
        doomed = set(keys)
        self.group_states = {
            gid: st for gid, st in self.group_states.items()
            if not (isinstance(gid, tuple) and len(gid) == 2
                    and gid[0] in doomed)
        }

    def _group_ids(self, env, n, pkeys=None) -> List:
        if not self.group_keys:
            base = [None] * n
        else:
            key_cols = [np.broadcast_to(np.asarray(k.fn(env)), (n,)) for k in self.group_keys]
            base = format_group_keys(key_cols, range(n))
        if pkeys is None:
            return base
        return [(pk, k) for pk, k in zip(pkeys, base)]

    def _agg_outputs(self, env, n, keys, is_remove: bool) -> Dict[str, np.ndarray]:
        """Segmented per-group aggregation preserving arrival order."""
        out: Dict[str, np.ndarray] = {}
        if not self.aggregations:
            return out
        # order-preserving group segments
        segments: Dict = {}
        for i, k in enumerate(keys):
            segments.setdefault(k, []).append(i)
        for ai, binding in enumerate(self.aggregations):
            if binding.arg is not None:
                vals = np.broadcast_to(np.asarray(binding.arg.fn(env)), (n,))
            else:
                vals = np.ones(n, dtype=np.int64)
            col: Optional[np.ndarray] = None
            for gkey, idx_list in segments.items():
                gstate = self.group_states.setdefault(gkey, {})
                if ai not in gstate:
                    gstate[ai] = binding.executor.new_state()
                idx = np.asarray(idx_list)
                seg_vals = vals[idx]
                # null inputs leave the aggregate UNCHANGED (reference
                # aggregators skip null data): feed only non-null values
                # and forward-fill the running output over null rows
                nulls = None
                if seg_vals.dtype == object:
                    nulls = np.frompyfunc(
                        lambda x: x is None, 1, 1)(seg_vals).astype(bool)
                    if nulls.any():
                        seg_vals = seg_vals[~nulls]
                    else:
                        nulls = None
                res = (
                    binding.executor.remove_run(gstate[ai], seg_vals)
                    if is_remove
                    else binding.executor.add_run(gstate[ai], seg_vals)
                )
                res = np.asarray(res)
                last_store = gstate.setdefault("_last_out", {})
                if nulls is not None:
                    full = np.empty(len(idx), dtype=object)
                    # position of the last non-null at or before each
                    # row; rows before any non-null value repeat the
                    # aggregate's LAST output from earlier batches
                    # (None only while the aggregate never saw a value)
                    prev = last_store.get(ai)
                    fill = np.cumsum((~nulls).astype(np.int64)) - 1
                    for j in range(len(idx)):
                        full[j] = res[fill[j]] if fill[j] >= 0 else prev
                    if len(res):
                        last_store[ai] = res[-1]
                    res = full
                elif len(res):
                    last_store[ai] = res[-1]
                if col is None:
                    col = np.empty(n, dtype=res.dtype if res.dtype != object else object)
                elif res.dtype == object and col.dtype != object:
                    # a later group emitted None (all-null inputs): the
                    # whole output column must carry real nulls, not
                    # coerced NaN/garbage
                    col = col.astype(object)
                col[idx] = res
            out[binding.env_key] = col if col is not None else np.empty(0)
        return out

    def process(self, batch: EventBatch, now: int) -> EventBatch:
        n = len(batch)
        if n == 0:
            return self._empty_output(batch)
        outputs: List[EventBatch] = []
        # split into maximal runs of equal event type (CURRENT/EXPIRED/...)
        change = np.flatnonzero(np.diff(batch.types)) + 1
        bounds = [0, *change.tolist(), n]
        for s, e in zip(bounds[:-1], bounds[1:]):
            # one run (a dense match batch, a filter's output) is the
            # batch itself: no copy of its columns
            run = batch if e - s == n else batch.take(np.arange(s, e))
            rtype = int(run.types[0])
            if rtype == ev.RESET:
                for gstate in self.group_states.values():
                    for ai, st in gstate.items():
                        if ai == "_last_out":  # null-carry cache, not
                            st.clear()         # an executor state
                            continue
                        self.aggregations[ai].executor.reset(st)
                continue
            if rtype == ev.TIMER:
                continue
            outputs.append(self._process_run(run, rtype))
        outs = [o for o in outputs if len(o)]
        if not outs:
            return self._empty_output(batch)
        result = EventBatch.concat(outs)
        result = self._order_limit(result)
        return result

    def _process_run(self, run: EventBatch, rtype: int) -> EventBatch:
        n = len(run)
        env = build_env(run)
        pkeys = None
        if self.partition_axis:
            pkeys = run.aux.get("partition_keys")
            if pkeys is None or len(pkeys) != n:
                raise SiddhiAppRuntimeError(
                    "partition-axis selector received rows without the "
                    "partition-key side channel")
        keys = self._group_ids(env, n, pkeys)
        if not self.group_keys and not self.aggregations:
            # passthrough selector over a device-lowered query: adopt
            # the upstream group-key side channel so per-group/snapshot
            # rate limiters downstream still see it
            incoming = run.aux.get("group_keys")
            if incoming is not None and len(incoming) == n:
                keys = list(incoming)
        env.update(self._agg_outputs(env, n, keys, is_remove=(rtype == ev.EXPIRED)))
        if self.items is None:
            out_cols = {nm: run.columns[nm] for nm in self.output_attribute_names}
        else:
            out_cols = {}
            for item in self.items:
                col = np.asarray(item.compiled.fn(env))
                if col.ndim == 0:
                    col = np.broadcast_to(col, (n,)).copy()
                out_cols[item.name] = col
        out = EventBatch(
            self.output_stream_id,
            self.output_attribute_names,
            out_cols,
            run.timestamps,
            run.types,
        )
        out.aux["group_keys"] = list(keys)
        # batched processing (reference ProcessingMode.BATCH): with group-by
        # emit the last row per group; with aggregators but no group-by emit
        # only the final row of the flush
        keep_idx = None
        if self.batch_mode and (self.group_keys or self.aggregations):
            last_idx: Dict = {}
            for i, k in enumerate(keys):
                last_idx[k] = i
            keep_idx = np.asarray(sorted(last_idx.values()))
            out = out.take(keep_idx)
        if self.having is not None:
            # input columns + aggregate keys first; select outputs override
            # so an alias shadowing an input attribute sees the output value
            henv = {
                k: (v[keep_idx] if keep_idx is not None and isinstance(v, np.ndarray) and v.shape[:1] == (n,) else v)
                for k, v in env.items()
            }
            henv.update(build_env(out))
            mask = np.broadcast_to(np.asarray(self.having.fn(henv)), (len(out),))
            out = out.mask(mask)
        return out

    def _order_limit(self, out: EventBatch) -> EventBatch:
        if self.order_by:
            # stable sort by keys right-to-left; descending via dense-rank
            # negation so ties keep arrival order (a reversed permutation
            # would reverse ties and break secondary keys)
            idx = np.arange(len(out))
            for name, asc in reversed(self.order_by):
                col = np.asarray(out.columns[name][idx])
                nulls = None
                if col.dtype == object:
                    nulls = np.frompyfunc(
                        lambda x: x is None, 1, 1)(col).astype(bool)
                    if not nulls.any():
                        nulls = None
                if nulls is None:
                    _, dense = np.unique(col, return_inverse=True)
                    key = dense if asc else -dense
                else:
                    # nulls order LAST in both directions (reference
                    # OrderByEventComparator: a null value loses to any
                    # non-null regardless of asc/desc)
                    nn = col[~nulls]
                    key = np.zeros(len(col), dtype=np.int64)
                    if len(nn):
                        _, dense_nn = np.unique(nn, return_inverse=True)
                        key[~nulls] = dense_nn if asc else -dense_nn
                    key[nulls] = (int(key[~nulls].max()) + 1
                                  if len(nn) else 0)
                order = np.argsort(key, kind="stable")
                idx = idx[order]
            out = out.take(idx)
        if self.offset is not None:
            out = out.take(np.arange(min(self.offset, len(out)), len(out)))
        if self.limit is not None:
            out = out.take(np.arange(0, min(self.limit, len(out))))
        return out

    def _empty_output(self, batch: EventBatch) -> EventBatch:
        return EventBatch(
            self.output_stream_id,
            self.output_attribute_names,
            {nm: np.empty(0) for nm in self.output_attribute_names},
            np.empty(0, dtype=np.int64),
            np.empty(0, dtype=np.int8),
        )


# ---------------------------------------------------------------------------
# Output rate limiting (reference: query/output/ratelimit/)
# ---------------------------------------------------------------------------


class OutputRateLimiter:
    # time-driven limiters need a scheduler task (next_wakeup/on_time);
    # event-count limiters set this False so the planner registers none
    needs_scheduler_task = True

    def process(self, batch: EventBatch, now: int) -> Optional[EventBatch]:
        return batch

    def on_time(self, now: int) -> Optional[EventBatch]:
        return None

    def next_wakeup(self) -> Optional[int]:
        return None

    def snapshot(self) -> Dict:
        return {}

    def restore(self, state: Dict):
        pass


class PassThroughRateLimiter(OutputRateLimiter):
    needs_scheduler_task = False


class EventRateLimiter(OutputRateLimiter):
    """`output <all|first|last> every N events` (reference:
    ratelimit/event/*PerEventOutputRateLimiter)."""

    needs_scheduler_task = False

    def __init__(self, n: int, mode: str):
        self.n = n
        self.mode = mode  # all | first | last
        self._count = 0
        self._held: List[EventBatch] = []

    def process(self, batch: EventBatch, now: int) -> Optional[EventBatch]:
        n = len(batch)
        if n == 0:
            return None
        if self.mode in ("first", "last"):
            pos = (self._count + np.arange(n)) % self.n
            self._count += n
            target = 0 if self.mode == "first" else self.n - 1
            out = batch.mask(pos == target)
            return out if len(out) else None
        # all: hold rows, release complete groups of n
        self._count += n
        self._held.append(batch)
        total = sum(len(b) for b in self._held)
        k = (total // self.n) * self.n
        if k == 0:
            return None
        merged = EventBatch.concat(self._held)
        out = merged.take(np.arange(k))
        rest = merged.take(np.arange(k, total))
        self._held = [rest] if len(rest) else []
        return out

    def snapshot(self):
        return {"count": self._count, "held": self._held}

    def restore(self, state):
        self._count, self._held = state["count"], state["held"]


class GroupByEventRateLimiter(OutputRateLimiter):
    """`output <first|last> every N events` on a GROUPED query: first/last
    PER GROUP within each N-event window (reference:
    ratelimit/event/FirstGroupByPerEventOutputRateLimiter.java,
    LastGroupByPerEventOutputRateLimiter.java)."""

    needs_scheduler_task = False

    def __init__(self, n: int, mode: str):
        self.n = n
        self.mode = mode  # first | last
        self._count = 0
        self._seen: set = set()          # first: groups emitted this window
        # last: group -> held single-row batch (previous batches) or a
        # row index into the CURRENT batch; dict order == first arrival
        # of the group in the window (python dicts keep a key's position
        # on overwrite, matching the reference's LinkedHashMap)
        self._last: Dict = {}

    def process(self, batch: EventBatch, now: int) -> Optional[EventBatch]:
        nrows = len(batch)
        if nrows == 0:
            return None
        keys = batch.aux.get("group_keys")
        if keys is None or len(keys) != len(batch):
            # the planner only builds this limiter for grouped queries,
            # whose selector always attaches the side channel — a missing
            # aux is a wiring bug; degrading to one global group would be
            # silently wrong output
            raise SiddhiAppRuntimeError(
                "per-group rate limiter received a batch without the "
                "group-key side channel")
        outs: List[EventBatch] = []
        first_rows: List[int] = []

        def _flush_last():
            if not self._last:
                return
            pieces = [
                v if isinstance(v, EventBatch) else batch.take(np.asarray([v]))
                for v in self._last.values()
            ]
            outs.append(EventBatch.concat(pieces))
            self._last.clear()

        for i in range(nrows):
            k = keys[i]
            if self.mode == "first":
                if k not in self._seen:
                    self._seen.add(k)
                    first_rows.append(i)
            else:
                self._last[k] = i  # local index; materialized lazily
            self._count += 1
            if self._count % self.n == 0:  # window closes
                if self.mode == "first":
                    self._seen.clear()
                else:
                    _flush_last()
        if self.mode == "last":
            # batch ends with the window open: pin surviving local rows
            # (one take per GROUP, not per row)
            for k, v in list(self._last.items()):
                if not isinstance(v, EventBatch):
                    self._last[k] = batch.take(np.asarray([v]))
        if self.mode == "first" and first_rows:
            outs.insert(0, batch.take(np.asarray(first_rows)))
        if not outs:
            return None
        return outs[0] if len(outs) == 1 else EventBatch.concat(outs)

    def snapshot(self):
        return {"count": self._count, "seen": set(self._seen),
                "last": dict(self._last)}

    def restore(self, state):
        self._count = state["count"]
        self._seen = set(state["seen"])
        self._last = dict(state["last"])


class TimeRateLimiter(OutputRateLimiter):
    """`output <all|first|last> every <t>` (reference:
    ratelimit/time/*TimeOutputRateLimiter)."""

    def __init__(self, ms: int, mode: str):
        self.ms = ms
        self.mode = mode
        self._held: List[EventBatch] = []
        self._first_sent = False
        self._last: Optional[EventBatch] = None
        self._window_end: Optional[int] = None

    def _roll(self, now: int):
        if self._window_end is None:
            self._window_end = now + self.ms

    def process(self, batch: EventBatch, now: int) -> Optional[EventBatch]:
        self._roll(now)
        out = self.on_time(now)
        res: List[EventBatch] = [out] if out is not None else []
        if self.mode == "first":
            if not self._first_sent and len(batch):
                self._first_sent = True
                res.append(batch.take(np.asarray([0])))
        elif self.mode == "last":
            if len(batch):
                self._last = batch.take(np.asarray([len(batch) - 1]))
        else:
            self._held.append(batch)
        return EventBatch.concat(res) if res else None

    def on_time(self, now: int) -> Optional[EventBatch]:
        if self._window_end is None or now < self._window_end:
            return None
        outs: List[EventBatch] = []
        while now >= self._window_end:
            if self.mode == "all" and self._held:
                outs.extend(self._held)
                self._held = []
            elif self.mode == "last" and self._last is not None:
                outs.append(self._last)
                self._last = None
            self._first_sent = False
            self._window_end += self.ms
        return EventBatch.concat(outs) if outs else None

    def next_wakeup(self) -> Optional[int]:
        return self._window_end

    def snapshot(self):
        return {
            "held": self._held, "first_sent": self._first_sent,
            "last": self._last, "end": self._window_end,
        }

    def restore(self, state):
        self._held = state["held"]
        self._first_sent = state["first_sent"]
        self._last = state["last"]
        self._window_end = state["end"]


class GroupByTimeRateLimiter(OutputRateLimiter):
    """`output <first|last> every <t>` on a GROUPED query: first/last
    PER GROUP within each period (reference: ratelimit/time/
    FirstGroupByPerTimeOutputRateLimiter.java,
    LastGroupByPerTimeOutputRateLimiter.java)."""

    def __init__(self, ms: int, mode: str):
        self.ms = ms
        self.mode = mode  # first | last
        self._seen: set = set()      # first: groups emitted this period
        self._last: Dict = {}        # last: group -> single-row batch
        self._window_end: Optional[int] = None

    def process(self, batch: EventBatch, now: int) -> Optional[EventBatch]:
        if self._window_end is None:
            self._window_end = now + self.ms
        out = self.on_time(now)
        res: List[EventBatch] = [out] if out is not None else []
        if len(batch) == 0:
            # having/batch-window flushes can hand over empty outputs,
            # which legitimately carry no group-key side channel
            return EventBatch.concat(res) if res else None
        keys = batch.aux.get("group_keys")
        if keys is None or len(keys) != len(batch):
            raise SiddhiAppRuntimeError(
                "per-group rate limiter received a batch without the "
                "group-key side channel")
        if self.mode == "first":
            rows = []
            for i, k in enumerate(keys):
                if k not in self._seen:
                    self._seen.add(k)
                    rows.append(i)
            if rows:
                res.append(batch.take(np.asarray(rows)))
        else:
            for i, k in enumerate(keys):
                self._last[k] = i  # local index; materialized below
            for k, v in list(self._last.items()):
                if not isinstance(v, EventBatch):
                    self._last[k] = batch.take(np.asarray([v]))
        return EventBatch.concat(res) if res else None

    def on_time(self, now: int) -> Optional[EventBatch]:
        if self._window_end is None or now < self._window_end:
            return None
        outs: List[EventBatch] = []
        while now >= self._window_end:
            if self.mode == "last" and self._last:
                outs.extend(self._last.values())
                self._last = {}
            self._seen.clear()
            self._window_end += self.ms
        return EventBatch.concat(outs) if outs else None

    def next_wakeup(self) -> Optional[int]:
        return self._window_end

    @staticmethod
    def _copy_last(last: Dict) -> Dict:
        # re-materialize the per-group single-row batches: a shallow dict
        # copy would alias EventBatch internals between the live limiter
        # and the snapshot (restored batches could bleed mutations)
        return {k: v.copy() if isinstance(v, EventBatch) else v
                for k, v in last.items()}

    def snapshot(self):
        return {"seen": set(self._seen), "last": self._copy_last(self._last),
                "end": self._window_end}

    def restore(self, state):
        self._seen = set(state["seen"])
        self._last = self._copy_last(state["last"])
        self._window_end = state["end"]


class SnapshotRateLimiter(OutputRateLimiter):
    """`output snapshot every <t>`: periodically re-emits the latest
    output per group key (reference: ratelimit/snapshot/
    WrappedSnapshotOutputRateLimiter, simplified to last-value
    snapshots)."""

    def __init__(self, ms: int, group_names: Optional[List[str]] = None):
        self.ms = ms
        self.group_names = group_names or []
        self._latest: Dict = {}
        self._window_end: Optional[int] = None

    def process(self, batch: EventBatch, now: int) -> Optional[EventBatch]:
        if self._window_end is None:
            self._window_end = now + self.ms
        cur = batch.only(ev.CURRENT)
        group_keys = batch.aux.get("group_keys")
        if group_keys is not None and len(group_keys) == len(batch):
            # align to the CURRENT subset
            cur_mask = np.isin(batch.types, (ev.CURRENT,))
            group_keys = [k for k, m in zip(group_keys, cur_mask) if m]
        for i in range(len(cur)):
            row = cur.take(np.asarray([i]))
            if group_keys is not None:
                key = group_keys[i]
            elif self.group_names:
                key = tuple(
                    row.columns[g][0] if g in row.columns else None for g in self.group_names
                )
            else:
                key = None
            self._latest[key] = row
        return self.on_time(now)

    def on_time(self, now: int) -> Optional[EventBatch]:
        if self._window_end is None or now < self._window_end:
            return None
        outs: List[EventBatch] = []
        while now >= self._window_end:
            outs = list(self._latest.values())  # latest snapshot only
            self._window_end += self.ms
        return EventBatch.concat(outs) if outs else None

    def next_wakeup(self) -> Optional[int]:
        return self._window_end

    def snapshot(self):
        return {"latest": self._latest, "end": self._window_end}

    def restore(self, state):
        self._latest, self._window_end = state["latest"], state["end"]


# ---------------------------------------------------------------------------
# Output callbacks (reference: query/output/callback/)
# ---------------------------------------------------------------------------


class OutputCallback:
    def send(self, batch: EventBatch, now: int):
        raise NotImplementedError


class InsertIntoStreamCallback(OutputCallback):
    """Routes selected events into the target junction; expired events
    become CURRENT on the next stream (reference:
    InsertIntoStreamCallback.java)."""

    def __init__(self, junction: StreamJunction, event_type: str):
        self.junction = junction
        self.event_type = event_type

    def send(self, batch: EventBatch, now: int):
        if self.event_type == "current":
            out = batch.only(ev.CURRENT)
        elif self.event_type == "expired":
            out = batch.only(ev.EXPIRED)
        else:
            out = batch.only(ev.CURRENT, ev.EXPIRED)
        if len(out) == 0:
            return
        out = out.with_types(ev.CURRENT)
        out.stream_id = self.junction.stream_id
        self.junction.send(out)


class QueryCallbackOutput(OutputCallback):
    """Feeds user QueryCallbacks with (ts, inEvents, removeEvents).

    ``app_context``/``ledger_key`` (set by QueryRuntime.add_callback)
    plug this endpoint into the crash-recovery output ledger: during
    restore-and-replay the journal suppresses the prefix of events these
    callbacks already received before the crash."""

    def __init__(self, app_context=None, ledger_key=None):
        self.callbacks: List[QueryCallback] = []
        self.app_context = app_context
        self.ledger_key = ledger_key

    def send(self, batch: EventBatch, now: int):
        if not self.callbacks or len(batch) == 0:
            return
        jr = getattr(self.app_context, "input_journal", None)
        if jr is not None and self.ledger_key is not None:
            batch = jr.deliver(self.ledger_key, batch)
            if batch is None:
                return
        cur = batch.only(ev.CURRENT)
        exp = batch.only(ev.EXPIRED)
        in_events = events_from_batch(cur) if len(cur) else None
        out_events = events_from_batch(exp) if len(exp) else None
        if in_events is None and out_events is None:
            return
        ts = int(batch.timestamps[-1])
        for cb in self.callbacks:
            cb.receive(ts, in_events, out_events)


class FanOutOutput(OutputCallback):
    def __init__(self, outputs: List[OutputCallback]):
        self.outputs = outputs

    def send(self, batch: EventBatch, now: int):
        for o in self.outputs:
            o.send(batch, now)


# ---------------------------------------------------------------------------
# Receiver + query runtime
# ---------------------------------------------------------------------------


class ProcessStreamReceiver:
    """Junction subscriber driving one query's chain
    (reference: query/input/ProcessStreamReceiver.java:99-179)."""

    def __init__(self, query_runtime: "QueryRuntime", chain_index: int = 0):
        self.query_runtime = query_runtime
        self.chain_index = chain_index

    def receive(self, batch: EventBatch):
        self.query_runtime.process(batch, self.chain_index)


class QueryRuntime:
    """One compiled query (reference: QueryRuntimeImpl.java:43).

    ``pattern_processor`` is set for a pattern query: the dense runtime
    (or the hot-key router around it), or on the host the
    ``PatternProcessor``, whose matches enter ``process`` at the
    selector, its chain being empty."""

    def __init__(
        self,
        name: str,
        chains: List[List[Processor]],
        selector: QuerySelector,
        rate_limiter: OutputRateLimiter,
        output: OutputCallback,
        app_context,
    ):
        self.name = name
        self.chains = chains
        self.selector = selector
        self.rate_limiter = rate_limiter
        self.output = output
        self.app_context = app_context
        self.callback_output: Optional[QueryCallbackOutput] = None
        self.pattern_processor = None
        # a single-stream query on the device query engine: its
        # DeviceQueryRuntime, whose outputs enter ``process`` at the
        # selector (the chain is empty)
        self.device_runtime = None
        # a join query: its JoinRuntime (core/join.py)
        self.join_runtime = None
        # which engine runs this query: 'host' (the columnar numpy
        # chain), 'device' (the device query engine), 'dense' or
        # 'hotkey' (the device pattern paths), 'device_probe' (a join
        # whose condition mask runs on the device), as
        # SiddhiAppRuntime.lowering() reports it
        self.lowered_to = "host"
        # the scheduler tasks a dense query registered (its rate task,
        # its deadline timer), for a partition that unwinds them
        self.scheduler_tasks: List = []

    @property
    def device_processor(self):
        """The runtime holding this query's device state (its dense
        pattern runtime or its device query runtime), or None on the
        host."""
        if self.lowered_to == "host":
            return None
        return self.pattern_processor or self.device_runtime

    def add_callback(self, cb: QueryCallback):
        if self.callback_output is None:
            self.callback_output = QueryCallbackOutput(
                self.app_context, ("query", self.name))
            self.output = FanOutOutput([self.output, self.callback_output])
        self.callback_output.callbacks.append(cb)

    def process(self, batch: EventBatch, chain_index: int = 0):
        # a deferred dense emit carries the clock sampled when its batch
        # was PROCESSED (aux side channel): time rate limiters see the
        # synchronous path's clock sequence, not the later drain time
        now = batch.aux.pop("emit_now", None)
        if now is None:
            now = self.app_context.timestamp_generator.current_time()
        b = batch
        for p in self.chains[chain_index]:
            b = p.process(b, now)
            if len(b) == 0:
                return
        out = self.selector.process(b, now)
        out = self.rate_limiter.process(out, now)
        if out is not None and len(out):
            self.output.send(out, now)

    # -- state plumbing (snapshot contract) ---------------------------------

    def snapshot_state(self, fetch: bool = True) -> Dict:
        """Every stateful element of this query: windows in the chain,
        the selector's group states, the rate limiter, a join's side
        windows and the pattern runtime (the reference's per-query
        StateHolder walk, util/snapshot/SnapshotService.java:101-169).
        ``fetch=False`` leaves the device runtime's state tensors on the
        device (the persist path's capture clones them)."""
        self._drain_device_emits()
        state: Dict = {"selector": self.selector.snapshot(),
                       "rate_limiter": self.rate_limiter.snapshot()}
        windows = {}
        for ci, chain in enumerate(self.chains):
            for pi, p in enumerate(chain):
                if isinstance(p, WindowChainProcessor):
                    windows[f"{ci}.{pi}"] = p.window.snapshot()
        if windows:
            state["windows"] = windows
        if self.join_runtime is not None:
            jw = {label: side.window.snapshot() for label, side in
                  (("left", self.join_runtime.left),
                   ("right", self.join_runtime.right))
                  if side.window is not None}
            if jw:
                state["join_windows"] = jw
        dp = self.device_processor
        if self.pattern_processor is not None:
            state["pattern"] = (self.pattern_processor.snapshot()
                                if dp is None else dp.snapshot(fetch))
        if self.device_runtime is not None:
            state["device"] = self.device_runtime.snapshot(fetch)
        return state

    def _drain_device_emits(self):
        """Flush barrier of the device emit pipelines: this query's
        queued outputs go through the selector, limiter and output BEFORE
        the surrounding snapshot or restore reads or replaces that
        state."""
        if self.device_processor is not None:
            self.device_processor.drain()

    def restore_state(self, state: Dict):
        self._drain_device_emits()
        self.selector.restore(state["selector"])
        if "rate_limiter" in state:
            self.rate_limiter.restore(state["rate_limiter"])
        for key, ws in state.get("windows", {}).items():
            ci, pi = (int(x) for x in key.split("."))
            self.chains[ci][pi].window.restore(ws)
        if self.join_runtime is not None:
            jw = state.get("join_windows", {})
            for label, side in (("left", self.join_runtime.left),
                                ("right", self.join_runtime.right)):
                if label in jw and side.window is not None:
                    side.window.restore(jw[label])
        if self.pattern_processor is not None and "pattern" in state:
            self.pattern_processor.restore(state["pattern"])
        if self.device_runtime is not None and "device" in state:
            self.device_runtime.restore(state["device"])

    def on_time(self, now: int):
        """Scheduler tick: run time-window evictions through the tail of
        the chain."""
        for chain in self.chains:
            for pi, p in enumerate(chain):
                if isinstance(p, WindowChainProcessor):
                    out = p.window.on_time(now)
                    if out is not None and len(out):
                        b = out
                        for q in chain[pi + 1:]:
                            b = q.process(b, now)
                            if len(b) == 0:
                                break
                        else:
                            sel = self.selector.process(b, now)
                            sel = self.rate_limiter.process(sel, now)
                            if sel is not None and len(sel):
                                self.output.send(sel, now)
