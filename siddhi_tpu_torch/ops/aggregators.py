"""Attribute aggregator executors: port of the JAX package's
``ops/aggregators.py`` (reference:
query/selector/attribute/aggregator/*AttributeAggregatorExecutor.java).

Per-group incremental aggregators with vectorized run processing: a "run"
is a maximal slice of same-type events for one group; ``add_run`` returns
the running aggregate value AFTER each row (Siddhi emits one output event
per input event carrying the aggregate-so-far), ``remove_run`` handles
EXPIRED events (window evictions), ``reset`` handles RESET markers from
batch windows.
"""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.query_api import AttrType


class AggExecutor:
    """One instance per (query select-item); state is per group key."""

    return_type: AttrType = AttrType.DOUBLE

    def new_state(self) -> dict:
        raise NotImplementedError

    def add_run(self, state: dict, values: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def remove_run(self, state: dict, values: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def reset(self, state: dict):
        new = self.new_state()
        state.clear()
        state.update(new)


class SumAgg(AggExecutor):
    """sum() — returns LONG for int/long inputs, DOUBLE for float/double
    (reference: SumAttributeAggregatorExecutor)."""

    def __init__(self, arg_type: AttrType):
        if arg_type in (AttrType.INT, AttrType.LONG):
            self.return_type = AttrType.LONG
            self._dtype = np.int64
        else:
            self.return_type = AttrType.DOUBLE
            self._dtype = np.float64

    def new_state(self):
        return {"sum": self._dtype(0), "n": 0}

    def add_run(self, state, values):
        out = state["sum"] + np.cumsum(values.astype(self._dtype))
        state["sum"] = out[-1] if len(out) else state["sum"]
        state["n"] += len(values)
        return out

    def remove_run(self, state, values):
        out = state["sum"] - np.cumsum(values.astype(self._dtype))
        state["sum"] = out[-1] if len(out) else state["sum"]
        state["n"] -= len(values)
        return out


class CountAgg(AggExecutor):
    return_type = AttrType.LONG

    def new_state(self):
        return {"n": np.int64(0)}

    def add_run(self, state, values):
        n = len(values)
        out = state["n"] + np.arange(1, n + 1, dtype=np.int64)
        state["n"] = state["n"] + n
        return out

    def remove_run(self, state, values):
        n = len(values)
        out = state["n"] - np.arange(1, n + 1, dtype=np.int64)
        state["n"] = state["n"] - n
        return out


class AvgAgg(AggExecutor):
    return_type = AttrType.DOUBLE

    def new_state(self):
        return {"sum": np.float64(0), "n": np.int64(0)}

    def _emit(self, sums, counts):
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(counts > 0, sums / counts, np.nan)

    def add_run(self, state, values):
        sums = state["sum"] + np.cumsum(values.astype(np.float64))
        counts = state["n"] + np.arange(1, len(values) + 1, dtype=np.int64)
        if len(values):
            state["sum"], state["n"] = sums[-1], counts[-1]
        return self._emit(sums, counts)

    def remove_run(self, state, values):
        sums = state["sum"] - np.cumsum(values.astype(np.float64))
        counts = state["n"] - np.arange(1, len(values) + 1, dtype=np.int64)
        if len(values):
            state["sum"], state["n"] = sums[-1], counts[-1]
        return self._emit(sums, counts)


class StdDevAgg(AggExecutor):
    """Population stddev (reference: StdDevAttributeAggregatorExecutor)."""

    return_type = AttrType.DOUBLE

    def new_state(self):
        return {"s1": np.float64(0), "s2": np.float64(0), "n": np.int64(0)}

    def _emit(self, s1, s2, n):
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = s1 / n
            var = s2 / n - mean * mean
            return np.where(n > 0, np.sqrt(np.maximum(var, 0.0)), np.nan)

    def add_run(self, state, values):
        v = values.astype(np.float64)
        s1 = state["s1"] + np.cumsum(v)
        s2 = state["s2"] + np.cumsum(v * v)
        n = state["n"] + np.arange(1, len(v) + 1, dtype=np.int64)
        if len(v):
            state["s1"], state["s2"], state["n"] = s1[-1], s2[-1], n[-1]
        return self._emit(s1, s2, n)

    def remove_run(self, state, values):
        v = values.astype(np.float64)
        s1 = state["s1"] - np.cumsum(v)
        s2 = state["s2"] - np.cumsum(v * v)
        n = state["n"] - np.arange(1, len(v) + 1, dtype=np.int64)
        if len(v):
            state["s1"], state["s2"], state["n"] = s1[-1], s2[-1], n[-1]
        return self._emit(s1, s2, n)


class _HeapMinMax(AggExecutor):
    """min()/max() with expiry support via lazy-deletion heap
    (the reference keeps a LinkedList scan; a heap is O(log n))."""

    def __init__(self, arg_type: AttrType, is_max: bool):
        self.return_type = arg_type
        self.is_max = is_max

    def new_state(self):
        return {"heap": [], "dead": {}, "size": 0}

    def _sign(self, v):
        return -v if self.is_max else v

    def _top(self, state):
        heap, dead = state["heap"], state["dead"]
        while heap:
            v = heap[0]
            if dead.get(v, 0) > 0:
                heapq.heappop(heap)
                dead[v] -= 1
                if dead[v] == 0:
                    del dead[v]
            else:
                return -v if self.is_max else v
        return None

    def add_run(self, state, values):
        out = np.empty(len(values), dtype=np.float64)
        for i, v in enumerate(values):
            heapq.heappush(state["heap"], self._sign(float(v)))
            state["size"] += 1
            out[i] = self._top(state)
        return self._cast(out)

    def remove_run(self, state, values):
        out = np.empty(len(values), dtype=np.float64)
        for i, v in enumerate(values):
            sv = self._sign(float(v))
            state["dead"][sv] = state["dead"].get(sv, 0) + 1
            state["size"] -= 1
            top = self._top(state)
            out[i] = np.nan if top is None else top
        return self._cast(out)

    def _cast(self, out):
        if self.return_type in (AttrType.INT, AttrType.LONG) and not np.isnan(out).any():
            return out.astype(AttrType(self.return_type).np_dtype)
        return out


class MinMaxForeverAgg(AggExecutor):
    """minForever()/maxForever() — never expire
    (reference: MinForeverAttributeAggregatorExecutor)."""

    def __init__(self, arg_type: AttrType, is_max: bool):
        self.return_type = arg_type
        self.is_max = is_max

    def new_state(self):
        return {"v": None}

    def add_run(self, state, values):
        v = values.astype(np.float64)
        acc = np.maximum.accumulate(v) if self.is_max else np.minimum.accumulate(v)
        if state["v"] is not None:
            acc = np.maximum(acc, state["v"]) if self.is_max else np.minimum(acc, state["v"])
        if len(acc):
            state["v"] = acc[-1]
        return acc

    def remove_run(self, state, values):
        n = len(values)
        cur = np.nan if state["v"] is None else state["v"]
        return np.full(n, cur, dtype=np.float64)

    def reset(self, state: dict):
        # forever values survive window RESETs: the reference's reset()
        # returns the current value WITHOUT clearing state
        # (MinForeverAttributeAggregatorExecutor.java:179-181)
        pass


class DistinctCountAgg(AggExecutor):
    return_type = AttrType.LONG

    def new_state(self):
        return {"counts": {}}

    def add_run(self, state, values):
        counts = state["counts"]
        out = np.empty(len(values), dtype=np.int64)
        for i, v in enumerate(values):
            key = v.item() if isinstance(v, np.generic) else v
            counts[key] = counts.get(key, 0) + 1
            out[i] = len(counts)
        return out

    def remove_run(self, state, values):
        counts = state["counts"]
        out = np.empty(len(values), dtype=np.int64)
        for i, v in enumerate(values):
            key = v.item() if isinstance(v, np.generic) else v
            c = counts.get(key, 0) - 1
            if c <= 0:
                counts.pop(key, None)
            else:
                counts[key] = c
            out[i] = len(counts)
        return out


class BoolAndAgg(AggExecutor):
    """and() over bools (reference: AndAttributeAggregatorExecutor)."""

    return_type = AttrType.BOOL

    def new_state(self):
        return {"true": 0, "false": 0}

    def _emit_scalar(self, state):
        return state["false"] == 0

    def add_run(self, state, values):
        out = np.empty(len(values), dtype=bool)
        for i, v in enumerate(values):
            state["true" if v else "false"] += 1
            out[i] = self._emit_scalar(state)
        return out

    def remove_run(self, state, values):
        out = np.empty(len(values), dtype=bool)
        for i, v in enumerate(values):
            state["true" if v else "false"] -= 1
            out[i] = self._emit_scalar(state)
        return out


class BoolOrAgg(BoolAndAgg):
    def _emit_scalar(self, state):
        return state["true"] > 0


class UnionSetAgg(AggExecutor):
    """unionSet() — accumulates a set of values
    (reference: UnionSetAttributeAggregatorExecutor)."""

    return_type = AttrType.OBJECT

    def new_state(self):
        return {"counts": {}}

    def add_run(self, state, values):
        counts = state["counts"]
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            key = v.item() if isinstance(v, np.generic) else v
            counts[key] = counts.get(key, 0) + 1
            out[i] = set(counts)
        return out

    def remove_run(self, state, values):
        counts = state["counts"]
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            key = v.item() if isinstance(v, np.generic) else v
            c = counts.get(key, 0) - 1
            if c <= 0:
                counts.pop(key, None)
            else:
                counts[key] = c
            out[i] = set(counts)
        return out


def make_aggregator(name: str, arg_type: Optional[AttrType]) -> AggExecutor:
    if name == "sum":
        return SumAgg(arg_type or AttrType.DOUBLE)
    if name == "count":
        return CountAgg()
    if name == "avg":
        return AvgAgg()
    if name == "stdDev":
        return StdDevAgg()
    if name == "min":
        return _HeapMinMax(arg_type or AttrType.DOUBLE, is_max=False)
    if name == "max":
        return _HeapMinMax(arg_type or AttrType.DOUBLE, is_max=True)
    if name == "minForever":
        return MinMaxForeverAgg(arg_type or AttrType.DOUBLE, is_max=False)
    if name == "maxForever":
        return MinMaxForeverAgg(arg_type or AttrType.DOUBLE, is_max=True)
    if name == "distinctCount":
        return DistinctCountAgg()
    if name == "and":
        return BoolAndAgg()
    if name == "or":
        return BoolOrAgg()
    if name == "unionSet":
        return UnionSetAgg()
    raise SiddhiAppCreationError(f"unknown aggregator '{name}'")
