"""The one general traffic generator: batch ``i`` of a mix, from the seed.

A mix is a data file ``traffic/<mix>.json``::

    {"stream": "Txn", "batch": 131072, "warmup_batches": 3,
     "time": {"start_ms": 1000, "ms_per_batch": 64},
     "columns": [{"name": "key", "kind": "stride", ...}, ...]}

``time`` takes ``ms_per_batch`` (every event of a batch at one time) or
``events_per_ms`` (times rising through the batch); either way each
batch owns its own span of timestamps, so an output row's time names
the batch it came from (``batch_of_ts``).

Column kinds:

- ``stride``: ``(j * stride + i * batch + offset) % modulo`` for row
  ``j`` (distinct within a batch when ``stride`` is prime to
  ``modulo``); ``offset`` is drawn from the seed;
- ``uniform_int``: uniform integers on ``[low, high)``;
- ``uniform``: uniform floats on ``[low, high)``, cast to ``dtype``;
- ``symbol``: ``prefix + str(id)``, ids uniform on ``[0, n)``; with
  ``cover_warmup`` the warm-up batches first carry every id once;
- ``event_time``: the rows' timestamps.

Batch ``i`` draws from ``SeedSequence([seed, i])`` and from what the
run drew once at its start from the seed (offsets, the warm-up's
cover), so any batch can be made again after the window (the
reference's input) without keeping the window's batches.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_DTYPES = {"int32": np.int32, "int64": np.int64, "float32": np.float32,
           "float64": np.float64}


class Traffic:
    """Batches of one mix under one seed."""

    def __init__(self, spec: dict, seed: int):
        self.spec = spec
        self.seed = int(seed)
        self.stream = spec["stream"]
        self.B = int(spec["batch"])
        self.warmup = int(spec.get("warmup_batches", 0))
        t = spec["time"]
        self.start_ms = int(t["start_ms"])
        if "ms_per_batch" in t:
            self.span_ms = int(t["ms_per_batch"])
            self.epm = None
        else:
            self.epm = int(t["events_per_ms"])
            if self.B % self.epm:
                raise ValueError("batch must be a multiple of events_per_ms")
            self.span_ms = self.B // self.epm
        self.columns = spec["columns"]
        self.names = [c["name"] for c in self.columns]
        head = np.random.default_rng([self.seed, 2**32 - 1])
        self._offset = {}
        self._symbols = {}
        self._cover = {}
        for c in self.columns:
            kind = c["kind"]
            if kind == "stride":
                self._offset[c["name"]] = int(head.integers(0, c["modulo"]))
                self._base = (np.arange(self.B, dtype=np.int64)
                              * int(c["stride"])) % int(c["modulo"])
            elif kind == "symbol":
                n = int(c["n"])
                self._symbols[c["name"]] = np.array(
                    [f"{c['prefix']}{k}" for k in range(n)], dtype=object)
                if c.get("cover_warmup"):
                    self._cover[c["name"]] = head.permutation(n)
        for name, perm in self._cover.items():
            need = -(-len(perm) // self.B)
            if need > self.warmup:
                raise ValueError(f"{name}: covering every id takes {need} "
                                 f"warm-up batches, the mix has "
                                 f"{self.warmup}")

    # -- one batch -----------------------------------------------------------

    def timestamps(self, i: int) -> np.ndarray:
        if self.epm is None:
            return np.full(self.B, self.start_ms + i * self.span_ms,
                           dtype=np.int64)
        return (self.start_ms
                + (i * self.B + np.arange(self.B, dtype=np.int64))
                // self.epm)

    def batch(self, i: int, extras: bool = False):
        """``(columns, timestamps)`` of batch ``i``; with ``extras`` also
        ``{"ids": {name: ids}}``: the integer ids behind each ``symbol``
        column."""
        rng = np.random.default_rng([self.seed, int(i)])
        ts = self.timestamps(i)
        cols: Dict[str, np.ndarray] = {}
        ids: Dict[str, np.ndarray] = {}
        for c in self.columns:
            name, kind = c["name"], c["kind"]
            if kind == "stride":
                mod = int(c["modulo"])
                k = self._base + (i * self.B + self._offset[name]) % mod
                np.subtract(k, mod, out=k, where=k >= mod)
                cols[name] = k
            elif kind == "uniform_int":
                cols[name] = rng.integers(c["low"], c["high"], self.B).astype(
                    _DTYPES[c.get("dtype", "int64")])
            elif kind == "uniform":
                cols[name] = rng.uniform(c["low"], c["high"], self.B).astype(
                    _DTYPES[c.get("dtype", "float64")])
            elif kind == "symbol":
                sid = rng.integers(0, int(c["n"]), self.B)
                cover = self._cover.get(name)
                if cover is not None and i * self.B < len(cover):
                    part = cover[i * self.B:(i + 1) * self.B]
                    sid[:len(part)] = part
                cols[name] = self._symbols[name][sid]
                ids[name] = sid
            elif kind == "event_time":
                cols[name] = ts.copy()
            else:
                raise ValueError(f"unknown column kind {kind!r}")
        if extras:
            return cols, ts, {"ids": ids}
        return cols, ts

    def batch_of_ts(self, ts: np.ndarray) -> np.ndarray:
        """The batch index whose span holds each timestamp."""
        return (np.asarray(ts, dtype=np.int64) - self.start_ms) // self.span_ms

    def symbols(self, name: str) -> np.ndarray:
        """The names of the ``symbol`` column ``name``, by id."""
        return self._symbols[name]

    def key_space(self, name: str) -> int:
        """How many distinct values the key column ``name`` can take."""
        c = next(c for c in self.columns if c["name"] == name)
        if c["kind"] == "stride":
            return int(c["modulo"])
        if c["kind"] == "uniform_int":
            return int(c["high"]) - int(c["low"])
        if c["kind"] == "symbol":
            return int(c["n"])
        raise ValueError(f"{name}: not a key column")


def merge(base: dict, over: Optional[dict]) -> dict:
    """``base`` with ``over`` merged in, dicts key by key and lists of
    named columns name by name (a test's small sizes)."""
    if not over:
        return base
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        elif (k == "columns" and isinstance(v, dict)
              and isinstance(out.get(k), list)):
            out[k] = [merge(c, v.get(c["name"])) for c in out[k]]
        else:
            out[k] = v
    return out
