"""Builtin stream functions (port of the JAX package's
``ops/stream_functions.py``): the reference core ships exactly two —
`#pol2Cart(theta, rho[, z])` (Pol2CartStreamFunctionProcessor.java:149,
appends cartesian x/y[/z] columns) and `#log(...)`
(LogStreamProcessor.java, passthrough event logging).

A stream-function object takes ``(compiled_args, attribute_names)``,
exposes optional ``output_attributes`` (appended to the flowing stream
schema by the planner) and ``process(batch, now) -> batch`` which must
add those columns.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np

from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.core.query import build_env
from siddhi_tpu_torch.extension.registry import extension
from siddhi_tpu_torch.extension.validator import Param
from siddhi_tpu_torch.query_api import Attribute, AttrType

log = logging.getLogger("siddhi_tpu_torch")

_NUM = (AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE)


@extension("stream_function", "pol2Cart")
class Pol2CartStreamFunction:
    """Appends x/y (and passes z through) computed from polar inputs:
    x = rho*cos(radians(theta)), y = rho*sin(radians(theta))."""

    PARAMETERS = (Param("theta", _NUM), Param("rho", _NUM),
                  Param("z", _NUM))
    OVERLOADS = (("theta", "rho"), ("theta", "rho", "z"))

    def __init__(self, args, attribute_names):
        if len(args) not in (2, 3):
            raise SiddhiAppCreationError(
                "#pol2Cart() takes (theta, rho) or (theta, rho, z)")
        self.args = args
        self.output_attributes: List[Attribute] = [
            Attribute("x", AttrType.DOUBLE),
            Attribute("y", AttrType.DOUBLE),
        ]
        if len(args) == 3:
            self.output_attributes.append(Attribute("z", AttrType.DOUBLE))

    def process(self, batch, now):
        env = build_env(batch)
        n = len(batch)
        theta = np.broadcast_to(
            np.asarray(self.args[0].fn(env), dtype=np.float64), (n,))
        rho = np.broadcast_to(
            np.asarray(self.args[1].fn(env), dtype=np.float64), (n,))
        rad = np.radians(theta)
        # a NEW batch: the junction hands the SAME EventBatch to every
        # receiver, so mutating columns/names in place would leak the
        # appended schema into sibling queries
        cols = dict(batch.columns)
        cols["x"] = rho * np.cos(rad)
        cols["y"] = rho * np.sin(rad)
        if len(self.args) == 3:
            cols["z"] = np.broadcast_to(
                np.asarray(self.args[2].fn(env), dtype=np.float64),
                (n,)).copy()
        names = list(batch.attribute_names) + [
            a.name for a in self.output_attributes
            if a.name not in batch.attribute_names]
        out = EventBatch(batch.stream_id, names, cols,
                         batch.timestamps, batch.types)
        out.aux.update(batch.aux)
        return out


@extension("stream_function", "log")
class LogStreamFunction:
    """Passthrough event logging (reference LogStreamProcessor):
    `#log()`, `#log('message')`, `#log('priority', 'message')`."""

    PARAMETERS = (Param("priority", (AttrType.STRING,)),
                  Param("log.message", (AttrType.STRING,)),
                  Param("is.event.logged", (AttrType.BOOL,)))
    OVERLOADS = ((), ("log.message",),
                 ("priority", "log.message"),
                 ("priority", "log.message", "is.event.logged"))

    _LEVELS = {"info": logging.INFO, "debug": logging.DEBUG,
               "warn": logging.WARNING, "error": logging.ERROR,
               "trace": logging.DEBUG, "fatal": logging.CRITICAL}

    def __init__(self, args, attribute_names):
        self.args = args
        self.attribute_names = attribute_names

    def process(self, batch, now):
        env = build_env(batch)
        vals = []
        for a in self.args:
            v = np.asarray(a.fn(env)).reshape(-1)
            vals.append(str(v[0]) if len(v) else "")
        level = logging.INFO
        message = ""
        log_events = True
        if len(vals) == 1:
            message = vals[0]
        elif len(vals) >= 2:
            level = self._LEVELS.get(vals[0].lower(), logging.INFO)
            message = vals[1]
            if len(vals) >= 3:
                log_events = vals[2].lower() == "true"
        if log.isEnabledFor(level):  # row dump is O(rows x cols): lazy
            if log_events:
                rows = [
                    [batch.columns[nm][i] for nm in batch.attribute_names]
                    for i in range(len(batch))
                ]
                log.log(level, "%s : %d events: %s",
                        message or batch.stream_id, len(batch), rows)
            else:
                log.log(level, "%s : %d events",
                        message or batch.stream_id, len(batch))
        return batch
