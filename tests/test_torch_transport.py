"""The port's sources, sinks and fault streams held against the JAX
package's.

``tests/test_transport.py``, ``test_conformance_transport.py``,
``test_conformance_onerror.py`` and ``test_config.py`` replayed through
both packages by ``test_torch_persistence.py``'s twin runs: in-memory
sources and sinks over the broker, the pass-through and JSON mappers,
round-robin, partitioned and broadcast distribution (with an endpoint
failing over), dynamic ``{{attr}}`` options, a failing sink's drop and
reconnect, a failing source's retry, the source and sink handler
managers, ``ref=`` configs, and ``@OnError(action='STREAM')``: a failing
query's batch and a sink's failed publish routed to ``!S`` with their
``_error``.  Both packages pass each test's own assertions and deliver
the same events.  Then the same routes on the device query path, where a
failing batch routes as on the host.
"""

from __future__ import annotations

import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core.event import Event as JaxEvent
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.event import Event
from test_torch_device_query import one_torch_thread  # noqa: F401
from test_torch_persistence import (
    INNER_IMPORTS,
    Record,
    _Runtime,
    cases,
    check_twin,
)

# the modules a test imports inside its body: the port's stand for them
INNER = INNER_IMPORTS + (
    "siddhi_tpu.transport.broker", "siddhi_tpu.transport.handler",
    "siddhi_tpu.transport.sink", "siddhi_tpu.transport.source",
    "siddhi_tpu.core.event", "siddhi_tpu.table", "siddhi_tpu.table.record")
CORPORA = ("test_transport", "test_conformance_transport",
           "test_conformance_onerror", "test_config")
CASES = [c for corpus in CORPORA for c in cases(corpus, {})]


def test_the_corpora_were_read():
    counts = {}
    for p in CASES:
        counts[p.values[0]] = counts.get(p.values[0], 0) + 1
    assert counts == {"test_transport": 11, "test_conformance_transport": 9,
                      "test_conformance_onerror": 7, "test_config": 5}


def _value(v):
    """An ``_error`` value as ``(type name, message)``: exceptions compare
    by identity, and each package raises its own."""
    return (type(v).__name__, str(v)) if isinstance(v, BaseException) else v


class _FaultRuntime(_Runtime):
    """A runtime whose stream callbacks record ``_error`` values by type
    name and message."""

    def add_callback(self, target, cb):
        if target not in self._rt.junctions:
            return super().add_callback(target, cb)
        self._rt.add_callback(target, cb)
        got = self._rec.got.setdefault(target, [])
        self._rt.add_callback(target, lambda evs: got.extend(
            (e.timestamp, e.is_expired, tuple(_value(v) for v in e.data))
            for e in evs))


class FaultRecord(Record):
    runtime_class = _FaultRuntime


@pytest.mark.parametrize("corpus,cname,mname,k", CASES)
def test_transport_corpus_as_the_reference(corpus, cname, mname, k,
                                           tmp_path, request):
    check_twin(corpus, cname, mname, k, tmp_path, request, inner=INNER,
               record=FaultRecord)


# -- the device query path ------------------------------------------------------

DEVICE_ONERROR = (
    "@app:playback @app:execution('tpu', partitions='8') "
    "@OnError(action='STREAM') define stream S (k long, v double); "
    "@info(name='q') from S#window.lengthBatch(6) "
    "select k, sum(v) as s group by k insert into Out; "
    "@info(name='qf') from !S select k, v, _error insert into F;")


def _device_onerror(port):
    """Sends whose new keys overflow the engine's 8 group rows: those
    batches fail on the device query path and go to ``!S``."""
    m = SiddhiManager(device="cpu") if port else JaxManager()
    try:
        rt = m.create_siddhi_app_runtime(DEVICE_ONERROR)
        got, faults = [], []
        rt.add_callback("Out", lambda evs: got.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        rt.add_callback("F", lambda evs: faults.extend(
            (e.timestamp, e.data[0], e.data[1], type(e.data[2]).__name__)
            for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        rng = np.random.default_rng(3)
        for i in range(12):
            # every fourth send carries a burst of fresh keys
            keys = ([100 * i + j for j in range(5)] if i % 4 == 3
                    else list(rng.integers(0, 4, 3)))
            h.send([(Event if port else JaxEvent)(
                1000 + 10 * i + j, [int(k), float(rng.integers(1, 9))])
                for j, k in enumerate(keys)])
        low = rt.lowering()
        rt.shutdown()
        return got, faults, low
    finally:
        m.shutdown()


def test_device_path_failing_batch_routes_to_the_fault_stream():
    """A device query whose batch fails (the group rows overflow) routes
    that batch to ``!S`` as the host path would: the same fault rows,
    the same windows over the batches that passed, in both packages."""
    jax = _device_onerror(False)
    port = _device_onerror(True)
    assert port[2] == jax[2] == {"q": "device", "qf": "device"}
    assert port[0] == jax[0] and port[0]
    assert port[1] == jax[1] and port[1]
    assert {f[3] for f in port[1]} == {"SiddhiAppRuntimeError"}
