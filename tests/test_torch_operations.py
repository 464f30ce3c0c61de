"""The port's operations layer held against the JAX package's.

The JAX package's tests of the operations layer run through both
packages by ``test_torch_persistence.py``'s twin runs: once as they
are, once with the names they took rebound to the port's
(``SiddhiManager`` is ``SiddhiManager(device="cpu")``, the service's
manager too), and the modules a test imports inside its body standing
for the port's while it runs.  Both runs must pass the test's own
assertions and deliver the same events.  The files:

- ``tests/test_faults.py``: the injector, drain retries and their
  exhaustion, sticky device loss, callback and sink faults, clock
  stalls, the NaN/Inf quarantine, the counters on the statistics and
  REST feeds, the journal;
- ``tests/test_overload.py``: admission (``drop``, ``oldest``,
  ``block``), the watchdog's self-heal, circuit breakers, the
  degradation ladder, the health endpoint;
- ``tests/test_replan.py``: live re-plans under pins (baseline and
  fused, dense and hot-key), under transient faults and across the
  ``replan.reseat`` crash point, the refusal without a journal, the
  REST plan dump and forced re-plan;
- ``tests/test_statistics_playback.py``, ``test_observability.py``,
  ``test_debugger.py``.

The sharded cases (``devices=``, a ``shard`` pin) and the plan
monitor's switch run too.  ``LEFT_OUT`` names the case the port's
ladder does not take.  The port's own points (the poison restore, the retried put, the ladder's
single ``fuse`` rung, the refusals) are in ``test_torch_ops_port.py``,
which imports no JAX, so its card cases run on the card.
"""

from __future__ import annotations

import re
import types

import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu import service as jax_service
from siddhi_tpu_torch import service as port_service
from test_torch_device_query import one_torch_thread  # noqa: F401
from test_torch_done_slices import INNER, stand_ins as root_stand_ins
from test_torch_persistence import Record, cases, check_twin
from test_torch_transport import _FaultRuntime

pytestmark = pytest.mark.faults

INNER_OPS = INNER + ("siddhi_tpu.util.persistence", "siddhi_tpu.robustness",
                     "siddhi_tpu.transport.broker", "siddhi_tpu.util.faults",
                     "siddhi_tpu.observability", "siddhi_tpu.debugger",
                     "siddhi_tpu.ops.device_query",
                     "siddhi_tpu.parallel.device_shard")

LEFT_OUT = {
    "test_overload": {
        ("TestDegradationLadder",
         "test_apply_degradation_demotes_in_documented_order"):
            "the port's ladder has only the fuse rung (ROADMAP.md §3 pin "
            "15; test_torch_ops_port.py holds its order)",
    },
    "test_replan": {
    },
}
CORPORA = ("test_faults", "test_overload", "test_replan",
           "test_statistics_playback", "test_observability",
           "test_debugger")
CASES = [c for corpus in CORPORA
         for c in cases(corpus, LEFT_OUT.get(corpus, {}))]


def _service_class(port):
    """The package's ``SiddhiService`` over its own manager (the port's
    on the CPU).  Not a recording one: a test holds the runtimes the
    service's manager registers (``get_siddhi_app_runtime(...) is
    rt``), and the tests that deploy through it add no callback."""
    if port:
        make = lambda: siddhi_tpu_torch.SiddhiManager(device="cpu")  # noqa
        cls = port_service.SiddhiService
    else:
        make = siddhi_tpu.SiddhiManager
        cls = jax_service.SiddhiService

    def service(manager=None, **kw):
        return cls(manager=manager or make(), **kw)

    return service


def stand_ins(rec, port):
    """``siddhi_tpu`` (the run's package, with the recording manager) and
    ``siddhi_tpu.service`` while a test runs."""
    out = root_stand_ins(rec, port)
    svc = types.ModuleType("siddhi_tpu.service")
    svc.SiddhiService = _service_class(port)
    out["siddhi_tpu.service"] = svc
    return out


class _Apps(list):
    """App strings with their ``dir=`` option dropped: each run writes
    its flight-recorder dumps into its own ``tmp_path`` directory."""

    def append(self, app):
        super().append(re.sub(r"dir='[^']*'", "dir=''", app)
                       if isinstance(app, str) else app)


class OpsRecord(Record):
    """Stream callbacks recorded with ``_error`` values by type name and
    message (each package raises its own exceptions)."""

    runtime_class = _FaultRuntime

    def __init__(self):
        super().__init__()
        self.apps = _Apps()


def rebind(mod, rec, port):
    """A module that imported ``SiddhiService`` at its top gets the
    run's package's."""
    if hasattr(mod, "SiddhiService"):
        mod.SiddhiService = _service_class(port)


def test_the_corpora_were_read():
    counts = {}
    for p in CASES:
        counts[p.values[0]] = counts.get(p.values[0], 0) + 1
    assert counts == {"test_faults": 30, "test_overload": 32,
                      "test_replan": 9, "test_statistics_playback": 4,
                      "test_observability": 24, "test_debugger": 5}


@pytest.mark.parametrize("corpus,cname,mname,k", CASES)
def test_operations_corpus_as_the_reference(corpus, cname, mname, k,
                                            tmp_path, request):
    check_twin(corpus, cname, mname, k, tmp_path, request, inner=INNER_OPS,
               stand_ins=stand_ins, rebind=rebind, record=OpsRecord)
