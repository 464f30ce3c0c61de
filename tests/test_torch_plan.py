"""The cost model's own choice and the plan monitor held against the
JAX package's.

``tests/test_planner_costmodel.py`` runs twice a case, by
``test_torch_persistence.py``'s twin runs: once as it is, once with the
JAX names it took rebound to the port's (``SiddhiManager`` is
``SiddhiManager(device="cpu")``; the ``costmodel`` module it holds as
``cm`` is the port's, as ``PlanMonitor`` is).  Both runs must pass the
test's own assertions and deliver the same events: ``@app:plan(auto=
'true')`` reaching the lowering the annotations pin on the fuse,
multiplex, shard and hot-key shapes, the fuse+shard composition bit for
bit against the single-device fused chain, the counted rejections and
conflicts, and ``PlanMonitor.decide`` on observed batch widths.
"""

from __future__ import annotations

import pytest

import siddhi_tpu_torch.planner.costmodel as port_costmodel
from test_torch_device_query import one_torch_thread  # noqa: F401
from test_torch_persistence import INNER_IMPORTS, cases, check_twin

pytestmark = pytest.mark.faults

CASES = cases("test_planner_costmodel", {})


def rebind(mod, rec, port):
    if port:
        mod.cm = port_costmodel


def test_the_corpus_was_read():
    assert len(CASES) == 14


@pytest.mark.parametrize("corpus,cname,mname,k", CASES)
def test_plan_corpus_as_the_reference(corpus, cname, mname, k, tmp_path,
                                      request):
    check_twin(corpus, cname, mname, k, tmp_path, request,
               inner=INNER_IMPORTS, rebind=rebind)
