"""The port's REST service held against the JAX package's.

``tests/test_service.py`` runs through both packages by
``test_torch_persistence.py``'s twin runs, each package's
``SiddhiService`` over its own manager (the port's on the CPU), on
localhost at port 0: deploy and undeploy, the app list, conflicts, bad
apps, the lowering endpoint, the lowering on the statistics feed.  The
service's other routes (``test_faults.py``, ``test_overload.py``,
``test_observability.py``, ``test_replan.py``, ``test_durability.py``
use them) are replayed in ``test_torch_operations.py`` and
``test_torch_durability.py``.  Then the routes one app string at a time
through both services: the health endpoint (200, then 503 while
shedding), ``/metrics``, and ``/siddhi-plan`` in legacy mode and, after
a forced re-plan, in pinned mode.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu import service as jax_service
from siddhi_tpu_torch import service as port_service
from test_torch_device_query import one_torch_thread  # noqa: F401
from test_torch_operations import INNER_OPS, OpsRecord, rebind, stand_ins
from test_torch_persistence import cases, check_twin

CASES = cases("test_service", {})


def test_the_corpus_was_read():
    assert len(CASES) == 8


@pytest.mark.parametrize("corpus,cname,mname,k", CASES)
def test_service_corpus_as_the_reference(corpus, cname, mname, k, tmp_path,
                                         request):
    check_twin(corpus, cname, mname, k, tmp_path, request, inner=INNER_OPS,
               stand_ins=stand_ins, rebind=rebind, record=OpsRecord)


def _services():
    """Each package's service on localhost, port 0."""
    return (jax_service.SiddhiService(manager=siddhi_tpu.SiddhiManager()),
            port_service.SiddhiService(
                manager=siddhi_tpu_torch.SiddhiManager(device="cpu")))


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _deploy(base, app):
    req = urllib.request.Request(f"{base}/siddhi-artifact-deploy",
                                 data=app.encode(), method="POST")
    with urllib.request.urlopen(req) as r:
        return r.status


HEALTH_APP = ("@app:name('hsvc') @app:playback "
              "@app:limits(rate='4/s', burst='4', shed='drop') "
              "define stream S (k long, v double); "
              "@info(name='q') from S[v > 0.0] select k, v insert into Out;")


def test_health_and_metrics_routes_as_the_reference():
    """The health route answers 200, then 503 with the same counters
    once the app sheds, in both services; ``/metrics`` serves a page
    with the app's shed counter in both."""
    out = []
    for svc in _services():
        svc.start()
        try:
            base = f"http://127.0.0.1:{svc.port}"
            assert _deploy(base, HEALTH_APP) == 200
            code0, _, body0 = _get(f"{base}/siddhi-health/hsvc")
            rt = svc.get_runtime("hsvc")
            h = rt.get_input_handler("S")
            for i in range(10):
                h.send([i, 1.0], timestamp=1_000_000 + i)
            code1, _, body1 = _get(f"{base}/siddhi-health/hsvc")
            mcode, ctype, page = _get(f"{base}/metrics")
            ghost = _get(f"{base}/siddhi-health/ghost")[0]
        finally:
            svc.stop()
        doc1 = json.loads(body1)
        shed_lines = [ln for ln in page.decode().splitlines()
                      if "events_shed" in ln and not ln.startswith("#")]
        out.append((code0, json.loads(body0)["healthy"], code1,
                    doc1["status"], doc1["counters"]["events_shed"],
                    doc1["counters"]["events_admitted"], mcode, ctype,
                    shed_lines, ghost))
    assert out[0] == out[1]
    assert out[1][:6] == (200, True, 503, "UNHEALTHY", 6, 4)


PLAN_APP = ("@app:name('psvc') @app:playback @app:execution('tpu') "
            "@app:faults(journal='1024') "
            "define stream SIn (sym int, price float, vol int); "
            "@info(name='q1') from SIn[price > 10.0] "
            "select sym, price, vol insert into Mid; "
            "@info(name='q2') from Mid[vol > 50] select sym, price "
            "insert into Out;")


def test_plan_route_legacy_then_pinned_as_the_reference():
    """``/siddhi-plan`` gives the same record in both services: legacy
    mode with the host and device candidates and the realized lowering;
    after ``/siddhi-replan?q1=fuse&q2=fuse`` pinned mode, the fused
    lowering and the switch in the history.  With no mesh declared
    neither lists a sharded candidate, and a pin naming ``shard``
    re-plans alike in both."""
    out = []
    for svc in _services():
        svc.start()
        try:
            base = f"http://127.0.0.1:{svc.port}"
            assert _deploy(base, PLAN_APP) == 200
            rt = svc.get_runtime("psvc")
            h = rt.get_input_handler("SIn")
            for i in range(20):
                h.send([i % 3, float(i * 2), 40 + i], timestamp=1000 + i)
            p0 = json.loads(_get(f"{base}/siddhi-plan/psvc")[2])
            r = json.loads(_get(f"{base}/siddhi-replan/psvc?q1=fuse&q2=fuse")
                           [2])
            p1 = json.loads(_get(f"{base}/siddhi-plan/psvc")[2])
            shard = _get(f"{base}/siddhi-replan/psvc?q1=device%2Bshard")
        finally:
            svc.stop()
        out.append((p0, r, p1, shard))
    (j0, jr, j1, jshard), (p0, pr, p1, pshard) = out
    for jp, pp in ((j0, p0), (j1, p1)):
        assert pp["lowering"] == jp["lowering"]
        assert set(pp["plans"]) == set(jp["plans"]) == {"q1", "q2"}
        for q in ("q1", "q2"):
            jrec, prec = jp["plans"][q], pp["plans"][q]
            for key in ("mode", "chosen", "pinned", "actual"):
                assert prec[key] == jrec[key], (q, key)
            feasible = {c["path"] for c in prec["candidates"]
                        if c["feasible"]}
            assert feasible == {c["path"] for c in jrec["candidates"]
                                if c["feasible"]}
    assert p0["plans"]["q1"]["mode"] == "legacy"
    assert {"host", "device"} <= {c["path"]
                                  for c in p0["plans"]["q1"]["candidates"]}
    for p in (j0, p0):
        assert not [c for c in p["plans"]["q1"]["candidates"]
                    if "shard" in c["path"]]
    assert pr == jr == {"status": "OK", "queries": {"q1": "fused",
                                                    "q2": "fused"}}
    assert p1["plans"]["q1"]["actual"] == "fused"
    assert [(e["query"], e["from"], e["to"]) for e in p1["replans"]] == \
        [(e["query"], e["from"], e["to"]) for e in j1["replans"]]
    assert pshard[0] == jshard[0] == 200
    assert json.loads(pshard[2]) == json.loads(jshard[2])
