"""REST microservice wrapper: deploy/undeploy SiddhiQL apps over HTTP.

Re-design of the reference ``modules/siddhi-service``
(SiddhiApiServiceImpl.java:51 deploy, :100 undeploy) on the stdlib HTTP
server instead of MSF4J:

    POST /siddhi-artifact-deploy            body = SiddhiQL app string
    GET  /siddhi-artifact-undeploy/{name}
    GET  /siddhi-apps                       (list deployed app names)
    GET  /siddhi-persist/{name}             (checkpoint; @app:persist mode)
    GET  /siddhi-restore-last/{name}        (restore newest good revision)
    GET  /siddhi-trace/{name}               (flight recorder; ?format=chrome)
    GET  /siddhi-plan/{name}                (per-query plan: candidates,
                                             costs, pins, re-plan history)
    GET  /siddhi-replan/{name}?q0=path      (force a live re-lowering;
                                             pairs pin per-query paths)
    GET  /siddhi-health/{name}              (overload-protection health:
                                             200 healthy / 503 shedding,
                                             open breaker or wedged)
    GET  /metrics                           (Prometheus text exposition)

Responses are JSON ``{"status": "OK"|"ERROR", "message": ...}`` except
``/metrics`` (Prometheus text) and ``/siddhi-trace?format=chrome``
(raw Chrome ``chrome://tracing`` JSON array).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlsplit

from siddhi_tpu_torch.core.manager import SiddhiManager
from siddhi_tpu_torch.observability.prometheus import (
    CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE,
    app_histogram_entries,
    render_prometheus,
)


class SiddhiService:
    """In-process deploy/undeploy service around one SiddhiManager."""

    def __init__(self, manager: Optional[SiddhiManager] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.manager = manager or SiddhiManager()
        self._runtimes: Dict[str, object] = {}
        self._lock = threading.Lock()
        service = self

        class Handler(BaseHTTPRequestHandler):
            # per-request socket timeout: a stalled client (or a wedge
            # downstream of a blocking read) must not pin one of the
            # server's threads forever
            timeout = 10

            def log_message(self, *args):  # quiet test output
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self._send_raw(code, body, "application/json")

            def _send_raw(self, code: int, body: bytes, content_type: str):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path.rstrip("/") != "/siddhi-artifact-deploy":
                    self._send(404, {"status": "ERROR", "message": "not found"})
                    return
                length = int(self.headers.get("Content-Length", "0"))
                app_str = self.rfile.read(length).decode("utf-8")
                code, payload = service.deploy(app_str)
                self._send(code, payload)

            def do_GET(self):
                url = urlsplit(self.path)
                parts = url.path.rstrip("/").split("/")
                if url.path.rstrip("/") == "/metrics":
                    self._send_raw(200, service.metrics_text().encode(),
                                   PROMETHEUS_CONTENT_TYPE)
                    return
                if len(parts) == 3 and parts[1] == "siddhi-trace":
                    fmt = parse_qs(url.query).get("format", [""])[0]
                    code, payload = service.trace(parts[2], fmt)
                    if code == 200 and fmt == "chrome":
                        self._send_raw(code, json.dumps(payload).encode(),
                                       "application/json")
                    else:
                        self._send(code, payload)
                    return
                if len(parts) == 3 and parts[1] == "siddhi-artifact-undeploy":
                    code, payload = service.undeploy(parts[2])
                    self._send(code, payload)
                elif len(parts) == 3 and parts[1] == "siddhi-pattern-state":
                    code, payload = service.pattern_state(parts[2])
                    self._send(code, payload)
                elif len(parts) == 3 and parts[1] == "siddhi-query-lowering":
                    code, payload = service.query_lowering(parts[2])
                    self._send(code, payload)
                elif len(parts) == 3 and parts[1] == "siddhi-plan":
                    code, payload = service.plan(parts[2])
                    self._send(code, payload)
                elif len(parts) == 3 and parts[1] == "siddhi-replan":
                    pins = {k: v[0]
                            for k, v in parse_qs(url.query).items()}
                    code, payload = service.replan(parts[2], pins)
                    self._send(code, payload)
                elif len(parts) == 3 and parts[1] == "siddhi-health":
                    code, payload = service.health(parts[2])
                    self._send(code, payload)
                elif len(parts) == 3 and parts[1] == "siddhi-statistics":
                    code, payload = service.statistics(parts[2])
                    self._send(code, payload)
                elif len(parts) == 3 and parts[1] == "siddhi-persist":
                    code, payload = service.persist(parts[2])
                    self._send(code, payload)
                elif len(parts) == 3 and parts[1] == "siddhi-restore-last":
                    code, payload = service.restore_last(parts[2])
                    self._send(code, payload)
                elif self.path.rstrip("/") == "/siddhi-apps":
                    self._send(200, {"status": "OK", "apps": service.app_names()})
                else:
                    self._send(404, {"status": "ERROR", "message": "not found"})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- operations (also usable without HTTP) -------------------------------

    def deploy(self, app_str: str):
        """reference: SiddhiApiServiceImpl.siddhiArtifactDeployPost:51"""
        try:
            with self._lock:
                runtime = self.manager.create_siddhi_app_runtime(
                    app_str, register=False)
                if (runtime.name in self._runtimes
                        or self.manager.get_siddhi_app_runtime(runtime.name)
                        is not None):
                    # also reject apps registered directly on the shared
                    # manager: silently replacing that registration would
                    # leave the old runtime running untracked
                    runtime.shutdown()
                    return 409, {
                        "status": "ERROR",
                        "message": f"Siddhi app '{runtime.name}' already exists",
                    }
                try:
                    runtime.start()
                except Exception:
                    runtime.shutdown()
                    raise
                # register only once start() succeeded, so a failed deploy
                # does not squat the name
                self.manager.runtimes[runtime.name] = runtime
                self._runtimes[runtime.name] = runtime
            return 200, {
                "status": "OK",
                "message": "Siddhi app is deployed and runtime is created",
                "name": runtime.name,
            }
        except Exception as e:  # noqa: BLE001 — surface planning errors to client
            return 400, {"status": "ERROR", "message": str(e)}

    def undeploy(self, name: str):
        """reference: SiddhiApiServiceImpl.siddhiArtifactUndeploySiddhiAppGet:100"""
        with self._lock:
            runtime = self._runtimes.pop(name, None)
        if runtime is None:
            return 404, {
                "status": "ERROR",
                "message": f"there is no Siddhi app named '{name}'",
            }
        runtime.shutdown()
        self._unregister(name, runtime)
        return 200, {"status": "OK", "message": f"Siddhi app '{name}' undeployed"}

    def _unregister(self, name: str, runtime):
        """The manager forgets a runtime this service deployed (only
        that one: a later registration under the name stays)."""
        if self.manager.runtimes.get(name) is runtime:
            self.manager.runtimes.pop(name, None)

    @staticmethod
    def _overload_503(name: str, runtime):
        """503 + the health report when the target app is shedding, has
        an open breaker, or is wedged — for routes that would otherwise
        BLOCK on the app's process lock.  None when the app (or an app
        without @app:limits) can serve the request now."""
        if getattr(runtime.app_context, "robustness", None) is None:
            return None
        h = runtime.health()
        if h["healthy"]:
            return None
        return 503, {
            "status": "ERROR",
            "message": f"Siddhi app '{name}' is overloaded "
                       "(shedding, open breaker, or wedged) — "
                       "see /siddhi-health/" + name,
            "health": h,
        }

    def health(self, name: str):
        """Overload-protection health of a deployed app: admission
        budgets + shed counts, breaker states, watchdog and ladder
        state, and the full robustness counter block (the same live
        objects the statistics feed reads).  200 healthy / 503 not."""
        with self._lock:
            runtime = self._runtimes.get(name)
        if runtime is None:
            return 404, {
                "status": "ERROR",
                "message": f"there is no Siddhi app named '{name}'",
            }
        h = runtime.health()
        code = 200 if h["healthy"] else 503
        return code, {"status": "OK" if h["healthy"] else "UNHEALTHY", **h}

    def pattern_state(self, name: str):
        """Per-query pattern-engine occupancy of a deployed app (dense:
        partitions/instances/overflow; host: live instances)."""
        with self._lock:
            runtime = self._runtimes.get(name)
        if runtime is None:
            return 404, {
                "status": "ERROR",
                "message": f"there is no Siddhi app named '{name}'",
            }
        # pattern_state() takes the app lock — answer 503 with the
        # health report instead of parking the request thread behind a
        # shedding or wedged app
        busy = self._overload_503(name, runtime)
        if busy is not None:
            return busy
        return 200, {"status": "OK", "queries": runtime.pattern_state()}

    def query_lowering(self, name: str):
        """Per-query engine placement (host | dense | device) of a
        deployed app — which queries actually lowered to a device
        engine under @app:execution('tpu')."""
        with self._lock:
            runtime = self._runtimes.get(name)
        if runtime is None:
            return 404, {
                "status": "ERROR",
                "message": f"there is no Siddhi app named '{name}'",
            }
        return 200, {"status": "OK", "queries": runtime.lowering()}

    def statistics(self, name: str):
        """Metric feed of a deployed app — latency/throughput trackers
        plus the fault/recovery counters (registered ungated, so chaos
        and recovery events stay visible at statistics level 'off')."""
        with self._lock:
            runtime = self._runtimes.get(name)
        if runtime is None:
            return 404, {
                "status": "ERROR",
                "message": f"there is no Siddhi app named '{name}'",
            }
        return 200, {"status": "OK", "metrics": runtime.statistics()}

    def plan(self, name: str):
        """Chosen plan per query of a deployed app: the cost model's
        candidates with scores, the pick, the pin that forced it,
        rejected alternatives with reasons, and the live re-plan
        history (planner/costmodel.py PlanRecord)."""
        with self._lock:
            runtime = self._runtimes.get(name)
        if runtime is None:
            return 404, {
                "status": "ERROR",
                "message": f"there is no Siddhi app named '{name}'",
            }
        sm = runtime.app_context.statistics_manager
        plans = {}
        replans = []
        if sm is not None:
            plans = {q: rec.to_dict()
                     for q, rec in sorted(sm.plans.items())}
            replans = list(sm.replans)
        return 200, {"status": "OK", "app": name,
                     "lowering": runtime.lowering(),
                     "plans": plans, "replans": replans}

    def replan(self, name: str, pins: Optional[Dict[str, str]] = None):
        """Force a live re-lowering of a deployed app.  Query-string
        pairs pin per-query paths (``?q0=fuse%2Bshard``); with no pairs
        the cost model re-chooses every query.  Refused (409) without a
        full-history input journal — see SiddhiAppRuntime.replan."""
        with self._lock:
            runtime = self._runtimes.get(name)
        if runtime is None:
            return 404, {
                "status": "ERROR",
                "message": f"there is no Siddhi app named '{name}'",
            }
        busy = self._overload_503(name, runtime)
        if busy is not None:
            return busy
        try:
            lowering = runtime.replan(pins or {}, forced=True,
                                      reason="forced via REST")
        except Exception as e:  # noqa: BLE001 — surface refusals to client
            return 409, {"status": "ERROR", "message": str(e)}
        return 200, {"status": "OK", "queries": lowering}

    def persist(self, name: str):
        """Checkpoint a deployed app in its configured persist mode
        (@app:persist, default sync).  Async mode returns as soon as the
        capture lands — the revision commits on the checkpoint writer
        thread; poll /siddhi-statistics for persistCommits."""
        with self._lock:
            runtime = self._runtimes.get(name)
        if runtime is None:
            return 404, {
                "status": "ERROR",
                "message": f"there is no Siddhi app named '{name}'",
            }
        busy = self._overload_503(name, runtime)
        if busy is not None:
            return busy
        try:
            revision = runtime.persist()
        except Exception as e:  # noqa: BLE001 — surface persist errors to client
            return 500, {"status": "ERROR", "message": str(e)}
        return 200, {"status": "OK", "revision": revision,
                     "mode": runtime.app_context.persist_mode}

    def restore_last(self, name: str):
        """Restore the newest restorable revision of a deployed app
        (corrupt/torn revisions are walked past) and replay journaled
        post-checkpoint input."""
        with self._lock:
            runtime = self._runtimes.get(name)
        if runtime is None:
            return 404, {
                "status": "ERROR",
                "message": f"there is no Siddhi app named '{name}'",
            }
        try:
            revision = runtime.restore_last_revision()
        except Exception as e:  # noqa: BLE001 — surface restore errors to client
            return 500, {"status": "ERROR", "message": str(e)}
        if revision is None:
            return 404, {
                "status": "ERROR",
                "message": f"no persisted revision for app '{name}'",
            }
        return 200, {"status": "OK", "revision": revision}

    def trace(self, name: str, fmt: str = ""):
        """Flight-recorder feed of a deployed app: the live span ring
        plus the last crash dump (if any).  ``fmt='chrome'`` returns the
        ring as a Chrome ``chrome://tracing`` event array instead."""
        with self._lock:
            runtime = self._runtimes.get(name)
        if runtime is None:
            return 404, {
                "status": "ERROR",
                "message": f"there is no Siddhi app named '{name}'",
            }
        tracer = runtime.app_context.tracer
        if tracer is None:
            return 404, {
                "status": "ERROR",
                "message": f"tracing is off for app '{name}'",
            }
        if fmt == "chrome":
            return 200, tracer.recorder.chrome_trace()
        return 200, {
            "status": "OK",
            "app": name,
            "sample": tracer.sample,
            "trace": tracer.recorder.payload("live"),
            "last_dump": tracer.recorder.last_dump,
        }

    def metrics_text(self) -> str:
        """All deployed apps' metric feeds as one Prometheus
        text-exposition page (scrape target: GET /metrics)."""
        with self._lock:
            runtimes = sorted(self._runtimes.items())
        apps = []
        for name, rt in runtimes:
            sm = rt.app_context.statistics_manager
            apps.append((name, rt.statistics(),
                         app_histogram_entries(name, sm)))
        return render_prometheus(apps)

    def app_names(self):
        with self._lock:
            return sorted(self._runtimes)

    def get_runtime(self, name: str):
        with self._lock:
            return self._runtimes.get(name)

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="siddhi-service", daemon=True
        )
        self._thread.start()

    def stop(self):
        # HTTPServer.shutdown() blocks until serve_forever() acknowledges;
        # it deadlocks when the serving thread was never started.
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._server.server_close()
        with self._lock:
            runtimes, self._runtimes = dict(self._runtimes), {}
        for name, rt in runtimes.items():
            rt.shutdown()
            self._unregister(name, rt)
