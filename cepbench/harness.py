"""One run of one cell: set-up, the measured window, the traced
sub-window, the check against the plain reference, the result line.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``)
and its traffic mix (``traffic/<mix>.json``, read by ``generator.py``);
the configuration names its reference (``reference/<module>.py``) and,
where the check needs one of the program's counters, its readout
(``readouts/<module>.py``); each metric is read by
``metrics/<name>.py`` from what the run recorded.

The window is a closed loop: one client hands batch after batch to
``InputHandler.send_batch`` until ``--seconds`` have passed, then
drains the app; outputs arrive through a ``StreamCallback`` on the
configuration's output stream.  With ``--trace 1`` the app runs under
``@app:trace(sample='1/1')`` (the port's ingest, step and emit spans on
every batch), and after the window a short sub-window runs under
``torch.profiler``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import List, Optional

from cepbench import devtrace
from cepbench.generator import Traffic, merge

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "siddhi_tpu")
# the traced sub-window: at least this long, and this many batches
PROFILE_SECONDS = 2.0
PROFILE_MIN_BATCHES = 3
TRACE_ANNOTATION = "@app:trace(sample='1/1', cycles='4096') "


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``cepbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cepbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules``, compared whole, that a run may
    not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every cache the program or its libraries keep, at fixed paths in
    the checkout (the port's kernels build in
    ``siddhi_tpu_torch/kernels/build``, itself in the checkout)."""
    cache = ROOT / ".cepbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["SIDDHI_TPU_TRACE_DIR"] = str(cache / "traces")


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration and mix;
    ``overrides`` merges smaller sizes in (``{"config": ..., "traffic":
    ...}``, for tests on the CPU)."""

    def __init__(self, name: str, spec: Optional[dict] = None,
                 overrides: Optional[dict] = None):
        spec = spec or load_json(ROOT / "BENCHMARK.json")
        self.spec = spec
        self.name = name
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}")
        self.cell = cells[name]
        conf = next(c for c in spec["configs"]
                    if c["name"] == self.cell["config"])
        over = overrides or {}
        self.config = merge(load_json(ROOT / conf["file"]),
                            over.get("config"))
        self.mix = merge(load_json(HERE / "traffic"
                                   / f"{self.cell['traffic']}.json"),
                         over.get("traffic"))
        self.chips = int(self.cell["chips"])

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: its end-to-end ones, or with
        ``trace`` its per-layer ones."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or self.name in m["workloads"]]

    def app(self, trace: bool) -> str:
        text = self.config["app"].format(**self.config["sizes"])
        return (TRACE_ANNOTATION + text) if trace else text


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_process: Optional[float] = None) -> dict:
    """Run ``cell`` and return the result (the last line's object).
    ``device``: ``cuda``, or ``cpu`` for tests, which then read no
    device metric."""
    t_process = time.perf_counter() if t_process is None else t_process
    import torch

    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.core.stream import StreamCallback

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    config, traffic = cell.config, Traffic(cell.mix, seed)
    mgr = SiddhiManager(device=device)
    rt = mgr.create_siddhi_app_runtime(cell.app(trace))
    received: list = []

    class Keep(StreamCallback):
        def receive_batch(self, batch):
            received.append((time.perf_counter(), batch.timestamps,
                             batch.columns))

    rt.add_callback(config["output"], Keep())
    rt.start()
    handler = rt.get_input_handler(config["input"])
    names = traffic.names

    def send(i):
        cols, ts = traffic.batch(i)
        return EventBatch(traffic.stream, names, cols, ts)

    for i in range(traffic.warmup):
        handler.send_batch(send(i))
    rt.drain()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tracer = rt.app_context.tracer
    if trace:
        tracer.reset()
    # the window: hand batches on until the time is up, then drain
    n_warm = len(received)
    hand: List[tuple] = []  # (batch index, hand-off, return)
    i = traffic.warmup
    deadline = None
    while True:
        b = send(i)
        t = time.perf_counter()
        if deadline is None:
            deadline = t + seconds
        elif t >= deadline:
            break
        handler.send_batch(b)
        hand.append((i, t, time.perf_counter()))
        i += 1
    rt.drain()
    sync()
    t_end = time.perf_counter()
    window_mods = forbidden_modules()
    ctx = {"config": config, "traffic": traffic,
           "setup_s": hand[0][1] - t_process, "hand": hand,
           "t_end": t_end, "received": received[n_warm:],
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu"}
    if trace:
        ctx["spans"] = {stage: (h.count, h.sum_ms)
                        for stage, h in tracer.stage_hist.items()}
        ctx["span_engines"] = sorted({s[2] for s in tracer.recorder.spans()})
        ctx["profile"] = None
        if cuda:
            ctx["profile"], i = traced_window(torch, rt, handler, send, i,
                                              tracer)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    program = (load_module("readouts", config["readout"]).read(rt, config)
               if config.get("readout") else {})
    dev = {"platform": "gpu" if cuda else "cpu", "kind": ctx["kind"],
           "count": cell.chips, "memory_peak_bytes": peak}
    n_batches = i
    # the program's state goes before the reference runs
    rt.shutdown()
    mgr.shutdown()
    del rt, mgr, handler
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    metrics = {}
    for m in cell.metrics(trace):
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    t_check = time.perf_counter()
    checks, failed_batches = check(cell, traffic, n_batches, received,
                                   program, device)
    print(f"cepbench: {cell.name} seed {seed}: setup {ctx['setup_s']:.3f} s, "
          f"{len(hand)} batches in the window, {n_batches} in all, "
          f"check {time.perf_counter() - t_check:.3f} s; host "
          f"{host_note()}", file=sys.stderr)
    correct = all(ok for _v, _lim, ok in checks.values())
    window = {b for b, _t, _r in hand}
    result = {"correct": bool(correct),
              "attempted": len(hand) * traffic.B,
              "failed": len(window & set(failed_batches)) * traffic.B,
              "metrics": metrics, "device": dev}
    if trace and ctx.get("profile"):
        p = ctx["profile"]
        dev["busy_s"] = p["busy_s"]
        dev["window_s"] = p["window_s"]
        result["breakdown"] = {"device_ops": p["device_ops"],
                               "idle_gaps": p["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim, _ok) in checks.items()}
    result["_forbidden"] = sorted(set(window_mods) | set(forbidden_modules()))
    return result


def traced_window(torch, rt, handler, send, i, tracer) -> tuple:
    """Batches from ``i`` on under ``torch.profiler`` for at least
    ``PROFILE_SECONDS`` and ``PROFILE_MIN_BATCHES``, from an idle device
    to a drained app: ``(the reduced trace or None, the next batch)``,
    the trace labelled by this harness's send spans and the port's
    ingest, step and emit spans."""
    from torch.profiler import ProfilerActivity, profile

    sends = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_mark = time.perf_counter()
        torch.zeros(1, device="cuda")  # the clock's marker
        torch.cuda.synchronize()
        first = i
        while True:
            b = send(i)
            t = time.perf_counter()
            if (t - t_mark >= PROFILE_SECONDS
                    and i - first >= PROFILE_MIN_BATCHES):
                break
            handler.send_batch(b)
            sends.append(("send", t, time.perf_counter()))
            i += 1
        rt.drain()
        torch.cuda.synchronize()
        t_stop = time.perf_counter()
    spans = sends + [(s[1], s[3], s[4]) for s in tracer.recorder.spans()
                     if s[4] >= t_mark]
    red = devtrace.reduce(devtrace.device_events(prof), t_mark, t_stop,
                          spans)
    if red is not None:
        red.update(batches=i - first, first_batch=first, next_batch=i)
    return red, i


def check(cell: Cell, traffic, n_batches: int, received, program: dict,
          device: str) -> tuple:
    """The reference over every batch the run sent, and the program's
    rows and readout held to it: ``({name: (value, limit, ok)}, failed
    batches)``."""
    ref = load_module("reference", cell.config["reference"])
    t0 = time.perf_counter()
    want = ref.reference(cell.config, traffic, n_batches, device)
    t1 = time.perf_counter()
    got = [(ts, cols) for _t, ts, cols in received]
    numbers = ref.compare(cell.config, traffic, n_batches, want, got,
                          program)
    print(f"cepbench: reference {t1 - t0:.3f} s, comparison "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)
    failed = numbers.pop("failed_batches")
    return held(ref, numbers), failed


def held(ref, numbers: dict) -> dict:
    """Each number beside its limit: ``{name: (value, limit, ok)}``."""
    out = {}
    for name, value in numbers.items():
        op, limit = ref.LIMITS[name]
        ok = value <= limit if op == "<=" else value >= limit
        out[name] = (value, f"{op} {limit}", ok)
    return out


def host_note() -> str:
    """The host's CPU model, its cores' mean clock and its load, read
    from ``/proc`` (empty where there is none): runs on hosts that
    differ read differently."""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            info = f.read().splitlines()
        with open("/proc/loadavg", encoding="utf-8") as f:
            load = f.read().split()[:3]
    except OSError:
        return ""
    model = next((ln.split(":", 1)[1].strip() for ln in info
                  if ln.startswith("model name")), "?")
    mhz = [float(ln.split(":", 1)[1]) for ln in info
           if ln.startswith("cpu MHz")]
    mean = sum(mhz) / len(mhz) if mhz else 0.0
    return (f"{model}, {len(mhz)} cpus at {mean:.0f} MHz mean, "
            f"load {' '.join(load)}")


def main(argv=None, t_process: Optional[float] = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("cepbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"cepbench: {args.workload} needs {cell.chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 t_process=t_process)
    found = result.pop("_forbidden")
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    if found:
        print(f"cepbench: modules that the run may not load: {found}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
