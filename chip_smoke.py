#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``siddhi_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``siddhi_tpu_torch/kernels/csrc`` and
drives the dense-NFA pattern path through ``compile_pattern`` and
``process`` at full size.  Phases, each printing one JSON line:

1. build: seconds to build every kernel (one ``nvcc`` per source, all
   started together), and the card's name and power limit.
2. probe: the build-and-launch kernel held equal to ``x + 1``.
3. packed step: the dense-step kernel against its plain torch version,
   both on the card, on seeded valid inputs at S=16, I=4, B=131072
   (anchors past ``within`` so expiry fires, busy lanes so placement
   overflows) and at ragged B=40, 1000, 1056; all five outputs must be
   bit-exact.  Times both at full width.
4. end to end: bench.py's ``kernel_eligible_app`` (16 states, within
   10 min) over 1,000,000 partitions, B=131072 events per batch, started
   from one seeded mid-chain state, on the card and again with
   ``device="cpu"``; every batch's matches and the final state must be
   bit-exact.  Kernel launch counts are read from this phase alone.
   A breakdown line follows: host-clock ms of each stage of ``process``
   on a few more batches, and the device's busy time and largest kernels
   under ``torch.profiler``.
5. kernels: one line per ported kernel (launches in phase 4, largest
   difference from its plain version, times, bound).

Then the card's name and power limit (nvidia-smi), and last the device
line.  Any failed phase raises, so the script exits non-zero and prints
no device line; so does a machine without a CUDA card.  It imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and the
# float32 rate outside the tensor cores, used for int32 ALU work.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12

N_STATES = 16
N_PARTITIONS = 1_000_000
BATCH = 1 << 17
N_INSTANCES = 4
WITHIN_MS = 600_000
E2E_BATCHES = 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def kernel_eligible_app() -> str:
    """bench.py's kernel_eligible_app: capture-free escalation chain."""
    states = ["every e1=Txn[v > 1.0]"]
    for i in range(2, N_STATES + 1):
        states.append(f"e{i}=Txn[v > {float(i)}]")
    return ("define stream Txn (key long, v double); "
            f"@info(name='bench') from {' -> '.join(states)} within 10 min "
            f"select e{N_STATES}.v as v insert into Alerts;")


def time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Mean ms per call over ``reps`` calls, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def packed_inputs(torch, pack_bits, batch_blocks, S, I, B, within, seed,
                  device):
    """Seeded valid packed-step inputs: anchors only where active, some
    older than ``within``; 60% of lanes busy so placement overflows."""
    rng = np.random.default_rng(seed)
    Bp, _W, _ = batch_blocks(B)
    ts = np.zeros(Bp, dtype=np.int64)
    ts[:B] = rng.integers(2 * within, 2**30, B)
    active = rng.random((S * I, Bp)) < 0.6
    active[:, B:] = False
    age = rng.integers(0, within + within // 4, (S * I, Bp))
    first = np.where(active, np.maximum(ts[None, :] - age, 1), 0)
    ok = rng.random((S, Bp)) < 0.5
    ok[:, B:] = False
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return (pack_bits(as_t(ok)).to(device),
            pack_bits(as_t(active)).to(device),
            as_t(first.astype(np.int32)).to(device),
            as_t(ts.astype(np.int32)[None, :]).to(device))


def packed_step_bound_ms(S, I, W) -> float:
    """Least time for one packed step: every input read once and every
    output written once over HBM, or its int32 work on the CUDA cores,
    whichever is larger (the bytes, by far)."""
    Bp = 32 * W
    words_in = S * W + S * I * W + S * I * Bp + Bp
    words_out = S * I * W + S * I * Bp + I * W + I * Bp + Bp
    bytes_ = 4 * (words_in + words_out)
    # per row, node and lane: expiry test and clear, fire, stamp, rank
    # and placement select; 16 int32 operations is a generous count
    ops = 16 * Bp * S * I
    return 1e3 * max(bytes_ / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S)


def mid_chain_state(engine, seed):
    """Seeded mid-chain state: ~30% of (partition, node, lane) active,
    anchors spread over the last ``within`` (a few expire per batch)."""
    rng = np.random.default_rng(seed)
    state = engine.init_state_host()
    shape = state["active"].shape
    active = rng.random(shape) < 0.3
    active[-1] = False  # scratch row
    first = np.where(active, rng.integers(1, WITHIN_MS + 1, shape), 0)
    state["active"] = active
    state["first_ts"] = first.astype(np.int32)
    # base so the first batch (ts = 1000) sits WITHIN_MS after rel 0
    return state, 1000 - WITHIN_MS


def e2e_batch(rng, i):
    part = ((np.arange(BATCH, dtype=np.int64) * 524287 + i * BATCH)
            % N_PARTITIONS).astype(np.int32)
    v = rng.uniform(0.0, float(N_STATES + 4), BATCH).astype(np.float32)
    ts = np.full(BATCH, 1_000 + i * 10, dtype=np.int64)
    return part, {"key": part.astype(np.int64), "v": v}, ts


def batch_breakdown(torch, eng, state, rng, first_batch, n=4):
    """Where one batch's time goes, on batches after the checked ones:
    host-clock ms of each stage of ``process`` (each ended by a
    synchronise), then one more pass under ``torch.profiler`` for the
    device's busy time and its largest kernels.  Timing only: launch
    counts were read before, and the results are not compared."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from siddhi_tpu_torch.core.emit_queue import fetch_coalesced
    from siddhi_tpu_torch.ops.dense_nfa import _collision_rounds

    stages = {"host_prep_ms": [], "step_ms": [], "count_ms": [],
              "fetch_ms": [], "materialize_ms": []}
    batches = [e2e_batch(rng, first_batch + i) for i in range(2 * n)]
    for part, cols, ts in batches[:n]:
        # host share of the step stage: collision rounds and lane columns
        t = time.perf_counter()
        _collision_rounds(part)
        eng.prepare_cols("Txn", cols)
        stages["host_prep_ms"].append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, pending = eng.process_deferred(state, "Txn", part, cols, ts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pending.resolve()
        t2 = time.perf_counter()
        host = fetch_coalesced(pending.device_arrays())
        t3 = time.perf_counter()
        pending.materialize(host)
        t4 = time.perf_counter()
        for k, a, b in (("step_ms", t0, t1), ("count_ms", t1, t2),
                        ("fetch_ms", t2, t3), ("materialize_ms", t3, t4)):
            stages[k].append(1e3 * (b - a))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for part, cols, ts in batches[n:]:
            state, _ev, _out = eng.process(state, "Txn", part, cols, ts)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side activity only (kernels and copies); the CPU ops that
    # launched them carry the same time again and are left out
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, c + 1)
    device_ms = sum(ms for ms, _c in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"phase": "breakdown", "batches": n,
            **{k: sorted(v)[len(v) // 2] for k, v in stages.items()},
            "profiled_wall_ms": wall_ms,
            "device_busy_ms": device_ms if by_name else "not measured",
            "device_busy_share": device_ms / wall_ms if by_name else None,
            "top_device_ops_ms": [[k[:90], ms, c] for k, (ms, c) in top]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2

    from siddhi_tpu_torch import compile_pattern, state_from_numpy, state_to_numpy
    from siddhi_tpu_torch.kernels import build, dense_step, probe
    from siddhi_tpu_torch.kernels.plane_pack import pack_bits

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "card": card,
          "ptxas": {n: [ln.split(":", 1)[1].strip()
                        for ln in log.splitlines() if "registers" in ln]
                    for n, log in build.BUILD_LOGS.items()}})

    # 2. probe ---------------------------------------------------------------
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    y = probe.add_one(x)
    torch.cuda.synchronize()
    probe_err = max_abs_err(torch, [y], [probe.add_one_plain(x)])
    if probe_err:
        raise AssertionError(f"probe kernel differs from x + 1: {probe_err}")
    probe_ms = time_ms(torch, lambda: probe.add_one(x), 200)
    probe_plain_ms = time_ms(torch, lambda: probe.add_one_plain(x), 200)
    probe_lib_ms = time_ms(torch, lambda: torch.add(x, 1), 200)
    emit({"phase": "probe", "ok": True, "ms": probe_ms,
          "plain_ms": probe_plain_ms})

    # 3. packed step vs its plain version --------------------------------------
    step_err = 0
    for B in (BATCH, 40, 1000, 1056):
        ins = packed_inputs(torch, pack_bits, dense_step._batch_blocks,
                            N_STATES, N_INSTANCES, B, WITHIN_MS, seed=B,
                            device=dev)
        got = dense_step.packed_step(*ins, n_inst=N_INSTANCES, within=WITHIN_MS)
        want = dense_step.packed_step_plain(*ins, N_INSTANCES, WITHIN_MS)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err:
            raise AssertionError(f"dense_step kernel differs from its plain "
                                 f"version at B={B}: max |diff| {err}")
        step_err = max(step_err, err)
        first, ts = ins[2], ins[3]
        expired = int(((first > 0) & (ts - first > WITHIN_MS)).sum())
        overflow = int(want[4].sum())
        if not (expired and overflow):
            raise AssertionError(f"B={B}: inputs exercise no expiry "
                                 f"({expired}) or no overflow ({overflow})")
        line = {"phase": "packed_step", "B": B, "bit_exact": True,
                "expired": expired, "overflow": overflow}
        if B == BATCH:
            full_ins, W = ins, ins[0].shape[1]
            step_ms = time_ms(torch, lambda: dense_step.packed_step(
                *full_ins, n_inst=N_INSTANCES, within=WITHIN_MS), 50)
            step_plain_ms = time_ms(torch, lambda: dense_step.packed_step_plain(
                *full_ins, N_INSTANCES, WITHIN_MS), 10)
            step_bound_ms = packed_step_bound_ms(N_STATES, N_INSTANCES, W)
            line.update(ms=step_ms, plain_ms=step_plain_ms,
                        bound_ms=step_bound_ms)
        emit(line)

    # 4. end to end at full size ---------------------------------------------
    app = kernel_eligible_app()
    probe.add_one.launches = 0
    dense_step.packed_step.launches = 0
    eng = compile_pattern(app, "bench", n_partitions=N_PARTITIONS, device="cuda")
    host, base_ts = mid_chain_state(eng, seed=11)
    state = state_from_numpy(eng, host, base_ts)
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    rng = np.random.default_rng(7)
    batches = [e2e_batch(rng, i) for i in range(E2E_BATCHES)]
    results, batch_s = [], []
    for part, cols, ts in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, ev, out = eng.process(state, "Txn", part, cols, ts)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t)
        results.append((ev, out))
    launches = {"probe": probe.add_one.launches,
                "dense_step": dense_step.packed_step.launches}
    final, _ = state_to_numpy(eng, state)
    breakdown = batch_breakdown(torch, eng, state, rng, E2E_BATCHES)
    del state

    cpu = compile_pattern(app, "bench", n_partitions=N_PARTITIONS, device="cpu")
    cstate = state_from_numpy(cpu, host, base_ts)
    n_matches = 0
    t = time.perf_counter()
    for (part, cols, ts), (ev, out) in zip(batches, results):
        cstate, cev, cout = cpu.process(cstate, "Txn", part, cols, ts)
        if not (np.array_equal(ev, cev) and np.array_equal(out, cout)
                and out.dtype == cout.dtype):
            raise AssertionError("end-to-end matches differ between the card "
                                 "and the CPU run")
        n_matches += len(ev)
    cpu_s = time.perf_counter() - t
    cfinal, _ = state_to_numpy(cpu, cstate)
    for k in ("active", "first_ts", "overflow"):
        if not np.array_equal(final[k], cfinal[k]):
            raise AssertionError(f"final '{k}' differs between the card and "
                                 "the CPU run")
    if n_matches == 0:
        raise AssertionError("the end-to-end run found no matches")
    if launches["dense_step"] < E2E_BATCHES or launches["probe"] < 1:
        raise AssertionError(f"kernels not launched on the main path: {launches}")
    # the first batch carries one-time set-up; the rate is every steady
    # event over all the steady batches' time, so a stall moves it
    steady = batch_s[1:]
    emit({"phase": "end_to_end", "bit_exact_batches": E2E_BATCHES,
          "partitions": N_PARTITIONS, "batch": BATCH, "matches": n_matches,
          "state_bytes": state_bytes, "launches": launches,
          "batch_ms": [1e3 * s for s in batch_s],
          "events_per_s": BATCH * len(steady) / sum(steady),
          "events_per_s_median_batch":
              BATCH / sorted(steady)[len(steady) // 2],
          "cpu_seconds": cpu_s, "card": card})

    emit(breakdown)

    # 5. kernels -------------------------------------------------------------
    emit({"kernels": [
        {"name": "dense_step", "route": "cuda",
         "source": "siddhi_tpu_torch/kernels/csrc/dense_step.cu",
         "replaces": "siddhi_tpu/kernels/dense_step.py:154",
         "launches": launches["dense_step"], "max_abs_err": step_err,
         "ms": step_ms, "plain_ms": step_plain_ms, "bound_ms": step_bound_ms,
         "bound_by": "bytes", "library_ms": None},
        {"name": "probe", "route": "cuda",
         "source": "siddhi_tpu_torch/kernels/csrc/probe.cu",
         "replaces": "siddhi_tpu/kernels/probe.py:56",
         "launches": launches["probe"], "max_abs_err": probe_err,
         "ms": probe_ms, "plain_ms": probe_plain_ms,
         "bound_ms": 1e3 * 2 * x.numel() * 4 / HBM_BYTES_PER_S,
         "bound_by": "bytes", "library_ms": probe_lib_ms},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
