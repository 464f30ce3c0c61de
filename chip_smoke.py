#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``siddhi_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``siddhi_tpu_torch/kernels/csrc`` and
drives the dense-NFA pattern path through ``compile_pattern`` and
``process`` at full size (the batch step and the general step), the
skew-routed pattern path and the incremental-aggregation path through
``SiddhiManager``.  Phases, each printing one JSON line:

1. build: seconds to build every kernel (one ``nvcc`` per source, all
   started together), and the card's name and power limit.
2. probe: the build-and-launch kernel held equal to ``x + 1``, timed in
   turns with ``torch.add(x, 1)``.  Every timed call reports ``ms`` (CUDA
   events over 200 back-to-back calls), ``host_us`` (``perf_counter``
   over the same calls, one synchronise at the end) and ``device_us``
   (device time per call under ``torch.profiler``).
3. packed step: the packed dense-step kernel (off the main path since
   the batch step took its place; kept as the Pallas kernel's
   interface-level twin) against its plain torch version, both on the card, on seeded valid inputs at S=16, I=4, B=131072
   (anchors past ``within`` so expiry fires, busy lanes so placement
   overflows) and at ragged B=40, 1000, 1056; then at the skew-routed
   path's dense half, S=2, I=8 with no ``within``, at B=2048 and ragged
   B=1900, 333, 37, 1.  All five outputs must be bit-exact.  Times both
   at full width and at the routed shape.
4. end to end: bench.py's ``kernel_eligible_app`` (16 states, within
   10 min) over 1,000,000 partitions, B=131072 events per batch, started
   from one seeded mid-chain state, on the card and again with
   ``device="cpu"``; every batch's matches and the final state must be
   bit-exact.  Kernel launch counts are read from this phase alone: one
   batch step a batch, no packed step.  A breakdown line follows:
   host-clock ms of each stage of ``process`` on a few more batches, and
   the device's busy time and largest kernels under ``torch.profiler``.
   One more batch's batch-step inputs are kept for phase 7.
5. scan kernel: the fused hot-key scan kernel against its plain torch
   version, both on the card, on seeded inputs at the skew-routed path's
   shape (H=8, n=2048, S=2), the widest legal shape (H=256, n=4096,
   S=32), a ragged one (H=3, n=16, S=5) and one of four 2,048-event
   tiles (H=16, n=8192, S=3); v', c' and emit must be bit-exact.  Times
   both, and works out the bound (bytes over HBM, or float operations at
   peak).
6. skew-routed end to end: bench.py's ``bench_hot_key`` app, annotations
   and traffic (4096 keys, Zipf(1.2) from seed 23, B=8192, 2 warm-up
   batches and 3 windows of 8), through the port's ``SiddhiManager`` on
   the card, routed (``@app:hotkeys``) and dense-only (cut to one
   window, which the line says).  At least one promotion, routed rows
   equal to dense-only rows but for the chains the dense-only run alone
   dropped at its instance-lane capacity (counted, at most one match
   each in this two-node chain), launches of every kernel of the path, and
   the routed callbacks of the warm-up and the first window, and the
   routed query's whole state after them (dense planes, anchors,
   overflow, scan slots, key maps), bit-exact against the same app on
   ``device="cpu"``.  Kernel launch counts of
   this path are read from the routed run alone: one batch step and one
   scan a batch, no packed step.  A breakdown line follows: host-clock
   ms of a routed batch's dense step (with its longest cold segment),
   scan cycle and routing, and the device's busy time under
   ``torch.profiler``.  One more routed batch's cold sub-batch is kept,
   at the batch step's boundary, for phase 7.
7. dense batch: the batch-step kernel against its plain torch version,
   both on the card, each on its own clone of the state: emits, anchors,
   ``n_emit`` and the state stepped in place bit-exact, and a second
   launch the same bits.  Cases: the 1 M cell's batch (131,072 one-event
   segments of the mid-chain state), the routed run's real cold
   sub-batch (N, segments and the longest segment recorded), and edge
   cases (N = 1; S = 32, I = 16; S = 32, I = 32, the shared-memory
   ceiling; I = 32 with a 300-event segment; ragged lanes with a 50 ms
   horizon).  The first two are timed beside the
   plain version, with the bound (bytes, and the longest segment's
   serial chain at the card's top SM clock).
8. bank kernel: the aggregation bank's segmented-reduce kernel against
   its plain torch versions, both on the card, at the aggregation path's
   shape (n_pad 32,768 events, r_pad 4,352 rows: 2,048 Zipf symbols over
   two seconds) for every lane kind the bank uses (float32 sum, count,
   min, max; int32 sum, min, max), at ``bench.py:1189``'s worst case (all
   32,768 events on row 0 of 4,096) and at a ragged n_pad = 256, through
   ``segmented_reduce`` (the delta); at the path's shape and the worst
   case also through ``accumulate_`` (the bank's entry: in place into
   4,097 rows from a live accumulator).  Exact but for float32 sums,
   held per row to n * 2^-24 * sum|v| (plus one rounding of the final add
   on each side for ``accumulate_``); two launches must give the same
   bits.  Times the kernel, the plain version and one PyTorch call
   (``torch.scatter_reduce``, or the in-place ``scatter_reduce_`` for
   ``accumulate_``), and works out the bound.  A ``host_split`` line
   follows: host µs of each piece of an ``accumulate_`` call and of a
   probe call, and of three ways to read the current stream's handle.
9. aggregation end to end: the Siddhi query guide's TradeAggregation
   (``avg(price)``, ``sum(price)`` by symbol, every sec ... year) under
   ``@app:execution('tpu') @app:kernels('bank')``, with
   ``bench_pallas_bank``'s sizes (2,048 symbols, Zipf(1.2) from seed 29,
   B = 32,768 events, 100 trades per ms of event time; 2 warm-up batches
   and 3 windows of 8, each window followed by ``per 'seconds'`` and
   ``per 'minutes'`` pulls through ``rt.query``), on the card and again
   with ``device="cpu"``.  Every pull must agree (bucket starts and
   symbols exact, ``total``/``avgPrice`` within each bucket's float32
   bound), bank scatters and flushes must be equal, and the kernel must
   launch exactly twice per banked batch, both through ``accumulate_``.
   Then the wide variant (every lane kind: LONG sum and extrema pairs,
   float extrema, count) for one window, held the same way.  A breakdown line follows: host-clock ms of
   a batch's host bucketing, bank scatter (H2D and launches) and flush
   (D2H and merge), of the pulls, and the device busy share under
   ``torch.profiler`` over one window.
10. general step: bench.py's headline ``flat_app`` (16 states whose
   filters and select read the capture ``e1.v``) through
   ``compile_pattern(..., n_partitions=1_000_000, n_instances=4)``,
   which routes it to the general step (torch ops, no hand-written
   kernel), from a seeded mid-chain state with registers, over 2
   warm-up and 10 timed batches of 131,072 stride-walked events as in
   ``bench.py:191-205``; every batch's matches and output bits and the
   whole final state (``active``, ``first_ts``, ``counts``, ``regs``,
   ``overflow``) bit-exact against the same batches with
   ``device="cpu"``; every batch must match and registers must move.
   It reports events/s, the per-batch split (``general_breakdown``:
   host preparation, step, count, fetch, materialize, device busy share
   and largest device items) and the device kernels and copies of one
   general step under ``torch.profiler``.  Then three small
   ``general_check`` lines, each card against CPU with its card time:
   an unpartitioned capturing pattern through ``SiddhiManager`` (one
   partition, a collision round an event), an integer id-join
   (``b=S[k == a.k]``, the integer registers) and a capture-free chain
   at ``instances='40'`` (past the batch step's 32 lanes).
11. part b: BASELINE configs 2-4 through ``compile_pattern(...,
   device="cuda")`` on the general step at full size, each from a seeded
   mid-chain state (counts below min at count nodes, one side matched
   at logical nodes, registers in every lane), over 2 warm-up and 10
   timed batches, each held against the same batches and state with
   ``device="cpu"``: every batch's matches, output bits and emits by
   bank, and the whole final state (``active``, ``first_ts``,
   ``counts``, ``regs``, ``iregs``, ``overflow``) bit-exact.
   ``count_fraud``: ``tests/test_dense_nfa.py``'s ``FRAUD_APP``
   (``every a -> b<3:5> within 10 min``) over 100,000 cards, 131,072
   events a batch, amounts ~ lognormal(4, 1), one event a ms;
   ``kleene_bruteforce``: ``every f=Login[ok == 0]<3:100> -> s within 1
   min`` over 1,000,000 users, 131,072 events a batch, 80% failures;
   ``logical_news``: ``every (t=Tick[...] and n=News[...]) within 5
   sec`` over 10,000 symbols, ``Tick`` batches of 16,384 and ``News``
   batches of 2,048 in turns, 500 ms of stream time each.  Each prints
   events/s, ms a batch, collision rounds a batch, emits in bank 0 and
   bank 1, one batch's device kernels a step (``torch.profiler``) and a
   ``<cell>_breakdown`` line (host preparation, step, count, fetch,
   materialize, device busy share).  Launch counts are read over the
   checked batches alone: the probe once an engine, no other kernel.
12. part_b_check: small shapes card against CPU, with their card time:
   ``sequence_pair``, ``non_every`` and ``bounded_count`` of
   ``tests/test_dense_differential_fuzz.py``, a whole-chain
   ``every (a -> b) within 3 sec`` and an ``or`` node, 300 events at
   P = 8 each.
13. absent deadlines (the app scheduler, the general step's absent
   kills and ``and not`` sides, the timer step, ``@purge``): phase
   ``absent_alert`` runs the Siddhi 5.1 query guide's absent example
   (``every e1=RegulatorStateChangeStream[action == 1] -> not
   TemperatureStream[temp <= e1.tempSet] for 30 sec``, the room as the
   partition key, ``action`` an int code) over 1,000,000 rooms through
   ``SiddhiManager(device="cuda")`` and ``send_batch``, so the scheduler
   drives the timer: from a seeded start (10% of rooms armed, deadlines
   over the first 30 s), in turns a Regulator batch of 4,096 events and
   a Temperature batch of 131,072, each over the next 8 s of stream
   time, 2 warm-up and 6 timed turn pairs.  The alerts (values,
   timestamps, order), the timer fires and the whole final state
   (``deadline`` included) must be bit-exact against the same run with
   ``device="cpu"``, with fires and kills.  It reports events/s, ticks
   and timer steps that fired, alerts a tick, the timer step's host ms
   (synchronised), ``next_wakeup`` ms, the fire fetch ms (a tick less
   its step), one timer step's device kernels and time and one
   Temperature batch's general steps under ``torch.profiler``,
   collision rounds a batch and the device busy share over one more
   turn pair.  Launches are read over the held card run: the probe once
   for its engine, no other kernel.  Then ``absent_check`` lines, card
   against CPU through ``SiddhiManager`` (about 300 events at P = 8
   each: a mid-chain absent, ``and not`` with and without ``for``,
   ``every`` arms under a ``within``, an unpartitioned trailing absent,
   the idle heartbeat of ``@app:playback(idle.time, increment)``
   firing a deadline with no input) and ``compile_pattern`` (an engine
   driven across a re-anchor with deadlines pending); and a
   ``purge_check`` line: ``@purge`` on a partitioned chain whose keys go
   idle and whose new keys take the recycled rows, callbacks, key maps
   and state held against the CPU run.
14. fraud_rollup: BASELINE config 2 (``FRAUD_APP``'s pattern inside
   ``partition with (card of Txn)``, 100,000 cards) under a per-card
   aggregating selector (``count()``, ``max(a.amount)``,
   ``sum(b[last].amount)``, ``having alerts >= 2``) through
   ``SiddhiManager`` and ``send_batch``: the dense engine emits the raw
   captures and the host query runtime's selector aggregates the match
   rows per card through the partition-key side channel.  From
   ``count_fraud``'s seeded start over its traffic (2 warm-up and 10
   timed batches of 131,072), the alerts of every batch (in order, bit
   for bit), the selector's groups and the engine's whole final state
   against the same run with ``device="cpu"``.  It reports events/s, ms
   a batch, the selector's host ms a batch, match and output rows a
   batch, the step kind and the launches (the probe once, no other
   kernel: ``launches_by_path.selector`` in the kernels line).
15. rate_limit_checks: small dense patterns card against CPU through
   ``SiddhiManager``: at one partition under ``output last every 1
   sec`` (the scheduler's rate task, the emit queue drained first),
   ``output first every 3 events``, ``output snapshot every 1 sec`` and
   a group-by selector with ``output all every 2 events``; an absent
   pattern under a partitioned aggregating selector; ``@purge``
   dropping the purged keys' selector state.
16. host_queries: a host-only app through ``SiddhiManager()`` with its
   default device: the verify skill's filter, a ``#window.time`` average
   and a ``#window.timeBatch`` group-by sum over 1,000,000 events in
   batches of 8,192, each lowered to ``host``, making no allocation on
   the card and giving the ``device="cpu"`` run's output; events/s are
   host figures on the card machine's host.
17. device_queries: the port's device query path through
   ``SiddhiManager()`` on the card, every app under ``@app:playback`` at
   eight events a ms, 1,000,000 events in batches of 8,192: the three
   ``host_queries`` under ``@app:execution('tpu')`` (the filter and the
   sliding average lower to ``device``, the tumbling LONG sum to
   ``host``, as in the reference); the reference harness's
   ``simple_filter``, ``filter_multi_4q``, ``sliding_window`` and
   ``groupby_length_batch_agg_only`` (``samples/performance/
   workloads.py:121-161``, 50 symbols; the last timed over its 16 held
   batches only, about 800 pane flushes a batch, its breakdown over one
   batch and its profile over a quarter batch), and
   ``partitioned_filter``, ``partitioned_double_filter``,
   ``partition_scaling`` and a keyed one-second time-window average at
   50,000 symbols (``workloads.py:163-185``; the keyed window's
   ``[65,536, 1,024]`` lanes hold about 0.9 GB on the card).  Each
   app's lowering equals its pinned reference value; the output of the
   first 16 batches equals the same batches with ``device="cpu"`` (bit
   for bit but the float32 sums, within ``rel=1e-4, abs=1e-3``) and a
   second card run bit for bit; the timed card run's output rows equal
   a count made in numpy from the events.  Each line gives events/s,
   ms a batch,
   a stage breakdown (host preparation and interning, steps, count
   fetch, column fetch, materialize) and a ``torch.profiler`` profile
   (kernels a step, the device's busy share) over 4 more batches each,
   and the state bytes on the card.  Launches are read over the timed
   card runs: ``accumulate_`` for the state scatters, no other kernel.
18. host_patterns: the host pattern engine through ``SiddhiManager()``
   on the card, three lines: (a) BASELINE config 1 (the three-state
   ``every`` sequence, ``within 1 sec``) in the default mode over
   1,000,000 events (``p ~ U(5, 30)`` float32, one event a ms, batches
   of 8,192), its rows also equal to those numpy finds in the events;
   (b) BASELINE config 2 (count_fraud) inside ``partition with (card of
   Txn)`` in the default mode, on per-key instances over 1,000 cards and
   262,144 events, then the same traffic on the dense path under
   ``@app:execution('tpu')``, whose rows must equal the instances' as
   sorted multisets (the line says whether the order agrees too); (c)
   one ``execution('tpu')`` app with a numeric pattern the dense path
   takes beside a ``symbol string`` select pattern the reference keeps
   on its host engine (lowering ``{dense, host}``, one fallback
   WARNING).  Each run's output equals the same run with
   ``device="cpu"``; the host engine and the instances make no card
   allocation and launch no kernel.  Events/s and ms a batch are host
   figures on the card machine's host; (b) gives the first batch, which
   plans every key's instance, apart.
19. host_partitions: the reference harness's partition rows
   (``workloads.py:164-186``) in the default mode: per-key instances
   over 1,000,000 cse-shaped events each (``partitioned_filter`` and
   ``partitioned_double_filter`` over 50 symbols, ``partition_scaling``
   at 10, 1,000 and 50,000), lowered to ``host``, no card allocation,
   no launch, output rows equal to a numpy count, the first 16 batches'
   output equal to the ``device="cpu"`` run's; each line gives the
   first batch (which plans the keys it meets) apart, and the
   ``device_queries`` rate of the same query beside it.
20. product: ``bench.py:257-322 bench_product``'s app and traffic: the
   capturing 16-state chain in ``partition with (key of Txn)`` at
   1,000,000 partitions, 3 warm-up batches of 131,072 stride-walked
   events (seed 11) and 3 windows of the same 10 timed batches, through
   ``SiddhiManager`` from a seeded mid-chain state restored into the
   dense runtime (so every batch matches).  (a) under ``ingest.depth=
   '2', emit.depth='auto'``; (b) at depths 1/1 in the same call, whose
   callback batches (bit for bit, in order) and ``pattern_state()``
   must equal (a)'s; (c) ``device="cpu"`` at (a)'s depths over the
   warm-up and the first 2 timed batches (the cut), held to (a)'s first
   batches.  Each prints events/s a window, the depth controllers'
   depths, transfers a batch, zero-match skips, pending and staging
   depths, overlapped batches and stalls, the interning share and the
   dense ``stats()``.  Then ``product_batch`` (d): the capture-free
   chain (``kernel_eligible_app``, the batch-step kernel's class) in
   the same partition on the same batches, at (a)'s depths and at
   ``ingest.depth='2', emit.depth='4'`` (several pending batches at
   once) against itself at 1/1, one batch step a batch.
21. auto_depths: the ``sliding_window`` device query and
   ``partition_scaling_50000`` (a per-key running count, whose state
   scatters are ``accumulate_``) at ``ingest.depth='auto',
   emit.depth='auto'`` against their depth-1 runs (every output batch
   bit for bit), and the skew-routed run at auto depths against
   phase 6's routed run (callbacks and whole state after the first
   window), with ``HotKeyRouter.stats()``.
22. scan_engine: ``compile_scan_pattern`` on the card against
   ``device="cpu"`` for ``tests/test_nfa_scan.py``'s three-node chain
   with ``within`` and a 16-node chain, over one key's seeded stream of
   65,536 events a batch, 8 batches: detections and starts equal, live
   state lanes bit-equal; events/s and one batch's kernels under
   ``torch.profiler``.
23. functions: a ``[python]`` script function and a ``FunctionExecutor``
   extension in a filter and a select under ``@app:execution('tpu')``
   over 262,144 events: the query falls back to the host with one
   WARNING, launches nothing, and gives the ``device="cpu"`` run's rows
   and numpy's count; then ``validate_siddhi_app`` and
   ``get_siddhi_app_runtimes()``.
24. joins and tables (``ROADMAP.md`` items 8 and 9), each run through
   ``SiddhiManager()`` on the card and held against the
   ``device="cpu"`` run of the same sends (rows, order, timestamps,
   value types, floats bit for bit):
   (a) ``join_stream``: the Siddhi 5.1 query guide's TempStream /
   RegulatorStream join (a one-minute time window against a length(1)
   window, on ``roomNo``) under ``@app:execution('tpu')`` at 10,000
   rooms, Temp batches of 8,192 events one a ms (temp ~ N(28, 4)) and
   Regulator batches of 2,048 over the same 8.192 s, 8 warm-up and 16
   timed turn pairs; lowered to ``device_probe``, probe calls above 0;
   (b) ``join_table``: the guide's RoomTypeTable join (10,000 rows, 10%
   server rooms, loaded by an insert query), 2 warm-up and 10 timed
   Temp batches; (c) ``table_noindex``: ``samples/performance/
   workloads.py:187-235`` verbatim, in the default mode and under
   ``execution('tpu')`` (its string condition keeps the numpy probe: 0
   probe calls); each with events/s, ms a batch, probe calls, mask
   blocks and bytes fetched a batch, a breakdown (side filters,
   windows, probe put, mask, fetch, materialization, selector; each
   piece synchronised) and the device's busy share under
   ``torch.profiler``; (d) ``join_check`` lines at about 300 events
   each: ``tests/test_device_join.py``'s shapes, a null in a numeric
   column (that batch on the numpy probe), an aggregation join with
   ``within``/``per``, a named window and a trigger feeding queries;
   and ``table_pulls``: FIND, update, delete and update or insert
   through ``rt.query`` on a table a dense pattern under
   ``execution('tpu', emit.depth='4')`` inserts into (the pull drains
   the queued emits first).  No hand-written kernel is on these paths:
   ``launches_by_path`` gives ``joins`` and ``tables`` as 0.
25. kernels: one line per ported kernel (launches on the main paths,
   largest difference from its plain version, ``ms``, ``host_us``,
   ``device_us``, plain and library times, bound); the bank kernel's at
   the entry the aggregation path uses, ``accumulate_``, with the delta
   entry's beside it; kernel 1 as ``dense_batch`` (the 1 M batch, the
   routed cold sub-batch beside it), with the packed kernel's phase-3
   line next to it; the scan kernel at the routed shape, the widest
   legal shape beside it.

An ``isolated_errors`` line comes before the kernels line; then the
card's name and power limit (nvidia-smi), and last the device line.  Any failed phase raises, so the
script exits non-zero and prints no device line; so does a machine
without a CUDA card.  An error the port isolates instead of raising (a
failing query, callback, scheduler task or emit materialize: an ERROR on
the ``siddhi_tpu_torch`` logger, or an error an app's exception
listeners hear) fails the phase that hit it.  It imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import ctypes
import gc
import json
import logging
import re
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
# the general step's headline cell: bench.py's flat_app (16 states,
# v > e1.v captures) at 1 M partitions, 2 warm-up and 10 timed batches
GEN_WARMUP = 2
GEN_STEPS = 10
# the skew-routed path's dense half (bench_hot_key's two-node chain at
# instances='8', no within): one full and four ragged collision rounds
ROUTED_STEP = (2, 8)
ROUTED_STEP_BATCHES = (2048, 1900, 333, 37, 1)

# bench.py's hot-key run (HK_* constants, bench_hot_key)
HK_KEYS = 4_096
HK_BATCH = 8_192
HK_STEPS = 8
HK_WARMUP = 2
HK_WINDOWS = 3
HK_DENSE_WINDOWS = 1  # the dense-only run is cut to one window
HK_HOT = "@app:hotkeys(k='8', promote='0.1', demote='0.04') "
# fused-scan shapes (H, n, S): the routed path's, the widest legal one,
# a ragged one, and one of four 2,048-event tiles
SCAN_SHAPES = ((8, 2048, 2), (256, 4096, 32), (3, 16, 5), (16, 8192, 3))
# part b (the general step's counts, Kleene closures and logical nodes):
# BASELINE configs 2-4 at full size, 2 warm-up and 10 timed batches each
PB_WARMUP = 2
PB_STEPS = 10
FRAUD_CARDS = 100_000
BRUTE_USERS = 1_000_000
NEWS_SYMBOLS = 10_000
TICK_BATCH = 16_384
NEWS_BATCH = 2_048
NEWS_SPAN_MS = 500
# tests/test_dense_nfa.py:14-19 and :105-110
FRAUD_APP = (
    "define stream Txn (card long, amount double); @info(name='fraud') "
    "from every a=Txn[amount > 100.0] -> b=Txn[amount > a.amount]<3:5> "
    "within 10 min select a.amount as base, b[0].amount as b0, "
    "b[last].amount as blast insert into Alerts;")
BRUTE_APP = (
    "define stream Login (user long, ok int); @info(name='bf') "
    "from every f=Login[ok == 0]<3:100> -> s=Login[ok == 1] within 1 min "
    "select f[0].ok as f0, s.ok as sk insert into Alerts;")
NEWS_APP = (
    "define stream Tick (sym long, price double); "
    "define stream News (sym long, score double); @info(name='q') "
    "from every (t=Tick[price > 10.0] and n=News[score > 0.5]) "
    "within 5 sec select t.price as p, n.score as sc insert into Alerts;")
# small part-b shapes held card against CPU (tests/
# test_dense_differential_fuzz.py:100-116, a whole-chain group-every and
# an `or` node)
PB_CHECKS = {
    "sequence_pair": (
        "every a=S[v > 10.0], b=S[v > a.v] select a.v as av, b.v as bv"),
    "non_every": "a=S[v > 10.0] -> b=S[v > a.v] select a.v as av, b.v as bv",
    "bounded_count": (
        "a=S[v > 8.0]<2:4> -> b=S[v < 4.0] within 5 sec "
        "select a[0].v as a0, b.v as bv"),
    "group_every": (
        "every (a=S[v > 8.0] -> b=S[v > a.v]) within 3 sec "
        "select a.v as av, b.v as bv"),
    "or_node": (
        "every a=S[v > 12.0] -> (b=S[v < 3.0] or c=S[u > 17.0]) "
        "within 3 sec select a.v as av, b.v as bv, c.u as cu"),
}
# absent deadlines: the Siddhi 5.1 query guide's "regulator on, room not
# cooled within the period" pattern at fleet size, in turns of a
# Regulator batch and a Temperature batch, each covering the next 8 s of
# stream time; 2 warm-up and 6 timed turn pairs (96 s, three deadlines)
ABSENT_ROOMS = 1_000_000
REG_BATCH = 4_096
TEMP_BATCH = 1 << 17
ABSENT_SPAN_MS = 8_000
ABSENT_WARMUP = 2
ABSENT_PAIRS = 6
ABSENT_WAIT_MS = 30_000
ABSENT_T0 = 1_000_000  # the first event's time (ms)
ABSENT_APP = (
    "@app:playback @app:execution('tpu', partitions='1000000', "
    "instances='4') "
    "define stream RegulatorStateChangeStream (deviceID long, roomNo int, "
    "tempSet float, action int); "
    "define stream TemperatureStream (roomNo int, temp float); "
    "partition with (roomNo of RegulatorStateChangeStream, roomNo of "
    "TemperatureStream) begin "
    "@info(name='q') from every e1=RegulatorStateChangeStream[action == 1] "
    "-> not TemperatureStream[temp <= e1.tempSet] for 30 sec "
    "select e1.roomNo as roomNo, e1.tempSet as tempSet "
    "insert into AlertStream; end;")
# small absent apps held card against CPU (about 300 events at P = 8)
ABSENT_DEFINE = ("define stream S (k long, v double); "
                 "define stream T (k long, v double); ")
ABSENT_CHECKS = {
    "mid_chain": (
        "every a=S[v > 5.0] -> not T[v > a.v] for 1 sec -> c=S[v > a.v] "
        "select a.v as av, c.v as cv"),
    "and_not": (
        "every a=S[v > 5.0] -> (b=S[v > a.v] and not T[v > 7.0]) "
        "select a.v as av, b.v as bv"),
    "and_not_for": (
        "every a=S[v > 5.0] -> (b=S[v > a.v] and not T[v > 7.0] for 1 sec) "
        "select a.v as av, b.v as bv"),
    "every_within": (
        "every a=S[v > 4.0] -> not T[v > a.v] for 1 sec -> c=S[v > 7.0] "
        "within 1500 millisec select a.k as ak, c.v as cv"),
}
# BASELINE config 2 under a per-card aggregating selector (the host query
# runtime over the dense matches): FRAUD_APP's pattern inside a partition
FRAUD_ROLLUP_APP = (
    "@app:playback @app:execution('tpu', partitions='100000') "
    "define stream Txn (card long, amount double); "
    "partition with (card of Txn) begin @info(name='fraud') "
    "from every a=Txn[amount > 100.0] -> b=Txn[amount > a.amount]<3:5> "
    "within 10 min select a.card as card, count() as alerts, "
    "max(a.amount) as top, sum(b[last].amount) as spent "
    "having alerts >= 2 insert into Alerts; end;")
# small dense patterns under rate limits and aggregating selectors, card
# against CPU (about 300 events each)
RATE_PATTERN = ("every a=S[v > 4.0] -> b=S[v > a.v] within 2 sec ")
RATE_CHECKS = {
    "output_last_every_1_sec": (
        "select a.v as av, b.v as bv output last every 1 sec"),
    "output_first_every_3_events": (
        "select a.v as av, b.v as bv output first every 3 events"),
    "output_snapshot_every_1_sec": (
        "select a.v as av, b.v as bv output snapshot every 1 sec"),
    "group_by_output_all_every_2_events": (
        "select a.k as ak, count() as n, max(b.v) as top group by a.k "
        "output all every 2 events"),
}
# host queries through SiddhiManager() on the card machine: the verify
# skill's filter, a sliding time-window average and a tumbling
# time-window group-by sum, over 1,000,000 events in batches of 8,192
HOST_EVENTS = 1_000_000
HOST_BATCH = 8_192
HOST_DEFINE = ("@app:playback define stream S (symbol string, price float, "
               "volume long); ")
HOST_QUERIES = {
    "filter": ("from S[volume < 150] select symbol, price "
               "insert into Out;"),
    "time_avg": ("from S#window.time(1 sec) select symbol, "
                 "avg(price) as avgPrice insert into Out;"),
    "time_batch_sum": ("from S#window.timeBatch(1 sec) select symbol, "
                       "sum(volume) as total group by symbol "
                       "insert into Out;"),
}
# device queries (the port's device query path through SiddhiManager,
# under @app:playback, eight events a ms): the host_queries stream under
# @app:execution('tpu'); the reference harness's single-stream and
# partitioned workloads (samples/performance/workloads.py:121-185) over
# 1,000,000 cse-shaped events (50 symbols, or 50,000 for partition
# scaling and the keyed time window); each app's lowering pinned to the
# reference's (tests/test_torch_device_query.py checks the pins against
# the JAX package)
DQ_EVENTS = 1_000_000
DQ_BATCH = 8_192
DQ_CHECK = 16  # batches held card against CPU and card against card
DQ_PROFILED = 4  # batches under torch.profiler
CSE_DEFINE = ("define stream cseEventStream (symbol string, price float, "
              "volume int, timestamp long); ")
DQ_TPU = "@app:playback @app:execution('tpu', partitions='65536') "
DQ_PARTITION = ("partition with (symbol of cseEventStream) begin {} end;")


def _dq_apps():
    apps = {}
    for label, query in HOST_QUERIES.items():
        apps["host_" + label] = (
            "@app:execution('tpu') " + HOST_DEFINE + "@info(name='q') "
            + query,
            {"q": "host" if label == "time_batch_sum" else "device"})
    single = {
        "simple_filter": ("@info(name='q0') from cseEventStream[volume < "
                          "150] select symbol, price insert into "
                          "outputStream;"),
        "filter_multi_4q": " ".join(
            f"@info(name='q{i}') from cseEventStream[volume > 90] select * "
            "insert into outputStream;" for i in range(4)),
        "sliding_window": ("@info(name='q0') from cseEventStream#window."
                           "length(10) select symbol, sum(price) as total, "
                           "avg(volume) as avgVolume, timestamp insert into "
                           "outputStream;"),
        "groupby_length_batch_agg_only": (
            "@info(name='q0') from cseEventStream#window.lengthBatch(10) "
            "select symbol, sum(price) as total, avg(volume) as avgVolume "
            "group by symbol insert into outputStream;"),
    }
    for label, body in single.items():
        names = re.findall(r"name='(q\d)'", body)
        apps[label] = (DQ_TPU + CSE_DEFINE + body,
                       {n: "device" for n in names})
    parted = {
        "partitioned_filter": ("@info(name='q0') from cseEventStream[700 > "
                               "price] select * insert into outputStream;"),
        "partitioned_double_filter": (
            "@info(name='q0') from cseEventStream[700 > price] select * "
            "insert into outputStream; @info(name='q1') from "
            "cseEventStream[price >= 700] select * insert into "
            "outputStream;"),
        "partition_scaling_50000": (
            "@info(name='q0') from cseEventStream[700 > price] select "
            "symbol, count() as c insert into outputStream;"),
        "keyed_time_avg_50000": (
            "@info(name='q0') from cseEventStream#window.time(1 sec) select "
            "symbol, avg(price) as ap insert into outputStream;"),
    }
    for label, body in parted.items():
        names = re.findall(r"name='(q\d)'", body)
        apps[label] = (DQ_TPU + CSE_DEFINE + DQ_PARTITION.format(body),
                       {n: "device" for n in names})
    return apps


# label -> (app, the reference's lowering)
DEVICE_QUERY_APPS = _dq_apps()
# the columns each app computes with float32 sums (the reference's
# rel=1e-4, abs=1e-3 between the card and the CPU); every other column
# is held bit for bit
DQ_SUM_COLUMNS = {"host_time_avg": ("avgPrice",),
                  "sliding_window": ("total", "avgVolume"),
                  "groupby_length_batch_agg_only": ("total", "avgVolume"),
                  "keyed_time_avg_50000": ("ap",)}
# the host pattern engine through SiddhiManager() on the card machine:
# BASELINE config 1 (samples/performance/baseline_configs.py:62-69) in
# the default mode over 1,000,000 events, p ~ U(5, 30) float32, one
# event a ms, batches of 8,192
HP_EVENTS = 1_000_000
HP_BATCH = 8_192
HP_CHECK = 16  # batches held card against CPU where a run is long
SEQ3_APP = (
    "@app:playback define stream T (key long, p double); @info(name='q') "
    "from every e1=T[p > 10.0], e2=T[p > e1.p], e3=T[p > e2.p] within "
    "1 sec select e1.p as p1, e3.p as p3 insert into O;")
# BASELINE config 2 (count_fraud's app and traffic) inside a partition:
# per-key instances in the default mode, 1,000 cards (the middle size of
# the reference's PartitionPerformance.java), 262,144 events; then the
# same traffic on the dense path
FRAUD_KEYS = 1_000
FRAUD_EVENTS = 1 << 18
FRAUD_PART_APP = (
    "@app:playback {}define stream Txn (card long, amount double); "
    "partition with (card of Txn) begin @info(name='fraud') "
    "from every a=Txn[amount > 100.0] -> b=Txn[amount > a.amount]<3:5> "
    "within 10 min select a.card as card, a.amount as base, "
    "b[0].amount as b0, b[last].amount as blast insert into Alerts; end;")
FRAUD_DENSE = "@app:execution('tpu', partitions='1024', instances='128') "
# one execution('tpu') app: a numeric pattern the dense path takes beside
# a `symbol string` select pattern of tests/test_conformance_patterns2.py
# (ComplexPatternTestCase.testQuery6) that the reference sends to its
# host engine: lowering {dense, host}, one fallback WARNING
MIXED_APP = (
    "@app:playback @app:execution('tpu') "
    "define stream Stream1 (symbol string, price float, volume int); "
    "define stream Stream2 (symbol string, price float, volume int); "
    "@info(name='dense') from every e1=Stream1[price > 28.0] -> "
    "e2=Stream2[price > e1.price] within 50 millisec select e1.price as "
    "p1, e2.price as p2 insert into OutputStream; "
    "@info(name='q') from every e1=Stream1 -> "
    "e2=Stream2[e1.symbol != 'AMBA']<2:> -> e3=Stream2[volume <= 70] "
    "select e3.symbol as symbol1, e2[0].symbol as symbol2, "
    "e3.volume as volume3 insert into OutputStream;")
MIXED_EVENTS = 2_048
MIXED_BATCH = 64
# the reference harness's host partition rows (samples/performance/
# workloads.py:164-186) in the default mode: per-key instances over
# 1,000,000 cse-shaped events each, batches of 8,192
# (the device_queries apps without execution('tpu')): label -> (symbols,
# app, the device_queries label of the same query)
HOST_PARTITION_APPS = {
    label: (n, DEVICE_QUERY_APPS[dq][0].replace(DQ_TPU, "@app:playback "),
            dq)
    for label, n, dq in (
        ("partitioned_filter", 50, "partitioned_filter"),
        ("partitioned_double_filter", 50, "partitioned_double_filter"),
        ("partition_scaling_10", 10, "partition_scaling_50000"),
        ("partition_scaling_1000", 1_000, "partition_scaling_50000"),
        ("partition_scaling_50000", 50_000, "partition_scaling_50000"))}
# a dependent operation waits at least 4 cycles for the one before it
DEP_LATENCY_CYCLES = 4
# the batch step's per-event dependent chain, per node: read the node's
# activity, fire, place into the next node, write it back (the next
# event reads what this one wrote)
BATCH_DEP_OPS = 4
# batch-step edge cases (S, I, N, P, within, events on one partition):
# one event, 16 lanes at 32 nodes, the shared-memory ceiling (32 nodes
# by 32 lanes), 32 lanes with a long segment, ragged lanes with a short
# horizon
BATCH_EDGE_CASES = ((2, 8, 1, 16, None, 0), (32, 16, 2048, 512, 3000, 40),
                    (32, 32, 2048, 512, 3000, 40),
                    (4, 32, 8192, 1024, None, 300),
                    (3, 7, 3000, 300, 50, 100))
# what the kernels line gives for each kernel, from its path-shape line
KERNEL_KEYS = ("ms", "host_us", "device_us", "plain_ms", "bound_ms",
               "bound_by", "library_ms")

# the aggregation path: bench.py's bank sizes (PK_BANK_ROWS,
# PK_BANK_EVENTS) under the docs app, Zipf(1.2) symbols as bench.py:720
AGG_SYMBOLS = 2_048
AGG_BATCH = 1 << 15
AGG_WARMUP = 2
AGG_STEPS = 8
AGG_WINDOWS = 3
AGG_BASE = 1_496_289_777_000  # 2017-06-01 04:02:57 UTC
AGG_PER = ("seconds", "minutes")
BANK_R_PAD = 4_352  # pad_rows(cap + 1) for the bank's 4,096 rows
BANK_WORST_ROWS = 4_096  # bench_pallas_bank: every event on row 0
BANK_ROWS = 4_097  # the bank's accumulator rows: cap + 1 (the dump row)
TRADE_DEFINE = ("define stream TradeStream (symbol string, price double, "
                "volume long, timestamp long); ")
TRADE_SELECT = {
    "docs": "symbol, avg(price) as avgPrice, sum(price) as total",
    "wide": ("symbol, avg(price) as avgPrice, sum(price) as total, "
             "sum(volume) as vol, min(price) as lo, max(price) as hi, "
             "min(volume) as vlo, max(volume) as vhi, count() as n"),
}


class IsolatedErrors(logging.Handler):
    """What the port isolates instead of raising.  A failing query,
    callback, scheduler task or emit materialize logs an ERROR on the
    ``siddhi_tpu_torch`` logger and goes on; the apps' exception
    listeners (``new_app``) hear it.  A WARNING the port also hands to
    the listeners (pattern instances dropped at the lane capacity, as in
    the reference) is counted, not fatal.  ``emit`` checks before every
    line, so a phase that hit an isolated error fails and prints no
    result."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.errors, self.heard, self.warned = [], [], set()
        self.warnings = 0
        # WARNINGs of a fallback from a device path to the host
        self.fallbacks = 0

    def emit(self, record):
        if record.levelno >= logging.ERROR:
            self.errors.append(record.getMessage())
        else:
            self.warned.add(record.getMessage())
            self.warnings += 1
            self.fallbacks += "unavailable (" in record.getMessage()

    def listener(self, e: Exception):
        self.heard.append(e)

    def check(self, where) -> None:
        errors = self.errors + [f"{type(e).__name__}: {e}"
                                for e in self.heard
                                if str(e) not in self.warned]
        self.errors, self.heard = [], []
        if errors:
            raise AssertionError(f"{where}: {len(errors)} isolated "
                                 f"error(s), the first {errors[:3]}")


ISOLATED = IsolatedErrors()


def new_app(mgr, app: str):
    """``mgr``'s runtime of ``app``, its exception listeners feeding
    ISOLATED."""
    rt = mgr.create_siddhi_app_runtime(app)
    rt.add_exception_listener(ISOLATED.listener)
    return rt


def emit(obj) -> None:
    ISOLATED.check(obj.get("phase", "kernels") if isinstance(obj, dict)
                   else "output")
    print(json.dumps(obj), flush=True)


def card_line(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
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


def flat_app(n_states: int = N_STATES) -> str:
    """bench.py's flat_app (``pattern_query``): the headline chain, whose
    filters and select read the capture ``e1.v``."""
    states = ["every e1=Txn[v > 0.0]"]
    for i in range(2, n_states + 1):
        states.append(f"e{i}=Txn[v > {float(i - 1)} and v > e1.v]")
    return ("define stream Txn (key long, v double); "
            f"@info(name='bench') from {' -> '.join(states)} within 10 min "
            f"select e1.v as v1, e{n_states}.v as v{n_states} "
            "insert into Alerts;")


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


def call_times(torch, fn, reps: int = 200, profiled: int = 50) -> dict:
    """One call's times: ``ms`` from CUDA events and ``host_us`` from
    ``time.perf_counter`` over the same ``reps`` back-to-back calls with
    one synchronise at the end; ``device_us``, the device time per call
    of every device op the calls ran, under ``torch.profiler`` over
    ``profiled`` more calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    device = []
    for _ in range(3):  # a profiled pass now and then records no device op
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(profiled):
                fn()
            torch.cuda.synchronize()
        device = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if device:
            break
    return {"ms": start.elapsed_time(end) / reps,
            "host_us": 1e6 * host_s / reps,
            "device_us": sum(device) / profiled if device else "not measured"}


def host_us(fn, reps: int = 2000) -> float:
    """Host µs of one call of ``fn``, over ``reps`` calls (host work
    only: no synchronise)."""
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e6 * (time.perf_counter() - t) / reps


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
    older than ``within`` (WITHIN_MS where the step has none); 60% of
    lanes busy so placement overflows."""
    rng = np.random.default_rng(seed)
    within = WITHIN_MS if within is None else within
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


def batch_step_bound(S, I, N, K, longest, sm_clock_hz) -> dict:
    """Least time for one batch step on this run's inputs: every state
    row of the batch read and written once, and per event its ts, order,
    ok flags, emit row and anchor row, and the segment arrays, over HBM;
    its int32 work at the CUDA cores' peak; and the serial chain, the
    longest segment's events one after another, BATCH_DEP_OPS dependent
    operations a node of DEP_LATENCY_CYCLES each at the top SM clock."""
    row = S * I + 4 * S * I + 4  # activity, anchors, overflow
    bytes_ = 2 * K * row + N * (4 + 4 + S + 2 * I + 8 * I) + 8 * K + 8
    ops = 16 * N * S * I  # as packed_step_bound_ms counts them
    terms = {"bytes_ms": 1e3 * bytes_ / HBM_BYTES_PER_S,
             "operations_at_peak_ms": 1e3 * ops / CUDA_CORE_OPS_PER_S,
             "serial_chain_ms": 1e3 * longest * S * BATCH_DEP_OPS
                                * DEP_LATENCY_CYCLES / sm_clock_hz}
    top = max(terms.values())
    return {"bound_ms": top, "bound_terms": terms, "bytes": bytes_,
            "bound_by": "bytes" if terms["bytes_ms"] == top else "operations"}


def capture_batch_step(run) -> dict:
    """Clones of the inputs of the first ``batch_step`` call that
    ``run()`` makes through the dense engine, taken at the kernel's
    boundary before the call (the state before it is stepped in place).
    The call itself goes ahead unchanged."""
    from siddhi_tpu_torch.ops import dense_nfa

    real = dense_nfa.batch_step
    got = {}

    def record(state, *args, **kw):
        if not got:
            got["state"] = {k: state[k].clone()
                            for k in ("active", "first_ts", "overflow")}
            got["args"] = [a.clone() for a in args]
            got["kw"] = dict(kw)
        return real(state, *args, **kw)

    dense_nfa.batch_step = record
    try:
        run()
    finally:
        dense_nfa.batch_step = real
    if not got:
        raise AssertionError("the run made no batch_step call to capture")
    return got


def batch_step_case(torch, S, I, N, P, within, seed, device, long_seg=0):
    """Seeded batch-step inputs for the edge cases: a mid-chain state,
    Zipf(1.2) partitions (``long_seg`` events on partition 0), ok flags
    and ascending ts; in ``capture_batch_step``'s form."""
    from siddhi_tpu_torch.ops.dense_nfa import partition_segments

    rng = np.random.default_rng(seed)
    w = within or WITHIN_MS
    now = 5_000_000
    active = rng.random((P + 1, S, I)) < 0.3
    age = rng.integers(0, w + w // 4, (P + 1, S, I))
    first = np.where(active, now - age, 0).astype(np.int32)
    part = 1 + (rng.zipf(1.2, N) - 1) % (P - 1)
    part[rng.choice(N, long_seg, replace=False)] = 0
    ok = rng.random((N, S)) < 0.5
    ts = (now + np.sort(rng.integers(0, w // 2, N))).astype(np.int32)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"state": {"active": as_t(active), "first_ts": as_t(first),
                      "overflow": as_t(rng.integers(0, 5, P + 1).astype(
                          np.int32))},
            "args": [as_t(a) for a in partition_segments(
                part.astype(np.int32))] + [as_t(ok), as_t(ts)],
            "kw": {"n_inst": I, "within": within}}


def hold_batch_step(torch, dense_batch, case, label, sm_clock_hz,
                    plain_reps=0):
    """The batch-step kernel against its plain version on one case, both
    on the card, each on its own clone of the state: emits, anchors,
    n_emit and the in-place state bit-exact, and a second launch the same
    bits.  With ``plain_reps``, times the kernel (on a clone that keeps
    stepping) and the plain version, and works out the bound."""
    st0, args, kw = case["state"], case["args"], case["kw"]
    I, within = kw["n_inst"], kw["within"]
    st = [{k: v.clone() for k, v in st0.items()} for _ in range(3)]
    got = dense_batch.batch_step(st[0], *args, **kw)
    again = dense_batch.batch_step(st[1], *args, **kw)
    want = dense_batch.batch_step_plain(st[2], *args, I, within)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [*got, *(st[0][k] for k in st0)],
                      [*want, *(st[2][k] for k in st0)])
    same = all(torch.equal(a, g) for a, g in zip(
        [*again, *(st[1][k] for k in st0)], [*got, *(st[0][k] for k in st0)]))
    if err or not same:
        raise AssertionError(f"dense_batch kernel differs from its plain "
                             f"version or from itself ({label}): max |diff| "
                             f"{err}, deterministic {same}")
    _order, seg_start, seg_part, ok, ts = args
    N, K, S = ts.numel(), seg_part.numel(), ok.shape[1]
    longest = int((seg_start[1:] - seg_start[:-1]).max())
    line = {"phase": "dense_batch", "case": label, "S": S, "I": I,
            "within": within, "partitions": st0["overflow"].numel() - 1,
            "N": N, "segments": K, "longest_segment": longest,
            "bit_exact": True, "deterministic": True, "max_abs_err": err,
            "n_emit": int(want[2]),
            "overflow_added": int((st[2]["overflow"]
                                   - st0["overflow"]).sum())}
    if plain_reps:
        line.update(
            **call_times(torch, lambda: dense_batch.batch_step(
                st[0], *args, **kw), 50, 10),
            plain_ms=time_ms(torch, lambda: dense_batch.batch_step_plain(
                st[2], *args, I, within), plain_reps, warmup=1),
            library_ms=None,
            **batch_step_bound(S, I, N, K, longest, sm_clock_hz))
    return line


def mid_chain_state(engine, seed, within_ms=WITHIN_MS, reg_draw=None):
    """Seeded mid-chain state: ~30% of (partition, node, lane) active,
    anchors spread over the last ``within_ms`` (a few expire per batch),
    at a count node a capture count below its min (so a batch's
    captures satisfy and emit), at a logical node one side of two
    matched, and, where the engine has registers, captures in every
    lane (free lanes keep stale values, as in the reference):
    ``reg_draw(rng, shape)``, else ~ U(0, 20)."""
    rng = np.random.default_rng(seed)
    state = engine.init_state_host()
    shape = state["active"].shape
    active = rng.random(shape) < 0.3
    active[-1] = False  # scratch row
    first = np.where(active, rng.integers(1, within_ms + 1, shape), 0)
    counts = np.zeros(shape, np.int32)
    for s, node in enumerate(engine.nodes):
        if node.kind == "logical":
            counts[:, s] = 1 << rng.integers(0, len(node.specs),
                                             (shape[0], shape[2]))
        elif not (node.min_count == 1 and node.max_count == 1):
            counts[:, s] = rng.integers(1, max(node.min_count, 2),
                                        (shape[0], shape[2]))
    state["active"] = active | state["active"]
    state["first_ts"] = first.astype(np.int32)
    state["counts"] = np.where(active, counts, 0).astype(np.int32)
    if engine.alloc.n:
        shape_r = state["regs"].shape
        state["regs"] = (rng.uniform(0.0, 20.0, shape_r) if reg_draw is None
                         else reg_draw(rng, shape_r)).astype(np.float32)
    if "iregs" in state:
        state["iregs"] = rng.integers(-2, 2, state["iregs"].shape,
                                      dtype=np.int32)
    # base so the first batch (ts = 1000) sits within_ms after rel 0
    return state, 1000 - within_ms


def e2e_batch(rng, i):
    part = ((np.arange(BATCH, dtype=np.int64) * 524287 + i * BATCH)
            % N_PARTITIONS).astype(np.int32)
    v = rng.uniform(0.0, float(N_STATES + 4), BATCH).astype(np.float32)
    ts = np.full(BATCH, 1_000 + i * 10, dtype=np.int64)
    return part, {"key": part.astype(np.int64), "v": v}, ts


def batch_breakdown(torch, eng, state, batches, n=4, phase="breakdown"):
    """Where one batch's time goes, on batches after the checked ones
    (``batches``: 2n of (stream, part, cols, ts)): host-clock ms of each
    stage of ``process`` over the first n (each ended by a
    synchronise), then the last n under ``torch.profiler`` for the
    device's busy time and its largest kernels.  Timing only: launch
    counts were read before, and the results are not compared."""
    from siddhi_tpu_torch.core.emit_queue import fetch_coalesced
    from siddhi_tpu_torch.ops.dense_nfa import _round_order, partition_segments

    stages = {"host_prep_ms": [], "step_ms": [], "count_ms": [],
              "fetch_ms": [], "materialize_ms": []}
    # host share of the step stage: the batch step's sort by partition,
    # or the general step's collision rounds; and the lane columns
    split = (partition_segments if eng.step_kind == "batch"
             else _round_order)
    for stream, part, cols, ts in batches[:n]:
        t = time.perf_counter()
        split(part)
        eng.prepare_cols(stream, cols)
        stages["host_prep_ms"].append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, pending = eng.process_deferred(state, stream, part, cols, ts)
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

    def run_rest():
        nonlocal state
        for stream, part, cols, ts in batches[n:]:
            state, _ev, _out = eng.process(state, stream, part, cols, ts)

    return {"phase": phase, "batches": n,
            **{k: sorted(v)[len(v) // 2] for k, v in stages.items()},
            **device_profile(torch, run_rest)}


def step_device_ops(torch, eng, state, batch) -> dict:
    """Device items of one batch's general steps under
    ``torch.profiler`` (``batch``: stream, part, cols, ts): one
    ``make_general_step`` call a collision round, so the kernels a step
    are the batch's kernels over its rounds; the copies beside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        state, pending = eng.process_deferred(state, *batch)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    rounds = len(pending.chunks)
    kernels = len(dev) - len(copies)
    device_us = sum(e.time_range.elapsed_us() for e in dev)
    return {"rounds": rounds, "kernels_per_step": kernels / rounds,
            "copies_per_step": len(copies) / rounds,
            "device_us_per_step": device_us / rounds,
            "kernels_per_batch": kernels, "device_us_per_batch": device_us}


def card_vs_cpu(torch, compile_pattern, state_to_numpy, app, P, n_inst,
                batches, label) -> dict:
    """``batches`` through ``compile_pattern(app)`` on the card and on the
    CPU: matches, output bits and the whole state must be equal.  The
    card's host-clock seconds (synchronised) and the match count."""
    eng = {d: compile_pattern(app, "q", n_partitions=P, n_instances=n_inst,
                              device=d) for d in ("cuda", "cpu")}
    state = {d: e.init_state() for d, e in eng.items()}
    res = {d: [] for d in eng}
    secs = 0.0
    for part, cols, ts in batches:
        for d, e in eng.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            state[d], ev, out = e.process(state[d], "S", part, cols, ts)
            torch.cuda.synchronize()
            if d == "cuda":
                secs += time.perf_counter() - t
            res[d].append((ev, out))
    n = 0
    for (cev, cout), (pev, pout) in zip(res["cuda"], res["cpu"]):
        if not (np.array_equal(cev, pev) and out_bits(cout) == out_bits(pout)):
            raise AssertionError(f"{label}: matches differ between the card "
                                 "and the CPU run")
        n += len(pev)
    card, _ = state_to_numpy(eng["cuda"], state["cuda"])
    cpu, _ = state_to_numpy(eng["cpu"], state["cpu"])
    bad = [k for k in cpu if not np.array_equal(card[k].view(np.uint8),
                                                cpu[k].view(np.uint8))]
    if bad or n == 0:
        raise AssertionError(f"{label}: state {bad} differs between the "
                             f"card and the CPU run, or no match ({n})")
    return {"case": label, "step_kind": eng["cuda"].step_kind,
            "partitions": P, "instances": n_inst,
            "events": sum(len(b[0]) for b in batches), "matches": n,
            "bit_exact_state": sorted(cpu), "card_seconds": secs}


def out_bits(out):
    """A match matrix as comparable bits (float32 words, or per-value
    bits of an object matrix with integer lanes)."""
    if out.dtype == object:
        return [[np.float64(x).tobytes() if isinstance(x, float) else int(x)
                 for x in row] for row in out.tolist()]
    return out.view(np.int32).tolist()


def small_batches(seed, n_batches, B, P, v_high=20.0):
    """Seeded ``S (k long, u double, v double)`` batches: colliding
    partitions (several collision rounds), ascending times."""
    rng = np.random.default_rng(seed)
    out, t = [], 1000
    for _ in range(n_batches):
        part = rng.integers(0, P, B).astype(np.int32)
        cols = {"k": rng.integers(0, 3, B), "u": rng.uniform(0, 20, B),
                "v": rng.uniform(0, v_high, B)}
        ts = t + np.sort(rng.integers(0, 900, B))
        t = int(ts[-1])
        out.append((part, cols, ts))
    return out


def unpartitioned_card_vs_cpu(torch, SiddhiManager, n_events=300) -> dict:
    """An unpartitioned capturing pattern (one partition, a collision
    round an event) through ``SiddhiManager`` on the card and the CPU."""
    app = ("@app:playback @app:execution('tpu') "
           "define stream S (k long, u double, v double); "
           "@info(name='q') from every a=S[v > 10.0] -> b=S[v > a.v] "
           "within 3 sec select a.v as av, b.v as bv insert into Alerts;")
    rng = np.random.default_rng(8)
    sends = [([int(rng.integers(0, 3)), float(rng.uniform(0, 20)),
               float(rng.uniform(0, 20))], 1000 + 37 * i)
             for i in range(n_events)]
    rows, secs, kinds = {}, {}, {}
    for d in ("cuda", "cpu"):
        mgr = SiddhiManager(device=d)
        rt = new_app(mgr, app)
        got = []
        rt.add_callback("Alerts", lambda evs, got=got: got.extend(
            (e.timestamp, list(e.data)) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        torch.cuda.synchronize()
        t = time.perf_counter()
        for row, ts in sends:
            h.send(row, timestamp=ts)
        rt.drain()
        torch.cuda.synchronize()
        secs[d] = time.perf_counter() - t
        kinds[d] = rt.lowering(step_kinds=True)
        partitions = rt.pattern_runtimes()["q"].engine.n_partitions
        rt.shutdown()
        mgr.shutdown()
        rows[d] = got
    if rows["cuda"] != rows["cpu"] or not rows["cpu"] or partitions != 1:
        raise AssertionError("unpartitioned capture app: card rows differ "
                             "from the CPU run's, or none")
    return {"case": "unpartitioned capture", "lowering": kinds["cuda"],
            "partitions": partitions, "events": n_events,
            "matches": len(rows["cpu"]), "card_seconds": secs["cuda"],
            "cpu_seconds": secs["cpu"]}


def device_profile(torch, run) -> dict:
    """Wall ms of ``run()`` under ``torch.profiler`` (synchronised at both
    ends), the device's busy ms and share in it, and its largest device
    items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
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
    return {"profiled_wall_ms": wall_ms,
            "device_busy_ms": device_ms if by_name else "not measured",
            "device_busy_share": device_ms / wall_ms if by_name else None,
            "top_device_ops_ms": [[k[:90], ms, c] for k, (ms, c) in top]}


def scan_inputs(torch, H, n, S, seed, device):
    """Seeded fused-scan inputs: 0/1 filter rows with all-zero padding
    rows past each slot's real events, ``v`` a mix of live starts and
    NEG (lane 0 the constant 0), integer-valued counts."""
    from siddhi_tpu_torch.kernels.scan_chain import NEG

    rng = np.random.default_rng(seed)
    F = (rng.random((H, n, S + 1)) < 0.55).astype(np.float32)
    for h, k in enumerate(rng.integers(1, n + 1, H)):
        F[h, k:] = 0.0
    ts = np.sort(rng.integers(1, 1 << 20, (H, n)), axis=1).astype(np.float32)
    live = rng.random((H, S)) < 0.6
    v = np.where(live, rng.integers(-5000, 100_000, (H, S)),
                 np.float32(NEG)).astype(np.float32)
    c = np.where(live, rng.integers(1, 100, (H, S)), 0).astype(np.float32)
    v[:, 0] = 0.0
    c[:, 0] = 1.0
    return [torch.from_numpy(a).to(device) for a in (F, ts, v, c)]


def scan_bound(H, n, S) -> dict:
    """Least time for one fused scan: every input read and output written
    once over HBM, or its float32 operations at the CUDA cores' peak,
    whichever is larger.  The recurrence is a scan, so no chain of n
    dependent steps bounds it."""
    bytes_ = 4 * (H * n * (S + 1) + H * n + 2 * H * S + 2 * H * S + H * n)
    # per event and lane: 3 compares, 2 adds, 5 selects, 2 max
    ops = 12 * H * n * S
    terms = {"bytes_ms": 1e3 * bytes_ / HBM_BYTES_PER_S,
             "operations_at_peak_ms": 1e3 * ops / CUDA_CORE_OPS_PER_S}
    top = max(terms.values())
    return {"bound_ms": top, "bound_terms": terms, "bytes": bytes_,
            "bound_by": "bytes" if terms["bytes_ms"] == top else "operations"}


def bits_equal(torch, got, want) -> bool:
    return all(g.shape == w.shape and g.dtype == w.dtype == torch.float32
               and torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


def hot_key_app(hot: bool, depths: str = "") -> str:
    """bench.py's bench_hot_key app, verbatim, plus @app:kernels (and
    ``depths``, an ``@app:execution`` option tail)."""
    return ("@app:name('hkbench{tag}') @app:playback "
            "@app:execution('tpu', instances='8'{depths}) {hot}"
            "@app:kernels('nfa,scan') "
            "define stream S (k long, u double, v double); "
            "partition with (k of S) begin "
            "@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0] "
            "select b.v as bv insert into Alerts; end;").format(
                tag="H" if hot else "D", hot=HK_HOT if hot else "",
                depths=", " + depths if depths else "")


def hot_key_batches(EventBatch):
    """bench.py's bench_hot_key traffic: seed 23, Zipf(1.2) keys."""
    rng = np.random.default_rng(23)
    out = []
    for i in range(HK_WARMUP + HK_STEPS):
        ks = (rng.zipf(1.2, HK_BATCH) - 1) % HK_KEYS
        u = rng.uniform(0.0, 20.0, HK_BATCH)
        v = rng.uniform(0.0, 20.0, HK_BATCH)
        ts = np.full(HK_BATCH, 1_000 + i * 10, dtype=np.int64)
        out.append(EventBatch("S", ["k", "u", "v"],
                              {"k": ks.astype(np.int64), "u": u, "v": v}, ts))
    return out


def routed_state(rt) -> dict:
    """Host copy of the routed query's whole state: the dense runtime's
    own snapshot tree (instance lanes, anchors, overflow, key rows, row
    clock, time base) and the router's scan slots ``v``/``c``, key-to-slot
    map, scan time base and sketch.  Reads only: the router's snapshot
    demotes every hot key first, so it is not taken mid-run."""
    from siddhi_tpu_torch.core.emit_queue import fetch_coalesced

    q = rt.pattern_runtimes()["q"]
    tree = q._dense.snapshot()
    v, c = fetch_coalesced([q._state["v"], q._state["c"]])
    tree.update(scan_v=v, scan_c=c, scan_base_ts=q._scan.base_ts,
                slots={k: dict(r) for k, r in q._slots.items()},
                sketch_counts=dict(q.sketch.counts),
                sketch_total=q.sketch.total)
    return tree


def tree_diff(a, b, path="") -> list:
    """Paths where two state trees differ; arrays compare by dtype, shape
    and bytes, so float lanes must be bit-exact."""
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [f"{path}: keys {sorted(a.keys() ^ b.keys(), key=repr)}"]
        return [d for k in a for d in tree_diff(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        same = (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
        return [] if same else [path]
    return [] if a == b else [path]


def run_hot_key(torch, SiddhiManager, EventBatch, bs, device, hot,
                windows, keep_cycles, depths=""):
    """bench_hot_key's run(): warm-up batches, then ``windows`` windows
    of the steady batches re-offset by (w+1)*1e6 ms, each drained (and
    synchronised on a card).  Keeps the callbacks of the first
    ``keep_cycles`` batches and counts rows per batch; a routed run also
    keeps its query's whole state after the first window.  Returns the
    still-running app and what it measured."""
    mgr = SiddhiManager(device=device)
    rt = new_app(mgr, hot_key_app(hot, depths))
    rows, kept = [], []

    def cb(evs):
        rows[-1] += len(evs)
        if len(rows) <= keep_cycles:
            kept.append(evs)

    rt.add_callback("Alerts", cb)
    rt.start()
    h = rt.get_input_handler("S")
    for b in bs[:HK_WARMUP]:
        rows.append(0)
        h.send_batch(b)
    window_s, overflow, state = [], None, None
    for w in range(windows):
        if device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        for b in bs[HK_WARMUP:]:
            rows.append(0)
            h.send_batch(EventBatch(b.stream_id, b.attribute_names,
                                    b.columns,
                                    b.timestamps + (w + 1) * 1_000_000,
                                    b.types))
        rt.drain()
        if device == "cuda":
            torch.cuda.synchronize()
        window_s.append(time.perf_counter() - t)
        if w == 0:
            # pending instances dropped at the instance-lane capacity
            # over the warm-up and the first window
            overflow = rt.pattern_runtimes()["q"].overflow_total()
            state = routed_state(rt) if hot else None
    return mgr, rt, {"window_s": window_s, "rows": rows, "kept": kept,
                     "overflow": overflow, "state": state}


def routed_breakdown(torch, rt, bs, EventBatch, n=3):
    """Where a routed batch's time goes, on batches after the checked
    windows (re-offset past them): host-clock ms of the dense step
    (the cold sub-batch: sort, put, filter matrix, one batch step), the
    scan cycle (pack, put, scan, count gate, emit) and the rest (sketch,
    routing masks, interning, handoffs), each ended by a synchronise,
    with the cold sub-batch's longest segment (the collision rounds the
    reference would step); then one more batch under ``torch.profiler``."""
    from siddhi_tpu_torch.kernels import dense_batch, scan_chain

    router = rt.pattern_runtimes()["q"]
    dense = router._dense
    h = rt.get_input_handler("S")
    rec = {"batch_ms": [], "dense_ms": [], "scan_ms": [],
           "longest_segment": []}
    # the stages are timed by shadowing two methods on the instances; a
    # renamed method would leave its stage reading 0 with no error
    for obj, meth in ((dense, "process_stream_batch"),
                      (router, "_process_hot")):
        if not callable(type(obj).__dict__.get(meth)):
            raise AssertionError(f"{type(obj).__name__}.{meth} is gone; "
                                 "the routed breakdown cannot time it")
    launched = (dense_batch.batch_step.launches,
                scan_chain.fused_scan.launches)

    def timed(fn, key, segments=False):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            rec[key][-1] += 1e3 * (time.perf_counter() - t)
            if segments:
                rec["longest_segment"][-1] = int(
                    np.unique(args[2], return_counts=True)[1].max())
        return run

    dense.process_stream_batch = timed(dense.process_stream_batch,
                                       "dense_ms", segments=True)
    router._process_hot = timed(router._process_hot, "scan_ms")
    try:
        for i, b in enumerate(bs[HK_WARMUP:HK_WARMUP + n]):
            for k in rec:
                rec[k].append(0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            h.send_batch(EventBatch(
                b.stream_id, b.attribute_names, b.columns,
                b.timestamps + (HK_WINDOWS + 1) * 1_000_000 + 10 * i,
                b.types))
            torch.cuda.synchronize()
            rec["batch_ms"][-1] = 1e3 * (time.perf_counter() - t)
    finally:
        del dense.process_stream_batch
        del router._process_hot
    steps = dense_batch.batch_step.launches - launched[0]
    scans = scan_chain.fused_scan.launches - launched[1]
    if ((steps and not sum(rec["dense_ms"]))
            or (scans and not sum(rec["scan_ms"]))):
        raise AssertionError(f"routed breakdown timed no dense or scan stage "
                             f"while they launched ({steps}, {scans}): {rec}")
    rec["route_ms"] = [b - d - s for b, d, s in
                       zip(rec["batch_ms"], rec["dense_ms"], rec["scan_ms"])]
    last = bs[HK_WARMUP + n]
    prof = device_profile(torch, lambda: h.send_batch(EventBatch(
        last.stream_id, last.attribute_names, last.columns,
        last.timestamps + (HK_WINDOWS + 2) * 1_000_000, last.types)))
    return {"phase": "routed_breakdown", "batches": n, **rec, **prof}


def bank_cases(torch, device):
    """Seeded segmented-reduce inputs: (label, rows, vals, r_pad, op,
    identity).  At the aggregation path's shape a batch that crosses a
    second holds its 2,048 Zipf symbols twice (rows sym and 2,048 + sym;
    the dump row 4,096 stays empty), one case per lane kind the bank
    uses; then bench_pallas_bank's worst case and a ragged 256."""
    from siddhi_tpu_torch.kernels.bank_scatter import pad_rows

    rng = np.random.default_rng(29)
    n = AGG_BATCH
    sym = (rng.zipf(1.2, n) - 1) % AGG_SYMBOLS
    rows = (sym + AGG_SYMBOLS * (np.arange(n) >= n // 2)).astype(np.int32)
    price = rng.uniform(1.0, 500.0, n).astype(np.float32)
    lo = (rng.integers(1, 10_000, n) & 0xFFFF).astype(np.int32)  # LONG-sum lo
    i32 = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    i32_max, i32_min = int(np.iinfo(np.int32).max), int(np.iinfo(np.int32).min)
    cases = [
        ("path f32 sum", rows, price, BANK_R_PAD, "sum", 0.0),
        ("path count", rows, np.ones(n, np.float32), BANK_R_PAD, "count", 0.0),
        ("path f32 min", rows, price, BANK_R_PAD, "min", float("inf")),
        ("path f32 max", rows, price, BANK_R_PAD, "max", float("-inf")),
        ("path i32 sum", rows, lo, BANK_R_PAD, "sum", 0),
        ("path i32 min", rows, i32, BANK_R_PAD, "min", i32_max),
        ("path i32 max", rows, i32, BANK_R_PAD, "max", i32_min),
    ]
    hot = np.zeros(n, dtype=np.int32)
    hot_v = np.random.default_rng(5).integers(0, 100, n).astype(np.int32)
    r_hot = pad_rows(BANK_WORST_ROWS)
    cases += [("row0 i32 sum", hot, hot_v, r_hot, "sum", 0),
              ("row0 f32 sum", hot, hot_v.astype(np.float32), r_hot, "sum",
               0.0)]
    r_rag = np.full(256, AGG_SYMBOLS * 2, dtype=np.int32)  # dump-row padding
    r_rag[:190] = rows[:190]
    v_rag = np.zeros(256, dtype=np.float32)
    v_rag[:190] = price[:190]
    m_rag = np.full(256, i32_min, dtype=np.int32)
    m_rag[:190] = i32[:190]
    cases += [("ragged f32 sum", r_rag, v_rag, BANK_R_PAD, "sum", 0.0),
              ("ragged i32 max", r_rag, m_rag, BANK_R_PAD, "max", i32_min)]
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return [(lbl, as_t(r), as_t(v), rp, op, ident)
            for lbl, r, v, rp, op, ident in cases]


def bank_bound(n_pad, rows, accumulate=False) -> dict:
    """Least time for one call: rows and values read once, and the delta
    written once (``segmented_reduce``) or the accumulator read and
    written once (``accumulate_``), over HBM; one select and one combine
    per event on the CUDA cores.  The larger bounds (the bytes)."""
    bytes_ = 8 * n_pad + (8 if accumulate else 4) * rows
    terms = {"bytes_ms": 1e3 * bytes_ / HBM_BYTES_PER_S,
             "operations_at_peak_ms": 1e3 * 2 * n_pad / CUDA_CORE_OPS_PER_S}
    return {"bound_ms": max(terms.values()), "bound_terms": terms,
            "bound_by": ("bytes" if terms["bytes_ms"] >= terms[
                "operations_at_peak_ms"] else "operations")}


def bank_diff(torch, got, want, rows, vals, op, label, acc0) -> float:
    """Largest |got - want| of a bank kernel call against its plain
    version; raises unless every row is bit-exact, or, for float32 sums,
    within n * 2^-24 * sum|v| (and, where it accumulated into ``acc0``,
    one rounding of the final add on each side, 2^-24 of each result)."""
    diff = torch.where(got == want, 0.0, (got.double() - want.double()).abs())
    if op == "sum" and vals.dtype == torch.float32:
        idx = rows.long()
        n_r = torch.zeros(got.numel(), dtype=torch.float64, device=got.device)
        n_r.index_add_(0, idx, torch.ones(idx.shape, dtype=torch.float64,
                                          device=got.device))
        abs_r = torch.zeros_like(n_r).index_add_(0, idx, vals.double().abs())
        bound = n_r * 2.0**-24 * abs_r
        if acc0 is not None:
            bound += 2.0**-24 * (got.double().abs() + want.double().abs())
        if bool((diff > bound).any()):
            raise AssertionError(f"bank_scatter kernel beyond the float32 sum "
                                 f"bound of its plain version ({label}): "
                                 f"max |diff| {float(diff.max())}")
    elif not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"bank_scatter kernel differs from its plain "
                             f"version ({label}): max |diff| "
                             f"{float(diff.max())}")
    return float(diff.max())


def host_split(torch, bank_scatter, probe, build, rows, vals, acc, lines):
    """Where the host time of one call goes: each piece of the
    ``accumulate_`` wrapper at the path's shape, and of the probe's,
    timed alone on the host (``host_us``), beside the whole call's
    ``host_us`` and ``device_us``; and the ways to read the current
    stream's handle."""
    dev = rows.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n, R = rows.numel(), acc.numel()
    launch = build.entry("bank_scatter", "bank_scatter_launch")
    plan_of = lambda: bank_scatter._plan(dev, stream, n, R, torch.float32,
                                         "sum", 1, 0.0)
    args = (rows.data_ptr(), vals.data_ptr(), acc.data_ptr(), plan_of(),
            stream)
    bad_plan = bank_scatter._Plan(None, None, 0, R, 0, 0, 1, 0)
    # n = 0: refused before any CUDA call
    noop = args[:3] + (ctypes.addressof(bad_plan),) + args[4:]
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    streams = {
        "torch.cuda.current_stream(device).cuda_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "torch.cuda.current_stream(index).cuda_stream": host_us(
            lambda: torch.cuda.current_stream(idx).cuda_stream),
        "torch._C._cuda_getCurrentRawStream(index), private": host_us(
            lambda: raw(idx)) if raw else "not available"}
    acc_pieces = {
        "checks": host_us(lambda: bank_scatter._check_events(
            rows, vals, "sum", "accumulate_")),
        "stream": streams["torch.cuda.current_stream(index).cuda_stream"],
        "plan_lookup": host_us(plan_of),
        "entry_lookup": host_us(
            lambda: build.entry("bank_scatter", "bank_scatter_launch")),
        "data_ptrs": host_us(
            lambda: (rows.data_ptr(), vals.data_ptr(), acc.data_ptr())),
        "ctypes_call_no_launch": host_us(lambda: launch(*noop)),
        "ctypes_call_and_launch": host_us(lambda: launch(*args), 200),
        "whole_call": host_us(lambda: bank_scatter.accumulate_(
            acc, rows, vals, "sum"), 200),
        "delta_entry_torch_empty": host_us(
            lambda: torch.empty(BANK_R_PAD, dtype=torch.float32, device=dev)),
    }
    torch.cuda.synchronize()
    x = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    y = torch.empty_like(x)
    add_one = build.entry("probe", "probe_add_one")
    probe_pieces = {
        "checks": host_us(lambda: x.dtype != torch.int32
                          or not x.is_contiguous() or x.device.type),
        "empty_like": host_us(lambda: torch.empty_like(x)),
        "stream": streams["torch.cuda.current_stream(index).cuda_stream"],
        "ctypes_call_no_launch": host_us(lambda: add_one(
            x.data_ptr(), y.data_ptr(), 0, stream)),
        "ctypes_call_and_launch": host_us(lambda: add_one(
            x.data_ptr(), y.data_ptr(), x.numel(), stream), 200),
        "whole_call": host_us(lambda: probe.add_one(x), 200),
        "torch_add_whole_call": host_us(lambda: torch.add(x, 1), 200),
    }
    torch.cuda.synchronize()
    acc_line = lines[("accumulate_", "path f32 sum")]
    return {"phase": "host_split", "unit": "us",
            "stream_handle": streams,
            "accumulate_": {"pieces": acc_pieces,
                            "call_host_us": acc_line["host_us"],
                            "call_device_us": acc_line["device_us"]},
            "probe": {"pieces": probe_pieces}}


def trade_app(kind: str) -> str:
    """The Siddhi 5.1 query guide's TradeAggregation (``docs``) or its
    every-lane variant (``wide``), under the device bank."""
    return (f"@app:name('TradeAgg_{kind}') @app:playback "
            "@app:execution('tpu') @app:kernels('bank') " + TRADE_DEFINE +
            "define aggregation TradeAggregation from TradeStream select "
            + TRADE_SELECT[kind] + " group by symbol aggregate by timestamp "
            "every sec ... year;")


def trade_pull(per: str, kind: str) -> str:
    cols = ", ".join(c.split(" as ")[-1] for c in TRADE_SELECT[kind].split(", "))
    return (f"from TradeAggregation within {AGG_BASE - 60_000}, "
            f"{AGG_BASE + 86_400_000} per '{per}' select {cols};")


def trade_batches(EventBatch, n_batches):
    """The aggregation cell's traffic: symbols (zipf(1.2) - 1) % 2048
    from default_rng(29), price ~ U(1, 500), volume ~ [1, 10000),
    timestamp = AGG_BASE + i // 100 (100,000 trades per second).
    Returns the batches and each batch's symbol indices."""
    rng = np.random.default_rng(29)
    names = np.asarray([f"S{i:04d}" for i in range(AGG_SYMBOLS)], dtype=object)
    out, syms = [], []
    for b in range(n_batches):
        i = np.arange(b * AGG_BATCH, (b + 1) * AGG_BATCH, dtype=np.int64)
        ts = AGG_BASE + i // 100
        sym = (rng.zipf(1.2, AGG_BATCH) - 1) % AGG_SYMBOLS
        cols = {"symbol": names[sym],
                "price": rng.uniform(1.0, 500.0, AGG_BATCH),
                "volume": rng.integers(1, 10_000, AGG_BATCH).astype(np.int64),
                "timestamp": ts}
        out.append(EventBatch("TradeStream", list(cols), cols, ts))
        syms.append(sym)
    return out, syms


class GcClock:
    """Host ms the garbage collector spent while registered in
    ``gc.callbacks``: its pauses land inside the timed windows."""

    def __init__(self):
        self.ms = 0.0
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.ms += 1e3 * (time.perf_counter() - self._t)
            self._t = None


def run_trade(torch, SiddhiManager, kind, device, batches, windows):
    """Warm-up batches, then ``windows`` windows of AGG_STEPS batches, each
    synchronised on a card and followed by the AGG_PER pulls.  Returns
    the still-running app and what it measured, with the garbage
    collector's ms inside each window and each pull."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    mgr = SiddhiManager(device=device)
    rt = new_app(mgr, trade_app(kind))
    rt.start()
    h = rt.get_input_handler("TradeStream")
    for b in batches[:AGG_WARMUP]:
        h.send_batch(b)
    window_s, pull_s, pulls, gc_ms = [], [], [], []
    clock = GcClock()
    gc.callbacks.append(clock)
    try:
        for w in range(windows):
            lo = AGG_WARMUP + w * AGG_STEPS
            sync()
            g = clock.ms
            t = time.perf_counter()
            for b in batches[lo:lo + AGG_STEPS]:
                h.send_batch(b)
            sync()
            window_s.append(time.perf_counter() - t)
            g_pull = clock.ms
            t = time.perf_counter()
            pulls.append([[(e.timestamp, e.data) for e in rt.query(
                trade_pull(per, kind))] for per in AGG_PER])
            pull_s.append(time.perf_counter() - t)
            gc_ms.append([g_pull - g, clock.ms - g_pull])
    finally:
        gc.callbacks.remove(clock)
    return mgr, rt, {"window_s": window_s, "pull_s": pull_s, "pulls": pulls,
                     "gc_ms": gc_ms}


def bucket_stats(batches, syms, dur_ms) -> dict:
    """(bucket start, symbol) -> (events, sum |price|) over ``batches``:
    the float32 bound of each pulled bucket's sums."""
    ts = np.concatenate([b.timestamps for b in batches])
    sym = np.concatenate(syms)
    price = np.concatenate([b.columns["price"] for b in batches])
    start = ts // dur_ms * dur_ms
    codes = (start - start.min()) * AGG_SYMBOLS + sym
    u, inv, n = np.unique(codes, return_inverse=True, return_counts=True)
    s = np.bincount(inv, weights=np.abs(price))
    return {(int(c // AGG_SYMBOLS + start.min()), f"S{int(c % AGG_SYMBOLS):04d}"):
            (int(k), float(a)) for c, k, a in zip(u, n, s)}


def compare_pulls(got, want, stats, kind) -> int:
    """Card pull rows against the CPU run's: bucket starts, symbols and
    int or extrema fields exact; ``avgPrice``/``total`` within each
    bucket's float32 bound n * 2^-24 * sum|price|.  Returns rows held."""
    if len(got) != len(want) or not want:
        raise AssertionError(f"{kind} pull: {len(got)} rows on the card, "
                             f"{len(want)} on the CPU")
    for (tg, g), (tw, w) in zip(got, want):
        if tg != tw or g[0] != w[0]:
            raise AssertionError(f"{kind} pull row differs: {(tg, g)} vs "
                                 f"{(tw, w)}")
        n, abs_sum = stats[(tw, w[0])]
        bound = n * 2.0**-24 * abs_sum
        if abs(g[2] - w[2]) > bound or abs(g[1] - w[1]) > bound / n:
            raise AssertionError(f"{kind} pull: total/avgPrice of {(tw, w[0])} "
                                 f"beyond the float32 bound {bound}: {g} vs {w}")
        if g[3:] != w[3:]:
            raise AssertionError(f"{kind} pull: exact fields differ: {g} vs {w}")
    return len(want)


def hold_trade(card, cpu, batches, syms, kind) -> int:
    """Every pull of the card run against the CPU run's."""
    held = 0
    for w, (gp, wp) in enumerate(zip(card["pulls"], cpu["pulls"])):
        sent = AGG_WARMUP + (w + 1) * AGG_STEPS
        for per, got, want in zip(AGG_PER, gp, wp):
            dur = {"seconds": 1_000, "minutes": 60_000}[per]
            held += compare_pulls(got, want, bucket_stats(
                batches[:sent], syms[:sent], dur), kind)
    return held


def agg_breakdown(torch, rt, batches, n=AGG_STEPS):
    """Where an aggregation batch's time goes, on batches after the
    checked windows: host-clock ms of the bank scatter (pack, the one
    H2D put, the kernel launches) and the bank flush (D2H and host
    merge), each ended by a synchronise, the rest of the batch (host
    bucketing: filters, np.unique, segment keys, row assignment), then
    the pulls; and one more window under ``torch.profiler``."""
    agg = rt.aggregations["TradeAggregation"]
    bank = agg._bank
    h = rt.get_input_handler("TradeStream")
    rec = {"batch_ms": [], "scatter_ms": [], "flush_ms": []}
    # the stages are timed by shadowing two methods on the instances; a
    # renamed method would leave its stage reading 0 with no error
    for obj, meth in ((bank, "scatter"), (agg, "_flush_bank")):
        if not callable(type(obj).__dict__.get(meth)):
            raise AssertionError(f"{type(obj).__name__}.{meth} is gone; the "
                                 "aggregation breakdown cannot time it")

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            rec[key][-1] += 1e3 * (time.perf_counter() - t)
            return out
        return run

    bank.scatter = timed(bank.scatter, "scatter_ms")
    agg._flush_bank = timed(agg._flush_bank, "flush_ms")
    try:
        for b in batches[:n]:
            for k in rec:
                rec[k].append(0.0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            h.send_batch(b)
            torch.cuda.synchronize()
            rec["batch_ms"][-1] = 1e3 * (time.perf_counter() - t)
    finally:
        del bank.scatter
        del agg._flush_bank
    if not (all(rec["scatter_ms"]) and any(rec["flush_ms"])):
        raise AssertionError(f"aggregation breakdown timed no scatter or no "
                             f"flush: {rec}")
    rec["host_bucketing_ms"] = [b - s - f for b, s, f in zip(
        rec["batch_ms"], rec["scatter_ms"], rec["flush_ms"])]
    pull_ms = {}
    for per in AGG_PER:
        t = time.perf_counter()
        rows = len(rt.query(trade_pull(per, "docs")))
        pull_ms[per] = [1e3 * (time.perf_counter() - t), rows]
    prof = device_profile(torch, lambda: [h.send_batch(b)
                                          for b in batches[n:2 * n]])
    return {"phase": "aggregation_breakdown", "batches": n, **rec,
            "pull_ms_rows": pull_ms, **prof}


def general_phase(torch, SiddhiManager, compile_pattern, state_from_numpy,
                  state_to_numpy, kernels, card) -> dict:
    """Phase 10: the headline capturing chain on the general step at
    1 M partitions, held against the CPU run, then the three small
    ``general_check`` cases.  ``kernels``: every kernel's wrappers by
    the kernel's name, whose counts are set to 0 here; returns this
    path's launches by kernel."""
    for wrappers in kernels.values():
        for k in wrappers:
            k.launches = 0
    gapp = flat_app()
    geng = compile_pattern(gapp, "bench", n_partitions=N_PARTITIONS,
                           n_instances=N_INSTANCES, device="cuda")
    ghost, gbase = mid_chain_state(geng, seed=13)
    gstate = state_from_numpy(geng, ghost, gbase)
    gstate_bytes = sum(t.numel() * t.element_size() for t in gstate.values())
    grng = np.random.default_rng(17)
    gbatches = [e2e_batch(grng, i) for i in range(GEN_WARMUP + GEN_STEPS)]
    gresults, gbatch_s = [], []
    for part, cols, ts in gbatches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        gstate, ev, out = geng.process(gstate, "Txn", part, cols, ts)
        torch.cuda.synchronize()
        gbatch_s.append(time.perf_counter() - t)
        gresults.append((ev, out))
    gen_launches = {name: sum(k.launches for k in wrappers)
                    for name, wrappers in kernels.items()}
    gfinal, _ = state_to_numpy(geng, gstate)
    gbreak = batch_breakdown(
        torch, geng, gstate,
        [("Txn", *e2e_batch(grng, len(gbatches) + i)) for i in range(8)],
        phase="general_breakdown")
    gops = step_device_ops(torch, geng, gstate,
                           ("Txn", *e2e_batch(grng, len(gbatches) + 8)))
    del gstate
    gcpu = compile_pattern(gapp, "bench", n_partitions=N_PARTITIONS,
                           n_instances=N_INSTANCES, device="cpu")
    gcstate = state_from_numpy(gcpu, ghost, gbase)
    g_matches = []
    t = time.perf_counter()
    for (part, cols, ts), (ev, out) in zip(gbatches, gresults):
        gcstate, cev, cout = gcpu.process(gcstate, "Txn", part, cols, ts)
        if not (np.array_equal(ev, cev) and out.dtype == cout.dtype
                and out_bits(out) == out_bits(cout)):
            raise AssertionError("general step: matches differ between the "
                                 "card and the CPU run")
        g_matches.append(len(ev))
    gcpu_s = time.perf_counter() - t
    gcfinal, _ = state_to_numpy(gcpu, gcstate)
    del gcstate
    bad = [k for k in gcfinal
           if not np.array_equal(gfinal[k].view(np.uint8),
                                 gcfinal[k].view(np.uint8))]
    if bad:
        raise AssertionError(f"general step: final {bad} differ between the "
                             "card and the CPU run")
    moved = int((gfinal["regs"] != ghost["regs"]).sum())
    if min(g_matches) == 0 or not moved or geng.step_kind != "general":
        raise AssertionError(f"general step: a batch without matches "
                             f"({g_matches}), no register moved ({moved}) "
                             f"or step {geng.step_kind}")
    # the general step launches no hand-written kernel; the probe runs
    # once for the engine built on the card
    if (gen_launches["probe"] < 1 or gen_launches["dense_batch"]
            or gen_launches["dense_step"] or gen_launches["scan_chain"]):
        raise AssertionError(f"general step launches: {gen_launches}")
    gsteady = gbatch_s[GEN_WARMUP:]
    emit({"phase": "general_step", "app": "bench.py flat_app (16 states, "
          "v > e1.v)", "step_kind": geng.step_kind,
          "partitions": N_PARTITIONS, "batch": BATCH, "states": N_STATES,
          "instances": N_INSTANCES, "registers": geng.alloc.n,
          "warmup_batches": GEN_WARMUP, "timed_batches": GEN_STEPS,
          "bit_exact_batches": len(gbatches),
          "bit_exact_state": sorted(gcfinal), "state_bytes": gstate_bytes,
          "matches_per_batch": g_matches, "registers_moved": moved,
          "batch_ms": [1e3 * x for x in gbatch_s],
          "events_per_s": BATCH * len(gsteady) / sum(gsteady),
          "events_per_s_median_batch":
              BATCH / sorted(gsteady)[len(gsteady) // 2],
          **gops, "launches": gen_launches, "cpu_seconds": gcpu_s,
          "card": card})
    emit(gbreak)
    checks = [unpartitioned_card_vs_cpu(torch, SiddhiManager)]
    checks.append(card_vs_cpu(
        torch, compile_pattern, state_to_numpy,
        "define stream S (k long, u double, v double); @info(name='q') "
        "from every a=S[v > 10.0] -> b=S[k == a.k] within 3 sec "
        "select a.k as ak, a.v as av, b.v as bv insert into Alerts;",
        64, N_INSTANCES, small_batches(41, 4, 400, 64), "int id-join"))
    checks.append(card_vs_cpu(
        torch, compile_pattern, state_to_numpy,
        "define stream S (k long, u double, v double); @info(name='q') "
        "from every a=S[v > 1.0] -> b=S[v > 19.0] -> c=S[u > 10.0] "
        "within 10 min select c.v as cv insert into Alerts;",
        8, 40, small_batches(42, 3, 400, 8), "capture-free, instances=40"))
    for line in checks:
        emit({"phase": "general_check", **line, "card": card})
    return gen_launches


def fraud_batches(n):
    """BASELINE config 2's traffic: card ids uniform over 100,000 cards,
    ``amount ~ lognormal(4, 1)`` float32, one event a ms."""
    rng = np.random.default_rng(31)
    out = []
    for i in range(n):
        card = rng.integers(0, FRAUD_CARDS, BATCH)
        amount = rng.lognormal(4.0, 1.0, BATCH).astype(np.float32)
        ts = 1000 + i * BATCH + np.arange(BATCH, dtype=np.int64)
        out.append(("Txn", card.astype(np.int32),
                    {"card": card, "amount": amount}, ts))
    return out


def brute_batches(n):
    """BASELINE config 3's traffic: users uniform over 1,000,000, a
    failed login (``ok = 0``) with p = 0.8, one event a ms."""
    rng = np.random.default_rng(37)
    out = []
    for i in range(n):
        user = rng.integers(0, BRUTE_USERS, BATCH)
        ok = (rng.random(BATCH) >= 0.8).astype(np.int32)
        ts = 1000 + i * BATCH + np.arange(BATCH, dtype=np.int64)
        out.append(("Login", user.astype(np.int32),
                    {"user": user, "ok": ok}, ts))
    return out


def news_batches(n):
    """BASELINE config 4's traffic: ``Tick`` batches of 16,384 and
    ``News`` batches of 2,048 in turns, each covering the next 500 ms of
    stream time in order; symbols uniform over 10,000,
    ``price ~ U(1, 500)``, ``score ~ U(0, 1)``."""
    rng = np.random.default_rng(41)
    out = []
    for i in range(n):
        tick = i % 2 == 0
        B = TICK_BATCH if tick else NEWS_BATCH
        sym = rng.integers(0, NEWS_SYMBOLS, B)
        ts = (1000 + i * NEWS_SPAN_MS
              + np.sort(rng.integers(0, NEWS_SPAN_MS, B))).astype(np.int64)
        cols = ({"sym": sym, "price": rng.uniform(1.0, 500.0, B)} if tick
                else {"sym": sym, "score": rng.uniform(0.0, 1.0, B)})
        out.append(("Tick" if tick else "News", sym.astype(np.int32), cols,
                    ts))
    return out


def run_cell(torch, eng, state, batches):
    """``batches`` through ``process_deferred``, ``resolve``, one fetch
    and ``materialize`` (what ``process`` does), each batch synchronised
    and timed by the host clock; then each batch's emits by bank (0: at
    the last node, 1: via-path clones)."""
    from siddhi_tpu_torch.core.emit_queue import fetch_coalesced
    from siddhi_tpu_torch.ops.dense_nfa import flatten_match_parts

    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))
    results, secs, banks = [], [], []
    for stream, part, cols, ts in batches:
        sync()
        t = time.perf_counter()
        state, pending = eng.process_deferred(state, stream, part, cols, ts)
        host = []
        if pending is not None and pending.resolve():
            host = fetch_coalesced(pending.device_arrays())
            ev, out = pending.materialize(host)
        else:
            ev, out = flatten_match_parts([], [], [],
                                          max(len(eng.out_spec), 1))
        sync()
        secs.append(time.perf_counter() - t)
        results.append((ev, out))
        emits = [h[ch["sel"]] for ch, h in zip(pending.chunks, host[::4])]
        banks.append([sum(int(e[:, b * eng.I:(b + 1) * eng.I].sum())
                          for e in emits) for b in (0, 1)])
    return state, results, secs, banks


def part_b_cell(torch, compile_pattern, state_from_numpy, state_to_numpy,
                kernels, card, name, app, qname, P, batches, within_ms,
                reg_draw=None) -> dict:
    """One part-b cell at full size: ``compile_pattern(app, device=
    "cuda")`` from a seeded mid-chain state, the warm-up and timed
    batches (launch counts read over the engine's build and these
    batches alone), a breakdown and one
    batch's device kernels, then the same batches and state with
    ``device="cpu"``: every batch's matches, output bits and emit banks
    and the whole final state must be equal.  ``batches`` holds the
    checked batches, 8 more for the breakdown and one to profile.
    Returns this path's launches by kernel."""
    from siddhi_tpu_torch.ops.dense_nfa import _round_order

    checked = batches[:PB_WARMUP + PB_STEPS]
    for wrappers in kernels.values():
        for k in wrappers:
            k.launches = 0
    eng = compile_pattern(app, qname, n_partitions=P, device="cuda")
    host, base = mid_chain_state(eng, seed=len(name), within_ms=within_ms,
                                 reg_draw=reg_draw)
    state = state_from_numpy(eng, host, base)
    state, results, secs, banks = run_cell(torch, eng, state, checked)
    launches = {kname: sum(k.launches for k in wrappers)
                for kname, wrappers in kernels.items()}
    final, _ = state_to_numpy(eng, state)
    brk = batch_breakdown(torch, eng, state, batches[len(checked):-1],
                          phase=f"{name}_breakdown")
    ops = step_device_ops(torch, eng, state, batches[-1])
    del state
    cpu = compile_pattern(app, qname, n_partitions=P, device="cpu")
    cstate = state_from_numpy(cpu, host, base)
    t = time.perf_counter()
    cstate, cres, _csecs, cbanks = run_cell(torch, cpu, cstate, checked)
    cpu_s = time.perf_counter() - t
    cfinal, _ = state_to_numpy(cpu, cstate)
    del cstate
    for i, ((ev, out), (cev, cout)) in enumerate(zip(results, cres)):
        if not (np.array_equal(ev, cev) and out.dtype == cout.dtype
                and out_bits(out) == out_bits(cout)):
            raise AssertionError(f"{name}: batch {i}'s matches differ "
                                 "between the card and the CPU run")
    bad = [k for k in cfinal if not np.array_equal(
        final[k].view(np.uint8), cfinal[k].view(np.uint8))]
    n_matches = [len(ev) for ev, _out in results]
    if bad or banks != cbanks or not sum(n_matches):
        raise AssertionError(f"{name}: final {bad} or emit banks differ "
                             "between the card and the CPU run, or no "
                             f"match ({n_matches})")
    if (eng.step_kind != "general" or launches["probe"] < 1
            or any(v for k, v in launches.items() if k != "probe")):
        raise AssertionError(f"{name}: step {eng.step_kind}, launches "
                             f"{launches}")
    steady = secs[PB_WARMUP:]
    events = [len(b[1]) for b in checked]
    line = {"phase": name, "app": app, "step_kind": eng.step_kind,
            "partitions": P, "states": eng.S, "instances": eng.I,
            "registers": eng.alloc.n, "int_registers": eng.alloc.n_int,
            "state_bytes": sum(int(np.prod(shape)) * dt.itemsize
                               for shape, dt in eng.state_layout().values()),
            "events_per_batch": events, "warmup_batches": PB_WARMUP,
            "timed_batches": PB_STEPS, "bit_exact_batches": len(checked),
            "bit_exact_state": sorted(cfinal),
            "matches_per_batch": n_matches,
            "emits_bank0": [b[0] for b in banks],
            "emits_bank1": [b[1] for b in banks],
            "rounds_per_batch": [len(_round_order(b[1])[1]) - 1
                                 for b in checked],
            "batch_ms": [1e3 * x for x in secs],
            "events_per_s": sum(events[PB_WARMUP:]) / sum(steady),
            "events_per_s_median_batch": sorted(
                e / x for e, x in zip(events[PB_WARMUP:], steady))[
                    len(steady) // 2],
            "profiled_batch": ops, "launches": launches,
            "cpu_seconds": cpu_s, "card": card}
    emit(line)
    emit(brk)
    return launches


def part_b_phase(torch, compile_pattern, state_from_numpy, state_to_numpy,
                 kernels, card) -> dict:
    """Phases 11 and 12: BASELINE configs 2-4 on the general step at
    full size, each held against its CPU run, then the small
    ``part_b_check`` cases.  Returns the three cells' launches by
    kernel, summed."""
    n = PB_WARMUP + PB_STEPS + 9
    cells = [
        ("count_fraud", FRAUD_APP, "fraud", FRAUD_CARDS, fraud_batches(n),
         600_000, lambda rng, shape: rng.lognormal(4.0, 1.0, shape)),
        ("kleene_bruteforce", BRUTE_APP, "bf", BRUTE_USERS,
         brute_batches(n), 60_000, None),
        ("logical_news", NEWS_APP, "q", NEWS_SYMBOLS, news_batches(n),
         5_000, lambda rng, shape: rng.uniform(0.0, 500.0, shape)),
    ]
    total = {kname: 0 for kname in kernels}
    for name, app, qname, P, batches, within_ms, draw in cells:
        got = part_b_cell(torch, compile_pattern, state_from_numpy,
                          state_to_numpy, kernels, card, name, app, qname,
                          P, batches, within_ms, draw)
        for kname, v in got.items():
            total[kname] += v
        gc.collect()
    for label, q in PB_CHECKS.items():
        line = card_vs_cpu(
            torch, compile_pattern, state_to_numpy,
            "define stream S (k long, u double, v double); "
            f"@info(name='q') from {q} insert into Alerts;",
            8, N_INSTANCES, small_batches(len(label), 2, 150, 8), label)
        emit({"phase": "part_b_check", **line, "card": card})
    return total


def absent_batches(EventBatch):
    """The ``absent_alert`` traffic: in turns, a Regulator batch of 4,096
    events over the next 8 s (rooms uniform over 1,000,000, ``action`` 1
    with p = 2/3, ``tempSet ~ U(18, 24)``, ``deviceID = roomNo``) and a
    Temperature batch of 131,072 events over the 8 s after it (``temp ~
    N(21, 2)``), timestamps non-decreasing, all float32."""
    rng = np.random.default_rng(37)
    out, t = [], ABSENT_T0
    for _ in range(ABSENT_WARMUP + ABSENT_PAIRS):
        rooms = rng.integers(0, ABSENT_ROOMS, REG_BATCH).astype(np.int32)
        out.append(EventBatch(
            "RegulatorStateChangeStream",
            ["deviceID", "roomNo", "tempSet", "action"],
            {"deviceID": rooms.astype(np.int64), "roomNo": rooms,
             "tempSet": rng.uniform(18.0, 24.0, REG_BATCH).astype(np.float32),
             "action": (rng.random(REG_BATCH) < 2 / 3).astype(np.int32)},
            t + np.sort(rng.integers(0, ABSENT_SPAN_MS, REG_BATCH))))
        t += ABSENT_SPAN_MS
        rooms = rng.integers(0, ABSENT_ROOMS, TEMP_BATCH).astype(np.int32)
        out.append(EventBatch(
            "TemperatureStream", ["roomNo", "temp"],
            {"roomNo": rooms,
             "temp": rng.normal(21.0, 2.0, TEMP_BATCH).astype(np.float32)},
            t + np.sort(rng.integers(0, ABSENT_SPAN_MS, TEMP_BATCH))))
        t += ABSENT_SPAN_MS
    return out


def absent_start(eng) -> dict:
    """A seeded mid-chain start for the ``absent_alert`` cell, as a
    runtime snapshot: every room interned to its own row, 10% of rooms
    with node 1 armed in lane 0 (``e1.roomNo`` and ``e1.tempSet`` in
    the registers, the anchor in the 30 s before the first event, the
    deadline 30 s after it, so uniform over the first 30 s)."""
    rng = np.random.default_rng(41)
    host = eng.init_state_host()
    rows = np.flatnonzero(rng.random(ABSENT_ROOMS) < 0.10)
    base = ABSENT_T0 - ABSENT_WAIT_MS - 1
    arm = rng.integers(1, ABSENT_WAIT_MS + 1, len(rows)).astype(np.int32)
    host["active"][rows, 1, 0] = True
    host["first_ts"][rows, 1, 0] = arm
    host["deadline"][rows, 1, 0] = arm + ABSENT_WAIT_MS
    slots = {(ref, attr): s for (ref, attr, _l), s in eng.alloc.slots.items()}
    temp_set = slots[("e1", "tempSet")]
    room = slots[("e1", "roomNo")]
    host["regs"][rows, 1, 0, temp_set.index] = rng.uniform(
        18.0, 24.0, len(rows)).astype(np.float32)
    host["iregs"][rows, 1, 0, 2 * room.index] = 0  # hi word of roomNo
    host["iregs"][rows, 1, 0, 2 * room.index + 1] = (
        rows.astype(np.int64) - 2**31).astype(np.int32)
    return {"dense_state": host, "base_ts": base,
            "key_rows": dict(zip(range(ABSENT_ROOMS), range(ABSENT_ROOMS))),
            "next_row": ABSENT_ROOMS, "free_rows": [],
            "row_last_used": np.zeros(ABSENT_ROOMS, dtype=np.int64)}


def timed_timer(torch, eng, sync):
    """Shadow the engine's wakeup read, tick and timer step on the
    instance with host-clock timers (the step ended by a synchronise on a
    card); returns the record they fill."""
    rec = {"wake_ms": [], "tick_ms": [], "step_ms": [], "fired": []}
    wake, on_time, tstep = (eng.next_wakeup_state, eng.on_time_state,
                            eng.make_time_step())

    def timed_wake(state):
        t = time.perf_counter()
        out = wake(state)
        rec["wake_ms"].append(1e3 * (time.perf_counter() - t))
        return out

    def timed_step(state, now):
        sync()
        t = time.perf_counter()
        out = tstep(state, now)
        sync()
        rec["step_ms"].append(1e3 * (time.perf_counter() - t))
        return out

    def timed_tick(state, now):
        sync()
        t = time.perf_counter()
        state, fired = on_time(state, now)
        sync()
        rec["tick_ms"].append(1e3 * (time.perf_counter() - t))
        rec["fired"].append(0 if fired is None else len(fired[1]))
        return state, fired

    eng.next_wakeup_state = timed_wake
    eng.on_time_state = timed_tick
    eng._time_step = timed_step
    return rec


def run_absent(torch, SiddhiManager, batches, device, start):
    """``ABSENT_APP`` on ``device`` from the snapshot ``start`` (or
    ``start(engine)``, which makes it; the snapshot is returned): every
    batch through ``send_batch``, so the scheduler drives the timer
    before each batch, each synchronised and timed by the host clock
    with its alerts delivered.  Returns the running app and what it
    measured."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    mgr = SiddhiManager(device=device)
    rt = new_app(mgr, ABSENT_APP)
    alerts = []
    rt.add_callback("AlertStream", lambda evs: alerts.extend(
        (e.timestamp, e.data) for e in evs))
    rt.start()
    proc = rt.pattern_runtimes()["q"]
    if callable(start):
        start = start(proc.engine)
    proc.restore(start)
    rec = timed_timer(torch, proc.engine, sync)
    secs = []
    for b in batches:
        sync()
        t = time.perf_counter()
        rt.get_input_handler(b.stream_id).send_batch(b)
        rt.drain()
        sync()
        secs.append(time.perf_counter() - t)
    return mgr, rt, {"alerts": alerts, "secs": secs, "timer": rec,
                     "start": start}


def absent_breakdown(torch, rt, proc, pair, timer) -> dict:
    """Where a turn pair's time goes in the ``absent_alert`` cell: each
    batch's host-clock ms (synchronised, alerts delivered) split into
    interning, the general steps (``process_deferred``, synchronised),
    the scheduler's tick and wakeup reads (``timer``, the run's timer
    record, which goes on filling) and the rest (the count gate, fetch,
    materialize and callbacks)."""
    eng = proc.engine
    spent = {"intern_ms": 0.0, "step_ms": 0.0}
    intern, step = proc.intern_keys, eng.process_deferred

    def timed_intern(keys):
        t = time.perf_counter()
        out = intern(keys)
        spent["intern_ms"] += 1e3 * (time.perf_counter() - t)
        return out

    def timed_step(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        spent["step_ms"] += 1e3 * (time.perf_counter() - t)
        return out

    proc.intern_keys, eng.process_deferred = timed_intern, timed_step
    line = {"phase": "absent_alert_breakdown"}
    for b in pair:
        for v in spent:
            spent[v] = 0.0
        n_tick, n_wake = len(timer["tick_ms"]), len(timer["wake_ms"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        rt.get_input_handler(b.stream_id).send_batch(b)
        rt.drain()
        torch.cuda.synchronize()
        total = 1e3 * (time.perf_counter() - t)
        tick = sum(timer["tick_ms"][n_tick:])
        wake = sum(timer["wake_ms"][n_wake:])
        line[b.stream_id] = {
            "events": len(b), "batch_ms": total, **dict(spent),
            "tick_ms": tick, "next_wakeup_ms": wake,
            "rest_ms": total - sum(spent.values()) - tick - wake}
    del proc.intern_keys, eng.process_deferred
    return line


def timer_step_ops(torch, eng, state, now) -> dict:
    """Device items of one timer step over the whole state under
    ``torch.profiler``, on a copy of ``state`` (the step writes it in
    place)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    copy = {k: v.clone() for k, v in state.items()}
    rel = min(now - eng.base_ts, 2**31 - 1)
    step = eng.make_time_step()
    step(copy, rel)  # warm
    copy = {k: v.clone() for k, v in state.items()}
    # the clones finish before the profiler starts, or it counts them
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        _s, emit_d, _o, _f, n_emit = step(copy, rel)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    return {"timer_step_kernels": len(dev) - len(copies),
            "timer_step_copies": len(copies),
            "timer_step_device_us": sum(e.time_range.elapsed_us()
                                        for e in dev),
            "timer_step_profiled_fires": int(n_emit.item())}


def absent_phase(torch, SiddhiManager, EventBatch, kernels, card) -> dict:
    """Phase 13a: ``absent_alert``, the query guide's absent example over
    1,000,000 rooms on the card from a seeded mid-chain state, held bit
    for bit against the same run on the CPU (alerts, their timestamps
    and order; the whole final state).  Returns the path's launches by
    kernel (read over the card run alone)."""
    from siddhi_tpu_torch.ops.dense_nfa import _round_order, state_to_numpy

    batches = absent_batches(EventBatch)
    for wrappers in kernels.values():
        for k in wrappers:
            k.launches = 0
    mgr, rt, got = run_absent(torch, SiddhiManager, batches, "cuda",
                              absent_start)
    start = got["start"]
    launches = {name: sum(k.launches for k in wrappers)
                for name, wrappers in kernels.items()}
    proc = rt.pattern_runtimes()["q"]
    eng = proc.engine
    lowering = rt.lowering(step_kinds=True)
    final, _ = state_to_numpy(eng, proc.state)
    time_fires = proc.time_fires
    # the callback and the timers go on recording after the held run
    alerts = list(got["alerts"])
    timer = {k: list(v) for k, v in got["timer"].items()}
    n_ticks = len(timer["tick_ms"])
    # timing only, after the held run: one timer step and one
    # Temperature batch's general steps alone, one more turn pair split
    # by stage, and one more under the profiler
    last_ts = int(batches[-1].timestamps[-1])
    more = [EventBatch(b.stream_id, b.attribute_names, b.columns,
                       b.timestamps + last_ts + 1 - ABSENT_T0)
            for b in batches[:4]]
    ops = timer_step_ops(torch, eng, proc.state, last_ts + ABSENT_WAIT_MS)
    temp = more[1]
    gstate = {k: v.clone() for k, v in proc.state.items()}
    torch.cuda.synchronize()  # the profiler must not count the clones
    gops = step_device_ops(torch, eng, gstate, (
        "TemperatureStream", temp.columns["roomNo"], dict(temp.columns),
        temp.timestamps))
    del gstate
    brk = absent_breakdown(torch, rt, proc, more[:2], got["timer"])

    def run_more():
        for b in more[2:]:
            rt.get_input_handler(b.stream_id).send_batch(b)
        rt.drain()

    prof = device_profile(torch, run_more)
    rt.shutdown()
    mgr.shutdown()
    cmgr, crt, cpu = run_absent(torch, SiddhiManager, batches, "cpu", start)
    cproc = crt.pattern_runtimes()["q"]
    cfinal, _ = state_to_numpy(cproc.engine, cproc.state)
    cpu_fires = cproc.time_fires
    crt.shutdown()
    cmgr.shutdown()
    if alerts != cpu["alerts"]:
        raise AssertionError("absent_alert: alerts differ between the card "
                             "and the CPU run")
    bad = [k for k in cfinal if not np.array_equal(
        final[k].view(np.uint8), cfinal[k].view(np.uint8))]
    if bad or time_fires != cpu_fires:
        raise AssertionError(f"absent_alert: final {bad} or timer fires "
                             f"({time_fires}, CPU {cpu_fires}) differ "
                             "between the card and the CPU run")
    # every arm: the seeded ones and each action == 1 event placed (less
    # the lane overflow); each is fired, killed or still pending
    arms = (int(start["dense_state"]["active"][:, 1].sum())
            + sum(int((b.columns["action"] == 1).sum()) for b in batches
                  if "action" in b.columns)
            - int(final["overflow"].sum()))
    pending = int(final["active"][:, 1].sum())
    n_alerts = len(alerts)
    kills = arms - n_alerts - pending
    if (lowering != {"q": "dense/general"} or not n_alerts or kills <= 0
            or launches["probe"] != 1
            or any(v for k, v in launches.items() if k != "probe")):
        raise AssertionError(f"absent_alert: lowering {lowering}, alerts "
                             f"{n_alerts}, kills {kills}, launches "
                             f"{launches}")
    timed = got["secs"][2 * ABSENT_WARMUP:]
    events = [len(b) for b in batches]
    emit({"phase": "absent_alert", "app": "Siddhi 5.1 query guide, "
          "non-occurrence: regulator on, room not cooled within 30 sec",
          "lowering": lowering, "rooms": ABSENT_ROOMS,
          "states": eng.S, "instances": eng.I, "registers": eng.alloc.n,
          "int_registers": eng.alloc.n_int,
          "state_bytes": sum(int(np.prod(shape)) * dt.itemsize
                             for shape, dt in eng.state_layout().values()),
          "seeded_armed": int(start["dense_state"]["active"][:, 1].sum()),
          "regulator_batch": REG_BATCH, "temperature_batch": TEMP_BATCH,
          "batch_span_ms": ABSENT_SPAN_MS,
          "warmup_pairs": ABSENT_WARMUP, "timed_pairs": ABSENT_PAIRS,
          "bit_exact_alerts": n_alerts, "bit_exact_state": sorted(cfinal),
          "kills": kills, "pending_at_end": pending,
          "overflow": int(final["overflow"].sum()),
          "events_per_s": sum(events[2 * ABSENT_WARMUP:]) / sum(timed),
          "batch_ms": [1e3 * x for x in got["secs"]],
          "ticks": n_ticks, "timer_steps_fired": time_fires,
          "alerts_per_tick": timer["fired"],
          "timer_step_host_ms": timer["step_ms"],
          "tick_ms": timer["tick_ms"],
          "fire_fetch_ms": [a - b for a, b in zip(timer["tick_ms"],
                                                  timer["step_ms"])],
          "next_wakeup_calls": len(timer["wake_ms"]),
          "next_wakeup_ms_median": sorted(timer["wake_ms"])[
              len(timer["wake_ms"]) // 2],
          "next_wakeup_ms_max": max(timer["wake_ms"]),
          **ops,
          "rounds_per_batch": [len(_round_order(
              b.columns["roomNo"])[1]) - 1 for b in batches],
          "general_step": gops, **prof,
          "profiled": "one more turn pair, after the held run",
          "launches": launches, "cpu_seconds": sum(cpu["secs"]),
          "card": card})
    emit(brk)
    return launches


def absent_sends(seed, n=300, P=8):
    """About ``n`` seeded events on ``S`` and ``T (k long, v double)``:
    keys over ``P`` partitions, ``v ~ U(0, 8)``, 1-40 ms apart."""
    rng = np.random.default_rng(seed)
    out, t = [], 1000
    for _ in range(n):
        t += int(rng.integers(1, 40))
        out.append(("S" if rng.random() < 0.6 else "T",
                    [int(rng.integers(0, P)), float(rng.uniform(0, 8))], t))
    return out


def app_card_vs_cpu(torch, SiddhiManager, app, sends, label, after=None,
                    wait=None) -> dict:
    """``sends`` (stream, row, ts) through ``SiddhiManager`` on the card
    and on the CPU: the callbacks (values, timestamps, order), the
    timer fires, the key maps and the query's whole final state must be
    equal.  ``after(rt)`` runs after the sends; ``wait(got)`` polls (at
    most 10 s) for callbacks that arrive with no input."""
    from siddhi_tpu_torch.ops.dense_nfa import state_to_numpy

    res, secs = {}, 0.0
    for d in ("cuda", "cpu"):
        mgr = SiddhiManager(device=d)
        rt = new_app(mgr, app)
        got = []
        rt.add_callback("Alerts", lambda evs, got=got: got.extend(
            (e.timestamp, list(e.data)) for e in evs))
        rt.start()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for stream, row, ts in sends:
            rt.get_input_handler(stream).send(list(row), timestamp=ts)
        if after is not None:
            after(rt)
        if wait is not None:
            stop = time.monotonic() + 10
            while not wait(got) and time.monotonic() < stop:
                time.sleep(0.005)
        rt.drain()
        torch.cuda.synchronize()
        if d == "cuda":
            secs = time.perf_counter() - t
        proc = rt.pattern_runtimes()["q"]
        lowering = rt.lowering(step_kinds=True)
        rt.shutdown()
        mgr.shutdown()
        state, base = state_to_numpy(proc.engine, proc.state)
        res[d] = (got, proc.time_fires, base, state, dict(proc._key_rows),
                  list(proc._free_rows))
    (g, f, b, st, keys, free), (cg, cf, cb, cst, ckeys, cfree) = (
        res["cuda"], res["cpu"])
    bad = [k for k in cst if not np.array_equal(st[k].view(np.uint8),
                                                cst[k].view(np.uint8))]
    if (g != cg or (f, b, keys, free) != (cf, cb, ckeys, cfree) or bad
            or not cg or lowering != {"q": "dense/general"}):
        raise AssertionError(f"{label}: card callbacks, fires, key maps or "
                             f"state {bad} differ from the CPU run's, none, "
                             f"or lowering {lowering}")
    return {"case": label, "events": len(sends), "callbacks": len(cg),
            "timer_fires": cf, "keys": len(ckeys), "free_rows": len(cfree),
            "bit_exact_state": sorted(cst), "card_seconds": secs}


def reanchor_card_vs_cpu(torch, compile_pattern, state_from_numpy,
                         state_to_numpy) -> dict:
    """An absent engine driven across a re-anchor with deadlines
    pending, card against CPU: a seeded state near the int32 headroom,
    batches that cross it (each after a tick to its last timestamp),
    then a tick past every deadline."""
    app = (ABSENT_DEFINE + "@info(name='q') from every a=S[v > 4.0] -> "
           "not T[v > a.v] for 2 sec select a.k as ak, a.v as av "
           "insert into Alerts;")
    eng = {d: compile_pattern(app, "q", n_partitions=8, device=d)
           for d in ("cuda", "cpu")}
    limit = eng["cpu"]._REL_LIMIT
    rng = np.random.default_rng(43)
    host = eng["cpu"].init_state_host()
    act = rng.random(host["active"].shape) < 0.5
    act[-1] = False
    act[:, 0] = False
    host["active"] = act
    host["first_ts"] = np.where(act, limit - 3_000, 0).astype(np.int32)
    host["deadline"] = np.where(act, rng.choice(
        [limit - 9_000, limit - 1_000, limit + 800], act.shape),
        0).astype(np.int32)
    host["regs"] = rng.uniform(0, 8, host["regs"].shape).astype(np.float32)
    state = {d: state_from_numpy(e, host, 0) for d, e in eng.items()}
    fired = {d: [] for d in eng}
    t = limit - 2_000
    for i in range(6):
        stream = "S" if i % 2 == 0 else "T"
        ts = t + np.sort(rng.integers(0, 700, 40))
        t = int(ts[-1])
        cols = {"k": rng.integers(0, 8, 40), "v": rng.uniform(0, 8, 40)}
        part = rng.integers(0, 8, 40).astype(np.int32)
        for d, e in eng.items():
            state[d], f = e.on_time_state(state[d], t)
            fired[d].append(None if f is None else [x.tolist() for x in f])
            state[d], ev, out = e.process(state[d], stream, part, cols, ts)
            fired[d].append([ev.tolist(), out.tolist()])
    for d, e in eng.items():
        state[d], f = e.on_time_state(state[d], t + 10_000)
        fired[d].append(None if f is None else [x.tolist() for x in f])
    card, _ = state_to_numpy(eng["cuda"], state["cuda"])
    cpu, _ = state_to_numpy(eng["cpu"], state["cpu"])
    bad = [k for k in cpu if not np.array_equal(card[k].view(np.uint8),
                                                cpu[k].view(np.uint8))]
    # the entries alternate tick, batch, ..., and end with a tick
    n_fired = sum(len(f[1]) for f in fired["cpu"][0::2] if f is not None)
    if (fired["cuda"] != fired["cpu"] or bad or not n_fired
            or eng["cuda"].base_ts != eng["cpu"].base_ts
            or not eng["cpu"].base_ts):
        raise AssertionError(f"re-anchor: fires, base or state {bad} differ "
                             "between the card and the CPU run, or no fire "
                             "or no re-anchor")
    return {"case": "re-anchor with deadlines pending",
            "base_ts": eng["cpu"].base_ts, "timer_fires": n_fired,
            "bit_exact_state": sorted(cpu)}


def absent_check_phase(torch, SiddhiManager, compile_pattern,
                       state_from_numpy, state_to_numpy, card) -> None:
    """Phase 13b-c: the small ``absent_check`` cases and ``purge_check``,
    each card against CPU."""
    part = ("@app:playback @app:execution('tpu', partitions='8') "
            + ABSENT_DEFINE + "partition with (k of S, k of T) begin "
            "@info(name='q') from {q} insert into Alerts; end;")
    lines = [app_card_vs_cpu(torch, SiddhiManager, part.format(q=q),
                             absent_sends(len(label)), label)
             for label, q in ABSENT_CHECKS.items()]
    lines.append(app_card_vs_cpu(
        torch, SiddhiManager,
        "@app:playback @app:execution('tpu') " + ABSENT_DEFINE
        + "@info(name='q') from every a=S[v > 6.0] -> not T[v > a.v] "
        "for 300 millisec select a.k as ak, a.v as av insert into Alerts;",
        absent_sends(11), "unpartitioned trailing"))
    lines.append(reanchor_card_vs_cpu(torch, compile_pattern,
                                      state_from_numpy, state_to_numpy))
    # the idle heartbeat fires a deadline with no input
    lines.append(app_card_vs_cpu(
        torch, SiddhiManager,
        "@app:playback(idle.time='20 millisecond', increment='400 "
        "millisecond') @app:execution('tpu') " + ABSENT_DEFINE
        + "@info(name='q') from every a=S[v > 6.0] -> not T[v > a.v] "
        "for 1 sec select a.k as ak, a.v as av insert into Alerts;",
        [("S", [3, 7.5], 1000)], "idle heartbeat",
        wait=lambda got: len(got) >= 1))
    for line in lines:
        emit({"phase": "absent_check", **line, "card": card})
    # @purge: keys going idle, new keys taking the recycled rows
    sends, rng, t = [], np.random.default_rng(47), 1000
    for i in range(300):
        t += int(rng.integers(1, 30)) + (4000 if i % 100 == 0 else 0)
        sends.append(("S", [int(rng.integers(0, 8)) + 8 * (i // 100),
                            float(rng.uniform(0, 8))], t))
    purge = ("@app:playback @app:execution('tpu', partitions='16') "
             + ABSENT_DEFINE + "@purge(enable='true', interval='1 sec', "
             "idle.period='2 sec') partition with (k of S) begin "
             "@info(name='q') from every a=S[v > 5.0] -> b=S[v > a.v] "
             "within 3 sec select a.v as av, b.v as bv insert into Alerts; "
             "end;")
    line = app_card_vs_cpu(
        torch, SiddhiManager, purge, sends, "purge",
        after=lambda rt: rt.get_input_handler("S").send(
            [999, 0.0], timestamp=t + 10_000))
    if not line["free_rows"]:
        raise AssertionError("purge_check: no row was recycled")
    emit({"phase": "purge_check", **line, "card": card})


def rollup_batches(EventBatch, n):
    """``fraud_batches`` as ``Txn`` batches for ``SiddhiManager``: card
    long, amount double (the float32 amounts widened exactly)."""
    return [EventBatch("Txn", ["card", "amount"],
                       {"card": cols["card"].astype(np.int64),
                        "amount": cols["amount"].astype(np.float64)}, ts)
            for _stream, _part, cols, ts in fraud_batches(n)]


def rollup_start(eng) -> dict:
    """``count_fraud``'s seeded mid-chain start as a runtime snapshot,
    card ``c`` interned on row ``c``: the engine meets the same state and
    batches as in ``count_fraud``."""
    host, base = mid_chain_state(
        eng, seed=len("count_fraud"), within_ms=600_000,
        reg_draw=lambda rng, shape: rng.lognormal(4.0, 1.0, shape))
    P = eng.n_partitions
    return {"dense_state": host, "base_ts": base,
            "key_rows": dict(zip(range(P), range(P))), "next_row": P,
            "free_rows": [], "row_last_used": np.zeros(P, np.int64)}


def run_rollup(torch, SiddhiManager, batches, device, start):
    """``FRAUD_ROLLUP_APP`` on ``device`` from ``start`` (a snapshot, or
    ``start(engine)`` which makes it; returned): every batch through
    ``send_batch`` and ``drain``, synchronised and timed by the host
    clock, with the selector's own host time and input rows (the match
    rows) per batch, and the alerts per batch."""
    from siddhi_tpu_torch.ops.dense_nfa import state_to_numpy

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    mgr = SiddhiManager(device=device)
    rt = new_app(mgr, FRAUD_ROLLUP_APP)
    alerts = [[]]
    rt.add_callback("Alerts", lambda evs: alerts[-1].extend(
        (e.timestamp, [v.hex() if isinstance(v, float) else v
                       for v in e.data]) for e in evs))
    sel = rt.partitions["partition_0"].dense_query_runtimes["fraud"].selector
    sel_s, sel_rows = [0.0], [0]
    inner = sel.process

    def timed(batch, now):
        t = time.perf_counter()
        out = inner(batch, now)
        sel_s[-1] += time.perf_counter() - t
        sel_rows[-1] += len(batch)
        return out

    sel.process = timed
    rt.start()
    proc = rt.pattern_runtimes()["fraud"]
    if callable(start):
        start = start(proc.engine)
    proc.restore(start)
    h = rt.get_input_handler("Txn")
    secs = []
    for i, b in enumerate(batches):
        if i:
            alerts.append([])
            sel_s.append(0.0)
            sel_rows.append(0)
        sync()
        t = time.perf_counter()
        h.send_batch(b)
        rt.drain()
        sync()
        secs.append(time.perf_counter() - t)
    final, _ = state_to_numpy(proc.engine, proc.state)
    return mgr, rt, {"alerts": alerts, "secs": secs, "sel_s": sel_s,
                     "sel_rows": sel_rows, "final": final,
                     "groups": sorted(sel.group_states, key=repr),
                     "start": start, "step_kind": proc.engine.step_kind,
                     "lowering": rt.lowering(step_kinds=True)}


def rollup_phase(torch, SiddhiManager, EventBatch, kernels, card) -> dict:
    """Phase 14: ``fraud_rollup``, BASELINE config 2 at 100,000 cards
    under a per-card aggregating selector through ``SiddhiManager``: the
    dense engine emits the raw captures, the host selector counts,
    maximises and sums per card (the partition-key side channel) and
    filters by ``having``.  From ``count_fraud``'s seeded start, over its
    traffic (2 warm-up and 10 timed batches of 131,072), held bit for
    bit against the same run with ``device="cpu"``: the alerts of every
    batch in order, the selector's groups and the engine's whole final
    state.  Returns the path's launches by kernel (the card run's)."""
    batches = rollup_batches(EventBatch, PB_WARMUP + PB_STEPS)
    for wrappers in kernels.values():
        for k in wrappers:
            k.launches = 0
    mgr, rt, got = run_rollup(torch, SiddhiManager, batches, "cuda",
                              rollup_start)
    launches = {name: sum(k.launches for k in wrappers)
                for name, wrappers in kernels.items()}
    rt.shutdown()
    mgr.shutdown()
    gc.collect()
    t = time.perf_counter()
    cmgr, crt, cpu = run_rollup(torch, SiddhiManager, batches, "cpu",
                                got["start"])
    cpu_s = time.perf_counter() - t
    crt.shutdown()
    cmgr.shutdown()
    bad = [k for k in cpu["final"] if not np.array_equal(
        got["final"][k].view(np.uint8), cpu["final"][k].view(np.uint8))]
    n_out = [len(a) for a in got["alerts"]]
    if (got["alerts"] != cpu["alerts"] or got["groups"] != cpu["groups"]
            or got["sel_rows"] != cpu["sel_rows"] or bad):
        raise AssertionError(f"fraud_rollup: alerts, selector groups, match "
                             f"rows or final state {bad} differ between the "
                             "card and the CPU run")
    if (not sum(n_out) or got["lowering"] != {"fraud": "dense/general"}
            or launches["probe"] != 1
            or any(v for k, v in launches.items() if k != "probe")):
        raise AssertionError(f"fraud_rollup: alerts {n_out}, lowering "
                             f"{got['lowering']}, launches {launches}")
    timed = got["secs"][PB_WARMUP:]
    events = [len(b) for b in batches]
    emit({"phase": "fraud_rollup", "app": FRAUD_ROLLUP_APP,
          "cards": FRAUD_CARDS, "batch": BATCH,
          "warmup_batches": PB_WARMUP, "timed_batches": PB_STEPS,
          "step_kind": got["step_kind"], "lowering": got["lowering"],
          "events_per_s": sum(events[PB_WARMUP:]) / sum(timed),
          "ms_per_batch": 1e3 * sum(timed) / len(timed),
          "batch_ms": [1e3 * x for x in got["secs"]],
          "selector_ms_per_batch": 1e3 * sum(got["sel_s"][PB_WARMUP:])
                                   / len(timed),
          "selector_ms": [1e3 * x for x in got["sel_s"]],
          "match_rows_per_batch": got["sel_rows"],
          "output_rows_per_batch": n_out,
          "selector_groups": len(got["groups"]),
          "bit_exact_alerts": sum(n_out),
          "bit_exact_state": sorted(cpu["final"]),
          "launches": launches, "cpu_seconds": cpu_s, "card": card})
    return launches


def rate_limit_phase(torch, SiddhiManager, card) -> None:
    """Phase 15: ``rate_limit_checks``, card against CPU through
    ``SiddhiManager`` (about 300 events each): unpartitioned dense
    patterns (one partition) under ``output last every 1 sec`` (fired by
    the scheduler's rate task, the emit queue drained first), ``output
    first every 3 events``, ``output snapshot every 1 sec`` and a
    group-by selector with ``output all every 2 events``; an absent
    pattern under a partitioned aggregating selector (its timer-fired
    alerts reach the per-key state); and ``@purge`` dropping a purged
    key's selector state."""
    def tick(t):
        return lambda rt: rt.get_input_handler("T").send([0, 0.0],
                                                         timestamp=t)

    lines = []
    for label, sel in RATE_CHECKS.items():
        sends = absent_sends(len(label), P=4)
        app = ("@app:playback @app:execution('tpu') " + ABSENT_DEFINE
               + f"@info(name='q') from {RATE_PATTERN}{sel} "
               "insert into Alerts;")
        lines.append(app_card_vs_cpu(torch, SiddhiManager, app, sends, label,
                                     after=tick(sends[-1][2] + 5000)))
    sends = absent_sends(53)
    lines.append(app_card_vs_cpu(
        torch, SiddhiManager,
        "@app:playback @app:execution('tpu', partitions='8') "
        + ABSENT_DEFINE + "partition with (k of S, k of T) begin "
        "@info(name='q') from every a=S[v > 5.0] -> not T[v > a.v] for 1 sec "
        "select a.k as ak, count() as n, sum(a.v) as s insert into Alerts; "
        "end;", sends, "absent_partitioned_aggregating",
        after=tick(sends[-1][2] + 5000)))
    # @purge: keys 0-7, then 8-15 (0-7 go idle and are purged), then 0-7
    # again, whose counts must start over
    sends, rng, t = [], np.random.default_rng(59), 1000
    for i in range(300):
        t += int(rng.integers(1, 30)) + (4000 if i % 100 == 0 else 0)
        sends.append(("S", [int(rng.integers(0, 8)) + 8 * ((i // 100) % 2),
                            float(rng.uniform(0, 8))], t))
    purge = ("@app:playback @app:execution('tpu', partitions='16') "
             + ABSENT_DEFINE + "@purge(enable='true', interval='1 sec', "
             "idle.period='2 sec') partition with (k of S) begin "
             "@info(name='q') from every a=S[v > 5.0] -> b=S[v > a.v] "
             "within 3 sec select a.k as ak, count() as n "
             "insert into Alerts; end;")
    seen = []

    def keys(rt):
        qr = rt.partitions["partition_0"].dense_query_runtimes["q"]
        seen.append(({gid[0] for gid in qr.selector.group_states},
                     set(qr.pattern_processor._key_rows)))

    line = app_card_vs_cpu(torch, SiddhiManager, purge, sends, "purge",
                           after=keys)
    # the selector keeps groups of live keys only: keys 8-15, idle in the
    # last hundred events, were purged from both
    groups, live = seen[0]
    if not groups or not groups <= live or any(8 <= k < 16 for k in live):
        raise AssertionError(f"rate_limit_checks: selector groups "
                             f"{sorted(groups)} outlive the live keys "
                             f"{sorted(live)}, or keys 8-15 were not purged")
    lines.append(line)
    for line in lines:
        emit({"phase": "rate_limit_checks", **line, "card": card})


def host_batches(EventBatch):
    """1,000,000 seeded events on ``S`` in batches of 8,192: eight
    symbols, ``price ~ U(1, 500)`` float32, ``volume`` uniform on
    [0, 300), eight events a ms."""
    rng = np.random.default_rng(53)
    syms = np.array(["IBM", "WSO2", "ORCL", "MSFT", "GOOG", "AMZN", "META",
                     "NVDA"], dtype=object)
    out = []
    for lo in range(0, HOST_EVENTS, HOST_BATCH):
        n = min(HOST_BATCH, HOST_EVENTS - lo)
        out.append(EventBatch(
            "S", ["symbol", "price", "volume"],
            {"symbol": syms[rng.integers(0, len(syms), n)],
             "price": rng.uniform(1.0, 500.0, n).astype(np.float32),
             "volume": rng.integers(0, 300, n).astype(np.int64)},
            1000 + (lo + np.arange(n, dtype=np.int64)) // 8))
    return out


def run_host(torch, SiddhiManager, StreamCallback, query, batches, device):
    """One host query over ``batches``; returns the output batches, the
    seconds, the lowering and the card's allocation count across it."""
    allocs = lambda: torch.cuda.memory_stats().get(
        "allocation.all.allocated", 0)
    before = allocs()
    mgr = SiddhiManager() if device is None else SiddhiManager(device=device)
    rt = new_app(mgr, HOST_DEFINE + "@info(name='q') " + query)
    class Rows(StreamCallback):
        """Keeps each output batch as it is (no row events)."""

        def __init__(self):
            self.batches = []

        def receive_batch(self, batch):
            self.batches.append(batch)

    rows = Rows()
    rt.add_callback("Out", rows)
    rt.start()
    h = rt.get_input_handler("S")
    t = time.perf_counter()
    for b in batches:
        h.send_batch(b)
    secs = time.perf_counter() - t
    low = rt.lowering()
    rt.shutdown()
    mgr.shutdown()
    return rows.batches, secs, low, allocs() - before


def host_phase(torch, SiddhiManager, EventBatch, StreamCallback,
               card) -> None:
    """Phase 16: ``host_queries``, a host-only app through
    ``SiddhiManager()`` with its default device (the card): the verify
    skill's filter, a ``#window.time`` average and a ``#window.timeBatch``
    group-by sum over 1,000,000 events in batches of 8,192.  Each must
    report ``host`` lowering, make no allocation on the card, and give
    the same output (columns, timestamps, event types) as the same query
    with ``device="cpu"``; the filter's rows also equal numpy's.  Host
    figures on the card machine's host, with the card line.  Returns
    each query's events/s and output rows."""
    batches = host_batches(EventBatch)
    rates = {}
    for label, query in HOST_QUERIES.items():
        out, secs, low, allocs = run_host(torch, SiddhiManager,
                                          StreamCallback, query, batches,
                                          None)
        cout, csecs, _clow, _ = run_host(torch, SiddhiManager,
                                         StreamCallback, query, batches,
                                         "cpu")
        got = EventBatch.concat(out)
        want = EventBatch.concat(cout)
        same = (np.array_equal(got.timestamps, want.timestamps)
                and np.array_equal(got.types, want.types)
                and all(np.array_equal(got.columns[c], want.columns[c])
                        for c in want.attribute_names))
        if label == "filter":
            keep = np.concatenate([b.columns["volume"] < 150
                                   for b in batches])
            price = np.concatenate([b.columns["price"] for b in batches])
            same = same and np.array_equal(got.columns["price"],
                                           price[keep])
        if not same or low != {"q": "host"} or allocs or not len(got):
            raise AssertionError(f"host_queries {label}: output differs "
                                 f"from the CPU run's, lowering {low}, "
                                 f"{allocs} card allocations, "
                                 f"{len(got)} rows")
        emit({"phase": "host_queries", "query": label,
              "app": HOST_DEFINE + query, "events": HOST_EVENTS,
              "batch": HOST_BATCH, "output_rows": len(got),
              "expired_rows": int((got.types == 1).sum()),
              "events_per_s": HOST_EVENTS / secs, "seconds": secs,
              "cpu_device_events_per_s": HOST_EVENTS / csecs,
              "lowering": low, "card_allocations": allocs,
              "held_vs_cpu_run": True,
              "note": "host figures on the card machine's host",
              "card": card})
        rates[label] = {"events_per_s": HOST_EVENTS / secs,
                        "rows": len(got)}
    return rates


def dq_batches(EventBatch, n_symbols: int, seed: int):
    """DQ_EVENTS seeded events shaped as the reference harness's
    ``cse_batch`` (``samples/performance/workloads.py:35``):
    ``n_symbols`` symbols ``S<i>``, ``price ~ U(100, 1000)`` float32,
    ``volume`` int32 on [0, 300), ``timestamp`` the event time; batches
    of DQ_BATCH, eight events a ms."""
    rng = np.random.default_rng(seed)
    names = np.array([f"S{i}" for i in range(n_symbols)], dtype=object)
    out = []
    for lo in range(0, DQ_EVENTS, DQ_BATCH):
        n = min(DQ_BATCH, DQ_EVENTS - lo)
        ts = 1000 + (lo + np.arange(n, dtype=np.int64)) // 8
        out.append(EventBatch(
            "cseEventStream", ["symbol", "price", "volume", "timestamp"],
            {"symbol": names[rng.integers(0, n_symbols, n)],
             "price": rng.uniform(100.0, 1000.0, n).astype(np.float32),
             "volume": rng.integers(0, 300, n).astype(np.int32),
             "timestamp": ts.copy()}, ts))
    return out


def later_batches(EventBatch, batches, n):
    """``n`` more batches after ``batches``: copies of its first ``n``,
    moved past its last event in time (for the breakdown and the
    profile, after the held run)."""
    shift = int(batches[-1].timestamps[-1] - batches[0].timestamps[0]) + 1
    out = []
    for b in batches[:n]:
        cols = dict(b.columns)
        if "timestamp" in cols:
            cols["timestamp"] = cols["timestamp"] + shift
        out.append(EventBatch(b.stream_id, list(b.attribute_names), cols,
                              b.timestamps + shift))
    return out


def run_dq(torch, SiddhiManager, StreamCallback, app, batches, device,
           kernels):
    """``run_app`` for a ``device_queries`` app: its one output stream,
    the output batches of the first DQ_CHECK input batches kept (the
    rest only counted), the app left running with its manager."""
    out_stream = "Out" if "into Out;" in app else "outputStream"
    return run_app(torch, SiddhiManager, StreamCallback, app, batches,
                   device, kernels, (out_stream,), keep=DQ_CHECK, live=True)


def dq_expected_rows(label: str, batches, host_rows: int) -> int:
    """The output rows of ``label``'s app over ``batches``, counted in
    numpy from the events alone: a filter emits the rows it passes (each
    of ``filter_multi_4q``'s four queries), a running aggregate or a
    sliding window one row an event, ``lengthBatch(10)`` grouped by
    symbol one row for each symbol of every full ten events.  The
    host-lowered ``timeBatch`` sum emits what the ``host_queries`` run of
    the same query emitted (``host_rows``)."""
    def col(c):
        return np.concatenate([b.columns[c] for b in batches])

    n = sum(len(b) for b in batches)
    if label == "host_time_batch_sum":
        return host_rows
    if label in ("host_filter", "simple_filter"):
        return int((col("volume") < 150).sum())
    if label == "filter_multi_4q":
        return 4 * int((col("volume") > 90).sum())
    if label in ("partitioned_filter", "partition_scaling_50000"):
        return int((col("price") < 700).sum())
    if label == "partitioned_double_filter":
        p = col("price")
        return int((p < 700).sum() + (p >= 700).sum())
    if label == "groupby_length_batch_agg_only":
        tens = col("symbol")[:n // 10 * 10].reshape(-1, 10)
        return sum(len(set(r)) for r in tens)
    # host_time_avg, sliding_window, keyed_time_avg_50000
    return n


def dq_held(EventBatch, got):
    """The output of the held batches as one batch (None if empty)."""
    outs = [b for bs in got["outs"].values() for b in bs]
    return EventBatch.concat(outs) if outs else None


def dq_compare(card, other, sum_cols, exact) -> dict:
    """The held output of two runs: timestamps, types, names and every
    column bit for bit, but ``sum_cols`` within the reference's float32
    bound (``rel=1e-4, abs=1e-3``), or bit for bit too when ``exact``.
    Returns the largest differences; raises when outside."""
    if (card is None) != (other is None):
        raise AssertionError("one run emitted nothing")
    if card is None:
        return {"rows": 0, "max_abs_err": 0.0, "max_rel_err": 0.0}
    if (card.attribute_names != other.attribute_names
            or not np.array_equal(card.timestamps, other.timestamps)
            or not np.array_equal(card.types, other.types)):
        raise AssertionError("rows, timestamps or types differ")
    max_abs = max_rel = 0.0
    for c in card.attribute_names:
        a, b = card.columns[c], other.columns[c]
        if a.dtype != b.dtype:
            raise AssertionError(f"column {c}: {a.dtype} vs {b.dtype}")
        if a.dtype.kind == "f":
            d = np.abs(a.astype(np.float64) - b.astype(np.float64))
            if len(d):
                max_abs = max(max_abs, float(d.max()))
                max_rel = max(max_rel, float(
                    (d / np.maximum(np.abs(b), 1e-30)).max()))
            if c in sum_cols and not exact:
                if not np.allclose(a, b, rtol=1e-4, atol=1e-3):
                    raise AssertionError(f"column {c} outside the float32 "
                                         "sum bound")
                continue
            same = np.array_equal(a.view(np.uint8), b.view(np.uint8))
        else:
            same = bool(np.all(a == b))
        if not same:
            raise AssertionError(f"column {c} differs")
    return {"rows": len(card), "max_abs_err": max_abs,
            "max_rel_err": max_rel}


def dq_breakdown(torch, rt, batches) -> dict:
    """Median host-clock ms of each stage of a batch over ``batches``,
    summed over the app's device query runtimes: host preparation and
    interning (``_intern_*``, ``_pad``), the steps (synchronised; for a
    tumbling window, its pane flushes' fetches too), the count fetch,
    the column fetch and the materialize."""
    from siddhi_tpu_torch.core.device_single import DeviceQueryRuntime
    from siddhi_tpu_torch.core.emit_queue import fetch_coalesced

    runtimes = [r for r in rt.device_runtimes().values()
                if isinstance(r, DeviceQueryRuntime)]
    stages = {k: [] for k in ("host_prep_ms", "step_ms", "count_ms",
                              "fetch_ms", "materialize_ms")}
    for b in batches:
        acc = dict.fromkeys(stages, 0.0)
        for r in runtimes:
            eng = r.engine
            prep = [0.0]
            saved = {}
            for name in ("_intern_groups", "_intern_wgroups", "_pad"):
                fn = getattr(eng, name)
                saved[name] = fn

                def timed(*a, fn=fn, **kw):
                    t = time.perf_counter()
                    try:
                        return fn(*a, **kw)
                    finally:
                        prep[0] += time.perf_counter() - t

                setattr(eng, name, timed)
            cols = {a: b.columns[a] for a in eng.all_attrs}
            keys = (np.asarray(b.columns["symbol"].tolist())
                    if eng.partition_mode else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.state, pending = eng.process_batch_deferred(
                r.state, cols, b.timestamps, part_keys=keys)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for name, fn in saved.items():
                delattr(eng, name)
            n = pending.resolve() if pending is not None else 0
            t2 = time.perf_counter()
            host = fetch_coalesced(pending.device_arrays()) if n else []
            t3 = time.perf_counter()
            if n:
                pending.materialize(host)
            t4 = time.perf_counter()
            acc["host_prep_ms"] += 1e3 * prep[0]
            acc["step_ms"] += 1e3 * (t1 - t0 - prep[0])
            for k, x, y in (("count_ms", t1, t2), ("fetch_ms", t2, t3),
                            ("materialize_ms", t3, t4)):
                acc[k] += 1e3 * (y - x)
        for k, v in acc.items():
            stages[k].append(v)
    return {k: sorted(v)[len(v) // 2] for k, v in stages.items()}


def dq_profile(torch, rt, batches) -> dict:
    """``batches`` through the app under ``torch.profiler``: the device
    kernels and copies, the engines' step calls (per-event steps,
    tumbling accumulates and flushes), kernels a step, and the device's
    busy share of the synchronised wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from siddhi_tpu_torch.core.device_single import DeviceQueryRuntime

    engines = [r.engine for r in rt.device_runtimes().values()
               if isinstance(r, DeviceQueryRuntime)]
    calls = [0]
    for eng in engines:
        for name in ("step", "acc_step", "flush_step"):
            fn = getattr(eng, name)

            def counted(*a, fn=fn, **kw):
                calls[0] += 1
                return fn(*a, **kw)

            setattr(eng, name, counted)
    h = rt.get_input_handler(batches[0].stream_id)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            h.send_batch(b)
        rt.drain()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    for eng in engines:
        for name in ("step", "acc_step", "flush_step"):
            delattr(eng, name)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    kernels = len(dev) - len(copies)
    return {"profiled_batches": len(batches),
            "profiled_events": sum(len(b) for b in batches),
            "steps": calls[0],
            "kernels": kernels, "copies": len(copies),
            "kernels_per_step": kernels / calls[0] if calls[0] else None,
            "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy if dev else "not measured",
            "device_busy_share": busy / wall_ms if dev else None}


def dq_state_bytes(rt) -> int:
    from siddhi_tpu_torch.core.device_single import DeviceQueryRuntime

    return sum(t.numel() * t.element_size()
               for r in rt.device_runtimes().values()
               if isinstance(r, DeviceQueryRuntime)
               for t in r.state.values())


def device_query_phase(torch, SiddhiManager, EventBatch, StreamCallback,
                       kernels, card, host_rates) -> dict:
    """Phase 17: ``device_queries``, the port's device query path through
    ``SiddhiManager()`` on the card (every app under ``@app:playback``,
    eight events a ms): the ``host_queries`` stream's three queries
    under ``@app:execution('tpu')`` (``time_batch_sum`` lowers to the
    host, as in the reference: a LONG sum), the reference harness's
    four single-stream workloads over 50 symbols, and its partitioned
    ones with a keyed one-second time window at 50,000 symbols, each
    over 1,000,000 events in batches of 8,192.  Each app's lowering
    must equal its pinned reference value; the output of the first 16
    batches must match the same batches with ``device="cpu"`` (bit for
    bit, but the float32 sum columns within the reference's bound) and a
    second card run bit for bit.  Then a stage breakdown and a profile
    over 4 more batches each.  The ``host_queries`` lines' events/s
    (``host_rates``, this call's) stand beside the device ones.  Returns
    the launches of the timed card runs by kernel, and each app's
    events/s by label."""
    host = host_batches(EventBatch)
    streams = {"host": host, "cse50": dq_batches(EventBatch, 50, 61),
               "cse50000": dq_batches(EventBatch, 50_000, 67)}
    # one short run first: the card's libraries load outside the timings
    warm = run_dq(torch, SiddhiManager, StreamCallback,
                  DEVICE_QUERY_APPS["sliding_window"][0],
                  streams["cse50"][:2], "cuda", kernels)
    warm["rt"].shutdown()
    warm["mgr"].shutdown()
    launches = dict.fromkeys(kernels, 0)
    rates = {}
    for label, (app, pinned) in DEVICE_QUERY_APPS.items():
        t_query = time.perf_counter()
        wall = {}
        stream = ("host" if label.startswith("host_") else
                  "cse50000" if label.endswith("50000") else "cse50")
        batches = streams[stream]
        profiled = DQ_PROFILED
        if label == "groupby_length_batch_agg_only":
            # a flush every 10 events is about 800 flushes a batch, each
            # two fetches: timed over the held batches only, one batch
            # for the breakdown and a quarter batch (about 200 flushes)
            # for the profile (PERF.md §4)
            batches, profiled = batches[:DQ_CHECK], 1
        extra = later_batches(EventBatch, batches, 2 * profiled)
        if profiled == 1:
            extra[1] = extra[1].take(np.arange(DQ_BATCH // 4))
        got = run_dq(torch, SiddhiManager, StreamCallback, app, batches,
                     "cuda", kernels)
        for k, n in got["launches"].items():
            launches[k] += n
        rt = got["rt"]
        state_bytes = dq_state_bytes(rt)
        device = any(v == "device" for v in pinned.values())
        t = time.perf_counter()
        breakdown = (dq_breakdown(torch, rt, extra[:profiled])
                     if device else {})
        prof = dq_profile(torch, rt, extra[profiled:]) if device else {}
        wall["breakdown_and_profile_s"] = time.perf_counter() - t
        rt.shutdown()
        got["mgr"].shutdown()
        if got["lowering"] != pinned:
            raise AssertionError(f"device_queries {label}: lowering "
                                 f"{got['lowering']}, the reference's "
                                 f"{pinned}")
        held = dq_held(EventBatch, got)
        n_rows, secs = got["rows"], got["secs"]
        want_rows = dq_expected_rows(
            label, batches, host_rates["time_batch_sum"]["rows"])
        if n_rows != want_rows:
            raise AssertionError(f"device_queries {label}: {n_rows} output "
                                 f"rows over the timed batches, the events "
                                 f"give {want_rows}")
        del got, rt
        t = time.perf_counter()
        again = run_dq(torch, SiddhiManager, StreamCallback, app,
                       batches[:DQ_CHECK], "cuda", kernels)
        again["rt"].shutdown()
        again["mgr"].shutdown()
        same = dq_compare(held, dq_held(EventBatch, again), (), True)
        del again
        torch.cuda.empty_cache()
        wall["second_card_run_s"] = time.perf_counter() - t
        t = time.perf_counter()
        cpu = run_dq(torch, SiddhiManager, StreamCallback, app,
                     batches[:DQ_CHECK], "cpu", kernels)
        cpu["rt"].shutdown()
        cpu["mgr"].shutdown()
        vs_cpu = dq_compare(held, dq_held(EventBatch, cpu),
                            DQ_SUM_COLUMNS.get(label, ()), False)
        del cpu, held
        wall["cpu_run_s"] = time.perf_counter() - t
        if not same["rows"]:
            raise AssertionError(f"device_queries {label}: no output in the "
                                 "held batches")
        events = sum(len(b) for b in batches)
        rates[label] = events / secs
        wall["query_s"] = time.perf_counter() - t_query
        emit({"phase": "device_queries", "query": label, "app": app,
              "lowering": pinned, "events": events, "batch": DQ_BATCH,
              "timed_batches": len(batches),
              "cut": ("timed over the 16 held batches, not 1,000,000 "
                      "events" if len(batches) == DQ_CHECK else None),
              "events_per_s": events / secs, "seconds": secs,
              "host_runtime_events_per_s": (
                  host_rates[label[len("host_"):]]["events_per_s"]
                  if label.startswith("host_") else None),
              "ms_per_batch": 1e3 * secs / len(batches),
              "output_rows": n_rows, "expected_rows": want_rows,
              "state_bytes": state_bytes,
              "breakdown_ms": breakdown, "profile": prof,
              "held_batches": DQ_CHECK, "held_rows": same["rows"],
              "bit_identical_card_runs": True,
              "vs_cpu": {"sum_columns": list(DQ_SUM_COLUMNS.get(label, ())),
                         "max_abs_err": vs_cpu["max_abs_err"],
                         "max_rel_err": vs_cpu["max_rel_err"]},
              "wall": wall, "card": card})
    return launches, rates


def card_allocs(torch) -> int:
    """The card's allocation calls so far in this process."""
    return torch.cuda.memory_stats().get("allocation.all.allocated", 0)


def zero_launches(kernels) -> None:
    for ws in kernels.values():
        for w in ws:
            w.launches = 0


def read_launches(kernels) -> dict:
    return {k: sum(w.launches for w in ws) for k, ws in kernels.items()}


def run_app(torch, SiddhiManager, StreamCallback, app, batches, device,
            kernels, outs, keep=None, live=False, setup=None):
    """``app`` over ``batches`` (EventBatches of any of its streams, in
    order) through ``SiddhiManager`` on ``device``: the output batches by
    stream (of the first ``keep`` input batches, all when None; ``rows``
    counts every output row), the seconds (synchronised) and the first
    batch's (host clock: per-key instances plan each key on its first
    event), the lowering, the card's allocations and the launches by
    kernel across it, the fallback WARNINGs of its creation, and the
    app runtime: shut down, or with ``live`` still running beside its
    manager (``mgr``).  ``setup(mgr)`` runs before the app is created
    (user extensions)."""
    before = card_allocs(torch)
    zero_launches(kernels)
    warned = ISOLATED.fallbacks
    mgr = SiddhiManager(device=device)
    if setup is not None:
        setup(mgr)
    rt = new_app(mgr, app)
    fallbacks = ISOLATED.fallbacks - warned
    got = {o: [] for o in outs}
    state = {"keep": True, "rows": 0}

    class Rows(StreamCallback):
        """Keeps each held output batch as it is (no row events)."""

        def __init__(self, kept):
            self.kept = kept

        def receive_batch(self, batch):
            state["rows"] += len(batch)
            if state["keep"]:
                self.kept.append(batch)

    for o in outs:
        rt.add_callback(o, Rows(got[o]))
    rt.start()
    handlers = {}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    first = None
    for i, b in enumerate(batches):
        state["keep"] = keep is None or i < keep
        h = handlers.get(b.stream_id)
        if h is None:
            h = handlers[b.stream_id] = rt.get_input_handler(b.stream_id)
        h.send_batch(b)
        if first is None:
            first = time.perf_counter() - t
    rt.drain()
    sync()
    secs = time.perf_counter() - t
    state["keep"] = False
    low = rt.lowering()
    launches = read_launches(kernels)
    run = {"outs": got, "rows": state["rows"], "secs": secs,
           "first_s": first, "lowering": low, "launches": launches,
           "fallbacks": fallbacks, "rt": rt}
    if live:
        run["mgr"] = mgr
    else:
        rt.shutdown()
        mgr.shutdown()
    run["allocs"] = card_allocs(torch) - before
    return run


def held_vs(a, b) -> int:
    """Two runs' output, stream by stream and batch by batch, bit for bit
    (timestamps, types, names, every column); returns the rows held."""
    rows = 0
    for o in a["outs"]:
        x, y = a["outs"][o], b["outs"][o]
        if len(x) != len(y):
            raise AssertionError(f"{o}: {len(x)} output batches, the other "
                                 f"run {len(y)}")
        rows += sum(dq_compare(p, q, (), True)["rows"]
                    for p, q in zip(x, y))
    return rows


def seq3_batches(EventBatch):
    """BASELINE config 1's traffic: ``p ~ U(5, 30)`` float32 (carried in
    the DOUBLE column), one event a ms, batches of HP_BATCH."""
    rng = np.random.default_rng(71)
    out = []
    for lo in range(0, HP_EVENTS, HP_BATCH):
        n = min(HP_BATCH, HP_EVENTS - lo)
        p = rng.uniform(5.0, 30.0, n).astype(np.float32)
        out.append(EventBatch(
            "T", ["key", "p"],
            {"key": np.zeros(n, dtype=np.int64), "p": p.astype(np.float64)},
            1000 + lo + np.arange(n, dtype=np.int64)))
    return out


def seq3_expected(batches):
    """The sequence's rows from the events alone: ``every e1, e2, e3``
    with strict continuity matches each three consecutive events rising
    from above 10 (the window of 1 s spans 1,000 events here), emitted
    at the third: (its timestamp, p1, p3)."""
    p = np.concatenate([b.columns["p"] for b in batches])
    ts = np.concatenate([b.timestamps for b in batches])
    i = np.flatnonzero((p[:-2] > 10.0) & (p[1:-1] > p[:-2])
                       & (p[2:] > p[1:-1]))
    return ts[i + 2], p[i], p[i + 2]


def fraud_part_batches(EventBatch):
    """BASELINE config 2's traffic over FRAUD_KEYS cards: card ids
    uniform, ``amount ~ lognormal(4, 1)`` float32, one event a ms."""
    rng = np.random.default_rng(73)
    out = []
    for lo in range(0, FRAUD_EVENTS, HP_BATCH):
        n = min(HP_BATCH, FRAUD_EVENTS - lo)
        out.append(EventBatch(
            "Txn", ["card", "amount"],
            {"card": rng.integers(0, FRAUD_KEYS, n).astype(np.int64),
             "amount": rng.lognormal(4.0, 1.0, n).astype(np.float32)
             .astype(np.float64)},
            1000 + lo + np.arange(n, dtype=np.int64)))
    return out


def mixed_batches(EventBatch):
    """MIXED_EVENTS events in batches of MIXED_BATCH, the two streams in
    turns, one event a ms: symbols of the corpus, ``price ~ U(5, 30)``,
    ``volume`` uniform on [0, 300)."""
    rng = np.random.default_rng(79)
    syms = np.array(["IBM", "WSO2", "GOOG", "AMBA", "FBX"], dtype=object)
    out = []
    for k, lo in enumerate(range(0, MIXED_EVENTS, MIXED_BATCH)):
        n = MIXED_BATCH
        out.append(EventBatch(
            f"Stream{1 + k % 2}", ["symbol", "price", "volume"],
            {"symbol": syms[rng.integers(0, len(syms), n)],
             "price": rng.uniform(5.0, 30.0, n).astype(np.float32),
             "volume": rng.integers(0, 300, n).astype(np.int32)},
            1000 + lo + np.arange(n, dtype=np.int64)))
    return out


def rows_of(EventBatch, outs) -> list:
    """The output rows of one stream as (timestamp, values) tuples."""
    if not outs:
        return []
    b = EventBatch.concat(outs)
    cols = [b.columns[c].tolist() for c in b.attribute_names]
    return list(zip(b.timestamps.tolist(), *cols))


def host_patterns_phase(torch, SiddhiManager, EventBatch, StreamCallback,
                        kernels, card) -> dict:
    """Phase 18: ``host_patterns``, the host pattern engine and per-key
    instances through ``SiddhiManager()`` on the card, each run held
    against the same run with ``device="cpu"``:

    (a) BASELINE config 1 (a three-state ``every`` sequence, ``within 1
        sec``) in the default mode over 1,000,000 events, also held
        against the rows numpy counts from the events;
    (b) BASELINE config 2 (count_fraud) inside ``partition with (card of
        Txn)`` in the default mode, per-key instances over 1,000 cards and
        262,144 events; then the same traffic under
        ``@app:execution('tpu')`` on the dense path, its rows equal to
        the instances' as sorted multisets;
    (c) an ``execution('tpu')`` app with a dense numeric pattern beside a
        ``symbol string`` select pattern the reference keeps on its host
        engine: lowering {dense, host}, one fallback WARNING.

    The host engine and the instances must make no allocation on the
    card and launch no kernel.  Returns the launches of the dense card
    runs of (b) and (c) by kernel."""
    # (a) ---------------------------------------------------------------
    batches = seq3_batches(EventBatch)
    gc.collect()
    a = run_app(torch, SiddhiManager, StreamCallback, SEQ3_APP, batches,
                "cuda", kernels, ("O",))
    c = run_app(torch, SiddhiManager, StreamCallback, SEQ3_APP,
                batches[:HP_CHECK], "cpu", kernels, ("O",))
    end = batches[HP_CHECK - 1].timestamps[-1]
    held = held_vs({"outs": {"O": [b for b in a["outs"]["O"]
                                   if b.timestamps[-1] <= end]}}, c)
    ts, p1, p3 = seq3_expected(batches)
    got = EventBatch.concat(a["outs"]["O"])
    if (a["lowering"] != {"q": "host"} or a["allocs"] or a["fallbacks"]
            or any(a["launches"].values()) or not len(got)
            or not np.array_equal(got.timestamps, ts)
            or not np.array_equal(got.columns["p1"], p1)
            or not np.array_equal(got.columns["p3"], p3)):
        raise AssertionError(
            f"host_patterns sequence: lowering {a['lowering']}, "
            f"{a['allocs']} card allocations, launches {a['launches']}, "
            f"{len(got)} rows, numpy gives {len(ts)}")
    n_b = len(batches)
    emit({"phase": "host_patterns", "case": "a_baseline_config_1",
          "app": SEQ3_APP, "events": HP_EVENTS, "batch": HP_BATCH,
          "lowering": a["lowering"], "card_allocations": a["allocs"],
          "launches": a["launches"], "fallback_warnings": a["fallbacks"],
          "output_rows": len(got), "held_batches": HP_CHECK,
          "rows_held_vs_cpu_run": held, "rows_held_vs_numpy": len(ts),
          "events_per_s": HP_EVENTS / a["secs"], "seconds": a["secs"],
          "ms_per_batch": 1e3 * a["secs"] / n_b,
          "cpu_device_events_per_s": (HP_CHECK * HP_BATCH / c["secs"]),
          "note": "host figures on the card machine's host",
          "card": card})
    del a, c, batches, got
    # (b) ---------------------------------------------------------------
    batches = fraud_part_batches(EventBatch)
    gc.collect()
    host_app = FRAUD_PART_APP.format("")
    a = run_app(torch, SiddhiManager, StreamCallback, host_app, batches,
                "cuda", kernels, ("Alerts",))
    instances = len(a["rt"].partitions["partition_0"].instances)
    cards = len(np.unique(np.concatenate([b.columns["card"]
                                          for b in batches])))
    c = run_app(torch, SiddhiManager, StreamCallback, host_app,
                batches[:HP_CHECK], "cpu", kernels, ("Alerts",))
    end = batches[HP_CHECK - 1].timestamps[-1]
    held = held_vs({"outs": {"Alerts": [
        b for b in a["outs"]["Alerts"] if b.timestamps[-1] <= end]}}, c)
    dense_app = FRAUD_PART_APP.format(FRAUD_DENSE)
    d = run_app(torch, SiddhiManager, StreamCallback, dense_app, batches,
                "cuda", kernels, ("Alerts",))
    host_rows = rows_of(EventBatch, a["outs"]["Alerts"])
    dense_rows = rows_of(EventBatch, d["outs"]["Alerts"])
    if (a["lowering"] != {"fraud": "host"} or a["allocs"] or a["fallbacks"]
            or any(a["launches"].values()) or not host_rows
            or instances != cards
            or d["lowering"] != {"fraud": "dense"}
            or sorted(dense_rows) != sorted(host_rows)):
        raise AssertionError(
            f"host_patterns count_fraud: lowering {a['lowering']} / dense "
            f"{d['lowering']}, {a['allocs']} card allocations, launches "
            f"{a['launches']}, {instances} instances, {len(host_rows)} "
            f"rows, dense {len(dense_rows)}")
    n_b = len(batches)
    emit({"phase": "host_patterns", "case": "b_count_fraud_partitioned",
          "app": host_app, "keys": FRAUD_KEYS, "events": FRAUD_EVENTS,
          "batch": HP_BATCH, "lowering": a["lowering"],
          "card_allocations": a["allocs"], "launches": a["launches"],
          "fallback_warnings": a["fallbacks"], "instances": instances,
          "output_rows": len(host_rows), "held_batches": HP_CHECK,
          "rows_held_vs_cpu_run": held,
          "events_per_s": FRAUD_EVENTS / a["secs"], "seconds": a["secs"],
          "first_batch_ms": 1e3 * a["first_s"],
          "ms_per_batch_after_first": (1e3 * (a["secs"] - a["first_s"])
                                       / (n_b - 1)),
          "cpu_device_events_per_s": HP_CHECK * HP_BATCH / c["secs"],
          "dense": {"app": dense_app, "lowering": d["lowering"],
                    "events_per_s": FRAUD_EVENTS / d["secs"],
                    "ms_per_batch": 1e3 * d["secs"] / n_b,
                    "card_allocations": d["allocs"],
                    "launches": d["launches"],
                    "rows_equal_as_multisets": True,
                    "same_order": dense_rows == host_rows},
          "note": "host figures on the card machine's host",
          "card": card})
    launches = dict(d["launches"])
    del a, c, d, batches, host_rows, dense_rows
    # (c) ---------------------------------------------------------------
    batches = mixed_batches(EventBatch)
    gc.collect()
    a = run_app(torch, SiddhiManager, StreamCallback, MIXED_APP, batches,
                "cuda", kernels, ("OutputStream",))
    c = run_app(torch, SiddhiManager, StreamCallback, MIXED_APP, batches,
                "cpu", kernels, ("OutputStream",))
    held = held_vs(a, c)
    want = {"dense": "dense", "q": "host"}
    if (a["lowering"] != want or c["lowering"] != want
            or a["fallbacks"] != 1 or c["fallbacks"] != 1 or not held):
        raise AssertionError(
            f"host_patterns mixed: lowering {a['lowering']}, fallback "
            f"WARNINGs {a['fallbacks']} / {c['fallbacks']}, {held} rows")
    emit({"phase": "host_patterns", "case": "c_mixed_dense_and_host",
          "app": MIXED_APP, "events": MIXED_EVENTS, "batch": MIXED_BATCH,
          "lowering": a["lowering"], "fallback_warnings": a["fallbacks"],
          "card_allocations": a["allocs"], "launches": a["launches"],
          "rows_held_vs_cpu_run": held,
          "events_per_s": MIXED_EVENTS / a["secs"], "seconds": a["secs"],
          "ms_per_batch": 1e3 * a["secs"] / len(batches),
          "note": "the dense query's allocations and launches; the host "
                  "query makes none",
          "card": card})
    return {k: v + a["launches"][k] for k, v in launches.items()}


def host_partitions_phase(torch, SiddhiManager, EventBatch, StreamCallback,
                          kernels, card, dq_rates) -> dict:
    """Phase 19: ``host_partitions``, the reference harness's partition
    rows (``samples/performance/workloads.py:164-186``) in the default
    mode, per-key instances through ``SiddhiManager()`` on the card, over
    1,000,000 cse-shaped events each (batches of 8,192, eight events a
    ms): ``partitioned_filter`` and ``partitioned_double_filter`` over 50
    symbols, ``partition_scaling`` at 10, 1,000 and 50,000.  Each must
    report ``host`` lowering, no card allocation and no launch, output
    rows equal to a numpy count of the events, and the first 16 batches'
    output equal to the same batches with ``device="cpu"``.  The
    ``device_queries`` rate of the same query under
    ``@app:execution('tpu')`` (``dq_rates``) stands beside each.
    Returns the launches of the card runs by kernel (all 0)."""
    streams = {}
    total = dict.fromkeys(kernels, 0)
    for label, (n_sym, app, dq_label) in HOST_PARTITION_APPS.items():
        if n_sym not in streams:
            streams.clear()
            gc.collect()
            streams[n_sym] = dq_batches(EventBatch, n_sym, 83 + n_sym % 7)
        batches = streams[n_sym]
        got = run_dq(torch, SiddhiManager, StreamCallback, app, batches,
                     "cuda", kernels)
        instances = len(got["rt"].partitions["partition_0"].instances)
        got["rt"].shutdown()
        got["mgr"].shutdown()
        for k, n in got["launches"].items():
            total[k] += n
        cpu = run_dq(torch, SiddhiManager, StreamCallback, app,
                     batches[:DQ_CHECK], "cpu", kernels)
        cpu["rt"].shutdown()
        cpu["mgr"].shutdown()
        vs_cpu = dq_compare(dq_held(EventBatch, got), dq_held(EventBatch, cpu),
                            (), True)
        price = np.concatenate([b.columns["price"] for b in batches])
        want = (len(price) if label == "partitioned_double_filter"
                else int((price < 700).sum()))
        low, allocs, launches = (got["lowering"], got["allocs"],
                                 got["launches"])
        if (set(low.values()) != {"host"} or allocs or got["fallbacks"]
                or any(launches.values()) or got["rows"] != want
                or not vs_cpu["rows"]):
            raise AssertionError(
                f"host_partitions {label}: lowering {low}, {allocs} card "
                f"allocations, launches {launches}, {got['rows']} "
                f"rows, numpy gives {want}")
        n_b = len(batches)
        secs = got["secs"]
        emit({"phase": "host_partitions", "query": label, "app": app,
              "symbols": n_sym, "events": len(price),
              "batch": DQ_BATCH, "lowering": low, "instances": instances,
              "card_allocations": allocs, "launches": launches,
              "fallback_warnings": got["fallbacks"],
              "output_rows": got["rows"], "numpy_rows": want,
              "held_batches": DQ_CHECK, "rows_held_vs_cpu_run":
                  vs_cpu["rows"],
              "events_per_s": len(price) / secs,
              "seconds": secs, "first_batch_ms": 1e3 * got["first_s"],
              "ms_per_batch_after_first": (1e3 * (secs - got["first_s"])
                                           / (n_b - 1)),
              "device_queries_events_per_s": (
                  dq_rates.get(dq_label)
                  if dq_label == label or n_sym == 50_000 else None),
              "device_queries_label": dq_label,
              "note": "host figures on the card machine's host",
              "card": card})
        del got, cpu
    return total


# -- phases 20-23: the product configuration, auto depths elsewhere, the
# single-key scan engine, user functions --------------------------------------

# bench.py:257-322 bench_product: 3 warm-up batches, then 3 windows of
# the same 10 batches (bench.py:41-57)
PRODUCT_WARMUP = 3
PRODUCT_STEPS = 10
PRODUCT_WINDOWS = 3
PRODUCT_DEPTHS = "ingest.depth='2', emit.depth='auto'"
AUTO_DEPTHS = "ingest.depth='auto', emit.depth='auto'"
FIXED_DEPTHS = "ingest.depth='2', emit.depth='4'"
# the CPU run (c): the warm-up batches and the first 2 timed ones
PRODUCT_CPU_BATCHES = PRODUCT_WARMUP + 2
# compile_scan_pattern: one hot key's stream, 65,536 events a batch
SCAN_EVENTS = 1 << 16
SCAN_BATCHES = 8
SCAN_APPS = {
    # tests/test_nfa_scan.py's three-node chain with within
    "three_node_within": (
        "define stream S (v double, n int); @info(name='q') from every "
        "a=S[v > 10.0] -> b=S[v > 20.0] -> c=S[v > 30.0] within 1 sec "
        "select a.v as av insert into Out;", 50.0),
    # the 16-node capture-free chain (bench.py's kernel_eligible_app)
    "chain_16": (
        "define stream S (v double, n int); @info(name='q') from "
        + " -> ".join(["every e1=S[v > 1.0]"] + [
            f"e{i}=S[v > {float(i)}]" for i in range(2, 17)])
        + " within 10 min select e16.v as v insert into Out;", 20.0),
}
UDF_EVENTS = 1 << 18
UDF_BATCH = 8_192
UDF_APP = (
    "@app:playback @app:execution('tpu') "
    "define function isBig[python] return bool { data[0] > 10 }; "
    "define stream S (k long, v double); "
    "@info(name='q') from S[isBig(k) and custom:scale(v) > 5.0] "
    "select k, v, custom:scale(v) as sv, isBig(k) as big insert into Out;")


def partitioned(flat: str) -> str:
    """A flat pattern app's query inside ``partition with (key of Txn)``
    (``bench.py``'s ``partitioned_app``)."""
    i = flat.index("@info")
    return (flat[:i] + "partition with (key of Txn) begin " + flat[i:]
            + " end;")


def product_app(depths: str, capturing: bool = True) -> str:
    body = flat_app() if capturing else kernel_eligible_app()
    sep = ", " if depths else ""
    return ("@app:playback @app:execution('tpu', "
            f"partitions='{N_PARTITIONS}'{sep}{depths}) " + partitioned(body))


def product_batches(EventBatch):
    """``bench.py``'s ``_product_batches(WARMUP + PRODUCT_STEPS,
    N_PARTITIONS, BATCH)``: seed 11, stride-walked keys, v ~ U(0, 20),
    one timestamp a batch."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(PRODUCT_WARMUP + PRODUCT_STEPS):
        keys = ((np.arange(BATCH, dtype=np.int64) * 524287 + i * BATCH)
                % N_PARTITIONS)
        v = rng.uniform(0.0, float(N_STATES + 4), BATCH)
        out.append(EventBatch("Txn", ["key", "v"], {"key": keys, "v": v},
                              np.full(BATCH, 1_000 + i * 10,
                                      dtype=np.int64)))
    return out


def run_product(torch, SiddhiManager, StreamCallback, app, device, batches,
                windows, start, kernels):
    """bench_product's sends through ``SiddhiManager`` on ``device``: the
    warm-up batches, then ``windows`` windows of the timed ones (each
    drained and synchronised at its end), from ``start``, a seeded
    mid-chain state restored into the dense runtime (key ``k`` on row
    ``k``).  Keeps every callback batch; returns the runtime's counters,
    ``pattern_state()`` and the launches from the app's creation (its
    engine's probe) to the last send."""
    zero_launches(kernels)
    mgr = SiddhiManager(device=device)
    rt = new_app(mgr, app)
    pr = rt.partitions["partition_0"]
    if not pr.is_dense:
        raise AssertionError("product app failed to lower densely")
    runtime = pr.dense_query_runtimes["bench"].pattern_processor
    kept = []

    class Keep(StreamCallback):
        def receive_batch(self, batch):
            kept.append(batch)

    rt.add_callback("Alerts", Keep())
    rt.start()
    host, base_ts = start
    runtime.restore({"dense_state": host, "base_ts": base_ts,
                     "key_rows": dict(zip(range(N_PARTITIONS),
                                          range(N_PARTITIONS))),
                     "next_row": N_PARTITIONS, "free_rows": []})
    h = rt.get_input_handler("Txn")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    for b in batches[:PRODUCT_WARMUP]:
        h.send_batch(b)
    window_s = []
    for _w in range(windows):
        sync()
        t = time.perf_counter()
        for b in batches[PRODUCT_WARMUP:]:
            h.send_batch(b)
        rt.drain()
        sync()
        window_s.append(time.perf_counter() - t)
    launches = read_launches(kernels)
    # the interning share of a batch, as bench_product measures it
    keys = np.asarray(batches[PRODUCT_WARMUP].columns["key"])
    t = time.perf_counter()
    for _ in range(5):
        runtime.intern_keys(keys)
    intern_s = (time.perf_counter() - t) / 5
    state = rt.pattern_state()
    es, ist = runtime.emit_stats, runtime.ingest_stats
    steps = max(runtime.step_invocations, 1)
    events = BATCH * PRODUCT_STEPS
    out = {"outs": {"Alerts": kept}, "window_s": window_s,
           "pattern_state": state, "launches": launches,
           "step_kind": runtime.engine.step_kind,
           "counters": {
               "events_per_s_windows": [events / s for s in window_s],
               "intern_share": (intern_s * len(window_s) * PRODUCT_STEPS
                                / max(sum(window_s), 1e-9)),
               "matches": sum(len(b) for b in kept),
               "emit_transfers_per_batch": es.emit_transfers / steps,
               "zero_match_skip_rate": es.zero_match_skips / steps,
               "max_pending_emit_depth": es.max_pending_depth,
               "auto_emit_depth": es.auto_depth,
               "ingest_auto_depth": ist.auto_depth,
               "ingest_overlapped_batches": ist.overlapped_batches,
               "ingest_stalls": ist.ingest_stalls,
               "ingest_max_staging_depth": ist.max_staging_depth,
               "emit": es.as_dict(), "ingest": ist.as_dict()}}
    rt.shutdown()
    mgr.shutdown()
    return out


def product_phase(torch, SiddhiManager, EventBatch, StreamCallback,
                  kernels, card) -> dict:
    """Phase 20: ``product``, bench_product's app and traffic at full
    size: (a) at ``ingest.depth='2', emit.depth='auto'``, (b) the same at
    depths 1/1, whose callback batches and ``pattern_state()`` must
    equal (a)'s bit for bit, (c) ``device="cpu"`` at (a)'s depths over
    the first 5 batches, held to (a)'s batches over them, and (d) the
    capture-free chain (the batch-step kernel's class) in the same
    partition at (a)'s depths and at ``FIXED_DEPTHS`` against itself at
    1/1.  Each run starts
    from one seeded mid-chain state so every batch matches.  Returns
    the launches of (a) and (d) by kernel."""
    from siddhi_tpu_torch.ops.dense_nfa import compile_pattern

    batches = product_batches(EventBatch)
    lines = {}
    launches = dict.fromkeys(kernels, 0)
    for capturing, label in ((True, "product"), (False, "product_batch")):
        eng = compile_pattern(kernel_eligible_app() if not capturing
                              else flat_app(), "bench",
                              n_partitions=N_PARTITIONS,
                              n_instances=N_INSTANCES, device="cpu")
        start = mid_chain_state(eng, seed=29 if capturing else 31)
        del eng
        auto = run_product(torch, SiddhiManager, StreamCallback,
                           product_app(PRODUCT_DEPTHS, capturing), "cuda",
                           batches, PRODUCT_WINDOWS, start, kernels)
        for k, n in auto["launches"].items():
            launches[k] += n
        gc.collect()
        one = run_product(torch, SiddhiManager, StreamCallback,
                          product_app("", capturing), "cuda", batches,
                          PRODUCT_WINDOWS, start, kernels)
        held = held_vs(auto, one)
        # (d) once more with a fixed emit window of 4: several batches'
        # pending outputs wait while later batch steps write the state
        # in place, then leave in one coalesced fetch
        fixed = (None if capturing else run_product(
            torch, SiddhiManager, StreamCallback,
            product_app(FIXED_DEPTHS, capturing), "cuda", batches,
            PRODUCT_WINDOWS, start, kernels))
        if fixed is not None:
            if (fixed["pattern_state"] != one["pattern_state"]
                    or fixed["counters"]["max_pending_emit_depth"] < 2):
                raise AssertionError(f"{label}: at {FIXED_DEPTHS}: "
                                     f"{fixed['pattern_state']} "
                                     f"{fixed['counters']}")
            held_fixed = held_vs(fixed, one)
        if auto["pattern_state"] != one["pattern_state"]:
            raise AssertionError(f"{label}: pattern_state() differs between "
                                 f"the depths: {auto['pattern_state']} "
                                 f"{one['pattern_state']}")
        n_batches = PRODUCT_WARMUP + PRODUCT_STEPS * PRODUCT_WINDOWS
        want_batch = 0 if capturing else n_batches
        if (auto["launches"]["dense_batch"] != want_batch
                or auto["launches"]["probe"] < 1
                or auto["launches"]["dense_step"]
                or auto["launches"]["scan_chain"]):
            raise AssertionError(f"{label}: launches {auto['launches']}")
        if not auto["counters"]["matches"]:
            raise AssertionError(f"{label}: no matches")
        line = {"phase": label, "partitions": N_PARTITIONS, "batch": BATCH,
                "warmup_batches": PRODUCT_WARMUP, "windows": PRODUCT_WINDOWS,
                "timed_batches_a_window": PRODUCT_STEPS,
                "step_kind": auto["step_kind"],
                "start": "a seeded mid-chain state restored into the dense "
                         "runtime (key k on row k)",
                "rows_held_depths": held,
                "pattern_state": auto["pattern_state"]["bench"],
                "launches": auto["launches"],
                "depths_a": auto["counters"],
                "depths_1": one["counters"]}
        if fixed is not None:
            line.update(rows_held_depths_2_4=held_fixed,
                        depths_2_4=fixed["counters"])
        del one, fixed
        gc.collect()
        if capturing:
            # (c): the CPU at (a)'s depths over the first batches
            cpu_batches = batches[:PRODUCT_CPU_BATCHES]
            t = time.perf_counter()
            cpu = run_product(torch, SiddhiManager, StreamCallback,
                              product_app(PRODUCT_DEPTHS), "cpu",
                              cpu_batches, 1, start, kernels)
            cpu_s = time.perf_counter() - t
            n_cpu = len(cpu["outs"]["Alerts"])
            head = {"outs": {"Alerts": auto["outs"]["Alerts"][:n_cpu]}}
            held_cpu = held_vs(head, cpu)
            nxt = auto["outs"]["Alerts"][n_cpu:n_cpu + 1]
            if nxt and int(nxt[0].timestamps[0]) <= int(
                    cpu_batches[-1].timestamps[0]):
                raise AssertionError("product: the card run has more output "
                                     "over the CPU run's batches")
            line.update(rows_held_vs_cpu=held_cpu, cpu_seconds=cpu_s,
                        cpu_cut=f"the CPU run takes the {PRODUCT_WARMUP} "
                                "warm-up batches and the first 2 timed "
                                f"ones ({PRODUCT_CPU_BATCHES} of "
                                f"{n_batches})")
            del cpu
        line["card"] = card
        lines[label] = line
        del auto
        gc.collect()
        torch.cuda.empty_cache()
    for line in lines.values():
        emit(line)
    return launches


def other_auto_phase(torch, SiddhiManager, EventBatch, StreamCallback,
                     kernels, card, routed) -> dict:
    """Phase 21: ``auto_depths``: the ``sliding_window`` device query and
    ``partition_scaling_50000`` (a per-key running count, whose state
    scatters are ``accumulate_``) at ``ingest.depth='auto',
    emit.depth='auto'`` against their depth-1 runs (rows of every batch
    bit for bit), and the skew-routed run at auto
    depths against phase 6's routed run (callbacks and state after the
    first window), with ``HotKeyRouter.stats()``.  Returns both runs'
    launches by kernel."""
    dq_launches = dict.fromkeys(kernels, 0)
    for label, n_symbols, seed in (("sliding_window", 50, 61),
                                   ("partition_scaling_50000", 50_000, 67)):
        app1, pinned = DEVICE_QUERY_APPS[label]
        app = app1.replace("partitions='65536')",
                           f"partitions='65536', {AUTO_DEPTHS})")
        if app == app1:
            raise AssertionError(f"{label}: no execution annotation")
        batches = dq_batches(EventBatch, n_symbols, seed)
        one = run_app(torch, SiddhiManager, StreamCallback, app1, batches,
                      "cuda", kernels, ("outputStream",), live=True)
        auto = run_app(torch, SiddhiManager, StreamCallback, app, batches,
                       "cuda", kernels, ("outputStream",), live=True)
        for k, n in auto["launches"].items():
            dq_launches[k] += n
        held = held_vs(auto, one)
        dq_rt = auto["rt"]._all_query_runtimes()["q0"].device_runtime
        dq_counters = {"emit": dq_rt.emit_stats.as_dict(),
                       "ingest": dq_rt.ingest_stats.as_dict()}
        for run in (one, auto):
            run["rt"].shutdown()
            run["mgr"].shutdown()
        if (auto["lowering"] != pinned or held != auto["rows"]
                or not held or any(v for k, v in auto["launches"].items()
                                   if k != "bank_scatter")):
            raise AssertionError(f"{label} at auto depths: lowering "
                                 f"{auto['lowering']}, held {held} of "
                                 f"{auto['rows']}, launches "
                                 f"{auto['launches']}")
        emit({"phase": "auto_depths", "path": "device_query", "app": label,
              "events": DQ_EVENTS, "batch": DQ_BATCH,
              "rows_held_vs_depth_1": held,
              "events_per_s": DQ_EVENTS / auto["secs"],
              "events_per_s_depth_1": DQ_EVENTS / one["secs"],
              **dq_counters, "launches": auto["launches"], "card": card})
    # the running count's state scatters are kernel 3's accumulate_
    if dq_launches["bank_scatter"] < 1:
        raise AssertionError(f"device queries at auto depths launched no "
                             f"accumulate_: {dq_launches}")

    bs = hot_key_batches(EventBatch)
    keep = HK_WARMUP + HK_STEPS
    zero_launches(kernels)
    mgr, rt, got = run_hot_key(torch, SiddhiManager, EventBatch, bs, "cuda",
                               True, HK_WINDOWS, keep, depths=AUTO_DEPTHS)
    hk_launches = read_launches(kernels)
    router = rt.pattern_runtimes()["q"]
    stats = router.stats()
    dense = router._dense
    counters = {"emit": dense.emit_stats.as_dict(),
                "ingest": dense.ingest_stats.as_dict()}
    rt.shutdown()
    mgr.shutdown()
    as_rows = lambda kept: [[(e.timestamp, e.data) for e in evs]
                            for evs in kept]
    if as_rows(got["kept"]) != as_rows(routed["kept"]):
        raise AssertionError("routed callbacks at auto depths differ from "
                             "the depth-1 routed run")
    state_diff = tree_diff(got["state"], routed["state"])
    if state_diff:
        raise AssertionError(f"routed state at auto depths differs: "
                             f"{state_diff}")
    n_hk = HK_WARMUP + HK_STEPS * HK_WINDOWS
    if (hk_launches["dense_batch"] != n_hk or hk_launches["scan_chain"] < 1
            or stats["engine"] != "hotkey"
            or stats["hotkeyPromotions"] < 1):
        raise AssertionError(f"routed run at auto depths: launches "
                             f"{hk_launches}, stats {stats}")
    steady = HK_BATCH * HK_STEPS
    emit({"phase": "auto_depths", "path": "skew_routed",
          "bit_exact_cycles_vs_depth_1": keep,
          "bit_exact_state_vs_depth_1": sorted(got["state"]),
          "events_per_s_windows": [steady / t for t in got["window_s"]],
          "events_per_s": steady * HK_WINDOWS / sum(got["window_s"]),
          "events_per_s_depth_1": steady * HK_WINDOWS
                                  / sum(routed["window_s"]),
          "router_stats": stats, **counters, "launches": hk_launches,
          "card": card})
    return {k: dq_launches[k] + hk_launches[k] for k in kernels}


def scan_engine_phase(torch, card) -> None:
    """Phase 22: ``scan_engine``, ``compile_scan_pattern`` on the card
    against ``device="cpu"`` over one hot key's seeded stream, 65,536
    events a batch, 8 batches: the same detections and starts, live
    state lanes bit-equal.  Events/s on the card (synchronised a batch)
    and on the CPU, and one batch's kernels under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from siddhi_tpu_torch.ops.nfa_scan import NEG, compile_scan_pattern

    for label, (app, v_high) in SCAN_APPS.items():
        rng = np.random.default_rng(37)
        batches = []
        t0 = 1000
        for _ in range(SCAN_BATCHES + 1):
            ts = t0 + np.cumsum(rng.integers(0, 20, SCAN_EVENTS))
            t0 = int(ts[-1]) + 1
            batches.append(({"v": rng.uniform(0.0, v_high, SCAN_EVENTS),
                             "n": rng.integers(0, 5, SCAN_EVENTS)},
                            ts.astype(np.int64)))
        card_eng = compile_scan_pattern(app, "q", device="cuda")
        cpu_eng = compile_scan_pattern(app, "q", device="cpu")
        gs, cs = card_eng.init_state(), cpu_eng.init_state()
        card_s, cpu_s, detections = [], 0.0, 0
        for cols, ts in batches[:SCAN_BATCHES]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            gs, gi, gst = card_eng.process(gs, cols, ts)
            torch.cuda.synchronize()
            card_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            cs, ci, cst = cpu_eng.process(cs, cols, ts)
            cpu_s += time.perf_counter() - t
            gv, cv = gs.cpu().numpy(), cs.numpy()
            live = cv > NEG / 2
            if not (np.array_equal(gi, ci) and np.array_equal(gst, cst)
                    and np.array_equal(live, gv > NEG / 2)
                    and gv[live].tobytes() == cv[live].tobytes()):
                raise AssertionError(f"scan engine ({label}): the card "
                                     "differs from the CPU run")
            detections += len(gi)
        if not detections:
            raise AssertionError(f"scan engine ({label}): no detections")
        cols, ts = batches[SCAN_BATCHES]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            card_eng.process(gs, cols, ts)
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
        emit({"phase": "scan_engine", "case": label,
              "nodes": card_eng.n_nodes, "events_a_batch": SCAN_EVENTS,
              "batches": SCAN_BATCHES, "detections": detections,
              "bit_exact_vs_cpu": True,
              "chunk_events": card_eng._chunk_len(),
              "events_per_s": SCAN_EVENTS * SCAN_BATCHES / sum(card_s),
              "batch_ms": [1e3 * s for s in card_s],
              "cpu_events_per_s": SCAN_EVENTS * SCAN_BATCHES / cpu_s,
              "kernels_per_batch": len(dev) - len(copies),
              "copies_per_batch": len(copies),
              "device_us_per_batch": sum(e.time_range.elapsed_us()
                                         for e in dev),
              "card": card})


def udf_batches(EventBatch):
    rng = np.random.default_rng(41)
    out = []
    for lo in range(0, UDF_EVENTS, UDF_BATCH):
        ts = 1000 + (lo + np.arange(UDF_BATCH, dtype=np.int64)) // 8
        out.append(EventBatch("S", ["k", "v"], {
            "k": rng.integers(0, 20, UDF_BATCH).astype(np.int64),
            "v": np.round(rng.uniform(0.0, 100.0, UDF_BATCH), 3)}, ts))
    return out


def functions_phase(torch, SiddhiManager, EventBatch, StreamCallback,
                    kernels, card) -> dict:
    """Phase 23: ``functions``, a ``[python]`` script function and a
    ``FunctionExecutor`` extension in a filter and a select under
    ``@app:execution('tpu')``: the query falls back to the host with one
    WARNING, launches nothing, and gives the ``device="cpu"`` run's rows
    and numpy's count.  Then the manager's ``validate_siddhi_app`` and
    ``get_siddhi_app_runtimes()``.  Returns the card run's launches."""
    from siddhi_tpu_torch.extension.function import FunctionExecutor
    from siddhi_tpu_torch.query_api import AttrType

    class Scale(FunctionExecutor):
        return_type = AttrType.DOUBLE

        def execute(self, v):
            return v * 0.5

    setup = lambda mgr: mgr.set_extension("custom:scale", Scale,
                                          kind="function")
    batches = udf_batches(EventBatch)
    card_run = run_app(torch, SiddhiManager, StreamCallback, UDF_APP,
                       batches, "cuda", kernels, ("Out",), setup=setup)
    cpu_run = run_app(torch, SiddhiManager, StreamCallback, UDF_APP,
                      batches, "cpu", kernels, ("Out",), setup=setup)
    held = held_vs(card_run, cpu_run)
    want = sum(int(((b.columns["k"] > 10)
                    & (b.columns["v"] * 0.5 > 5.0)).sum()) for b in batches)
    if (card_run["lowering"] != {"q": "host"} or card_run["fallbacks"] != 1
            or any(card_run["launches"].values())
            or card_run["rows"] != want or held != want):
        raise AssertionError(f"functions: lowering {card_run['lowering']}, "
                             f"fallbacks {card_run['fallbacks']}, launches "
                             f"{card_run['launches']}, rows "
                             f"{card_run['rows']}, held {held}, numpy {want}")
    mgr = SiddhiManager()
    setup(mgr)
    mgr.validate_siddhi_app(UDF_APP)
    try:
        mgr.validate_siddhi_app(UDF_APP.replace("isBig(k)", "nope(k)"))
        bad = "accepted"
    except Exception as e:  # the refusal is the result
        bad = f"{type(e).__name__}: {e}"
    rt = mgr.create_siddhi_app_runtime("@app:name('udfApp') " + UDF_APP)
    runtimes = sorted(mgr.get_siddhi_app_runtimes())
    rt.shutdown()
    mgr.shutdown()
    if runtimes != ["udfApp"] or bad == "accepted":
        raise AssertionError(f"manager APIs: runtimes {runtimes}, "
                             f"invalid app {bad}")
    n_batches = len(batches)
    emit({"phase": "functions", "events": UDF_EVENTS, "batch": UDF_BATCH,
          "lowering": card_run["lowering"],
          "fallback_warnings": card_run["fallbacks"],
          "rows": card_run["rows"], "rows_numpy": want,
          "rows_held_vs_cpu": held,
          "events_per_s": UDF_EVENTS / card_run["secs"],
          "ms_a_batch": 1e3 * card_run["secs"] / n_batches,
          "cpu_events_per_s": UDF_EVENTS / cpu_run["secs"],
          "card_allocations": card_run["allocs"],
          "launches": card_run["launches"],
          "validate_siddhi_app": "valid",
          "validate_unknown_function": bad,
          "get_siddhi_app_runtimes": runtimes, "card": card})
    return card_run["launches"]


# -- joins and tables (ROADMAP.md items 8 and 9) ------------------------------

# (a) the Siddhi 5.1 query guide's stream join at fleet size: 10,000
# rooms, Temp batches of 8,192 events one a ms, temp ~ N(28, 4) (about
# 31% pass the filter), Regulator batches of 2,048 over the same 8.192 s
# (isOn true at p = 0.5); 8 warm-up turn pairs (65.5 s of stream, which
# fills the minute window), 16 timed, 2 for the breakdown, 2 profiled
JOIN_ROOMS = 10_000
JOIN_TEMP_BATCH = 8_192
JOIN_REG_BATCH = 2_048
JOIN_WARMUP = 8
JOIN_PAIRS = 16
JOIN_EXTRA = 2  # pairs for the breakdown, and again for the profile
JOIN_T0 = 1_000_000
JOIN_DEFINE = ("define stream TempStream (deviceID long, roomNo int, "
               "temp double); ")
JOIN_STREAM_APP = (
    "@app:playback @app:execution('tpu') " + JOIN_DEFINE
    + "define stream RegulatorStream (deviceID long, roomNo int, isOn bool); "
    "@info(name='q') from TempStream[temp > 30.0]#window.time(1 min) as T "
    "join RegulatorStream[isOn == false]#window.length(1) as R "
    "on T.roomNo == R.roomNo select T.roomNo, R.deviceID, 'start' as action "
    "insert into RegulatorActionStream;")
# (b) the query guide's table join: 10,000 rooms' types (10% server
# rooms) loaded by an insert query, then Temp batches of 8,192, 2 warm-up
# and 10 timed
TABLE_ROOMS = 10_000
TABLE_WARMUP = 2
TABLE_STEPS = 10
JOIN_TABLE_APP = (
    "@app:playback @app:execution('tpu') " + JOIN_DEFINE
    + "define stream RoomTypeStream (roomNo int, type string); "
    "define table RoomTypeTable (roomNo int, type string); "
    "@info(name='load') from RoomTypeStream insert into RoomTypeTable; "
    "@info(name='q') from TempStream join RoomTypeTable "
    "on RoomTypeTable.roomNo == TempStream.roomNo "
    "select deviceID, RoomTypeTable.type as roomType, temp "
    "having roomType == 'server-room' insert into ServerRoomTempStream;")
# (c) samples/performance/workloads.py:187-235 verbatim
# (NoIndexingTablePerformance.java:80): 1,000 table rows, StockCheckStream
# batches of 512 joined on the string symbol, in the default mode and
# under execution('tpu'); 50 timed batches each
NOINDEX_ROWS = 1_000
NOINDEX_BATCH = 512
NOINDEX_BATCHES = 50
NOINDEX_APP = (
    "define stream StockInputStream (symbol string, company string, "
    "price float, volume long); "
    "define stream StockCheckStream (symbol string, company string, "
    "timestamp long); "
    "define table StockTable (symbol string, company string, "
    "price float, volume long); "
    "from StockInputStream select symbol, company, price, volume "
    "insert into StockTable; "
    "from StockCheckStream join StockTable "
    "on StockCheckStream.symbol == StockTable.symbol "
    "select StockCheckStream.timestamp, StockCheckStream.symbol, "
    "StockCheckStream.company as company, StockTable.price as price "
    "insert into OutputStream;")
# (d) small checks, card against CPU: tests/test_device_join.py's shapes
JC_DEFINE = ("define stream A (sym string, x double, n int); "
             "define stream B (sym2 string, y double, m int); ")
JOIN_CHECKS = {
    "length_length": "from A#window.length(3) join B#window.length(3) "
                     "on A.x < B.y",
    "time_time": "from A#window.time(500 ms) join B#window.time(500 ms) "
                 "on A.x >= B.y",
    "compound_filters": "from A[x > 1.0]#window.length(4) join "
                        "B[y < 9.0]#window.length(4) on A.x < B.y and "
                        "A.n != B.m",
    "left_outer": "from A#window.length(2) left outer join "
                  "B#window.length(2) on A.x < B.y",
    "unidirectional": "from A#window.length(3) unidirectional join "
                      "B#window.length(3) on A.x < B.y",
    "expired_pairs": "from A#window.length(1) join B#window.length(2) "
                     "on A.x <= B.y",
}
JC_SELECT = " select A.sym as s, A.x as x, B.y as y, A.n as n insert into O;"
AGG_JOIN_APP = (
    "define stream S (k int, v double); define stream Q (k int); "
    "define aggregation Agg from S select k, sum(v) as total "
    "group by k aggregate every sec ... min; "
    "@info(name='q') from Q as q join Agg as a on q.k == a.k "
    "within 0L, 9000000000000L per 'seconds' "
    "select q.k as k, a.total as total insert into O;")
WINDOW_TRIGGER_APP = (
    "define stream S (sym string, v int); "
    "define trigger T at every 200 milliseconds; "
    "define window W (sym string, v int) length(4) output all events; "
    "from S insert into W; "
    "@info(name='w') from W select sym, sum(v) as total insert into O; "
    "@info(name='t') from T join W select T.triggered_time as t, "
    "W.sym as sym, W.v as v insert into O2;")
PULL_APP = (
    "@app:execution('tpu', emit.depth='4') "
    "define stream Txn (card long, amount double); "
    "define table Alerts (card long, amount double); "
    "@info(name='p') from every e1=Txn[amount > 100.0] -> "
    "e2=Txn[card == e1.card and amount > e1.amount] "
    "select e1.card as card, e2.amount as amount insert into Alerts;")
PULLS = (
    ("find", "from Alerts select card, amount;"),
    ("update", "select 1L as card, 999.0 as amount update Alerts set "
               "Alerts.amount = amount on Alerts.card == card;"),
    ("find", "from Alerts on card == 1L select card, amount;"),
    ("delete", "select 2L as card delete Alerts on Alerts.card == card;"),
    ("update_or_insert", "select 77L as card, 1.5 as amount update or "
                         "insert into Alerts set Alerts.amount = amount on "
                         "Alerts.card == card;"),
    ("find", "from Alerts select card, sum(amount) as total group by card "
             "order by card;"))


def join_stream_batches(EventBatch, n_pairs, seed=61):
    """Turn pairs of (a): a Temp batch and the Regulator batch over the
    same 8.192 s of stream."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_pairs):
        t0 = JOIN_T0 + i * JOIN_TEMP_BATCH
        nt, nr = JOIN_TEMP_BATCH, JOIN_REG_BATCH
        out.append(EventBatch("TempStream", ["deviceID", "roomNo", "temp"], {
            "deviceID": rng.integers(0, 1_000_000, nt).astype(np.int64),
            "roomNo": rng.integers(0, JOIN_ROOMS, nt).astype(np.int32),
            "temp": rng.normal(28.0, 4.0, nt)},
            t0 + np.arange(nt, dtype=np.int64)))
        out.append(EventBatch("RegulatorStream",
                              ["deviceID", "roomNo", "isOn"], {
            "deviceID": rng.integers(0, 1_000_000, nr).astype(np.int64),
            "roomNo": rng.integers(0, JOIN_ROOMS, nr).astype(np.int32),
            "isOn": rng.random(nr) < 0.5},
            t0 + 4 * np.arange(nr, dtype=np.int64)))
    return out


def table_batches(EventBatch, n, seed=67):
    """(b): the room types (one batch), then ``n`` Temp batches."""
    rng = np.random.default_rng(seed)
    rooms = np.arange(TABLE_ROOMS, dtype=np.int32)
    types = np.where(rng.random(TABLE_ROOMS) < 0.1, "server-room", "office")
    out = [EventBatch("RoomTypeStream", ["roomNo", "type"], {
        "roomNo": rooms, "type": types.astype(object)},
        np.full(TABLE_ROOMS, JOIN_T0 - 1, dtype=np.int64))]
    for i in range(n):
        t0 = JOIN_T0 + i * JOIN_TEMP_BATCH
        out.append(EventBatch("TempStream", ["deviceID", "roomNo", "temp"], {
            "deviceID": rng.integers(0, 1_000_000, JOIN_TEMP_BATCH).astype(
                np.int64),
            "roomNo": rng.integers(0, TABLE_ROOMS, JOIN_TEMP_BATCH).astype(
                np.int32),
            "temp": rng.normal(28.0, 4.0, JOIN_TEMP_BATCH)},
            t0 + np.arange(JOIN_TEMP_BATCH, dtype=np.int64)))
    return out


def noindex_batches(EventBatch, n, seed=3):
    """(c): ``workloads.py``'s table load, then ``n`` copies of its check
    batch."""
    rng = np.random.default_rng(seed)
    syms = np.asarray([f"S{i}" for i in range(NOINDEX_ROWS)], dtype=object)
    load = EventBatch(
        "StockInputStream", ["symbol", "company", "price", "volume"],
        {"symbol": syms, "company": syms,
         "price": rng.uniform(1, 100, NOINDEX_ROWS).astype(np.float32),
         "volume": rng.integers(1, 100, NOINDEX_ROWS).astype(np.int64)},
        np.zeros(NOINDEX_ROWS, dtype=np.int64))
    check = EventBatch(
        "StockCheckStream", ["symbol", "company", "timestamp"],
        {"symbol": np.asarray([f"S{int(i)}" for i in rng.integers(
            0, NOINDEX_ROWS, NOINDEX_BATCH)], dtype=object),
         "company": np.asarray(["c"] * NOINDEX_BATCH, dtype=object),
         "timestamp": np.zeros(NOINDEX_BATCH, dtype=np.int64)},
        np.zeros(NOINDEX_BATCH, dtype=np.int64))
    return [load] + [check] * n


def join_runtimes(rt):
    return [qr.join_runtime for qr in rt.query_runtimes.values()
            if qr.join_runtime is not None]


def run_join_app(torch, SiddhiManager, StreamCallback, app, setup, timed,
                 device, kernels, outs):
    """``setup`` then ``timed`` batches (each batch timed, synchronised)
    through ``SiddhiManager`` on ``device``; the output batches by stream,
    the seconds, the lowering, the launches by kernel over the whole run,
    the probe's counters over the timed batches, and the live runtime
    and manager (``rt``, ``mgr``) for the breakdown."""
    zero_launches(kernels)
    warned = ISOLATED.fallbacks
    mgr = SiddhiManager(device=device)
    rt = new_app(mgr, app)
    fallbacks = ISOLATED.fallbacks - warned
    got = {o: [] for o in outs}

    class Rows(StreamCallback):
        def __init__(self, kept):
            self.kept = kept

        def receive_batch(self, batch):
            self.kept.append(batch)

    for o in outs:
        rt.add_callback(o, Rows(got[o]))
    rt.start()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    send = lambda b: rt.get_input_handler(b.stream_id).send_batch(b)
    for b in setup:
        send(b)
    rt.drain()
    sync()
    jrs = join_runtimes(rt)
    probes = [j.device_probe for j in jrs if j.device_probe is not None]

    def counters():
        return {"calls": sum(j.probe_invocations for j in jrs),
                "blocks": sum(p.blocks for p in probes),
                "fetches": sum(p.fetches for p in probes),
                "bytes": sum(p.bytes_fetched for p in probes),
                "puts": sum(p.ingest_stats.device_puts for p in probes)}

    c0 = counters()
    batch_s = []
    for b in timed:
        t = time.perf_counter()
        send(b)
        sync()
        batch_s.append(time.perf_counter() - t)
    t = time.perf_counter()
    rt.drain()
    sync()
    drain_s = time.perf_counter() - t
    c1 = counters()
    # the output up to here: what the other run is held against
    return {"outs": {o: list(v) for o, v in got.items()},
            "secs": sum(batch_s) + drain_s, "batch_s": batch_s,
            "lowering": rt.lowering(), "launches": read_launches(kernels),
            "fallbacks": fallbacks,
            "probe": {k: c1[k] - c0[k] for k in c0}, "rt": rt, "mgr": mgr}


def close_run(run) -> None:
    run["rt"].shutdown()
    run["mgr"].shutdown()


def join_breakdown(torch, rt, batches) -> dict:
    """Host-clock ms a batch of each stage of the join over ``batches``,
    each timed piece synchronised: side filters, windows (their
    expiry on the scheduler too), the other side's buffer, the probe's
    put, mask and fetch, the pairs' materialization (the rest of the
    probe call) and the selector with the output."""
    jr = join_runtimes(rt)[0]
    probe = jr.device_probe
    ms = {k: 0.0 for k in ("filters", "windows", "buffer", "probe_put",
                           "mask", "fetch", "probe_call", "selector")}
    sync = torch.cuda.synchronize

    def wrap(obj, name, key):
        fn = getattr(obj, name)

        def timed(*a, **kw):
            sync()
            t = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            ms[key] += 1e3 * (time.perf_counter() - t)
            return out

        setattr(obj, name, timed)

    for side in (jr.left, jr.right):
        wrap(side, "buffered", "buffer")
        for f in side.filters:
            wrap(f, "process", "filters")
        if side.window is not None:
            wrap(side.window, "process", "windows")
            wrap(side.window, "on_time", "windows")
    if probe is not None:
        wrap(probe, "_stage", "probe_put")
        wrap(probe, "_device_mask", "mask")
        wrap(probe, "_fetch", "fetch")
    wrap(jr, "_join", "probe_call")
    wrap(jr, "emit", "selector")
    b0 = probe.bytes_fetched if probe is not None else 0
    c0 = jr.probe_invocations
    t = time.perf_counter()
    for b in batches:
        rt.get_input_handler(b.stream_id).send_batch(b)
    rt.drain()
    sync()
    wall = 1e3 * (time.perf_counter() - t)
    n = len(batches)
    # the probe call holds the other side's buffer, the put, the mask and
    # the fetch; the selector runs after the probe calls of a batch
    ms["materialize"] = (ms["probe_call"] - ms["buffer"] - ms["probe_put"]
                         - ms["mask"] - ms["fetch"])
    # without the device probe, materialize holds the numpy probe's
    # cross product too
    return {"probe": "device" if probe is not None else "numpy",
            **{f"{k}_ms_a_batch": v / n for k, v in ms.items()},
            "wall_ms_a_batch": wall / n,
            "probe_calls_a_batch": (jr.probe_invocations - c0) / n,
            "bytes_fetched_a_batch": ((probe.bytes_fetched - b0) / n
                                      if probe is not None else 0)}


def join_profile(torch, rt, batches) -> dict:
    def run():
        for b in batches:
            rt.get_input_handler(b.stream_id).send_batch(b)
        rt.drain()

    p = device_profile(torch, run)
    return {k: p[k] for k in ("profiled_wall_ms", "device_busy_ms",
                              "device_busy_share", "top_device_ops_ms")}


def join_line(label, card_run, cpu_run, n_timed_events, held, extra, card):
    pr = card_run["probe"]
    n = len(card_run["batch_s"])
    return {"phase": label, "lowering": card_run["lowering"],
            "events_per_s": n_timed_events / card_run["secs"],
            "ms_a_batch": 1e3 * card_run["secs"] / n,
            "cpu_events_per_s": n_timed_events / cpu_run["secs"],
            "rows_held_vs_cpu": held,
            "probe_calls_a_batch": pr["calls"] / n,
            "mask_blocks_a_batch": pr["blocks"] / n,
            "fetches_a_batch": pr["fetches"] / n,
            "bytes_fetched_a_batch": pr["bytes"] / n,
            "launches": card_run["launches"],
            "fallback_warnings": card_run["fallbacks"], **extra,
            "card": card}


def joins_phase(torch, SiddhiManager, EventBatch, StreamCallback, kernels,
                card) -> dict:
    """Phase 24 (a)-(b): ``join_stream`` and ``join_table`` through
    ``SiddhiManager()`` on the card, each held bit for bit against the
    ``device="cpu"`` run of the same sends (rows, order, timestamps,
    types, values), each lowered to ``device_probe`` with probe calls
    above 0; events/s, the breakdown and the device's busy share.
    Returns the launches of both card runs (no hand-written kernel is on
    this path)."""
    launches = {k: 0 for k in kernels}
    # (a) join_stream
    total = JOIN_WARMUP + JOIN_PAIRS + 2 * JOIN_EXTRA
    bs = join_stream_batches(EventBatch, total)
    warm, timed = bs[:2 * JOIN_WARMUP], bs[2 * JOIN_WARMUP:
                                          2 * (JOIN_WARMUP + JOIN_PAIRS)]
    extra = bs[2 * (JOIN_WARMUP + JOIN_PAIRS):]
    out = ("RegulatorActionStream",)
    card_run = run_join_app(torch, SiddhiManager, StreamCallback,
                            JOIN_STREAM_APP, warm, timed, "cuda", kernels,
                            out)
    for k, v in card_run["launches"].items():
        launches[k] += v
    rt = card_run["rt"]
    window_rows = len(join_runtimes(rt)[0].left.window.buffered())
    bd = join_breakdown(torch, rt, extra[:2 * JOIN_EXTRA])
    prof = join_profile(torch, rt, extra[2 * JOIN_EXTRA:])
    close_run(card_run)
    cpu_run = run_join_app(torch, SiddhiManager, StreamCallback,
                           JOIN_STREAM_APP, warm, timed, "cpu", kernels, out)
    close_run(cpu_run)
    held = held_vs(card_run, cpu_run)
    if (card_run["lowering"] != {"q": "device_probe"}
            or card_run["probe"]["calls"] <= 0 or not held
            or any(card_run["launches"].values())):
        raise AssertionError(f"join_stream: lowering {card_run['lowering']}, "
                             f"probe {card_run['probe']}, held {held}, "
                             f"launches {card_run['launches']}")
    n_ev = JOIN_PAIRS * (JOIN_TEMP_BATCH + JOIN_REG_BATCH)
    emit(join_line("join_stream", card_run, cpu_run, n_ev, held, {
        "rooms": JOIN_ROOMS, "temp_batch": JOIN_TEMP_BATCH,
        "regulator_batch": JOIN_REG_BATCH, "warmup_pairs": JOIN_WARMUP,
        "timed_pairs": JOIN_PAIRS, "temp_window_rows": window_rows,
        "ms_a_turn_pair": 1e3 * card_run["secs"] / JOIN_PAIRS,
        "breakdown": bd, "profile": prof}, card))

    # (b) join_table
    tb = table_batches(EventBatch, TABLE_WARMUP + TABLE_STEPS + 2)
    setup, timed = tb[:1 + TABLE_WARMUP], tb[1 + TABLE_WARMUP:
                                            1 + TABLE_WARMUP + TABLE_STEPS]
    extra = tb[1 + TABLE_WARMUP + TABLE_STEPS:]
    out = ("ServerRoomTempStream",)
    card_run = run_join_app(torch, SiddhiManager, StreamCallback,
                            JOIN_TABLE_APP, setup, timed, "cuda", kernels,
                            out)
    for k, v in card_run["launches"].items():
        launches[k] += v
    rt = card_run["rt"]
    table_rows = len(rt.tables["RoomTypeTable"])
    bd = join_breakdown(torch, rt, extra[:1])
    prof = join_profile(torch, rt, extra[1:])
    close_run(card_run)
    cpu_run = run_join_app(torch, SiddhiManager, StreamCallback,
                           JOIN_TABLE_APP, setup, timed, "cpu", kernels, out)
    close_run(cpu_run)
    held = held_vs(card_run, cpu_run)
    if (card_run["lowering"].get("q") != "device_probe"
            or card_run["probe"]["calls"] <= 0 or not held
            or table_rows != TABLE_ROOMS
            or any(card_run["launches"].values())):
        raise AssertionError(f"join_table: lowering {card_run['lowering']}, "
                             f"probe {card_run['probe']}, held {held}, "
                             f"table rows {table_rows}, launches "
                             f"{card_run['launches']}")
    emit(join_line("join_table", card_run, cpu_run,
                   TABLE_STEPS * JOIN_TEMP_BATCH, held, {
                       "table_rows": table_rows,
                       "temp_batch": JOIN_TEMP_BATCH,
                       "warmup_batches": TABLE_WARMUP,
                       "timed_batches": TABLE_STEPS,
                       "breakdown": bd, "profile": prof}, card))
    return launches


def typed_rows(events) -> list:
    """Events as (timestamp, expired, typed values), floats by their
    bits."""
    def typed(v):
        if isinstance(v, float):
            return ("float", v.hex())
        return (type(v).__name__, v)

    return [(e.timestamp, e.is_expired, tuple(typed(v) for v in e.data))
            for e in events]


def app_steps_card_vs_cpu(SiddhiManager, app, steps, outs) -> dict:
    """``app`` through ``SiddhiManager()`` on the card and on the CPU: the
    callbacks' events of ``outs`` and every pull's rows, typed, in
    order; raises unless equal.  Steps: ``("send", stream, row, ts)``,
    ``("batch", EventBatch)`` or ``("query", label, q)``."""
    runs = []
    for device in ("cuda", "cpu"):
        mgr = SiddhiManager(device=device)
        try:
            rt = new_app(mgr, "@app:playback " + app)
            got = []
            for o in outs:
                rt.add_callback(o, lambda evs, o=o: got.append(
                    (o, typed_rows(evs))))
            rt.start()
            pulls = {}
            for step in steps:
                if step[0] == "send":
                    rt.get_input_handler(step[1]).send(step[2], step[3])
                elif step[0] == "batch":
                    rt.get_input_handler(step[1].stream_id).send_batch(
                        step[1])
                else:
                    rows = typed_rows(rt.query(step[2]))
                    got.append((step[1], rows))
                    pulls[step[1]] = pulls.get(step[1], 0) + 1
            calls = sum(j.probe_invocations for j in join_runtimes(rt))
            runs.append({"got": got, "lowering": rt.lowering(),
                         "calls": calls, "pulls": pulls})
            rt.shutdown()
        finally:
            mgr.shutdown()
    card, cpu = runs
    if card["got"] != cpu["got"] or card["lowering"] != cpu["lowering"]:
        raise AssertionError(f"card and CPU differ: lowering "
                             f"{card['lowering']} vs {cpu['lowering']}")
    return {"lowering": card["lowering"], "probe_calls": card["calls"],
            "outputs": len(card["got"]),
            "rows": sum(len(r) for _o, r in card["got"]),
            "pulls": card["pulls"]}


def jc_events(n=300, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sid = "A" if rng.integers(2) else "B"
        out.append(("send", sid, [f"s{int(rng.integers(4))}",
                                  float(rng.integers(0, 10)),
                                  int(rng.integers(0, 5))],
                    1000 + i * int(rng.integers(1, 60))))
    return out


def join_check_phase(SiddhiManager, EventBatch, card) -> None:
    """Phase 24 (d): about 300 events each, card against CPU:
    ``tests/test_device_join.py``'s shapes under ``execution('tpu')`` and
    a null in a numeric column (one numpy batch), an aggregation join
    with ``within``/``per``, a named window and a trigger feeding
    queries, and pulls (FIND, update, delete, update or insert) on a
    table a dense pattern inserts into with queued emits."""
    for k, (label, shape) in enumerate(JOIN_CHECKS.items()):
        app = ("@app:execution('tpu') " + JC_DEFINE + "@info(name='j') "
               + shape + JC_SELECT)
        r = app_steps_card_vs_cpu(SiddhiManager, app, jc_events(300, k),
                                  ("O",))
        if r["lowering"] != {"j": "device_probe"} or r["probe_calls"] <= 0:
            raise AssertionError(f"join check {label}: {r}")
        emit({"phase": "join_check", "case": label, **r, "card": card})
    # a null in a numeric column: that batch alone takes the numpy probe
    xs = np.empty(3, dtype=object)
    xs[:] = [1.0, None, 3.0]
    steps = [("send", "B", ["b", 5.0, 0], 1),
             ("batch", EventBatch("A", ["sym", "x", "n"], {
                 "sym": np.array(["a1", "a2", "a3"], dtype=object), "x": xs,
                 "n": np.zeros(3, dtype=np.int32)},
                 np.array([2, 3, 4], dtype=np.int64))),
             ("send", "A", ["a4", 2.0, 1], 5)]
    app = ("@app:execution('tpu') " + JC_DEFINE + "@info(name='j') "
           "from A#window.length(3) join B#window.length(3) on A.x < B.y"
           + JC_SELECT)
    r = app_steps_card_vs_cpu(SiddhiManager, app, steps, ("O",))
    # B probes an empty window; A's null batch takes the numpy probe and
    # A's last event the device probe
    if r["probe_calls"] != 1 or r["rows"] != 3:
        raise AssertionError(f"join check null_batch: {r}")
    emit({"phase": "join_check", "case": "null_batch", **r,
          "numpy_batches": 1, "card": card})
    # an aggregation join with within/per
    rng = np.random.default_rng(71)
    steps = []
    for i in range(300):
        if rng.random() < 0.8:
            steps.append(("send", "S", [int(rng.integers(5)),
                                        float(rng.integers(1, 50))],
                          1000 + 7 * i))
        else:
            steps.append(("send", "Q", [int(rng.integers(6))],
                          1000 + 7 * i))
    r = app_steps_card_vs_cpu(SiddhiManager, "@app:execution('tpu') "
                              + AGG_JOIN_APP, steps, ("O",))
    if r["lowering"] != {"q": "device_probe"} or not r["rows"]:
        raise AssertionError(f"join check aggregation: {r}")
    emit({"phase": "join_check", "case": "aggregation_within_per", **r,
          "card": card})
    # a named window and a trigger feeding queries
    steps = [("send", "S", [f"k{int(rng.integers(4))}",
                            int(rng.integers(0, 100))], 5000 + 13 * i)
             for i in range(300)]
    r = app_steps_card_vs_cpu(SiddhiManager, "@app:execution('tpu') "
                              + WINDOW_TRIGGER_APP, steps, ("O", "O2"))
    if not r["rows"]:
        raise AssertionError(f"named window and trigger: {r}")
    emit({"phase": "join_check", "case": "named_window_trigger", **r,
          "card": card})


def tables_phase(torch, SiddhiManager, EventBatch, StreamCallback, kernels,
                 card) -> dict:
    """Phase 24 (c) and the pull barrier: ``table_noindex``
    (``workloads.py:187-235``) in the default mode and under
    ``execution('tpu')``, where its string condition keeps the numpy
    probe (0 probe calls, 0 launches), each held against the
    ``device="cpu"`` run; then pulls on a table a dense pattern under
    ``execution('tpu', emit.depth='4')`` inserts into.  Returns the
    launches of the table runs."""
    launches = {k: 0 for k in kernels}
    bs = noindex_batches(EventBatch, NOINDEX_BATCHES)
    rates = {}
    for mode, prefix in (("default", ""), ("tpu", "@app:execution('tpu') ")):
        app = "@app:playback " + prefix + NOINDEX_APP
        card_run = run_join_app(torch, SiddhiManager, StreamCallback, app,
                                bs[:1], bs[1:], "cuda", kernels,
                                ("OutputStream",))
        for k, v in card_run["launches"].items():
            launches[k] += v
        bd = join_breakdown(torch, card_run["rt"], bs[1:3])
        prof = join_profile(torch, card_run["rt"], bs[1:3])
        close_run(card_run)
        cpu_run = run_join_app(torch, SiddhiManager, StreamCallback, app,
                               bs[:1], bs[1:], "cpu", kernels,
                               ("OutputStream",))
        close_run(cpu_run)
        held = held_vs(card_run, cpu_run)
        want = NOINDEX_BATCH * NOINDEX_BATCHES
        if (held != want or card_run["probe"]["calls"]
                or any(card_run["launches"].values())
                or card_run["lowering"].get("query_1") != "host"):
            raise AssertionError(f"table_noindex {mode}: held {held} of "
                                 f"{want}, probe {card_run['probe']}, "
                                 f"launches {card_run['launches']}, "
                                 f"lowering {card_run['lowering']}")
        rates[mode] = want / card_run["secs"]
        emit(join_line("table_noindex", card_run, cpu_run, want, held, {
            "mode": mode, "table_rows": NOINDEX_ROWS,
            "batch": NOINDEX_BATCH, "timed_batches": NOINDEX_BATCHES,
            "breakdown": bd, "profile": prof}, card))
    # pulls on a table a dense pattern writes through its emit queue
    rng = np.random.default_rng(73)
    steps, t = [], 1000
    for i in range(300):
        t += int(rng.integers(1, 20))
        steps.append(("send", "Txn", [int(rng.integers(0, 6)),
                                      float(rng.integers(50, 400))], t))
        if i % 50 == 49:
            label, q = PULLS[(i // 50) % len(PULLS)]
            steps.append(("query", label, q))
    steps.extend(("query", label, q) for label, q in PULLS)
    zero_launches(kernels)
    r = app_steps_card_vs_cpu(SiddhiManager, PULL_APP, steps, ())
    pull_launches = read_launches(kernels)
    if r["lowering"] != {"p": "dense"} or not r["rows"]:
        raise AssertionError(f"table pulls: {r}")
    emit({"phase": "table_pulls", **r,
          "pattern_launches_card_and_cpu": pull_launches, "card": card})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2

    # the port's warnings still reach stderr; its errors also fail the run
    logging.basicConfig(format="%(levelname)s %(name)s: %(message)s")
    logging.getLogger("siddhi_tpu_torch").addHandler(ISOLATED)
    from siddhi_tpu_torch import (
        SiddhiManager,
        compile_pattern,
        state_from_numpy,
        state_to_numpy,
    )
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.core.stream import StreamCallback
    from siddhi_tpu_torch.kernels import (
        bank_scatter,
        build,
        dense_batch,
        dense_step,
        probe,
        scan_chain,
    )
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
    # kernel, library call, kernel, library call: the host moves both
    probe_t = [call_times(torch, lambda: probe.add_one(x)),
               call_times(torch, lambda: torch.add(x, 1)),
               call_times(torch, lambda: probe.add_one(x)),
               call_times(torch, lambda: torch.add(x, 1))]
    probe_line = {
        "phase": "probe", "ok": True, **probe_t[2],
        "plain_ms": time_ms(torch, lambda: probe.add_one_plain(x), 200),
        "library_ms": probe_t[3]["ms"],
        "library_host_us": probe_t[3]["host_us"],
        "library_device_us": probe_t[3]["device_us"],
        "first_round": {"kernel": probe_t[0], "library": probe_t[1]},
        "bound_ms": 1e3 * 2 * x.numel() * 4 / HBM_BYTES_PER_S,
        "bound_by": "bytes"}
    emit(probe_line)

    # 3. packed step vs its plain version --------------------------------------
    step_err = 0
    step_cases = ([(N_STATES, N_INSTANCES, B, WITHIN_MS)
                   for B in (BATCH, 40, 1000, 1056)]
                  + [(*ROUTED_STEP, B, None) for B in ROUTED_STEP_BATCHES])
    for S, I, B, within in step_cases:
        ins = packed_inputs(torch, pack_bits, dense_step._batch_blocks,
                            S, I, B, within, seed=B, device=dev)
        got = dense_step.packed_step(*ins, n_inst=I, within=within)
        want = dense_step.packed_step_plain(*ins, I, within)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err:
            raise AssertionError(f"dense_step kernel differs from its plain "
                                 f"version at S={S}, I={I}, B={B}, within="
                                 f"{within}: max |diff| {err}")
        step_err = max(step_err, err)
        first, ts = ins[2], ins[3]
        expired = (int(((first > 0) & (ts - first > within)).sum())
                   if within is not None else None)
        overflow = int(want[4].sum())
        # one event rarely meets eight busy lanes; every other case must
        # reach the placement overflow, and expiry where there is within
        if expired == 0 or (B > 1 and not overflow):
            raise AssertionError(f"S={S}, I={I}, B={B}: inputs exercise no "
                                 f"expiry ({expired}) or no overflow "
                                 f"({overflow})")
        line = {"phase": "packed_step", "S": S, "I": I, "B": B,
                "within": within, "bit_exact": True, "expired": expired,
                "overflow": overflow}
        if B in (BATCH, ROUTED_STEP_BATCHES[0]):
            W = ins[0].shape[1]
            line.update(
                **call_times(torch, lambda: dense_step.packed_step(
                    *ins, n_inst=I, within=within), 50, 10),
                plain_ms=time_ms(torch, lambda: dense_step.packed_step_plain(
                    *ins, I, within), 10),
                bound_ms=packed_step_bound_ms(S, I, W), bound_by="bytes",
                library_ms=None)
            if B == BATCH:
                step_line = line
        emit(line)

    # 4. end to end at full size ---------------------------------------------
    app = kernel_eligible_app()
    for k in (probe.add_one, dense_batch.batch_step, dense_step.packed_step):
        k.launches = 0
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
                "dense_batch": dense_batch.batch_step.launches,
                "dense_step": dense_step.packed_step.launches}
    final, _ = state_to_numpy(eng, state)
    breakdown = batch_breakdown(
        torch, eng, state,
        [("Txn", *e2e_batch(rng, E2E_BATCHES + i)) for i in range(8)])
    # one more batch's inputs at the kernel's boundary, for phase 7
    full_case = capture_batch_step(lambda: eng.process(
        state, "Txn", *e2e_batch(rng, E2E_BATCHES + 8)))
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
    # one batch step a batch; the packed step is off the main path
    if (launches["dense_batch"] != E2E_BATCHES or launches["dense_step"]
            or launches["probe"] < 1):
        raise AssertionError(f"kernel launches on the main path: {launches}")
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

    # 5. scan kernel vs its plain version -------------------------------------
    scan_err = 0.0
    scan_lines = {}
    for H, n, S in SCAN_SHAPES:
        ins = scan_inputs(torch, H, n, S, seed=H * n + S, device=dev)
        got = scan_chain.fused_scan(*ins)
        want = scan_chain.fused_scan_plain(*ins)
        torch.cuda.synchronize()
        if not bits_equal(torch, got, want):
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            raise AssertionError(f"scan_chain kernel differs from its plain "
                                 f"version at H={H}, n={n}, S={S}: max "
                                 f"|diff| {err}")
        emits = int((want[2] > 0).sum())
        if not emits:
            raise AssertionError(f"H={H}, n={n}, S={S}: inputs emit nothing")
        line = {"phase": "scan_kernel", "H": H, "n": n, "S": S,
                "bit_exact": True, "emitting_events": emits,
                **call_times(torch, lambda: scan_chain.fused_scan(*ins), 50,
                             10),
                "plain_ms": time_ms(torch, lambda: scan_chain.fused_scan_plain(
                    *ins), 1, warmup=1),
                "library_ms": None, **scan_bound(H, n, S)}
        scan_lines[(H, n, S)] = line
        emit(line)
    scan_line = scan_lines[SCAN_SHAPES[0]]

    # 6. skew-routed end to end ------------------------------------------------
    bs = hot_key_batches(EventBatch)
    for k in (probe.add_one, dense_batch.batch_step, dense_step.packed_step,
              scan_chain.fused_scan):
        k.launches = 0
    keep = HK_WARMUP + HK_STEPS
    mgr, rt, routed = run_hot_key(torch, SiddhiManager, EventBatch, bs,
                                  "cuda", True, HK_WINDOWS, keep)
    hk_launches = {"probe": probe.add_one.launches,
                   "dense_batch": dense_batch.batch_step.launches,
                   "dense_step": dense_step.packed_step.launches,
                   "scan_chain": scan_chain.fused_scan.launches}
    router = rt.pattern_runtimes()["q"]
    counters = router.hot_metrics()
    hk_state_bytes = sum(t.numel() * t.element_size() for t in
                         [*router._dense.state.values(),
                          *router._state.values()])
    lowering = rt.lowering()
    hk_breakdown = routed_breakdown(torch, rt, bs, EventBatch)
    # one more routed batch's cold sub-batch at the kernel's boundary
    last = bs[HK_WARMUP + 4]
    cold_case = capture_batch_step(lambda: rt.get_input_handler(
        "S").send_batch(EventBatch(
            last.stream_id, last.attribute_names, last.columns,
            last.timestamps + (HK_WINDOWS + 3) * 1_000_000, last.types)))
    rt.shutdown()
    mgr.shutdown()
    dmgr, drt, dense_only = run_hot_key(torch, SiddhiManager, EventBatch, bs,
                                        "cuda", False, HK_DENSE_WINDOWS, 0)
    drt.shutdown()
    dmgr.shutdown()
    cmgr, crt, cpu_run = run_hot_key(torch, SiddhiManager, EventBatch, bs,
                                     "cpu", True, 1, keep)
    crt.shutdown()
    cmgr.shutdown()
    as_rows = lambda kept: [[(e.timestamp, e.data) for e in evs]
                            for evs in kept]
    if as_rows(routed["kept"]) != as_rows(cpu_run["kept"]):
        raise AssertionError("routed callbacks differ between the card and "
                             "the CPU run")
    state_diff = tree_diff(routed["state"], cpu_run["state"])
    if state_diff:
        raise AssertionError(f"routed state after the first window differs "
                             f"between the card and the CPU run: {state_diff}")
    if counters["hotkeyPromotions"] < 1 or lowering != {"q": "hotkey"}:
        raise AssertionError(f"no promotion under Zipf(1.2) skew: "
                             f"{counters} {lowering}")
    # bench.py's own check, routed rows == dense-only rows, over the
    # warm-up and the first window.  It is exact while neither run drops
    # a pending instance at its lane capacity (instances='8').  A dense
    # row with no free lane for an advancing chain drops it (counted in
    # `overflow`); the scan keeps exact counts, so the routed run drops
    # only on its cold keys, which the dense-only run drops alike.  In
    # this two-node chain a dropped chain costs at most one match, so the
    # routed run may emit up to (dense-only drops - routed drops) more.
    # On numpy 2.3.5's Zipf stream from seed 23 the JAX package itself
    # emits 43,939 routed and 43,938 dense-only rows, dropping 2 and 3
    # (tests/test_torch_hotkey_card_stream.py replays that stream).
    n_cmp = HK_WARMUP + HK_STEPS * HK_DENSE_WINDOWS
    routed_rows = sum(routed["rows"][:n_cmp])
    dense_rows = sum(dense_only["rows"])
    extra_drops = dense_only["overflow"] - routed["overflow"]
    if not (routed_rows > 0 and extra_drops >= 0
            and dense_rows <= routed_rows <= dense_rows + extra_drops):
        raise AssertionError(
            f"routed run emitted {routed_rows} rows ({routed['overflow']} "
            f"dropped), dense-only {dense_rows} ({dense_only['overflow']} "
            "dropped)")
    # one batch step per batch (every batch has cold keys), one scan per
    # batch; the packed step is off the main path
    n_hk = HK_WARMUP + HK_STEPS * HK_WINDOWS
    if (hk_launches["dense_batch"] != n_hk or hk_launches["dense_step"]
            or hk_launches["scan_chain"] < 1 or hk_launches["probe"] < 1):
        raise AssertionError(f"kernel launches on the skew-routed path: "
                             f"{hk_launches}")
    steady = HK_BATCH * HK_STEPS
    hk_rate = steady * HK_WINDOWS / sum(routed["window_s"])
    dense_rate = (steady * HK_DENSE_WINDOWS / sum(dense_only["window_s"]))
    dense_longest = [int(np.unique(b.columns["k"],
                                   return_counts=True)[1].max())
                     for b in bs[HK_WARMUP:]]
    emit({"phase": "skew_routed", "keys": HK_KEYS, "batch": HK_BATCH,
          "windows": HK_WINDOWS, "dense_only_windows": HK_DENSE_WINDOWS,
          "cut": "the dense-only run takes 1 window of 8, not 3; its rows "
                 "are compared with the routed run's first window",
          "bit_exact_cycles_vs_cpu": keep,
          "bit_exact_state_vs_cpu": sorted(routed["state"]),
          "events_per_s_windows": [steady / t for t in routed["window_s"]],
          "events_per_s": hk_rate,
          "dense_events_per_s": dense_rate,
          "vs_dense": hk_rate / dense_rate,
          "rows_compared": {"routed": routed_rows, "dense_only": dense_rows},
          "dropped_instances": {"routed": routed["overflow"],
                                "dense_only": dense_only["overflow"]},
          "state_bytes": hk_state_bytes,
          **counters,
          "dense_only_longest_segment_per_batch": dense_longest,
          "routed_cold_longest_segment_per_batch":
              hk_breakdown["longest_segment"],
          "launches": hk_launches, "card": card})
    emit(hk_breakdown)

    # 7. batch step vs its plain version ----------------------------------------
    sm_clock_hz = 1e6 * float(card_line("clocks.max.sm").split()[0])
    batch_lines = {
        "1M": hold_batch_step(torch, dense_batch, full_case,
                              "1M mid-chain batch", sm_clock_hz, 3),
        "routed": hold_batch_step(torch, dense_batch, cold_case,
                                  "routed cold sub-batch", sm_clock_hz, 1)}
    del full_case, cold_case
    for S, I, N, P, within, long_seg in BATCH_EDGE_CASES:
        batch_lines[(S, I, N)] = hold_batch_step(
            torch, dense_batch, batch_step_case(
                torch, S, I, N, P, within, seed=S * I + N, device=dev,
                long_seg=long_seg), f"S={S}, I={I}, N={N}", sm_clock_hz)
    for line in batch_lines.values():
        emit(line)
    batch_err = max(line["max_abs_err"] for line in batch_lines.values())

    # 8. bank kernel vs its plain version -------------------------------------
    bank_err = 0.0
    bank_lines = {}
    red_of = {"sum": "sum", "count": "sum", "min": "amin", "max": "amax"}
    for label, rows, vals, r_pad, op, ident in bank_cases(torch, dev):
        got = bank_scatter.segmented_reduce(rows, vals, r_pad, op, ident)
        again = bank_scatter.segmented_reduce(rows, vals, r_pad, op, ident)
        want = bank_scatter.segmented_reduce_plain(rows, vals, r_pad, op, ident)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"bank_scatter kernel is not deterministic "
                                 f"({label})")
        err = bank_diff(torch, got, want, rows, vals, op, label, None)
        bank_err = max(bank_err, err)
        lib_base = torch.full((r_pad,), ident, dtype=vals.dtype, device=dev)
        idx64 = rows.long()
        line = {"phase": "bank_kernel", "entry": "segmented_reduce",
                "case": label, "n_pad": rows.numel(),
                "r_pad": r_pad, "op": op, "dtype": str(vals.dtype)[6:],
                "distinct_rows": int(torch.unique(rows).numel()),
                "max_abs_err": err, "deterministic": True,
                **call_times(torch, lambda: bank_scatter.segmented_reduce(
                    rows, vals, r_pad, op, ident)),
                "plain_ms": time_ms(torch, lambda: bank_scatter.
                                    segmented_reduce_plain(rows, vals, r_pad,
                                                           op, ident), 50),
                "library_ms": time_ms(torch, lambda: torch.scatter_reduce(
                    lib_base, 0, idx64, vals, red_of[op], include_self=True),
                    200),
                **bank_bound(rows.numel(), r_pad)}
        bank_lines[("segmented_reduce", label)] = line
        emit(line)
        if not label.startswith(("path", "row0")):
            continue
        # the bank's own entry: the accumulator of cap + 1 rows, in place,
        # from a live accumulator of the lane's kind
        perm = torch.randperm(rows.numel(), device=dev,
                              generator=torch.Generator(dev).manual_seed(3))
        acc0 = vals[perm][:BANK_ROWS].clone()
        acc = [acc0.clone() for _ in range(5)]
        bank_scatter.accumulate_(acc[0], rows, vals, op)
        bank_scatter.accumulate_(acc[1], rows, vals, op)
        bank_scatter.accumulate_plain(acc[2], rows, vals, op)
        torch.cuda.synchronize()
        if not torch.equal(acc[0].view(torch.int32), acc[1].view(torch.int32)):
            raise AssertionError(f"bank_scatter accumulate_ is not "
                                 f"deterministic ({label})")
        err = bank_diff(torch, acc[0], acc[2], rows, vals, op, label, acc0)
        bank_err = max(bank_err, err)
        line = {"phase": "bank_kernel", "entry": "accumulate_",
                "case": label, "n_pad": rows.numel(), "rows": BANK_ROWS,
                "op": op, "dtype": str(vals.dtype)[6:],
                "max_abs_err": err, "deterministic": True,
                # repeated calls keep accumulating into one clone
                **call_times(torch, lambda: bank_scatter.accumulate_(
                    acc[0], rows, vals, op)),
                "plain_ms": time_ms(torch, lambda: bank_scatter.
                                    accumulate_plain(acc[2], rows, vals, op),
                                    50),
                "library_ms": time_ms(torch, lambda: acc[3].scatter_reduce_(
                    0, idx64, vals, red_of[op], include_self=True), 200),
                **bank_bound(rows.numel(), BANK_ROWS, accumulate=True)}
        # the delta entry and the accumulate entry in turns, after both
        # were timed once: the host moves both
        line["delta_then_accumulate_ms"] = [
            time_ms(torch, lambda: bank_scatter.segmented_reduce(
                rows, vals, r_pad, op, ident), 200),
            time_ms(torch, lambda: bank_scatter.accumulate_(
                acc[4], rows, vals, op), 200)]
        bank_lines[("accumulate_", label)] = line
        emit(line)
        if label == "path f32 sum":
            split_case = (rows, vals, acc[0])
            bank_acc_line = line
            bank_delta_line = bank_lines[("segmented_reduce", label)]
    emit(host_split(torch, bank_scatter, probe, build, *split_case,
                    bank_lines))

    # 9. aggregation end to end -------------------------------------------------
    n_batches = AGG_WARMUP + AGG_STEPS * AGG_WINDOWS
    tb, tsyms = trade_batches(EventBatch, n_batches + 2 * AGG_STEPS)
    bank_entries = (bank_scatter.accumulate_, bank_scatter.segmented_reduce)
    for k in (probe.add_one, dense_batch.batch_step, dense_step.packed_step,
              scan_chain.fused_scan, *bank_entries):
        k.launches = 0
    amgr, art, agg_card = run_trade(torch, SiddhiManager, "docs", "cuda", tb,
                                    AGG_WINDOWS)
    # the bank kernel's launches, by entry: the bank's single lanes take
    # accumulate_, its LONG-extrema pairs segmented_reduce
    bank_by_entry = {k.__name__: k.launches for k in bank_entries}
    agg_launches = {"probe": probe.add_one.launches,
                    "dense_batch": dense_batch.batch_step.launches,
                    "dense_step": dense_step.packed_step.launches,
                    "scan_chain": scan_chain.fused_scan.launches,
                    "bank_scatter": sum(bank_by_entry.values())}
    card_bank = art.aggregations["TradeAggregation"]._bank
    card_counts = (card_bank.scatters, card_bank.flushes)
    agg_bd = agg_breakdown(torch, art, tb[n_batches:])
    art.shutdown()
    amgr.shutdown()
    cmgr, crt, agg_cpu = run_trade(torch, SiddhiManager, "docs", "cpu", tb,
                                   AGG_WINDOWS)
    cpu_bank = crt.aggregations["TradeAggregation"]._bank
    cpu_counts = (cpu_bank.scatters, cpu_bank.flushes)
    crt.shutdown()
    cmgr.shutdown()
    held = hold_trade(agg_card, agg_cpu, tb, tsyms, "docs")
    if card_counts != cpu_counts or card_counts[0] != n_batches:
        raise AssertionError(f"bank scatters/flushes: card {card_counts}, CPU "
                             f"{cpu_counts}, batches {n_batches}")
    if (bank_by_entry["accumulate_"] != 2 * card_counts[0]
            or agg_launches["bank_scatter"] != 2 * card_counts[0]
            or agg_launches["probe"] < 1):
        raise AssertionError(f"aggregation path launches {agg_launches} "
                             f"{bank_by_entry}, banked batches "
                             f"{card_counts[0]}")
    # the wide variant: one window, every lane kind of the bank
    for k in bank_entries:
        k.launches = 0
    wn = AGG_WARMUP + AGG_STEPS
    wmgr, wrt, wide_card = run_trade(torch, SiddhiManager, "wide", "cuda",
                                     tb[:wn], 1)
    wide_by_entry = {k.__name__: k.launches for k in bank_entries}
    wide_launches = sum(wide_by_entry.values())
    wbank = wrt.aggregations["TradeAggregation"]._bank
    wide_counts = (wbank.scatters, wbank.flushes, len(wbank._lanes))
    wrt.shutdown()
    wmgr.shutdown()
    wcmgr, wcrt, wide_cpu = run_trade(torch, SiddhiManager, "wide", "cpu",
                                      tb[:wn], 1)
    wcbank = wcrt.aggregations["TradeAggregation"]._bank
    wcrt.shutdown()
    wcmgr.shutdown()
    wide_held = hold_trade(wide_card, wide_cpu, tb, tsyms, "wide")
    if (wide_counts[:2] != (wcbank.scatters, wcbank.flushes)
            or wide_launches != wide_counts[2] * wide_counts[0]
            or not wide_counts[0]):
        raise AssertionError(f"wide variant: card scatters/flushes/lanes "
                             f"{wide_counts}, CPU {(wcbank.scatters, wcbank.flushes)}, "
                             f"launches {wide_launches}")
    steady = AGG_BATCH * AGG_STEPS
    agg_rate = steady * AGG_WINDOWS / sum(agg_card["window_s"])
    emit({"phase": "aggregation", "symbols": AGG_SYMBOLS, "batch": AGG_BATCH,
          "windows": AGG_WINDOWS, "warmup_batches": AGG_WARMUP,
          "events_per_s": agg_rate,
          "events_per_s_windows": [steady / t for t in agg_card["window_s"]],
          "ms_per_batch": 1e3 * sum(agg_card["window_s"])
                          / (AGG_STEPS * AGG_WINDOWS),
          "pull_ms_windows": [1e3 * t for t in agg_card["pull_s"]],
          "gc_ms_windows_and_pulls": agg_card["gc_ms"],
          "pull_rows_last": [len(p) for p in agg_card["pulls"][-1]],
          "cpu_events_per_s": steady * AGG_WINDOWS / sum(agg_cpu["window_s"]),
          "rows_held_vs_cpu": held, "scatters": card_counts[0],
          "flushes": card_counts[1], "launches": agg_launches,
          "bank_launches_by_entry": bank_by_entry,
          "bank_state_bytes": 4 * (card_bank.cap + 1) * len(card_bank._lanes),
          "wide": {"batches": wn, "lanes": wide_counts[2],
                   "scatters": wide_counts[0], "flushes": wide_counts[1],
                   "bank_scatter_launches": wide_launches,
                   "bank_launches_by_entry": wide_by_entry,
                   "rows_held_vs_cpu": wide_held,
                   "events_per_s": steady / wide_card["window_s"][0],
                   "cut": "one window of 8, not 3"},
          "card": card})
    emit(agg_bd)

    # 10. general step at full size ------------------------------------------
    gen_launches = general_phase(
        torch, SiddhiManager, compile_pattern, state_from_numpy,
        state_to_numpy, {"probe": [probe.add_one],
                         "dense_batch": [dense_batch.batch_step],
                         "dense_step": [dense_step.packed_step],
                         "scan_chain": [scan_chain.fused_scan],
                         "bank_scatter": bank_entries}, card)

    # 11-12. part b: BASELINE configs 2-4, then the small checks -----------
    pb_launches = part_b_phase(
        torch, compile_pattern, state_from_numpy, state_to_numpy,
        {"probe": [probe.add_one], "dense_batch": [dense_batch.batch_step],
         "dense_step": [dense_step.packed_step],
         "scan_chain": [scan_chain.fused_scan],
         "bank_scatter": bank_entries}, card)

    # 13. absent deadlines: the 1 M-room cell, then the small checks ----------
    all_kernels = {"probe": [probe.add_one],
                   "dense_batch": [dense_batch.batch_step],
                   "dense_step": [dense_step.packed_step],
                   "scan_chain": [scan_chain.fused_scan],
                   "bank_scatter": bank_entries}
    absent_launches = absent_phase(torch, SiddhiManager, EventBatch,
                                   all_kernels, card)
    gc.collect()
    absent_check_phase(torch, SiddhiManager, compile_pattern,
                       state_from_numpy, state_to_numpy, card)

    # 14-16. the host query runtime: the per-card rollup at full size, the
    # rate limits, the host queries ------------------------------------------
    gc.collect()
    rollup_launches = rollup_phase(torch, SiddhiManager, EventBatch,
                                   all_kernels, card)
    gc.collect()
    rate_limit_phase(torch, SiddhiManager, card)
    host_rates = host_phase(torch, SiddhiManager, EventBatch,
                            StreamCallback, card)

    # 17. the device query path ----------------------------------------------
    gc.collect()
    dq_launches, dq_rates = device_query_phase(
        torch, SiddhiManager, EventBatch, StreamCallback, all_kernels, card,
        host_rates)
    # the state scatters of the running and tumbling accumulators are
    # the path's kernel: accumulate_, once a lane kind a step
    if (dq_launches["bank_scatter"] < 1
            or any(v for k, v in dq_launches.items() if k != "bank_scatter")):
        raise AssertionError(f"device query path launches {dq_launches}")

    # 18-19. the host pattern engine and per-key partition instances ------
    gc.collect()
    hp_launches = host_patterns_phase(torch, SiddhiManager, EventBatch,
                                      StreamCallback, all_kernels, card)
    gc.collect()
    hpart_launches = host_partitions_phase(
        torch, SiddhiManager, EventBatch, StreamCallback, all_kernels, card,
        dq_rates)

    # 20-23. the product configuration, auto depths on the other device
    # paths, the single-key scan engine, user functions ----------------
    gc.collect()
    product_launches = product_phase(torch, SiddhiManager, EventBatch,
                                     StreamCallback, all_kernels, card)
    gc.collect()
    auto_launches = other_auto_phase(torch, SiddhiManager, EventBatch,
                                     StreamCallback, all_kernels, card,
                                     routed)
    scan_engine_phase(torch, card)
    udf_launches = functions_phase(torch, SiddhiManager, EventBatch,
                                   StreamCallback, all_kernels, card)

    # 24. joins with the device probe, tables, named windows, triggers
    # and pulls --------------------------------------------------------------
    gc.collect()
    join_launches = joins_phase(torch, SiddhiManager, EventBatch,
                                StreamCallback, all_kernels, card)
    join_check_phase(SiddhiManager, EventBatch, card)
    table_launches = tables_phase(torch, SiddhiManager, EventBatch,
                                  StreamCallback, all_kernels, card)
    emit({"phase": "isolated_errors", "errors": 0,
          "warnings_to_listeners_or_log": ISOLATED.warnings})

    # 25. kernels -------------------------------------------------------------
    by_path = lambda name: {"dense_1M": launches.get(name, 0),
                            "skew_routed": hk_launches.get(name, 0),
                            "aggregation": agg_launches[name],
                            "general_1M": gen_launches[name],
                            "part_b": pb_launches[name],
                            "absent": absent_launches[name],
                            "selector": rollup_launches[name],
                            "device_query": dq_launches[name],
                            # the dense runs beside the host engine; the
                            # host engine and the instances launch none
                            "host_patterns": hp_launches[name],
                            "host_partitions": hpart_launches[name],
                            # (a) and (d) of the product phase
                            "product": product_launches[name],
                            "auto_depths": auto_launches[name],
                            "functions": udf_launches[name],
                            # torch ops on the join and table paths
                            "joins": join_launches[name],
                            "tables": table_launches[name]}
    emit({"kernels": [
        {"name": "dense_batch", "route": "cuda",
         "source": "siddhi_tpu_torch/kernels/csrc/dense_batch.cu",
         "replaces": "siddhi_tpu/kernels/dense_step.py:154",
         "launches": (launches["dense_batch"] + hk_launches["dense_batch"]
                      + hp_launches["dense_batch"]
                      + product_launches["dense_batch"]
                      + auto_launches["dense_batch"]),
         "launches_by_path": by_path("dense_batch"),
         "max_abs_err": batch_err,
         # the 1 M cell's batch; the routed cold sub-batch beside it
         "case": "1M mid-chain batch",
         **{k: batch_lines["1M"][k] for k in KERNEL_KEYS},
         "routed": {k: batch_lines["routed"][k] for k in
                    ("longest_segment", "segments", "N", *KERNEL_KEYS)}},
        {"name": "dense_step", "route": "cuda",
         "source": "siddhi_tpu_torch/kernels/csrc/dense_step.cu",
         "replaces": "siddhi_tpu/kernels/dense_step.py:154",
         "off_main_path": True,
         "launches": launches["dense_step"] + hk_launches["dense_step"],
         "launches_by_path": by_path("dense_step"), "max_abs_err": step_err,
         **{k: step_line[k] for k in KERNEL_KEYS}},
        {"name": "probe", "route": "cuda",
         "source": "siddhi_tpu_torch/kernels/csrc/probe.cu",
         "replaces": "siddhi_tpu/kernels/probe.py:56",
         "launches": (launches["probe"] + hk_launches["probe"]
                      + agg_launches["probe"] + gen_launches["probe"]
                      + pb_launches["probe"] + absent_launches["probe"]
                      + rollup_launches["probe"] + hp_launches["probe"]
                      + product_launches["probe"] + auto_launches["probe"]),
         "launches_by_path": by_path("probe"), "max_abs_err": probe_err,
         **{k: probe_line[k] for k in KERNEL_KEYS}},
        {"name": "scan_chain", "route": "cuda",
         "source": "siddhi_tpu_torch/kernels/csrc/scan_chain.cu",
         "replaces": "siddhi_tpu/kernels/scan_chain.py:91",
         "launches": hk_launches["scan_chain"]
                     + auto_launches["scan_chain"],
         "launches_by_path": by_path("scan_chain"), "max_abs_err": scan_err,
         # the routed path's shape; the widest legal one beside it
         "case": "H=8, n=2048, S=2",
         **{k: scan_line[k] for k in KERNEL_KEYS},
         "widest": {k: scan_lines[SCAN_SHAPES[1]][k] for k in KERNEL_KEYS}},
        {"name": "bank_scatter", "route": "cuda",
         "source": "siddhi_tpu_torch/kernels/csrc/bank_scatter.cu",
         "replaces": "siddhi_tpu/kernels/bank_scatter.py:76",
         "launches": agg_launches["bank_scatter"]
                     + dq_launches["bank_scatter"]
                     + auto_launches["bank_scatter"],
         "launches_by_path": by_path("bank_scatter"),
         "launches_by_entry": bank_by_entry,
         "max_abs_err": bank_err,
         # the entry the aggregation path uses, at its shape and lane
         "entry": "accumulate_", "case": "path f32 sum",
         **{k: bank_acc_line[k] for k in KERNEL_KEYS},
         "segmented_reduce": {k: bank_delta_line[k] for k in KERNEL_KEYS}},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
