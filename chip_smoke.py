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
25. checkpoint: persistence through ``SiddhiManager``, each app's store
   in a fresh ``tempfile`` directory (its free bytes printed, at most 2
   revisions kept, deleted after the app): (a) ``product_app`` (1,000,000
   partitions, S = 16, I = 4, 836,000,836 B of state) under
   ``@app:faults(journal='16')`` over ``product_batches``' first 10: a
   sync ``persist()`` into a ``FileSystemPersistenceStore`` after batch
   4, a simulated crash on the ingest of batch 7, and a fresh runtime of
   the same manager whose ``restore_last_revision()`` replays 5-7 before
   8-10 are sent; then the same with ``persist(mode='async')`` into a
   ``DurableFileSystemPersistenceStore``.  The output across the crash
   equals the uninterrupted card run's bit for bit, the final state
   too, and the revision's dense tree equals the CPU run's at batch 4;
   (b) ``kernel_eligible_app`` the same way (sync), ``dense_batch``
   launching after the restore; (c) ``device_queries``'
   ``partition_scaling_50000`` (the running count, whose state scatters
   are ``accumulate_``, launching after the restore) and
   ``keyed_time_avg_50000`` (the keyed one-second window, 872,677,376
   B), a persist after batch 40 and a crash on batch 81 of 123, held
   against the uninterrupted card run and, over 16 batches, the CPU's;
   (d) the kitchen-sink app of ``tests/test_conformance_persistence2.py``
   with an aggregation, under ``execution('tpu')``, rolled back with
   ``restore_revision`` on the card and on the CPU: the same rows and
   pulls; (e) a flipped byte in the newest durable revision (its persist
   crashed after the manifest), which ``restore_last_revision`` walks
   back past with the reference's WARNINGs, replaying from the previous
   revision to the uninterrupted run's rows.  Each line gives the state
   bytes on the card, the snapshot bytes written, ``persist_sync_ms``
   (in the barrier, clones synchronised, and in all) or the async
   barrier and writer ms, ``restore_ms`` and ``replay_ms``, the
   replayed batches and suppressed events, and the launches after the
   restore.
26. fusion: stream-graph fusion (``@app:fuse``).  (a) ``bench.py``'s
   ``FUSE_APP`` chain (``SIn[price > 4.0]``, ``Mid#window.length(64)``
   ``sum(price)``, a capturing two-node pattern tail over ``Win``) at
   B = 8,192, eight symbols, price ~ U(0, 40) so the window sums reach
   the tail's ``total > 1540.0`` (32 instance lanes a node, so none
   is dropped), a warm-up batch of 1,024 rows and 1
   timed batch (the tail's one general step a row takes 19-30 s a
   batch), fused on the card, unfused on the card and fused at
   ``device="cpu"`` over the same batches: rows, which must not be
   none, equal
   (the float32 sums within the reference's bound), ``lowering()``
   ``fused`` for q1-q3, ``Mid`` and ``Win`` at zero dispatches, events/s
   and ms a batch of both card runs; (b) the chain with a device tail
   (``Win[total > 1540.0]``) at B = 131,072 against the unfused run,
   with the device ops and busy share of one more batch under
   ``torch.profiler``; (c) an ``@async`` intermediate falls back with
   its WARNING, its rows those of the fused run.
27. devtables: device tables (``@app:devtables``).  (a) ``bench.py``'s
   stream-table join (``@PrimaryKey('k') T (k int, v float)``, ``update
   or insert``) at 1,000,000 seeded rows, ``capacity='1048576'``,
   131,072 probes (about half hit) and 16,384 upserts a batch pair, 1
   warm-up and 4 timed, held against a numpy model of the join (the
   host join is a cross product, 1.3e11 pairs a batch at this width):
   state bytes on the card, events/s, probe and scatter ms a batch;
   (b) the reference bench's shape (8,192 rows, capacity 16,384, B =
   8,192, 1,024 upserts): card against ``device="cpu"`` bit for bit,
   and the host table on the card beside it; (c) a capacity overflow
   that compacts and then demotes with its WARNING, its rows the host
   table's.
28. multiplex: multi-tenant multiplexing (``@app:multiplex``), each
   card run's launches counted from app creation on.  (a) ``bench.py``'s
   ``bench_multiplexed`` (8 tenants, 1,024 keys, 4,096 events a tenant a
   cycle, panes of 65,536, 2 warm-up cycles and 3 windows of 10),
   multiplexed and with 8 dedicated engines on the card and multiplexed
   at ``device="cpu"``: every tenant's rows bit for bit, events/s,
   dispatches a cycle, ``combined_steps``, ``slow_steps`` and the
   ``accumulate_`` launches; (b) the same app for 1,024 tenants at
   ``slots='64'`` (16 groups, the group axis at the 1,024 keys: 1,048,576
   accumulator rows), 1 warm-up and 4 timed cycles, multiplexed and
   dedicated: app-creation seconds, events/s, dispatches a cycle, the
   banks' bytes, and every tenant's accumulator rows bit for bit; (c) 64
   tenants of ``kernel_eligible_app`` at ``slots='64'``, 4,096 events a
   tenant a cycle, v ~ U(0, 20), lowered to ``multiplex/batch`` with one
   ``dense_batch`` launch a cycle (the longest segment printed), and 64
   of the capturing ``e2=Txn[v > e1.v]`` chain at 64 events a tenant a
   cycle on the general step's rounds (one warm-up and one timed cycle:
   a dedicated cycle is 4,096 general steps), each held to the dedicated
   card run and the CPU run bit for bit (the capture-free chain's CPU
   run cut to its first cycle, whose 4,096 ranks of the plain batch
   step take the host about 16 s).  A ``multiplex_seconds`` line
   follows.
29. transports: the verify skill's filter and a ``lengthBatch(8192)``
   group-by under ``@app:execution('tpu')`` over 1,000,000 events in
   publishes of 8,192, in through an in-memory source (pass-through,
   then JSON) and out through in-memory sinks to broker subscribers,
   the rows held against the input-handler-and-callback run on the card
   and at ``device="cpu"`` (a JSON source carries no event times, so
   the rows are held without their timestamps); events/s source to sink
   beside handler to callback.  Then an ``@OnError(action='STREAM')`` app whose device
   query fails on some batches (new symbols past its 64 group rows): its
   ``!S`` rows equal the CPU run's.  A ``transports_seconds`` line
   follows.
30. operations: the operations layer on the card, one line a case.
   (a) ``kernel_eligible_app`` at 1,000,000 partitions and 32 instance
   lanes, 6 batches of 131,072 (half on 16,384 keys, so a cold chain
   completes and no instance is dropped), with transient ``emit.drain``
   and ``ingest.put`` faults at a seeded probability and one
   ``step.dense`` fault routed to ``!Txn``: rows and final state equal
   to the fault-free card run over the other batches; retries,
   recoveries and ms a batch beside the clean run's.  (b)
   ``state.poison`` tripping once on a ``lengthBatch`` group-by on the
   device query path (``accumulate_``) and on the skew-routed path
   (``scan_chain``): one quarantine each and rows equal to the CPU
   run's; the guard's ms a batch, armed and never tripping, beside the
   unarmed run.  (c) the ladder's one rung, ``fuse``, on fusion (b)'s
   chain under ``@app:fuse @app:faults(journal=) @app:limits(ladder=)``,
   down and back up: the junctions carry the hops while demoted, none
   after, rows equal the undisturbed fused run; each re-plan's
   seconds; a forced re-plan of the main path (two engine sets at 1 M
   partitions for a moment): its seconds and peak memory, rows equal
   the clean run, ``dense_batch`` launching before and after; then a
   wedged ``@async`` device-query app healed by the watchdog, every row
   delivered once.  (d) admission (``shed='drop'``, half shed) on the
   main path with the statistics feed and transient faults, 2 batches
   on 4,096 keys: the rows, ``events_shed`` and the feed's fault and
   robustness counters equal the CPU run's.  (e) events/s with
   ``@app:statistics @app:trace(sample='1/64')`` and without, 8
   batches each; a fully sampled run's spans by stage; and
   ``/metrics`` from the service on localhost.  Every main-path run
   prints its dropped instances and fails on one.  An
   ``operations_seconds`` line follows.
31. sharded: the mesh (``@app:execution(devices=)``), one line a case,
   each card run's launches counted from app creation on.  (a) BASELINE
   config 5 (``samples/performance/baseline_configs.py:106-119``: the
   32-state escalation chain, ``within 10 min``) inside ``partition with
   (dev of D)`` at 10,000,000 partitions, ``devices='1'``: 2 warm-up and
   10 timed batches of 131,072 events (devices uniform from a seed, v ~
   U(0, 40) float32) from a mid-chain state seeded on the card by key
   number (a ``torch.Generator``, every key of the run interned first;
   one lane of each node's four, so no instance is dropped),
   16,680,001,668 B of state; its matches and whole state bit for bit
   against the same app without ``devices=``, run after it (its state
   kept on the card, the rest of the app freed).  (b) the same at
   ``devices='4'``, four shards on one card (16,680,006,672 B), held
   against (a) by key number.  (c) (b) at 65,536 partitions, 2 batches
   of 8,192, on the card and on the CPU, bit for bit.  (c2) the
   capture-free 16-state chain (``kernel_eligible_app``) at 1,000,000
   partitions, ``devices='4'``, 2 warm-up and 6 timed batches of
   131,072: one ``dense_batch`` launch a shard with events, matches and
   state bit for bit against the unsharded card run, which launches it
   too.  (d) ``running``
   (``device_queries``' ``partition_scaling_50000``), ``keyed_sliding``
   (``keyed_time_avg_50000``), ``tumbling`` (a ``lengthBatch(8192)``
   group-by) and ``sliding`` (``sliding_window``) at ``devices='4'``
   over 16 batches of 8,192, against one device: every column bit for
   bit, float32 sums included, and ``accumulate_`` launching in each
   kind whose one-device run launches it (``running`` and
   ``tumbling``; ``sliding`` and ``keyed_sliding`` launch no
   hand-written kernel on one device or sharded).  Every dense run
   fails on a dropped instance.  (e) one transient
   ``step.shard`` fault on (c)'s app, its batch routed to ``!D``, the
   other rows and the state equal to the fault-free run; then one
   ``@app:plan(auto='true')`` switch by ``PlanMonitor`` on the observed
   batch widths, rows equal to the run that keeps its plan.  Seconds a
   case and a ``sharded_seconds`` line follow.
32. analysis: (a) the port's static pass (``python -m
   siddhi_tpu_torch.analysis --format json`` on this checkout, started
   after the build in a process of its own, beside the card phases):
   its rule count, findings (which must be 0), suppressed count and
   seconds; (b)
   its dynamic twin, ``analysis/sync_guard.SyncGuard``
   (``torch.cuda.set_sync_debug_mode("warn")``, each sync attributed to
   its innermost frame of the port), over four main-path apps at full
   width, each for 1 warm-up batch and 3 guarded batches, then the same
   batches unguarded: ``product``'s capturing chain and the capture-free
   chain (``product_batch``) at 1,000,000 partitions and B=131072, both
   from the product phase's seeded start, ``device_queries``'
   ``partition_scaling_50000`` (B=8192) and ``bench_hot_key``'s routed
   app (4096 keys, B=8192).  First a control: the batch step's plain
   twin, off the main path, under the guard, whose syncs (its rank
   count's ``int()`` and its ``nonzero``) the guard must see and
   attribute to its scope.  One line an app: syncs a batch by scope
   and by bucket (drain, staging, allowlist, on_card), the unsanctioned
   count, which must be 0, the launches of each kernel from the app's
   creation, which must include the app's kernels, and the rows held bit
   for bit between the guarded and the unguarded run.  Nothing is timed
   under the guard.
33. kernels: one line per ported kernel (launches on the main paths,
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

import atexit
import contextlib
import ctypes
import gc
import json
import logging
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

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
            "device_ops": sum(c for _ms, c in by_name.values()),
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


def card_state_bytes(rt) -> int:
    """Bytes of the device runtimes' state tensors (the hot-key router's
    dense runtime's)."""
    total = 0
    for r in rt.device_runtimes().values():
        st = r.state if hasattr(r, "state") else r._dense.state
        total += sum(t.numel() * t.element_size() for t in st.values())
    return total


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
        state_bytes = card_state_bytes(rt)
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


# -- 25. checkpoint and restore ------------------------------------------------

CKPT_KEEP = 2  # revisions each store keeps
# (a)/(b): product_batches' first 10 (3 warm-up + 7), a persist after
# batch 4, a crash on the ingest of batch 7 (index 6)
CKPT_BATCHES = 10
CKPT_PERSIST_AT = 4
CKPT_CRASH_AT = 6
# (c)/(e): 1,000,000 events in 123 batches, a persist after batch 40, a
# crash on batch 81 (index 80); the journal holds the 41 between
CKPT_DQ_LABELS = ("partition_scaling_50000", "keyed_time_avg_50000")
CKPT_DQ_PERSIST_AT = 40
CKPT_DQ_CRASH_AT = 80
# (d): the kitchen-sink app of tests/test_conformance_persistence2.py:18-29
# (a window, a group-by, a table, a pattern) with an aggregation added,
# under execution('tpu')
KITCHEN_APP = (
    "@app:name('ckpt_d') @app:playback @app:execution('tpu') "
    "define stream S (k string, v long); "
    "define stream P (k string, v long); "
    "define table T (k string, v long); "
    "@info(name='qwin') from S#window.length(3) select k, sum(v) as total "
    "insert into WinOut; "
    "@info(name='qgrp') from S select k, sum(v) as total group by k "
    "insert into GrpOut; "
    "@info(name='qtab') from S insert into T; "
    "@info(name='qpat') from every a=P[v > 10] -> b=P[v > a.v] "
    "select a.v as av, b.v as bv insert into PatOut; "
    "define aggregation A from S select k, sum(v) as total group by k "
    "aggregate every sec, min;")


def ckpt_keep(StreamCallback, kept):
    class Keep(StreamCallback):
        def receive_batch(self, batch):
            kept.append(batch)

    return Keep()


def device_states(torch, rt) -> list:
    """Clones of every device runtime's state tensors, in order."""
    out = []
    for r in rt.device_runtimes().values():
        st = r.state if hasattr(r, "state") else r._dense.state
        out.append({k: t.clone() for k, t in st.items()})
    return out


def send_all(rt, batches):
    hs = {}
    for b in batches:
        h = hs.get(b.stream_id)
        if h is None:
            h = hs[b.stream_id] = rt.get_input_handler(b.stream_id)
        h.send_batch(b)


def ckpt_plain_run(torch, SiddhiManager, StreamCallback, app, out, batches,
                   device, setup=None, snapshot=False):
    """``app`` over ``batches`` on ``device`` with no persist: the output
    batches, clones of the final device state (on the card) and, with
    ``snapshot``, the first device runtime's snapshot tree."""
    mgr = SiddhiManager(device=device)
    rt = new_app(mgr, app)
    kept = []
    rt.add_callback(out, ckpt_keep(StreamCallback, kept))
    rt.start()
    if setup is not None:
        setup(rt)
    send_all(rt, batches)
    rt.drain()
    final = device_states(torch, rt) if device == "cuda" else None
    tree = (next(iter(rt.device_runtimes().values())).snapshot()
            if snapshot else None)
    rt.shutdown()
    mgr.shutdown()
    return kept, final, tree


def ckpt_crash_run(torch, SiddhiManager, StreamCallback, kernels, app, out,
                   batches, persist_at, crash_at, store, mode, setup=None,
                   before_crash=None):
    """``app`` on the card: ``batches[:persist_at]``, a ``persist(mode)``
    into ``store`` (timed: the call, the in-barrier capture with its
    clones synchronised, and for async the writer until committed), the
    batches up to ``crash_at``, a simulated crash on the ingest of
    ``batches[crash_at]``, then a fresh runtime of the same manager
    restoring the last revision (the journal replays the batches after
    it) and taking the rest.  Returns the output across the crash, the
    timings and counters, the launches after the restore and clones of
    the final device state."""
    from siddhi_tpu_torch.core.exceptions import SimulatedCrashError

    mgr = SiddhiManager(device="cuda")
    mgr.set_persistence_store(store)
    rt = new_app(mgr, app)
    kept = []
    rt.add_callback(out, ckpt_keep(StreamCallback, kept))
    rt.start()
    if setup is not None:
        setup(rt)
    state_bytes = card_state_bytes(rt)
    send_all(rt, batches[:persist_at])
    rt.drain()
    torch.cuda.synchronize()
    svc = rt._snapshot_service()
    capture, barrier = svc.capture, []

    def timed_capture(**kw):
        t = time.perf_counter()
        got = capture(**kw)
        torch.cuda.synchronize()
        barrier.append(1e3 * (time.perf_counter() - t))
        return got

    svc.capture = timed_capture
    t = time.perf_counter()
    rev = rt.persist(mode=mode)
    call_ms = 1e3 * (time.perf_counter() - t)
    writer_ms = None
    if mode == "async":
        t = time.perf_counter()
        status = rt.wait_for_persist(rev, timeout=600)
        writer_ms = 1e3 * (time.perf_counter() - t)
        if status != "committed":
            raise AssertionError(f"async persist ended '{status}'")
    written = rt._durability_stats().bytes_written
    # what a capture that fetches inside the barrier (the reference's
    # fetch-in-snapshot) would hold the app lock for
    with rt.app_context.process_lock:
        t = time.perf_counter()
        svc._state_tree(fetch=True)
        torch.cuda.synchronize()
        fetch_in_barrier_ms = 1e3 * (time.perf_counter() - t)
    send_all(rt, batches[persist_at:crash_at])
    if before_crash is not None:
        before_crash(rt)
    rt.app_context.fault_injector.configure("ingest", "crash", count=1)
    try:
        send_all(rt, batches[crash_at:crash_at + 1])
    except SimulatedCrashError:
        pass
    else:
        raise AssertionError("the armed ingest crash did not fire")
    rt.shutdown()

    rt = new_app(mgr, app)
    rt.add_callback(out, ckpt_keep(StreamCallback, kept))
    rt.start()
    replay, replay_s = rt._replay_journal, []

    def timed_replay(revision):
        t = time.perf_counter()
        replay(revision)
        torch.cuda.synchronize()
        replay_s.append(time.perf_counter() - t)

    rt._replay_journal = timed_replay
    before = read_launches(kernels)
    torch.cuda.synchronize()
    t = time.perf_counter()
    restored = rt.restore_last_revision()
    torch.cuda.synchronize()
    restore_total_ms = 1e3 * (time.perf_counter() - t)
    send_all(rt, batches[crash_at + 1:])
    rt.drain()
    torch.cuda.synchronize()
    after = read_launches(kernels)
    jst = rt.app_context.input_journal.stats
    run = {"kept": kept, "final": device_states(torch, rt), "rev": rev,
           "restored": restored, "line": {
               "state_bytes_on_card": state_bytes,
               "snapshot_bytes_written": written,
               "fetch_in_barrier_ms": fetch_in_barrier_ms,
               "restore_ms": restore_total_ms - 1e3 * sum(replay_s),
               "replay_ms": 1e3 * sum(replay_s),
               "replayed_batches": jst.replayed_batches,
               "suppressed_events": jst.suppressed_events,
               "launches_after_restore": {k: after[k] - before[k]
                                          for k in after}}}
    if mode == "sync":
        run["line"]["persist_sync_ms"] = {"in_barrier": barrier[0],
                                          "total": call_ms}
    else:
        run["line"]["persist_async_barrier_ms"] = call_ms
        run["line"]["persist_async_barrier_capture_ms"] = barrier[0]
        run["line"]["persist_async_writer_ms"] = writer_ms
    rt.shutdown()
    mgr.shutdown()
    return run


def ckpt_rows_held(EventBatch, got, want, sum_cols=(), exact=True) -> int:
    """Two output sequences as one batch each, held as ``dq_compare``
    holds them (row order, timestamps, every column)."""
    a = EventBatch.concat(got) if got else None
    b = EventBatch.concat(want) if want else None
    return dq_compare(a, b, sum_cols, exact)["rows"]


def ckpt_prefix(EventBatch, kept, last_ts):
    """The rows of ``kept`` up to event time ``last_ts``, as one batch
    list."""
    if not kept:
        return []
    b = EventBatch.concat(kept)
    return [b.take(np.flatnonzero(b.timestamps <= last_ts))]


def same_final(torch, a, b) -> bool:
    return (len(a) == len(b) and all(
        x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b)))


def checkpoint_phase(torch, SiddhiManager, EventBatch, StreamCallback,
                     kernels, card) -> dict:
    """Phase 25: ``checkpoint``, persistence through ``SiddhiManager`` on
    the card, each app with its store in a fresh ``tempfile`` directory
    (its free bytes printed, at most ``CKPT_KEEP`` revisions, deleted
    after): (a) ``product_app`` at 1,000,000 partitions through a sync
    persist after batch 4, a crash on batch 7 and a restore that replays
    5-7, then again with an async persist into the durable store; (b)
    ``kernel_eligible_app`` (the batch-step kernel) the same way; (c)
    ``device_queries``' ``partition_scaling_50000`` and
    ``keyed_time_avg_50000``; (d) the kitchen-sink app rolled back with
    ``restore_revision``; (e) a flipped byte in the newest durable
    revision, walked back past.  Returns the phase's launches by
    kernel."""
    import os
    import pickle
    import shutil
    import tempfile

    from siddhi_tpu_torch import (
        DurableFileSystemPersistenceStore,
        FileSystemPersistenceStore,
    )
    from siddhi_tpu_torch.core.exceptions import SimulatedCrashError
    from siddhi_tpu_torch.ops.dense_nfa import compile_pattern

    zero_launches(kernels)
    t_phase = time.perf_counter()

    def tmpdir():
        d = tempfile.mkdtemp(prefix="ckpt-")
        return d, shutil.disk_usage(d).free

    # (a) and (b): the product configuration --------------------------------
    batches = product_batches(EventBatch)[:CKPT_BATCHES]
    for capturing, label in ((True, "a"), (False, "b")):
        name = f"ckpt_{label}"
        eng = compile_pattern(flat_app() if capturing
                              else kernel_eligible_app(), "bench",
                              n_partitions=N_PARTITIONS,
                              n_instances=N_INSTANCES, device="cpu")
        host, base_ts = mid_chain_state(eng, seed=29 if capturing else 31)
        del eng
        start = {"dense_state": host, "base_ts": base_ts,
                 "key_rows": dict(zip(range(N_PARTITIONS),
                                      range(N_PARTITIONS))),
                 "next_row": N_PARTITIONS, "free_rows": []}

        def setup(rt):
            rt.partitions["partition_0"].dense_query_runtimes[
                "bench"].pattern_processor.restore(start)

        plain = product_app(PRODUCT_DEPTHS, capturing)
        app = f"@app:name('{name}') @app:faults(journal='16') " + plain
        ref, ref_final, _ = ckpt_plain_run(
            torch, SiddhiManager, StreamCallback, plain, "Alerts", batches,
            "cuda", setup)
        cpu, _, cpu_tree = ckpt_plain_run(
            torch, SiddhiManager, StreamCallback, plain, "Alerts",
            batches[:CKPT_PERSIST_AT], "cpu", setup, snapshot=True)
        last_ts = int(batches[CKPT_PERSIST_AT - 1].timestamps[-1])
        modes = (("sync", FileSystemPersistenceStore),
                 ("async", DurableFileSystemPersistenceStore))
        for mode, store_cls in modes if capturing else modes[:1]:
            d, free = tmpdir()
            try:
                store = store_cls(d, revisions_to_keep=CKPT_KEEP)
                run = ckpt_crash_run(
                    torch, SiddhiManager, StreamCallback, kernels, app,
                    "Alerts", batches, CKPT_PERSIST_AT, CKPT_CRASH_AT,
                    store, mode, setup)
                tree = pickle.loads(store.load(name, run["rev"]))
            finally:
                shutil.rmtree(d, ignore_errors=True)
            dense = tree["partitions"]["partition_0"]["__dense__"]["bench"][
                "pattern"]
            diff = tree_diff(dense, cpu_tree)
            if diff:
                raise AssertionError(f"checkpoint ({label}, {mode}): the "
                                     "revision's dense tree differs from "
                                     f"the CPU run's at the persist point: "
                                     f"{diff[:5]}")
            del tree, dense
            held = ckpt_rows_held(EventBatch, run["kept"], ref)
            held_cpu = ckpt_rows_held(
                EventBatch, ckpt_prefix(EventBatch, run["kept"], last_ts),
                cpu)
            if not same_final(torch, run["final"], ref_final):
                raise AssertionError(f"checkpoint ({label}, {mode}): final "
                                     "state differs from the uninterrupted "
                                     "run's")
            after = run["line"]["launches_after_restore"]
            if (run["restored"] != run["rev"] or not held
                    or run["line"]["replayed_batches"] != 3
                    or (not capturing and after["dense_batch"] < 1)):
                raise AssertionError(f"checkpoint ({label}, {mode}): "
                                     f"{run['line']}, rows {held}")
            emit({"phase": "checkpoint",
                  "app": f"({label}) " + ("product_app" if capturing
                                          else "kernel_eligible_app"),
                  "partitions": N_PARTITIONS, "batch": BATCH,
                  "mode": mode, "store": store_cls.__name__,
                  "tmp_free_bytes_before": free,
                  "persist_after_batch": CKPT_PERSIST_AT,
                  "crash_on_batch": CKPT_CRASH_AT + 1,
                  **run["line"],
                  "rows_held_vs_uninterrupted_card": held,
                  "final_state_equal_uninterrupted_card": True,
                  "rows_held_vs_cpu": held_cpu,
                  "revision_tree_equal_cpu_at_persist": True,
                  "cpu_cut": f"the CPU run takes the first "
                             f"{CKPT_PERSIST_AT} batches",
                  "card": card})
            del run
            gc.collect()
        del ref, ref_final, cpu, cpu_tree, start, host
        gc.collect()
        torch.cuda.empty_cache()

    # (c) the device query path, (e) a corrupted revision ------------------
    dq_runs = {}
    for label in CKPT_DQ_LABELS:
        plain, _low = DEVICE_QUERY_APPS[label]
        n_sym = 50_000
        dqb = dq_batches(EventBatch, n_sym, seed=n_sym)
        sums = DQ_SUM_COLUMNS.get(label, ())
        ref, ref_final, _ = ckpt_plain_run(
            torch, SiddhiManager, StreamCallback, plain, "outputStream", dqb,
            "cuda")
        cpu, _, _ = ckpt_plain_run(torch, SiddhiManager, StreamCallback,
                                   plain, "outputStream", dqb[:DQ_CHECK],
                                   "cpu")
        app = "@app:name('ckpt_c') @app:faults(journal='64') " + plain
        d, free = tmpdir()
        try:
            run = ckpt_crash_run(
                torch, SiddhiManager, StreamCallback, kernels, app,
                "outputStream", dqb, CKPT_DQ_PERSIST_AT, CKPT_DQ_CRASH_AT,
                FileSystemPersistenceStore(d, revisions_to_keep=CKPT_KEEP),
                "sync")
        finally:
            shutil.rmtree(d, ignore_errors=True)
        held = ckpt_rows_held(EventBatch, run["kept"], ref)
        last_ts = int(dqb[DQ_CHECK - 1].timestamps[-1])
        held_cpu = ckpt_rows_held(
            EventBatch, ckpt_prefix(EventBatch, run["kept"], last_ts), cpu,
            sums, False)
        after = run["line"]["launches_after_restore"]
        if (not same_final(torch, run["final"], ref_final)
                or run["restored"] != run["rev"]
                or run["line"]["replayed_batches"]
                != CKPT_DQ_CRASH_AT - CKPT_DQ_PERSIST_AT + 1
                or (label == "partition_scaling_50000"
                    and after["bank_scatter"] < 1)):
            raise AssertionError(f"checkpoint (c) {label}: {run['line']}")
        emit({"phase": "checkpoint", "app": f"(c) {label}",
              "events": DQ_EVENTS, "batch": DQ_BATCH, "symbols": n_sym,
              "mode": "sync", "store": "FileSystemPersistenceStore",
              "tmp_free_bytes_before": free,
              "persist_after_batch": CKPT_DQ_PERSIST_AT,
              "crash_on_batch": CKPT_DQ_CRASH_AT + 1, **run["line"],
              "rows_held_vs_uninterrupted_card": held,
              "final_state_equal_uninterrupted_card": True,
              "rows_held_vs_cpu": held_cpu,
              "cpu_cut": f"the CPU run takes the first {DQ_CHECK} batches",
              "card": card})
        dq_runs[label] = (dqb, ref)
        del run, cpu, ref_final
        gc.collect()

    # (e): partition_scaling_50000 into the durable store: rev1 after
    # batch 30, rev2 crashes after its manifest (journal mark not
    # committed), a byte of rev2's largest blob is flipped, and the
    # restore walks back to rev1 and replays from there
    dqb, ref = dq_runs["partition_scaling_50000"]
    plain = DEVICE_QUERY_APPS["partition_scaling_50000"][0]
    app = "@app:name('ckpt_e') @app:faults(journal='128') " + plain
    d, free = tmpdir()
    warnings = []

    class Warned(logging.Handler):
        def emit(self, record):
            if record.levelno == logging.WARNING:
                warnings.append(record.getMessage())

    wh = Warned()
    try:
        store = DurableFileSystemPersistenceStore(
            d, revisions_to_keep=CKPT_KEEP)
        mgr = SiddhiManager(device="cuda")
        mgr.set_persistence_store(store)
        rt = new_app(mgr, app)
        kept = []
        rt.add_callback("outputStream", ckpt_keep(StreamCallback, kept))
        rt.start()
        send_all(rt, dqb[:30])
        rev1 = rt.persist()
        send_all(rt, dqb[30:60])
        rt.app_context.fault_injector.configure("persist.post_manifest",
                                                "crash", count=1)
        try:
            rt.persist()
        except SimulatedCrashError:
            pass
        else:
            raise AssertionError("the armed persist crash did not fire")
        rt.shutdown()
        rev2 = store.get_last_revision("ckpt_e")
        rev_dir = os.path.join(d, "ckpt_e", rev2 + ".ckpt")
        blob = max((os.path.join(rev_dir, f) for f in os.listdir(rev_dir)
                    if f.endswith(".blob")), key=os.path.getsize)
        with open(blob, "r+b") as f:
            f.seek(os.path.getsize(blob) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        rt = new_app(mgr, app)
        rt.add_callback("outputStream", ckpt_keep(StreamCallback, kept))
        rt.start()
        logging.getLogger("siddhi_tpu_torch").addHandler(wh)
        t = time.perf_counter()
        restored = rt.restore_last_revision()
        restore_ms = 1e3 * (time.perf_counter() - t)
        logging.getLogger("siddhi_tpu_torch").removeHandler(wh)
        send_all(rt, dqb[60:])
        rt.drain()
        jst = rt.app_context.input_journal.stats
        replayed, suppressed = jst.replayed_batches, jst.suppressed_events
        rt.shutdown()
        mgr.shutdown()
    finally:
        logging.getLogger("siddhi_tpu_torch").removeHandler(wh)
        shutil.rmtree(d, ignore_errors=True)
    walked = [w for w in warnings if rev2 in w]
    held = ckpt_rows_held(EventBatch, kept, ref)
    if restored != rev1 or not walked or replayed != 30:
        raise AssertionError(f"checkpoint (e): restored {restored} (rev1 "
                             f"{rev1}, rev2 {rev2}), warnings {warnings}, "
                             f"replayed {replayed}")
    emit({"phase": "checkpoint", "app": "(e) partition_scaling_50000, a "
          "flipped byte in the newest revision",
          "store": "DurableFileSystemPersistenceStore",
          "tmp_free_bytes_before": free, "revisions": [rev1, rev2],
          "restored": "previous", "warnings": walked,
          "restore_ms": restore_ms, "replayed_batches": replayed,
          "suppressed_events": suppressed,
          "rows_held_vs_uninterrupted_card": held, "card": card})
    del dq_runs, ref
    gc.collect()

    # (d) every element type, rolled back with restore_revision ------------
    def kitchen(device):
        d, free = tmpdir()
        try:
            mgr = SiddhiManager(device=device)
            mgr.set_persistence_store(FileSystemPersistenceStore(
                d, revisions_to_keep=CKPT_KEEP))
            rt = new_app(mgr, KITCHEN_APP)
            got = []
            for o in ("WinOut", "GrpOut", "PatOut"):
                rt.add_callback(o, lambda evs, o=o: got.extend(
                    (o, e.timestamp, tuple(e.data)) for e in evs))
            rt.start()
            s = rt.get_input_handler("S")
            p = rt.get_input_handler("P")
            rng = np.random.default_rng(5)
            t = 1000
            for i in range(200):
                t += int(rng.integers(1, 40))
                h = s if rng.random() < 0.6 else p
                h.send([f"k{int(rng.integers(0, 5))}",
                        int(rng.integers(0, 30))], timestamp=t)
                if i == 99:
                    rev = rt.persist()
            rt.restore_revision(rev)
            for i in range(100):
                t += int(rng.integers(1, 40))
                h = s if rng.random() < 0.6 else p
                h.send([f"k{int(rng.integers(0, 5))}",
                        int(rng.integers(0, 30))], timestamp=t)
            pulls = [[tuple(e.data) for e in rt.query(q)] for q in (
                "from T select k, v;",
                "from A within 0L, 100000L per 'seconds' select k, total;")]
            low = rt.lowering()
            rt.shutdown()
            mgr.shutdown()
        finally:
            shutil.rmtree(d, ignore_errors=True)
        return got, pulls, low, free

    kc = kitchen("cuda")
    kp = kitchen("cpu")
    if kc[:3] != kp[:3] or not kc[0]:
        raise AssertionError("checkpoint (d): the card's rows after the "
                             "rollback differ from the CPU run's")
    emit({"phase": "checkpoint", "app": "(d) kitchen sink "
          "(tests/test_conformance_persistence2.py:18-29 + an aggregation)",
          "store": "FileSystemPersistenceStore",
          "tmp_free_bytes_before": kc[3], "lowering": kc[2],
          "rows_held_vs_cpu": len(kc[0]),
          "pull_rows_held_vs_cpu": [len(x) for x in kc[1]],
          "seconds": time.perf_counter() - t_phase, "card": card})
    return read_launches(kernels)


# -- 26. stream-graph fusion ---------------------------------------------------

# bench.py:494-507 FUSE_APP verbatim (its {trace} slot left empty)
FUSE_APP = ("@app:name('fusebench{tag}') @app:playback "
            "@app:execution('tpu') {fuse}{trace}"
            "define stream SIn (sym int, price float, vol int); "
            "define stream Mid (sym int, price float, vol int); "
            "define stream Win (sym int, total double); "
            "@info(name='q1') from SIn[price > 4.0] "
            "select sym, price, vol insert into Mid; "
            "@info(name='q2') from Mid#window.length(64) "
            "select sym, sum(price) as total insert into Win; "
            "@info(name='q3') from every e1=Win[total > 1540.0] "
            "-> e2=Win[total > e1.total] "
            "select e1.sym as s1, e1.total as t1, e2.total as t2 "
            "insert into Out;")
FUSE_BATCH = 8_192
# cut from 2 warm-up and 4 timed batches of 8,192, then from 2 timed to
# 1 to keep the script inside its time limit: the fused dense tail takes
# one general step a row, about 2.2-3.7 ms a row on the H100, so a batch
# of 8,192 takes 19-30 s on the card (8 s on its host's CPU); the
# warm-up batch is shorter
FUSE_WARMUP_ROWS = 1_024
FUSE_STEPS = 1
# bench.py's U(0, 30) prices keep every length(64) sum of the rows
# above 4.0 near 1,088, 7.5 sigma below the tail's 1540.0, so its run
# matches nothing; at U(0, 40) about 6% of the sums pass
FUSE_HIGH = 40.0
# at U(0, 40) up to 20 e1 instances wait at once (a numpy model of the
# pattern over this run's traffic), past the engine's default 4 lanes a
# node: the run takes 32, so no instance is dropped
FUSE_EXECUTION = "@app:execution('tpu', instances='32')"
# (b): the same chain with a device tail, at the main path's width
TAIL_APP = ("@app:name('fusetail{tag}') @app:playback "
            "@app:execution('tpu') {fuse}"
            "define stream SIn (sym int, price float, vol int); "
            "{mid}define stream Mid (sym int, price float, vol int); "
            "define stream Win (sym int, total double); "
            "@info(name='q1') from SIn[price > 4.0] "
            "select sym, price, vol insert into Mid; "
            "@info(name='q2') from Mid#window.length(64) "
            "select sym, sum(price) as total insert into Win; "
            "@info(name='q3') from Win[total > 1540.0] "
            "select sym, total insert into Out;")
TAIL_BATCH = 1 << 17
TAIL_WARMUP = 1
TAIL_STEPS = 4
ASYNC_MID = "@async(buffer.size='16') "
ASYNC_BATCH = 8_192
ASYNC_BATCHES = 8


def fuse_batches(EventBatch, sizes, high=30.0, seed=31):
    """bench.py's ``_run_fused_pipeline`` traffic, a batch of each of
    ``sizes`` rows: eight symbols strided over the stream, price ~ U(0,
    ``high``) float32, vol ~ [1, 100), one timestamp a batch, 10 ms
    apart."""
    rng = np.random.default_rng(seed)
    out = []
    start = 0
    for i, batch in enumerate(sizes):
        sym = (np.arange(batch, dtype=np.int64) * 524287 + start) % 8
        start += batch
        price = rng.uniform(0.0, high, batch).astype(np.float32)
        vol = rng.integers(1, 100, batch)
        ts = np.full(batch, 1_000 + i * 10, dtype=np.int64)
        out.append(EventBatch("SIn", ["sym", "price", "vol"],
                              {"sym": sym, "price": price, "vol": vol}, ts))
    return out


def held_concat(EventBatch, a, b, sum_cols) -> dict:
    """Two runs' outputs concatenated, every column bit for bit but
    ``sum_cols`` within the reference's float32 bound."""
    ca = [x for v in a["outs"].values() for x in v]
    cb = [x for v in b["outs"].values() for x in v]
    return dq_compare(EventBatch.concat(ca) if ca else None,
                      EventBatch.concat(cb) if cb else None, sum_cols, False)


def hop_dispatches(rt) -> dict:
    return {s: rt.junctions[s].dispatches for s in ("SIn", "Mid", "Win")}


def fusion_phase(torch, SiddhiManager, EventBatch, StreamCallback, kernels,
                 card) -> dict:
    """Phase 26: stream-graph fusion (``@app:fuse``).  (a) bench.py's
    own chain (filter, ``length(64)`` sum, a capturing two-node pattern
    tail; B = 8,192, eight symbols, price ~ U(0, 40)) fused on the card,
    unfused on the card and fused at ``device="cpu"``, its rows not
    none; (b) the chain with a device tail
    at B = 131,072 against the unfused run, with launches a batch and
    the busy share; (c) an ``@async`` intermediate falls back with its
    WARNING, its rows those of the fused run.  Returns the launches of
    the card runs."""
    launches = {k: 0 for k in kernels}
    fused = {"q1": "fused", "q2": "fused", "q3": "fused"}
    # (a)
    bs = fuse_batches(EventBatch, (FUSE_WARMUP_ROWS,)
                      + (FUSE_BATCH,) * FUSE_STEPS, high=FUSE_HIGH)
    warned = set(ISOLATED.warned)
    runs = {}
    for label, fuse, device in (("fused", True, "cuda"),
                                ("unfused", False, "cuda"),
                                ("cpu", True, "cpu")):
        app = FUSE_APP.format(
            tag=label, fuse="@app:fuse " if fuse else "", trace="").replace(
                "@app:execution('tpu')", FUSE_EXECUTION)
        r = run_join_app(torch, SiddhiManager, StreamCallback, app,
                         bs[:1], bs[1:], device, kernels, ("Out",))
        r["hops"] = hop_dispatches(r["rt"])
        if fuse:
            dr = r["rt"].query_runtimes["q3"].device_runtime
            r["dense_steps"] = dr.graph.dense_steps
            r["stats"] = dr.stats()
        if device == "cuda":
            for k, v in r["launches"].items():
                launches[k] += v
        close_run(r)
        runs[label] = r
    f, u, c = runs["fused"], runs["unfused"], runs["cpu"]
    if (f["lowering"] != fused or c["lowering"] != fused
            or u["lowering"] != {"q1": "device", "q2": "device",
                                 "q3": "dense"}
            or f["hops"]["Mid"] or f["hops"]["Win"]):
        raise AssertionError(f"fusion (a): lowering {f['lowering']}, "
                             f"unfused {u['lowering']}, hops {f['hops']}")
    vs_unfused = held_concat(EventBatch, f, u, ("t1", "t2"))
    vs_cpu = held_concat(EventBatch, f, c, ("t1", "t2"))
    if not vs_unfused["rows"] or not vs_cpu["rows"]:
        raise AssertionError("fusion (a): no rows to hold")
    dropped = [w for w in ISOLATED.warned - warned if "dropped" in w]
    if dropped:
        raise AssertionError(f"fusion (a): {dropped}")
    n_timed = FUSE_STEPS * FUSE_BATCH
    emit({"phase": "fusion", "case": "a", "app": "bench.py FUSE_APP",
          "batch": FUSE_BATCH, "warmup_rows": FUSE_WARMUP_ROWS,
          "timed": FUSE_STEPS, "price_high": FUSE_HIGH,
          "lowering": f["lowering"],
          "fused_events_per_s": n_timed / f["secs"],
          "unfused_events_per_s": n_timed / u["secs"],
          "fused_ms_each_batch": [1e3 * x for x in f["batch_s"]],
          "unfused_ms_each_batch": [1e3 * x for x in u["batch_s"]],
          "cpu_events_per_s": n_timed / c["secs"],
          "rows_vs_unfused": vs_unfused, "rows_vs_cpu": vs_cpu,
          "hop_dispatches_fused": f["hops"],
          "hop_dispatches_unfused": u["hops"],
          "dense_tail_steps": f["dense_steps"],
          "rows_sent": sum(len(b) for b in bs),
          "chain_stats": f["stats"], "launches": f["launches"],
          "card": card})
    # (b)
    bs = fuse_batches(EventBatch, [TAIL_BATCH] * (TAIL_WARMUP + TAIL_STEPS),
                      high=50.0, seed=37)
    runs = {}
    for label, fuse in (("fused", True), ("unfused", False)):
        app = TAIL_APP.format(tag=label, fuse="@app:fuse " if fuse else "",
                              mid="")
        r = run_join_app(torch, SiddhiManager, StreamCallback, app,
                         bs[:TAIL_WARMUP], bs[TAIL_WARMUP:], "cuda", kernels,
                         ("Out",))
        for k, v in r["launches"].items():
            launches[k] += v
        r["hops"] = hop_dispatches(r["rt"])
        extra = fuse_batches(EventBatch, [TAIL_BATCH], high=50.0, seed=41)
        extra[0].timestamps += 10 * (TAIL_WARMUP + TAIL_STEPS)
        rt = r["rt"]
        r["profile"] = device_profile(
            torch, lambda: (rt.get_input_handler("SIn").send_batch(extra[0]),
                            rt.drain()))
        close_run(r)
        runs[label] = r
    f, u = runs["fused"], runs["unfused"]
    if f["lowering"] != fused or f["hops"]["Mid"] or f["hops"]["Win"]:
        raise AssertionError(f"fusion (b): {f['lowering']}, {f['hops']}")
    held = held_concat(EventBatch, f, u, ("total",))
    if not held["rows"]:
        raise AssertionError("fusion (b): no rows to hold")
    n_timed = TAIL_STEPS * TAIL_BATCH
    emit({"phase": "fusion", "case": "b", "batch": TAIL_BATCH,
          "warmup": TAIL_WARMUP, "timed": TAIL_STEPS,
          "lowering": f["lowering"],
          "fused_events_per_s": n_timed / f["secs"],
          "unfused_events_per_s": n_timed / u["secs"],
          "fused_ms_a_batch": 1e3 * f["secs"] / TAIL_STEPS,
          "unfused_ms_a_batch": 1e3 * u["secs"] / TAIL_STEPS,
          "rows_vs_unfused": held,
          "fused_profile": f["profile"], "unfused_profile": u["profile"],
          "hop_dispatches_fused": f["hops"],
          "hop_dispatches_unfused": u["hops"], "card": card})
    # (c)
    bs = fuse_batches(EventBatch, [ASYNC_BATCH] * ASYNC_BATCHES, high=50.0,
                      seed=43)
    outs = {}
    for label, mid in (("fused", ""), ("async", ASYNC_MID)):
        warned = set(ISOLATED.warned)
        mgr = SiddhiManager(device="cuda")
        rt = new_app(mgr, TAIL_APP.format(tag=label, fuse="@app:fuse ",
                                          mid=mid))
        got = []

        class Rows(StreamCallback):
            def receive_batch(self, batch):
                got.append(batch)

        rt.add_callback("Out", Rows())
        rt.start()
        low = rt.lowering()
        for b in bs:
            rt.get_input_handler("SIn").send_batch(b)
        rt.shutdown()  # the async worker dispatches what it holds
        mgr.shutdown()
        outs[label] = {"outs": {"Out": got}, "lowering": low,
                       "warnings": sorted(ISOLATED.warned - warned)}
    a, fz = outs["async"], outs["fused"]
    reason = [w for w in a["warnings"] if "fused chain unavailable" in w]
    # q1 keeps the junction path; Mid -> Win -> Out still fuses
    if (fz["lowering"] != fused or a["lowering"]["q1"] != "device"
            or not any("@async" in w for w in reason)):
        raise AssertionError(f"fusion (c): {a['lowering']}, {reason}")
    held = held_concat(EventBatch, a, fz, ("total",))
    emit({"phase": "fusion", "case": "c", "lowering": a["lowering"],
          "fallback_warnings": reason, "rows_vs_fused": held,
          "card": card})
    return launches


# -- 27. device tables ---------------------------------------------------------

# bench.py:1005-1014 (bench_devtable_join's app) at the port's default
# depths, so the numpy model's order (upsert batch i, then probe batch i)
# is the run's
DT_APP = ("@app:name('dtbench{tag}') @app:playback "
          "@app:execution('tpu') {dev}"
          "define stream S (k int, x float); "
          "define stream Ups (k int, v float); "
          "@PrimaryKey('k') define table T (k int, v float); "
          "from Ups update or insert into T set T.v = v on T.k == k; "
          "@info(name='j') from S join T as t on S.k == t.k "
          "select S.k as k, S.x as x, t.v as v insert into Out;")
DT_ROWS = 1_000_000
DT_CAPACITY = 1 << 20
DT_BATCH = 1 << 17
DT_UPSERTS = 16_384
DT_WARMUP = 1
DT_STEPS = 4
# (b): the reference bench's own shape
DTB_ROWS = 8_192
DTB_CAPACITY = 16_384
DTB_BATCH = 8_192
DTB_UPSERTS = 1_024
DTB_WARMUP = 2
DTB_STEPS = 4
# (c): an overflow that compacts, then demotes: the same app with a
# delete stream
DTC_CAPACITY = 4_096
DTC_APP = DT_APP.replace(
    "from Ups update", "define stream Del (k int); "
    "from Del delete T on T.k == k; from Ups update").replace(
    "dtbench{tag}", "dtover{tag}")


def dt_batches(EventBatch, rows, batch, n_ups, n, seed=41):
    """bench_devtable_join's traffic: the seed upsert of every key in
    ``[0, rows)`` (v = k % 97), then per step an upsert batch of
    ``n_ups`` random keys and a probe batch of ``batch`` keys strided
    over ``[0, 2 rows)`` (about half hit)."""
    rng = np.random.default_rng(seed)
    seed_k = np.arange(rows, dtype=np.int32)
    seed_b = EventBatch("Ups", ["k", "v"],
                        {"k": seed_k, "v": (seed_k % 97).astype(np.float32)},
                        np.full(rows, 500, dtype=np.int64))
    steps = []
    for i in range(n):
        k = ((np.arange(batch, dtype=np.int64) * 524287 + i * batch)
             % (rows * 2)).astype(np.int32)
        x = rng.uniform(0.0, 1.0, batch).astype(np.float32)
        probe = EventBatch("S", ["k", "x"], {"k": k, "x": x},
                           np.full(batch, 1_000 + i * 20, dtype=np.int64))
        uk = rng.integers(0, rows, n_ups).astype(np.int32)
        uv = rng.uniform(0.0, 100.0, n_ups).astype(np.float32)
        ups = EventBatch("Ups", ["k", "v"], {"k": uk, "v": uv},
                         np.full(n_ups, 1_010 + i * 20, dtype=np.int64))
        steps.extend((ups, probe))
    return seed_b, steps


def dt_model(rows, steps) -> tuple:
    """The plain reference of the join: a ``[rows]`` value array, each
    upsert batch applied in order (the last writer of a key wins), each
    probe's hits in arrival order."""
    v = (np.arange(rows) % 97).astype(np.float32)
    ks, xs, vs = [], [], []
    for b in steps:
        k = b.columns["k"]
        if b.stream_id == "Ups":
            rk, rv = k[::-1], b.columns["v"][::-1]
            _u, first = np.unique(rk, return_index=True)
            v[rk[first]] = rv[first]
            continue
        hit = k < rows
        ks.append(k[hit])
        xs.append(b.columns["x"][hit])
        vs.append(v[k[hit]])
    return np.concatenate(ks), np.concatenate(xs), np.concatenate(vs)


def dt_split(torch, rt, steps) -> dict:
    """Median synchronised ms of the probe (every chunk's dispatch) and of
    the scatter steps a batch pair, over ``steps``."""
    from siddhi_tpu_torch.devtable import DevTableJoinRuntime, DeviceTable

    table = rt.tables["T"]
    jr = rt.query_runtimes["j"].device_runtime
    spent = {"probe": 0.0, "scatter": 0.0}

    def timed(obj, name, key):
        fn = getattr(obj, name)

        def wrap(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                spent[key] += time.perf_counter() - t

        setattr(obj, name, wrap)

    assert isinstance(table, DeviceTable)
    assert isinstance(jr, DevTableJoinRuntime)
    timed(jr, "_dispatch_chunk", "probe")
    timed(table, "_apply_scatter", "scatter")
    per = {"probe_ms": [], "scatter_ms": []}
    for i in range(0, len(steps), 2):
        spent.update(probe=0.0, scatter=0.0)
        for b in steps[i:i + 2]:
            rt.get_input_handler(b.stream_id).send_batch(b)
        rt.drain()
        per["probe_ms"].append(1e3 * spent["probe"])
        per["scatter_ms"].append(1e3 * spent["scatter"])
    del jr._dispatch_chunk, table._apply_scatter
    return {k: sorted(v)[len(v) // 2] for k, v in per.items()}


def dt_run(torch, SiddhiManager, StreamCallback, app, seed_b, steps, warm,
           device, kernels):
    """The seed, ``warm`` batch pairs, then the rest timed (each pair
    synchronised)."""
    r = run_join_app(torch, SiddhiManager, StreamCallback, app,
                     [seed_b] + steps[:2 * warm], steps[2 * warm:], device,
                     kernels, ("Out",))
    r["batch_s"] = [a + b for a, b in zip(r["batch_s"][0::2],
                                          r["batch_s"][1::2])]
    return r


def devtables_phase(torch, SiddhiManager, EventBatch, StreamCallback,
                    kernels, card) -> dict:
    """Phase 27: device tables (``@app:devtables``).  (a) bench.py's
    stream-table join at 1,000,000 seeded rows, capacity 1,048,576,
    probes of 131,072 (about half hit) and 16,384 upserts a batch pair,
    held against the numpy model of the join; (b) the reference bench's
    shape, card against ``device="cpu"`` bit for bit and beside the host
    table on the card; (c) an overflow that compacts and then demotes
    with its WARNING, its rows the host table's.  Returns the launches
    of the card runs."""
    launches = {k: 0 for k in kernels}
    dev_ann = "@app:devtables(capacity='{}') "
    # (a)
    seed_b, steps = dt_batches(EventBatch, DT_ROWS, DT_BATCH, DT_UPSERTS,
                               DT_WARMUP + DT_STEPS + 2)
    timed = steps[:2 * (DT_WARMUP + DT_STEPS)]
    app = DT_APP.format(tag="D", dev=dev_ann.format(DT_CAPACITY))
    t0 = time.perf_counter()
    r = dt_run(torch, SiddhiManager, StreamCallback, app, seed_b, timed,
               DT_WARMUP, "cuda", kernels)
    for k, v in r["launches"].items():
        launches[k] += v
    table = r["rt"].tables["T"]
    state_bytes = table.state_bytes()
    metrics = table.devtable_metrics()
    split = dt_split(torch, r["rt"], steps[len(timed):])
    close_run(r)
    got = EventBatch.concat(r["outs"]["Out"])
    k, x, v = dt_model(DT_ROWS, timed)
    if (r["lowering"].get("j") != "devtable" or metrics["devtableDemoted"]
            or not np.array_equal(got.columns["k"], k)
            or not np.array_equal(got.columns["x"].view(np.uint32),
                                  x.view(np.uint32))
            or not np.array_equal(got.columns["v"].view(np.uint32),
                                  v.view(np.uint32))):
        raise AssertionError(f"devtables (a): lowering {r['lowering']}, "
                             f"{metrics}, rows {len(got)} vs {len(k)}")
    n_timed = DT_STEPS * (DT_BATCH + DT_UPSERTS)
    emit({"phase": "devtables", "case": "a", "lowering": r["lowering"],
          "rows": DT_ROWS, "capacity": DT_CAPACITY, "probes": DT_BATCH,
          "upserts": DT_UPSERTS, "warmup": DT_WARMUP, "timed": DT_STEPS,
          "state_bytes_on_card": state_bytes,
          "events_per_s": n_timed / r["secs"],
          "ms_a_batch_pair": 1e3 * r["secs"] / DT_STEPS,
          "probe_ms_a_batch": split["probe_ms"],
          "scatter_ms_a_batch": split["scatter_ms"],
          "rows_held_vs_numpy": len(k),
          "host_table": "not run at this width: the host join is a cross "
                        "product (1.3e11 pairs a batch); (b) runs it",
          "seconds_with_seed": time.perf_counter() - t0,
          "metrics": metrics, "launches": r["launches"], "card": card})
    # (b)
    seed_b, steps = dt_batches(EventBatch, DTB_ROWS, DTB_BATCH, DTB_UPSERTS,
                               DTB_WARMUP + DTB_STEPS)
    runs = {}
    for label, dev, device in (("devtable", True, "cuda"),
                               ("cpu", True, "cpu"),
                               ("host_table", False, "cuda")):
        app = DT_APP.format(tag=label,
                            dev=dev_ann.format(DTB_CAPACITY) if dev else "")
        r = dt_run(torch, SiddhiManager, StreamCallback, app, seed_b, steps,
                   DTB_WARMUP, device, kernels)
        if device == "cuda":
            for kk, vv in r["launches"].items():
                launches[kk] += vv
        close_run(r)
        runs[label] = r
    d, c, h = runs["devtable"], runs["cpu"], runs["host_table"]
    vs_cpu = held_vs(d, c)
    vs_host = held_concat(EventBatch, d, h, ())
    k, _x, _v = dt_model(DTB_ROWS, steps)
    if (d["lowering"].get("j") != "devtable"
            or c["lowering"] != d["lowering"]
            or h["lowering"].get("j") == "devtable"
            or vs_host["rows"] != len(k)):
        raise AssertionError(f"devtables (b): {d['lowering']}, "
                             f"{h['lowering']}, {vs_host}")
    n_timed = DTB_STEPS * (DTB_BATCH + DTB_UPSERTS)
    emit({"phase": "devtables", "case": "b", "rows": DTB_ROWS,
          "capacity": DTB_CAPACITY, "probes": DTB_BATCH,
          "upserts": DTB_UPSERTS, "lowering": d["lowering"],
          "host_lowering": h["lowering"],
          "events_per_s": n_timed / d["secs"],
          "host_table_events_per_s": n_timed / h["secs"],
          "cpu_events_per_s": n_timed / c["secs"],
          "rows_held_vs_cpu": vs_cpu, "rows_vs_host_table": vs_host,
          "card": card})
    # (c)
    half = DTC_CAPACITY // 2
    seed_b, steps = dt_batches(EventBatch, half, 2_048, 512, 2, seed=47)

    def keys_batch(stream, lo, hi, ts):
        k = np.arange(lo, hi, dtype=np.int32)
        cols = {"k": k} if stream == "Del" else {
            "k": k, "v": (k % 89).astype(np.float32)}
        return EventBatch(stream, list(cols), cols,
                          np.full(len(k), ts, dtype=np.int64))

    # tombstones, then new keys that fit only after a compaction, then
    # more than the table holds, each followed by probes
    churn = [keys_batch("Del", 0, half // 2, 1_100), steps[1],
             keys_batch("Ups", half, DTC_CAPACITY + half // 2, 1_200),
             steps[3],
             keys_batch("Ups", DTC_CAPACITY + half // 2, 2 * DTC_CAPACITY,
                        1_300),
             keys_batch("Del", half, half + 64, 1_400), steps[3]]
    churn[-1] = EventBatch("S", ["k", "x"], dict(steps[3].columns),
                           steps[3].timestamps + 1_000)
    runs = {}
    for label, dev in (("devtable", True), ("host_table", False)):
        warned = set(ISOLATED.warned)
        app = DTC_APP.format(tag=label,
                             dev=dev_ann.format(DTC_CAPACITY) if dev else "")
        r = run_join_app(torch, SiddhiManager, StreamCallback, app,
                         [seed_b] + steps[:2], churn, "cuda", kernels,
                         ("Out",))
        r["metrics"] = (r["rt"].tables["T"].devtable_metrics() if dev
                        else None)
        r["warnings"] = sorted(ISOLATED.warned - warned)
        close_run(r)
        runs[label] = r
    d, h = runs["devtable"], runs["host_table"]
    held = held_concat(EventBatch, d, h, ())
    demoted = [w for w in d["warnings"] if "demoting" in w]
    if (not d["metrics"]["devtableDemoted"] or not demoted
            or d["metrics"]["devtableCompactions"] < 1 or not held["rows"]):
        raise AssertionError(f"devtables (c): {d['metrics']}, {demoted}")
    emit({"phase": "devtables", "case": "c", "capacity": DTC_CAPACITY,
          "metrics": d["metrics"], "demotion_warnings": demoted,
          "rows_vs_host_table": held, "card": card})
    return launches


# -- 28-29. multiplexing and transports ----------------------------------------

MUX_TENANTS = 8
MUX_KEYS = 1_024
MUX_BATCH = 4_096
MUX_PANE = 1 << 16
MUX_STEPS = 10
MUX_WARMUP = 2
MUX_WINDOWS = 3
MUX_APP = ("@app:name('muxbench{{i}}') @app:playback @app:execution('tpu'"
           "{parts}) {mux}define stream Mkt (k long, v double); "
           "@info(name='w') from Mkt#window.lengthBatch(" + str(MUX_PANE)
           + ") select k, sum(v) as s, count() as c group by k "
           "insert into Panes;")
# (b): the 1k-tenant deployment of the same app, 64 seats a group, the
# group axis sized to the 1,024 keys each tenant sends
MUXB_TENANTS = 1_024
MUXB_SLOTS = 64
MUXB_WARMUP = 1
MUXB_STEPS = 4
# (c): the dense group, capture-free and capturing chains
MUXC_TENANTS = 64
MUXC_BATCH = 4_096
MUXC_WARMUP = 2
MUXC_STEPS = 6
# the CPU run of the capture-free chain: its first cycle (4,096 ranks of
# the plain batch step, one a segment position)
MUXC_CPU_CYCLES = 1
MUXC_CAP_BATCH = 64
MUXC_CAP_CYCLES = 2  # one warm-up, one timed: a dedicated cycle is 4,096
                     # general-step rounds
MUXC_CAP_APP = ("define stream Txn (key long, v double); @info(name='bench') "
                "from every e1=Txn[v > 1.0] -> e2=Txn[v > e1.v] within 10 min "
                "select e1.v as a, e2.v as b insert into Alerts;")
TR_EVENTS = 1_000_000
TR_BATCH = 8_192
TR_SYMBOLS = 48
TR_ERR_BATCHES = 32


def mux_batches(EventBatch, tenants, cycles, batch=MUX_BATCH, keys=MUX_KEYS,
                seed=23):
    """bench.py's ``bench_multiplexed`` traffic: each cycle the same keys
    for every tenant (strided over ``keys``), v ~ [0, 50) integer-valued,
    one timestamp a cycle, 10 ms apart; drawn cycle by cycle, tenant by
    tenant, as the bench draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(cycles):
        k = (np.arange(batch, dtype=np.int64) * 524287 + i * batch) % keys
        ts = np.full(batch, 1_000 + i * 10, dtype=np.int64)
        out.append([EventBatch("Mkt", ["k", "v"], {
            "k": k, "v": rng.integers(0, 50, batch).astype(np.float64)}, ts)
            for _t in range(tenants)])
    return out


def dense_mux_batches(EventBatch, tenants, cycles, batch, seed=29):
    """Each tenant's sub-batch a cycle: v ~ U(0, 20), 1 ms apart."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(cycles):
        ts = 1_000 + i * batch + np.arange(batch, dtype=np.int64)
        out.append([EventBatch("Txn", ["key", "v"], {
            "key": np.full(batch, t, dtype=np.int64),
            "v": rng.uniform(0.0, 20.0, batch)}, ts)
            for t in range(tenants)])
    return out


def run_tenants(torch, SiddhiManager, StreamCallback, apps, cycles, warmup,
                windows, device, kernels, out_stream, snapshot=False):
    """One app runtime a tenant on one manager; each cycle sends every
    tenant its sub-batch.  The output batches per tenant, the seconds of
    app creation and of each timed window (synchronised), the launches
    by kernel over the whole drive, the lowering, the groups' counters,
    and with ``snapshot`` each tenant's query snapshot."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    # the counts cover the drive from app creation on: each dense group
    # or dedicated dense engine probes the card's kernels once
    zero_launches(kernels)
    mgr = SiddhiManager(device=device)
    t0 = time.perf_counter()
    rts = [new_app(mgr, app) for app in apps]
    create_s = time.perf_counter() - t0
    outs = [[] for _ in rts]
    for rt, o in zip(rts, outs):
        rt.add_callback(out_stream, ckpt_keep(StreamCallback, o))
        rt.start()
    stream = cycles[0][0].stream_id
    hs = [rt.get_input_handler(stream) for rt in rts]
    for cycle in cycles[:warmup]:
        for h, b in zip(hs, cycle):
            h.send_batch(b)
    sync()
    window_s = []
    steps = (len(cycles) - warmup) // max(windows, 1)
    for w in range(windows):
        t = time.perf_counter()
        for cycle in cycles[warmup + w * steps:warmup + (w + 1) * steps]:
            for h, b in zip(hs, cycle):
                h.send_batch(b)
        sync()
        window_s.append(time.perf_counter() - t)
    for rt in rts:
        rt.drain()
    sync()
    launches = read_launches(kernels)
    reg = mgr.siddhi_context.multiplex_registry
    groups = reg.open_groups() if reg is not None else []
    counters = {
        "groups": len(groups),
        "dispatches": sum(g.dispatches for g in groups),
        "combined_steps": sum(g.combined_steps for g in groups),
        "slow_steps": sum(getattr(g, "slow_steps", 0) for g in groups),
        "flush_skips": sum(getattr(g, "flush_skips", 0) for g in groups),
        "longest_segment": max((getattr(g, "last_longest", 0)
                                for g in groups), default=0),
        "bank_bytes": sum(g.state_bytes() for g in groups)}
    run = {"outs": outs, "create_s": create_s, "window_s": window_s,
           "launches": launches, "counters": counters,
           "lowering": rts[0].lowering(step_kinds=True)}
    if snapshot:
        run["snaps"] = []
        for rt in rts:
            qr = next(iter(rt.query_runtimes.values()))
            dr = qr.device_runtime
            run["snaps"].append(dr.snapshot())
        if not groups:
            run["counters"]["bank_bytes"] = sum(
                card_state_bytes(rt) for rt in rts)
    for rt in rts:
        rt.shutdown()
    mgr.shutdown()
    gc.collect()
    return run


def before(EventBatch, run, limit):
    """``run`` with each tenant's output cut to the rows stamped before
    ``limit`` (all of them when None)."""
    if limit is None:
        return run
    outs = []
    for batches in run["outs"]:
        keep = []
        for b in batches:
            sel = np.flatnonzero(b.timestamps < limit)
            if len(sel):
                keep.append(EventBatch(
                    b.stream_id, b.attribute_names,
                    {k: np.asarray(v)[sel] for k, v in b.columns.items()},
                    b.timestamps[sel], b.types[sel]))
        outs.append(keep)
    return {**run, "outs": outs}


def held_tenants(EventBatch, a, b) -> int:
    """Two runs' outputs, tenant by tenant, bit for bit; the rows held."""
    rows = 0
    for x, y in zip(a["outs"], b["outs"]):
        rows += dq_compare(EventBatch.concat(x) if x else None,
                           EventBatch.concat(y) if y else None, (),
                           True)["rows"]
    return rows


def same_snapshots(a, b) -> int:
    """Each tenant's device rows and pane bookkeeping, bit for bit; the
    accumulator rows held."""
    rows = 0
    for x, y in zip(a["snaps"], b["snaps"]):
        dx, dy = x["device_state"], y["device_state"]
        if sorted(dx) != sorted(dy):
            raise AssertionError(f"state keys {sorted(dx)} vs {sorted(dy)}")
        for k in dx:
            p, q = np.asarray(dx[k]), np.asarray(dy[k])
            if p.shape != q.shape or not np.array_equal(
                    p.view(np.uint8), q.view(np.uint8)):
                raise AssertionError(f"tenant state '{k}' differs")
        for k in ("pane_fill", "group_vals"):
            if x["host"][k] != y["host"][k]:
                raise AssertionError(f"tenant host '{k}' differs")
        rows += len(dx["acc_cnt"])
    return rows


def rate(run, per_window) -> float:
    return per_window * len(run["window_s"]) / sum(run["window_s"])


def multiplex_phase(torch, SiddhiManager, EventBatch, StreamCallback,
                    kernels, card) -> dict:
    """Phase 28: multi-tenant multiplexing (``@app:multiplex``).  (a)
    bench.py's ``bench_multiplexed``: 8 tenants, 1,024 keys, 4,096 events
    a tenant a cycle, panes of 65,536, 2 warm-up cycles then 3 windows of
    10, multiplexed and dedicated on the card and multiplexed on the CPU,
    the rows bit for bit; (b) the same app for 1,024 tenants at 64 seats
    a group, multiplexed against dedicated, every tenant's accumulator
    rows bit for bit; (c) 64 tenants of the capture-free 16-node chain
    (one ``batch_step`` a cycle) and 64 of the capturing two-node chain
    (the general step's rounds), against the dedicated card runs and the
    CPU.  Returns the launches of the card runs."""
    launches = {k: 0 for k in kernels}

    def add(run):
        for k, v in run["launches"].items():
            launches[k] += v

    # (a)
    cycles = mux_batches(EventBatch, MUX_TENANTS,
                         MUX_WARMUP + MUX_STEPS * MUX_WINDOWS)
    mux_apps = [MUX_APP.format(parts="", mux="@app:multiplex(slots='8') ")
                .format(i=i) for i in range(MUX_TENANTS)]
    ded_apps = [MUX_APP.format(parts="", mux="").format(i=i)
                for i in range(MUX_TENANTS)]
    runs = {}
    for label, apps, device in (("mux", mux_apps, "cuda"),
                                ("dedicated", ded_apps, "cuda"),
                                ("cpu", mux_apps, "cpu")):
        runs[label] = run_tenants(torch, SiddhiManager, StreamCallback, apps,
                                  cycles, MUX_WARMUP, MUX_WINDOWS, device,
                                  kernels, "Panes")
    add(runs["mux"])
    add(runs["dedicated"])
    m, d, c = runs["mux"], runs["dedicated"], runs["cpu"]
    held = held_tenants(EventBatch, m, d)
    held_cpu = held_tenants(EventBatch, m, c)
    n_cycles = MUX_WARMUP + MUX_STEPS * MUX_WINDOWS
    mc = m["counters"]
    if (m["lowering"] != {"w": "multiplex"} or mc["groups"] != 1
            or d["lowering"] != {"w": "device"} or not held
            or held != held_cpu or m["launches"]["bank_scatter"] < 1):
        raise AssertionError(f"multiplex (a): {m['lowering']} {mc} "
                             f"{d['lowering']} rows {held}/{held_cpu} "
                             f"{m['launches']}")
    per_window = MUX_TENANTS * MUX_BATCH * MUX_STEPS
    emit({"phase": "multiplex", "case": "a", "tenants": MUX_TENANTS,
          "keys": MUX_KEYS, "batch": MUX_BATCH, "pane": MUX_PANE,
          "warmup": MUX_WARMUP, "windows": MUX_WINDOWS, "steps": MUX_STEPS,
          "lowering": m["lowering"],
          "events_per_s": rate(m, per_window),
          "events_per_s_windows": [per_window / t for t in m["window_s"]],
          "dedicated_events_per_s": rate(d, per_window),
          "cpu_events_per_s": rate(c, per_window),
          "dispatches_per_cycle": mc["dispatches"] / n_cycles,
          "dedicated_dispatches_per_cycle": MUX_TENANTS,
          "combined_steps": mc["combined_steps"],
          "slow_steps": mc["slow_steps"],
          "accumulate_launches": m["launches"]["bank_scatter"],
          "dedicated_accumulate_launches": d["launches"]["bank_scatter"],
          "bank_bytes": mc["bank_bytes"],
          "rows_held_vs_dedicated": held, "rows_held_vs_cpu": held_cpu,
          "card": card})
    del runs, m, d, c, cycles
    gc.collect()
    torch.cuda.empty_cache()
    # (b)
    cycles = mux_batches(EventBatch, MUXB_TENANTS, MUXB_WARMUP + MUXB_STEPS,
                         seed=41)
    parts = f", partitions='{MUX_KEYS}'"
    mux_apps = [MUX_APP.format(parts=parts,
                               mux=f"@app:multiplex(slots='{MUXB_SLOTS}') ")
                .format(i=i) for i in range(MUXB_TENANTS)]
    ded_apps = [MUX_APP.format(parts=parts, mux="").format(i=i)
                for i in range(MUXB_TENANTS)]
    m = run_tenants(torch, SiddhiManager, StreamCallback, mux_apps, cycles,
                    MUXB_WARMUP, 1, "cuda", kernels, "Panes", snapshot=True)
    add(m)
    d = run_tenants(torch, SiddhiManager, StreamCallback, ded_apps, cycles,
                    MUXB_WARMUP, 1, "cuda", kernels, "Panes", snapshot=True)
    add(d)
    held_rows = same_snapshots(m, d)
    held_out = held_tenants(EventBatch, m, d)
    mc = m["counters"]
    n_cycles = MUXB_WARMUP + MUXB_STEPS
    if (m["lowering"] != {"w": "multiplex"}
            or mc["groups"] != MUXB_TENANTS // MUXB_SLOTS
            or held_rows != MUXB_TENANTS * MUX_KEYS):
        raise AssertionError(f"multiplex (b): {m['lowering']} {mc} "
                             f"rows {held_rows}")
    per_window = MUXB_TENANTS * MUX_BATCH * MUXB_STEPS
    emit({"phase": "multiplex", "case": "b", "tenants": MUXB_TENANTS,
          "slots": MUXB_SLOTS, "groups": mc["groups"], "keys": MUX_KEYS,
          "batch": MUX_BATCH, "warmup": MUXB_WARMUP, "timed": MUXB_STEPS,
          "app_creation_s": m["create_s"],
          "dedicated_app_creation_s": d["create_s"],
          "events_per_s": rate(m, per_window),
          "dedicated_events_per_s": rate(d, per_window),
          "dispatches_per_cycle": mc["dispatches"] / n_cycles,
          "dedicated_dispatches_per_cycle": MUXB_TENANTS,
          "combined_steps": mc["combined_steps"],
          "slow_steps": mc["slow_steps"],
          "accumulate_launches": m["launches"]["bank_scatter"],
          "accumulator_rows": held_rows, "bank_bytes": mc["bank_bytes"],
          "dedicated_state_bytes": d["counters"]["bank_bytes"],
          "rows_held_vs_dedicated": held_rows,
          "output_rows_held": held_out,
          "held": "every tenant's accumulator rows and pane fill: 5 "
                  "cycles of 4,096 leave each pane of 65,536 open",
          "card": card})
    del m, d, cycles
    gc.collect()
    torch.cuda.empty_cache()
    # (c)
    for label, body, batch, n_cyc, warm, cpu_cyc in (
            ("batch", kernel_eligible_app(), MUXC_BATCH,
             MUXC_WARMUP + MUXC_STEPS, MUXC_WARMUP, MUXC_CPU_CYCLES),
            ("general", MUXC_CAP_APP, MUXC_CAP_BATCH, MUXC_CAP_CYCLES, 1,
             MUXC_CAP_CYCLES)):
        cycles = dense_mux_batches(EventBatch, MUXC_TENANTS, n_cyc, batch)
        head = "@app:name('mc{i}') @app:playback @app:execution('tpu') "
        mux_apps = [(head + f"@app:multiplex(slots='{MUXC_TENANTS}') "
                     + body).format(i=i) for i in range(MUXC_TENANTS)]
        ded_apps = [(head + body).format(i=i) for i in range(MUXC_TENANTS)]
        runs = {}
        for run_label, apps, device, cyc, w in (
                ("mux", mux_apps, "cuda", cycles, warm),
                ("dedicated", ded_apps, "cuda", cycles, warm),
                ("cpu", mux_apps, "cpu", cycles[:cpu_cyc],
                 min(warm, cpu_cyc - 1))):
            runs[run_label] = run_tenants(
                torch, SiddhiManager, StreamCallback, apps, cyc, w, 1,
                device, kernels, "Alerts")
        m, d, c = runs["mux"], runs["dedicated"], runs["cpu"]
        add(m)
        add(d)
        held = held_tenants(EventBatch, m, d)
        # the CPU run's cycles: rows completed before the next cycle's
        # first event
        limit = int(cycles[cpu_cyc][0].timestamps[0]) if cpu_cyc < n_cyc \
            else None
        held_cpu = held_tenants(EventBatch, before(EventBatch, m, limit), c)
        mc = m["counters"]
        want = {"bench": f"multiplex/{label}"}
        bad = (m["lowering"] != want or c["lowering"] != want
               or d["lowering"] != {"bench": f"dense/{label}"}
               or not held or not held_cpu or mc["groups"] != 1
               or (held != held_cpu and cpu_cyc == n_cyc))
        if label == "batch":
            bad = bad or (m["launches"]["dense_batch"] != n_cyc
                          or d["launches"]["dense_batch"]
                          != n_cyc * MUXC_TENANTS)
        if bad:
            raise AssertionError(f"multiplex (c) {label}: {m['lowering']} "
                                 f"{d['lowering']} {mc} rows {held}/"
                                 f"{held_cpu} {m['launches']} "
                                 f"{d['launches']}")
        per_window = MUXC_TENANTS * batch * (n_cyc - warm)
        emit({"phase": "multiplex", "case": f"c/{label}",
              "tenants": MUXC_TENANTS, "batch": batch, "warmup": warm,
              "timed": n_cyc - warm, "lowering": m["lowering"],
              "events_per_s": rate(m, per_window),
              "dedicated_events_per_s": rate(d, per_window),
              "cpu_events_per_s": rate(c, MUXC_TENANTS * batch
                                       * (cpu_cyc - min(warm, cpu_cyc - 1))),
              "cpu_cycles": cpu_cyc,
              "dispatches_per_cycle": mc["dispatches"] / n_cyc,
              "longest_segment": mc["longest_segment"],
              "dense_batch_launches": m["launches"]["dense_batch"],
              "dedicated_dense_batch_launches":
                  d["launches"]["dense_batch"],
              "probe_launches": m["launches"]["probe"],
              "dedicated_probe_launches": d["launches"]["probe"],
              "bank_bytes": mc["bank_bytes"],
              "rows_held_vs_dedicated": held, "rows_held_vs_cpu": held_cpu,
              "card": card})
        del runs, m, d, c, cycles
        gc.collect()
    return launches


def tr_batches(EventBatch, n_events=TR_EVENTS, batch=TR_BATCH, seed=53):
    """The verify skill's stream at scale: 48 symbols, integer-valued
    float32 prices (their sums are exact in any order), volume ~ [0,
    300), 1 ms apart, in batches of 8,192."""
    rng = np.random.default_rng(seed)
    syms = np.array([f"S{i:02d}" for i in range(TR_SYMBOLS)], dtype=object)
    out = []
    for lo in range(0, n_events, batch):
        n = min(batch, n_events - lo)
        out.append(EventBatch("S", ["symbol", "price", "volume"], {
            "symbol": syms[rng.integers(0, TR_SYMBOLS, n)],
            "price": rng.integers(1, 1_000, n).astype(np.float32),
            "volume": rng.integers(0, 300, n).astype(np.int64)},
            1_000 + lo + np.arange(n, dtype=np.int64)))
    return out


TR_BODY = ("define stream S (symbol string, price float, volume long); "
           "{sink_out}define stream Out (symbol string, price float); "
           "{sink_agg}define stream Agg (symbol string, total double, "
           "n long); "
           "@info(name='filter') from S[volume < 150] select symbol, price "
           "insert into Out; "
           "@info(name='agg') from S#window.lengthBatch(8192) "
           "select symbol, sum(price) as total, count() as n "
           "group by symbol insert into Agg;")


def tr_app(tag, mapper=None):
    src = sink_out = sink_agg = ""
    if mapper is not None:
        src = (f"@source(type='inMemory', topic='tr-in-{tag}', "
               f"@map(type='{mapper}')) ")
        sink_out = (f"@sink(type='inMemory', topic='tr-out-{tag}', "
                    f"@map(type='{mapper}')) ")
        sink_agg = (f"@sink(type='inMemory', topic='tr-agg-{tag}', "
                    f"@map(type='{mapper}')) ")
    return (f"@app:name('tr{tag}') @app:playback @app:execution('tpu') "
            + src + TR_BODY.format(sink_out=sink_out, sink_agg=sink_agg))


def tr_rows(values) -> list:
    """Rows as python tuples (float32 prices by value)."""
    return [tuple(v.item() if isinstance(v, np.generic) else v for v in r)
            for r in values]


def run_transport(torch, SiddhiManager, StreamCallback, batches, payloads,
                  mapper, device, kernels):
    """The transport app over the traffic: through the input handler and
    stream callbacks (``mapper`` None), or published to its source and
    received from its sinks' topics by broker subscribers.  The Out and
    Agg rows, the seconds (synchronised), the launches and the
    lowering."""
    from siddhi_tpu_torch.core.event import events_from_batch
    from siddhi_tpu_torch.transport.broker import (
        FunctionSubscriber,
        InMemoryBroker,
    )

    tag = f"{mapper or 'handler'}-{device}"
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    mgr = SiddhiManager(device=device)
    rt = new_app(mgr, tr_app(tag, mapper))
    got = {"Out": [], "Agg": []}
    subs = []
    if mapper is None:
        for o in got:
            rt.add_callback(o, ckpt_keep(StreamCallback, got[o]))
    else:
        for o, topic in (("Out", f"tr-out-{tag}"), ("Agg", f"tr-agg-{tag}")):
            subs.append(FunctionSubscriber(topic, got[o].append))
            InMemoryBroker.subscribe(subs[-1])
    rt.start()
    zero_launches(kernels)
    h = rt.get_input_handler("S")
    sync()
    t = time.perf_counter()
    if mapper is None:
        for b in batches:
            h.send_batch(b)
    else:
        for p in payloads:
            InMemoryBroker.publish(f"tr-in-{tag}", p)
    rt.drain()
    sync()
    secs = time.perf_counter() - t
    launches = read_launches(kernels)
    low = rt.lowering()
    rt.shutdown()
    for s in subs:
        InMemoryBroker.unsubscribe(s)
    mgr.shutdown()
    rows = {}
    for o, items in got.items():
        if mapper is None:
            rows[o] = tr_rows(e.data for b in items
                              for e in events_from_batch(b))
        elif mapper == "json":
            rows[o] = tr_rows(tuple(json.loads(s).values()) for s in items)
        else:
            rows[o] = tr_rows(e.data for e in items)
    return {"rows": rows, "secs": secs, "launches": launches,
            "lowering": low}


def tr_err_app(tag):
    return (f"@app:name('trerr{tag}') @app:playback "
            "@app:execution('tpu', partitions='64') "
            "@OnError(action='STREAM') "
            "define stream S (symbol string, price float, volume long); "
            "@info(name='agg') from S#window.lengthBatch(8192) "
            "select symbol, sum(price) as total, count() as n "
            "group by symbol insert into Agg; "
            "@info(name='faults') from !S select symbol, volume, _error "
            "insert into F;")


def transports_phase(torch, SiddhiManager, EventBatch, StreamCallback,
                     kernels, card) -> dict:
    """Phase 29: sources, sinks and fault streams.  The verify skill's
    filter and a tumbling group-by under ``@app:execution('tpu')`` over
    1,000,000 events in publishes of 8,192: in through an in-memory
    source (pass-through, then JSON), out through in-memory sinks to
    broker subscribers, the rows held against the input-handler run on
    the card and at ``device="cpu"``; then an ``@OnError(action='STREAM')`` app
    whose device query fails on some batches (new symbols past its 64
    group rows), its ``!S`` rows held against the CPU run's.  Returns
    the launches of the card runs."""
    from siddhi_tpu_torch.core.event import Event, events_from_batch

    launches = {k: 0 for k in kernels}
    batches = tr_batches(EventBatch)
    t0 = time.perf_counter()
    events = [events_from_batch(b) for b in batches]
    names = ("symbol", "price", "volume")
    json_payloads = [json.dumps([dict(zip(names, (r[0], float(r[1]),
                                                  int(r[2]))))
                                 for r in (e.data for e in evs)])
                     for evs in events]
    setup_s = time.perf_counter() - t0
    runs = {}
    for label, mapper, device, payloads in (
            ("handler", None, "cuda", None),
            ("passThrough", "passThrough", "cuda", events),
            ("json", "json", "cuda", json_payloads),
            ("cpu", None, "cpu", None)):
        runs[label] = run_transport(torch, SiddhiManager, StreamCallback,
                                    batches, payloads, mapper, device,
                                    kernels)
        if device == "cuda":
            for k, v in runs[label]["launches"].items():
                launches[k] += v
    ref = runs["handler"]
    for label, r in runs.items():
        # a JSON source carries no event times: the rows are held, their
        # timestamps are not
        if r["rows"] != ref["rows"] or r["lowering"] != {
                "filter": "device", "agg": "device"}:
            raise AssertionError(f"transports {label}: rows or lowering "
                                 f"differ ({r['lowering']})")
    if ref["launches"]["bank_scatter"] < 1:
        raise AssertionError(f"transports launches {ref['launches']}")
    emit({"phase": "transports", "events": TR_EVENTS, "publish": TR_BATCH,
          "lowering": ref["lowering"],
          "handler_events_per_s": TR_EVENTS / ref["secs"],
          "source_sink_events_per_s": TR_EVENTS / runs["passThrough"]["secs"],
          "json_source_sink_events_per_s": TR_EVENTS / runs["json"]["secs"],
          "cpu_handler_events_per_s": TR_EVENTS / runs["cpu"]["secs"],
          "out_rows": len(ref["rows"]["Out"]),
          "agg_rows": len(ref["rows"]["Agg"]),
          "rows_held": {k: len(v) for k, v in ref["rows"].items()},
          "held_against": ["handler", "passThrough", "json", "cpu"],
          "payload_setup_s": setup_s,
          "accumulate_launches": {k: r["launches"]["bank_scatter"]
                                  for k, r in runs.items()},
          "card": card})
    del events, json_payloads, runs
    gc.collect()
    # the fault stream on the device path
    rng = np.random.default_rng(59)
    err = []
    for i in range(TR_ERR_BATCHES):
        b = batches[i]
        sym = np.asarray(b.columns["symbol"]).copy()
        if i % 8 == 5:
            # 20 symbols the group rows have no room for
            sym[rng.integers(0, len(sym), 20)] = [f"N{i}_{j}"
                                                  for j in range(20)]
        err.append(EventBatch("S", list(b.attribute_names),
                              {**b.columns, "symbol": sym}, b.timestamps))
    outs = {}
    for device in ("cuda", "cpu"):
        mgr = SiddhiManager(device=device)
        rt = new_app(mgr, tr_err_app(device))
        kept = {"Agg": [], "F": []}
        for o in kept:
            rt.add_callback(o, ckpt_keep(StreamCallback, kept[o]))
        rt.start()
        zero_launches(kernels)
        h = rt.get_input_handler("S")
        for b in err:
            h.send_batch(b)
        rt.drain()
        if device == "cuda":
            for k, v in read_launches(kernels).items():
                launches[k] += v
        outs[device] = (kept, rt.lowering())
        rt.shutdown()
        mgr.shutdown()
    (ck, cl), (pk, pl) = outs["cuda"], outs["cpu"]
    fault_rows = [(r[0], r[1], type(r[2]).__name__, str(r[2]))
                  for b in ck["F"] for r in zip(
                      b.columns["symbol"], b.columns["volume"],
                      b.columns["_error"])]
    cpu_fault_rows = [(r[0], r[1], type(r[2]).__name__, str(r[2]))
                      for b in pk["F"] for r in zip(
                          b.columns["symbol"], b.columns["volume"],
                          b.columns["_error"])]
    agg_held = dq_compare(EventBatch.concat(ck["Agg"]),
                          EventBatch.concat(pk["Agg"]), (), True)["rows"]
    failing = sum(1 for i in range(TR_ERR_BATCHES) if i % 8 == 5)
    if (fault_rows != cpu_fault_rows or cl != pl
            or len(fault_rows) < failing * TR_BATCH // 2
            or cl.get("agg") != "device"):
        raise AssertionError(f"transports on-error: {len(fault_rows)} vs "
                             f"{len(cpu_fault_rows)} fault rows, {cl}, {pl}")
    emit({"phase": "transports", "case": "on_error_stream",
          "batches": TR_ERR_BATCHES, "failing_batches": failing,
          "lowering": cl, "fault_rows": len(fault_rows),
          "fault_rows_held_vs_cpu": len(fault_rows),
          "agg_rows_held_vs_cpu": agg_held,
          "errors": sorted({r[2] for r in fault_rows}), "card": card})
    return launches


# -- phase 30: the operations layer -------------------------------------------

OPS_PARTITIONS = N_PARTITIONS
OPS_BATCH = BATCH
# instance lanes a node: the most the dense_batch kernel takes; with the
# traffic below none is dropped (the phase fails on a drop)
OPS_INSTANCES = 32
OPS_BATCHES = 6
# half of each batch on these keys (so a cold 16-state chain completes
# within the phase's batches, and no node holds more than
# OPS_INSTANCES pending instances), half spread over every partition
OPS_HOT_KEYS = 16_384
OPS_FAULTED = 3  # the batch whose step.dense check raises once
OPS_TRACED = 8
# (d)'s traffic sits on these keys, so chains complete from the first
# batch; the card and the CPU run take the same batches (more of them
# would fill a node's lanes on these keys)
OPS_ADMIT_KEYS = 4_096
OPS_ADMIT_BATCHES = 2
OPS_DQ_BATCHES = 8
OPS_DQ_BATCH = 65_536
# the messages an operations case expects on the port's logger
OPS_EXPECTED = ("device state poisoned", "NaN/Inf poison",
                "watchdog tripped", "transient fault at",
                "error processing events on stream")
# launches of the phase's runs on the card add up here
OPS_TALLY: dict = {}


def ops_batches(EventBatch, n=None, seed=83, hot=None):
    """The main path's traffic for the operations phase: ``n`` batches
    (``OPS_BATCHES``) of ``OPS_BATCH``, even rows on ``OPS_HOT_KEYS``
    keys, odd rows stride-walked over every partition, v ~ U(0, 20), one
    timestamp a batch 10 ms apart; with ``hot``, every row on ``hot``
    keys (a chain completes within the first batch)."""
    n = OPS_BATCHES if n is None else n
    batch, partitions = OPS_BATCH, OPS_PARTITIONS
    rng = np.random.default_rng(seed)
    out = []
    idx = np.arange(batch, dtype=np.int64)
    for i in range(n):
        wide = (idx * 524287 + i * batch) % partitions
        keys = (rng.integers(0, hot, batch) if hot else
                np.where(idx % 2 == 0,
                         rng.integers(0, OPS_HOT_KEYS, batch), wide))
        v = rng.uniform(0.0, float(N_STATES + 4), batch)
        out.append(EventBatch("Txn", ["key", "v"], {"key": keys, "v": v},
                              np.full(batch, 1_000 + i * 10,
                                      dtype=np.int64)))
    return out


def ops_app(anns: str, stream_anns: str = "") -> str:
    """The main path (``kernel_eligible_app`` in ``partition with (key of
    Txn)``, ``OPS_PARTITIONS`` partitions) under ``anns``, its stream
    definition under ``stream_anns``."""
    body = partitioned(kernel_eligible_app())
    if stream_anns:
        body = body.replace("define stream Txn", stream_anns
                            + " define stream Txn", 1)
    return ("@app:playback @app:execution('tpu', "
            f"partitions='{OPS_PARTITIONS}', instances='{OPS_INSTANCES}') "
            + anns + " " + body)


class OpsErrors:
    """The ERRORs an operations case expects (a quarantine, a watchdog
    trip, a retried or routed fault) leave ``ISOLATED`` when the case
    ends; any other still fails the phase."""

    def __enter__(self):
        self.before = len(ISOLATED.errors)
        return self

    def __exit__(self, *exc):
        new = ISOLATED.errors[self.before:]
        del ISOLATED.errors[self.before:]
        ISOLATED.errors.extend(m for m in new
                               if not any(p in m for p in OPS_EXPECTED))
        ISOLATED.heard = [e for e in ISOLATED.heard
                          if type(e).__name__ not in (
                              "TransferFaultError", "InjectedFaultError",
                              "SimulatedCrashError")]
        return False


def ops_run(torch, SiddhiManager, StreamCallback, app, device, batches,
            kernels, outs=("Alerts",), between=None, keep_live=False):
    """``app`` over ``batches`` on ``device``: the kept output batches by
    stream, the seconds a batch (synchronised), the launches, and the
    runtime; ``between(i, rt)`` runs before batch ``i`` is sent."""
    zero_launches(kernels)
    mgr = SiddhiManager(device=device)
    rt = mgr.create_siddhi_app_runtime(app)
    kept = {o: [] for o in outs}
    for o in outs:
        rt.add_callback(o, ckpt_keep(StreamCallback, kept[o]))
    rt.start()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    h = rt.get_input_handler(batches[0].stream_id)
    per = []
    for i, b in enumerate(batches):
        if between is not None:
            between(i, rt)
        sync()
        t = time.perf_counter()
        h.send_batch(b)
        rt.drain()
        sync()
        per.append(time.perf_counter() - t)
    run = {"outs": kept, "batch_s": per, "launches": read_launches(kernels),
           "rt": rt, "mgr": mgr, "lowering": rt.lowering(step_kinds=True),
           "overflow": ops_overflow(rt)}
    if run["overflow"]:
        raise AssertionError(f"operations: {run['overflow']} pending "
                             "instance(s) dropped on the main path")
    if device == "cuda":
        for k, n in run["launches"].items():
            OPS_TALLY[k] = OPS_TALLY.get(k, 0) + n
    if not keep_live:
        ops_close(run)
    return run


def ops_overflow(rt):
    """The main path's dropped instances (``overflow_total``), None for
    another app."""
    pr = rt.partitions.get("partition_0")
    dense = pr.dense_query_runtimes.get("bench") if pr is not None else None
    return None if dense is None else \
        dense.pattern_processor.overflow_total()


def ops_close(run):
    """Shut the run's app down and drop it, so its device state is freed
    before the next run (a re-plan's peak memory reads two engine sets,
    not a finished run's too)."""
    run.pop("rt").shutdown()
    run.pop("mgr").shutdown()
    gc.collect()


def ops_same_state(torch, rt_a, rt_b) -> bool:
    """The main path's dense state equal key by key in two runs (a key
    interned in one run only must still hold the initial row: a batch
    whose step faulted interned its keys and stepped nothing)."""
    def parts(rt):
        pr = rt.partitions["partition_0"]
        dense = pr.dense_query_runtimes["bench"].pattern_processor
        return dense.state, dict(dense._key_rows), dense.engine

    (sa, ka, eng), (sb, kb, _) = parts(rt_a), parts(rt_b)
    init = eng.init_state()
    common = [key for key in ka if key in kb]
    for k, ta in sa.items():
        tb = sb[k]
        if ta.dim() == 0 or ta.shape[0] != init[k].shape[0] \
                or ta.shape[0] < eng.n_partitions:
            if not torch.equal(ta, tb):
                return False
            continue
        if not torch.equal(ta[[ka[x] for x in common]],
                           tb[[kb[x] for x in common]]):
            return False
        for t, rows, other in ((ta, ka, kb), (tb, kb, ka)):
            only = [rows[x] for x in rows if x not in other]
            if only and not torch.equal(t[only], init[k][only]):
                return False
    return True


def ops_rows(EventBatch, kept) -> list:
    """Every kept output row as (ts, values), in order."""
    out = []
    for b in kept:
        cols = [np.asarray(b.columns[a]) for a in b.attribute_names]
        out.extend(zip(b.timestamps.tolist(),
                       *[c.tolist() for c in cols]))
    return out


def ops_transient_case(torch, SiddhiManager, EventBatch, StreamCallback,
                       kernels, card, batches, clean_all) -> dict:
    """(a) transient faults on the main path."""
    faults = ("@app:faults(seed='7', transfer.retry.scale='0.0001', "
              "emit.drain='transient:p=0.25:count=100000', "
              "ingest.put='transient:p=0.25:count=100000', "
              f"step.dense='transient:count=1:after={OPS_FAULTED}')")
    with OpsErrors():
        chaos = ops_run(torch, SiddhiManager, StreamCallback,
                        ops_app(faults, stream_anns="@OnError(action='STREAM')"),
                        "cuda", batches, kernels, outs=("Alerts", "!Txn"),
                        keep_live=True)
    skip = batches[:OPS_FAULTED] + batches[OPS_FAULTED + 1:]
    clean = ops_run(torch, SiddhiManager, StreamCallback, ops_app(""),
                    "cuda", skip, kernels, keep_live=True)
    same_state = ops_same_state(torch, chaos["rt"], clean["rt"])
    rows = ops_rows(EventBatch, chaos["outs"]["Alerts"])
    fst = chaos["rt"].app_context.fault_injector.stats
    faulted = sum(len(b) for b in chaos["outs"]["!Txn"])
    ops_close(chaos)
    ops_close(clean)
    if (rows != ops_rows(EventBatch, clean["outs"]["Alerts"]) or not rows
            or not same_state or faulted != len(batches[OPS_FAULTED])
            or fst.drains_failed or not fst.transfer_retries
            or chaos["launches"]["dense_batch"] != len(batches) - 1):
        raise AssertionError(
            f"operations (a): rows {len(rows)} state {same_state} "
            f"faulted {faulted} {fst.as_dict()} {chaos['launches']}")
    keep = [i for i in range(len(batches)) if i != OPS_FAULTED]
    chaos_ms = [chaos["batch_s"][i] * 1e3 for i in keep]
    return {"phase": "operations", "case": "a_transient_faults",
            "partitions": OPS_PARTITIONS, "batch": OPS_BATCH,
            "batches": len(batches), "faulted_batch": OPS_FAULTED,
            "rows": len(rows), "rows_equal_fault_free_card_run": True,
            "final_state_equal": same_state,
            "fault_stream_rows": faulted,
            "faults_injected": fst.faults_injected,
            "transfer_retries": fst.transfer_retries,
            "drains_recovered": fst.drains_recovered,
            "drains_failed": fst.drains_failed,
            "ms_a_batch_faulted": sum(chaos_ms) / len(chaos_ms),
            "ms_a_batch_clean": 1e3 * sum(clean["batch_s"])
            / len(clean["batch_s"]),
            "dense_batch_launches": chaos["launches"]["dense_batch"],
            "dropped_instances": {"faulted": chaos["overflow"],
                                  "clean": clean["overflow"]},
            "card": card}


OPS_DQ_APP = ("@app:playback @app:execution('tpu', partitions='1024') {faults}"
              "define stream S (k long, v double); "
              "@info(name='q') from S#window.lengthBatch(8192) "
              "select k, sum(v) as s, count() as c group by k "
              "insert into Out;")


def ops_dq_batches(EventBatch, n=None):
    """``n`` (``OPS_DQ_BATCHES``) batches of ``OPS_DQ_BATCH`` events over
    1,024 keys for the device query path."""
    n, batch = OPS_DQ_BATCHES if n is None else n, OPS_DQ_BATCH
    rng = np.random.default_rng(89)
    return [EventBatch("S", ["k", "v"],
                       {"k": rng.integers(0, 1024, batch),
                        "v": np.round(rng.uniform(0, 10, batch), 1)},
                       np.full(batch, 5_000 + 10 * i, dtype=np.int64))
            for i in range(n)]


def ops_poison_case(torch, SiddhiManager, EventBatch, StreamCallback,
                    kernels, card) -> list:
    """(b) the NaN/Inf quarantine on the device query path (kernel 3)
    and on the skew-routed path (kernel 4), each against the CPU run
    with the same fault; the guard's ms a batch, armed and never
    tripping, beside the unarmed run."""
    lines = []
    # the group-by's float32 sums within the reference's bound, the
    # router's captured values bit for bit
    cases = (
        ("device_query", OPS_DQ_APP, ops_dq_batches(EventBatch), ("Out",),
         "bank_scatter", ("s",)),
        ("hotkey", hot_key_app(True).replace("@app:playback",
                                             "@app:playback {faults}"),
         hot_key_batches(EventBatch), ("Alerts",), "scan_chain", ()))
    for label, app, batches, outs, kernel, sums in cases:
        trip = "@app:faults(state.poison='poison:count=1:after=2') "
        armed = "@app:faults(state.poison='poison:count=0') "
        runs = {}
        with OpsErrors():
            for key, device, faults in (("card", "cuda", trip),
                                        ("cpu", "cpu", trip),
                                        ("armed", "cuda", armed),
                                        ("unarmed", "cuda", "")):
                r = ops_run(torch, SiddhiManager, StreamCallback,
                            app.format(faults=faults), device, batches,
                            kernels, outs=outs, keep_live=True)
                fi = r["rt"].app_context.fault_injector
                r["quarantines"] = (fi.stats.poison_quarantines
                                    if fi is not None else 0)
                ops_close(r)
                runs[key] = r
        held = dq_compare(
            EventBatch.concat(runs["card"]["outs"][outs[0]]),
            EventBatch.concat(runs["cpu"]["outs"][outs[0]]), sums,
            not sums)
        if (not held["rows"] or runs["card"]["quarantines"] != 1
                or runs["cpu"]["quarantines"] != 1
                or not runs["card"]["launches"][kernel]):
            raise AssertionError(
                f"operations (b) {label}: {held} rows, quarantines "
                f"{runs['card']['quarantines']}/{runs['cpu']['quarantines']}"
                f", launches {runs['card']['launches']}")
        ms = {k: 1e3 * sum(runs[k]["batch_s"][1:]) / (len(batches) - 1)
              for k in ("armed", "unarmed")}
        lines.append({
            "phase": "operations", "case": f"b_poison_{label}",
            "lowering": runs["card"]["lowering"],
            "batches": len(batches), "batch": len(batches[0]),
            "poison_quarantines": runs["card"]["quarantines"],
            "rows_held_vs_cpu": held["rows"],
            "sum_max_abs_err": held["max_abs_err"],
            "kernel": kernel,
            "kernel_launches": runs["card"]["launches"][kernel],
            "guard_ms_a_batch": ms["armed"] - ms["unarmed"],
            "armed_ms_a_batch": ms["armed"],
            "unarmed_ms_a_batch": ms["unarmed"], "card": card})
    return lines


OPS_WD_APP = ("@app:name('opswd{tag}') @app:execution('tpu') {faults} "
              "@app:limits(watchdog='200 ms') "
              "@async(buffer.size='64', batch.size.max='16') "
              "define stream S (k long, v double); "
              "@info(name='q') from S[v > 0.0] select k, v insert into Out;")


# (c)'s ladder runs fusion (b)'s device-tail chain: the port's ladder
# has one rung, fuse (its dense engines stay on their kernel)
OPS_LADDER_BATCHES = 6
OPS_LADDER_ANNS = ("@app:fuse @app:faults(journal='64') "
                   "@app:limits(watchdog='60 sec', ladder='true') ")


def ops_ladder_case(torch, SiddhiManager, EventBatch, StreamCallback,
                    kernels, card, batches, clean_all) -> list:
    """(c) the degradation ladder's ``fuse`` rung on fusion (b)'s fused
    chain at B = 131,072, down one rung and back up against the
    undisturbed fused run; a forced re-plan of the main path at
    ``OPS_PARTITIONS`` partitions (two engine sets for a moment) against
    the clean run; the watchdog's self-heal of a wedged device-query
    app."""
    fb = fuse_batches(EventBatch, [TAIL_BATCH] * OPS_LADDER_BATCHES,
                      high=50.0, seed=47)
    fused = {"q1": "fused", "q2": "fused", "q3": "fused"}
    unfused = {"q1": "device", "q2": "device", "q3": "device"}
    marks = {}

    def rung(i, rt):
        if i in (2, 4):
            hops = hop_dispatches(rt)
            torch.cuda.synchronize()
            t = time.perf_counter()
            pressure = 1.0 if i == 2 else 0.0
            for _ in range(3 if i == 2 else 6):
                rt._ladder.observe(pressure)
            torch.cuda.synchronize()
            marks[i] = {"replan_s": time.perf_counter() - t,
                        "lowering": rt.lowering(), "hops_before": hops}

    still = ops_run(torch, SiddhiManager, StreamCallback,
                    TAIL_APP.format(tag="lu", fuse="@app:fuse ", mid=""),
                    "cuda", fb, kernels, outs=("Out",), keep_live=True)
    ops_close(still)
    ladder = ops_run(torch, SiddhiManager, StreamCallback,
                     TAIL_APP.format(tag="ld", fuse=OPS_LADDER_ANNS, mid=""),
                     "cuda", fb, kernels, outs=("Out",), between=rung,
                     keep_live=True)
    rb = ladder["rt"].app_context.robustness
    hops_after = hop_dispatches(ladder["rt"])
    ops_close(ladder)
    held = held_concat(EventBatch, ladder, still, ("total",))
    # while demoted (batches 2-3, and the replay of 0-1) the junctions
    # carried every hop; after the promotion the fused chain did
    demoted_hops = marks[4]["hops_before"]
    if (not held["rows"] or still["lowering"] != fused
            or (rb.ladder_demotions, rb.ladder_promotions) != (1, 1)
            or marks[2]["lowering"] != unfused
            or marks[4]["lowering"] != fused
            or not demoted_hops["Mid"] or not demoted_hops["Win"]
            or hops_after["Mid"] or hops_after["Win"]):
        raise AssertionError(f"operations (c) ladder: {held}, "
                             f"{rb.as_dict()}, {marks}, {hops_after}")
    lines = [{"phase": "operations", "case": "c_ladder",
              "app": "fusion (b)'s device-tail chain",
              "batch": TAIL_BATCH, "batches": len(fb),
              "rows_vs_undisturbed_fused_run": held,
              "demote": marks[2], "promote": marks[4],
              "hop_dispatches_while_demoted": demoted_hops,
              "hop_dispatches_after_promotion": hops_after,
              "launches": ladder["launches"],
              "ladder_demotions": rb.ladder_demotions,
              "ladder_promotions": rb.ladder_promotions,
              "watchdog": "60 sec (its own ticks never move the ladder "
                          "in this case)",
              "card": card}]

    replan = {}

    def forced(i, rt):
        if i == 3:
            replan["launches_before"] = read_launches(kernels)["dense_batch"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            replan["lowering"] = rt.replan({}, forced=True,
                                           reason="operations (c)")
            torch.cuda.synchronize()
            replan.update(
                replan_s=time.perf_counter() - t,
                peak_bytes=torch.cuda.max_memory_allocated(),
                launches_after=read_launches(kernels)["dense_batch"])

    main = ops_run(torch, SiddhiManager, StreamCallback,
                   ops_app("@app:faults(journal='64')"), "cuda", batches,
                   kernels, between=forced, keep_live=True)
    rows = ops_rows(EventBatch, main["outs"]["Alerts"])
    ref = ops_rows(EventBatch, clean_all["outs"]["Alerts"])
    ops_close(main)
    # the replay of batches 0-2 launched the kernel again, and so did
    # the batches after it
    if (rows != ref or not rows or replan["lowering"] != {"bench": "dense"}
            or replan["launches_after"] <= replan["launches_before"]
            or main["launches"]["dense_batch"] <= replan["launches_after"]):
        raise AssertionError(f"operations (c) replan: rows {len(rows)} vs "
                             f"{len(ref)}, {replan}, {main['launches']}")
    lines.append({"phase": "operations", "case": "c_replan",
                  "partitions": OPS_PARTITIONS, "batch": OPS_BATCH,
                  "instances": OPS_INSTANCES, "rows": len(rows),
                  "rows_equal_clean_run": True, "replan_s":
                  replan["replan_s"], "peak_bytes": replan["peak_bytes"],
                  "lowering": replan["lowering"],
                  "dense_batch_launches": main["launches"]["dense_batch"],
                  "dropped_instances": main["overflow"], "card": card})

    class Wedge:
        def receive(self, batch):
            from siddhi_tpu_torch.core.exceptions import SimulatedCrashError

            raise SimulatedCrashError("wedged worker")

    mgr = SiddhiManager(device="cuda")
    got = []
    with OpsErrors():
        rt = mgr.create_siddhi_app_runtime(OPS_WD_APP.format(
            tag="h", faults="@app:faults(journal='8192')"))
        rt.add_callback("Out", lambda evs: got.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        rt.start()
        rt.junctions["S"].subscribe(Wedge())
        h = rt.get_input_handler("S")
        for i in range(1, 6):
            h.send([i, float(i)], timestamp=1000 + i)
        time.sleep(0.05)
        t_wedge = time.perf_counter()
        for i in range(6, 11):
            h.send([i, float(i)], timestamp=1000 + i)
        rb = rt.app_context.robustness
        deadline = time.time() + 15
        while rb.watchdog_recoveries == 0 and time.time() < deadline:
            time.sleep(0.01)
        heal_s = time.perf_counter() - t_wedge
        for i in range(11, 16):
            h.send([i, float(i)], timestamp=1000 + i)
        rt.drain()
        health = rt.health()
        low = rt.lowering()
        rt.shutdown()
        mgr.shutdown()
    want = [(1000 + i, (i, float(i))) for i in range(1, 16)]
    if (sorted(got) != want or rb.watchdog_recoveries != 1
            or health["wedged"] or low != {"q": "device"}):
        raise AssertionError(f"operations (c) watchdog: {sorted(got)} "
                             f"{rb.as_dict()} {low}")
    lines.append({"phase": "operations", "case": "c_watchdog",
                  "lowering": low, "rows": len(got),
                  "rows_equal_all_sends": True,
                  "watchdog_trips": rb.watchdog_trips,
                  "watchdog_recoveries": rb.watchdog_recoveries,
                  "heal_s_from_wedge": heal_s, "deadline_ms": 200,
                  "card": card})
    return lines


def ops_admission_case(torch, SiddhiManager, EventBatch, StreamCallback,
                       kernels, card) -> tuple:
    """(d) admission on the main path, shedding about half, with the
    statistics feed and transient faults armed: the rows, ``events_shed``
    and the feed's fault and robustness counters over
    ``OPS_ADMIT_BATCHES`` batches against the CPU run's.  The traffic
    sits on ``OPS_ADMIT_KEYS`` keys, so chains complete from the first
    batch."""
    batches = ops_batches(EventBatch, n=OPS_ADMIT_BATCHES, seed=91,
                          hot=OPS_ADMIT_KEYS)
    half = len(batches[0]) // 2
    anns = ("@app:statistics('true') "
            "@app:faults(seed='11', transfer.retry.scale='0.0001', "
            "emit.drain='transient:p=0.5:count=100000', "
            "ingest.put='transient:p=0.5:count=100000') "
            f"@app:limits(rate='{half * 100}/s', burst='{half}', "
            "shed='drop')")

    def counters(rt):
        return {k.split(".Siddhi.", 1)[1]: v
                for k, v in rt.statistics().items()
                if ".Faults." in k or ".Robustness." in k}

    runs = {}
    with OpsErrors():
        for device in ("cuda", "cpu"):
            r = ops_run(torch, SiddhiManager, StreamCallback, ops_app(anns),
                        device, batches, kernels, keep_live=True)
            r["counters"] = counters(r["rt"])
            r["shed"] = r["rt"].app_context.robustness.events_shed
            r["admitted"] = r["rt"].app_context.robustness.events_admitted
            r["rows"] = ops_rows(EventBatch, r["outs"]["Alerts"])
            ops_close(r)
            runs[device] = r
    card_run, cpu = runs["cuda"], runs["cpu"]
    key = "Robustness.overload.events_shed"
    if (card_run["rows"] != cpu["rows"] or not card_run["rows"]
            or card_run["counters"] != cpu["counters"]
            or cpu["counters"][key] != len(batches) * half
            or not cpu["counters"]["Faults.injector.faults_injected"]
            or card_run["shed"] != cpu["shed"]):
        raise AssertionError(
            f"operations (d): rows {len(card_run['rows'])} vs "
            f"{len(cpu['rows'])}, {card_run['counters']} vs "
            f"{cpu['counters']}")
    line = {"phase": "operations", "case": "d_admission",
            "rate_per_s": half * 100, "burst": half, "shed": "drop",
            "batches": len(batches), "keys": OPS_ADMIT_KEYS,
            "events_shed": card_run["shed"],
            "events_admitted": card_run["admitted"],
            "rows": len(card_run["rows"]), "rows_equal_cpu_run": True,
            "events_shed_equal_cpu_run": True,
            "admitted_ms_a_batch": 1e3 * sum(card_run["batch_s"])
            / len(batches),
            "dropped_instances": {"card": card_run["overflow"],
                                  "cpu": cpu["overflow"]}, "card": card}
    return line, card_run["counters"]


def ops_stats_case(torch, SiddhiManager, EventBatch, StreamCallback,
                   kernels, card, feed_counters) -> dict:
    """(e) the main path with the statistics feed and the tracer on and
    off, a fully sampled run's spans by stage, and ``/metrics`` from the
    service on localhost."""
    import urllib.request

    from siddhi_tpu_torch.service import SiddhiService

    batches = ops_batches(EventBatch, n=OPS_TRACED, seed=97)
    rates, dropped = {}, {}
    for label, anns in (("on", "@app:statistics('true') "
                               "@app:trace(sample='1/64')"),
                        ("off", "")):
        r = ops_run(torch, SiddhiManager, StreamCallback, ops_app(anns),
                    "cuda", batches, kernels)
        rates[label] = len(batches) * len(batches[0]) / sum(r["batch_s"])
        dropped[label] = r["overflow"]
    traced = ops_run(torch, SiddhiManager, StreamCallback,
                     ops_app("@app:trace(sample='1')"), "cuda", batches[:4],
                     kernels, keep_live=True)
    spans = {s: m["spans"] for s, m in
             traced["rt"].app_context.tracer.stage_stats().items()}
    ops_close(traced)
    # a batch without a match has no emit span
    if (spans.get("ingest") != 4 or spans.get("step") != 4
            or not spans.get("emit")):
        raise AssertionError(f"operations (e): spans {spans}")
    svc = SiddhiService(manager=SiddhiManager(device="cuda"))
    svc.start()
    try:
        code, _ = svc.deploy(OPS_DQ_APP.format(faults="@app:name('opsm') "
                                               "@app:statistics "))
        svc.get_runtime("opsm").get_input_handler("S").send_batch(
            ops_dq_batches(EventBatch, n=1)[0])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{svc.port}/metrics") as resp:
            status, page = resp.status, resp.read().decode()
    finally:
        svc.stop()
        svc.manager.shutdown()
    if code != 200 or status != 200 or 'app="opsm"' not in page:
        raise AssertionError(f"operations (e): /metrics {code} {status}")
    return {"phase": "operations", "case": "e_statistics_tracing",
            "batches": len(batches), "batch": len(batches[0]),
            "events_per_s_statistics_and_trace_1_64": rates["on"],
            "events_per_s_plain": rates["off"],
            "spans_by_stage_sample_1_over_4_batches": spans,
            "spans_at_1_64_over_8_batches": "none sampled (cycles 64, "
                                             "128, ...)",
            # the equal counters that moved (the rest are 0 in both)
            "feed_counters_equal_cpu_run": {k: v for k, v in
                                            feed_counters.items() if v},
            "metrics_status": status,
            "metrics_lines": len(page.splitlines()),
            "dropped_instances": dropped, "card": card}


def operations_phase(torch, SiddhiManager, EventBatch, StreamCallback,
                     kernels, card) -> dict:
    """Phase 30: the operations layer on the card, (a)-(e); returns the
    launches of its card runs."""
    OPS_TALLY.clear()
    OPS_TALLY.update(dict.fromkeys(kernels, 0))
    t_phase = time.perf_counter()
    batches = ops_batches(EventBatch)
    clean_all = ops_run(torch, SiddhiManager, StreamCallback, ops_app(""),
                        "cuda", batches, kernels, keep_live=True)
    ops_close(clean_all)
    lines = [ops_transient_case(torch, SiddhiManager, EventBatch,
                                StreamCallback, kernels, card, batches,
                                clean_all)]
    lines += ops_poison_case(torch, SiddhiManager, EventBatch,
                             StreamCallback, kernels, card)
    lines += ops_ladder_case(torch, SiddhiManager, EventBatch,
                             StreamCallback, kernels, card, batches,
                             clean_all)
    line_d, feed = ops_admission_case(torch, SiddhiManager, EventBatch,
                                      StreamCallback, kernels, card)
    lines.append(line_d)
    lines.append(ops_stats_case(torch, SiddhiManager, EventBatch,
                                StreamCallback, kernels, card, feed))
    for line in lines:
        emit(line)
    emit({"phase": "operations_seconds",
          "seconds": time.perf_counter() - t_phase,
          "launches": dict(OPS_TALLY), "card": card})
    return dict(OPS_TALLY)


# -- phase 31: multi-device (the mesh) --------------------------------------

# BASELINE config 5 (samples/performance/baseline_configs.py:106-119, the
# 10,000,000-device variant it names): the 32-state escalation chain in
# partition with (dev of D), v ~ U(0, 40) float32, devices uniform
SH_PARTITIONS = 10_000_000
SH_BATCH = 1 << 17
SH_WARMUP = 2
SH_STEPS = 10
SH_SEED = 101
# rows of key numbers seeded a chunk (a multiple of every shard count)
SH_CHUNK = 1 << 20
# lanes of each node the mid-chain seed may fill (of the app's 4)
SH_SEED_LANES = 1
# (c2) the capture-free chain at devices='4' against the unsharded run
SH_BATCH_PARTITIONS = 1_000_000
SH_BATCH_WARMUP = 2
SH_BATCH_STEPS = 6
# (c) the CPU twin: (b) at 65,536 partitions, two batches of 8,192 (the
# CPU's general step over 32 nodes takes seconds a collision round)
SH_CPU_PARTITIONS = 65_536
SH_CPU_BATCH = 8_192
SH_CPU_BATCHES = 2
# (d) sharded device queries: the first batches of each cell's traffic;
# kind -> (device_queries label or app, symbols, float32 sum columns)
SH_DQ_DEVICES = 4
SH_DQ_BATCHES = 16
SH_DQ_APPS = {
    # running: device_queries' partition_scaling_50000
    "running": ("partition_scaling_50000", 50_000, ()),
    # keyed_sliding: device_queries' keyed_time_avg_50000
    "keyed_sliding": ("keyed_time_avg_50000", 50_000, ("ap",)),
    # tumbling: a lengthBatch group-by over the cse shape's 50 symbols
    "tumbling": (DQ_TPU + CSE_DEFINE + "@info(name='q0') from "
                 "cseEventStream#window.lengthBatch(8192) select symbol, "
                 "sum(price) as total, count() as c group by symbol insert "
                 "into outputStream;", 50, ("total",)),
    # sliding: device_queries' sliding_window (the global ring)
    "sliding": ("sliding_window", 50, ("total", "avgVolume")),
}
# the device the phase runs its card runs on (a CPU rehearsal at small
# sizes sets "cpu" from a script that imports this file)
SH_CARD = "cuda"
# (e) the faulted batch of the step.shard case
SH_FAULTED = 1
SH_FAULT_BATCHES = 3
SH_MON_SENDS = 120
SH_MON_SWITCH = 60


def batch_chain_app(partitions, devices=None):
    """``kernel_eligible_app``'s capture-free chain over D in ``partition
    with (dev of D)`` (``devices='N'``: sharded over N)."""
    dev = f", devices='{devices}'" if devices else ""
    body = (kernel_eligible_app().split("; ", 1)[1]
            .replace("=Txn[", "=D[").replace("name='bench'", "name='q'"))
    return (f"@app:playback @app:execution('tpu', partitions='{partitions}'"
            f"{dev}) define stream D (dev long, v double); partition with "
            f"(dev of D) begin {body} end;")


def config5_app(partitions, devices=None, anns="", stream_anns=""):
    """BASELINE config 5's chain in ``partition with (dev of D)`` at
    ``partitions`` (``devices='N'``: sharded over N)."""
    states = ["every e1=D[v > 0.0]"] + [
        f"e{i}=D[v > {float(i - 1)} and v > e1.v]" for i in range(2, 33)]
    dev = f", devices='{devices}'" if devices else ""
    return (f"@app:playback @app:execution('tpu', partitions='{partitions}'"
            f"{dev}) {anns} {stream_anns} define stream D (dev long, "
            "v double); partition with (dev of D) begin @info(name='q') "
            "from " + " -> ".join(states) + " within 10 min select e1.v as "
            "v1, e32.v as v32 insert into Alerts; end;")


def sh_batches(EventBatch, n, partitions, batch, seed=SH_SEED):
    """``n`` batches of ``batch`` events: devices uniform on
    ``[0, partitions)``, v ~ U(0, 40) float32 (in the DOUBLE column), one
    timestamp a batch 10 ms apart."""
    rng = np.random.default_rng(seed)
    return [EventBatch(
        "D", ["dev", "v"],
        {"dev": rng.integers(0, partitions, batch),
         "v": rng.uniform(0.0, 40.0, batch).astype(np.float32)
         .astype(np.float64)},
        np.full(batch, 1_000 + 10 * i, dtype=np.int64)) for i in range(n)]


def sh_dense(rt):
    return rt.partitions["partition_0"].dense_query_runtimes["q"] \
        .pattern_processor


def sh_seed(torch, dense, batches, gen_device, seed=SH_SEED):
    """Pre-intern every key of ``batches`` (so key number k is the same
    key in every run) and seed a mid-chain state by key number on the
    card: per (row, node) the first SH_SEED_LANES lanes active with
    p = 0.3 (the free lanes take what the batches advance, so no
    instance is dropped), its anchor within the last 10 min, its
    register e1.v ~ U(0, 20); chunk by chunk of
    ``SH_CHUNK`` key numbers from a ``torch.Generator`` on
    ``gen_device``, so every layout holds the same values a key: key
    number k on row k, or on a sharded runtime's shard k % n at local
    row k // n (the runtime's round-robin deal)."""
    dense.intern_keys(np.concatenate([b.columns["dev"] for b in batches]))
    eng = dense.engine
    P, S, I = eng.n_partitions, eng.S, eng.I
    R = max(eng.alloc.n, 1)
    n = dense.n_shards if dense._sharded is not None else 1
    for c, k0 in enumerate(range(0, P, SH_CHUNK)):
        m = min(SH_CHUNK, P - k0)
        g = torch.Generator(device=gen_device).manual_seed(seed * 1009 + c)
        active = torch.rand((m, S, I), generator=g, device=gen_device) < 0.3
        active[:, :, SH_SEED_LANES:] = False
        first = torch.randint(1, WITHIN_MS + 1, (m, S, I), generator=g,
                              device=gen_device, dtype=torch.int32)
        vals = {"active": active,
                "first_ts": torch.where(active, first, 0).to(torch.int32),
                "regs": torch.rand((m, S, I, R), generator=g,
                                   device=gen_device) * 20.0}
        if dense._sharded is None:
            for key, v in vals.items():
                dense.state[key][k0:k0 + m] = v.to(dense.state[key].device)
            continue
        for s in range(n):
            sh = dense.state.shards[s]
            for key, v in vals.items():
                sh[key][k0 // n:(k0 + m) // n] = v[s::n].to(sh[key].device)
    eng.base_ts = int(batches[0].timestamps[0]) - WITHIN_MS


def sh_same_state(torch, kept, dense) -> bool:
    """``dense``'s whole state against ``kept`` (a devices='1' run's one
    shard, the reference's [P + 1] rows), bit for bit, by key number:
    shard s of n holds key numbers s, s + n, ... then its scratch row."""
    P = dense.engine.n_partitions
    if dense._sharded is None:
        shards, n = [dense.state], 1
    else:
        shards, n = dense.state.shards, dense.n_shards
    for key, ref in kept.items():
        for s, sh in enumerate(shards):
            a, b = sh[key], ref
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not (torch.equal(a[:-1], b[:P][s::n])
                    and torch.equal(a[-1:], b[P:])):
                return False
    return True


def sh_run(torch, SiddhiManager, StreamCallback, app, batches, device,
           kernels, seed_batches=None, outs=("Alerts",), keep_live=False,
           gen_device=None):
    """``app`` over ``batches`` with a seeded mid-chain state (drawn on
    ``gen_device``, the run's device by default): the kept output
    batches, the synchronised seconds a batch, the launches (set to 0
    before the app is created) and the runtime."""
    zero_launches(kernels)
    mgr = SiddhiManager(device=device)
    rt = new_app(mgr, app)
    kept = {o: [] for o in outs}
    for o in outs:
        rt.add_callback(o, ckpt_keep(StreamCallback, kept[o]))
    rt.start()
    dense = sh_dense(rt)
    t = time.perf_counter()
    sh_seed(torch, dense, seed_batches or batches, gen_device or device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    seed_s = time.perf_counter() - t
    h = rt.get_input_handler("D")
    per = []
    for b in batches:
        sync()
        t = time.perf_counter()
        h.send_batch(b)
        rt.drain()
        sync()
        per.append(time.perf_counter() - t)
    run = {"outs": kept, "batch_s": per, "seed_s": seed_s,
           "launches": read_launches(kernels), "rt": rt, "mgr": mgr,
           "dense": dense, "stats": dense.stats(),
           "lowering": rt.lowering(step_kinds=True)}
    if run["stats"]["dropped_instances"]:
        raise AssertionError(
            f"sharded: {run['stats']['dropped_instances']} instances "
            "dropped at the lane capacity; the match set is not the "
            "pattern's")
    if not keep_live:
        sh_close(run)
    return run


def sh_close(run):
    run.pop("dense", None)
    run.pop("rt").shutdown()
    run.pop("mgr").shutdown()
    gc.collect()


def sh_rows(EventBatch, kept) -> int:
    """Two runs' kept Alerts bit for bit; returns the rows."""
    a, b = kept
    if len(a) != len(b):
        raise AssertionError(f"sharded: {len(a)} output batches against "
                             f"{len(b)}")
    return sum(dq_compare(x, y, (), True)["rows"] for x, y in zip(a, b))


def sh_line(case, run, batch, warmup, card, **extra):
    steady = run["batch_s"][warmup:]
    return {"phase": "sharded", "case": case, "batch": batch,
            "warmup_batches": warmup, "timed_batches": len(steady),
            "events_per_s": batch * len(steady) / sum(steady),
            "ms_a_batch": 1e3 * sum(steady) / len(steady),
            "batch_ms": [1e3 * x for x in run["batch_s"]],
            "seed_s": run["seed_s"], "lowering": run["lowering"],
            "shards_per_card": run["stats"].get("shards_per_card"),
            "partitions_in_use": run["stats"]["partitions_in_use"],
            # instances dropped at the lane capacity (sh_run fails on one)
            "dropped_instances": run["stats"]["dropped_instances"],
            "launches": run["launches"], **extra, "card": card}


def sh_config5(torch, SiddhiManager, EventBatch, StreamCallback, kernels,
               card, tally) -> list:
    """(a) and (b): config 5 at SH_PARTITIONS on the card at devices='1'
    and '4', each held, matches and whole state, against the same app
    without devices=."""
    batches = sh_batches(EventBatch, SH_WARMUP + SH_STEPS, SH_PARTITIONS,
                         SH_BATCH)
    lines = []

    def bytes_of(dense):
        shards = (dense.state.shards if dense._sharded is not None
                  else [dense.state])
        return sum(t.numel() * t.element_size() for sh in shards
                   for t in sh.values())

    card_mem = SH_CARD == "cuda"
    if card_mem:
        torch.cuda.reset_peak_memory_stats()
    one = sh_run(torch, SiddhiManager, StreamCallback,
                 config5_app(SH_PARTITIONS, 1), batches, SH_CARD, kernels,
                 keep_live=True)
    state_1 = bytes_of(one["dense"])
    kept = dict(one["dense"].state.shards[0])
    one_outs = one["outs"]["Alerts"]
    sh_close(one)
    ref = sh_run(torch, SiddhiManager, StreamCallback,
                 config5_app(SH_PARTITIONS), batches, SH_CARD, kernels,
                 keep_live=True)
    held_a = sh_rows(EventBatch, (one_outs, ref["outs"]["Alerts"]))
    same_a = sh_same_state(torch, kept, ref["dense"])
    state_ref = bytes_of(ref["dense"])
    ref_stats = ref["stats"]
    sh_close(ref)
    peak_a = torch.cuda.max_memory_allocated() if card_mem else None
    for k, v in one["launches"].items():
        tally[k] += v
    if not same_a or not held_a:
        raise AssertionError(f"sharded (a): state {same_a}, rows {held_a}")
    lines.append(sh_line(
        "a_config5_devices_1", one, SH_BATCH, SH_WARMUP, card,
        partitions=SH_PARTITIONS, devices=1, state_bytes=state_1,
        unsharded_state_bytes=state_ref, rows=held_a,
        rows_equal_unsharded=True, state_equal_unsharded=True,
        unsharded_events_per_s=SH_BATCH * SH_STEPS
        / sum(ref["batch_s"][SH_WARMUP:]),
        unsharded_ms_a_batch=1e3 * sum(ref["batch_s"][SH_WARMUP:])
        / SH_STEPS, unsharded_lowering=ref["lowering"],
        unsharded_launches=ref["launches"],
        unsharded_partitions_in_use=ref_stats["partitions_in_use"],
        peak_card_bytes=peak_a))
    del ref
    gc.collect()
    if card_mem:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    four = sh_run(torch, SiddhiManager, StreamCallback,
                  config5_app(SH_PARTITIONS, 4), batches, SH_CARD, kernels,
                  keep_live=True)
    held_b = sh_rows(EventBatch, (four["outs"]["Alerts"], one_outs))
    same_b = sh_same_state(torch, kept, four["dense"])
    state_4 = bytes_of(four["dense"])
    sh_close(four)
    for k, v in four["launches"].items():
        tally[k] += v
    if not same_b or held_b != held_a:
        raise AssertionError(f"sharded (b): state {same_b}, rows {held_b}")
    lines.append(sh_line(
        "b_config5_devices_4", four, SH_BATCH, SH_WARMUP, card,
        partitions=SH_PARTITIONS, devices=4, state_bytes=state_4,
        rows=held_b, rows_equal_devices_1=True, state_equal_devices_1=True,
        peak_card_bytes=(torch.cuda.max_memory_allocated() if card_mem
                         else None)))
    del kept, one_outs
    gc.collect()
    if card_mem:
        torch.cuda.empty_cache()
    return lines


def sh_cpu_twin(torch, SiddhiManager, EventBatch, StreamCallback, kernels,
                card, tally) -> dict:
    """(c): (b) at SH_CPU_PARTITIONS over SH_CPU_BATCHES, on the card and
    on the CPU: matches and the state's global rows bit for bit."""
    batches = sh_batches(EventBatch, SH_CPU_BATCHES, SH_CPU_PARTITIONS,
                         SH_CPU_BATCH, seed=SH_SEED + 1)
    app = config5_app(SH_CPU_PARTITIONS, 4)
    runs = {}
    for device in (SH_CARD, "cpu"):
        # one seeded state for both: drawn on the CPU
        run = sh_run(torch, SiddhiManager, StreamCallback, app, batches,
                     device, kernels, keep_live=True, gen_device="cpu")
        run["final"] = run["dense"].snapshot()["dense_state"]
        sh_close(run)
        runs[device] = run
    card_run = runs[SH_CARD]
    for k, v in card_run["launches"].items():
        tally[k] += v
    held = sh_rows(EventBatch, (card_run["outs"]["Alerts"],
                                runs["cpu"]["outs"]["Alerts"]))
    bad = [k for k, v in card_run["final"].items()
           if not np.array_equal(v.view(np.uint8),
                                 runs["cpu"]["final"][k].view(np.uint8))]
    if bad or not held:
        raise AssertionError(f"sharded (c): state {bad} differ, rows {held}")
    return sh_line("c_cpu_twin_devices_4", card_run, SH_CPU_BATCH, 0,
                   card, partitions=SH_CPU_PARTITIONS, devices=4,
                   rows=held, rows_equal_cpu=True, state_equal_cpu=True,
                   cpu_ms_a_batch=1e3 * sum(runs["cpu"]["batch_s"])
                   / SH_CPU_BATCHES)


def sh_batch_chain(torch, SiddhiManager, EventBatch, StreamCallback,
                   kernels, card, tally) -> dict:
    """(c2): the capture-free chain at SH_BATCH_PARTITIONS on the card at
    devices='4' against the same app without devices=: both launch
    ``dense_batch`` (the sharded run once a shard with events), matches
    and whole state bit for bit by key number."""
    batches = sh_batches(EventBatch, SH_BATCH_WARMUP + SH_BATCH_STEPS,
                         SH_BATCH_PARTITIONS, SH_BATCH, seed=SH_SEED + 4)
    ref = sh_run(torch, SiddhiManager, StreamCallback,
                 batch_chain_app(SH_BATCH_PARTITIONS), batches, SH_CARD,
                 kernels, keep_live=True)
    kept = dict(ref["dense"].state)
    ref_outs = ref["outs"]["Alerts"]
    sh_close(ref)
    four = sh_run(torch, SiddhiManager, StreamCallback,
                  batch_chain_app(SH_BATCH_PARTITIONS, 4), batches, SH_CARD,
                  kernels, keep_live=True)
    held = sh_rows(EventBatch, (four["outs"]["Alerts"], ref_outs))
    same = sh_same_state(torch, kept, four["dense"])
    sh_close(four)
    del kept, ref_outs
    gc.collect()
    for run in (ref, four):
        for k, v in run["launches"].items():
            tally[k] += v
    batch_kind = {"q": "dense/batch"}
    launched = [run["launches"]["dense_batch"] for run in (ref, four)]
    if (not same or not held or ref["lowering"] != batch_kind
            or four["lowering"] != batch_kind
            or (SH_CARD == "cuda" and min(launched) < 1)):
        raise AssertionError(f"sharded (c2): state {same}, rows {held}, "
                             f"lowering {four['lowering']}, dense_batch "
                             f"launches {launched}")
    return sh_line(
        "c2_capture_free_devices_4", four, SH_BATCH, SH_BATCH_WARMUP, card,
        partitions=SH_BATCH_PARTITIONS, devices=4, rows=held,
        rows_equal_unsharded=True, state_equal_unsharded=True,
        unsharded_events_per_s=SH_BATCH * SH_BATCH_STEPS
        / sum(ref["batch_s"][SH_BATCH_WARMUP:]),
        unsharded_ms_a_batch=1e3 * sum(ref["batch_s"][SH_BATCH_WARMUP:])
        / SH_BATCH_STEPS, unsharded_lowering=ref["lowering"],
        unsharded_launches=ref["launches"])


def sh_device_queries(torch, SiddhiManager, EventBatch, StreamCallback,
                      kernels, card, tally) -> list:
    """(d): each sharded device-query kind at devices='4' on the card
    against the same app on one device, bit for bit."""
    from siddhi_tpu_torch.parallel import ShardedDeviceQueryEngine

    lines = []
    for kind, (label, n_symbols, sum_cols) in SH_DQ_APPS.items():
        t_case = time.perf_counter()
        app = DEVICE_QUERY_APPS[label][0] if label in DEVICE_QUERY_APPS \
            else label
        batches = dq_batches(EventBatch, n_symbols, 43)[:SH_DQ_BATCHES]
        sharded_app = app.replace(
            "@app:execution('tpu', ",
            f"@app:execution('tpu', devices='{SH_DQ_DEVICES}', ")
        runs = {}
        for tag, a in (("single", app), ("sharded", sharded_app)):
            run = run_app(torch, SiddhiManager, StreamCallback, a, batches,
                          SH_CARD, kernels, ("outputStream",), live=True)
            rts = [qr.device_runtime for qr in
                   run["rt"]._all_query_runtimes().values()
                   if getattr(qr, "device_runtime", None) is not None]
            run["engines"] = [type(r.engine).__name__ for r in rts]
            run["kinds"] = [r.engine.kind for r in rts]
            run["rt"].shutdown()
            run.pop("mgr").shutdown()
            runs[tag] = run
        one, sh = runs["single"], runs["sharded"]
        # every column bit for bit, the float32 sums too
        x = sh["outs"]["outputStream"]
        y = one["outs"]["outputStream"]
        if len(x) != len(y):
            raise AssertionError(f"sharded (d) {kind}: {len(x)} output "
                                 f"batches against {len(y)}")
        cmp = [dq_compare(p, q, sum_cols, True) for p, q in zip(x, y)]
        held = sum(c["rows"] for c in cmp)
        # accumulate_ in every kind whose one-device run launches it
        banks = (one["launches"]["bank_scatter"],
                 sh["launches"]["bank_scatter"])
        ok = (sh["engines"] == [ShardedDeviceQueryEngine.__name__]
              and sh["kinds"] == [kind] and sh["lowering"] == one["lowering"]
              and (SH_CARD != "cuda" or bool(banks[0]) == bool(banks[1])))
        if not ok or not held:
            raise AssertionError(f"sharded (d) {kind}: engines "
                                 f"{sh['engines']} {sh['kinds']}, lowering "
                                 f"{sh['lowering']}, rows {held}, "
                                 f"accumulate_ launches {banks}")
        for k, v in sh["launches"].items():
            tally[k] += v
        events = sum(len(b) for b in batches)
        lines.append({
            "phase": "sharded", "case": f"d_device_query_{kind}",
            "cell": label if label in DEVICE_QUERY_APPS else "lengthBatch "
            "group-by", "symbols": n_symbols, "devices": SH_DQ_DEVICES,
            "batches": len(batches), "batch": DQ_BATCH, "rows": held,
            "rows_equal_single_device": True, "bit_exact": True,
            "float32_sum_columns": list(sum_cols),
            "max_abs_err": max(c["max_abs_err"] for c in cmp),
            "max_rel_err": max(c["max_rel_err"] for c in cmp),
            "case_s": time.perf_counter() - t_case,
            "events_per_s": events / sh["secs"],
            "single_device_events_per_s": events / one["secs"],
            "ms_a_batch": 1e3 * sh["secs"] / len(batches),
            "launches": sh["launches"],
            "single_device_launches": one["launches"],
            "lowering": sh["lowering"], "card": card})
    return lines


def sh_fault_and_plan(torch, SiddhiManager, EventBatch, StreamCallback,
                      kernels, card, tally) -> list:
    """(e): one transient step.shard fault on (c)'s app on the card, the
    faulted batch routed to ``!D`` and the other rows equal to the clean
    run's; then one @app:plan(auto) switch by the plan monitor on
    observed batch widths, bit for bit against the run without it."""
    from siddhi_tpu_torch.planner.monitor import PlanMonitor

    batches = sh_batches(EventBatch, SH_FAULT_BATCHES, SH_CPU_PARTITIONS,
                         SH_CPU_BATCH, seed=SH_SEED + 2)
    faults = ("@app:faults(seed='7', "
              f"step.shard='transient:count=1:after={SH_FAULTED}')")
    with OpsErrors():
        chaos = sh_run(torch, SiddhiManager, StreamCallback,
                       config5_app(SH_CPU_PARTITIONS, 4, faults,
                                   "@OnError(action='STREAM')"),
                       batches, SH_CARD, kernels, outs=("Alerts", "!D"),
                       keep_live=True)
    skip = batches[:SH_FAULTED] + batches[SH_FAULTED + 1:]
    clean = sh_run(torch, SiddhiManager, StreamCallback,
                   config5_app(SH_CPU_PARTITIONS, 4), skip, SH_CARD, kernels,
                   seed_batches=batches, keep_live=True)
    fst = chaos["rt"].app_context.fault_injector.stats
    faulted = sum(len(b) for b in chaos["outs"]["!D"])
    rows = ops_rows(EventBatch, chaos["outs"]["Alerts"])
    same = sh_same_dense(torch, chaos["dense"], clean["dense"])
    sh_close(chaos)
    sh_close(clean)
    for run in (chaos, clean):
        for k, v in run["launches"].items():
            tally[k] += v
    if (rows != ops_rows(EventBatch, clean["outs"]["Alerts"]) or not rows
            or faulted != len(batches[SH_FAULTED]) or not same
            or fst.faults_injected != 1):
        raise AssertionError(f"sharded (e): rows {len(rows)} faulted "
                             f"{faulted} state {same} {fst.as_dict()}")
    lines = [{"phase": "sharded", "case": "e_step_shard_transient",
              "partitions": SH_CPU_PARTITIONS, "devices": 4,
              "batches": len(batches), "faulted_batch": SH_FAULTED,
              "rows": len(rows), "rows_equal_fault_free_run": True,
              "state_equal_fault_free_run": True,
              "fault_stream_rows": faulted,
              "faults_injected": fst.faults_injected,
              "launches": chaos["launches"], "card": card}]
    app = ("@app:name('shmon{tag}') @app:playback @app:execution('tpu') "
           "@app:plan(auto='true') @app:statistics('true') "
           "@app:faults(journal='8192') "
           "define stream S (sym int, price float); "
           "@info(name='q1') from S[price > 10.0] select sym insert into "
           "Out;")
    rng = np.random.default_rng(SH_SEED + 3)
    sends = [EventBatch("S", ["sym", "price"],
                        {"sym": rng.integers(0, 9, 4).astype(np.int32),
                         "price": rng.uniform(0, 30, 4).astype(np.float32)},
                        1000 + 4 * i + np.arange(4, dtype=np.int64))
             for i in range(SH_MON_SENDS)]
    out = {}
    for tag in ("kept", "switched"):
        mgr = SiddhiManager(device=SH_CARD)
        rt = new_app(mgr, app.format(tag=tag))
        kept = []
        rt.add_callback("Out", ckpt_keep(StreamCallback, kept))
        rt.start()
        before = dict(rt.lowering())
        switch_s, decided = None, {}
        for i, b in enumerate(sends):
            if tag == "switched" and i == SH_MON_SWITCH:
                mon = PlanMonitor(rt)
                decided = mon.decide()
                t = time.perf_counter()
                if not mon.maybe_replan():
                    raise AssertionError("sharded (e): the monitor did not "
                                         f"re-plan ({decided})")
                switch_s = time.perf_counter() - t
            rt.get_input_handler("S").send_batch(b)
        rt.drain()
        out[tag] = {"rows": ops_rows(EventBatch, kept), "before": before,
                    "after": dict(rt.lowering()), "decided": decided,
                    "switch_s": switch_s,
                    "mode": rt.app_context.statistics_manager
                    .plans["q1"].mode}
        rt.shutdown()
        mgr.shutdown()
    k, s = out["kept"], out["switched"]
    if (s["rows"] != k["rows"] or not k["rows"]
            or s["after"] == s["before"] or s["mode"] != "pinned"):
        raise AssertionError(f"sharded (e) monitor: {s} against {k}")
    lines.append({"phase": "sharded", "case": "e_plan_monitor_switch",
                  "sends": SH_MON_SENDS, "switch_at": SH_MON_SWITCH,
                  "lowering_before": s["before"], "lowering_after":
                  s["after"], "decided": s["decided"],
                  "replan_s": s["switch_s"], "rows": len(s["rows"]),
                  "rows_equal_unswitched_run": True,
                  "mode_after": s["mode"], "card": card})
    return lines


def sh_same_dense(torch, a, b) -> bool:
    """Two sharded dense runtimes of one layout: every shard's tensors
    equal, bit for bit."""
    for sa, sb in zip(a.state.shards, b.state.shards):
        for key, ta in sa.items():
            tb = sb[key]
            if ta.is_floating_point():
                ta, tb = ta.view(torch.int32), tb.view(torch.int32)
            if not torch.equal(ta, tb):
                return False
    return True


def sharded_phase(torch, SiddhiManager, EventBatch, StreamCallback, kernels,
                  card) -> dict:
    """Phase 31, ``sharded``: (a) BASELINE config 5 at 10,000,000
    partitions at devices='1' and (b) '4' against the unsharded card run,
    (c) the CPU twin, (c2) the capture-free chain on ``dense_batch`` at
    devices='4', (d) each sharded device-query kind against one
    device, (e) a step.shard fault and a plan-monitor switch.  Returns
    the launches of its card runs."""
    tally = dict.fromkeys(kernels, 0)
    t_phase = time.perf_counter()
    for case in (sh_config5, sh_cpu_twin, sh_batch_chain, sh_device_queries,
                 sh_fault_and_plan):
        t = time.perf_counter()
        lines = case(torch, SiddhiManager, EventBatch, StreamCallback,
                     kernels, card, tally)
        for line in (lines if isinstance(lines, list) else [lines]):
            emit(line)
        emit({"phase": "sharded_case_seconds", "case": case.__name__,
              "seconds": time.perf_counter() - t})
    if SH_CARD == "cuda" and (tally["probe"] < 1 or tally["bank_scatter"] < 1
            or tally["dense_batch"] < 1 or tally["dense_step"]
            or tally["scan_chain"]):
        raise AssertionError(f"sharded phase launches {tally}")
    emit({"phase": "sharded_seconds", "seconds": time.perf_counter() - t_phase,
          "launches": tally, "card": card})
    return tally


# the analysis phase: the static pass, then the sync guard over four
# main-path apps at full width, 1 warm-up batch and AN_BATCHES guarded
AN_BATCHES = 3


def start_static_pass() -> dict:
    """``analysis`` (a), started beside the card phases: ``python -m
    siddhi_tpu_torch.analysis --format json`` on this checkout, in a
    process of its own (a host core the card phases leave idle), read by
    a thread that stamps its end; killed at exit if still running."""
    out = {"t0": time.perf_counter()}
    proc = subprocess.Popen(
        [sys.executable, "-m", "siddhi_tpu_torch.analysis", "--format",
         "json"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(Path(__file__).resolve().parent))
    atexit.register(proc.kill)

    def wait():
        out["stdout"], out["stderr"] = proc.communicate()
        out["seconds"] = time.perf_counter() - out["t0"]
        out["rc"] = proc.returncode

    out["thread"] = threading.Thread(target=wait, name="static-pass",
                                     daemon=True)
    out["thread"].start()
    return out


def an_apps(EventBatch):
    """The four apps of ``analysis`` (b): label -> (app, input stream,
    output stream, batches, the runtime's seeded start or None, the
    kernels its run must launch)."""
    from siddhi_tpu_torch.ops.dense_nfa import compile_pattern

    n = 1 + AN_BATCHES
    dense = product_batches(EventBatch)[:n]
    apps = {}
    for label, capturing, seed, need in (
            ("product", True, 29, ("probe",)),
            ("product_batch", False, 31, ("probe", "dense_batch"))):
        eng = compile_pattern(flat_app() if capturing else
                              kernel_eligible_app(), "bench",
                              n_partitions=N_PARTITIONS,
                              n_instances=N_INSTANCES, device="cpu")
        start = mid_chain_state(eng, seed=seed)
        del eng
        apps[label] = (product_app("", capturing), "Txn", "Alerts", dense,
                       start, need)
    apps["partition_scaling_50000"] = (
        DEVICE_QUERY_APPS["partition_scaling_50000"][0], "cseEventStream",
        "outputStream", dq_batches(EventBatch, 50_000, 67)[:n], None,
        ("bank_scatter",))
    apps["hot_key_routed"] = (hot_key_app(True), "S", "Alerts",
                              hot_key_batches(EventBatch)[:n], None,
                              ("dense_batch", "scan_chain"))
    return apps


def an_run(torch, SiddhiManager, StreamCallback, spec, kernels, guard):
    """One app of ``analysis`` (b) on the card: created (launch counts
    from here), its seeded start restored, the warm-up batch sent and
    drained, then the guarded batches sent and drained inside ``guard``
    (a ``SyncGuard``, or None for the unguarded twin).  Returns the
    callback batches, the launches by kernel and the rows."""
    app, stream, out, batches, start, _need = spec
    zero_launches(kernels)
    mgr = SiddhiManager(device="cuda")
    rt = new_app(mgr, app)
    kept = []

    class Keep(StreamCallback):
        def receive_batch(self, batch):
            kept.append(batch)

    rt.add_callback(out, Keep())
    rt.start()
    if start is not None:
        host, base_ts = start
        runtime = rt.partitions["partition_0"].dense_query_runtimes[
            "bench"].pattern_processor
        runtime.restore({"dense_state": host, "base_ts": base_ts,
                         "key_rows": dict(zip(range(N_PARTITIONS),
                                              range(N_PARTITIONS))),
                         "next_row": N_PARTITIONS, "free_rows": []})
    h = rt.get_input_handler(stream)
    h.send_batch(batches[0])
    rt.drain()
    torch.cuda.synchronize()
    with guard or contextlib.nullcontext():
        for b in batches[1:]:
            h.send_batch(b)
        rt.drain()
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    rt.shutdown()
    mgr.shutdown()
    return {"outs": {out: kept}, "launches": launches,
            "rows": sum(len(b) for b in kept)}


def analysis_phase(torch, SiddhiManager, EventBatch, StreamCallback, kernels,
                   card, static) -> dict:
    """Phase 32, ``analysis``: (a) ``python -m siddhi_tpu_torch.analysis
    --format json`` on this checkout (``static``, from
    ``start_static_pass``), which must report no finding; (b)
    the static host-sync rule's dynamic twin, ``SyncGuard``, over four
    main-path apps at full width (``an_apps``): each app's syncs a batch
    by attributed scope, none of them unsanctioned, its kernels launched,
    and its callback batches under the guard bit for bit those of the
    same batches unguarded.  Nothing is timed under the guard.  Returns
    the launches of the guarded runs."""
    from siddhi_tpu_torch.analysis.sync_guard import (
        OUTSIDE, SyncGuard, unused_on_card_syncs)

    t_phase = time.perf_counter()
    static["thread"].join(600)
    if static["thread"].is_alive() or not static["stdout"]:
        raise AssertionError("analysis (a): the static pass did not finish: "
                             f"{static.get('stderr', '')[-2000:]}")
    report = json.loads(static["stdout"])
    if static["rc"] != 0 or report["finding_count"]:
        raise AssertionError(
            "analysis (a): the static pass reports findings: "
            + "; ".join(f"{f['file']}:{f['line']} [{f['rule']}] {f['scope']}"
                        for f in report["findings"][:10]))
    emit({"phase": "analysis", "case": "static", "rules": report["rule_count"],
          "modules": report["modules"], "findings": report["finding_count"],
          "suppressed": report["allowlisted"],
          "seconds": static["seconds"],
          "waited_s": time.perf_counter() - t_phase, "card": card})
    # the control: the batch step's plain twin, off the main path, syncs
    # outside every sanctioned scope (its rank count and its nonzero), so
    # the guard must see those syncs on the card and name its scope
    from siddhi_tpu_torch.kernels import dense_batch

    case = batch_step_case(torch, 3, 2, 64, 8, None, 5, "cuda")
    control = SyncGuard()
    with control:
        dense_batch.batch_step_plain(case["state"], *case["args"],
                                     case["kw"]["n_inst"],
                                     case["kw"]["within"])
    torch.cuda.synchronize()
    want = "siddhi_tpu_torch/kernels/dense_batch.py:batch_step_plain"
    seen = control.unsanctioned()
    emit({"phase": "analysis", "case": "control", "unsanctioned": seen,
          "lines": {k: dict(v) for k, v in control.lines.items()},
          "card": card})
    if seen.get(want, 0) < 2 or any(
            not k.startswith(want.split(":")[0]) for k in seen):
        raise AssertionError(f"analysis (b): the guard's control saw {seen}, "
                             f"not the syncs of {want}")
    tally = dict.fromkeys(kernels, 0)
    guards = []
    for label, spec in an_apps(EventBatch).items():
        t = time.perf_counter()
        guard = SyncGuard()
        got = an_run(torch, SiddhiManager, StreamCallback, spec, kernels,
                     guard)
        gc.collect()
        plain = an_run(torch, SiddhiManager, StreamCallback, spec, kernels,
                       None)
        held = held_vs(got, plain)
        guards.append(guard)
        for k, n in got["launches"].items():
            tally[k] += n
        bad = guard.unsanctioned()
        missing = [k for k in spec[5] if got["launches"][k] < 1]
        line = {"phase": "analysis", "case": label,
                "batch": len(spec[3][1]), "guarded_batches": AN_BATCHES,
                "syncs_per_batch": {k: n / AN_BATCHES for k, n in
                                    sorted(guard.counts.items())},
                "syncs_per_batch_by_bucket": {
                    k: n / AN_BATCHES for k, n in guard.by_bucket().items()},
                "threads": {k: sorted(v) for k, v in guard.threads.items()},
                "unsanctioned": sum(bad.values()),
                "unsanctioned_scopes": bad,
                "launches": got["launches"], "rows": got["rows"],
                "rows_held_guarded_vs_unguarded": held,
                "bit_equal": True, "seconds": time.perf_counter() - t,
                "card": card}
        emit(line)
        if bad or missing or guard.counts.get(OUTSIDE):
            raise AssertionError(
                f"analysis (b) {label}: unsanctioned syncs {bad}, outside "
                f"{guard.counts.get(OUTSIDE, 0)}, kernels not launched "
                f"{missing}")
        del got, plain
        gc.collect()
        torch.cuda.empty_cache()
    stale = unused_on_card_syncs(guards)
    emit({"phase": "analysis_seconds", "seconds": time.perf_counter() - t_phase,
          "launches": tally, "on_card_syncs_never_hit": stale, "card": card})
    if stale:
        # as a stale allowlist entry fails the static pass: the list of
        # sanctioned card syncs only shrinks
        raise AssertionError(f"analysis (b): ON_CARD_SYNCS entries no app "
                             f"hit: {stale}")
    return tally


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
    static = start_static_pass()
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

    # 25. checkpoint and restore ---------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_launches = checkpoint_phase(torch, SiddhiManager, EventBatch,
                                     StreamCallback, all_kernels, card)

    # 26-27. stream-graph fusion and device tables ----------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    fuse_launches = fusion_phase(torch, SiddhiManager, EventBatch,
                                 StreamCallback, all_kernels, card)
    emit({"phase": "fusion_seconds", "seconds": time.perf_counter() - t_phase})
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    dt_launches = devtables_phase(torch, SiddhiManager, EventBatch,
                                  StreamCallback, all_kernels, card)
    emit({"phase": "devtables_seconds",
          "seconds": time.perf_counter() - t_phase})

    # 28-29. multiplexing; sources, sinks and fault streams -------------------
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    mux_launches = multiplex_phase(torch, SiddhiManager, EventBatch,
                                   StreamCallback, all_kernels, card)
    emit({"phase": "multiplex_seconds",
          "seconds": time.perf_counter() - t_phase})
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tr_launches = transports_phase(torch, SiddhiManager, EventBatch,
                                   StreamCallback, all_kernels, card)
    emit({"phase": "transports_seconds",
          "seconds": time.perf_counter() - t_phase})

    # 30. the operations layer -------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    ops_launches = operations_phase(torch, SiddhiManager, EventBatch,
                                    StreamCallback, all_kernels, card)

    # 31. the mesh: BASELINE config 5 at 10,000,000 partitions sharded,
    # sharded device queries, a step.shard fault, the plan monitor -----------
    gc.collect()
    torch.cuda.empty_cache()
    shard_launches = sharded_phase(torch, SiddhiManager, EventBatch,
                                   StreamCallback, all_kernels, card)

    # 32. static analysis, and the sync guard over four main-path apps ----
    gc.collect()
    torch.cuda.empty_cache()
    an_launches = analysis_phase(torch, SiddhiManager, EventBatch,
                                 StreamCallback, all_kernels, card, static)
    emit({"phase": "isolated_errors", "errors": 0,
          "warnings_to_listeners_or_log": ISOLATED.warnings})

    # 33. kernels -------------------------------------------------------------
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
                            "tables": table_launches[name],
                            # (a)-(e) of the checkpoint phase
                            "checkpoint": ckpt_launches[name],
                            # the card runs of the fusion and device
                            # table phases
                            "fusion": fuse_launches[name],
                            "devtables": dt_launches[name],
                            # (a)-(c) of the multiplex phase, multiplexed
                            # and dedicated card runs; the transport runs
                            "multiplex": mux_launches[name],
                            "transports": tr_launches[name],
                            # (a)-(e) of the operations phase
                            "operations": ops_launches[name],
                            # (a)-(e) of the sharded phase, card runs
                            "sharded": shard_launches[name],
                            # the guarded runs of the analysis phase
                            "analysis": an_launches[name]}
    emit({"kernels": [
        {"name": "dense_batch", "route": "cuda",
         "source": "siddhi_tpu_torch/kernels/csrc/dense_batch.cu",
         "replaces": "siddhi_tpu/kernels/dense_step.py:154",
         "launches": (launches["dense_batch"] + hk_launches["dense_batch"]
                      + hp_launches["dense_batch"]
                      + product_launches["dense_batch"]
                      + auto_launches["dense_batch"]
                      + ckpt_launches["dense_batch"]
                      + mux_launches["dense_batch"]
                      + tr_launches["dense_batch"]
                      + ops_launches["dense_batch"]
                      + shard_launches["dense_batch"]
                      + an_launches["dense_batch"]),
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
                      + product_launches["probe"] + auto_launches["probe"]
                      + ckpt_launches["probe"] + fuse_launches["probe"]
                      + mux_launches["probe"] + tr_launches["probe"]
                      + ops_launches["probe"] + shard_launches["probe"]
                      + an_launches["probe"]),
         "launches_by_path": by_path("probe"), "max_abs_err": probe_err,
         **{k: probe_line[k] for k in KERNEL_KEYS}},
        {"name": "scan_chain", "route": "cuda",
         "source": "siddhi_tpu_torch/kernels/csrc/scan_chain.cu",
         "replaces": "siddhi_tpu/kernels/scan_chain.py:91",
         "launches": hk_launches["scan_chain"]
                     + auto_launches["scan_chain"]
                     + ops_launches["scan_chain"]
                     + an_launches["scan_chain"],
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
                     + auto_launches["bank_scatter"]
                     + ckpt_launches["bank_scatter"]
                     + fuse_launches["bank_scatter"]
                     + dt_launches["bank_scatter"]
                     + mux_launches["bank_scatter"]
                     + tr_launches["bank_scatter"]
                     + ops_launches["bank_scatter"]
                     + shard_launches["bank_scatter"]
                     + an_launches["bank_scatter"],
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
