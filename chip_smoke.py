"""Smoke run of metrics_tpu_torch on one NVIDIA GPU (H100): build, check, time.

Run from the root of a checkout, on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

It builds every CUDA kernel of the port's main path from the sources in the
checkout, and then:

- Phase A holds each kernel against its plain PyTorch version on the card
  (``torch.equal`` on int32 counts). Both routes of ``csrc/pair_count.cu``:
  the table route (the confusion matrix) and the stat-score route (int32
  tp/fp/tn/fn without the table), each at the training step's shape and at
  the six-metric collection's (Phase J2), on int64 and int32 labels, mixed
  label types, ``ignore_index`` None, in range, -1 and at or above C,
  out-of-range and negative labels, int64 labels at and above 2^31 (they
  count by their low 32 bits), C = 2, N = 1, N = 0, views at a storage
  offset (no 16-byte loads), the table route's two branches (shared memory
  in clusters of two blocks, up to the largest table a block holds, and
  global atomics) with and without a mask, and the stat-score route's two
  (counters in shared memory, up to the largest C a block holds, and in the
  output for C = 20000); tables and counters above 48 KB of dynamic shared
  memory included.
- Phase B drives the main path through the user's entry point
  (``metrics_tpu_torch.entry.entry``): the fused Accuracy + F1 +
  ConfusionMatrix training step at batch 1024, hidden 4096, 1000 classes,
  8 layers. Kernel launch counts are zeroed just before and read just after;
  each step must launch the stat-score route twice (accuracy, F1) and the
  table route once (the confusion matrix). The card's
  metric states are held bit for bit against a CPU recomputation from the
  same predictions. The stateful ``update``/``forward``/``compute``/``reset``
  path runs once on the card too.
- Phase C times the bare and the fused step, and both routes at the two
  shapes on int64 labels against their plain versions, ``torch.bincount``
  of the pair keys (the library call), and their memory bounds. ``ms`` is
  the wrapper's call time by CUDA events over back-to-back calls;
  ``device_ms`` is the kernel's own device time from ``torch.profiler``.
- Phase D profiles the bare step, the fused step and the fused step's metric
  updates alone: device busy time and idle share per step, and device time
  by kernel; the metric updates must run no int64 reduction.
- Phase A also holds each scatter kernel of the sketch plane (``hist_add``,
  ``hist_max``, ``cms_rows_add`` of ``csrc/scatter.cu``) against its plain
  version: every branch (a shared-memory table, one above 48 KB of dynamic
  shared memory, hist_max's packed int16 table for tables beyond one block,
  and global atomics),
  ragged and tiny N, N = 0, out-of-range indices, zero weights, int32
  extremes, Zipf-skewed keys, and inputs that are views at a storage offset
  with N % 4 != 0 (idx and val at one offset and at two); the ids route of
  ``cms_rows_add`` (columns hashed in the kernel, ``csrc/cm_hash.cuh``) on the
  same count-min shapes, negative ids with the int32 extremes, widths that
  are no power of two, depth 7 x width 1 and a view at a storage offset; and
  the heavy-hitter ledger walk (``csrc/cms_walk.cu``, four kernels: segment
  histograms, their scan, the estimates, the walk) against the plain walk,
  ``torch.equal`` on the table and the ledger, at up to 2^14 items: Zipf,
  uniform, one id, negative ids, ties at the ledger's minimum, non-empty
  starting ledgers (held keys, a duplicate, a negative key), k = 1, 8, 32,
  33, 100 and 40000 (the step walk, the one-warp walk with the ledger in
  shared and in global memory), a
  table beyond shared memory (histograms counted in global memory), widths
  2047 and 65536, a candidate at lane 0 and at lane 31 of a chunk, a raise of
  the slot at the minimum before a candidate in the same chunk, held keys
  above every estimate, duplicate and negative keys, counts that wrap near
  2^31, and a seeded sweep over k and width; the kernel's counters (raises,
  evictions, chunks that reached a candidate) equal to the numpy mirror's
  (``cms_walk.walk_in_chunks``) on every case.
- Phase E drives the sketch plane at the JAX classes' default sizes through
  the functional API and once through the stateful one: QuantileSketch
  (alpha 0.01, 2048 buckets), CardinalitySketch (p = 12 and 16) and the
  4 x 2048 count-min table on 2 batches of 2^22 values, HeavyHittersSketch
  (k 32, 4 x 2048) on 2 batches of HH_BATCH ids. Launch counts are zeroed just
  before and read just after: 2 hist_add per quantile update, 1 hist_max per
  cardinality update, 1 cms_rows_add (its ids route, past the registry) per
  table update, 4 cms_walk kernels per heavy-hitter update, and no reference
  dispatch on a CUDA tensor. The int32 states are held against a CPU
  recomputation (the heavy hitters through the plain walk) and the merge of
  two half-streams against the single stream.
- Phase F times each scatter kernel at the Phase E shapes (call, device,
  plain version, one PyTorch library call, bound; the ids route's bound is
  the larger of its bytes and its hash's integer instructions over the
  card's issue rate, 128 lanes a SM at ``clocks.max.sm``), the ledger walk at
  4096, HH_BATCH and 2^22 ids (µs per item, device time by kernel, the
  counters, equal to the mirror's; bound: the evictions times the fewest
  dependent cycles of one decision over ``clocks.max.sm``, plus the ids
  route's bound at the same N; beside it ``snapshot_bound_ms``, the same
  cycles for every item held at the start of its chunk of 32 or above the
  smallest count then, the bound of a walk that decides each of those), each
  sketch's update and values/s, and profiles a quantile, a count-min table
  and a heavy-hitter update.
- Phase G holds the threshold-count kernel of the binned curves
  (``csrc/binned_curve.cu``) against its plain version: ``torch.equal`` on
  0/1 weights at N = 10^6 with T = 100, 200, 400 and 1024 and with 10
  columns, and on the edge cases of the CPU tests (NaN, +-inf, -0.0, scores
  on a threshold, unsorted, descending and duplicate thresholds, NaN and
  +-inf thresholds, -0.0 against +0.0 scores, T = 1, T above one block's
  1024, N = 1, ragged N, N = 0 without a launch, views at a storage offset),
  on both sides of the crossover between the sorted-threshold and the
  comparison route; float weights within ``rtol=1e-5, atol=1e-3``, two
  launches on one input bit-identical.
- Phase H drives the binned curves at full width: 2 updates of 10^6 scores
  at T = 200 through BinaryPrecisionRecallCurve, BinaryROC, BinaryAUROC
  (max_fpr None and 0.5) and BinaryAveragePrecision, functional API and
  stateful; MulticlassAUROC and MultilabelAveragePrecision at C = 10 on 10^6
  rows; one exact-mode BinaryAUROC on 2^20 scores. Launch counts are zeroed
  just before and read just after: one binned_curve launch per binned update
  and no reference dispatch. The int32 states are held against a CPU
  recomputation (the plain version) and the merge of two half-streams
  against the single stream; values against the CPU.
- Phase I times the kernel at the Phase H shape, at T = 1024 and at C = 10
  (device time under the profiler, summed over every kernel one wrapper call
  launches and divided by the calls, call time, plain version, bound: the larger of the
  bytes and the operations of the sorted-threshold route, O(N log T), the
  least work that computes the function; no single PyTorch call
  computes the function, so the three-call bucketize + bincount + cumsum
  route is timed beside it) and the five binary updates per batch.
- Phase J drives the metric core. J1: the flagship step at full width with
  its three metrics in a ``MetricCollection`` (one eager ``update`` forms
  the groups the JAX package forms, {accuracy, f1} and {confmat}; then
  ``init_state`` / ``update_state`` / ``compute_from``): 20 chained steps of
  ``sgd_step`` + ``argmax`` + ``update_state``, 1 stat-score and 1 table
  launch per step against 2 and 1 for the same metrics as a dict on the
  same predictions, no reference dispatch,
  states and values equal to the dict path's (``torch.equal``), and the
  step timed beside the bare and the dict step as Phase C times it. J2: the
  six-metric collection of ``benchmarks/collections_vs_reference.py``
  (accuracy micro; precision, recall, F1, specificity macro; a confusion
  matrix) at N = 10^6, C = 100, with compute groups on and off: the groups
  at construction and after the first update as the JAX package forms them,
  1 stat-score and 1 table launch per update against 5 and 1 (3 and 1 in
  the update that forms the groups, one per group seeded at construction),
  no reference dispatch, int32 states equal in both modes
  and to a CPU recomputation, ``compute()`` equal, and 8 updates timed by
  CUDA events (groups on and off interleaved, minimum of 5). J3: Sum, Mean,
  Max, Min and Cat on 2^22 float32 values with NaN under "warn", "ignore"
  and a float imputation (Max, Min and Cat exact, Sum and Mean within rtol
  1e-5 of a float64 CPU sum), every state on the card, and
  ``MulticlassPrecision + MulticlassRecall`` and ``2 * MeanMetric`` equal to
  the operator on their children's values.

- Phase K drives the port's ``StreamingEngine`` on the card, each micro-batch
  one CUDA-graph replay (``metrics_tpu_torch/engine/runtime.py``). Each
  sub-phase warms up over its bucket ladder (one capture a bucket; compiles
  must equal the bucket count after the traffic too), serves from client
  threads, and holds every tenant's state to a per-tenant sequential fold of
  the same requests through ``update_state`` on the card (``torch.equal``
  leaf for leaf; ``_update_count`` counts rows). K1: ``QuantileSketch()``
  at ``benchmarks/engine_throughput.py --sketch``'s configuration (buckets
  (64, 256), max_queue 2048, capacity 8; 8000 batch-1 lognormal requests
  over 8 tenants from 4 threads), beside 300 naive per-call updates. K2: the
  flagship metrics (accuracy micro, F1 macro, a confusion matrix at 1000
  classes) in a ``MetricCollection``, 1000 requests of 1-16 int64 label
  pairs plus one 600-row request a tenant (split into chunks), states also
  against the plain versions on the CPU, ``compute()`` equal, and the
  collection's ``jitted_update_state`` against ``update_state``. K3:
  ``HeavyHittersSketch`` (k 32, 4 x 2048) on 1000 Zipf(1.1) ids over 4
  tenants from one thread. K4: ``BinaryAUROC(thresholds=200)`` on 1000
  requests of 1-8 scores. K1 and K2 then profile a window of replays: the
  hand kernels' launches in the profile must equal the launches captured x
  replays; the device's idle share and µs per row. Every graph's nodes
  (``cudaGraphGetNodes``), capture and warm-up ms and pool growth are
  printed. K5: an update that reads a value on the host cannot be captured:
  one demotion (``fused_fallbacks == 1``), every request answered, then
  eager updates on the card with ``hist_add`` launched, states equal to
  the fold, ``compute`` and ``compute_all`` of the demoted engine equal to
  the fold's values, and random numbers still drawn after the failed
  capture. K6:
  ``BinaryAccuracy()`` with its value checks on, at
  ``benchmarks/engine_throughput.py``'s headline configuration (the K1
  engine settings; 8000 batch-1 int64 requests, seed 0), beside 300 naive
  per-call forwards: no fallback, states equal to the fold, then
  ``evict_tenant("tenant-0")`` returns True, the tenant leaves
  ``compute_all()``, and its resubmitted requests give a fresh tenant's
  state with no new capture.
- Phase L drives the binary and multilabel stat-score families and
  ``MeanSquaredError`` at the JAX benchmarks' sizes: 10^6 float32 scores
  with int32 targets (``benchmarks/classification_vs_reference.py``, seed
  0), as 10^6 binary scores and as 10^4 samples x 100 labels, through
  each of stat scores, confusion matrix, accuracy, F1, precision, recall
  and specificity by its class, its task façade, its functional and its
  functional façade (int32 states bit-identical to the port's plain code
  on the CPU, values within rtol 1e-6); 10^6 float32 pairs through
  ``MeanSquaredError`` (``benchmarks/regression_vs_reference.py``; the sum
  within rtol 1e-5 of a float64 sum and of the CPU's). These updates are
  plain torch code (no hand kernel): each class update is timed by CUDA
  events, with and without its value checks, and profiled (device time,
  idle share, device kernels a update).
- Phase M drives the durable state plane (``metrics_tpu_torch/ckpt/``, the
  engine's ``checkpoint=``). M1: the checkpoint overhead at K6's
  configuration by ``benchmarks/engine_throughput.py``'s procedure (6 pairs
  of passes, plain and with ``CheckpointConfig(interval_s=0.25, retain=3)``
  in a temporary directory, alternating which goes first; the median of the
  per-pair ratios, less one; the JAX benchmark's 5% gate is printed as a
  record, not checked), each pass's states held to the fold, with the best
  req/s of each side, the snapshots, WAL records and bytes a pass, the write
  ms a snapshot and the temporary directory's filesystem. M2: the flagship
  collection at 1000 classes and ``QuantileSketch`` served, snapshotted
  half way, served on and crashed (``close(checkpoint=False)``); a new engine
  on the card recovers: every leaf ``torch.equal`` to the crashed engine's
  and to the fold, the graph replays equal to the chunk records replayed,
  the wrappers' counters advanced twice what the graphs captured (warm-up
  and capture) and the profiled launches equal captured x (replays + 1), and
  a new tenant gets a fresh slot; recovery ms, records and rows replayed,
  rows/s, the snapshot's bytes and write ms. M3: the card's final snapshot
  restores into a CPU engine, the CPU engine's snapshot and the ``T``
  record of an eviction after it restore on the card (leaves equal, the
  tenant gone), and ``MetricCollection.save``/``restore`` of the flagship
  collection gives equal states on the card and the CPU and an equal
  ``compute()`` on the card (the CPU's within rtol 1e-6). No new kernel: the
  ``kernels`` line keeps its rows.
- Phase N drives the guard plane (``guard=GuardConfig(...)``). N1: the guard's
  overhead at K6's configuration, 6 pairs of plain and guarded passes, the
  median pair ratio (the JAX gate of 5% printed as a record) beside the
  dispatcher's timed share in ``form_drain``. N2: the light tenants' p99 under
  a 100x skewed adversary (``engine_throughput.py --guard``: one tenant's
  bursts of 400 x 64 rows every 0.4 s beside 9 x 100 paced batch-1
  requests), 5 guarded pairs of solo and flooded runs (``GuardConfig(
  shed=False, drain_quantum_rows=128)``) and 2 unguarded; both ratios printed
  beside the JAX gates as records. N3: faults on K2's flagship collection at
  C = 1000: a wedged dispatcher is taken over (inline on the engine's
  stream) and restarted, every leaf equal to a fold, the wrappers' counters
  equal to the inline updates' launches and the graphs' captured x replays
  grown; a held dispatch lock quarantines the engine, every pending future
  fails with ``EngineQuarantined`` and ``close()`` returns; a capture
  governor with a budget of one sends novel signatures to eager updates on
  ``cuda:0`` that launch the kernels, states equal to the fold.
- Phase O drives the tier plane (``tier=TierConfig(...)``). O1: K6 plain
  against ``TierConfig(hot_capacity=8)``, 6 pairs. O2: ``engine_throughput.py
  --tier``'s million: 10^6 registered tenants, a sweep over 12,000 with a hot
  set of 8000 and a flush every 64 submits; the slab stays within the
  footprint of 10,000 tenants (measured on a 512-tenant untiered engine) and
  no graph is captured after the slab reaches its cap; ``slab_bytes`` beside
  ``torch.cuda.memory_allocated()``. O3: warm readmission p50 and p99 over
  255 demote / timed pin cycles. O4: K2's collection (4 MB a tenant) over 32
  tenants with 8 hot and 8 warm (the rest spilled), and K1's quantiles over
  64 with 16 hot: every leaf equal to a fold and to an untiered twin, the
  wrappers' launches 2 x captured and in the graphs captured x replays; a
  crash and a recovery from the snapshot's tier section and the WAL's D and
  P records gives the same leaves; ms a promotion and a demotion against a
  pinned copy of the same bytes.
- Phase P drives the replication plane (``replication=ReplConfig(...)``). P1:
  the shipping overhead at K6's configuration, 6 pairs of a checkpoint-only
  pass and a checkpointing pass whose primary also ships over a drained
  ``LoopbackLink`` (``ship_interval_s=0.02``), the median pair ratio (the JAX
  gate of 5% a record) beside the shipper thread's wall and CPU ms. P2: read
  scale-out (``engine_throughput.py --replica``): K6's primary ships over a
  directory spool under 4 writers of 64-row batches paced at 1 ms; its
  compute() rate over 2 s against a follower's in its own process on the
  same card (this script started with ``--replica-reader SPOOL SECONDS``;
  its graphs captured before the window, on one request a rung sent once
  it bootstrapped), with the follower's quiet rate, its readers'
  wait for the dispatch lock and its lag; the JAX limits (5x, 500/s) are
  records. P3: K2's collection at
  C = 1000 and K1's quantiles, each a journaled primary and a follower on
  ``cuda:0`` over a ``LoopbackLink`` with their own graphs: the follower
  tracks a live segment; the primary restarts (a new epoch) and the follower
  rebootstraps into its slab in place (the same data pointers); a segment
  is held behind the follower's dispatch lock and replayed alone under the
  profiler (its launches equal captured x replays, 2 ``stat_scores`` + 1
  ``pair_count`` / 2 ``hist_add`` a row of every graph); the primary is
  dropped without ``close()`` and the follower promoted (ms, and its drain,
  fence and pin spans); the deposed primary's shipments are fenced and
  leave the promoted states alone; the promoted engine serves 128 requests;
  every leaf ``torch.equal`` to the primary's at the applied seq and to the
  fold. P4: a zombie primary over TCP refused at the follower's receive
  side; a guard quarantine promoting its follower through ``failover_hook``
  with the flight bundle loaded back; a traced submit's trace id in the
  follower's ``engine.replay`` span and the primary's node snapshot in the
  fleet aggregator.

- Phase Q drives the comm plane (``metrics_tpu_torch/comm/``,
  ``parallel/sync.py``). Q1: the flagship metrics' ``update_state`` ->
  ``sync_state(s, group)`` -> ``compute_from`` at the step's shape over NCCL
  at world 1 on ``cuda:0`` (one eager all-reduce first, so the communicator
  exists), 6 eager steps counted (2 stat-score + 1 table launches a step)
  and the same step captured in one CUDA graph and replayed 6 times:
  states, synced states and values ``torch.equal`` to the eager fold, the
  profiler's launches 2 + 1 a replay, NCCL's operations in an eager step's
  profile. Q2: ``entry.make_dp_step`` at bench.py's full width in two
  processes on ``cuda:0`` over gloo (this script started with ``--q-rank q2
  RANK PORT DIR``), each on its own seeded batch for 6 steps, the loss and
  gradients averaged and the metrics synced over a ``DeviceMesh``'s ``dp``
  every step: the synced counts and values equal one process's fold of both
  ranks' predictions, step ms with and without the metrics' sync, sync ms
  and bytes a step, 2 + 1 launches a rank-step; then each metric's
  ``Metric.sync()`` on the same states (the default ``dist_sync_fn``,
  ``gather_all_tensors``: staged through numpy, gathered over gloo), timed
  and equal to the in-step sync. Q3: two serving processes
  (``--q-rank q3``) each serve half of 4000 K2-style requests (the flagship
  collection at C = 1000, 8 tenants, buckets (64, 256), capacity 8) and call
  ``compute_all(sync=True)`` and ``compute(key, sync=True)``: every value
  equal to a one-process engine's over all the requests, every report
  ``degraded_step == "none"``, raw and wire bytes and sync ms; then
  ``benchmarks/comm_bench.py``'s gates at its configuration with the states
  on the card (int8 wire reduction at least 4x within absmax/254; the
  lossless overhead a record). Q4: ``LoopbackWorld(3)`` threads holding
  flagship collection states on ``cuda:0``: a dead rank (its
  ``DeadPeerTransport`` serves it stale local state) leaves the survivors a
  ``live_subset`` sync equal to their union and ``live_set_shrink`` bundles;
  a stalled transport under a deadline walks retry -> lossless_only ->
  local_state; an engine with ``GuardConfig()`` pins its syncs once its comm
  breaker opens.
- Phase R drives the shard plane (``metrics_tpu_torch.shard.ShardedEngine``)
  at ``benchmarks/engine_throughput.py --shard``'s mix (seed 3, 32 tenants: 4
  with 64-row requests, 8 with 8-row, 20 batch-1; ``BinaryAccuracy()``, 8000
  requests from 4 threads, buckets (64, 256), capacity 32). R1: 8 shards
  against 1 in req/s, median of alternating pairs (a record beside the JAX
  floor of 4x: the eight dispatchers share one card and one interpreter); R2:
  1 shard against the bare engine (a record against the JAX 5%); R3: the
  first 250 requests over 8 checkpointed shards, every tenant's state on its
  ring shard ``torch.equal`` to a one-engine fold, and its value; R4: K2's
  flagship collection (C = 1000) over 8 shards with the guard's watchdog:
  one tenant a shard captures its 64-row graph at once with the others, with
  no takeover and no fallback (a first call's watchdog deadline is the
  timeout times the first calls in flight beside it; each capture's ms is
  recorded beside the timeout), states equal to the fold,
  the stat-score and table launches in the shards' replays equal to the
  profiler's count; R5: a checkpointed ``resize(8 ->
  16)`` of R3's shards: the ring-moved tenants (and the rest) bit-identical,
  the manifest at 16, and a restart that recovers every tenant on its ring
  shard.
- Phase S drives the query plane (``metrics_tpu_torch.query.GlobalQuery``
  over the partition plane's ``PartitionedClient``) at ``--query``'s
  configuration. S1: 8 ``QuantileSketch`` engines (capacity 256, tiered, hot
  4096, buckets (64,)), one node leading all 8 partitions, with 10^6
  registered and 1024 fed tenants (seed 18): the global p50/p99 ``torch.equal`` to the per-tenant
  oracle on the card (``update_state`` replay, pairwise ``merge_states``),
  the merged state equal to the oracle's leaf for leaf, ``report.tenants ==
  10^6 + 1024``, ``hist_add`` launched in the replays; S2: 8 journaled
  leaders shipping to 8 followers, 512 tenants written through the client,
  ``GlobalQuery`` on ``prefer="replica"``: a populating miss, then 50 timed
  queries, every one a cache hit served by followers with no leader read
  (``QUERY_LEADER_READS`` unmoved: checked), the value equal to the leaders'
  per-tenant oracle, ``hist_add`` in the followers' replays and, over a
  profiled window of writes and their replays, equal to the profiler's
  count; against the naive per-tenant scatter (512 routed leader
  ``compute`` calls; a record beside the JAX 10x); S3: K6's configuration
  with and without a thread calling ``rollup()`` every 2 ms, alternating
  pairs (a record beside the JAX 5%), rollups served.
- Phase T drives the cluster plane (``metrics_tpu_torch.cluster``). T1: the
  JAX tests' three-node cluster at full width (the flagship collection at
  C = 1000, 8 tenants, 64-row requests, buckets (64,)): 'a' a checkpointed
  primary (``wal_flush="fsync"``) shipping through a ``FanoutTransport`` of
  ``LoopbackLink``s, 'b' and 'c' followers with ``promote_checkpoint``, each
  supervised by a live ``ClusterNode`` thread at ``--cluster``'s cadence
  (TTL 1.0 s, heartbeat 0.2, suspect 0.8, confirm 2.5, tick 0.05, seeded)
  over a ``DirectoryCoordStore``; writes through a ``ClusterClient``. 'a'
  dies (its node stops without releasing, its engine closes); a follower
  wins the lease at epoch 2 and promotes at it; writes go on; a's last
  epoch-1 WAL frame, delivered again, is refused at both of its links; 'a'
  is recovered from its directory (its states equal to the fold of what it
  acknowledged) and its node demotes it to a follower of the new leader.
  A thread samples every millisecond how many engines can commit writes (at
  most one, checked); every engine's states ``torch.equal`` to a CPU fold
  of every acknowledged write; the stat-score and table launches in the
  three engines' replays equal to the profiler's count over a window of
  writes; the death-to-first-acknowledgement time. T2: ``--cluster``'s pair,
  K6's mix on a checkpointed primary shipping over a drained
  ``LoopbackLink``, with and without a ``ClusterNode``, alternating pairs (a
  record beside the JAX 5%).
- Phase U drives the partition plane (``metrics_tpu_torch.part``). U1: 2
  hosts x 4 partitions of the flagship collection (eight engines on
  ``cuda:0``, buckets (64,)), 'a' leading p0 and p1 and following p2 and
  p3, 'b' the reverse, two ``PartitionedNode`` threads over one
  ``FakeCoordStore`` on the live clock, a ``PartitionedClient`` routing 16
  tenants' writes. 'b' dies: p2 and p3 fail over to 'a' each on its own
  lease (each partition's failover time) while p0 and p1 keep their
  epochs; at most one engine of a partition can commit writes (sampled,
  checked); the routes unchanged, every tenant's state equal to its fold,
  the launches in the replays against the profiler. U2: ``migrate_tenant``
  moves one tenant from p0 (guarded: the quarantine hold) to p2 while a
  thread writes p0's other tenants: the moved state bit-identical, later
  writes folded onto it, the manifest's override and epoch floor; p2's
  leader restarts from its directory with the tenant, and
  ``sweep_partitions`` evicts nothing. U3: ``--part``'s (b), a
  ``partitions=1`` ``PartitionedNode`` against a plain ``ClusterNode`` on
  T2's mix (a record beside the JAX 5%). U4: ``--part``'s (a), 4 loopback
  hosts as processes of their own on the one card (this script started with
  ``--u-host SEED PARTITIONS REQUESTS``), each leading 2 of 8 partitions of
  ``BinaryAccuracy`` engines, against one host leading all 8 (a record
  beside the JAX floor of 3.2x: the hosts share one card).
- Phase V drives the confusion-matrix family and the autopilot plane
  (``metrics_tpu_torch.pilot``). V1: ``MulticlassJaccardIndex`` (macro),
  ``MulticlassCohenKappa`` (weights None, linear, quadratic) and
  ``MulticlassMatthewsCorrCoef`` for 4 updates at bench.py's width (N =
  1024, 1000 classes) and J2's (10^6 labels, C = 100): one table launch of
  ``csrc/pair_count.cu`` an update (counted just around the updates), no
  reference dispatch, the int32 table ``torch.equal`` to the plain pair
  count and to the port's on the CPU, the value within rtol 1e-5, atol 1e-6
  of the CPU's; ms and device µs an update. Their binary and multilabel
  forms at N = 10^6 (plain torch counts) against the CPU. A
  ``MetricCollection`` of the confusion matrix and the three metrics forms
  the JAX package's groups ({cm, mcc}, {jaccard}, {kappa} at construction,
  one group after the first update): 3 then 1 table launches an update with
  groups, 4 without, every table equal. V2: ``engine_throughput.py
  --pilot``'s zipf-storm self-heal (:1619-1706): one ``PartitionedNode``
  leading 4 partitions of ``BinaryAccuracy`` engines on the card (buckets
  (64,), capacity 64, ``GuardConfig(shed=False)``) over a
  ``FakeCoordStore``, 8 hot tenants all on p0 and 2 background tenants on
  each other partition, batch-1 requests 85% zipf(1.2) over the hot set
  from 4 threads; a live ``AutoPilot`` (the benchmark's config) must spread
  the hot set over at least 3 partitions with at least one migration and
  no operator input, then is paused for the timed window; req/s against a
  hand-balanced layout (a record beside the JAX floor of 0.9x: the
  partitions share one card and one interpreter); every tenant's state, on
  the engine its map names and no other, equal to a CPU fold of its
  accepted writes. V3: the quiet pilot's cost (:1708-1760): a uniform mix on
  a balanced fleet with a default-config pilot holding the lease against
  none (a record beside the JAX 1%); the pilot journals every cycle and
  moves nothing. V4: two ``AutoPilot`` threads over one store: the holder
  is closed without releasing its lease and the standby takes it within
  one TTL, the shared journal's seqs running on; then a tier retune of p0's
  engine (hot capacity 4 -> 16 through the actuator) takes effect at the
  next sweep and grows the slab, states equal to the fold. Every pilot ends
  with no actuator failure, no ``last_error`` and no ``pilot_action_failed``
  bundle.
- Phase W drives the rest of classification and the nominal metrics. W1:
  ``CramersV``, ``PearsonsContingencyCoefficient``, ``TschuprowsT`` and
  ``TheilsU`` at 100 classes over 4 updates of 10^6 int64 label pairs, and
  the four functionals on one of them: one table launch of
  ``csrc/pair_count.cu`` an update or a call, the int32 table
  ``torch.equal`` to the plain pair count of the same labels on the CPU;
  ``cramers_v_matrix`` and ``theils_u_matrix`` over a (2^17, 8) matrix of 20
  categories a column, 28 and 56 table launches; one float batch with NaNs
  replaced by 0.0 and by -1.0 (category -1: dropped) and dropped. W2:
  ``MulticlassHammingDistance`` at V1's shapes, 4 updates, one stat-score
  launch an update, tp/fp/tn/fn equal to the plain stat scores; bench.py's
  three metrics with a Hamming distance in one ``MetricCollection`` (the
  JAX package's groups: four at construction, {accuracy, f1, hamming} and
  {confmat} after the first update; 3 + 1 launches in that update, then
  1 + 1); the binary and multilabel Hamming forms at 10^6; exact match on
  (16, 512 x 512) labels over 21 classes, global and samplewise, and on
  (10^6, 10) multilabel scores. W3: binary calibration on 10^6 scores with
  the 16 bin edges among them (count and accuracy bins equal to the CPU's
  bit for bit), multiclass at (10^6, 100); binary and multiclass hinge
  (both modes, squared); coverage error, ranking average precision and
  ranking loss at (2^15, 100). W4: Dice at (10^6, 100) micro and macro, and
  samplewise on (10^4, 100, 100) scores. No reference dispatch; every
  state against the CPU's and every value within (V_RTOL, V_ATOL); ms and
  device µs an update and the idle share of each metric.
- Phase X drives the rest of regression, pairwise and retrieval (plain
  torch, no hand kernel). X1: ``PearsonCorrCoef``, ``ConcordanceCorrCoef``,
  ``R2Score(adjusted=5)`` and ``ExplainedVariance`` over 4 updates of 10^6
  scalar pairs and their (10^6, 8) forms; Pearson merged from two halves
  through the stacked ``_final_aggregation`` equals one metric fed the whole
  (rtol 1e-4, atol 1e-5). X2: ``CosineSimilarity`` on (2^16, 512) in two
  batches, ``KLDivergence`` on (2^16, 1000) probabilities and
  log-probabilities, ``TweedieDevianceScore`` at powers 0, 1, 1.5, 2 and 3
  on 10^6 values, ``SpearmanCorrCoef`` on 10^6 tied values (ranks equal to
  the CPU's bit for bit), ``KendallRankCorrCoef`` variants a, b and c with
  ``t_test`` at N = 2^15 on the card (on its first 2^12 pairs, the CPU
  grid's cost, pair counts equal to the CPU's exactly and values against
  the CPU's).
  X3: the four pairwise functionals on (4096, 512) x (4096, 512) and in
  self mode (diagonal 0), manhattan on (2048, 256) x (2048, 256); linear and
  manhattan within atol 1e-4 (sums of 256-512 products in another order).
  X4: the ten retrieval classes over 4 updates of 10^4 queries x 100
  candidates (scores on 64 levels, about 5% of queries without a positive),
  "pos" and "skip" beside "neg", ``ignore_index``, nDCG on graded targets;
  "error" raises on the card. X5: K6's traffic shape (batch-1 requests, 8
  tenants, buckets (64, 256), capacity 8, 4 threads, 2000 requests) serving
  ``R2Score``, ``PearsonCorrCoef``, ``ExplainedVariance`` and
  ``TweedieDevianceScore`` over X1's rows: 2 captures and only replays, no
  eager fallback, each tenant's state against a CPU fold of its requests in
  receipt order (each thread owns its tenants), req/s beside per-request
  updates. Every op of an X1-X4 update or compute on the card returns card
  tensors (checked under a ``TorchDispatchMode``); every state and value
  against the port on the CPU within (V_RTOL, V_ATOL) unless stated; ms of
  the call that does each form's work (its update, or for list states the
  compute), and device µs and idle share of one form of each metric, whose
  profile must hold device kernels.
- Phase Y drives the wrappers and the image metrics that need no network.
  Y1: ``BootStrapper`` over the hand kernels, 10 updates of bench.py's
  step (1024 int64 labels, 1000 classes; predictions equal to the targets at
  rate 0.7): ``MulticlassAccuracy(average="micro")`` with 20 copies and
  ``MulticlassConfusionMatrix`` with 8, multinomial, seed 0;
  ``BinaryAUROC(thresholds=200)`` with 10 copies over 2 updates of 10^6
  scores; ``QuantileSketch`` with 4 copies on 2^20 lognormal values; a
  Poisson ``MulticlassF1Score`` with 10 copies. ``_use_vmap`` stays True on
  every multinomial form (False on the Poisson one); each update launches,
  counted by this thread's tally, exactly the stat-score, table,
  ``binned_curve`` or ``hist_add`` kernel once a copy (twice for the
  sketch's two stores), the Poisson form once a copy a chunk span of its
  draw; the stacked count states equal, ``torch.equal`` row by row, the
  port's copies path on the CPU with the same seed and batches (AUROC: the
  first 2 copies, recomputed from the generator's rows, whose raw AUROC
  values are compared too); ``mean``, ``std``, ``quantile`` (0.95) and
  ``raw`` within (V_RTOL, V_ATOL). Y2: ``ClasswiseWrapper(MulticlassAccuracy
  (1000, average=None))`` beside ``MulticlassF1Score`` in a collection: the
  wrapper registers no states, so it is a compute group of its own in both
  packages, 2 stat-score launches an update against 1 (after the forming
  update) unwrapped; ``MinMaxMetric(MulticlassF1Score(1000))`` over 10
  forwards; ``MetricTracker`` over accuracy and F1 (compute groups on) for
  3 increments of 5 updates, saved with ``ckpt.save`` after the second,
  restored into a fresh tracker on the card, its ``compute_all`` and
  ``best_metric`` equal to the uninterrupted run's; ``MultioutputWrapper(
  MeanSquaredError(), 8)`` on (10^6, 8) with 1% NaN rows dropped. Y3: SSIM
  and UQI on (16, 3, 512, 512) (gaussian, sigma 1.5), MS-SSIM on (8, 3, 256,
  256), 3-D SSIM on (2, 1, 64, 128, 128), PSNR on (16, 3, 512, 512) with
  ``data_range=None`` and with ``dim=(1, 2, 3)``, ERGAS and SAM on (16, 8,
  256, 256), D-lambda on (8, 8, 128, 128), total variation and
  ``image_gradients`` on (16, 3, 512, 512) (gradients equal to the CPU's);
  SSIM, UQI, MS-SSIM and D-lambda are compared with the CPU on their first
  2 images (the CPU's banded products at full width would take seconds
  each), within rtol 1e-6 and atol 2e-5 (their variances cancel), the rest
  on the whole batch within (V_RTOL, V_ATOL) (SAM: atol 2e-5, an arccos of
  a cosine near 1, float32 within 6e-6 of float64 on each device). Every op of a Y update or
  compute on the card returns card tensors (the ``TorchDispatchMode`` of
  Phase X), but for ``BootStrapper``'s resample indices, drawn on the host
  by numpy as in the JAX package, which enter as one CPU tensor an update
  (a Poisson chunk) and are copied to the card; ms an update, device µs and
  idle share of each form.
- Phase Z drives the image metrics with a network and audio at the sizes
  users score, with the port's seeded random weights. Z1: InceptionV3 on 2
  updates of 64 real and 64 fake uint8 images at 299 x 299 and one of 64
  at 512 x 512 (resized down, antialiased), its 2048 tap and
  ``logits_unbiased`` on the first 2 images of a 299 and the 512 batch
  against the CPU's network within rtol 1e-4 of the tap's scale;
  ``FrechetInceptionDistance`` at the 2048 and the 64 tap with both square
  roots (scipy's on the host, Newton-Schulz on the card), each side topped
  up to 2176 images (more than 2048 features), ``KernelInceptionDistance``
  (10 subsets of 100) and ``InceptionScore`` (10 splits); every metric's
  states carried to a CPU twin whose compute the card's must match (KID and
  IS under one numpy seed; FID's tolerance adds 4 times the CPU twin's
  distance from a float64 value of the same states: at the 2048 tap the
  random net leaves the covariance product nearly singular, and
  Newton-Schulz diverges there to NaN in both packages, the card's NaN
  where the CPU's is). Z2: LPIPS with the alex, vgg and squeeze nets on
  (16, 3, 256, 256) pairs, the first 2 against the CPU within rtol 1e-4.
  Z3: SDR (filter 512), SI-SDR, SNR and SI-SNR on (8, 2, 64000), 4 s at
  16 kHz; PIT over SI-SDR with 3 speakers on (8, 3, 32000) by the
  exhaustive search and by scipy's assignment on the host (the same best
  permutations, which undo the draw); STOI and ESTOI on (8, 48000) at 16
  kHz with a silent lead-in; every value against the CPU on the whole
  batch (atol 1e-4); ``SignalDistortionRatio``'s update under
  ``torch.cuda.set_sync_debug_mode("error")``, so a host sync in it raises.
  Z4: K6's traffic shape serving ``SignalNoiseRatio``,
  ``ScaleInvariantSignalNoiseRatio``, ``ScaleInvariantSignalDistortionRatio``
  and ``SignalDistortionRatio`` (filter 128) on rows of 4000 samples, as X5
  does; SDR's batched ``solve_ex`` is captured in the graph or the engine
  demotes the metric at its first capture, and the record says which. Every
  op of a Z update or compute on the card returns card tensors, but for
  KID's and IS's numpy permutations, PIT's permutation table, STOI's
  constant tables and the host steps of scipy's square root and assignment,
  which enter or leave as CPU tensors; ms an update, device µs and idle
  share of each form (device µs count overlapping kernels once).
  Depth cut for the time limit (a whole run must end within 1200 s on the
  slowest host seen, about 1.5x the fastest, where a whole run with Phase V
  took 1104.6 s before the cuts marked "before Phase V"; the depths before
  Phases T and U came in brackets): Phase E 2 batches of 2^22 values and 2 of the heavy
  hitters' ([8, 4]) of 2^16 ids (2^17 before Phase Z), Phase H 2 updates ([8]), K's profiled windows 500
  requests ([1000]), K2 1000 ([4000]), M1 (on disk and in /dev/shm), N1,
  O1 and P1 1 pair (the JAX benchmarks' 6; [4]), N2 3 guarded and 1 unguarded pair (5 and 2), M2 500
  flagship and 1000 quantile requests ([2000, 4000]; 1000 and 2000 before Phase V), P3 segments of 64
  and 192 requests (384 and 1024; [192, 512]; 128 and 384 before Phase V), Q 6 steps ([20]; 10 before Phase V), Q3 4000
  requests ([8000]), R1, R2
  and S3 1 pair (6; [2, 2, 3]), R3 250 requests (8000; [2000]; 500 before Phase V), R4 256
  ([512]); S1 and S2 serve with buckets (64,) (the engine's six-rung
  default there: one capture an engine, not six); T1 48 + 48 writes around
  the death (64 + 64 before Phase V) and U1 64 + 48, T2 and U3 1 pair (6 there), U4 1 pair (4); V2 1 healed /
  hand-balanced pair (2 there), V3 1 quiet pair (6 there); X Kendall's CPU grid 2^12 (2^15 in its first run),
  one profiled form a metric (every form in its first runs: X took 44.3-56.5 s alone).

The second-to-last line of output is a JSON object with one record per
kernel (``shapes`` lists every shape or route a kernel was timed at); the
last is ``{"ok": true, "device": {...}}``. Any failure raises, and the script
exits non-zero without those lines. Without a GPU it exits
non-zero at once. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores, taken for int32 ALU work
FLAGSHIP_STEPS = 20
TIMING_REPS = 5
SKETCH_BATCH = 2**22  # values per sketch update in Phases E and F
SKETCH_BATCHES = 2
HH_BATCH = 2**16  # ids per heavy-hitter update: the CPU recomputation walks them one at a time (plain version)
HH_BATCHES = 2  # the CPU recomputation walks 3 batches (the stream, then its second half), about 45 us an item
WALK_SHAPES = (4096, HH_BATCH, SKETCH_BATCH)  # ids per ledger walk timed in Phase F
WALK_FIELDS = ("us_per_item", "device_ms_by_kernel", "raises", "evictions", "sequential_chunks", "chunks",
               "snapshot_items", "eviction_bound_ms", "snapshot_bound_ms", "table_bound_ms")
# Integer instructions per (id, row) of the count-min hash from ids (csrc/cm_hash.cuh) at a
# power-of-two width: the xor with the row seed, three shift-xor steps (2 each), two
# multiplies, the modulo (a mask) and the add into the table.
CM_HASH_OPS = 1 + 3 * 2 + 2 + 1 + 1
# The fewest dependent cycles one eviction of the ledger walk needs (csrc/cms_walk.cu): an
# eviction reads the ledger the one before it wrote, so the count compare
# (ISETP), the warp vote that finds the first slot at the minimum (VOTE) and the select that
# writes the slot follow one another: 3 dependent instructions, at least 4 cycles each (the
# shortest time from one instruction to a dependent one on the SM's pipes).
WALK_DECISION_CYCLES = 3 * 4
CURVE_N = 10**6  # scores per curve update in Phases G to I
CURVE_T = 200
CURVE_UPDATES = 2
CURVE_COLS = 10
EXACT_N = 2**20
ZIPF_IDS = 10**7
ZIPF_S = 1.1
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
SIX_N = 10**6  # labels per update of the six-metric collection (benchmarks/collections_vs_reference.py)
SIX_C = 100
SIX_UPDATES = 8  # timed updates after the one that forms the groups
AGG_N = 2**22  # values per aggregator update in Phase J3
# the compute groups the JAX package forms for the same collections on the CPU
FLAGSHIP_GROUPS = {0: ["accuracy", "f1"], 1: ["confmat"]}
SIX_GROUPS_BUILT = {0: ["acc"], 1: ["cm"], 2: ["f1"], 3: ["prec", "rec", "spec"]}
SIX_GROUPS = {0: ["acc", "f1", "prec", "rec", "spec"], 1: ["cm"]}
ROUTES = ("stat_scores", "pair_count")  # the two routes of csrc/pair_count.cu, as launch counts name them


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _time_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _pair_count_cases():
    """(name, N, rows, cols, label range, row / col dtype, ignore_index, masked, storage offset,
    high) of the Phase A table-route cases; ``high`` adds multiples of 2^31 to int64 labels."""
    i32, i64 = "int32", "int64"
    return [
        ("train_step", 1024, 1000, 1000, (0, 1000), i64, i64, None, False, 0, False),  # main path, global
        ("train_step_int32", 1024, 1000, 1000, (0, 1000), i32, i32, None, False, 0, False),
        ("six_metric_update", SIX_N, SIX_C, SIX_C, (0, SIX_C), i64, i64, None, False, 0, False),  # J2, shared
        ("six_metric_update_int32", SIX_N, SIX_C, SIX_C, (0, SIX_C), i32, i32, None, False, 0, False),
        ("shared_1M_ignore", 2**20, 100, 100, (-5, 105), i64, i64, 7, False, 0, False),
        ("ragged", 4097, 7, 23, (0, 23), i32, i32, None, False, 0, False),
        ("classes_2", 100003, 2, 2, (0, 2), i64, i64, None, False, 0, False),
        ("mixed_types", 65541, 50, 50, (-2, 52), i32, i64, 3, False, 0, False),
        ("masked", 65539, 50, 50, (0, 50), i32, i32, None, True, 0, False),
        ("masked_ignore_global", 9999, 1000, 1000, (-7, 1007), i64, i64, 5, True, 0, False),
        ("out_of_range", 10000, 20, 20, (-5, 25), i32, i32, None, False, 0, False),
        ("ignore_minus_one", 30001, 7, 7, (-3, 10), i64, i64, -1, False, 0, False),
        ("ignore_above", 30001, 7, 7, (-3, 10), i64, i64, 9, False, 0, False),
        ("int64_high_shared", 70001, 100, 100, (0, 100), i64, i64, 3, False, 0, True),
        ("int64_high_global", 70001, 1000, 1000, (0, 1000), i64, i64, 3, False, 0, True),
        ("offset_shared", 2**20 + 3, 100, 100, (0, 100), i64, i64, None, False, 1, False),
        ("offset_global", 4099, 1000, 1000, (0, 1000), i64, i32, 11, False, 3, False),
        # shared tables above 48 KB (opt-in dynamic shared memory): 200 x 200 is 160 KB,
        # 241 x 241 the largest square table a block holds on an H100 (227 KB)
        ("shared_200", 2**20, 200, 200, (-3, 203), i64, i64, 17, False, 0, False),
        ("shared_200_int32_masked", 400003, 200, 200, (0, 200), i32, i32, None, True, 0, False),
        ("shared_241_offset", 2**19 + 1, 241, 241, (0, 241), i64, i64, 5, False, 1, False),
        ("n_1", 1, 7, 7, (0, 7), i64, i64, None, False, 0, False),
        ("empty", 0, 5, 5, (0, 5), i32, i32, None, False, 0, False),
    ]


def _stat_score_cases():
    """(name, N, classes, label range, target / preds dtype, ignore_index, storage offset, high)
    of the Phase A stat-score cases."""
    i32, i64 = "int32", "int64"
    return [
        ("train_step", 1024, 1000, (0, 1000), i64, i64, None, 0, False),  # main path: argmax + target
        ("train_step_int32", 1024, 1000, (0, 1000), i32, i32, None, 0, False),
        ("six_metric_update", SIX_N, SIX_C, (0, SIX_C), i64, i64, None, 0, False),  # J2
        ("six_metric_update_int32", SIX_N, SIX_C, (0, SIX_C), i32, i32, None, 0, False),
        ("classes_2", 100003, 2, (0, 2), i64, i64, None, 0, False),
        ("classes_7_ignore", 4097, 7, (-2, 9), i64, i64, 3, 0, False),
        ("classes_100_ignore_minus_one", 70001, 100, (-3, 103), i64, i64, -1, 0, False),
        ("classes_100_ignore_above", 70001, 100, (-3, 103), i64, i64, 100, 0, False),
        ("mixed_types", 65541, 50, (0, 50), i32, i64, 7, 0, False),
        ("int64_high", 70001, 7, (0, 7), i64, i64, 3, 0, True),
        ("offset", 2**20 + 3, 100, (0, 100), i64, i64, 5, 1, False),
        ("offset_int32", 4099, 1000, (0, 1000), i32, i32, None, 3, False),
        # shared counters above 48 KB (opt-in dynamic shared memory): 96 KB at C = 8000, and the
        # largest C whose 3 * C counters a block holds on an H100 (227 KB)
        ("shared_8000", 2**20, 8000, (-2, 8002), i64, i64, 17, 0, False),
        ("shared_8000_int32_offset", 300001, 8000, (0, 8000), i32, i32, None, 3, False),
        ("shared_19370", 2**20, 19370, (0, 19370), i64, i64, None, 0, False),
        ("global_counters", 2**20, 20000, (0, 20000), i64, i64, 17, 0, False),  # 3 * C * 4 B > shared memory
        ("n_1", 1, 7, (0, 7), i64, i64, None, 0, False),
        ("empty", 0, 5, (0, 5), i64, i64, None, 0, False),
    ]


def _labels(torch, gen, n: int, lo: int, hi: int, dtype: str, offset: int = 0, high: bool = False, like=None):
    """n labels in [lo, hi) on the card, a view at ``offset`` into its storage; ``high`` adds
    0, 1, 2 or 3 times 2^31 (int64); ``like``: copy that many of them (a diagonal share)."""
    x = torch.randint(lo, hi, (n + offset,), generator=gen)
    if like is not None:
        x[offset:] = torch.where(torch.rand(n, generator=gen) < 0.3, like, x[offset:])
    if high:
        x = x + torch.randint(0, 4, (n + offset,), generator=gen) * 2**31
    return x.to(getattr(torch, dtype)).cuda()[offset:]


def phase_a(torch, confmat) -> dict:
    """Every case of both routes of csrc/pair_count.cu: kernel vs plain version on the same CUDA inputs."""
    gen = torch.Generator().manual_seed(1234)
    worst = {"pair_count": 0, "stat_scores": 0}

    def err(got, want) -> int:
        return int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0

    for name, n, rows, cols, (lo, hi), rt, ct, ignore, masked, offset, high in _pair_count_cases():
        r = _labels(torch, gen, n, lo, hi, rt, offset, high)
        c = _labels(torch, gen, n, lo, hi, ct, offset, high)
        m = torch.randint(0, 2, (n,), generator=gen).bool().cuda() if masked else None
        shared = confmat.uses_shared_branch(rows, cols)
        want = confmat.pair_count_bincount(r, c, rows, cols, m, ignore)
        before = confmat.launches
        got = confmat.pair_count_cuda(r, c, rows, cols, m, ignore)
        torch.cuda.synchronize()
        _check(got.dtype == torch.int32 and got.shape == (rows, cols), f"{name}: {got.dtype} {tuple(got.shape)}")
        worst["pair_count"] = max(worst["pair_count"], err(got, want))
        _check(torch.equal(got, want), f"{name}: kernel differs from pair_count_bincount")
        _check(confmat.launches == before + (1 if n else 0), f"{name}: launch count")
        branch = "none (N = 0)" if n == 0 else ("shared" if shared else "global")
        aligned = r.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0
        print(f"phase A pair_count {name}: N={n} R={rows} C={cols} {rt}/{ct} ignore_index={ignore} mask={masked} "
              f"offset={offset} 16-byte loads={aligned} branch={branch} equal=True total={int(want.sum())}")
    _check(not confmat.uses_shared_branch(1000, 1000), "1000x1000 must take the global-atomic branch")
    _check(confmat.uses_shared_branch(100, 100), "100x100 must take the shared-memory branch")
    _check(confmat.uses_shared_branch(241, 241), "241x241 must take the shared-memory branch")

    for name, n, classes, (lo, hi), tt, pt, ignore, offset, high in _stat_score_cases():
        t = _labels(torch, gen, n, lo, hi, tt, offset, high)
        p = _labels(torch, gen, n, lo, hi, pt, offset, high, like=t.cpu().to(torch.int64))
        want = confmat.stat_scores_bincount(t, p, classes, ignore)
        before = confmat.stat_score_launches
        got = confmat.stat_scores_cuda(t, p, classes, ignore)
        torch.cuda.synchronize()
        for what, g, w in zip(("tp", "fp", "tn", "fn"), got, want):
            _check(g.dtype == torch.int32 and g.shape == (classes,), f"{name}.{what}: {g.dtype} {tuple(g.shape)}")
            worst["stat_scores"] = max(worst["stat_scores"], err(g, w))
            _check(torch.equal(g, w), f"{name}.{what}: kernel differs from stat_scores_bincount")
        _check(confmat.stat_score_launches == before + (1 if n else 0), f"{name}: launch count")
        branch = "none (N = 0)" if n == 0 else ("shared" if confmat.stat_scores_uses_shared(classes) else "global")
        n_valid = int(sum(x[0] for x in want))  # tp + fp + tn + fn of any class
        print(f"phase A stat_scores {name}: N={n} C={classes} {tt}/{pt} ignore_index={ignore} offset={offset} "
              f"branch={branch} equal=True tp={int(want[0].sum())} valid={n_valid}")
    _check(confmat.stat_scores_uses_shared(1000) and confmat.stat_scores_uses_shared(19370)
           and not confmat.stat_scores_uses_shared(20000), "stat-score branches")
    return worst


_ZIPF_CDF = {}


def _zipf(torch, n: int, gen, n_ids: int = ZIPF_IDS, s: float = ZIPF_S):
    """``n`` int32 ids in ``[0, n_ids)`` with P(id = k) proportional to (k + 1)^-s,
    drawn on the card by inverse CDF from the seeded generator ``gen``."""
    key = (n_ids, s)
    if key not in _ZIPF_CDF:
        cdf = torch.cumsum(torch.arange(1, n_ids + 1, device="cuda", dtype=torch.float64).pow(-s), 0)
        _ZIPF_CDF[key] = cdf / cdf[-1]
    u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
    return torch.searchsorted(_ZIPF_CDF[key], u).clamp_(max=n_ids - 1).to(torch.int32)


def _scatter_values(torch, kind: str, n: int, gen):
    if kind == "01":
        return torch.randint(0, 2, (n,), generator=gen, device="cuda", dtype=torch.int32)
    if kind == "rank":
        return torch.randint(1, 22, (n,), generator=gen, device="cuda", dtype=torch.int32)
    if kind == "signed":
        return torch.randint(-3, 4, (n,), generator=gen, device="cuda", dtype=torch.int32)
    if kind == "zero":
        return torch.zeros(n, dtype=torch.int32, device="cuda")
    choices = torch.tensor([INT32_MIN, INT32_MAX, -7, 0, 9], dtype=torch.int32, device="cuda")  # "extremes"
    return choices[torch.randint(0, 5, (n,), generator=gen, device="cuda")]


def _scatter_hist_cases():
    """(name, op, N, bins, index range or "zipf", values) of the Phase A scatter cases."""
    return [
        ("ddsketch_2048", "add", SKETCH_BATCH, 2048, (-3, 2051), "01"),  # Phase E's quantile shape, shared
        ("hll_p12", "max", SKETCH_BATCH, 2**12, (0, 2**12), "rank"),  # Phase E's p = 12, shared
        ("hll_p14_ragged", "max", 2**20 + 7, 2**14, (0, 2**14), "rank"),  # 64 KB: dynamic shared memory
        ("hll_p16", "max", SKETCH_BATCH, 2**16, (0, 2**16), "rank"),  # 256 KB: the packed branch
        ("add_ragged_global", "add", 4097, 2**16, (-5, 2**16 + 5), "01"),
        ("add_ragged_dynamic_shared", "add", 65537, 2**14, (-5, 2**14 + 5), "signed"),
        ("add_tiny", "add", 5, 2048, (0, 2048), "01"),
        ("max_tiny", "max", 5, 2**16, (0, 2**16), "rank"),
        ("add_empty", "add", 0, 2048, (0, 2048), "01"),
        ("max_empty", "max", 0, 2**16, (0, 2**16), "rank"),
        ("max_out_of_range_extremes", "max", 100000, 100, (-50, 150), "extremes"),
        ("max_extremes_global", "max", 2**20, 2**16, (-9, 2**16 + 9), "extremes"),
        ("add_zero_weights", "add", 2**20, 2**14, (0, 2**14), "zero"),
        ("add_signed_wraparound", "add", 2**20, 64, (0, 64), "signed"),
        ("add_zipf_shared", "add", SKETCH_BATCH, 2048, "zipf", "01"),
        ("max_zipf_global", "max", SKETCH_BATCH, 2**16, "zipf", "rank"),
        # views with a storage offset on the global branch, N % 4 != 0: idx and val at one
        # offset (16-byte loads after a scalar head) and at two (single loads)
        ("max_global_view_offset_1_1", "max", 2**20 + 3, 2**16, (-3, 2**16 + 3), "rank", (1, 1)),
        ("max_global_view_offset_1_2", "max", 2**20 + 5, 2**16, (0, 2**16), "extremes", (1, 2)),
        ("add_global_view_offset_3_3", "add", 2**20 + 1, 2**16, (-3, 2**16 + 3), "signed", (3, 3)),
        ("add_global_view_offset_0_1", "add", 2**20 + 2, 2**16, (0, 2**16), "01", (0, 1)),
        ("max_global_view_offset_tiny", "max", 3, 2**16, (0, 2**16), "rank", (2, 2)),
        ("max_global_view_offset_small_1_1", "max", 40003, 2**16, (-3, 2**16 + 3), "rank", (1, 1)),
        ("add_global_view_offset_small_1_2", "add", 40005, 2**16, (-3, 2**16 + 3), "signed", (1, 2)),
        # 2^17 slots, beyond one block's shared memory and hist_max's packed table: global atomics
        ("max_global_2p17_extremes", "max", 2**20 + 7, 2**17, (-5, 2**17 + 5), "extremes"),
        ("add_global_2p17_zipf", "add", 2**20, 2**17, "zipf", "signed"),
        # packed int16 slots of hist_max: values past int16 go straight to the output
        ("max_packed_extremes", "max", 2**20 + 1, 2**16, (-5, 2**16 + 5), "extremes"),
        # 2^19 slots, beyond 8 blocks' shared memory: global atomics
        ("max_global_2p19", "max", 2**20 + 1, 2**19, (-5, 2**19 + 5), "rank"),
        ("add_global_2p19", "add", 2**20 + 3, 2**19, (-5, 2**19 + 5), "signed"),
    ]


def _cms_cases():
    """(name, N, depth, width, columns) of the Phase A count-min cases."""
    return [
        ("cms_4x2048", SKETCH_BATCH, 4, 2048, "in"),  # Phase E's table, shared
        ("cms_4x65536_ragged", 2**20 + 3, 4, 65536, "in"),  # 1 MB: global atomics
        ("cms_out_of_range_ragged", 4097, 4, 2048, "out"),
        ("cms_tiny", 5, 4, 2048, "in"),
        ("cms_empty", 0, 4, 2048, "in"),
        ("cms_zipf_shared", SKETCH_BATCH, 4, 2048, "zipf"),
        ("cms_zipf_global", 2**20, 4, 65536, "zipf"),
    ]


def _cms_ids_cases():
    """(name, N, depth, width, ids, storage offset) of the Phase A cases of the ids route of
    cms_rows_add: the count-min shapes of ``_cms_cases``, then negative ids with the int32
    extremes, widths that are no power of two (the modulo, shared and global) and a view at a
    storage offset (a scalar head before the 16-byte loads)."""
    kinds = {"in": "uniform", "out": "negative", "zipf": "zipf"}
    cases = [(f"ids_{name[4:]}", n, depth, width, kinds[cols], 0) for name, n, depth, width, cols in _cms_cases()]
    return cases + [
        ("ids_negative_extremes", 2**20 + 1, 4, 2048, "negative", 0),
        ("ids_width_2047_zipf", SKETCH_BATCH, 4, 2047, "zipf", 0),
        ("ids_width_100003_global", 2**20 + 3, 4, 100003, "zipf", 0),
        ("ids_depth_7_width_1", 4099, 7, 1, "uniform", 0),
        ("ids_view_offset_3", 2**20 + 5, 4, 2048, "zipf", 3),
    ]


def _ids(torch, kind: str, n: int, gen):
    """``n`` int32 ids on the card: Zipf over ZIPF_IDS, uniform over ZIPF_IDS, uniform over 64
    (``few``), one id (``one``), or uniform with 30% negative and the int32 extremes mixed in
    (``negative``)."""
    if kind == "zipf":
        return _zipf(torch, n, gen)
    if kind == "one":
        return torch.full((n,), 12345, dtype=torch.int32, device="cuda")
    ids = torch.randint(0, 64 if kind == "few" else ZIPF_IDS, (n,), generator=gen, device="cuda", dtype=torch.int32)
    if kind == "negative":
        ids = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.3, -ids - 1, ids)
        ids[::1009] = INT32_MIN
        ids[1::1009] = INT32_MAX
    return ids


def phase_a_cms_ids(torch, scatter) -> int:
    """The ids route of cms_rows_add against its plain version on the same CUDA inputs."""
    gen = torch.Generator(device="cuda").manual_seed(8642)
    worst = 0
    for name, n, depth, width, kind, offset in _cms_ids_cases():
        ids = _ids(torch, kind, n + offset, gen)[offset:]
        _check(ids.storage_offset() == offset, f"{name}: view")
        counts = torch.randint(0, 9, (depth, width), generator=gen, device="cuda", dtype=torch.int32)
        before = counts.clone()
        launched = scatter.launches["cms_rows_add"]
        got = scatter.cms_ids_add_cuda(counts, ids)
        torch.cuda.synchronize()
        want = scatter.cms_ids_add_reference(counts, ids)
        _check(got.dtype == torch.int32 and got.shape == want.shape, f"{name}: {got.dtype} {tuple(got.shape)}")
        _check(torch.equal(got, want), f"{name}: the ids route of cms_rows_add differs from its plain version")
        _check(torch.equal(counts, before), f"{name}: the input table was written")
        _check(scatter.launches["cms_rows_add"] == launched + (1 if n else 0), f"{name}: launch count")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, err)
        branch = "none (N = 0)" if n == 0 else scatter.cms_ids_branch(depth, width)
        print(f"phase A {name}: kernel=cms_rows_add (ids route) N={n} table=({depth}, {width}) ids={kind} "
              f"offset={offset} branch={branch} equal=True max_abs_err={err} added={int((got - before).sum())}")
    return worst


def _walk_cases():
    """(name, N, depth, width, k, ids, starting ledger) of the Phase A cases of the ledger walk;
    ids "crafted" and "sweep" are built by ``_crafted_walk`` and ``_sweep_walk``."""
    return [
        ("walk_zipf_2p14", 2**14, 4, 2048, 32, "zipf", "empty"),  # the heavy-hitter sketch's defaults
        ("walk_uniform", 4096, 4, 2048, 32, "uniform", "empty"),
        ("walk_all_one_id", 4096, 4, 2048, 32, "one", "empty"),
        ("walk_negative_ids", 4096, 4, 2048, 32, "negative", "empty"),
        ("walk_ties_at_the_minimum", 4096, 4, 2048, 8, "few", "ties"),
        ("walk_nonempty_ledger", 4096, 4, 2048, 32, "few", "held"),
        ("walk_k1", 4096, 4, 2048, 1, "zipf", "empty"),
        ("walk_k8", 4096, 4, 2048, 8, "zipf", "empty"),
        ("walk_k33_shared_ledger", 4096, 4, 2048, 33, "zipf", "empty"),
        ("walk_k100_shared_ledger", 4096, 4, 2048, 100, "zipf", "held"),
        ("walk_global_table", 4096, 4, 65536, 32, "zipf", "empty"),  # 1 MB: histograms in global memory
        ("walk_width_2047", 4096, 4, 2047, 32, "few", "held"),
        ("walk_global_ledger", 1024, 4, 2048, 40000, "zipf", "held"),  # 320 KB of ledger: global memory
        ("walk_ragged_small_table", 1001, 3, 64, 32, "zipf", "empty"),
        *((f"walk_{name}", 4096, 4, 2048, 32, "crafted", name) for name in WALK_CRAFTED),
        *((f"walk_sweep_k{k}_w{w}_s{s}", 4096, 3 + s, w, k, "sweep", "sweep")
          for k in (1, 8, 32, 33) for w in (7, 2048) for s in (0, 1)),
    ]


WALK_CRAFTED = ("candidate_at_lane_0", "candidate_at_lane_31", "raise_at_the_minimum_before_a_candidate",
                "held_no_ops", "duplicate_and_negative_keys", "wrap_near_2p31")


def _crafted_walk(torch, scatter, name: str, n: int):
    """(counts, ledger, ids) as numpy arrays, built around chunks of 32 on a 4 x 2048 table and a
    k = 32 ledger: a candidate (an id not held, its estimate above every count) at lane 0 or 31
    of chunks 2 and 5 among raises that lift counts; a raise of the slot at the minimum (slot 3)
    at lane 4 of chunk 1 before a candidate at lane 9, which must take slot 7; held keys above
    every estimate; duplicate and negative keys; a table and counts that wrap near 2^31."""
    import numpy as np

    rng = np.random.default_rng(sum(map(ord, name)))
    held = np.arange(5000, 5032, dtype=np.int32)
    new, new2 = 777777, 888888

    def set_cells(counts, ids, value):
        cols = scatter.ids_route_columns(torch.from_numpy(np.asarray(ids, np.int32)), 4, 2048).numpy()
        counts[np.arange(4)[None, :], cols] = value

    counts = np.full((4, 2048), 3, np.int32)
    ledger = np.stack([held, 40 + np.arange(32, dtype=np.int32)], axis=1)
    set_cells(counts, held, 25)
    ids = rng.integers(10**6, 10**6 + 10**5, n).astype(np.int32)  # estimates ~4: no-ops
    if name.startswith("candidate_at_lane"):
        set_cells(counts, [new, new2], 100)
        set_cells(counts, held[:8], 60)
        ids = rng.choice(held[:12], n).astype(np.int32)
        lane = 0 if name.endswith("_0") else 31
        ids[2 * 32 + lane], ids[5 * 32 + lane] = new, new2
    elif name == "raise_at_the_minimum_before_a_candidate":
        ledger[3, 1], ledger[7, 1] = 10, 20
        set_cells(counts, held[3:4], 29)
        set_cells(counts, [new], 100)
        ids[32 + 4], ids[32 + 9] = held[3], new
    elif name == "held_no_ops":
        ledger[:, 1] = 10**6
        ids = rng.choice(np.r_[held, ids[:32]], n).astype(np.int32)
    elif name == "duplicate_and_negative_keys":
        ledger = np.stack([np.full(32, -1, np.int32), np.zeros(32, np.int32)], axis=1)
        ledger[:9] = np.array([[5, 4], [5, 9], [-1, 0], [-7, 3], [9, 1], [5, 2], [INT32_MIN, 5], [12, 0], [9, 7]])
        counts = rng.integers(0, 3, (4, 2048)).astype(np.int32)
        ids = rng.choice(np.array([5, 9, 12, -1, -7, INT32_MIN, 40, 41, 42, 43], np.int32), n)
    elif name == "wrap_near_2p31":
        counts = np.full((4, 2048), INT32_MAX - 40, np.int32)
        ledger = np.stack([np.full(32, -1, np.int32), np.zeros(32, np.int32)], axis=1)
        ledger[:2] = np.array([[3, INT32_MAX], [4, INT32_MAX - 30]])
        ids = (rng.zipf(1.3, n) % 50).astype(np.int32)
    return counts, ledger, ids


def _sweep_walk(name: str, n: int, depth: int, width: int, k: int):
    """(counts, ledger, ids) as numpy arrays: a random start ledger (stream keys, duplicates,
    counts 0-20), a random table, Zipf ids with 10% negative."""
    import numpy as np

    rng = np.random.default_rng(sum(map(ord, name)))
    ids = (rng.zipf(1.2, n) % 200).astype(np.int32)
    ids[rng.random(n) < 0.1] = -2
    m = int(rng.integers(0, k + 1))
    ledger = np.stack([np.full(k, -1, np.int32), np.zeros(k, np.int32)], axis=1)
    ledger[:m, 0], ledger[:m, 1] = rng.choice(ids, m), rng.integers(0, 21, m)
    return rng.integers(0, 6, (depth, width)).astype(np.int32), ledger, ids


def _start_ledger(torch, kind: str, k: int, ids, gen):
    """A (k, 2) int32 ledger on the card: empty, every count 3 (``ties``), or (``held``) some of
    the stream's ids with counts from 0 to 49, one of them twice, and a negative key."""
    keys = torch.full((k,), -1, dtype=torch.int32, device="cuda")
    cnts = torch.zeros(k, dtype=torch.int32, device="cuda")
    if kind == "ties":
        keys = torch.arange(10**6, 10**6 + k, dtype=torch.int32, device="cuda")
        cnts.fill_(3)
    elif kind == "held":
        m = max(1, min(k // 2, ids.numel()))
        keys[:m] = ids[:m]
        cnts[:m] = torch.randint(0, 50, (m,), generator=gen, device="cuda", dtype=torch.int32)
        if k > 2:
            keys[m] = keys[0]
            keys[-1] = -7
            cnts[-1] = 2
    return torch.stack([keys, cnts], dim=1)


def _walk_inputs(torch, scatter, case, gen):
    name, n, depth, width, k, kind, start = case
    if kind in ("crafted", "sweep"):
        arrays = _crafted_walk(torch, scatter, start, n) if kind == "crafted" else _sweep_walk(name, n, depth, width, k)
        return tuple(torch.from_numpy(a).cuda() for a in arrays)
    ids = _ids(torch, kind, n, gen)
    counts = torch.randint(0, 3, (depth, width), generator=gen, device="cuda", dtype=torch.int32)
    return counts, _start_ledger(torch, start, k, ids, gen), ids


def phase_a_walk(torch, scatter, cms_walk) -> int:
    """The ledger walk's kernels against the plain walk on the same CUDA inputs, and their
    counters against the numpy mirror's."""
    gen = torch.Generator(device="cuda").manual_seed(5150)
    worst = 0
    for case in _walk_cases():
        name, n, depth, width, k, kind, start = case
        counts, ledger, ids = _walk_inputs(torch, scatter, case, gen)
        before_counts, before_ledger = counts.clone(), ledger.clone()
        counters = torch.zeros(3, dtype=torch.int64, device="cuda")
        launched = cms_walk.launches
        got = cms_walk.cms_walk_cuda(counts, ledger, ids, counters)
        torch.cuda.synchronize()
        _check(cms_walk.launches == launched + cms_walk.KERNELS, f"{name}: launch count")
        want = cms_walk.cms_walk_reference(counts, ledger, ids)
        for g, w, what in zip(got, want, ("table", "ledger")):
            _check(g.dtype == torch.int32 and g.shape == w.shape, f"{name} {what}: {g.dtype} {tuple(g.shape)}")
            _check(torch.equal(g, w), f"{name}: the walk kernel's {what} differs from the plain walk")
        _check(torch.equal(counts, before_counts) and torch.equal(ledger, before_ledger), f"{name}: inputs written")
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) for g, w in zip(got, want))
        worst = max(worst, err)
        m_counts, m_ledger, mirror = cms_walk.walk_in_chunks(counts.cpu(), ledger.cpu(), ids.cpu())
        _check(torch.equal(m_counts, want[0].cpu()) and torch.equal(m_ledger, want[1].cpu()), f"{name}: mirror")
        if start == "raise_at_the_minimum_before_a_candidate":  # the raise lifted slot 3 first
            _check(int(want[1][7, 0]) == 777777 and int(want[1][3, 0]) == 5003, f"{name}: not the case it names")
        kernel = tuple(counters.tolist())
        _check(kernel == tuple(mirror[:3]), f"{name}: kernel counters {kernel}, mirror {tuple(mirror[:3])}")
        print(f"phase A {name}: kernel=cms_walk N={n} table=({depth}, {width}) k={k} ids={kind} ledger={start} "
              f"placement=({cms_walk.placement(depth, width, k)}) equal=True max_abs_err={err} "
              f"raises={kernel[0]} evictions={kernel[1]} (mirror {mirror.evictions}) sequential_chunks={kernel[2]} "
              f"of {-(-n // cms_walk.CHUNK)}; top ledger count {int(got[1][:, 1].max())}")
    return worst


def phase_a_scatter(torch, scatter) -> dict:
    """Every scatter case: kernel vs plain version on the same CUDA inputs."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    worst = {"hist_add": 0, "hist_max": 0, "cms_rows_add": 0}

    def held(kernel, name, got, want, before, table, n, branch, launched):
        torch.cuda.synchronize()
        _check(got.dtype == torch.int32 and got.shape == want.shape, f"{name}: {got.dtype} {tuple(got.shape)}")
        _check(torch.equal(got, want), f"{name}: {kernel} kernel differs from its plain version")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst[kernel] = max(worst[kernel], err)
        _check(torch.equal(table, before), f"{name}: the input table was written")
        _check(scatter.launches[kernel] == launched + (1 if n else 0), f"{name}: launch count")
        branch = "none (N = 0)" if n == 0 else branch
        print(f"phase A {name}: kernel={kernel} N={n} table={tuple(table.shape)} branch={branch} "
              f"equal=True max_abs_err={err}")

    for name, op, n, n_bins, index, values, *offsets in _scatter_hist_cases():
        kernel = f"hist_{op}"
        off_i, off_v = offsets[0] if offsets else (0, 0)
        if index == "zipf":
            idx = _zipf(torch, n + off_i, gen, n_ids=n_bins)[off_i:]
        else:
            idx = torch.randint(index[0], index[1], (n + off_i,), generator=gen, device="cuda", dtype=torch.int32)
            idx = idx[off_i:]
        vals = _scatter_values(torch, values, n + off_v, gen)[off_v:]
        _check(idx.storage_offset() == off_i and vals.storage_offset() == off_v, f"{name}: views")
        if name == "add_signed_wraparound":
            bins = torch.full((n_bins,), INT32_MAX - 2, dtype=torch.int32, device="cuda")
        elif op == "add":
            bins = torch.randint(0, 50, (n_bins,), generator=gen, device="cuda", dtype=torch.int32)
        else:
            bins = torch.randint(0, 8, (n_bins,), generator=gen, device="cuda", dtype=torch.int32)
            bins[:2] = torch.tensor([INT32_MIN, INT32_MAX], dtype=torch.int32)
        before = bins.clone()
        launched = scatter.launches[kernel]
        wrapper, plain = ((scatter.hist_add_cuda, scatter.hist_add_reference) if op == "add"
                          else (scatter.hist_max_cuda, scatter.hist_max_reference))
        got = wrapper(bins, idx, vals)
        want = plain(bins, idx, vals)
        branch = scatter.hist_branch(kernel, n, n_bins)
        if off_i or off_v:
            branch += f" (views at storage offsets {off_i}, {off_v})"
        held(kernel, name, got, want, before, bins, n, branch, launched)

    for name, n, depth, width, columns in _cms_cases():
        if columns == "zipf":
            cols = _zipf(torch, n * depth, gen, n_ids=width).reshape(n, depth)
        else:
            lo, hi = (0, width) if columns == "in" else (-3, width + 3)
            cols = torch.randint(lo, hi, (n, depth), generator=gen, device="cuda", dtype=torch.int32)
        valid = torch.randint(0, 2, (n,), generator=gen, device="cuda").bool()
        counts = torch.randint(0, 9, (depth, width), generator=gen, device="cuda", dtype=torch.int32)
        before = counts.clone()
        launched = scatter.launches["cms_rows_add"]
        got = scatter.cms_rows_add_cuda(counts, cols, valid)
        want = scatter.cms_rows_add_reference(counts, cols, valid)
        branch = "shared" if scatter.uses_shared_branch(depth * width) else "global"
        held("cms_rows_add", name, got, want, before, counts, n, branch, launched)

    for cells, shared in ((2048, True), (2**12, True), (2**14, True), (2**16, False), (4 * 2048, True),
                          (4 * 65536, False)):
        _check(scatter.uses_shared_branch(cells) == shared, f"a table of {cells} int32 must take the "
               f"{'shared-memory' if shared else 'global-atomic'} branch")
    return worst


def phase_b(torch, confmat, entry_mod):
    """The main path: the fused step at full width, counted and verified."""
    step, (params, states, x, y) = entry_mod.entry(device="cuda", seed=0)
    metrics = step.metrics
    cfg = entry_mod.FULL_CONFIG
    print(f"phase B config: {json.dumps(cfg)} steps={FLAGSHIP_STEPS} (+1 warm-up)")

    # Record the predictions each step hands its metrics, to recompute the
    # states on the CPU afterwards. All three metrics get the same preds.
    seen = []
    spied = metrics["accuracy"]
    update_state = spied.update_state

    def recording_update_state(state, preds, target):
        seen.append((preds.cpu(), target.cpu()))
        return update_state(state, preds, target)

    spied.update_state = recording_update_state

    confmat.launches = confmat.stat_score_launches = 0  # the main path's run starts here
    t0 = time.perf_counter()
    losses = []
    for _ in range(FLAGSHIP_STEPS + 1):
        loss, params, states = step(params, states, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"stat_scores": confmat.stat_score_launches, "pair_count": confmat.launches}  # ... and ends here
    del spied.update_state
    n_steps = FLAGSHIP_STEPS + 1
    print(f"phase B ran {n_steps} steps in {wall:.3f} s; launches {launches}")
    # accuracy and F1 take the stat-score route, the confusion matrix the table route
    _check(launches == {"stat_scores": 2 * n_steps, "pair_count": n_steps},
           f"expected {2 * n_steps} stat-score and {n_steps} table launches, got {launches}")
    losses = torch.stack(losses).cpu()
    _check(bool(torch.isfinite(losses).all()), f"non-finite loss {losses.tolist()}")
    _check(len(seen) == n_steps, "recorded predictions")

    # CPU recomputation through the plain path (bincount pair count)
    cpu_metrics = entry_mod.make_metrics(cfg["classes"], "cpu")
    cpu_states = {name: m.init_state() for name, m in cpu_metrics.items()}
    for preds, target in seen:
        cpu_states = {name: m.update_state(cpu_states[name], preds, target) for name, m in cpu_metrics.items()}
    values = {}
    for name, m in metrics.items():
        for key, want in cpu_states[name].items():
            got = states[name][key].cpu()
            _check(got.dtype == want.dtype == torch.int32, f"{name}.{key} dtype {got.dtype} vs {want.dtype}")
            _check(torch.equal(got, want), f"{name}.{key} differs from the CPU recomputation")
        got_v = m.compute_from(states[name]).cpu()
        want_v = cpu_metrics[name].compute_from(cpu_states[name])
        _check(bool(torch.isfinite(got_v.float()).all()), f"{name} value not finite")
        if name == "f1":  # a float mean over 1000 classes: the card sums in another order
            _check(torch.allclose(got_v, want_v, rtol=1e-6, atol=0), f"f1 {got_v} vs {want_v}")
        else:
            _check(torch.equal(got_v, want_v), f"{name} value {got_v} vs {want_v}")
        values[name] = float(got_v) if got_v.numel() == 1 else int(got_v.sum())
    print(f"phase B states bit-identical to the CPU recomputation; loss first/last "
          f"{float(losses[0]):.6f}/{float(losses[-1]):.6f}; accuracy={values['accuracy']:.6f} "
          f"f1={values['f1']:.6f} confmat total={values['confmat']}")

    # the stateful path, once, on the card and on the CPU
    preds, target = seen[-1]
    for name in metrics:
        results = []
        for device in ("cuda", "cpu"):
            metric = entry_mod.make_metrics(cfg["classes"], device)[name]
            p, t = preds.to(device), target.to(device)
            metric.update(p, t)
            batch_value = metric.forward(p, t)
            total = metric.compute()
            metric.reset()
            _check(metric.update_count == 0 and not metric.update_called, f"reset of {name} on {device}")
            results.append((batch_value.cpu().float(), total.cpu().float()))
        (card_batch, card_total), (host_batch, host_total) = results
        _check(torch.allclose(card_batch, host_batch, rtol=1e-6, atol=0), f"stateful forward of {name}")
        _check(torch.allclose(card_total, host_total, rtol=1e-6, atol=0), f"stateful compute of {name}")
    print("phase B stateful update/forward/compute/reset on the card agree with the CPU")
    return launches, (params, states, x, y), step


def phase_c_steps(torch, entry_mod, step, args):
    """Bare vs fused step time, interleaved repetitions, minimum of each."""
    params, states, x, y = args
    bare, fused = [], []

    def run_bare():
        nonlocal params
        params, _, _ = entry_mod.sgd_step(params, x, y)

    def run_fused():
        nonlocal params, states
        _, params, states = step(params, states, x, y)

    for _ in range(TIMING_REPS):
        bare.append(_time_ms(run_bare, FLAGSHIP_STEPS, warmup=1))
        fused.append(_time_ms(run_fused, FLAGSHIP_STEPS, warmup=1))
    t_bare, t_fused = min(bare), min(fused)
    overhead = (t_fused - t_bare) / t_bare * 100.0
    print(f"phase C step: bare_ms={t_bare} fused_ms={t_fused} overhead_pct={overhead} "
          f"(min of {TIMING_REPS} reps x {FLAGSHIP_STEPS} steps; bare reps {bare}; fused reps {fused})")
    return {"bare_ms": t_bare, "fused_ms": t_fused, "overhead_pct": overhead}


def _bound(nbytes: int, ops: int, ops_per_s: float = CUDA_CORE_OPS_PER_S):
    """(ms, "bytes" or "operations"): the larger of the bytes over the memory rate and the operations
    over ``ops_per_s``."""
    return max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), (ops / ops_per_s * 1e3, "operations"))


def phase_c_kernel(torch, confmat, n: int, classes: int) -> dict:
    """Both routes of csrc/pair_count.cu at one shape, on int64 labels as the main path hands
    them over: call time, device time, plain version, torch.bincount of the pair keys (the
    library call), bound."""
    gen = torch.Generator().manual_seed(99)
    t = torch.randint(0, classes, (n,), generator=gen).cuda()
    p = torch.randint(0, classes, (n,), generator=gen).cuda()
    key = t * classes + p
    iters = 200
    library_ms = _time_ms(lambda: torch.bincount(key, minlength=classes * classes + 1), iters)
    recs = {}
    routes = {
        # two int64 label streams read, the int32 table written; per pair two range compares, a key, an add
        "pair_count": (lambda: confmat.pair_count_cuda(t, p, classes, classes),
                       lambda: confmat.pair_count_bincount(t, p, classes, classes),
                       "pair_count_", 16 * n + 4 * classes * classes, 4 * n),
        # two int64 label streams read, four int32 (C,) counts written; per pair two range compares,
        # the hit compare, one or two adds
        "stat_scores": (lambda: confmat.stat_scores_cuda(t, p, classes),
                        lambda: confmat.stat_scores_bincount(t, p, classes),
                        "stat_scores_kernel", 16 * n + 16 * classes, 4 * n),
    }
    for route, (run, plain, match, nbytes, ops) in routes.items():
        bound_ms, bound_by = _bound(nbytes, ops)
        recs[route] = rec = {
            "n": n, "rows": classes, "cols": classes, "label_dtype": "int64", "ms": _time_ms(run, iters),
            "device_ms": _per_call_ms(_call_kernels(torch, run, match, 1)),
            "plain_ms": _time_ms(plain, iters), "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops}
        print(f"phase C {route} {json.dumps(rec)}")
    return recs


def _per_call_ms(kernels: dict):
    """Device ms of one wrapper call from ``{kernel name: [µs of each recorded
    launch]}``: every kernel a call launches runs once per call, and the
    profiler may miss the first launches of a window, so each kernel counts
    its mean over the launches it recorded."""
    return sum(sum(v) / len(v) for v in kernels.values()) / 1e3 if kernels else None


def _call_kernels(torch, run, match: str, per_call: int, calls: int = 20, tries: int = 3) -> dict:
    """``{kernel name: [µs of each recorded launch]}`` of the ``per_call`` kernels
    (names holding ``match``) that one call of ``run`` launches, over ``calls``
    calls under the profiler. The profiler sometimes records few or none of a
    window's launches, so a window that lacks a kernel or holds fewer than half
    of its launches is profiled again, up to ``tries`` times; ``{}`` (not
    measured) if none is whole."""
    for _ in range(tries):
        kernels, _ = _profile_steps(torch, run, calls)
        mine = {name: v for name, v in kernels.items() if match in name}
        if len(mine) == per_call and all(2 * len(v) >= calls for v in mine.values()):
            return mine
    return {}


def _profiler_lead_in(torch) -> None:
    """A few tiny kernels at the start of a profiled window, finished before the
    work it measures. Without them whole runs of this script have lost Q1's
    first 2 stat-score records in every profiled session while the states
    stayed exact; with them, at most 1 in a run's first session. A 50 ms
    pause of the idle card in their place changed nothing, so the loss is of
    a session's first records, not of early time stamps (PERF.md §6). Their
    names match no hand kernel's."""
    x = torch.zeros(8, device="cuda")
    for _ in range(4):
        x.add_(1)
    torch.cuda.synchronize()


def _warm_profile(torch, run) -> dict:
    """``_kernel_times`` of ``run()`` profiled in the active cycle of a profiler
    session whose first cycle, a warm-up running ``run()`` too, is recorded
    and discarded (``torch.profiler.schedule(warmup=1)``). Q1's sessions have
    lost their first replay's two stat-score records in every session of a
    whole run, with the lead-in and without it: the records lost are a
    session's first graph-node records, and the warm-up cycle takes them."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cycles = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: cycles.append(_kernel_times(p, torch))) as prof:
        run()
        prof.step()
        run()
        prof.step()
    return cycles[-1]


def _kernel_times(prof, torch):
    """``{kernel name: [device µs of each launch]}`` from a profile."""
    out = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out.setdefault(evt.name, []).append(evt.time_range.elapsed_us())
    return out


def _profile_steps(torch, run, iters: int):
    """``(kernel times, wall µs)`` of ``iters`` calls of ``run`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _kernel_times(prof, torch), wall_us


def phase_d_profile(torch, entry_mod, step, args, iters: int = 5):
    """Device time by kernel: the bare step, the fused step, then its metric updates alone."""
    params, states, x, y = args

    def run_bare():
        nonlocal params
        params, _, _ = entry_mod.sgd_step(params, x, y)

    def run_fused():
        nonlocal params, states
        _, params, states = step(params, states, x, y)

    bare_kernels, bare_wall_us = _profile_steps(torch, run_bare, iters)
    step_kernels, wall_us = _profile_steps(torch, run_fused, iters)
    if not step_kernels:
        print("phase D: the profiler recorded no device time: not measured")
        return None
    bare_busy_us = sum(sum(v) for v in bare_kernels.values())
    busy_us = sum(sum(v) for v in step_kernels.values())

    logits = entry_mod.forward(params, x, y)[1]

    def run_metrics():
        nonlocal states
        preds = torch.argmax(logits, dim=-1)
        states = {name: m.update_state(states[name], preds, y) for name, m in step.metrics.items()}

    metric_kernels, _ = _profile_steps(torch, run_metrics, iters)
    pair = [us for name, v in metric_kernels.items() if "pair_count_" in name for us in v]
    stat = [us for name, v in metric_kernels.items() if "stat_scores_kernel" in name for us in v]
    top = sorted(metric_kernels.items(), key=lambda kv: -sum(kv[1]))[:12]
    # the stat-score route replaced the int64 sums of the (C, C) table and the casts around them
    long_sums = [name for name in metric_kernels if "ReduceOp<long" in name]
    _check(not long_sums, f"int64 reductions left in the metric updates: {long_sums}")
    rec = {
        "bare_step_device_busy_us": bare_busy_us / iters,
        "bare_step_wall_us_under_profiler": bare_wall_us / iters,
        "bare_step_idle_share": 1.0 - bare_busy_us / bare_wall_us,
        "step_device_busy_us": busy_us / iters,
        "step_wall_us_under_profiler": wall_us / iters,
        "step_idle_share": 1.0 - busy_us / wall_us,
        "metric_device_us_per_step": sum(sum(v) for v in metric_kernels.values()) / iters,
        "metric_kernel_launches_per_step": sum(len(v) for v in metric_kernels.values()) / iters,
        "pair_count_device_us_per_launch": sum(pair) / len(pair) if pair else None,
        "pair_count_launches_profiled": len(pair),
        "stat_scores_device_us_per_launch": sum(stat) / len(stat) if stat else None,
        "stat_scores_launches_profiled": len(stat),
        "metric_top_kernels": [
            {"name": name[:90], "launches_per_step": len(v) / iters, "us_per_step": sum(v) / iters} for name, v in top
        ],
        "step_top_kernels": [
            {"name": name[:90], "launches_per_step": len(v) / iters, "us_per_step": sum(v) / iters}
            for name, v in sorted(step_kernels.items(), key=lambda kv: -sum(kv[1]))[:8]
        ],
    }
    print(f"phase D profile {json.dumps(rec)}")
    return rec


ENTRY_OF = {"hist_add": "ddsketch_hist_add", "hist_max": "hll_scatter_max", "cms_rows_add": "cms_row_scatter"}


def _zero_launches(scatter, cms_walk) -> None:
    for k in scatter.launches:
        scatter.launches[k] = 0
    cms_walk.launches = 0


def _launch_counts(scatter, cms_walk) -> dict:
    return {**scatter.launches, "cms_walk": cms_walk.launches}


def _latencies(torch, gen, n: int):
    """Lognormal latencies with 1% exact zeros, 2% negated, and NaN, +inf and
    -inf every million values."""
    v = torch.empty(n, device="cuda").log_normal_(1.0, 1.5, generator=gen)
    u = torch.rand(n, device="cuda", generator=gen)
    v = torch.where(u < 0.01, 0.0, torch.where(u < 0.03, -v, v))
    v[::1_000_003] = math.nan
    v[1::1_000_003] = math.inf
    v[2::1_000_003] = -math.inf
    return v


def _equal_states(torch, a: dict, b: dict, what: str) -> None:
    for key in a:
        x, y = torch.as_tensor(a[key]).cpu(), torch.as_tensor(b[key]).cpu()
        _check(x.dtype == y.dtype and torch.equal(x, y), f"{what}: state {key!r} differs")


def _fold(init, update, batches):
    state = init()
    for b in batches:
        state = update(state, b)
    return state


def phase_e(torch, scatter, cms_walk, obs, instrument):
    """The sketch plane at the JAX classes' default sizes, counted and verified."""
    from metrics_tpu_torch.sketch import CardinalitySketch, HeavyHittersSketch, QuantileSketch
    from metrics_tpu_torch.sketch import kernels as sk

    gen = torch.Generator(device="cuda").manual_seed(2024)
    lat = [_latencies(torch, gen, SKETCH_BATCH) for _ in range(SKETCH_BATCHES)]
    ids = [_zipf(torch, SKETCH_BATCH, gen) for _ in range(SKETCH_BATCHES)]
    hh_ids = [_zipf(torch, HH_BATCH, gen) for _ in range(HH_BATCHES)]
    torch.cuda.synchronize()
    print(f"phase E data: {SKETCH_BATCHES} batches of {SKETCH_BATCH} lognormal latencies (1% zeros, 2% negative, "
          f"NaN/+inf/-inf) and of Zipf({ZIPF_S}) int32 ids over {ZIPF_IDS}; heavy hitters {HH_BATCHES} x {HH_BATCH} ids")

    def table_zeros():
        return torch.zeros((4, 2048), dtype=torch.int32, device="cuda")

    q = QuantileSketch(alpha=0.01, n_buckets=2048, device="cuda")
    c12, c16 = CardinalitySketch(p=12, device="cuda"), CardinalitySketch(p=16, device="cuda")
    hh = HeavyHittersSketch(k=32, depth=4, width=2048, device="cuda")
    # name: (init, update, merge, batches, launches per update, registry dispatches per update);
    # the count-min table takes the ids route of cms_rows_add and the heavy hitters the walk
    # kernel, neither through the registry
    paths = {
        "quantile": (q.init_state, q.update_state, q.merge_states, lat, {"hist_add": 2}, {"ddsketch_hist_add": 2}),
        "cardinality_p12": (c12.init_state, c12.update_state, c12.merge_states, ids, {"hist_max": 1},
                            {"hll_scatter_max": 1}),
        "cardinality_p16": (c16.init_state, c16.update_state, c16.merge_states, ids, {"hist_max": 1},
                            {"hll_scatter_max": 1}),
        "count_min_4x2048": (table_zeros, sk.cms_table_update, lambda a, b: a + b, ids, {"cms_rows_add": 1}, {}),
        "heavy_hitters": (hh.init_state, hh.update_state, hh.merge_states, hh_ids, {"cms_walk": cms_walk.KERNELS},
                          {}),
    }
    states, launches, walls = {}, {k: 0 for k in _launch_counts(scatter, cms_walk)}, {}
    obs.enable()
    try:
        for name, (init, update, merge, batches, per_update, per_dispatch) in paths.items():
            instrument.KERNEL_DISPATCHES.clear()
            _zero_launches(scatter, cms_walk)  # the main path's run starts here ...
            half = len(batches) // 2
            t0 = time.perf_counter()
            first = _fold(init, update, batches[:half])
            single = first
            for b in batches[half:]:
                single = update(single, b)
            second = _fold(init, update, batches[half:])
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            counted = _launch_counts(scatter, cms_walk)  # ... and ends here
            n_updates = len(batches) + half
            want = {k: per_update.get(k, 0) * n_updates for k in counted}
            _check(counted == want, f"{name}: launches {counted}, expected {want}")
            for entry in ENTRY_OF.values():
                ref = instrument.KERNEL_DISPATCHES.value(kernel=entry, impl="reference")
                opt = instrument.KERNEL_DISPATCHES.value(kernel=entry, impl="optimized")
                expected = per_dispatch.get(entry, 0) * n_updates
                _check(ref == 0, f"{name}: {ref} reference dispatches of {entry} on a CUDA tensor")
                _check(opt == expected, f"{name}: {opt} kernel dispatches of {entry}, expected {expected}")
            for k in launches:
                launches[k] += counted[k]
            states[name] = (first, second, single, merge(first, second))
            print(f"phase E {name}: {n_updates} updates in {walls[name]:.3f} s; launches {counted} "
                  f"({', '.join(f'{v // n_updates} {k}' for k, v in counted.items() if v) or 'no kernel'} per update); "
                  "no reference dispatch")
    finally:
        obs.disable()

    cpu = {"lat": [b.cpu() for b in lat], "ids": [b.cpu() for b in ids], "hh": [b.cpu() for b in hh_ids]}

    # --- quantile sketch
    first, second, single, merged = states["quantile"]
    _equal_states(torch, single, merged, "quantile merge of two half-streams")
    _, log_gamma, offset = sk.ddsketch_params(0.01)
    own = [torch.zeros(2048, dtype=torch.int32, device="cuda") for _ in range(2)]
    moved = 0
    for b, b_cpu in zip(lat, cpu["lat"]):
        idx = sk.ddsketch_buckets(b, 2048, log_gamma=log_gamma, offset=offset)
        own[0] = scatter.hist_add_reference(own[0], idx, (b > 0).to(torch.int32))
        own[1] = scatter.hist_add_reference(own[1], idx, (b < 0).to(torch.int32))
        idx_cpu = sk.ddsketch_buckets(b_cpu, 2048, log_gamma=log_gamma, offset=offset)
        moved += int(((idx.cpu() != idx_cpu) & (b_cpu != 0) & torch.isfinite(b_cpu)).sum())
    _check(torch.equal(single["pos_buckets"], own[0]) and torch.equal(single["neg_buckets"], own[1]),
           "quantile buckets differ from the plain scatter fed the card's own bucket indices")
    q_cpu = QuantileSketch(alpha=0.01, n_buckets=2048, device="cpu")
    s_cpu = _fold(q_cpu.init_state, q_cpu.update_state, cpu["lat"])
    for key in ("pos_buckets", "neg_buckets"):
        _check(int(single[key].sum()) == int(s_cpu[key].sum()), f"quantile {key} total differs from the CPU")
    for key in ("zero_count", "min_value", "max_value", "_update_count"):
        _check(torch.equal(single[key].cpu(), s_cpu[key]), f"quantile {key} differs from the CPU")
    cells_moved = int((single["pos_buckets"].cpu() != s_cpu["pos_buckets"]).sum()
                      + (single["neg_buckets"].cpu() != s_cpu["neg_buckets"]).sum())
    got_q, want_q = q.compute_from(single).cpu(), q_cpu.compute_from(s_cpu)
    _check(bool(torch.isfinite(got_q).all()) and got_q.shape == (3,), f"quantile value {got_q}")
    _check(bool(((got_q - want_q).abs() <= 2 * 0.01 * want_q.abs()).all()), f"quantiles {got_q} vs CPU {want_q}")
    every = torch.cat(lat)
    every = torch.sort(every[~torch.isnan(every)]).values
    exact = [float(every[int(math.floor(qq * (every.numel() - 1)))]) for qq in q.quantiles]
    rel = [abs(float(g) - e) / abs(e) for g, e in zip(got_q, exact)]
    _check(max(rel) <= 0.01, f"quantile relative errors {rel} above alpha 0.01")
    print(f"phase E quantile: buckets bit-identical to the plain scatter on the card's own bucket indices; "
          f"{moved} of {SKETCH_BATCHES * SKETCH_BATCH} values in another bucket than on the CPU "
          f"({cells_moved} bucket counts differ), totals, zero count and min/max equal; merge == single stream; "
          f"q{list(q.quantiles)} = {got_q.tolist()} (CPU {want_q.tolist()}, exact {exact}, rel err {rel})")

    # --- cardinality sketches
    true_distinct = int(torch.unique(torch.cat(ids)).numel())
    for name, p, metric in (("cardinality_p12", 12, c12), ("cardinality_p16", 16, c16)):
        first, second, single, merged = states[name]
        _equal_states(torch, single, merged, f"{name} merge of two half-streams")
        m_cpu = CardinalitySketch(p=p, device="cpu")
        s_cpu = _fold(m_cpu.init_state, m_cpu.update_state, cpu["ids"])
        _equal_states(torch, single, s_cpu, f"{name} against the CPU recomputation")
        est, est_cpu = float(metric.compute_from(single)), float(m_cpu.compute_from(s_cpu))
        _check(math.isclose(est, est_cpu, rel_tol=1e-6), f"{name} estimate {est} vs CPU {est_cpu}")
        rel = abs(est - true_distinct) / true_distinct
        _check(rel <= 3 * 1.04 / math.sqrt(1 << p), f"{name} estimate {est} vs {true_distinct} distinct")
        print(f"phase E {name}: registers bit-identical to the CPU; merge == single stream; estimate {est} "
              f"(CPU {est_cpu}) of {true_distinct} distinct, rel err {rel}")

    # --- count-min table
    first, second, single, merged = states["count_min_4x2048"]
    _check(torch.equal(single, merged), "count-min merge of two half-streams")
    t_cpu = _fold(lambda: torch.zeros((4, 2048), dtype=torch.int32), sk.cms_table_update, cpu["ids"])
    _check(torch.equal(single.cpu(), t_cpu), "count-min table differs from the CPU recomputation")
    keys = ids[0][:4096]
    true_counts = torch.bincount(torch.cat(ids).to(torch.int64), minlength=ZIPF_IDS)[keys.to(torch.int64)]
    est = sk.cms_query(single, keys)
    _check(bool((est.to(torch.int64) >= true_counts).all()), "count-min undercounts")
    print(f"phase E count_min_4x2048: table bit-identical to the CPU; merge == single stream; never undercounts "
          f"on 4096 keys (largest overcount {int((est.to(torch.int64) - true_counts).max())})")

    # --- heavy hitters
    first, second, single, merged = states["heavy_hitters"]
    half = HH_BATCHES // 2
    t0 = time.perf_counter()
    h_cpu = HeavyHittersSketch(k=32, depth=4, width=2048, device="cpu")
    first_cpu = _fold(h_cpu.init_state, h_cpu.update_state, cpu["hh"][:half])
    single_cpu = _fold(lambda: first_cpu, h_cpu.update_state, cpu["hh"][half:])
    second_cpu = _fold(h_cpu.init_state, h_cpu.update_state, cpu["hh"][half:])
    cpu_s = time.perf_counter() - t0
    for card, host, what in ((first, first_cpu, "first half"), (second, second_cpu, "second half"),
                             (single, single_cpu, "single stream")):
        _equal_states(torch, card, host, f"heavy hitters ({what}) against the CPU recomputation")
    _check(torch.equal(merged["counts"], single["counts"]), "heavy-hitter counts: merge != single stream")
    _check(torch.equal(merged["ledger"].cpu(), sk.topk_merge(torch.stack([first_cpu["ledger"], second_cpu["ledger"]]))),
           "heavy-hitter merged ledger differs from topk_merge on the CPU")
    top_keys, top_counts = hh.compute_from(single)
    cpu_keys, cpu_counts = h_cpu.compute_from(single_cpu)
    _check(torch.equal(top_keys.cpu(), cpu_keys) and torch.equal(top_counts.cpu(), cpu_counts), "hh_rank differs")
    print(f"phase E heavy_hitters: {HH_BATCHES} batches of {HH_BATCH} ids: counts and ledger bit-identical to the "
          f"CPU's plain walk ({cpu_s:.1f} s; both halves and the single stream); merged counts == single stream, "
          f"merged ledger == topk_merge on the CPU; top 5 {list(zip(top_keys[:5].tolist(), top_counts[:5].tolist()))}")

    # --- the stateful path, once per sketch
    for make, batch in ((lambda: QuantileSketch(device="cuda"), lat[0]), (lambda: CardinalitySketch(device="cuda"), ids[0]),
                        (lambda: HeavyHittersSketch(device="cuda"), hh_ids[0])):
        metric = make()
        metric.update(batch)
        value = metric.compute()
        want = metric.compute_from(metric.update_state(metric.init_state(), batch))
        for a, b in zip(value if isinstance(value, tuple) else (value,), want if isinstance(want, tuple) else (want,)):
            _check(torch.equal(a, b), f"stateful {type(metric).__name__}.compute differs from compute_from")
        metric.reset()
        for key, default in metric._defaults.items():
            _check(torch.equal(getattr(metric, key), default), f"reset of {type(metric).__name__}.{key}")
        _check(metric.update_count == 0 and not metric.update_called, "reset")
    print("phase E stateful update/compute/reset on the card agree with the functional path")
    return launches, {"lat": lat, "ids": ids, "hh_ids": hh_ids, "paths": paths, "states": states, "walls": walls}


def _kernel_record(torch, kernel: str, run, plain, library, nbytes: int, ops: int, extra: dict,
                   ops_per_s: float = CUDA_CORE_OPS_PER_S) -> dict:
    """Kernel, plain version, library call and bound at one shape."""
    iters = 50
    ms = _time_ms(run, iters)
    plain_ms = _time_ms(plain, 10, warmup=2)
    library_ms = _time_ms(library, iters)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    device_ms = _per_call_ms(_call_kernels(torch, run, f"{kernel}_", 1))
    rec = {**extra, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops}
    print(f"phase F {kernel} {json.dumps(rec)}")
    return rec


def _update_profile(torch, update, state, batch, kernel: str, iters: int = 20, tries: int = 3) -> dict:
    """Device time by kernel, idle share and launches of one sketch update, under the profiler.
    The profiler sometimes records few of a window's launches: a window that holds fewer than
    half of the launches of the update's ``kernel`` (one a call at least) is profiled again,
    up to ``tries`` times; ``complete`` says whether one held them."""
    for _ in range(tries):
        kernels, wall_us = _profile_steps(torch, lambda: update(state, batch), iters)
        recorded = sum(len(v) for name, v in kernels.items() if kernel in name)
        if 2 * recorded >= iters:
            break
    busy_us = sum(sum(v) for v in kernels.values())
    return {
        "complete": 2 * recorded >= iters,
        f"{kernel}_launches_recorded": recorded,
        "updates": iters,
        "device_busy_us_per_update": busy_us / iters,
        "wall_us_per_update_under_profiler": wall_us / iters,
        "idle_share": 1.0 - busy_us / wall_us if wall_us else None,
        "launches_per_update": sum(len(v) for v in kernels.values()) / iters,
        "top_kernels": [
            {"name": name[:90], "launches_per_update": len(v) / iters, "us_per_update": sum(v) / iters}
            for name, v in sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:10]
        ],
    }


def _walk_record(torch, cms_walk, ids, issue_ops_per_s: float, clock_hz: float, plain: bool) -> dict:
    """The ledger walk of ``ids`` into an empty 4 x 2048 table and k = 32 ledger: call time, device
    time (all four kernels, and by kernel), µs per item, the counters (held against the numpy
    mirror's), and the bound: the evictions times WALK_DECISION_CYCLES over the SM clock
    (``clocks.max.sm``), plus the table half's bound (the ids route of cms_rows_add at the same N);
    ``snapshot_bound_ms``: the same cycles for every item held at the start of its chunk of 32 or
    with an estimate above the smallest count then (``snapshot_items`` of the mirror in chunks of
    32), plus the table half's bound. The plain walk once if asked."""
    n = ids.numel()
    table = torch.zeros((4, 2048), dtype=torch.int32, device="cuda")
    ledger = torch.stack([torch.full((32,), -1, dtype=torch.int32, device="cuda"),
                          torch.zeros(32, dtype=torch.int32, device="cuda")], dim=1)
    run = lambda: cms_walk.cms_walk_cuda(table, ledger, ids)  # noqa: E731
    calls = max(2, min(20, 2**18 // n))
    ms = _time_ms(run, calls, warmup=1)
    by_kernel = {name[name.index("cms_walk_"):].split("<")[0].split("(")[0]: sum(v) / len(v) / 1e3
                 for name, v in _call_kernels(torch, run, "cms_walk_", cms_walk.KERNELS, calls).items()}
    device_ms = sum(by_kernel.values()) if by_kernel else None
    counters = torch.zeros(3, dtype=torch.int64, device="cuda")
    got = cms_walk.cms_walk_cuda(table, ledger, ids, counters)
    raises, evictions, sequential = counters.tolist()
    m_table, m_ledger, mirror = cms_walk.walk_in_chunks(table.cpu(), ledger.cpu(), ids.cpu())
    _check((raises, evictions, sequential) == tuple(mirror[:3]), f"walk at N={n}: counters {counters.tolist()}, "
           f"mirror {tuple(mirror[:3])}")
    _check(torch.equal(got[0].cpu(), m_table) and torch.equal(got[1].cpu(), m_ledger), f"walk at N={n}: mirror")
    snapshot = cms_walk.walk_in_chunks(table.cpu(), ledger.cpu(), ids.cpu(), step=cms_walk.CHUNK)[2].snapshot_items
    valid = int((ids >= 0).sum())
    nbytes, ops = 4 * n + 8 * 4 * 2048, CM_HASH_OPS * 4 * n
    table_ms, table_by = _bound(nbytes, ops, issue_ops_per_s)
    eviction_ms = evictions * WALK_DECISION_CYCLES / clock_hz * 1e3
    snapshot_ms = snapshot * WALK_DECISION_CYCLES / clock_hz * 1e3
    plain_ms = _time_ms(lambda: cms_walk.cms_walk_reference(table, ledger, ids), 1, warmup=0) if plain else None
    chunks = -(-n // cms_walk.CHUNK)
    return {"shape": f"N={n} Zipf ids, 4 x 2048 table, k=32", "ms": ms, "device_ms": device_ms,
            "device_ms_by_kernel": by_kernel, "us_per_item": device_ms * 1e3 / n if device_ms else None,
            "raises": raises, "evictions": evictions, "sequential_chunks": sequential, "chunks": chunks,
            "sequential_share": sequential / chunks, "valid": valid, "snapshot_items": snapshot,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": eviction_ms + table_ms, "bound_by": "operations",
            "eviction_bound_ms": eviction_ms, "snapshot_bound_ms": snapshot_ms + table_ms,
            "table_bound_ms": table_ms, "table_bound_by": table_by, "bytes": nbytes, "ops": ops,
            "placement": cms_walk.placement(4, 2048, 32), "segments": cms_walk.segments(n, 4 * 2048)}


def phase_f(torch, scatter, cms_walk, data, issue_ops_per_s: float, clock_hz: float) -> dict:
    """Each scatter kernel at the Phase E shapes; the ledger walk; each sketch's update; profiled updates."""
    from metrics_tpu_torch.sketch import kernels as sk

    lat0, ids0, hh0 = data["lat"][0], data["ids"][0], data["hh_ids"][0]
    n = SKETCH_BATCH
    _, log_gamma, offset = sk.ddsketch_params(0.01)
    recs = {}

    idx = sk.ddsketch_buckets(lat0, 2048, log_gamma=log_gamma, offset=offset)  # always in range
    w = (lat0 > 0).to(torch.int32)
    bins = torch.zeros(2048, dtype=torch.int32, device="cuda")
    lib_bins = bins.clone()
    recs["hist_add"] = _kernel_record(
        torch, "hist_add", lambda: scatter.hist_add_cuda(bins, idx, w), lambda: scatter.hist_add_reference(bins, idx, w),
        lambda: lib_bins.index_add_(0, idx, w), 8 * n + 8 * 2048, 3 * n,
        {"shape": f"N={n}, 2048 bins (the quantile sketch's positive store)",
         "branch": scatter.hist_branch("hist_add", n, 2048)})

    for p in (12, 16):
        reg_idx, rank = sk.hll_registers(ids0, p=p)
        regs = torch.zeros(1 << p, dtype=torch.int32, device="cuda")
        lib_regs, reg_idx64 = regs.clone(), reg_idx.to(torch.int64)
        recs[f"hist_max_p{p}"] = _kernel_record(
            torch, "hist_max", lambda: scatter.hist_max_cuda(regs, reg_idx, rank),
            lambda: scatter.hist_max_reference(regs, reg_idx, rank),
            lambda: lib_regs.scatter_reduce_(0, reg_idx64, rank, "amax", include_self=True),
            8 * n + 8 * (1 << p), 3 * n,
            {"shape": f"N={n}, 2^{p} registers", "branch": scatter.hist_branch("hist_max", n, 1 << p)})

    cols = sk._cm_columns(ids0, 4, 2048)
    valid = ids0 >= 0
    counts = torch.zeros((4, 2048), dtype=torch.int32, device="cuda")
    flat = counts.clone().reshape(-1)
    key = (torch.arange(4, device="cuda") * 2048 + cols.to(torch.int64)).reshape(-1)
    inc = valid.to(torch.int32)[:, None].expand(n, 4).reshape(-1).contiguous()
    # the ids route: the ids read once, the table read and written once; the hash's integer
    # instructions over the card's issue rate
    recs["cms_rows_add_ids"] = _kernel_record(
        torch, "cms_rows_add", lambda: scatter.cms_ids_add_cuda(counts, ids0),
        lambda: scatter.cms_ids_add_reference(counts, ids0), lambda: flat.index_add_(0, key, inc),
        4 * n + 8 * 4 * 2048, CM_HASH_OPS * 4 * n,
        {"shape": f"N={n}, 4 x 2048 table, ids route (columns hashed in the kernel)",
         "branch": scatter.cms_ids_branch(4, 2048)}, ops_per_s=issue_ops_per_s)
    recs["cms_rows_add"] = _kernel_record(
        torch, "cms_rows_add", lambda: scatter.cms_rows_add_cuda(counts, cols, valid),
        lambda: scatter.cms_rows_add_reference(counts, cols, valid), lambda: flat.index_add_(0, key, inc),
        4 * 4 * n + n + 8 * 4 * 2048, 3 * 4 * n, {"shape": f"N={n}, 4 x 2048 table, columns route (registry entry)"})

    # the ledger walk at 4096 ids, at HH_BATCH (Phase E's heavy-hitter batch) and at 2^22
    for n_ids in WALK_SHAPES:
        ids = {n: ids0, HH_BATCH: hh0}.get(n_ids)
        ids = _zipf(torch, n_ids, torch.Generator(device="cuda").manual_seed(n_ids)) if ids is None else ids
        recs[f"cms_walk_{n_ids}"] = rec = _walk_record(torch, cms_walk, ids, issue_ops_per_s, clock_hz,
                                                       plain=n_ids == HH_BATCH)
        print(f"phase F cms_walk {json.dumps(rec)}")

    # per-update time and values/s of each sketch on one batch
    updates = {}
    for name, (init, update, _, batches, *_) in data["paths"].items():
        state, batch = init(), batches[0]
        ms = _time_ms(lambda: update(state, batch), 10, warmup=1)
        updates[name] = {"values": batch.numel(), "ms_per_update": ms, "values_per_s": batch.numel() / ms * 1e3}
    init, update, _, batches, *_ = data["paths"]["heavy_hitters"]
    state, batch = init(), batches[0][:4096]
    ms = _time_ms(lambda: update(state, batch), 10, warmup=1)
    updates["heavy_hitters_4096"] = {"values": batch.numel(), "ms_per_update": ms,
                                     "values_per_s": batch.numel() / ms * 1e3}
    for name in ("heavy_hitters", "heavy_hitters_4096"):
        updates[name]["us_per_item"] = updates[name]["ms_per_update"] * 1e3 / updates[name]["values"]
    print(f"phase F sketch updates {json.dumps(updates)}")

    # a quantile, a count-min table and a heavy-hitter update under the profiler
    for name, kernel in (("quantile", "hist_add"), ("count_min_4x2048", "cms_rows_add"), ("heavy_hitters", "cms_walk")):
        init, update, _, batches, *_ = data["paths"][name]
        recs[f"{name}_profile"] = profile = _update_profile(torch, update, init(), batches[0], kernel)
        print(f"phase F {name} update profile {json.dumps(profile)}")
    return recs


def _at_offset(torch, x, offset: int):
    """``x`` as a contiguous view ``offset`` elements into a larger buffer (a storage offset)."""
    if not offset:
        return x
    buf = torch.full((x.numel() + offset,), 7.0, device=x.device, dtype=x.dtype)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def _curve_inputs(torch, gen, shape, thr, weights: str, per_row: bool = False, offset: int = 0,
                  zeros: bool = False):
    """(p, tw, w) on the card: uniform scores with the edge values and ties on
    ``thr`` mixed in (or, with ``zeros``, only -0.0, +0.0 and +-1e-30); 0/1 or
    float weights, per element or per row; views at a storage offset if asked."""
    p = torch.rand(shape, generator=gen, device="cuda")
    flat = p.view(-1)
    n = flat.numel()
    if zeros:
        choices = torch.tensor([-0.0, 0.0, 1e-30, -1e-30], device="cuda")
        flat.copy_(choices[torch.randint(0, 4, (n,), generator=gen, device="cuda")])
    elif n >= 16:
        flat[:6] = torch.tensor([math.nan, math.inf, -math.inf, -0.0, 0.0, 1.0], device="cuda")
        k = max(1, n // 100)
        at = torch.randint(0, n, (k,), generator=gen, device="cuda")
        flat[at] = thr[torch.randint(0, thr.numel(), (k,), generator=gen, device="cuda")]
    w_shape = shape[:1] if per_row else shape
    if weights == "float":
        w = torch.rand(w_shape, generator=gen, device="cuda") * 2
    else:
        w = torch.randint(0, 2, w_shape, generator=gen, device="cuda").to(torch.float32)
    y = torch.randint(0, 2, shape, generator=gen, device="cuda").to(torch.float32)
    tw = y * (w[:, None] if per_row and len(shape) == 2 else w)
    return tuple(_at_offset(torch, x, offset) for x in (p, tw, w))


def _sorted_route_max_thresholds(bc, n_cols: int) -> int:
    """The largest T that takes the kernel's sorted-threshold route for ``n_cols`` columns."""
    lo, hi = 0, 2**20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if bc.uses_sorted_route(n_cols, mid) else (lo, mid - 1)
    return lo


def _curve_cases(bc):
    """(name, N, C, T, thresholds, per-row w[, storage offset]) of the Phase G cases,
    with both sides of the route crossover (``uses_sorted_route``) at C = 1 and 16."""
    edge1, edge16 = _sorted_route_max_thresholds(bc, 1), _sorted_route_max_thresholds(bc, 16)
    return [
        ("main_T100", CURVE_N, 1, 100, "linspace", False),
        ("main_T200", CURVE_N, 1, 200, "linspace", False),  # the main path's shape
        ("main_T400", CURVE_N, 1, 400, "linspace", False),
        ("main_T1024", CURVE_N, 1, 1024, "linspace", False),
        ("multiclass_C10", CURVE_N, CURVE_COLS, 200, "linspace", True),  # the multiclass update: w per row
        ("multilabel_C10", CURVE_N, CURVE_COLS, 200, "linspace", False),
        ("T1", 5003, 1, 1, "linspace", False),
        ("T1500_two_chunks", 4097, 3, 1500, "unsorted", False),
        ("compare_T1500_two_chunks_C16", 4097, 16, 1500, "unsorted", False),
        ("unsorted_duplicates", 65537, 1, 37, "unsorted", False),
        ("N1", 1, 1, 5, "linspace", False),
        ("N1_C10", 1, CURVE_COLS, 7, "linspace", True),
        ("ragged", 1025, 2, 33, "linspace", False),
        ("empty", 0, 1, 10, "linspace", False),
        ("nan_inf_thresholds", 65537, 1, 40, "specials", False),
        ("nan_inf_thresholds_C10", 30011, CURVE_COLS, 40, "specials", True),
        ("all_nan_thresholds", 4099, 2, 3, "nan", False),
        ("signed_zero_scores", 65536, 1, 9, "zeros", False),
        ("descending", 65537, 1, 200, "descending", False),
        ("descending_C10", 20000, CURVE_COLS, 64, "descending", False),
        (f"sorted_edge_T{edge1}", 65537, 1, edge1, "specials", False),
        (f"compare_edge_T{edge1 + 1}", 65537, 1, edge1 + 1, "specials", False),
        (f"sorted_edge_C16_T{edge16}", 20001, 16, edge16, "unsorted", True),
        (f"compare_edge_C16_T{edge16 + 1}", 20001, 16, edge16 + 1, "unsorted", True),
        ("unsorted_T1024_in_block_sort", 65537, 1, 1024, "unsorted", False),
        ("C3_two_phases", 30001, 3, 50, "specials", False),
        ("C33_two_columns_per_warp", 20001, 33, 100, "unsorted", True),
        ("view_offset_main", CURVE_N, 1, CURVE_T, "linspace", False, 1),
        ("view_offset_C10", 99991, CURVE_COLS, 50, "unsorted", True, 3),
    ]


def _curve_thresholds(torch, kind: str, t: int, gen):
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg

    if kind == "linspace":
        return _adjust_threshold_arg(t, torch.device("cuda"))
    if kind == "nan":
        return torch.full((t,), math.nan, device="cuda")
    if kind == "zeros":  # -0.0 and +0.0, and their neighbours
        return torch.tensor([0.0, -0.0, 1e-30, -1e-30, -0.0, 0.0, 1e-31, -math.inf, math.inf], device="cuda")[:t]
    thr = torch.rand(t, generator=gen, device="cuda")
    if kind == "descending":
        return torch.sort(thr, descending=True).values
    if kind == "specials":  # NaN, +-inf, -0.0 beside +0.0 and a duplicate, at random places
        at = torch.randperm(t, generator=gen, device="cuda")[:6]
        thr[at] = torch.tensor([math.nan, math.inf, -math.inf, -0.0, 0.0, math.nan], device="cuda")[:at.numel()]
    if t > 2:
        thr[1] = thr[0]
    return thr


def phase_g(torch, bc) -> dict:
    """Every threshold-count case: kernel vs plain version on the same CUDA inputs."""
    gen = torch.Generator(device="cuda").manual_seed(77)
    worst = 0.0
    for name, n, c, t, kind, per_row, *offset in _curve_cases(bc):
        route = "sorted" if bc.uses_sorted_route(c, t) else "compare"
        if name.startswith(("sorted_", "compare_")):
            _check(name.startswith(route), f"{name}: takes the {route} route")
        thr = _curve_thresholds(torch, kind, t, gen)
        p, tw, w = _curve_inputs(torch, gen, (n,) if c == 1 else (n, c), thr, "01", per_row,
                                 offset=offset[0] if offset else 0, zeros=kind == "zeros")
        if offset:
            thr = _at_offset(torch, thr, offset[0])
            _check(all(x.storage_offset() == offset[0] and x.is_contiguous() for x in (p, tw, w, thr)), name)
        before = bc.launches
        got = bc.binned_curve_counts_cuda(p, tw, w, thr)
        torch.cuda.synchronize()
        _check(bc.launches == before + (1 if n else 0), f"{name}: launch count")
        want = bc.reference_counts(p, tw, w, thr)
        for g, wnt, what in zip(got, want, ("tp", "fp")):
            _check(g.dtype == torch.float32 and g.shape == wnt.shape, f"{name} {what}: {g.dtype} {tuple(g.shape)}")
            _check(torch.equal(g, wnt), f"{name} {what}: kernel differs from reference_counts")
        err = max(float((g - wnt).abs().max()) if g.numel() else 0.0 for g, wnt in zip(got, want))
        worst = max(worst, err)
        print(f"phase G {name}: N={n} C={c} T={t} route={route} thresholds={kind} "
              f"w={'per row' if per_row else 'per element'} offset={offset[0] if offset else 0} "
              f"equal=True max_abs_err={err} launches={bc.launches - before} tp[0]={got[0].reshape(-1)[0].item() if n else 0}")
    _check(not bc.uses_sorted_route(16, 1500), "float_compare_route: takes the compare route")

    float_err = 0.0
    for name, n, c, t in (("float_main", CURVE_N, 1, CURVE_T), ("float_C10", CURVE_N, CURVE_COLS, CURVE_T),
                          ("float_compare_route", 65537, 16, 1500)):
        thr = _curve_thresholds(torch, "linspace", t, gen)
        p, tw, w = _curve_inputs(torch, gen, (n,) if c == 1 else (n, c), thr, "float")
        first = bc.binned_curve_counts_cuda(p, tw, w, thr)
        second = bc.binned_curve_counts_cuda(p, tw, w, thr)
        want = bc.reference_counts(p, tw, w, thr)
        torch.cuda.synchronize()
        for a, b, wnt in zip(first, second, want):
            _check(torch.equal(a, b), f"{name}: two launches on one input differ")
            _check(torch.allclose(a, wnt, rtol=1e-5, atol=1e-3), f"{name}: kernel vs reference_counts")
        err = max(float((a - wnt).abs().max()) for a, wnt in zip(first, want))
        rel = max(float(((a - wnt).abs() / wnt.abs().clamp(min=1)).max()) for a, wnt in zip(first, want))
        float_err = max(float_err, err)
        print(f"phase G {name}: N={n} C={c} T={t} float weights: repeat launches bit-identical; "
              f"allclose(rtol=1e-5, atol=1e-3) max_abs_err={err} max_rel_err={rel}")
    return {"max_abs_err": worst, "float_max_abs_err": float_err}


def _classifier_scores(torch, gen, n: int, pos_rate: float = 0.3):
    """Probabilities of a fair binary classifier: labels ~ Bernoulli(pos_rate), logits ~ N(+-1, 1.5), 1% ignored (-1)."""
    y = (torch.rand(n, generator=gen, device="cuda") < pos_rate).to(torch.int32)
    logit = torch.randn(n, generator=gen, device="cuda") * 1.5 + (2 * y - 1).to(torch.float32)
    y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.01, -1, y)
    return torch.sigmoid(logit), y


def phase_h(torch, bc, obs, instrument):
    """The binned curves at full width, counted and verified."""
    from metrics_tpu_torch.classification import (
        BinaryAUROC, BinaryAveragePrecision, BinaryPrecisionRecallCurve, BinaryROC, MulticlassAUROC,
        MultilabelAveragePrecision,
    )

    gen = torch.Generator(device="cuda").manual_seed(4242)
    batches = [_classifier_scores(torch, gen, CURVE_N) for _ in range(CURVE_UPDATES)]
    mc_batches, ml_batches = [], []
    for _ in range(2):
        mc_target = torch.randint(0, CURVE_COLS, (CURVE_N,), generator=gen, device="cuda", dtype=torch.int32)
        logits = torch.randn(CURVE_N, CURVE_COLS, generator=gen, device="cuda")
        logits[torch.arange(CURVE_N, device="cuda"), mc_target.long()] += 1.5
        mc_batches.append((torch.softmax(logits, dim=1), mc_target))
        ml_target = (torch.rand(CURVE_N, CURVE_COLS, generator=gen, device="cuda") < 0.2).to(torch.int32)
        ml_scores = torch.sigmoid(torch.randn(CURVE_N, CURVE_COLS, generator=gen, device="cuda") + 1.5 * ml_target - 0.5)
        ml_batches.append((ml_scores, ml_target))
    torch.cuda.synchronize()
    print(f"phase H data: {CURVE_UPDATES} batches of {CURVE_N} binary scores (30% positive, 1% ignored), "
          f"2 batches of {CURVE_N} x {CURVE_COLS} multiclass and multilabel scores; T={CURVE_T}")

    kw = {"thresholds": CURVE_T, "ignore_index": -1, "device": "cuda"}
    binary = {
        "BinaryPrecisionRecallCurve": BinaryPrecisionRecallCurve(**kw),
        "BinaryROC": BinaryROC(**kw),
        "BinaryAUROC": BinaryAUROC(**kw),
        "BinaryAUROC(max_fpr=0.5)": BinaryAUROC(max_fpr=0.5, **kw),
        "BinaryAveragePrecision": BinaryAveragePrecision(**kw),
    }
    mc = MulticlassAUROC(num_classes=CURVE_COLS, thresholds=CURVE_T, device="cuda")
    ml = MultilabelAveragePrecision(num_labels=CURVE_COLS, thresholds=CURVE_T, device="cuda")
    paths = {name: (m, batches) for name, m in binary.items()}
    paths["MulticlassAUROC"] = (mc, mc_batches)
    paths["MultilabelAveragePrecision"] = (ml, ml_batches)

    states, launches, n_updates = {}, 0, 0
    obs.enable()
    try:
        instrument.KERNEL_DISPATCHES.clear()
        bc.launches = 0  # the main path's run starts here ...
        t0 = time.perf_counter()
        for name, (m, bs) in paths.items():
            half = len(bs) // 2
            first = _fold(m.init_state, lambda s, b: m.update_state(s, *b), bs[:half])
            single = _fold(lambda: first, lambda s, b: m.update_state(s, *b), bs[half:])
            second = _fold(m.init_state, lambda s, b: m.update_state(s, *b), bs[half:])
            states[name] = (first, second, single, m.merge_states(first, second))
            n_updates += len(bs) + len(bs[half:])
            m.update(*bs[0])  # the stateful path: one update, compute below
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = bc.launches  # ... and ends here
        ref = instrument.KERNEL_DISPATCHES.value(kernel="binned_curve_counts", impl="reference")
        opt = instrument.KERNEL_DISPATCHES.value(kernel="binned_curve_counts", impl="optimized")
    finally:
        obs.disable()
    n_updates += len(paths)  # the stateful updates
    print(f"phase H ran {n_updates} binned updates in {wall:.3f} s; binned_curve launches={launches}, "
          f"dispatches optimized={opt} reference={ref}")
    _check(launches == n_updates, f"expected {n_updates} binned_curve launches (one per update), got {launches}")
    _check(opt == n_updates and ref == 0, f"dispatches: {opt} optimized, {ref} reference on CUDA tensors")

    # CPU recomputation through the plain version; the five binary metrics share one state
    cpu_bin = BinaryPrecisionRecallCurve(thresholds=CURVE_T, ignore_index=-1, device="cpu")
    cpu_state = _fold(cpu_bin.init_state, lambda s, b: cpu_bin.update_state(s, b[0].cpu(), b[1].cpu()), batches)
    cpu_mc = MulticlassAUROC(num_classes=CURVE_COLS, thresholds=CURVE_T, device="cpu")
    cpu_mc_state = _fold(cpu_mc.init_state, lambda s, b: cpu_mc.update_state(s, b[0].cpu(), b[1].cpu()), mc_batches)
    cpu_ml = MultilabelAveragePrecision(num_labels=CURVE_COLS, thresholds=CURVE_T, device="cpu")
    cpu_ml_state = _fold(cpu_ml.init_state, lambda s, b: cpu_ml.update_state(s, b[0].cpu(), b[1].cpu()), ml_batches)
    cpu_states = {name: (cpu_bin, cpu_state) for name in binary}
    cpu_states["MulticlassAUROC"] = (cpu_mc, cpu_mc_state)
    cpu_states["MultilabelAveragePrecision"] = (cpu_ml, cpu_ml_state)
    for name, (m, bs) in paths.items():
        first, second, single, merged = states[name]
        _equal_states(torch, single, merged, f"{name}: merge of two half-streams")
        cpu_m, cpu_s = cpu_states[name]
        _check(single["confmat"].dtype == torch.int32, f"{name}: confmat dtype {single['confmat'].dtype}")
        _check(torch.equal(single["confmat"].cpu(), cpu_s["confmat"]), f"{name}: state differs from the CPU recomputation")
        got, want = m.compute_from(single), _twin(m, "cpu").compute_from(cpu_s)
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            _check(bool(torch.isfinite(g).all()), f"{name}: value not finite")
            _check(torch.allclose(g.cpu(), w, rtol=1e-5, atol=1e-6), f"{name}: card {g} vs CPU {w}")
        stateful, functional = m.compute(), m.compute_from(m.update_state(m.init_state(), *bs[0]))
        for g, w in zip(stateful if isinstance(stateful, tuple) else (stateful,),
                        functional if isinstance(functional, tuple) else (functional,)):
            _check(torch.equal(g, w), f"{name}: stateful compute differs from compute_from")
        m.reset()
        _check(not m.confmat.any() and m.update_count == 0, f"{name}: reset")
    auroc = float(binary["BinaryAUROC"].compute_from(states["BinaryAUROC"][2]))
    ap = float(binary["BinaryAveragePrecision"].compute_from(states["BinaryAveragePrecision"][2]))
    pauc = float(binary["BinaryAUROC(max_fpr=0.5)"].compute_from(states["BinaryAUROC(max_fpr=0.5)"][2]))
    mc_v = float(mc.compute_from(states["MulticlassAUROC"][2]))
    ml_v = float(ml.compute_from(states["MultilabelAveragePrecision"][2]))
    print(f"phase H binned states bit-identical to the CPU recomputation; merge == single stream; stateful == "
          f"functional; BinaryAUROC={auroc} (max_fpr=0.5: {pauc}) BinaryAveragePrecision={ap} "
          f"MulticlassAUROC={mc_v} MultilabelAveragePrecision={ml_v}")

    # exact mode: one BinaryAUROC on 2^20 scores, against the CPU and the binned value
    scores, target = _classifier_scores(torch, gen, EXACT_N)
    exact = BinaryAUROC(thresholds=None, ignore_index=-1, device="cuda")
    exact.update(scores, target)
    got = float(exact.compute())
    cpu_exact = BinaryAUROC(thresholds=None, ignore_index=-1, device="cpu")
    cpu_exact.update(scores.cpu(), target.cpu())
    want = float(cpu_exact.compute())
    binned = BinaryAUROC(thresholds=CURVE_T, ignore_index=-1, device="cuda")
    binned.update(scores, target)
    approx = float(binned.compute())
    _check(math.isfinite(got) and abs(got - want) <= 1e-5, f"exact AUROC card {got} vs CPU {want}")
    _check(abs(got - approx) <= 2e-3, f"exact AUROC {got} vs binned {approx}")
    print(f"phase H exact BinaryAUROC on {EXACT_N} scores: {got} (CPU {want}; binned T={CURVE_T}: {approx})")
    return launches, {"batches": batches, "binary": binary, "mc": (mc, mc_batches), "ml": (ml, ml_batches)}


def _twin(m, device: str, validate_args: bool = True):
    """The same curve metric class with the same arguments, on ``device``."""
    kw = {"thresholds": CURVE_T, "device": device, "validate_args": validate_args}
    for attr in ("ignore_index", "max_fpr", "average", "num_classes", "num_labels"):
        if hasattr(m, attr):
            kw[attr] = getattr(m, attr)
    return type(m)(**kw)


def _bucketize_counts(torch, p, tw, w, thr_sorted):
    """The three-call route for sorted thresholds: bucketize, bincount, cumsum (0/1 weights)."""
    b = torch.bucketize(p, thr_sorted, right=True)  # p >= thr[t]  <=>  b > t; NaN lands past the last bucket
    t = thr_sorted.numel()
    key = b * 2 + (tw > 0).to(torch.int64)
    hist = torch.bincount(key, weights=w, minlength=2 * (t + 1)).reshape(t + 1, 2)
    suffix = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))  # suffix[t] = counts with b >= t
    return suffix[1:, 1], suffix[1:, 0]


def phase_i(torch, bc, data) -> dict:
    """The kernel at the Phase H shape and at T = 1024; the binary updates per batch."""
    recs = {}
    gen = torch.Generator(device="cuda").manual_seed(99)
    for t, c in ((CURVE_T, 1), (1024, 1), (CURVE_T, CURVE_COLS)):
        n = CURVE_N
        thr = _curve_thresholds(torch, "linspace", t, gen)
        per_row = c > 1
        p, tw, w = _curve_inputs(torch, gen, (n,) if c == 1 else (n, c), thr, "01", per_row=per_row)
        iters = 50
        ms = _time_ms(lambda: bc.binned_curve_counts_cuda(p, tw, w, thr), iters)
        plain_ms = _time_ms(lambda: bc.reference_counts(p, tw, w, thr), 5, warmup=1)
        # p and tw read once, w once at its own shape (one weight per row for C > 1), thr once;
        # tp and fp written once
        nbytes = 8 * n * c + 4 * (n if per_row else n * c) + 4 * t + 8 * t * c
        # The least work that computes the function is the sorted-threshold route: sort the thresholds,
        # per sample a binary search and five flops (w·tw, w·w, a subtraction, two histogram adds),
        # then a suffix sum of both histograms.
        ops = t * math.ceil(math.log2(t)) + n * c * (math.ceil(math.log2(t + 1)) + 5) + 2 * t * c
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / CUDA_CORE_OPS_PER_S * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        calls = 20
        # both routes launch two kernels a call
        mine = _call_kernels(torch, lambda: bc.binned_curve_counts_cuda(p, tw, w, thr), "binned_curve_", 2, calls)
        device_ms = _per_call_ms(mine)
        rec = {"shape": f"N={n}, C={c}, T={t}", "route": "sorted" if bc.uses_sorted_route(c, t) else "compare",
               "ms": ms, "device_ms": device_ms,
               "device_ms_by_kernel": {
                   name[:60]: {"launches_recorded": len(v), "calls": calls, "ms_per_launch": sum(v) / len(v) / 1e3}
                   for name, v in mine.items()},
               "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
               "bytes": nbytes, "ops": ops}
        if c == 1:  # the three-call route, for sorted thresholds and 0/1 weights
            finite = torch.isfinite(p)  # the route counts NaN above every threshold: compare on finite scores
            got_f = _bucketize_counts(torch, p[finite], tw[finite], w[finite], thr)
            want_f = bc.binned_curve_counts_cuda(p[finite].contiguous(), tw[finite].contiguous(), w[finite].contiguous(), thr)
            _check(all(torch.equal(a.to(torch.float32), b) for a, b in zip(got_f, want_f)),
                   "bucketize route differs from the kernel on finite scores")
            rec["bucketize_bincount_cumsum_ms"] = _time_ms(lambda: _bucketize_counts(torch, p, tw, w, thr), iters)
        recs[f"T{t}_C{c}"] = rec
        print(f"phase I binned_curve {json.dumps(rec)}")

    # the five binary updates per batch of 10^6 scores (default arguments, and without validation)
    batch = data["batches"][0]
    for validate in (True, False):
        metrics = [_twin(m, "cuda", validate) for m in data["binary"].values()]
        states = [m.init_state() for m in metrics]

        def run():
            for i, m in enumerate(metrics):
                states[i] = m.update_state(states[i], *batch)

        ms = _time_ms(run, 10, warmup=2)
        recs[f"binary_updates_validate_{validate}"] = {"ms_per_batch": ms, "updates": len(metrics),
                                                      "scores_per_s": CURVE_N * len(metrics) / ms * 1e3}
    one = data["binary"]["BinaryAUROC"]
    state = one.init_state()
    kernels, wall_us = _profile_steps(torch, lambda: one.update_state(state, *batch), 5)
    busy_us = sum(sum(v) for v in kernels.values())
    recs["auroc_update_profile"] = {
        "device_busy_us_per_update": busy_us / 5,
        "wall_us_per_update_under_profiler": wall_us / 5,
        "idle_share": 1.0 - busy_us / wall_us if wall_us else None,
        "launches_per_update": sum(len(v) for v in kernels.values()) / 5,
        "top_kernels": [{"name": name[:90], "launches_per_update": len(v) / 5, "us_per_update": sum(v) / 5}
                        for name, v in sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:8]],
    }
    print(f"phase I binary updates {json.dumps({k: v for k, v in recs.items() if not k.startswith('T')})}")
    return recs


def _route_launches(instrument) -> tuple:
    """(stat-score, table) launches of csrc/pair_count.cu counted so far."""
    return tuple(int(instrument.KERNEL_LAUNCHES.value(kernel=k)) for k in ("stat_scores", "pair_count"))


def _diff(after: tuple, before: tuple) -> tuple:
    return tuple(a - b for a, b in zip(after, before))


def _no_reference_dispatch(instrument, what: str) -> None:
    for entry in ("stat_scores_cuda", "pair_count_cuda"):
        n = int(instrument.KERNEL_DISPATCHES.value(kernel=entry, impl="reference"))
        _check(n == 0, f"{what}: {n} reference dispatches of {entry} on a CUDA tensor")


def phase_j1(torch, entry_mod, obs, instrument, steps_c: dict, dev: str = "cuda", **config) -> dict:
    """The flagship step at full width with its three metrics in a MetricCollection,
    against the same three as a dict, counted, verified and timed."""
    from metrics_tpu_torch import MetricCollection

    cfg = {**entry_mod.FULL_CONFIG, **config}
    params, x, y = entry_mod.make_inputs(0, cfg["batch"], cfg["hidden"], cfg["classes"], cfg["layers"], dev)
    col = MetricCollection(entry_mod.make_metrics(cfg["classes"], dev))
    metrics = entry_mod.make_metrics(cfg["classes"], dev)
    built = {k: list(v) for k, v in col.compute_groups.items()}
    # one eager update forms the groups; the functional states start from init_state() after it
    col.update(torch.argmax(entry_mod.forward(params, x, y)[1], dim=-1), y)
    groups = {k: list(v) for k, v in col.compute_groups.items()}
    print(f"phase J1 compute groups: built {built}, after one update {groups}")
    _check(groups == FLAGSHIP_GROUPS, f"flagship groups {groups}, the JAX package forms {FLAGSHIP_GROUPS}")
    col_states = col.init_state()
    _check(sorted(col_states) == ["accuracy", "confmat"], f"collection states {sorted(col_states)}")
    dict_states = {name: m.init_state() for name, m in metrics.items()}

    # sgd_step + argmax + col.update_state, chained; the dict path's three update_state calls on the
    # same predictions; (stat-score, table) launches counted around each
    col_launches, dict_launches = [], []
    obs.enable()
    try:
        instrument.KERNEL_LAUNCHES.clear()  # the main path's run starts here ...
        instrument.KERNEL_DISPATCHES.clear()
        for _ in range(FLAGSHIP_STEPS):
            params, loss, logits = entry_mod.sgd_step(params, x, y)
            preds = torch.argmax(logits, dim=-1)
            before = _route_launches(instrument)
            col_states = col.update_state(col_states, preds, y)
            mid = _route_launches(instrument)
            dict_states = {name: m.update_state(dict_states[name], preds, y) for name, m in metrics.items()}
            col_launches.append(_diff(mid, before))
            dict_launches.append(_diff(_route_launches(instrument), mid))
        total = _route_launches(instrument)  # ... and ends here
        _no_reference_dispatch(instrument, "phase J1")
    finally:
        obs.disable()
    print(f"phase J1 {FLAGSHIP_STEPS} steps: (stat-score, table) launches per step {col_launches[0]} through the "
          f"collection, {dict_launches[0]} through the dict; {total} in all")
    _check(col_launches == [(1, 1)] * FLAGSHIP_STEPS, f"collection launches per step {col_launches}")
    _check(dict_launches == [(2, 1)] * FLAGSHIP_STEPS, f"dict launches per step {dict_launches}")
    _check(bool(torch.isfinite(loss)), f"non-finite loss {loss}")
    for name in metrics:
        got = col_states["accuracy" if name == "f1" else name]
        for key, want in dict_states[name].items():
            _check(got[key].dtype == want.dtype and got[key].device == want.device, f"{name}.{key} dtype/device")
            _check(torch.equal(got[key], want), f"{name}.{key}: collection state differs from the dict path's")
    values = col.compute_from(col_states)
    for name, m in metrics.items():
        want = m.compute_from(dict_states[name])
        _check(torch.equal(values[name], want), f"{name}: collection value {values[name]} vs dict {want}")
    print(f"phase J1 states and compute_from values equal the dict path's (torch.equal); accuracy="
          f"{float(values['accuracy'])} f1={float(values['f1'])} confmat total={int(values['confmat'].sum())}")

    # time: bare, dict and collection steps, interleaved repetitions, minimum of each
    col_step, dict_step = entry_mod.make_step(col), entry_mod.make_step(metrics)
    reps = {"bare": [], "dict": [], "collection": []}
    st = {"dict": dict_states, "collection": col_states}

    def run(kind):
        def go():
            nonlocal params
            if kind == "bare":
                params, _, _ = entry_mod.sgd_step(params, x, y)
            else:
                _, params, st[kind] = (dict_step if kind == "dict" else col_step)(params, st[kind], x, y)
        return go

    for _ in range(TIMING_REPS):
        for kind in reps:
            reps[kind].append(_time_ms(run(kind), FLAGSHIP_STEPS, warmup=1))
    t = {k: min(v) for k, v in reps.items()}
    rec = {"bare_ms": t["bare"], "dict_ms": t["dict"], "collection_ms": t["collection"],
           "dict_overhead_pct": (t["dict"] - t["bare"]) / t["bare"] * 100.0,
           "collection_overhead_pct": (t["collection"] - t["bare"]) / t["bare"] * 100.0,
           "phase_c_overhead_pct": steps_c["overhead_pct"],
           "launches_per_step": {"collection": dict(zip(ROUTES, col_launches[0])),
                                 "dict": dict(zip(ROUTES, dict_launches[0]))},
           "launches": dict(zip(ROUTES, total))}
    print(f"phase J1 step {json.dumps(rec)} (min of {TIMING_REPS} reps x {FLAGSHIP_STEPS} steps; reps {reps})")
    return rec


def _six_metrics(dev: str, num_classes: int) -> dict:
    """The six-metric set of benchmarks/collections_vs_reference.py, argument validation off."""
    from metrics_tpu_torch.classification import (
        MulticlassAccuracy, MulticlassConfusionMatrix, MulticlassF1Score, MulticlassPrecision, MulticlassRecall,
        MulticlassSpecificity,
    )

    kw = {"validate_args": False, "device": dev}
    return {
        "acc": MulticlassAccuracy(num_classes, average="micro", **kw),
        "prec": MulticlassPrecision(num_classes, average="macro", **kw),
        "rec": MulticlassRecall(num_classes, average="macro", **kw),
        "f1": MulticlassF1Score(num_classes, average="macro", **kw),
        "spec": MulticlassSpecificity(num_classes, average="macro", **kw),
        "cm": MulticlassConfusionMatrix(num_classes, **kw),
    }


def phase_j2(torch, obs, instrument, dev: str = "cuda", n: int = SIX_N, num_classes: int = SIX_C) -> dict:
    """The six-metric collection with compute groups on and off: groups, launches, states, time."""
    import numpy as np
    from metrics_tpu_torch import MetricCollection

    rng = np.random.default_rng(7)
    batches = [tuple(torch.from_numpy(rng.integers(0, num_classes, n)).to(dev) for _ in range(2))
               for _ in range(1 + SIX_UPDATES)]
    print(f"phase J2 data: {len(batches)} batches of {n} int64 preds and targets in [0, {num_classes}) from seed 7")
    cols = {"groups": MetricCollection(_six_metrics(dev, num_classes)),
            "no_groups": MetricCollection(_six_metrics(dev, num_classes), compute_groups=False)}
    built = {k: list(v) for k, v in cols["groups"].compute_groups.items()}
    _check(built == SIX_GROUPS_BUILT, f"groups at construction {built}, the JAX package seeds {SIX_GROUPS_BUILT}")
    launches = {}
    obs.enable()
    try:
        for mode, col in cols.items():
            instrument.KERNEL_LAUNCHES.clear()  # the main path's run starts here ...
            instrument.KERNEL_DISPATCHES.clear()
            per_update = []
            for preds, target in batches:
                before = _route_launches(instrument)
                col.update(preds, target)
                per_update.append(_diff(_route_launches(instrument), before))
            launches[mode] = per_update  # ... and ends here
            _no_reference_dispatch(instrument, f"phase J2 {mode}")
    finally:
        obs.disable()
    groups = {k: list(v) for k, v in cols["groups"].compute_groups.items()}
    print(f"phase J2 compute groups: built {built}, after one update {groups}; (stat-score, table) launches per "
          f"update: {launches['groups'][1]} with groups (the first, which forms them, {launches['groups'][0]}: one "
          f"per group at construction), {launches['no_groups'][0]} without")
    _check(groups == SIX_GROUPS, f"six-metric groups {groups}, the JAX package forms {SIX_GROUPS}")
    # groups at construction: {acc}, {cm}, {f1}, {prec, rec, spec}: three stat-score updates and the table
    _check(launches["groups"] == [(3, 1)] + [(1, 1)] * SIX_UPDATES, f"launches with groups {launches['groups']}")
    _check(launches["no_groups"] == [(5, 1)] * len(batches), f"launches without groups {launches['no_groups']}")

    # int32 states: with groups == without == a CPU recomputation through the plain pair count
    cpu = MetricCollection(_six_metrics("cpu", num_classes), compute_groups=False)
    for preds, target in batches:
        cpu.update(preds.cpu(), target.cpu())
    on = dict(cols["groups"].items(keep_base=True))
    off = dict(cols["no_groups"].items(keep_base=True))
    host = dict(cpu.items(keep_base=True))
    for name in on:
        for key in on[name]._defaults:
            a, b, c = getattr(on[name], key), getattr(off[name], key), getattr(host[name], key)
            _check(a.dtype == b.dtype == c.dtype == torch.int32 and a.device.type == dev, f"{name}.{key} dtype/device")
            _check(torch.equal(a, b), f"{name}.{key}: groups on differs from groups off")
            _check(torch.equal(a.cpu(), c), f"{name}.{key}: differs from the CPU recomputation")
    val_on, val_off, val_cpu = cols["groups"].compute(), cols["no_groups"].compute(), cpu.compute()
    for name in val_on:
        _check(torch.equal(val_on[name], val_off[name]), f"{name}: compute() with groups {val_on[name]} vs without")
        _check(torch.allclose(val_on[name].cpu().double(), val_cpu[name].double(), rtol=1e-6, atol=0),
               f"{name}: card {val_on[name]} vs CPU {val_cpu[name]}")
    print(f"phase J2 int32 states equal with groups, without, and on the CPU; compute() equal with and without "
          f"groups; {json.dumps({k: float(v) for k, v in val_on.items() if v.numel() == 1})}")

    # time SIX_UPDATES updates of each collection with CUDA events, interleaved, minimum of TIMING_REPS
    rec = {"n": n, "classes": num_classes,
           "launches_per_update": {k: dict(zip(ROUTES, v[-1])) for k, v in launches.items()},
           "launches_forming_update": dict(zip(ROUTES, launches["groups"][0]))}
    times = {mode: [] for mode in cols}
    for _ in range(TIMING_REPS):
        for mode, col in cols.items():
            times[mode].append(_time_ms(lambda: col.update(*batches[0]), SIX_UPDATES, warmup=1))
    for mode in cols:
        rec[f"{mode}_ms_per_update"] = min(times[mode])
    rec["speedup"] = rec["no_groups_ms_per_update"] / rec["groups_ms_per_update"]
    print(f"phase J2 updates {json.dumps(rec)} (min of {TIMING_REPS} runs of {SIX_UPDATES} updates; runs {times})")
    return rec


def phase_j3(torch, dev: str = "cuda", n: int = AGG_N) -> None:
    """The aggregators and a composition on the card against the CPU."""
    import warnings
    from metrics_tpu_torch import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
    from metrics_tpu_torch.classification import MulticlassPrecision, MulticlassRecall

    gen = torch.Generator(device=dev).manual_seed(31)
    values = torch.rand(n, generator=gen, device=dev) * 10.0 - 2.0
    values[torch.rand(n, generator=gen, device=dev) < 0.01] = float("nan")
    weights = torch.rand(n, generator=gen, device=dev)
    host_v, host_w = values.cpu(), weights.cpu()
    nans = torch.isnan(host_v)
    rtol = 1e-5  # float32 sums of 2^22 values in the card's order against a float64 sum on the CPU
    for strategy in ("warn", "ignore", 0.5):
        kept = host_v[~nans] if strategy in ("warn", "ignore") else torch.where(nans, 0.5, host_v)
        kept_w = host_w[~nans] if strategy in ("warn", "ignore") else host_w
        aggs = {cls.__name__: cls(nan_strategy=strategy, device=dev)
                for cls in (SumMetric, MeanMetric, MaxMetric, MinMetric, CatMetric)}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for name, m in aggs.items():
                if name == "MeanMetric":
                    m.update(values, weights)
                else:
                    m.update(values)
        if strategy == "warn":
            _check(sum("nan" in str(w.message) for w in caught) == len(aggs), f"warn: {len(caught)} warnings")
        got = {name: m.compute() for name, m in aggs.items()}
        for name, m in aggs.items():
            for key in m._defaults:
                state = getattr(m, key)
                on_card = all(s.device.type == dev for s in state) if isinstance(state, list) else state.device.type == dev
                _check(on_card, f"{name}({strategy}).{key} is not on {dev}")
        want_sum = kept.double().sum()
        want_mean = (kept.double() * kept_w.double()).sum() / kept_w.double().sum()
        _check(torch.allclose(got["SumMetric"].cpu().double(), want_sum, rtol=rtol, atol=0),
               f"Sum({strategy}) {got['SumMetric']} vs {want_sum}")
        _check(torch.allclose(got["MeanMetric"].cpu().double(), want_mean, rtol=rtol, atol=0),
               f"Mean({strategy}) {got['MeanMetric']} vs {want_mean}")
        _check(torch.equal(got["MaxMetric"].cpu(), kept.max()), f"Max({strategy}) {got['MaxMetric']}")
        _check(torch.equal(got["MinMetric"].cpu(), kept.min()), f"Min({strategy}) {got['MinMetric']}")
        _check(torch.equal(got["CatMetric"].cpu(), kept), f"Cat({strategy}) differs from the kept values")
        print(f"phase J3 aggregators nan_strategy={strategy!r} on {n} float32 values ({int(nans.sum())} NaN): "
              f"Sum {float(got['SumMetric'])} (float64 CPU {float(want_sum)}), Mean {float(got['MeanMetric'])} "
              f"(float64 CPU {float(want_mean)}), rtol {rtol}; Max, Min and Cat exact")

    prec, rec = (cls(SIX_C, average="macro", device=dev) for cls in (MulticlassPrecision, MulticlassRecall))
    mean = MeanMetric(device=dev)
    pr_sum, twice_mean = prec + rec, 2 * mean
    g = torch.Generator().manual_seed(11)
    preds, target = (torch.randint(0, SIX_C, (SIX_N,), generator=g).to(dev) for _ in range(2))
    pr_sum.update(preds, target)
    twice_mean.update(values[~torch.isnan(values)])
    for combo, children in ((pr_sum, (prec, rec)), (twice_mean, (twice_mean.metric_a, mean))):
        _check(combo.device.type == dev, f"{combo.op.__name__}: device {combo.device}")
        got = combo.compute()
        a, b = (c.compute() if hasattr(c, "compute") else c for c in children)
        want = combo.op(a, b)
        _check(got.device.type == dev and torch.equal(got, want), f"{combo.op.__name__}: {got} vs {want}")
    _check(twice_mean.metric_a.dtype == torch.int32 and twice_mean.metric_a.device.type == dev,
           f"constant 2: {twice_mean.metric_a.dtype} on {twice_mean.metric_a.device}")
    print(f"phase J3 compositions on {dev}: precision + recall = {float(pr_sum.compute())}, "
          f"2 * mean = {float(twice_mean.compute())} (int32 constant on {dev}); each equals the operator on its "
          f"children's values")


# --------------------------------------------------------------------------- Phase K: the streaming engine

K_BUCKETS = (64, 256)  # the bucket ladder of benchmarks/engine_throughput.py --sketch
K_QUEUE = 2048
K_TENANTS = 8
K_THREADS = 4
K1_REQUESTS = 8000
K_NAIVE = 300  # naive per-call updates timed, as the benchmark times them
K_PROFILED = 500  # requests in the profiled window that follows the timed one
K2_REQUESTS = 1000
K2_ROWS = (1, 16)
K2_BIG_ROWS = 600  # one request per tenant above the top bucket: split_rows cuts it
K2_CLASSES = 1000  # bench.py's class count
K3_REQUESTS = 1000
K3_TENANTS = 4
K3_BUCKETS = (64,)
K4_REQUESTS = 1000
K4_ROWS = (1, 8)
K5_REQUESTS = 300
# kernel -> (name fragment of its device kernels in a profile, device kernels per counted launch)
K_PROFILE_NAMES = {"pair_count": ("pair_count_", 1), "stat_scores": ("stat_scores_kernel", 1),
                   "hist_add": ("hist_add_", 1), "hist_max": ("hist_max_", 1), "cms_rows_add": ("cms_rows_add_", 1),
                   "cms_walk": ("cms_walk_", 1), "binned_curve": ("binned_curve_", 2)}


def _graph_nodes(graph) -> int | None:
    """Nodes of a captured graph (``cudaGraphGetNodes`` on the graph the engine
    kept); None where the runtime library cannot be loaded."""
    import ctypes

    try:
        cudart = ctypes.CDLL("libcudart.so.12")
    except OSError:
        return None
    n = ctypes.c_size_t(0)
    code = cudart.cudaGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    return int(n.value) if code == 0 else None


def _k_submit(engine, reqs, threads: int) -> float:
    """Submit ``reqs`` from ``threads`` client threads (request i from thread
    i % threads), flush, check every receipt; the wall seconds of it all."""
    import gc
    import threading
    from concurrent.futures import wait

    from metrics_tpu_torch.utils.graphs import collector_paused

    futures, lock = [], threading.Lock()

    def client(tid: int) -> None:
        mine = [engine.submit(key, *args) for key, args in reqs[tid::threads]]
        with lock:
            futures.extend(mine)

    gc.collect()
    with collector_paused():  # the pause the engine's captures share: no capture sees it end
        t0 = time.perf_counter()
        workers = [threading.Thread(target=client, args=(tid,)) for tid in range(threads)]
        for th in workers:
            th.start()
        for th in workers:
            th.join(300)
            _check(not th.is_alive(), "a client thread did not finish")
        engine.flush(timeout=300)
        seconds = time.perf_counter() - t0
    done, not_done = wait(futures, timeout=60)
    _check(not not_done and len(done) == len(reqs), f"{len(not_done)} of {len(reqs)} futures unanswered")
    errors = [f.exception() for f in done if f.exception() is not None]
    _check(not errors, f"{len(errors)} requests failed, first: {errors[:1]!r}")
    return seconds


def _k_warm(engine, make_args, buckets, keys) -> int:
    """The benchmark's warm-up: every tenant allocated, one request a rung (each
    captures its bucket's graph), then a reset (in place: the graphs stay)."""
    for key in keys:
        engine._alloc_slot(key)
    for rows in buckets:
        engine.submit(keys[0], *make_args(rows)).result(timeout=300)
        engine.flush(timeout=300)
    engine.reset()
    return engine.telemetry_snapshot()["compiles"]


def _k_fold(torch, metric, reqs, dev: str):
    """Per-tenant sequential fold of whole requests through ``update_state`` on
    ``dev``, and each tenant's row count."""
    states, rows = {}, {}
    for key, args in reqs:
        state = states.get(key) or metric.init_state()
        states[key] = metric.update_state(state, *(torch.from_numpy(a).to(dev) for a in args))
        rows[key] = rows.get(key, 0) + args[0].shape[0]
    return states, rows


def _k_leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _k_leaves(sub, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree}


def _k_check_states(torch, engine, folds, rows, what: str, states=None) -> int:
    """Every tenant's engine state (or its entry in ``states``, read beforehand)
    equal to its fold, leaf for leaf with its dtype; ``_update_count`` counts
    rows (the engine updates a row at a time, the fold a request at a time).
    The number of leaves compared."""
    compared = 0
    for key, fold in folds.items():
        state = states[key] if states is not None else engine._keyed.state_of(key)
        got, want = _k_leaves(state), _k_leaves(fold)
        _check(set(got) == set(want), f"{what} {key}: leaves {sorted(got)} vs {sorted(want)}")
        for path, x in got.items():
            y = want[path]
            if path.endswith("_update_count"):
                _check(int(x) == rows[key], f"{what} {key} {path}: {int(x)} updates for {rows[key]} rows")
                continue
            _check(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), f"{what} {key}: {path} differs")
            compared += 1
    return compared


def _k_profile(torch, engine, reqs, threads: int, kernels) -> dict:
    """Device busy share, and the hand kernels' launches in the profile against
    captured launches x replays, over one window of ``reqs``; the window is
    profiled again (up to 3 times) while the counts disagree."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        before = engine.graph_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _profiler_lead_in(torch)
            wall_s = _k_submit(engine, reqs, threads)
        expected = {k: n - before.get(k, 0) for k, n in engine.graph_launches().items() if k in kernels}
        times = _kernel_times(prof, torch)
        seen = {k: sum(len(v) for name, v in times.items() if K_PROFILE_NAMES[k][0] in name) // K_PROFILE_NAMES[k][1]
                for k in kernels}
        if seen == expected or not times:
            break
    busy_us = sum(sum(v) for v in times.values())
    return {
        "wall_s": wall_s,
        "device_busy_us": busy_us,
        "idle_share": 1.0 - busy_us / (wall_s * 1e6) if times else None,
        "device_ops": sum(len(v) for v in times.values()),
        "launches_in_replays": expected,
        "launches_profiled": seen,
        "profile_attempts": attempt + 1,
        "top_kernels": [{"name": n[:80], "count": len(v), "us": sum(v)}
                        for n, v in sorted(times.items(), key=lambda kv: -sum(kv[1]))[:6]],
    }


def _k_graphs(engine) -> list:
    out = []
    for (sig, bucket, cap), kernel in engine._kernels.items():
        rec = next(r for r in engine.graph_stats() if (r["bucket"], r["capacity"]) == (bucket, cap)
                   and r["signature"] == sig)
        out.append({"bucket": bucket, "capacity": cap, "nodes": _graph_nodes(kernel.graph),
                    "warmup_ms": rec["warmup_ms"], "capture_ms": rec["capture_ms"], "pool_bytes": rec["pool_bytes"],
                    "captured_launches": rec["captured_launches"], "replays": rec["replays"]})
    return out


def _k_serve(torch, name: str, make, reqs, buckets, warm_args, kernels, threads: int = K_THREADS,
             profile_reqs=None, **engine_kw) -> tuple:
    """One engine on the card: warm-up over the ladder, the timed window, the
    state checks against a fold on the card, then a profiled window. Returns
    ``(record, engine, fold states, rows)``; the caller closes the engine."""
    from metrics_tpu_torch.engine import StreamingEngine

    keys = sorted({key for key, _ in reqs})
    engine = StreamingEngine(make(), buckets=buckets, max_queue=K_QUEUE, capacity=K_TENANTS, **engine_kw)
    warm = _k_warm(engine, warm_args, buckets, keys)
    _check(warm == len(buckets), f"{name}: {warm} captures in the warm-up for {len(buckets)} buckets")
    seconds = _k_submit(engine, reqs, threads)
    snap = engine.telemetry_snapshot()
    _check(snap["fused"] and snap["fused_fallbacks"] == 0, f"{name}: fused {snap['fused']}, "
           f"{snap['fused_fallbacks']} fallbacks")
    _check(snap["compiles"] == len(buckets), f"{name}: {snap['compiles']} captures for {len(buckets)} buckets")
    launched = engine.graph_launches()
    for k in kernels:
        _check(launched.get(k, 0) > 0, f"{name}: {k} was never launched inside a replay ({launched})")
    folds, rows = _k_fold(torch, make(), reqs, "cuda")
    compared = _k_check_states(torch, engine, folds, rows, name)
    n_rows = sum(args[0].shape[0] for _, args in reqs)
    rec = {
        "requests": len(reqs), "rows": n_rows, "tenants": len(keys), "threads": threads, "buckets": list(buckets),
        "req_per_s": len(reqs) / seconds, "rows_per_s": n_rows / seconds, "seconds": seconds,
        "latency_s": snap["latency_s"], "batches": snap["batches"], "mean_batch_occupancy": snap["mean_batch_occupancy"],
        "compiles": snap["compiles"], "fused_fallbacks": snap["fused_fallbacks"], "slab_bytes": snap["slab_bytes"],
        "state_leaves_equal": compared, "graph_launches": launched, "graphs": _k_graphs(engine),
    }
    # the least time a row could take: one tenant's state gathered (read once) and scattered back
    # (written once) over the card's memory rate
    rec["state_bytes_per_tenant"] = snap["slab_bytes"] // engine._keyed.capacity
    rec["state_bound_us_per_row"] = 2 * rec["state_bytes_per_tenant"] / HBM_BYTES_PER_S * 1e6
    if profile_reqs is not None:
        prof = _k_profile(torch, engine, profile_reqs, threads, kernels)
        _check(prof["launches_profiled"] == prof["launches_in_replays"] or prof["device_ops"] == 0,
               f"{name}: profiled launches {prof['launches_profiled']} vs replays {prof['launches_in_replays']}")
        prof_rows = sum(args[0].shape[0] for _, args in profile_reqs)
        prof["device_us_per_row"] = prof["device_busy_us"] / prof_rows
        prof["wall_us_per_row"] = prof["wall_s"] * 1e6 / prof_rows
        rec["profiled_window"] = prof
    return rec, engine, folds, rows


def _k_quantile_reqs(np, seed: int, n: int, tenants: int):
    rng = np.random.default_rng(seed)
    return [(f"tenant-{int(rng.integers(0, tenants))}", (rng.lognormal(0.0, 1.0, 1).astype(np.float32),))
            for _ in range(n)]


def phase_k1(torch, np) -> dict:
    """The quantile engine at benchmarks/engine_throughput.py --sketch's configuration."""
    from metrics_tpu_torch import QuantileSketch

    reqs = _k_quantile_reqs(np, 2, K1_REQUESTS, K_TENANTS)
    naive = QuantileSketch()
    stream = [torch.from_numpy(v).to("cuda") for _, (v,) in reqs[:K_NAIVE]]
    naive.update(stream[0])  # warm the eager update path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for v in stream:
        naive.update(v)
    torch.cuda.synchronize()
    naive_rps = K_NAIVE / (time.perf_counter() - t0)
    rng = np.random.default_rng(3)
    rec, engine, _, _ = _k_serve(
        torch, "K1", QuantileSketch, reqs, K_BUCKETS,
        lambda rows: (rng.lognormal(0.0, 1.0, rows).astype(np.float32),), ("hist_add",),
        profile_reqs=_k_quantile_reqs(np, 4, K_PROFILED, K_TENANTS),
    )
    engine.close()
    rec["naive_req_per_s"] = naive_rps
    rec["speedup_vs_naive"] = rec["req_per_s"] / naive_rps
    print(f"phase K1 {json.dumps(rec)}")
    return rec


def _k2_metric(dev: str = "cuda"):
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch.classification import MulticlassAccuracy, MulticlassConfusionMatrix, MulticlassF1Score

    return MetricCollection({
        "accuracy": MulticlassAccuracy(K2_CLASSES, average="micro", device=dev),
        "f1": MulticlassF1Score(K2_CLASSES, average="macro", device=dev),
        "confmat": MulticlassConfusionMatrix(K2_CLASSES, device=dev),
    })


def phase_k2(torch, np) -> dict:
    """The flagship metrics served: int64 label pairs, 8 tenants, 4 client threads."""
    rng = np.random.default_rng(5)

    def labels(rows):
        return rng.integers(0, K2_CLASSES, rows).astype(np.int64), rng.integers(0, K2_CLASSES, rows).astype(np.int64)

    reqs = [(f"tenant-{int(rng.integers(0, K_TENANTS))}", labels(int(rng.integers(K2_ROWS[0], K2_ROWS[1] + 1))))
            for _ in range(K2_REQUESTS)]
    reqs += [(f"tenant-{t}", labels(K2_BIG_ROWS)) for t in range(K_TENANTS)]
    profile_reqs = [(f"tenant-{int(rng.integers(0, K_TENANTS))}", labels(int(rng.integers(K2_ROWS[0], K2_ROWS[1] + 1))))
                    for _ in range(K_PROFILED // 4)]
    rec, engine, folds, rows = _k_serve(torch, "K2", _k2_metric, reqs, K_BUCKETS, labels,
                                        ("stat_scores", "pair_count"), profile_reqs=None)
    try:
        # the plain versions on the CPU: one update of each tenant's rows, concatenated
        cpu_metric = _k2_metric("cpu")
        for key in folds:
            mine = [args for k, args in reqs if k == key]
            cpu = cpu_metric.update_state(cpu_metric.init_state(),
                                          *(torch.from_numpy(np.concatenate(col)) for col in zip(*mine)))
            got = _k_leaves(engine._keyed.state_of(key))
            for path, want in _k_leaves(cpu).items():
                if not path.endswith("_update_count"):
                    _check(want.dtype == torch.int32 and torch.equal(got[path].cpu(), want),
                           f"K2 {key}: {path} differs from the CPU's plain versions")
        metric = _k2_metric()
        for key, fold in folds.items():
            got, want = engine.compute(key), metric.compute_from(fold)
            for name in want:
                _check(torch.equal(got[name], want[name]), f"K2 {key}: compute()[{name!r}] differs from the fold's")
        # the engine hook: the collection's update captured as one graph per shape
        updater, state, fold = metric.jitted_update_state(), metric.init_state(), metric.init_state()
        for _ in range(5):
            batch = [torch.from_numpy(a).to("cuda") for a in labels(64)]
            state, fold = updater(state, *batch), metric.update_state(fold, *batch)
        for path, want in _k_leaves(fold).items():
            _check(torch.equal(_k_leaves(state)[path], want), f"K2 jitted_update_state: {path} differs")
        rec["profiled_window"] = _k_profile(torch, engine, profile_reqs, K_THREADS, ("stat_scores", "pair_count"))
        prof = rec["profiled_window"]
        _check(prof["launches_profiled"] == prof["launches_in_replays"] or prof["device_ops"] == 0,
               f"K2: profiled launches {prof['launches_profiled']} vs replays {prof['launches_in_replays']}")
        prof_rows = sum(args[0].shape[0] for _, args in profile_reqs)
        prof["device_us_per_row"] = prof["device_busy_us"] / prof_rows
        prof["wall_us_per_row"] = prof["wall_s"] * 1e6 / prof_rows
        prof["launches_per_row"] = {k: n / prof_rows for k, n in prof["launches_in_replays"].items()}
    finally:
        engine.close()
    rec["launches_per_row"] = {k: sum(g["captured_launches"].get(k, 0) for g in rec["graphs"]) /
                               sum(g["bucket"] for g in rec["graphs"]) for k in ("stat_scores", "pair_count")}
    print(f"phase K2 {json.dumps(rec)}")
    return rec


def phase_k3(torch, np) -> dict:
    """Heavy hitters: the four kernels of the ledger walk inside a graph; one client
    thread, so each tenant's (order-dependent) ledger follows its submission order."""
    from metrics_tpu_torch import HeavyHittersSketch

    rng = np.random.default_rng(7)

    def ids(rows):
        return (np.minimum(rng.zipf(ZIPF_S, rows), ZIPF_IDS).astype(np.int32),)

    reqs = [(f"tenant-{int(rng.integers(0, K3_TENANTS))}", ids(1)) for _ in range(K3_REQUESTS)]
    rec, engine, _, _ = _k_serve(torch, "K3", lambda: HeavyHittersSketch(k=32, depth=4, width=2048), reqs,
                                 K3_BUCKETS, ids, ("cms_walk",), threads=1)
    engine.close()
    print(f"phase K3 {json.dumps(rec)}")
    return rec


def phase_k4(torch, np) -> dict:
    """Binned AUROC: one binned_curve launch a row inside a graph."""
    from metrics_tpu_torch.classification import BinaryAUROC

    rng = np.random.default_rng(9)

    def scores(rows):
        return rng.random(rows).astype(np.float32), rng.integers(0, 2, rows).astype(np.int64)

    reqs = [(f"tenant-{int(rng.integers(0, K_TENANTS))}", scores(int(rng.integers(K4_ROWS[0], K4_ROWS[1] + 1))))
            for _ in range(K4_REQUESTS)]
    rec, engine, folds, _ = _k_serve(torch, "K4", lambda: BinaryAUROC(thresholds=CURVE_T), reqs, K_BUCKETS, scores,
                                     ("binned_curve",))
    try:
        metric = BinaryAUROC(thresholds=CURVE_T)
        for key, fold in folds.items():
            _check(torch.equal(engine.compute(key), metric.compute_from(fold)), f"K4 {key}: AUROC differs")
    finally:
        engine.close()
    print(f"phase K4 {json.dumps(rec)}")
    return rec


def phase_k5(torch, np, scatter) -> dict:
    """The ladder: an update that reads a value on the host cannot be captured;
    the engine demotes once and serves eagerly on the card, its kernels launched."""
    from metrics_tpu_torch import QuantileSketch
    from metrics_tpu_torch.engine import StreamingEngine

    class HostCheckedQuantiles(QuantileSketch):
        """Refuses non-finite values, read on the host (one sync an update)."""

        def update(self, value):
            if not bool(torch.isfinite(value).all()):
                raise ValueError("non-finite value")
            super().update(value)

    reqs = _k_quantile_reqs(np, 11, K5_REQUESTS, K_TENANTS)
    engine = StreamingEngine(HostCheckedQuantiles(), buckets=K3_BUCKETS, max_queue=K_QUEUE, capacity=K_TENANTS)
    try:
        before = scatter.launches["hist_add"]
        seconds = _k_submit(engine, reqs, K_THREADS)
        snap = engine.telemetry_snapshot()
        _check(snap["fused_fallbacks"] == 1 and not snap["fused"] and not snap["degraded"],
               f"K5: fused {snap['fused']}, {snap['fused_fallbacks']} fallbacks, degraded {snap['degraded']}")
        _check(snap["processed"] == len(reqs) and snap["failed"] == 0, f"K5: {snap['processed']} processed")
        _check(engine.graph_launches() == {}, "K5: a graph survived the demotion")
        eager = scatter.launches["hist_add"] - before
        _check(eager >= 2 * len(reqs), f"K5: {eager} hist_add launches for {len(reqs)} eager updates")
        folds, rows = _k_fold(torch, HostCheckedQuantiles(), reqs, "cuda")
        compared = _k_check_states(torch, engine, folds, rows, "K5")
        # the demoted engine's read path (eager states, no slab) against the fold
        metric, everything = HostCheckedQuantiles(), engine.compute_all()
        _check(set(everything) == set(folds), f"K5: compute_all keys {sorted(everything)}")
        for key, fold in folds.items():
            want = metric.compute_from(fold)
            for what, got in (("compute", engine.compute(key)), ("compute_all", everything[key])):
                _check(torch.isfinite(got).all().item() and torch.equal(got.cpu(), want.cpu()),
                       f"K5: {what}({key}) {got.tolist()} vs the fold's {want.tolist()}")
        _check(torch.randn(4, device="cuda").isfinite().all().item(), "K5: random numbers after a failed capture")
        rec = {"requests": len(reqs), "req_per_s": len(reqs) / seconds, "fused_fallbacks": snap["fused_fallbacks"],
               "compiles": snap["compiles"], "hist_add_launches_eager": eager, "state_leaves_equal": compared,
               "reads_equal": 2 * len(folds), "latency_s": snap["latency_s"]}
    finally:
        engine.close()
    print(f"phase K5 {json.dumps(rec)}")
    return rec


def _k6_reqs(np, n: int, tenants: int):
    """benchmarks/engine_throughput.py's stream: seed 0, per request a tenant, then
    int64 batch-1 preds and targets in {0, 1}, drawn in that order."""
    rng = np.random.default_rng(0)
    return [(f"tenant-{rng.integers(0, tenants)}", (rng.integers(0, 2, 1), rng.integers(0, 2, 1))) for _ in range(n)]


def phase_k6(torch, np) -> dict:
    """The JAX engine benchmark's headline configuration: ``BinaryAccuracy()`` with
    its value checks on, buckets (64, 256), max_queue 2048, capacity 8; 8000 batch-1
    requests over 8 tenants from 4 threads, beside 300 per-call forwards.
    Then ``evict_tenant`` on the served engine: the tenant's slot is reused and its
    replays start from a fresh state, with no new capture, while the other
    tenants keep their states."""
    from metrics_tpu_torch.classification import BinaryAccuracy

    reqs = _k6_reqs(np, K1_REQUESTS, K_TENANTS)
    naive = BinaryAccuracy(device="cuda")
    stream = [tuple(torch.from_numpy(a).to("cuda") for a in args) for _, args in reqs[:K_NAIVE]]
    naive(*stream[0])  # warm the eager forward
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p, t in stream:
        naive(p, t)
    torch.cuda.synchronize()
    naive_rps = K_NAIVE / (time.perf_counter() - t0)
    rng = np.random.default_rng(13)
    rec, engine, folds, rows = _k_serve(
        torch, "K6", lambda: BinaryAccuracy(device="cuda"), reqs, K_BUCKETS,
        lambda rows: (rng.integers(0, 2, rows), rng.integers(0, 2, rows)), (),
        profile_reqs=_k6_reqs(np, K_PROFILED, K_TENANTS),
    )
    # the profiled window served the same tenants again: fold it too, so the
    # other tenants can be checked after the eviction
    fold = BinaryAccuracy(device="cuda")
    for key, args in _k6_reqs(np, K_PROFILED, K_TENANTS):
        folds[key] = fold.update_state(folds[key], *(torch.from_numpy(a).to("cuda") for a in args))
        rows[key] += args[0].shape[0]
    try:
        _check(engine.evict_tenant("tenant-0") is True, "K6: evict_tenant('tenant-0') did not return True")
        _check("tenant-0" not in engine.compute_all(), "K6: the evicted tenant is still read")
        _check(engine.evict_tenant("tenant-0") is False, "K6: a second eviction of the same tenant returned True")
        again = [("tenant-0", args) for _, args in _k6_reqs(np, 64, 1)]
        compiles = engine.telemetry_snapshot()["compiles"]
        _k_submit(engine, again, 1)
        snap = engine.telemetry_snapshot()
        _check(snap["compiles"] == compiles and snap["fused"] and snap["fused_fallbacks"] == 0,
               f"K6: {snap['compiles'] - compiles} captures, fused {snap['fused']} after the eviction")
        others = {key: fold for key, fold in folds.items() if key != "tenant-0"}
        kept = _k_check_states(torch, engine, others, rows, "K6 another tenant after the eviction")
        fresh, fresh_rows = _k_fold(torch, BinaryAccuracy(device="cuda"), again, "cuda")
        _k_check_states(torch, engine, fresh, fresh_rows, "K6 after the eviction")
        rec["eviction"] = {"evicted": "tenant-0", "resubmitted": len(again), "captures_after": snap["compiles"] - compiles,
                           "tier_evictions": snap["tier_evictions"], "state_equals_fresh_tenant": True,
                           "other_tenants_leaves_equal": kept}
    finally:
        engine.close()
    # C.4 on the graphed updater: a label above C is dropped (as under jax.jit), not refused,
    # on the call that captures the graph and on a replay alike
    from metrics_tpu_torch.classification import MulticlassConfusionMatrix

    cm = MulticlassConfusionMatrix(3, device="cuda")
    updater, state = cm.jitted_update_state(donate=False), cm.init_state()
    bad = [torch.tensor(v, dtype=torch.int32, device="cuda") for v in ([0, 1], [0, 3])]
    for _ in range(2):
        state = updater(state, *bad)
    _check(state["confmat"].tolist() == [[2, 0, 0], [0, 0, 0], [0, 0, 0]],
           f"K6 jitted_update_state on a label above C: {state['confmat'].tolist()}")
    rec["naive_req_per_s"] = naive_rps
    rec["speedup_vs_naive"] = rec["req_per_s"] / naive_rps
    rec["jax_gate"] = 10.0  # benchmarks/engine_throughput.py's speedup_ge_10x, a record here (ROADMAP B.2 item 8)
    for g in rec["graphs"]:
        g["nodes_per_row"] = g["nodes"] / g["bucket"] if g["nodes"] is not None else None
    print(f"phase K6 {json.dumps(rec)}")
    return rec


def phase_k(torch, scatter) -> dict:
    """The port's StreamingEngine on the card (K1 to K6)."""
    import numpy as np

    t0 = time.perf_counter()
    out = {"K1": phase_k1(torch, np), "K2": phase_k2(torch, np), "K3": phase_k3(torch, np),
           "K4": phase_k4(torch, np), "K5": phase_k5(torch, np, scatter), "K6": phase_k6(torch, np)}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase K: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------- Phase L: binary, multilabel, MSE

L_N = 10**6  # scores per update (benchmarks/classification_vs_reference.py's N)
L_C = 100  # that benchmark's C: the multilabel shape is L_N // L_C samples x L_C labels
L_FAMILY = {"StatScores": "stat_scores", "ConfusionMatrix": "confusion_matrix", "Accuracy": "accuracy",
            "F1Score": "f1_score", "Precision": "precision", "Recall": "recall", "Specificity": "specificity"}
L_TIMED = 10  # updates timed by CUDA events
L_PROFILED = 20  # updates under the profiler


def _l_batches(np):
    """benchmarks/classification_vs_reference.py's binary scores (seed 0, drawn after
    its two label arrays) and a second batch drawn after them."""
    rng = np.random.default_rng(0)
    rng.integers(0, L_C, L_N)
    rng.integers(0, L_C, L_N)
    return [(rng.random(L_N).astype(np.float32), rng.integers(0, 2, L_N).astype(np.int32)) for _ in range(2)]


def _l_equal(torch, got, want, what: str, rtol: float = 1e-6) -> None:
    """Integer results bit-identical with their dtype; float results within ``rtol``."""
    got = got.cpu()
    _check(got.dtype == want.dtype and got.shape == want.shape, f"{what}: {got.dtype}{tuple(got.shape)} vs "
           f"{want.dtype}{tuple(want.shape)}")
    ok = torch.equal(got, want) if not want.is_floating_point() else torch.allclose(got, want, rtol=rtol, atol=0)
    _check(ok, f"{what}: differs from the CPU recomputation")


def _l_profile(torch, run, iters: int = L_PROFILED) -> dict:
    """Device time, idle share and device kernels of one update, under the profiler (as Phase I)."""
    kernels, wall_us = _profile_steps(torch, run, iters)
    busy_us = sum(sum(v) for v in kernels.values())
    return {
        "device_busy_us_per_update": busy_us / iters,
        "wall_us_per_update_under_profiler": wall_us / iters,
        "idle_share": 1.0 - busy_us / wall_us if wall_us else None,
        "launches_per_update": sum(len(v) for v in kernels.values()) / iters,
        "top_kernels": [{"name": name[:70], "launches_per_update": len(v) / iters, "us_per_update": sum(v) / iters}
                        for name, v in sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:4]],
    }


def _l_task(torch, task: str, batches, **kw) -> dict:
    """The seven stat-score families of ``task`` through their class, their
    task façade (``StatScores(task=...)``), their functional and their functional
    façade on the card: int32 states and counts equal to the CPU's plain code,
    values within rtol 1e-6; each class update timed and profiled."""
    import metrics_tpu_torch.classification as cls
    import metrics_tpu_torch.functional.classification as fc

    dev_batches = [tuple(torch.from_numpy(a).to("cuda") for a in b) for b in batches]
    cpu_batches = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    out = {}
    for family, fn_name in L_FAMILY.items():
        name = f"{task.capitalize()}{family}"
        make = getattr(cls, name)
        # each route beside its CPU twin: the façades' defaults (average="micro") are not the classes'
        routes = {"class": lambda d: make(**kw, device=d),
                  "facade": lambda d: getattr(cls, family)(task=task, **kw, device=d)}
        compared = 0
        for route, build in routes.items():
            m, cpu = build("cuda"), build("cpu")
            _check(type(m) is make, f"{name} ({route}) built {type(m).__name__}")
            for b, c in zip(dev_batches, cpu_batches):
                m.update(*b)
                cpu.update(*c)
            for key in cpu._defaults:
                want = getattr(cpu, key)
                _check(want.dtype == torch.int32, f"{name}.{key} is {want.dtype} on the CPU")
                _l_equal(torch, getattr(m, key), want, f"{name} ({route}) state {key}")
                compared += 1
            _l_equal(torch, m.compute(), cpu.compute(), f"{name} ({route}) compute()")
        fn, facade = getattr(fc, f"{task}_{fn_name}"), getattr(fc, fn_name)
        _l_equal(torch, fn(*dev_batches[-1], **kw), fn(*cpu_batches[-1], **kw), f"{task}_{fn_name}")
        _l_equal(torch, facade(*dev_batches[-1], task=task, **kw), facade(*cpu_batches[-1], task=task, **kw),
                 f"{fn_name}(task={task!r})")
        rec = {"states_equal": compared, "routes": ["class", "facade", "functional", "functional_facade"]}
        m, unchecked = make(**kw, device="cuda"), make(**kw, device="cuda", validate_args=False)
        rec["ms_per_update"] = _time_ms(lambda: m.update(*dev_batches[0]), L_TIMED, warmup=2)
        rec["ms_per_update_unvalidated"] = _time_ms(lambda: unchecked.update(*dev_batches[0]), L_TIMED, warmup=2)
        rec.update(_l_profile(torch, lambda: m.update(*dev_batches[0])))
        out[name] = rec
        print(f"phase L {name} {json.dumps(rec)}")
    return out


def _l_mse(torch, np) -> dict:
    """benchmarks/regression_vs_reference.py's pairs through ``MeanSquaredError``:
    the float32 sum within rtol 1e-5 of a float64 sum on the CPU and of the
    port's plain code on the CPU, the count exact."""
    from metrics_tpu_torch.functional import mean_squared_error
    from metrics_tpu_torch.regression import MeanSquaredError

    rng = np.random.default_rng(0)
    p = rng.normal(size=L_N).astype(np.float32)
    t = (0.8 * p + 0.2 * rng.normal(size=L_N)).astype(np.float32)
    dp, dt = torch.from_numpy(p).to("cuda"), torch.from_numpy(t).to("cuda")
    rtol = 1e-5  # float32 sums of 10^6 squares in the card's order against float64 and the CPU's order
    m, cpu = MeanSquaredError(device="cuda"), MeanSquaredError(device="cpu")
    for _ in range(2):
        m.update(dp, dt)
        cpu.update(torch.from_numpy(p), torch.from_numpy(t))
    want64 = 2 * float(np.sum((p.astype(np.float64) - t.astype(np.float64)) ** 2))
    got = m.sum_squared_error.cpu()
    _check(got.dtype == torch.float32 and m.total.dtype == torch.float32, "MeanSquaredError states are not float32")
    _check(abs(float(got) - want64) <= rtol * want64, f"MSE sum {float(got)} vs float64 {want64}")
    _l_equal(torch, got, cpu.sum_squared_error, "MSE sum_squared_error", rtol)
    _check(float(m.total) == 2 * L_N, f"MSE total {float(m.total)}")
    _l_equal(torch, m.compute(), cpu.compute(), "MSE compute()", rtol)
    _l_equal(torch, mean_squared_error(dp, dt), mean_squared_error(torch.from_numpy(p), torch.from_numpy(t)),
             "mean_squared_error", rtol)
    rec = {"n": L_N, "sum_squared_error": float(got), "float64_sum": want64, "rtol": rtol}
    one = MeanSquaredError(device="cuda")
    rec["ms_per_update"] = _time_ms(lambda: one.update(dp, dt), L_TIMED, warmup=2)
    rec.update(_l_profile(torch, lambda: one.update(dp, dt)))
    print(f"phase L MeanSquaredError {json.dumps(rec)}")
    return rec


def phase_l(torch, np) -> dict:
    """The binary and multilabel stat-score families and MeanSquaredError at the JAX
    benchmarks' sizes: plain torch code, no hand kernel."""
    t0 = time.perf_counter()
    batches = _l_batches(np)
    out = {"binary": _l_task(torch, "binary", batches)}
    shaped = [tuple(a.reshape(L_N // L_C, L_C) for a in b) for b in batches]
    out["multilabel"] = _l_task(torch, "multilabel", shaped, num_labels=L_C)
    out["MeanSquaredError"] = _l_mse(torch, np)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase L: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------- Phase M: the durable state plane

M_PAIRS = 1  # plain/checkpointing pairs of benchmarks/engine_throughput.py's overhead gate (:442-476; 6 there)
M_INTERVAL_S = 0.25  # that gate's CheckpointConfig(interval_s=0.25, retain=3)
M_RETAIN = 3
M_GATE_PCT = 5.0  # its ckpt_overhead_lt_5pct: a record here (the engine's rate moves between calls)
M2_QUANTILE_REQUESTS = 1000  # the depth cut (4000 there, 2000 before Phase V)
M2_FLAGSHIP_REQUESTS = 500  # (2000 there, 1000 before Phase V)
M3_CPU_REQUESTS = 40
M3_BATCH = 4096  # labels per update of the collection saved and restored on the card


def _m_filesystem(path: str) -> str:
    out = subprocess.run(["stat", "-f", "-c", "%T", path], capture_output=True, text=True)
    return out.stdout.strip() or "unknown"


def _m_states(engine) -> dict:
    """Copies of every tenant's live state (read under the dispatch lock)."""
    return {key: engine._keyed.state_of(key) for key in engine._keyed.keys}


def _m_equal(torch, got: dict, want: dict, what: str) -> int:
    """Every tenant's every leaf equal with its dtype (across devices too); the
    number of leaves compared."""
    _check(set(got) == set(want), f"{what}: tenants {sorted(got)} vs {sorted(want)}")
    compared = 0
    for key in want:
        a, b = _k_leaves(got[key]), _k_leaves(want[key])
        _check(set(a) == set(b), f"{what} {key}: leaves {sorted(a)} vs {sorted(b)}")
        for path, x in a.items():
            y = b[path]
            _check(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), f"{what} {key}: {path} differs")
            compared += 1
    return compared


def _m_timed(fn, spent: dict, key: str):
    """``fn`` adding its wall ms to ``spent[key]`` at each call."""

    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent[key] += (time.perf_counter() - t0) * 1e3

    return run


def _m_cpu_timed(fn, spent: dict, key: str):
    """``fn`` adding the CPU ms its thread spends in it to ``spent[key]`` at each
    call (``time.thread_time``: waits for the GIL and sleeps do not count)."""

    def run(*args, **kwargs):
        t0 = time.thread_time()
        try:
            return fn(*args, **kwargs)
        finally:
            spent[key] += (time.thread_time() - t0) * 1e3

    return run


def _m1_pass(torch, np, reqs, folds, rows, ckpt_dir) -> dict:
    """One warmed, timed K6 pass (the benchmark's run_engine_pass), with
    checkpointing when ``ckpt_dir`` is given; states held to the fold. A
    checkpointing pass also sums the dispatcher's wall ms in the WAL (each
    chunk record's encode, append and flush) and in the snapshot views."""
    from metrics_tpu_torch.classification import BinaryAccuracy
    from metrics_tpu_torch.engine import CheckpointConfig, StreamingEngine

    cfg = None if ckpt_dir is None else CheckpointConfig(directory=ckpt_dir, interval_s=M_INTERVAL_S,
                                                          retain=M_RETAIN)
    engine = StreamingEngine(BinaryAccuracy(device="cuda"), buckets=K_BUCKETS, max_queue=K_QUEUE,
                             capacity=K_TENANTS, checkpoint=cfg)
    try:
        rng = np.random.default_rng(13)
        _k_warm(engine, lambda n: (rng.integers(0, 2, n), rng.integers(0, 2, n)), K_BUCKETS,
                sorted({key for key, _ in reqs}))
        before = engine.telemetry_snapshot()
        wal_bytes = engine._journal.appended_bytes if cfg is not None else 0
        spent = {"journal_ms": 0.0, "view_ms": 0.0}
        if cfg is not None:
            engine._journal_chunk = _m_timed(engine._journal_chunk, spent, "journal_ms")
            engine._checkpoint_view = _m_timed(engine._checkpoint_view, spent, "view_ms")
        seconds = _k_submit(engine, reqs, K_THREADS)
        spent = dict(spent)  # the timed window's: close() takes one more view
        after = engine.telemetry_snapshot()
        _k_check_states(torch, engine, folds, rows, "M1")
        rec = {"req_per_s": len(reqs) / seconds}
        if cfg is not None:
            health = engine.health()
            _check(after["checkpoint_failures"] == 0 and not health["wal_disabled"],
                   f"M1: {after['checkpoint_failures']} checkpoint failures, wal_disabled {health['wal_disabled']}")
            rec.update(snapshots=after["checkpoints"] - before["checkpoints"],
                       wal_records=after["wal_records"] - before["wal_records"],
                       wal_bytes=engine._journal.appended_bytes - wal_bytes, seconds=seconds, **spent)
        return rec
    finally:
        engine.close()


def phase_m1(torch, np, obs, instrument, root=None) -> dict:
    """Checkpoint overhead at K6's configuration, by the JAX benchmark's procedure:
    6 pairs of passes, plain and checkpointing (a snapshot every 0.25 s, 3 kept,
    the WAL on) in a temporary directory under ``root`` (None: the temporary
    directory's default), alternating which goes first; the median of the
    per-pair ratios, less one, is the overhead."""
    import statistics
    import tempfile

    reqs = _k6_reqs(np, K1_REQUESTS, K_TENANTS)
    from metrics_tpu_torch.classification import BinaryAccuracy

    folds, rows = _k_fold(torch, BinaryAccuracy(device="cuda"), reqs, "cuda")
    obs.enable()  # the write histogram; on for both sides of every pair
    try:
        writes0 = (instrument.CKPT_SECONDS.count(site="engine", op="write"),
                   instrument.CKPT_SECONDS.sum(site="engine", op="write"))
        plain, ckpt, ratios, fs = [], [], [], None
        for i in range(M_PAIRS):
            order = ("plain", "ckpt") if i % 2 == 0 else ("ckpt", "plain")
            got = {}
            for side in order:
                if side == "plain":
                    got[side] = _m1_pass(torch, np, reqs, folds, rows, None)
                else:
                    with tempfile.TemporaryDirectory(dir=root) as d:
                        fs = _m_filesystem(d)
                        got[side] = _m1_pass(torch, np, reqs, folds, rows, d)
            plain.append(got["plain"])
            ckpt.append(got["ckpt"])
            ratios.append(got["plain"]["req_per_s"] / got["ckpt"]["req_per_s"])
        writes = instrument.CKPT_SECONDS.count(site="engine", op="write") - writes0[0]
        write_s = instrument.CKPT_SECONDS.sum(site="engine", op="write") - writes0[1]
    finally:
        obs.disable()
    overhead_pct = (statistics.median(ratios) - 1.0) * 100.0
    rec = {
        "overhead_pct": overhead_pct, "gate_pct": M_GATE_PCT, "within_gate": overhead_pct < M_GATE_PCT,
        "pair_ratios": ratios, "plain_best_req_per_s": max(r["req_per_s"] for r in plain),
        "ckpt_best_req_per_s": max(r["req_per_s"] for r in ckpt),
        "plain_req_per_s": [r["req_per_s"] for r in plain], "ckpt_req_per_s": [r["req_per_s"] for r in ckpt],
        "snapshots_per_pass": [r["snapshots"] for r in ckpt], "wal_records_per_pass": [r["wal_records"] for r in ckpt],
        "wal_bytes_per_pass": [r["wal_bytes"] for r in ckpt],
        # the dispatcher's share of a checkpointing pass: WAL and snapshot views
        "dispatcher_journal_ms_per_pass": [r["journal_ms"] for r in ckpt],
        "dispatcher_view_ms_per_pass": [r["view_ms"] for r in ckpt],
        "dispatcher_share": [(r["journal_ms"] + r["view_ms"]) / (r["seconds"] * 1e3) for r in ckpt],
        "snapshot_writes": writes, "write_ms_per_snapshot": write_s * 1e3 / writes if writes else None,
        "filesystem": fs, "requests": len(reqs), "interval_s": M_INTERVAL_S, "retain": M_RETAIN,
    }
    # every checkpointing pass commits its final snapshot at close(), and those inside its
    # timed window as they fall due (``snapshots_per_pass``: a window shorter than the
    # interval may hold none)
    _check(writes >= M_PAIRS, f"M1: {writes} snapshot writes in {M_PAIRS} checkpointing passes")
    print(f"phase M1 ({fs}) {json.dumps(rec)}")
    return rec


def _m2_crash_and_recover(torch, np, name, make, reqs, kernels, directory) -> tuple:
    """Serve half, snapshot, serve the rest, crash (no final snapshot), recover on
    the card; hold the recovered states to the crashed engine's and to the fold,
    and the replay's hand-kernel launches to captured x replays. Returns
    ``(record, recovered engine, fold states, rows)``."""
    from torch.profiler import ProfilerActivity, profile

    from metrics_tpu_torch.engine import CheckpointConfig, StreamingEngine
    from metrics_tpu_torch.kernels import launch_counts

    kw = dict(buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=K_TENANTS,
              checkpoint=CheckpointConfig(directory=directory, interval_s=3600.0, retain=M_RETAIN))
    engine = StreamingEngine(make(), **kw)
    half = len(reqs) // 2
    _k_submit(engine, reqs[:half], K_THREADS)
    t0 = time.perf_counter()
    gen = engine.checkpoint_now()
    snapshot_write_ms = (time.perf_counter() - t0) * 1e3
    _check(gen is not None, f"{name}: checkpoint_now() failed: {engine._ckpt_writer.last_error!r}")
    snapshot_bytes = os.path.getsize(engine._ckpt_store.path(gen))
    _k_submit(engine, reqs[half:], K_THREADS)
    crashed = _m_states(engine)
    wal_rows = sum(args[0].shape[0] for _, args in reqs[half:])
    engine.close(checkpoint=False)  # the crash: the WAL holds everything after the snapshot
    folds, rows = _k_fold(torch, make(), reqs, "cuda")

    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec_engine = StreamingEngine(make(), **kw)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    counted = {k: n - before[k] for k, n in launch_counts().items()}
    snap = rec_engine.telemetry_snapshot()
    graphs = rec_engine.graph_stats()
    replays = sum(g["replays"] for g in graphs)
    _check(snap["recoveries"] == 1 and snap["replayed"] >= 1 and snap["failed"] == 0,
           f"{name}: recoveries {snap['recoveries']}, replayed {snap['replayed']}, failed {snap['failed']}")
    _check(snap["fused"] and snap["fused_fallbacks"] == 0 and rec_engine.device.type == "cuda",
           f"{name}: the recovery left the card's graphs (fused {snap['fused']}, device {rec_engine.device})")
    _check(replays == snap["replayed"], f"{name}: {replays} graph replays for {snap['replayed']} chunk records")
    compared = _m_equal(torch, _m_states(rec_engine), crashed, f"{name} recovered vs crashed")
    _k_check_states(torch, rec_engine, folds, rows, f"{name} recovered vs fold")
    in_replays = rec_engine.graph_launches()
    captured = {k: sum(g["captured_launches"].get(k, 0) for g in graphs) for k in kernels}
    for k in kernels:
        _check(in_replays.get(k, 0) > 0, f"{name}: {k} never launched in the replay ({in_replays})")
        # each graph's warm-up and capture run the wrappers once each: the counters
        # advance twice what a graph captured, never at a replay
        _check(counted.get(k, 0) == 2 * captured[k], f"{name}: {k} counted {counted.get(k, 0)}, "
               f"captured {captured[k]}")

    # the replay under the profiler: each hand kernel's device launches equal
    # captured x (replays + the warm-up); the recovery is repeatable (nothing is written)
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _profiler_lead_in(torch)
            again = StreamingEngine(make(), **kw)
            torch.cuda.synchronize()
        g2 = again.graph_stats()
        expected = {k: sum(g["captured_launches"].get(k, 0) * (g["replays"] + 1) for g in g2) for k in kernels}
        again.close(checkpoint=False)
        times = _kernel_times(prof, torch)
        seen = {k: sum(len(v) for n, v in times.items() if K_PROFILE_NAMES[k][0] in n) // K_PROFILE_NAMES[k][1]
                for k in kernels}
        if seen == expected or not times:
            break
    _check(seen == expected or not times, f"{name}: profiled launches {seen} vs captured x (replays + 1) {expected}")

    # a new tenant after recovery gets a fresh slot and a fresh state
    used = set(rec_engine._keyed._slots.values())
    args = reqs[0][1]
    rec_engine.submit("tenant-new", *args).result(timeout=300)
    rec_engine.flush(timeout=300)
    _check(rec_engine._keyed._slots["tenant-new"] not in used, f"{name}: the new tenant took an existing slot")
    fresh, fresh_rows = _k_fold(torch, make(), [("tenant-new", args)], "cuda")
    _k_check_states(torch, rec_engine, fresh, fresh_rows, f"{name} new tenant")
    folds.update(fresh)
    rows.update(fresh_rows)
    rec = {
        "requests": len(reqs), "snapshot_generation": gen, "snapshot_bytes": snapshot_bytes,
        "snapshot_write_ms": snapshot_write_ms, "recovery_ms": recovery_s * 1e3,
        "records_replayed": snap["replayed"], "rows_replayed": wal_rows, "replay_rows_per_s": wal_rows / recovery_s,
        # of the recovery: each graph's warm-up and capture, the rest is reading, restoring, replaying
        "capture_ms": sum(g["warmup_ms"] + g["capture_ms"] for g in graphs),
        "graphs_captured": len(graphs), "graph_replays": replays, "launches_in_replays": in_replays,
        "launches_counted": {k: counted.get(k, 0) for k in kernels}, "launches_profiled": seen,
        "profile_attempts": attempt + 1, "leaves_equal": compared,
    }
    print(f"phase M2 {name} {json.dumps(rec)}")
    return rec, rec_engine, folds, rows


def phase_m(torch, np, obs, instrument) -> dict:
    """The durable state plane on the card: M1 the checkpoint overhead, M2 crash
    and recovery, M3 snapshots across devices and save/restore."""
    import tempfile

    from metrics_tpu_torch import QuantileSketch
    from metrics_tpu_torch.engine import CheckpointConfig, StreamingEngine

    t0 = time.perf_counter()
    out = {"M1": phase_m1(torch, np, obs, instrument)}
    if os.path.isdir("/dev/shm"):
        # the same procedure in memory: what the filesystem adds to the overhead
        out["M1_shm"] = phase_m1(torch, np, obs, instrument, root="/dev/shm")
    rng = np.random.default_rng(17)

    def labels(n):
        return rng.integers(0, K2_CLASSES, n).astype(np.int64), rng.integers(0, K2_CLASSES, n).astype(np.int64)

    with tempfile.TemporaryDirectory() as qdir, tempfile.TemporaryDirectory() as fdir:
        out["M2_quantile"], engine, _, _ = _m2_crash_and_recover(
            torch, np, "quantile", QuantileSketch, _k_quantile_reqs(np, 19, M2_QUANTILE_REQUESTS, K_TENANTS),
            ("hist_add",), qdir)
        engine.close(checkpoint=False)
        flagship = [(f"tenant-{int(rng.integers(0, K_TENANTS))}", labels(int(rng.integers(K2_ROWS[0], K2_ROWS[1] + 1))))
                    for _ in range(M2_FLAGSHIP_REQUESTS)]
        out["M2_flagship"], engine, _, _ = _m2_crash_and_recover(
            torch, np, "flagship", _k2_metric, flagship, ("stat_scores", "pair_count"), fdir)

        # M3: the card's final snapshot restores into a CPU engine; the CPU engine's
        # snapshot, and the T record of an eviction after it, restore on the card
        card = _m_states(engine)
        engine.close()  # the final snapshot, written on the card
        kw = dict(buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=K_TENANTS,
                  checkpoint=CheckpointConfig(directory=fdir, interval_s=3600.0, retain=M_RETAIN))
        cpu = StreamingEngine(_k2_metric("cpu"), **kw)
        try:
            snap = cpu.telemetry_snapshot()
            _check(snap["recoveries"] == 1 and snap["replayed"] == 0, f"M3 CPU: {snap['recoveries']} recoveries, "
                   f"{snap['replayed']} replayed")
            to_cpu = _m_equal(torch, _m_states(cpu), card, "M3 card snapshot on the CPU")
            _k_submit(cpu, flagship[:M3_CPU_REQUESTS], 1)
            cpu.checkpoint_now()
            _check(cpu.evict_tenant("tenant-3") is True, "M3: evict_tenant('tenant-3') on the CPU engine")
            on_cpu = _m_states(cpu)
        finally:
            cpu.close(checkpoint=False)
        back = StreamingEngine(_k2_metric("cuda"), **kw)
        try:
            snap = back.telemetry_snapshot()
            _check(snap["recoveries"] == 1 and snap["replayed"] == 1 and snap["failed"] == 0,
                   f"M3 card: {snap['recoveries']} recoveries, {snap['replayed']} replayed (the T record)")
            _check("tenant-3" not in back._keyed.keys, "M3: the evicted tenant is back after recovery")
            to_card = _m_equal(torch, _m_states(back), on_cpu, "M3 CPU snapshot on the card")
        finally:
            back.close(checkpoint=False)

        # MetricCollection.save/restore of the flagship collection on the card
        col = _k2_metric()
        for _ in range(3):
            col.update(*(torch.from_numpy(a).to("cuda") for a in labels(M3_BATCH)))
        path = os.path.join(fdir, "flagship.ckpt")
        col.save(path)
        restored, on_cpu_col = _k2_metric(), _k2_metric("cpu")
        restored.restore(path)
        on_cpu_col.restore(path)
        for name, m in col._modules.items():
            for state in m._defaults:
                for other in (restored, on_cpu_col):
                    got = getattr(other._modules[name], state)
                    _check(got.dtype == getattr(m, state).dtype and torch.equal(got.cpu(), getattr(m, state).cpu()),
                           f"M3 save/restore: {name}.{state} differs on {got.device}")
        # the values: equal on the card; on the CPU within the parity tolerance (the
        # macro F1's mean over 1000 classes adds in another order there)
        want, on_cpu_values = col.compute(), on_cpu_col.compute()
        for name, value in restored.compute().items():
            _check(torch.equal(value, want[name]), f"M3 save/restore: compute()[{name!r}] differs on the card")
            _check(torch.allclose(on_cpu_values[name].float(), want[name].cpu().float(), rtol=1e-6, atol=0),
                   f"M3 save/restore: compute()[{name!r}] on the CPU beyond rtol 1e-6")
        out["M3"] = {"card_to_cpu_leaves_equal": to_cpu, "cpu_to_card_leaves_equal": to_card,
                     "evicted_tenant_gone": True, "collection_snapshot_bytes": os.path.getsize(path),
                     "collection_groups": {k: list(v) for k, v in col.compute_groups.items()}}
        print(f"phase M3 {json.dumps(out['M3'])}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase M: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------- Phase N: the guard plane

N_PAIRS = 1  # benchmarks/engine_throughput.py --guard's overhead pairs (:1284-1297; 6 there)
N_GATE_PCT = 5.0  # its guard_overhead_lt_5pct: a record here, as M1's
N2_BURST, N2_HEAVY_ROWS, N2_LIGHT_TENANTS, N2_LIGHT_REQUESTS = 400, 64, 9, 100  # (:1309-1362)
N2_GUARDED_PAIRS, N2_UNGUARDED_PAIRS = 3, 1  # 5 and 2 there
N2_QUEUE, N2_CAPACITY, N2_QUANTUM = 16384, 16, 128
N2_GATES = {"guarded_le_x_solo": 2.0, "unguarded_gt_x_solo": 10.0}
N3_REQUESTS = 48  # flagship requests a fault window
# the timeout must outlast the longest capture (the warm-up and capture of a 256-row graph of
# the collection take seconds; the watchdog counts them, as the JAX package counts compiles, against
# the timeout times the first calls in flight at once: several engines capturing together)
N3_WATCHDOG = dict(watchdog_timeout_s=5.0, watchdog_poll_s=0.02, hang_lock_timeout_s=1.0)


def _engine_pass(torch, np, reqs, folds, rows, what: str, supervise=None, **engine_kw) -> tuple:
    """One warmed, timed K6 pass (the benchmark's run_engine_pass) with the
    given planes, and supervised by ``supervise(engine)`` where given (a
    cluster node, which registers itself as ``engine._cluster``); the states
    held to the fold. Returns ``(record, engine)`` with the engine still open;
    the caller closes it."""
    from metrics_tpu_torch.classification import BinaryAccuracy
    from metrics_tpu_torch.engine import StreamingEngine

    engine = StreamingEngine(BinaryAccuracy(device="cuda"), buckets=K_BUCKETS, max_queue=K_QUEUE,
                             capacity=K_TENANTS, **engine_kw)
    if supervise is not None:
        supervise(engine)
    rng = np.random.default_rng(13)
    _k_warm(engine, lambda n: (rng.integers(0, 2, n), rng.integers(0, 2, n)), K_BUCKETS,
            sorted({key for key, _ in reqs}))
    spent = {"plane_ms": 0.0}
    if engine._guard is not None:
        engine._guard.form_drain = _m_timed(engine._guard.form_drain, spent, "plane_ms")
    if engine._tier is not None:
        engine._maybe_tier = _m_timed(engine._maybe_tier, spent, "plane_ms")
    if engine._shipper is not None:  # the shipper thread's ticks (its own thread, not the dispatcher's)
        spent["plane_cpu_ms"] = 0.0
        engine._shipper.tick = _m_timed(_m_cpu_timed(engine._shipper.tick, spent, "plane_cpu_ms"), spent, "plane_ms")
    seconds = _k_submit(engine, reqs, K_THREADS)
    spent = dict(spent)
    _k_check_states(torch, engine, folds, rows, what)
    snap = engine.telemetry_snapshot()
    for name in ("shed", "failed", "tier_demotions", "compile_rejections"):
        _check(snap[name] == 0, f"{what}: {snap[name]} {name} on well-behaved traffic")
    return {"req_per_s": len(reqs) / seconds, "seconds": seconds, **spent}, engine


def _paired_overhead(torch, np, what: str, plane: dict) -> dict:
    """The JAX benchmark's paired procedure: N_PAIRS pairs of plain and planed K6
    passes, alternating which goes first; the median pair ratio less one."""
    import statistics

    from metrics_tpu_torch.classification import BinaryAccuracy

    reqs = _k6_reqs(np, K1_REQUESTS, K_TENANTS)
    folds, rows = _k_fold(torch, BinaryAccuracy(device="cuda"), reqs, "cuda")
    plain, planed, ratios = [], [], []
    for i in range(N_PAIRS):
        got = {}
        for side in (("plain", "plane") if i % 2 == 0 else ("plane", "plain")):
            rec, engine = _engine_pass(torch, np, reqs, folds, rows, f"{what} {side}",
                                       **({} if side == "plain" else plane))
            engine.close()
            got[side] = rec
        plain.append(got["plain"])
        planed.append(got["plane"])
        ratios.append(got["plain"]["req_per_s"] / got["plane"]["req_per_s"])
    overhead_pct = (statistics.median(ratios) - 1.0) * 100.0
    return {
        "overhead_pct": overhead_pct, "gate_pct": N_GATE_PCT, "within_gate": overhead_pct < N_GATE_PCT,
        "pair_ratios": ratios, "plain_req_per_s": [r["req_per_s"] for r in plain],
        "plane_req_per_s": [r["req_per_s"] for r in planed],
        "plain_best_req_per_s": max(r["req_per_s"] for r in plain),
        "plane_best_req_per_s": max(r["req_per_s"] for r in planed),
        # the dispatcher's wall ms in the plane's own code, a pass, and its share of the pass
        "dispatcher_plane_ms_per_pass": [r["plane_ms"] for r in planed],
        "dispatcher_share": [r["plane_ms"] / (r["seconds"] * 1e3) for r in planed],
        "requests": len(reqs),
    }


def _n2_skew_pass(np, guard, flood: bool) -> float:
    """benchmarks/engine_throughput.py's skew_pass on the card: the light
    tenants' submit->commit p99 in seconds."""
    import contextlib
    import gc
    import threading

    from metrics_tpu_torch.classification import BinaryAccuracy
    from metrics_tpu_torch.engine import StreamingEngine
    from metrics_tpu_torch.utils.graphs import collector_paused

    rng = np.random.default_rng(23)
    heavy_args = (rng.integers(0, 2, N2_HEAVY_ROWS), rng.integers(0, 2, N2_HEAVY_ROWS))
    light_args = (rng.integers(0, 2, 1), rng.integers(0, 2, 1))
    engine = StreamingEngine(BinaryAccuracy(device="cuda"), buckets=K_BUCKETS, max_queue=N2_QUEUE,
                             capacity=N2_CAPACITY, guard=guard)
    lat_lock, light_lat, stop = threading.Lock(), [], threading.Event()
    paused = contextlib.ExitStack()
    try:
        for rows in K_BUCKETS:  # warm the ladder, one rung a flush
            engine.submit("heavy", rng.integers(0, 2, rows), rng.integers(0, 2, rows))
            engine.flush(timeout=300)
        for k in range(N2_LIGHT_TENANTS):
            engine.submit(f"light-{k}", *light_args)
        engine.flush(timeout=300)
        engine.reset()
        gc.collect()
        paused.enter_context(collector_paused())

        def heavy_client():
            while not stop.is_set():
                for _ in range(N2_BURST):
                    engine.submit("heavy", *heavy_args)
                if stop.wait(0.4):
                    return

        def record(t0):
            def done(f):
                with lat_lock:
                    light_lat.append(time.perf_counter() - t0)
            return done

        def light_client(k):
            for _ in range(N2_LIGHT_REQUESTS):
                t0 = time.perf_counter()
                engine.submit(f"light-{k}", *light_args).add_done_callback(record(t0))
                time.sleep(0.0005)  # paced: a polite interactive tenant

        threads = [threading.Thread(target=light_client, args=(k,)) for k in range(N2_LIGHT_TENANTS)]
        heavy = threading.Thread(target=heavy_client)
        if flood:
            heavy.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        stop.set()
        if flood:
            heavy.join(300)
        engine.flush(timeout=300)
        _check(len(light_lat) == N2_LIGHT_TENANTS * N2_LIGHT_REQUESTS,
               f"N2: {len(light_lat)} light receipts of {N2_LIGHT_TENANTS * N2_LIGHT_REQUESTS}")
        snap = engine.telemetry_snapshot()
        _check(snap["failed"] == 0 and snap["shed"] == 0, f"N2: {snap['failed']} failed, {snap['shed']} shed")
        return float(np.percentile(np.asarray(light_lat), 99, method="nearest"))
    finally:
        paused.close()
        stop.set()
        engine.close()


def phase_n2(np) -> dict:
    import statistics

    from metrics_tpu_torch.engine import GuardConfig

    guard = GuardConfig(shed=False, drain_quantum_rows=N2_QUANTUM)
    guarded, unguarded = [], []
    for _ in range(N2_GUARDED_PAIRS):
        guarded.append((_n2_skew_pass(np, guard, flood=False), _n2_skew_pass(np, guard, flood=True)))
    for _ in range(N2_UNGUARDED_PAIRS):
        unguarded.append((_n2_skew_pass(np, None, flood=False), _n2_skew_pass(np, None, flood=True)))
    g_ratio = statistics.median(f / s for s, f in guarded)
    u_ratio = statistics.median(f / s for s, f in unguarded)
    return {
        "solo_p99_ms": min(s for s, _ in guarded) * 1e3, "guarded_p99_ms": min(f for _, f in guarded) * 1e3,
        "unguarded_p99_ms": min(f for _, f in unguarded) * 1e3,
        "guarded_pairs_ms": [[s * 1e3, f * 1e3] for s, f in guarded],
        "unguarded_pairs_ms": [[s * 1e3, f * 1e3] for s, f in unguarded],
        "guarded_over_solo": g_ratio, "unguarded_over_solo": u_ratio, "jax_gates": N2_GATES,
        "guarded_within_gate": g_ratio <= N2_GATES["guarded_le_x_solo"],
        "unguarded_beyond_gate": u_ratio > N2_GATES["unguarded_gt_x_solo"],
        "config": {"burst": N2_BURST, "heavy_rows": N2_HEAVY_ROWS, "light_tenants": N2_LIGHT_TENANTS,
                   "light_requests": N2_LIGHT_REQUESTS, "drain_quantum_rows": N2_QUANTUM, "max_queue": N2_QUEUE,
                   "capacity": N2_CAPACITY},
    }


def _n_fold(torch, np, metric, reqs, whole) -> dict:
    """Per-tenant fold on the card: request ``i`` in one ``update_state`` where
    ``whole(i)`` (the inline and eager paths), else a row at a time (a replay)."""
    states = {}
    for i, (key, args) in enumerate(reqs):
        state = states.get(key) or metric.init_state()
        parts = [args] if whole(i) else [tuple(a[r : r + 1] for a in args) for r in range(args[0].shape[0])]
        for part in parts:
            state = metric.update_state(state, *(torch.from_numpy(np.ascontiguousarray(a)).to("cuda") for a in part))
        states[key] = state
    return states


def _n_states(torch, engine, folds, what: str) -> int:
    """Every tenant's engine state ``torch.equal`` to its fold, ``_update_count``
    included (the fold applied whole or by rows as the engine did)."""
    states = engine._read_states(list(folds), False)
    return _m_equal(torch, states, folds, what)


def _update_launches(metric, args, torch) -> dict:
    """The wrappers' launches of one eager ``update_state`` of ``metric``."""
    from metrics_tpu_torch.kernels import launch_counts

    before = launch_counts()
    metric.update_state(metric.init_state(), *(torch.from_numpy(a).to("cuda") for a in args))
    torch.cuda.synchronize()
    return {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}


def _n_reqs(np, seed: int, n: int):
    rng = np.random.default_rng(seed)

    def labels(rows):
        return rng.integers(0, K2_CLASSES, rows).astype(np.int64), rng.integers(0, K2_CLASSES, rows).astype(np.int64)

    return [(f"tenant-{int(rng.integers(0, K_TENANTS))}", labels(int(rng.integers(K2_ROWS[0], K2_ROWS[1] + 1))))
            for _ in range(n)], labels


def _wait_for(cond, what: str, timeout: float = 60.0) -> float:
    t0 = time.perf_counter()
    while not cond():
        _check(time.perf_counter() - t0 < timeout, f"{what} within {timeout} s")
        time.sleep(0.005)
    return time.perf_counter() - t0


def phase_n3(torch, np) -> dict:
    """Faults on the card, each a check, at K2's flagship collection (C = 1000)."""
    from metrics_tpu_torch.engine import EngineQuarantined, GuardConfig, StreamingEngine
    from metrics_tpu_torch.guard.faults import hold_dispatch_lock, wedge_dispatcher
    from metrics_tpu_torch.kernels import launch_counts

    kernels = ("stat_scores", "pair_count")
    out = {}
    reqs, labels = _n_reqs(np, 29, 2 * N3_REQUESTS)
    engine = StreamingEngine(_k2_metric(), buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=K_TENANTS,
                             guard=GuardConfig(shed=False, **N3_WATCHDOG))
    try:
        _k_warm(engine, labels, K_BUCKETS, sorted({k for k, _ in reqs}))
        per_update = _update_launches(_k2_metric(), labels(4), torch)
        before, graphs0 = launch_counts(), engine.graph_launches()
        old_worker = engine._worker
        t0 = time.perf_counter()
        with wedge_dispatcher(engine):
            wedged = [engine.submit(key, *args) for key, args in reqs[:N3_REQUESTS]]
            engine.flush(timeout=300)
            takeover_s = time.perf_counter() - t0
            _check(all(f.result(timeout=60)["bucket"] is None for f in wedged), "N3: a wedged request was replayed")
            restart_s = _wait_for(lambda: not engine.degraded and engine._worker is not old_worker,
                                  "N3: a fresh dispatcher")
        old_worker.join(60)
        _check(not old_worker.is_alive(), "N3: the superseded dispatcher did not retire")
        fused = [engine.submit(key, *args) for key, args in reqs[N3_REQUESTS:]]
        engine.flush(timeout=300)
        _check(all(f.result(timeout=60)["bucket"] in K_BUCKETS for f in fused), "N3: the restart is not fused")
        snap = engine.telemetry_snapshot()
        _check((snap["worker_hangs"], snap["watchdog_restarts"], snap["failed"]) == (1, 1, 0),
               f"N3: hangs {snap['worker_hangs']}, restarts {snap['watchdog_restarts']}, failed {snap['failed']}")
        counted = {k: launch_counts()[k] - before[k] for k in kernels}
        in_graphs = {k: engine.graph_launches().get(k, 0) - graphs0.get(k, 0) for k in kernels}
        inline = {k: N3_REQUESTS * per_update.get(k, 0) for k in kernels}
        for k in kernels:
            # no graph was captured in the window: the wrappers counted the inline updates only
            _check(counted[k] == inline[k], f"N3: {k} counted {counted[k]}, inline updates {inline[k]}")
            _check(in_graphs[k] > 0, f"N3: {k} never launched in a replay after the restart")
        folds = _n_fold(torch, np, _k2_metric(), reqs, lambda i: i < N3_REQUESTS)
        leaves = _n_states(torch, engine, folds, "N3 takeover vs fold")
        out["takeover"] = {"requests_inline": N3_REQUESTS, "requests_fused_after": N3_REQUESTS,
                           "takeover_s": takeover_s, "restart_s": restart_s, "leaves_equal": leaves,
                           "launches_counted_inline": counted, "launches_per_inline_update": per_update,
                           "launches_in_replays_after": in_graphs, "worker_restarts": engine.health()["worker_restarts"]}

        # the held lock: a worker wedged inside a device call cannot be superseded
        before_states = _m_states(engine)
        t0 = time.perf_counter()
        with wedge_dispatcher(engine), hold_dispatch_lock(engine):
            held = [engine.submit(key, *args) for key, args in reqs[:8]]
            quarantine_s = _wait_for(lambda: engine.quarantined, "N3: the engine quarantines")
            for f in held:
                _check(isinstance(f.exception(timeout=60), EngineQuarantined), "N3: a pending future did not fail")
            failed_s = time.perf_counter() - t0
        _check(engine.health()["state"] == "QUARANTINED", "N3: health is not QUARANTINED")
        try:
            engine.submit(*reqs[0][:1], *reqs[0][1])
            _check(False, "N3: a quarantined engine accepted a submit")
        except EngineQuarantined:
            pass
        _m_equal(torch, _m_states(engine), before_states, "N3 quarantine left the states alone")
        out["held_lock"] = {"pending": len(held), "quarantine_s": quarantine_s, "all_failed_s": failed_s}
    finally:
        t0 = time.perf_counter()
        engine.close()
        out.setdefault("held_lock", {})["close_s"] = time.perf_counter() - t0
    _check(out["held_lock"]["close_s"] < 60, "N3: close() of the quarantined engine hung")

    # the capture governor: a budget of one capture, novel (signature, bucket) keys run eagerly on cuda:0
    gov = StreamingEngine(_k2_metric(), buckets=(4, 8, 16, 64), max_queue=K_QUEUE, capacity=K_TENANTS,
                          guard=GuardConfig(shed=False, compile_rate_per_s=0.0, compile_burst=1.0,
                                            breaker_failure_threshold=1, breaker_probation_s=1e6))
    try:
        rng = np.random.default_rng(31)
        # novel keys: buckets 8, 16 and 64, and float scores of shape (3, C) (another signature)
        sizes = (1, 3, 6, 2, 12, 40, 3, 1)
        greqs = [(f"tenant-{i % 4}", (rng.random((r, K2_CLASSES)).astype(np.float32) if i == 6 else
                                      rng.integers(0, K2_CLASSES, r), rng.integers(0, K2_CLASSES, r)))
                 for i, r in enumerate(sizes)]
        per_update = _update_launches(_k2_metric(), labels(4), torch)
        before = launch_counts()
        buckets = []
        for key, args in greqs:
            buckets.append(gov.submit(key, *args).result(timeout=300)["bucket"])
            gov.flush(timeout=300)
        snap = gov.telemetry_snapshot()
        eager = [i for i, b in enumerate(buckets) if b is None]
        _check(len(eager) == snap["compile_rejections"] == 4 and snap["compiles"] == 1,
               f"N3 governor: buckets {buckets}, {snap['compile_rejections']} rejections, {snap['compiles']} captures")
        graphs = gov.graph_stats()
        captured = {k: sum(g["captured_launches"].get(k, 0) for g in graphs) for k in kernels}
        counted = {k: launch_counts()[k] - before[k] for k in kernels}
        for k in kernels:
            want = 2 * captured[k] + len(eager) * per_update.get(k, 0)
            _check(counted[k] == want, f"N3 governor: {k} counted {counted[k]}, 2 x captured + eager {want}")
        devices = {f"{d.type}:{0 if d.index is None else d.index}"
                   for d in [leaf.device for leaf in gov._keyed.leaves()] + [gov.device]}
        _check(devices == {"cuda:0"}, f"N3 governor: the eager route left cuda:0 ({devices})")
        folds = _n_fold(torch, np, _k2_metric(), greqs, lambda i: buckets[i] is None)
        leaves = _n_states(torch, gov, folds, "N3 governor vs fold")
        out["governor"] = {"buckets": buckets, "compile_rejections": snap["compile_rejections"],
                           "captures": snap["compiles"], "eager_chunks": len(eager), "launches_counted": counted,
                           "launches_per_eager_update": per_update, "devices": sorted(devices), "leaves_equal": leaves,
                           "breaker": gov.health()["breakers"]["compile"]["state"]}
    finally:
        gov.close()
    return out


def phase_n(torch, np) -> dict:
    """The guard plane on the card (N1 to N3)."""
    from metrics_tpu_torch.engine import GuardConfig

    t0 = time.perf_counter()
    out = {"N1": _paired_overhead(torch, np, "N1", {"guard": GuardConfig()})}
    print(f"phase N1 {json.dumps(out['N1'])}")
    out["N2"] = phase_n2(np)
    print(f"phase N2 {json.dumps(out['N2'])}")
    out["N3"] = phase_n3(torch, np)
    print(f"phase N3 {json.dumps(out['N3'])}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase N: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------- Phase O: the tier plane

O2_HOT, O2_REGISTERED, O2_SWEEP, O2_STRIDE = 8_000, 1_000_000, 12_000, 64  # engine_throughput.py --tier (:1092)
O2_FOOTPRINT_TENANTS = 10_000
O3_HOT, O3_TENANTS, O3_ROWS = 512, 256, 8  # (:1154-1176)
O3_CONTRACT_S = 0.1  # one dispatch interval, the JAX benchmark's readmission bound
# requests round-robin over the tenants, a flush every hot-set's worth of submits, so
# each batch promotes a hot set's worth and the pass after it demotes as many
O4_FLAGSHIP_TENANTS, O4_FLAGSHIP_HOT, O4_FLAGSHIP_WARM, O4_FLAGSHIP_REQUESTS = 32, 8, 8, 128
O4_QUANTILE_TENANTS, O4_QUANTILE_HOT, O4_QUANTILE_WARM, O4_QUANTILE_REQUESTS = 64, 16, 16, 1024


def phase_o2(torch, np) -> dict:
    from metrics_tpu_torch.classification import BinaryAccuracy
    from metrics_tpu_torch.engine import StreamingEngine, TierConfig

    ref = StreamingEngine(BinaryAccuracy(device="cuda"), buckets=K_BUCKETS, capacity=64)
    try:
        for k in range(512):
            ref._alloc_slot(f"ref-{k}")
        ref.flush(timeout=300)
        with ref._dispatch_lock:
            ref._grow()
        per_tenant = sum(ref._slab_bytes().values()) / ref._keyed.capacity
    finally:
        ref.close()
    big = StreamingEngine(BinaryAccuracy(device="cuda"), buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=64,
                          tier=TierConfig(hot_capacity=O2_HOT, idle_demote_s=3600.0, check_interval_s=0.0))
    try:
        t0 = time.perf_counter()
        registered = big.register_tenants([f"reg-{i}" for i in range(O2_REGISTERED)])
        reg_s = time.perf_counter() - t0
        slab_after_reg = sum(big._slab_bytes().values())
        one = (np.ones(1, np.int64), np.ones(1, np.int64))
        capped_at = None
        t0 = time.perf_counter()
        for i in range(O2_SWEEP):
            big.submit(f"act-{i}", *one)
            if i % O2_STRIDE == O2_STRIDE - 1:
                big.flush(timeout=300)
                if capped_at is None and big._keyed.capacity >= 8192:
                    capped_at = (i, big.telemetry_snapshot()["compiles"])
        big.flush(timeout=300)
        sweep_s = time.perf_counter() - t0
        deadline = time.monotonic() + 60
        while big.tier_stats()["hot"] > O2_HOT and time.monotonic() < deadline:
            time.sleep(0.01)
        stats = big.tier_stats()
        snap = big.telemetry_snapshot()
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        slab = stats["slab_bytes"]
        checks = {
            "registered_1m": registered == O2_REGISTERED,
            "all_tenants_accounted": stats["hot"] + stats["warm"] + stats["cold"] == O2_REGISTERED + O2_SWEEP,
            "registration_left_slab_alone": slab_after_reg < per_tenant * 1024,
            "hot_set_trimmed_to_cap": stats["hot"] <= O2_HOT,
            "slab_capped_at_10k_footprint": slab / per_tenant <= O2_FOOTPRINT_TENANTS,
            "no_capture_after_the_cap": capped_at is not None and snap["compiles"] == capped_at[1],
        }
        for name, ok in checks.items():
            _check(ok, f"O2: {name} failed ({stats}, capped at {capped_at}, {snap['compiles']} captures)")
        return {
            "checks": checks, "slab_bytes": slab, "slab_capacity": big._keyed.capacity,
            "footprint_tenants": slab / per_tenant, "per_tenant_bytes": per_tenant,
            "cuda_memory_allocated": allocated, "registration_keys_per_s": O2_REGISTERED / reg_s,
            "registration_s": reg_s, "sweep_s": sweep_s, "sweep_req_per_s": O2_SWEEP / sweep_s,
            "hot": stats["hot"], "warm": stats["warm"], "cold": stats["cold"], "captures": snap["compiles"],
            "capped_at_submit": capped_at[0], "captures_at_cap": capped_at[1], "key_growths": snap["key_growths"],
            "tier_demotions": snap["tier_demotions"], "tier_promotions": snap["tier_promotions"],
            "config": {"hot_capacity": O2_HOT, "registered": O2_REGISTERED, "sweep_tenants": O2_SWEEP,
                       "flush_every": O2_STRIDE},
        }
    finally:
        big.close()


def phase_o3(np) -> dict:
    from metrics_tpu_torch.classification import BinaryAccuracy
    from metrics_tpu_torch.engine import StreamingEngine, TierConfig

    rng = np.random.default_rng(37)
    engine = StreamingEngine(BinaryAccuracy(device="cuda"), buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=64,
                             tier=TierConfig(hot_capacity=O3_HOT, idle_demote_s=3600.0, check_interval_s=3600.0))
    try:
        for k in range(O3_TENANTS):
            engine.submit(f"warm-{k}", rng.integers(0, 2, O3_ROWS), rng.integers(0, 2, O3_ROWS))
        engine.flush(timeout=300)
        _check(engine.demote_tenant("warm-0"), "O3: warm-0 not demoted")  # both paths once
        engine.pin_tenant("warm-0")
        engine.unpin_tenant("warm-0")
        lat = []
        for k in range(1, O3_TENANTS):
            key = f"warm-{k}"
            _check(engine.demote_tenant(key), f"O3: {key} not demoted")
            t0 = time.perf_counter()
            engine.pin_tenant(key)  # promotes synchronously, as a submit to a warm tenant does
            lat.append(time.perf_counter() - t0)
            engine.unpin_tenant(key)
            _check(engine.tenant_tier(key) == "hot", f"O3: {key} not readmitted")
        snap = engine.telemetry_snapshot()
        _check(snap["tier_promotions"] == snap["tier_demotions"] == O3_TENANTS, f"O3: {snap['tier_promotions']} "
               f"promotions, {snap['tier_demotions']} demotions")
        p99 = float(np.percentile(np.asarray(lat), 99, method="nearest"))
        return {"p50_ms": float(np.percentile(np.asarray(lat), 50, method="nearest")) * 1e3, "p99_ms": p99 * 1e3,
                "max_ms": max(lat) * 1e3, "samples": len(lat), "contract_ms": O3_CONTRACT_S * 1e3,
                "within_contract": p99 < O3_CONTRACT_S}
    finally:
        engine.close()


def _o4_serve(torch, np, name, make, reqs, kernels, tier_kw, directory) -> dict:
    """One metric tiered around its hand kernels: a tiered engine (checkpointing
    into ``directory``), an untiered twin, the same requests from one thread
    with a flush every ``len(tenants)`` submits; leaves equal to the fold and
    the twin; the wrappers' counters against the graphs; a crash and a
    recovery; the tier's transfers timed."""
    import tempfile

    from metrics_tpu_torch.engine import CheckpointConfig, StreamingEngine, TierConfig
    from metrics_tpu_torch.engine import runtime
    from metrics_tpu_torch.kernels import launch_counts

    keys = sorted({k for k, _ in reqs})
    stride = tier_kw["hot_capacity"]
    spill = tempfile.mkdtemp(dir=directory)
    # neither slab grows during the run, so every graph captured stays in graph_stats():
    # the tiered one holds the hot set and one batch's promotions, the twin every tenant
    kw = dict(buckets=K_BUCKETS, max_queue=K_QUEUE)
    ckpt = CheckpointConfig(directory=os.path.join(directory, "ckpt"), interval_s=3600.0, retain=M_RETAIN,
                            durable=False)
    tiered = StreamingEngine(make(), checkpoint=ckpt, tier=TierConfig(spill_directory=spill, durable=False,
                                                                     idle_demote_s=3600.0, check_interval_s=0.0,
                                                                     **tier_kw), capacity=2 * stride, **kw)
    twin = StreamingEngine(make(), capacity=len(keys), **kw)
    # a promotion's wall time, and within it the entry's fetch (the warm dict, or a spill
    # file read and checked) and its restore into the slab row (the H2D copies); the rest
    # is the P record (the entry serialized into the WAL) and the bookkeeping
    spent = {"promote_ms": 0.0, "demote_ms": 0.0, "fetch_ms": 0.0, "restore_ms": 0.0}
    tiered._promote_tenant = _m_timed(tiered._promote_tenant, spent, "promote_ms")
    tiered._demote_tenants = _m_timed(tiered._demote_tenants, spent, "demote_ms")
    tiered._tier.pop_entry = _m_timed(tiered._tier.pop_entry, spent, "fetch_ms")
    restore = runtime.restore_entry
    runtime.restore_entry = _m_timed(restore, spent, "restore_ms")
    before = launch_counts()
    try:
        half = len(reqs) // 2
        for engine in (tiered, twin):
            for i, (key, args) in enumerate(reqs):
                engine.submit(key, *args)
                if i % stride == stride - 1:
                    engine.flush(timeout=300)
                    if engine is tiered:  # the eviction pass follows the batch: let it trim to the hot set
                        _wait_for(lambda: tiered.tier_stats()["hot"] <= stride, f"O4 {name}: the trim")
                if engine is tiered and i == half:
                    engine.flush(timeout=300)
                    _check(engine.checkpoint_now() is not None, f"O4 {name}: the mid-run snapshot failed")
            engine.flush(timeout=300)
        runtime.restore_entry = restore
        counted = {k: launch_counts()[k] - before[k] for k in kernels}
        snap = tiered.telemetry_snapshot()
        _check(snap["fused"] and snap["failed"] == 0 and snap["fused_fallbacks"] == 0,
               f"O4 {name}: fused {snap['fused']}, {snap['failed']} failed, capture error {tiered._fused_error!r}")
        for c in ("tier_demotions", "tier_promotions", "tier_spills"):
            _check(snap[c] > 0, f"O4 {name}: no {c}")
        _check(tiered._keyed.capacity == 2 * stride and snap["key_growths"] == 0,
               f"O4 {name}: the tiered slab grew to {tiered._keyed.capacity} rows")
        folds, rows = _k_fold(torch, make(), reqs, "cuda")
        states = tiered._read_states(keys, False)  # non-resident tenants read from host RAM and disk
        leaves = _m_equal(torch, states, twin._read_states(keys, False), f"O4 {name} tiered vs twin")
        for key in keys:
            for path, x in _k_leaves(states[key]).items():
                y = _k_leaves(folds[key])[path]
                if path.endswith("_update_count"):
                    _check(int(x) == rows[key], f"O4 {name} {key}: {int(x)} updates for {rows[key]} rows")
                else:
                    _check(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), f"O4 {name} {key}: {path} vs fold")
        graphs = tiered.graph_stats() + twin.graph_stats()
        captured = {k: sum(g["captured_launches"].get(k, 0) for g in graphs) for k in kernels}
        in_graphs = {k: sum(g["captured_launches"].get(k, 0) * g["replays"] for g in graphs) for k in kernels}
        for k in kernels:
            _check(counted[k] == 2 * captured[k] and in_graphs[k] > 0,
                   f"O4 {name}: {k} counted {counted[k]}, captured {captured[k]}, in replays {in_graphs[k]}")
        tier_leaves = tiered._read_states(keys, False)
        entry_bytes = sum(leaf.numel() * leaf.element_size() for leaf in tiered._keyed.leaves()) // \
            tiered._keyed.capacity
    finally:
        runtime.restore_entry = restore
        tiered.close(checkpoint=False)  # the crash: the WAL holds D and P records past the snapshot
        twin.close()
    recovered = StreamingEngine(make(), checkpoint=ckpt, capacity=2 * stride, **kw)
    try:
        rsnap = recovered.telemetry_snapshot()
        _check(rsnap["recoveries"] == 1 and rsnap["failed"] == 0 and recovered._tier is not None,
               f"O4 {name}: recoveries {rsnap['recoveries']}, failed {rsnap['failed']}")
        rec_leaves = _m_equal(torch, recovered._read_states(keys, False), tier_leaves, f"O4 {name} recovered")
        replayed = rsnap["replayed"]
    finally:
        recovered.close(checkpoint=False)
    # the same bytes as one tenant's state, copied between pinned host memory and the card
    host = torch.empty(entry_bytes, dtype=torch.uint8).pin_memory()
    dev = torch.empty(entry_bytes, dtype=torch.uint8, device="cuda")
    h2d = _time_ms(lambda: dev.copy_(host, non_blocking=True), 20)
    d2h = _time_ms(lambda: host.copy_(dev, non_blocking=True), 20)
    return {
        "requests": len(reqs), "tenants": len(keys), "tier": dict(tier_kw), "slab_rows": 2 * stride,
        "twin_slab_rows": len(keys), "leaves_equal_twin": leaves,
        "leaves_equal_after_recovery": rec_leaves, "records_replayed": replayed,
        "promotions": snap["tier_promotions"], "demotions": snap["tier_demotions"], "spills": snap["tier_spills"],
        "ms_per_promotion": spent["promote_ms"] / snap["tier_promotions"],
        "ms_per_demotion": spent["demote_ms"] / snap["tier_demotions"], "bytes_per_tenant": entry_bytes,
        "fetch_ms_per_promotion": spent["fetch_ms"] / snap["tier_promotions"],
        "restore_ms_per_promotion": spent["restore_ms"] / snap["tier_promotions"],
        "pinned_h2d_ms": h2d, "pinned_d2h_ms": d2h, "launches_counted": counted, "captured": captured,
        "launches_in_replays": in_graphs,
    }


def phase_o4(torch, np) -> dict:
    import tempfile

    from metrics_tpu_torch import QuantileSketch

    rng = np.random.default_rng(41)

    def labels(rows):
        return rng.integers(0, K2_CLASSES, rows).astype(np.int64), rng.integers(0, K2_CLASSES, rows).astype(np.int64)

    flagship = [(f"tenant-{i % O4_FLAGSHIP_TENANTS}", labels(int(rng.integers(K2_ROWS[0], K2_ROWS[1] + 1))))
                for i in range(O4_FLAGSHIP_REQUESTS)]
    quantile = [(f"tenant-{i % O4_QUANTILE_TENANTS}", (rng.lognormal(0.0, 1.0, 1).astype(np.float32),))
                for i in range(O4_QUANTILE_REQUESTS)]
    out = {}
    # promote records carry whole entries (4 MB a flagship tenant): the WAL and the spill
    # files go to memory where the machine has it
    with tempfile.TemporaryDirectory(dir="/dev/shm" if os.path.isdir("/dev/shm") else None) as d:
        for name, make, reqs, kernels, tier_kw in (
            ("flagship", _k2_metric, flagship, ("stat_scores", "pair_count"),
             dict(hot_capacity=O4_FLAGSHIP_HOT, warm_capacity=O4_FLAGSHIP_WARM)),
            ("quantile", QuantileSketch, quantile, ("hist_add",),
             dict(hot_capacity=O4_QUANTILE_HOT, warm_capacity=O4_QUANTILE_WARM)),
        ):
            os.makedirs(os.path.join(d, name))
            out[name] = _o4_serve(torch, np, name, make, reqs, kernels, tier_kw, os.path.join(d, name))
    return out


def phase_o(torch, np) -> dict:
    """The tier plane on the card (O1 to O4)."""
    from metrics_tpu_torch.engine import TierConfig

    t0 = time.perf_counter()
    out = {"O1": _paired_overhead(torch, np, "O1", {"tier": TierConfig(hot_capacity=8)})}
    print(f"phase O1 {json.dumps(out['O1'])}")
    out["O2"] = phase_o2(torch, np)
    print(f"phase O2 {json.dumps(out['O2'])}")
    out["O3"] = phase_o3(np)
    print(f"phase O3 {json.dumps(out['O3'])}")
    out["O4"] = phase_o4(torch, np)
    print(f"phase O4 {json.dumps(out['O4'])}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase O: {out['seconds']:.1f} s")
    return out



# --------------------------------------------------------------------------- Phase P: the replication plane

P_PAIRS = 1  # benchmarks/engine_throughput.py --replica's shipping pairs (:532-585; 6 there)
P_GATE_PCT = 5.0  # its shipping_overhead_lt_5pct: a record here, as M1's
P_SHIP_INTERVAL_S = 0.02  # that gate's ReplConfig(ship_interval_s=0.02)
P2_READ_S = 2.0  # the read windows of its scale-out gate (:595-666)
P2_HEARTBEAT_S = 0.1
P2_WRITERS, P2_WRITER_ROWS, P2_WRITER_PACE_S = 4, 64, 0.001
P2_GATE_RATIO, P2_FLOOR_PER_S = 5.0, 500.0  # follower_ge_5x_primary_reads, follower_reads_ge_floor
P3_SEGMENTS = {"flagship": 64, "quantile": 192}  # requests a segment: live, after the restart, profiled (cut)
P3_AFTER_PROMOTION = 128  # requests the promoted engine serves
P3_PROFILE_ATTEMPTS = 5
P3_ZOMBIE = 32  # requests the deposed primary journals and ships after the promotion
P3_PER_ROW = {"flagship": {"stat_scores": 2, "pair_count": 1}, "quantile": {"hist_add": 2}}
P4_REQUESTS = 256
# the graphs are captured before the faults, one at a time, so a short watchdog outlasts nothing but the wedge
P4_WATCHDOG = dict(watchdog_timeout_s=2.0, watchdog_poll_s=0.02, hang_lock_timeout_s=0.2)


def _p_read_rate(engine, seconds: float, n_threads: int = 4) -> float:
    """benchmarks/engine_throughput.py's _read_rate: aggregate compute() reads/s of
    ``n_threads`` readers of one tenant for ``seconds`` (a read begun in the
    window counts, and so does the time it takes)."""
    import threading

    counts = [0] * n_threads
    t_end = time.perf_counter() + seconds

    def reader(i: int) -> None:
        while time.perf_counter() < t_end:
            float(engine.compute("tenant-0"))
            counts[i] += 1

    threads = [threading.Thread(target=reader, args=(i,), name=f"p2-reader-{i}") for i in range(n_threads)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
        _check(not th.is_alive(), "a reader thread did not finish")
    return sum(counts) / (time.perf_counter() - t0)


def _p1_pass(torch, np, reqs, folds, rows, directory: str, ship: bool, supervise=None) -> dict:
    """One K6 pass with checkpointing (M1's configuration) and, with ``ship``, a
    shipping primary over a LoopbackLink that a thread drains and discards (the
    follower of a real deployment replays on another host); the shipper
    thread's wall ms in its ticks is summed. ``supervise`` attaches a cluster
    node (Phases T2 and U3), closed before the engine."""
    import threading

    from metrics_tpu_torch.engine import CheckpointConfig, ReplConfig
    from metrics_tpu_torch.repl import LoopbackLink

    kw = {"checkpoint": CheckpointConfig(directory=directory, interval_s=M_INTERVAL_S, retain=M_RETAIN)}
    stop, drainer = threading.Event(), None
    if ship:
        link = LoopbackLink()

        def drain():
            while not stop.is_set():
                link.recv(timeout_s=0.05)

        drainer = threading.Thread(target=drain, daemon=True)
        drainer.start()
        kw["replication"] = ReplConfig(role="primary", transport=link, ship_interval_s=P_SHIP_INTERVAL_S)
    try:
        rec, engine = _engine_pass(torch, np, reqs, folds, rows, "P1 ship" if ship else "P1 ckpt",
                                   supervise=supervise, **kw)
        node = engine._cluster
        try:
            snap = engine.telemetry_snapshot()
            if ship:
                _check(not engine._shipper.fenced and snap["ship_failures"] == 0,
                       f"P1: fenced {engine._shipper.fenced}, {snap['ship_failures']} ship failures")
                rec["shipped_records"] = snap["shipped_records"]
            if node is not None:
                _check(node.failovers == 0 and not engine._repl_follower, "T pass: the supervised primary stepped down")
                rec["lease_renewals"], rec["lease_epoch"] = node.lease_renewals, engine._shipper.epoch
        finally:
            if node is not None:
                node.close()
            engine.close()  # the final snapshot, then the shipper's final publish
        if ship:
            _check(engine._shipper.last_shipped_seq == engine._wal_seq,
                   f"P1: shipped through {engine._shipper.last_shipped_seq} of {engine._wal_seq}")
    finally:
        stop.set()
        if drainer is not None:
            drainer.join(60)
    return rec


def phase_p1(torch, np) -> dict:
    """Shipping overhead at K6's configuration: P_PAIRS pairs of a checkpoint-only
    pass and a checkpointing + shipping pass, alternating which goes first; the
    median pair ratio less one, and the shipper thread's timed share of a pass."""
    import statistics
    import tempfile

    from metrics_tpu_torch.classification import BinaryAccuracy

    reqs = _k6_reqs(np, K1_REQUESTS, K_TENANTS)
    folds, rows = _k_fold(torch, BinaryAccuracy(device="cuda"), reqs, "cuda")
    ckpt, ship, ratios = [], [], []
    for i in range(P_PAIRS):
        got = {}
        for side in (("ckpt", "ship") if i % 2 == 0 else ("ship", "ckpt")):
            with tempfile.TemporaryDirectory() as d:
                got[side] = _p1_pass(torch, np, reqs, folds, rows, d, side == "ship")
        ckpt.append(got["ckpt"])
        ship.append(got["ship"])
        ratios.append(got["ckpt"]["req_per_s"] / got["ship"]["req_per_s"])
    overhead_pct = (statistics.median(ratios) - 1.0) * 100.0
    return {
        "overhead_pct": overhead_pct, "gate_pct": P_GATE_PCT, "within_gate": overhead_pct < P_GATE_PCT,
        "pair_ratios": ratios, "ckpt_req_per_s": [r["req_per_s"] for r in ckpt],
        "ship_req_per_s": [r["req_per_s"] for r in ship],
        "ckpt_best_req_per_s": max(r["req_per_s"] for r in ckpt), "ship_best_req_per_s": max(r["req_per_s"] for r in ship),
        # the shipper thread's ticks a pass: wall ms (GIL waits included) and its own CPU ms
        "shipper_ms_per_pass": [r["plane_ms"] for r in ship],
        "shipper_share": [r["plane_ms"] / (r["seconds"] * 1e3) for r in ship],
        "shipper_cpu_ms_per_pass": [r["plane_cpu_ms"] for r in ship],
        "shipper_cpu_share": [r["plane_cpu_ms"] / (r["seconds"] * 1e3) for r in ship],
        "shipped_records_per_pass": [r["shipped_records"] for r in ship],
        "requests": len(reqs), "ship_interval_s": P_SHIP_INTERVAL_S,
    }


class _PTimedLock:
    """A lock that adds the time P2's reader threads wait for it to ``waited["s"]``."""

    def __init__(self, lock, waited: dict) -> None:
        self._lock, self._waited = lock, waited

    def acquire(self, *args, **kwargs):
        import threading

        t0 = time.perf_counter()
        got = self._lock.acquire(*args, **kwargs)
        if threading.current_thread().name.startswith("p2-reader"):
            self._waited["s"] += time.perf_counter() - t0
        return got

    def release(self) -> None:
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _p2_reader(spool: str, seconds: float) -> int:
    """The read replica of Phase P2, in its own process (the parent starts this
    script again with ``--replica-reader SPOOL SECONDS``): a follower on the card
    over the primary's directory spool. Prints BOOTSTRAPPED once it holds
    tenant-0, READY once it has captured a graph a bucket (on the records of
    the requests the parent sends then), then one JSON line with its compute()
    rate under the primary's write flood."""
    import torch

    from metrics_tpu_torch.classification import BinaryAccuracy
    from metrics_tpu_torch.engine import ReplConfig, StreamingEngine
    from metrics_tpu_torch.repl import DirectoryTransport

    if not torch.cuda.is_available():
        print("READER_FAILED no CUDA GPU", flush=True)
        return 1
    follower = StreamingEngine(BinaryAccuracy(device="cuda"), buckets=K_BUCKETS, capacity=K_TENANTS,
                               replication=ReplConfig(role="follower", transport=DirectoryTransport(spool, durable=False),
                                                      poll_interval_s=0.01))
    try:
        deadline = time.perf_counter() + 120.0
        while "tenant-0" not in follower._keyed.keys and time.perf_counter() < deadline:
            time.sleep(0.01)
        if "tenant-0" not in follower._keyed.keys:
            print("READER_FAILED bootstrap timed out", flush=True)
            return 1
        while (follower._applier.applied_seq < follower._applier.known_seq or follower._applier.applied_seq < 1) \
                and time.perf_counter() < deadline:
            time.sleep(0.01)
        # the follower captures a bucket's graph when it first replays a record of it, under
        # its dispatch lock. A bootstrap snapshot that already covers the primary's warm-up
        # records leaves both captures to the first records of the flood, inside the read
        # window (0.27-0.46 s holds of the lock on an H100, reads down to 47/s): the parent
        # sends one request a rung once this line is out, and the window waits for both
        print("BOOTSTRAPPED", flush=True)
        while follower.telemetry_snapshot()["compiles"] < len(K_BUCKETS) and time.perf_counter() < deadline:
            time.sleep(0.01)
        if follower.telemetry_snapshot()["compiles"] < len(K_BUCKETS):
            print("READER_FAILED the warm-up records were not replayed", flush=True)
            return 1
        float(follower.compute("tenant-0"))
        # the readers' waits for the dispatch lock, which the applier holds through each replay
        waited = {"s": 0.0}
        follower._dispatch_lock = _PTimedLock(follower._dispatch_lock, waited)
        t0 = time.perf_counter()
        quiet = _p_read_rate(follower, 1.0)  # before the flood: the card and the lock are free
        quiet_wait_share = waited["s"] / (4 * (time.perf_counter() - t0))
        waited["s"] = 0.0
        applied0 = follower._applier.applied_seq
        print("READY", flush=True)
        time.sleep(0.3)  # the parent starts its write flood: read under load
        t0 = time.perf_counter()
        rate = _p_read_rate(follower, seconds)
        window_s = time.perf_counter() - t0
        lag = follower.replica_lag()
        snap = follower.telemetry_snapshot()
        print(json.dumps({"reader": rate, "quiet_reader": quiet, "reader_lock_wait_share": waited["s"] / (4 * window_s),
                          "quiet_reader_lock_wait_share": quiet_wait_share,
                          "applied": follower._applier.applied_seq, "applied_in_window": follower._applier.applied_seq
                          - applied0, "lag_seqs": lag.seqs_behind,
                          "lag_s": lag.seconds_behind if math.isfinite(lag.seconds_behind) else None,
                          "applied_records": snap["applied_records"], "snapshot_loads": snap["snapshot_loads"],
                          "captures": snap["compiles"], "device": str(follower.device)}), flush=True)
    finally:
        follower.close()
    return 0


def phase_p2(torch, np) -> dict:
    """Read scale-out: the primary at K6's configuration ships over a directory
    spool while four writer threads flood it with 64-row batches paced at 1 ms;
    its compute() rate over 2 s against a follower's in its own process on the
    same card (benchmarks/engine_throughput.py --replica's procedure)."""
    import tempfile
    import threading

    from metrics_tpu_torch.classification import BinaryAccuracy
    from metrics_tpu_torch.engine import CheckpointConfig, ReplConfig, StreamingEngine
    from metrics_tpu_torch.repl import DirectoryTransport

    with tempfile.TemporaryDirectory() as d:
        spool = os.path.join(d, "spool")
        primary = StreamingEngine(
            BinaryAccuracy(device="cuda"), buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=K_TENANTS,
            checkpoint=CheckpointConfig(directory=os.path.join(d, "ckpt"), interval_s=M_INTERVAL_S, retain=M_RETAIN),
            replication=ReplConfig(role="primary", transport=DirectoryTransport(spool, durable=False),
                                   ship_interval_s=P_SHIP_INTERVAL_S, heartbeat_interval_s=P2_HEARTBEAT_S))
        stop, writers, reader = threading.Event(), [], None
        written = [0] * P2_WRITERS
        try:
            rng = np.random.default_rng(1)
            for rows in K_BUCKETS:
                primary.submit("tenant-0", rng.integers(0, 2, rows), rng.integers(0, 2, rows))
                primary.flush(timeout=300)
            t0 = time.perf_counter()
            reader = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--replica-reader", spool,
                                       str(P2_READ_S)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            line = reader.stdout.readline()
            _check("BOOTSTRAPPED" in line, f"P2: the reader did not bootstrap: {line!r}")
            for rows in K_BUCKETS:  # replayed by the follower: its two graphs captured before the window
                primary.submit("tenant-1", rng.integers(0, 2, rows), rng.integers(0, 2, rows))
                primary.flush(timeout=300)
            line = reader.stdout.readline()
            _check("READY" in line, f"P2: the reader did not capture its graphs: {line!r}")
            ready_s = time.perf_counter() - t0

            def write_load(tid: int) -> None:
                w_rng = np.random.default_rng(100 + tid)
                w_args = (w_rng.integers(0, 2, P2_WRITER_ROWS), w_rng.integers(0, 2, P2_WRITER_ROWS))
                w_end = time.perf_counter() + P2_READ_S + 3.0
                while not stop.is_set() and time.perf_counter() < w_end:
                    primary.submit(f"tenant-{w_rng.integers(0, K_TENANTS)}", *w_args)
                    written[tid] += 1
                    time.sleep(P2_WRITER_PACE_S)

            writers = [threading.Thread(target=write_load, args=(i,)) for i in range(P2_WRITERS)]
            for w in writers:
                w.start()
            time.sleep(0.2)  # the standing load established
            primary_reads = _p_read_rate(primary, P2_READ_S)
            out, err = reader.communicate(timeout=600)
            wal_at_reader_exit = primary._wal_seq
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            _check(reader.returncode == 0 and bool(lines), f"P2: reader rc {reader.returncode}, "
                   f"stdout {out[-400:]!r}, stderr {err[-800:]!r}")
            got = json.loads(lines[-1])
        finally:
            stop.set()
            for w in writers:
                w.join(300)
            if reader is not None and reader.poll() is None:
                reader.kill()
                reader.wait(60)
            primary.close()
        snap = primary.telemetry_snapshot()
        _check(snap["failed"] == 0 and not primary._shipper.fenced, f"P2: {snap['failed']} failed requests, "
               f"fenced {primary._shipper.fenced}")
    follower_reads = float(got["reader"])
    ratio = follower_reads / max(primary_reads, 1e-9)
    return {
        "primary_reads_per_s": primary_reads, "follower_reads_per_s": follower_reads, "ratio": ratio,
        "gate_ratio": P2_GATE_RATIO, "floor_per_s": P2_FLOOR_PER_S,
        "within_gate": ratio >= P2_GATE_RATIO and follower_reads >= P2_FLOOR_PER_S,
        "follower_quiet_reads_per_s": got["quiet_reader"], "follower_reader_lock_wait_share": got["reader_lock_wait_share"],
        "follower_quiet_reader_lock_wait_share": got["quiet_reader_lock_wait_share"],
        "follower_applied_in_window": got["applied_in_window"], "primary_wal_seq_at_reader_exit": wal_at_reader_exit,
        "follower_lag_seqs": got["lag_seqs"], "follower_lag_s": got["lag_s"], "follower_applied_seq": got["applied"],
        "follower_applied_records": got["applied_records"], "follower_snapshot_loads": got["snapshot_loads"],
        "follower_captures": got["captures"], "follower_device": got["device"], "reader_ready_s": ready_s,
        "writer_requests": sum(written), "primary_wal_seq": primary._wal_seq, "read_seconds": P2_READ_S,
    }


def _p_states(engine) -> dict:
    """Copies of every tenant's state, read as compute() reads them: under the
    dispatch lock, after the engine's stream (a follower's replays run there
    without a sync each)."""
    return engine._read_states(None, False)


def _p_graph_replays(engine) -> dict:
    return {(g["signature"], g["bucket"], g["capacity"]): (g["captured_launches"], g["replays"])
            for g in engine.graph_stats()}


def _p3_run(torch, np, name, make, segments, after, kernels, directory) -> dict:
    """One metric at full width: a journaled primary and a follower on cuda:0 over a
    LoopbackLink, each with its own graphs. The follower tracks a live segment;
    the primary restarts (a new epoch) and the follower rebootstraps into its
    slab in place; the follower replays a held segment alone under the
    profiler; the primary is dropped without close() and the follower promoted;
    the deposed primary's later shipments are refused; the promoted engine
    serves ``after`` more requests. States against the primary's and the fold,
    ``torch.equal`` leaf for leaf."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from metrics_tpu_torch import obs
    from metrics_tpu_torch.engine import CheckpointConfig, ReplConfig, StreamingEngine
    from metrics_tpu_torch.repl import LoopbackLink

    link = LoopbackLink()
    kw = dict(buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=K_TENANTS)

    def make_primary():
        return StreamingEngine(make(), checkpoint=CheckpointConfig(
            directory=os.path.join(directory, "primary"), interval_s=3600.0, retain=M_RETAIN, durable=False),
            replication=ReplConfig(role="primary", transport=link, ship_interval_s=P_SHIP_INTERVAL_S,
                                   heartbeat_interval_s=P2_HEARTBEAT_S), **kw)

    primary = make_primary()
    follower = StreamingEngine(make(), replication=ReplConfig(
        role="follower", transport=link, poll_interval_s=0.005,
        promote_checkpoint=CheckpointConfig(directory=os.path.join(directory, "promoted"), interval_s=3600.0,
                                            retain=M_RETAIN, durable=False)), **kw)
    applier = follower._applier
    # the lag sampled while the follower tracks the live segments (not while this
    # script holds its dispatch lock, nor while the primary restarts)
    peak = {"seqs": 0, "seconds": 0.0}
    watching, live = threading.Event(), threading.Event()

    def watch_lag():
        while not watching.wait(0.002):
            if not live.is_set():
                continue
            lag = applier.lag()
            peak["seqs"] = max(peak["seqs"], lag.seqs_behind)
            if applier.bootstrapped and math.isfinite(lag.seconds_behind):
                peak["seconds"] = max(peak["seconds"], lag.seconds_behind)

    watcher = threading.Thread(target=watch_lag, daemon=True)
    watcher.start()
    served, rec = [], {"requests_per_segment": len(segments[0])}
    zombie = None
    try:
        # 1. live: the follower tracks the primary
        _wait_for(lambda: applier.bootstrapped, f"P3 {name}: the follower's bootstrap")
        live.set()
        live_s = _k_submit(primary, segments[0], K_THREADS)
        served += segments[0]
        _check(applier.await_seq(primary._wal_seq, 300), f"P3 {name}: the follower did not catch up")
        live.clear()
        rec["leaves_equal_live"] = _m_equal(torch, _p_states(follower), _p_states(primary), f"P3 {name} live")
        rec["live_rows_per_s"] = sum(a[0].shape[0] for _, a in segments[0]) / live_s
        # 2. the primary restarts on its directory: a new epoch; the follower rebootstraps
        # from the restart snapshot into its live slab (its graphs stay bound)
        slab = [t.data_ptr() for t in follower._keyed.leaves()]
        loads = follower.telemetry_snapshot()["snapshot_loads"]
        primary.close(checkpoint=False)
        t0 = time.perf_counter()
        primary = make_primary()
        rec["restart_ms"] = (time.perf_counter() - t0) * 1e3
        _check(primary._repl_epoch == 1, f"P3 {name}: the restarted primary's epoch is {primary._repl_epoch}")
        _k_submit(primary, segments[1], K_THREADS)
        served += segments[1]
        rec["rebootstrap_s"] = _wait_for(lambda: applier.epoch == 1 and not applier._gap
                                         and applier.applied_seq == primary._wal_seq, f"P3 {name}: the rebootstrap",
                                         timeout=300)
        live.set()  # tracking the restarted primary: one more live segment, timed
        t0 = time.perf_counter()
        _k_submit(primary, segments[2], K_THREADS)
        served += segments[2]
        _check(applier.await_seq(primary._wal_seq, 300), f"P3 {name}: the follower did not catch up")
        rec["tracked_rows_per_s"] = sum(a[0].shape[0] for _, a in segments[2]) / (time.perf_counter() - t0)
        live.clear()
        _check([t.data_ptr() for t in follower._keyed.leaves()] == slab, f"P3 {name}: the rebootstrap moved the slab")
        rec["snapshot_loads_in_rebootstrap"] = follower.telemetry_snapshot()["snapshot_loads"] - loads
        _check(rec["snapshot_loads_in_rebootstrap"] >= 1, f"P3 {name}: no snapshot load in the rebootstrap")
        rec["leaves_equal_after_rebootstrap"] = _m_equal(torch, _p_states(follower), _p_states(primary),
                                                         f"P3 {name} after the rebootstrap")
        # 3. the follower's replays alone under the profiler: its dispatch lock is held while
        # the primary serves the segment (the applier waits on it with the records shipped),
        # then released inside the profile; another segment while the counts disagree (the
        # profiler drops a kernel record now and then), up to P3_PROFILE_ATTEMPTS
        attempts = []
        for attempt, seg in enumerate(segments[3:]):
            g0 = _p_graph_replays(follower)
            follower._dispatch_lock.acquire()
            held = True
            try:
                live3_s = _k_submit(primary, seg, K_THREADS)
                served += seg
                target = primary._wal_seq
                _wait_for(lambda: primary._shipper.last_shipped_seq >= target, f"P3 {name}: the segment shipped")
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    _profiler_lead_in(torch)
                    t0 = time.perf_counter()
                    held = False
                    follower._dispatch_lock.release()
                    _check(applier.await_seq(target, 300), f"P3 {name}: the held segment was not replayed")
                    follower._sync()
                    replay_s = time.perf_counter() - t0
            finally:
                if held:
                    follower._dispatch_lock.release()
            g1 = _p_graph_replays(follower)
            expected = {k: 0 for k in kernels}
            for key, (captured, replays) in g1.items():
                before = g0.get(key, (captured, -1))[1]  # a graph captured in the window: its warm-up ran the scan
                for k in kernels:
                    expected[k] += captured.get(k, 0) * (replays - before)
            times = _kernel_times(prof, torch)
            seen = {k: sum(len(v) for n, v in times.items() if K_PROFILE_NAMES[k][0] in n) // K_PROFILE_NAMES[k][1]
                    for k in kernels}
            attempts.append({"profiled": seen, "in_replays": expected})
            if seen == expected or not times:
                break
        # Under this window's launch rate the profiler can lose a few kernel records. A replay
        # launches all its nodes or none, so a missing replay would take per_row x bucket
        # launches of each kernel at once: a smaller deficit still shows every replay launched
        # its kernels (the per-row counts are checked exactly at capture, below).
        if not (seen == expected or not times):
            smallest = min(g["bucket"] for g in follower.graph_stats())
            for k in kernels:
                _check(0 <= expected[k] - seen[k] < P3_PER_ROW[name][k] * smallest,
                       f"P3 {name}: profiled launches against captured x replays, each attempt: {attempts}")
        for g in follower.graph_stats():
            for k, per_row in P3_PER_ROW[name].items():
                _check(g["captured_launches"].get(k, 0) == per_row * g["bucket"],
                       f"P3 {name}: a {g['bucket']}-row graph captured {g['captured_launches']}")
        rows3 = sum(a[0].shape[0] for _, a in seg)
        busy_us = sum(sum(v) for v in times.values())
        rec.update(profile_attempts=attempts, launches_in_replays=expected, launches_profiled=seen,
                   profiler_lost={k: expected[k] - seen[k] for k in kernels} if times else None,
                   replayed_rows=rows3, replay_s=replay_s, replay_rows_per_s=rows3 / replay_s,
                   live_rows_per_s_held_segment=rows3 / live3_s, replay_device_busy_us=busy_us,
                   replay_idle_share=1.0 - busy_us / (replay_s * 1e6) if times else None,
                   follower_graphs=len(g1), follower_replays=sum(r for _, r in g1.values()))
        rec["leaves_equal_at_applied_seq"] = _m_equal(torch, _p_states(follower), _p_states(primary),
                                                      f"P3 {name} at the applied seq")
        folds, rows = _k_fold(torch, make(), served, "cuda")
        rec["primary_leaves_equal_fold"] = _k_check_states(torch, primary, folds, rows, f"P3 {name} primary vs fold")
        # 4. the crash: the primary is dropped without close(); the follower is promoted
        zombie, primary = primary, None
        applied = zombie._wal_seq
        # the promotion's steps are spans: obs on around it alone (obs.reset() would also
        # clear every engine's telemetry, so only the tracer is cleared)
        obs.TRACER.clear()
        obs.enable()
        t0 = time.perf_counter()
        try:
            follower.promote()
        finally:
            obs.disable()
        rec["promote_ms"] = (time.perf_counter() - t0) * 1e3
        spans = {s["name"]: s["dur_ns"] / 1e6 for s in obs.TRACER.spans() if s["name"].startswith("repl.")}
        obs.TRACER.clear()
        rec.update(drain_ms=spans.get("repl.drain"), fence_ms=spans.get("repl.fence"), pin_ms=spans.get("repl.pin"),
                   promote_span_ms=spans.get("repl.promote"))
        _check(not follower._repl_follower and follower._repl_epoch == 2 and applier.applied_seq == applied,
               f"P3 {name}: promoted {not follower._repl_follower}, epoch {follower._repl_epoch}, "
               f"applied {applier.applied_seq} of {applied}")
        _k_check_states(torch, follower, folds, rows, f"P3 {name} promoted vs fold")
        # 5. the zombie ships after the promotion: the link's fence refuses it
        promoted = _p_states(follower)
        zreqs = segments[0][:P3_ZOMBIE]
        _k_submit(zombie, zreqs, 1)
        _wait_for(lambda: zombie._shipper.fenced, f"P3 {name}: the zombie's shipper is fenced")
        _check(zombie.health()["state"] == "DEGRADED", f"P3 {name}: the zombie's health is not DEGRADED")
        _m_equal(torch, _p_states(follower), promoted, f"P3 {name} promoted states after the zombie's writes")
        rec["zombie"] = {"requests": len(zreqs), "fenced": True,
                         "send_rejections": zombie.telemetry_snapshot()["fenced_rejections"]}
        # 6. the promoted engine serves
        more = segments[0][:after]
        _k_submit(follower, more, K_THREADS)
        folds, rows = _k_fold(torch, make(), served + more, "cuda")
        rec["promoted_leaves_equal_fold"] = _k_check_states(torch, follower, folds, rows,
                                                            f"P3 {name} promoted engine vs fold")
        rec["served_after_promotion"] = len(more)
        snap = follower.telemetry_snapshot()
        _check(snap["failed"] == 0 and snap["fused_fallbacks"] == 0, f"P3 {name}: {snap['failed']} failed, "
               f"{snap['fused_fallbacks']} fallbacks, capture error {follower._fused_error!r}")
        rec["follower_captures"] = snap["compiles"]
    finally:
        watching.set()
        watcher.join(60)
        follower.close()
        for engine in (primary, zombie):
            if engine is not None:
                engine.close(checkpoint=False)
    rec["lag_peak_seqs"], rec["lag_peak_s"] = peak["seqs"], peak["seconds"]
    print(f"phase P3 {name} {json.dumps(rec)}")
    return rec


def phase_p3(torch, np) -> dict:
    import tempfile

    from metrics_tpu_torch import QuantileSketch

    rng = np.random.default_rng(43)

    def labels(rows):
        return rng.integers(0, K2_CLASSES, rows).astype(np.int64), rng.integers(0, K2_CLASSES, rows).astype(np.int64)

    n = P3_SEGMENTS["flagship"]
    flagship = [[(f"tenant-{int(rng.integers(0, K_TENANTS))}", labels(int(rng.integers(K2_ROWS[0], K2_ROWS[1] + 1))))
                 for _ in range(n)] for _ in range(3 + P3_PROFILE_ATTEMPTS)]
    quantile = [_k_quantile_reqs(np, 50 + i, P3_SEGMENTS["quantile"], K_TENANTS) for i in range(3 + P3_PROFILE_ATTEMPTS)]
    out = {}
    # each snapshot of the flagship collection is 32 MB: the lineages go to memory where the machine has it
    with tempfile.TemporaryDirectory(dir="/dev/shm" if os.path.isdir("/dev/shm") else None) as d:
        for name, make, segments, kernels in (("flagship", _k2_metric, flagship, ("stat_scores", "pair_count")),
                                              ("quantile", QuantileSketch, quantile, ("hist_add",))):
            os.makedirs(os.path.join(d, name))
            out[name] = _p3_run(torch, np, name, make, segments, P3_AFTER_PROMOTION, kernels, os.path.join(d, name))
    return out


def phase_p4(torch, np) -> dict:
    """Fencing and obs: (a) a zombie primary shipping over TCP, whose sender cannot
    see the fence, refused at the follower's receive side; (b) a guard quarantine
    of a primary promoting its follower through failover_hook, with the flight
    bundle it dumps loaded back; (c) a traced submit's trace id in the follower's
    engine.replay span, and the heartbeat's node snapshot in the aggregator."""
    import tempfile

    from metrics_tpu_torch import obs
    from metrics_tpu_torch.classification import BinaryAccuracy
    from metrics_tpu_torch.engine import CheckpointConfig, GuardConfig, ReplConfig, StreamingEngine
    from metrics_tpu_torch.guard.faults import hold_dispatch_lock, wedge_dispatcher
    from metrics_tpu_torch.obs.fleet import AGGREGATOR
    from metrics_tpu_torch.obs.flight import FLIGHT, load_bundle
    from metrics_tpu_torch.repl import LoopbackLink, SocketShipReceiver, SocketShipSender, failover_hook

    reqs = _k6_reqs(np, 2 * P4_REQUESTS, K_TENANTS)
    kw = dict(buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=K_TENANTS)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        # (a) receive-side fencing
        receiver = SocketShipReceiver()
        sender = SocketShipSender("127.0.0.1", receiver.port)
        primary = StreamingEngine(BinaryAccuracy(device="cuda"), checkpoint=CheckpointConfig(
            directory=os.path.join(d, "a"), interval_s=3600.0, durable=False),
            replication=ReplConfig(role="primary", transport=sender, ship_interval_s=P_SHIP_INTERVAL_S,
                                   heartbeat_interval_s=P2_HEARTBEAT_S), **kw)
        follower = StreamingEngine(BinaryAccuracy(device="cuda"), replication=ReplConfig(
            role="follower", transport=receiver, poll_interval_s=0.005), **kw)
        try:
            _k_submit(primary, reqs[:P4_REQUESTS], K_THREADS)
            _check(follower._applier.await_seq(primary._wal_seq, 300), "P4a: the follower did not catch up")
            _m_equal(torch, _p_states(follower), _p_states(primary), "P4a follower vs primary")
            follower.promote()
            promoted = _p_states(follower)
            _k_submit(primary, reqs[P4_REQUESTS:], K_THREADS)  # the zombie writes and ships
            target = primary._wal_seq
            _wait_for(lambda: primary._shipper.last_shipped_seq >= target, "P4a: the zombie shipped")
            delivered = []
            _wait_for(lambda: delivered.extend(receiver.recv(timeout_s=0.05)) or receiver.fenced_rejected > 0,
                      "P4a: the receive side refused the zombie's frames")
            time.sleep(0.2)
            delivered += receiver.recv(timeout_s=0.1)
            _check(not delivered, f"P4a: {len(delivered)} zombie frames passed the fence")
            _m_equal(torch, _p_states(follower), promoted, "P4a promoted states after the zombie's shipments")
            out["receive_side_fencing"] = {"fenced_rejected": receiver.fenced_rejected, "fence": receiver.fenced_epoch,
                                           "zombie_sender_fenced": primary._shipper.fenced, "delivered": 0}
        finally:
            follower.close()
            primary.close(checkpoint=False)
            sender.close()
            receiver.close()

        # (b) and (c), obs on
        obs.reset()
        obs.enable()
        FLIGHT.configure(directory=os.path.join(d, "flight"))
        link = LoopbackLink()
        follower = StreamingEngine(BinaryAccuracy(device="cuda"), replication=ReplConfig(
            role="follower", transport=link, poll_interval_s=0.005,
            promote_checkpoint=CheckpointConfig(directory=os.path.join(d, "b-promoted"), interval_s=3600.0,
                                                durable=False)), **kw)
        primary = StreamingEngine(BinaryAccuracy(device="cuda"), checkpoint=CheckpointConfig(
            directory=os.path.join(d, "b"), interval_s=3600.0, durable=False),
            guard=GuardConfig(shed=False, on_health_transition=failover_hook(follower), **P4_WATCHDOG),
            replication=ReplConfig(role="primary", transport=link, ship_interval_s=P_SHIP_INTERVAL_S,
                                   heartbeat_interval_s=P2_HEARTBEAT_S), **kw)
        try:
            rng = np.random.default_rng(13)
            keys = sorted({key for key, _ in reqs})
            for key in keys:
                primary._alloc_slot(key)
            for rows in K_BUCKETS:
                # one capture at a time: the follower captures its rung while it replays the
                # primary's, and the primary's 2 s watchdog must outlast the primary's capture
                primary.submit(keys[0], rng.integers(0, 2, rows), rng.integers(0, 2, rows)).result(timeout=300)
                primary.flush(timeout=300)
                _check(follower._applier.await_seq(primary._wal_seq, 300), "P4b: the follower did not warm up")
            primary.reset()
            _k_submit(primary, reqs[:P4_REQUESTS], K_THREADS)
            ctx = obs.mint()
            with obs.activate(ctx):
                primary.submit(*reqs[0][:1], *reqs[0][1]).result(timeout=300)
            _check(follower._applier.await_seq(primary._wal_seq, 300), "P4c: the follower did not catch up")
            replays = [s for s in obs.TRACER.spans()
                       if s["name"] == "engine.replay" and s["thread_name"] == "metrics-tpu-repl-apply"]
            traced = [s for s in replays if ctx.trace_hex in s["attrs"].get("traces", "")]
            _check(len(traced) == 1, f"P4c: {len(traced)} follower replay spans name the traced submit")
            node = f"primary:{primary.telemetry.engine_id}"
            _wait_for(lambda: node in AGGREGATOR.nodes(), "P4c: the primary's node snapshot reached the aggregator")
            page = AGGREGATOR.render_prometheus()
            _check(f'node="{node}"' in page and "metrics_tpu_torch_repl_shipped_records_total" in page,
                   "P4c: the fleet page lacks the primary's series")
            out["trace"] = {"trace_id": ctx.trace_hex, "follower_replay_spans": len(replays),
                            "replay_kind": traced[0]["attrs"]["kind"], "fleet_nodes": sorted(AGGREGATOR.nodes())}
            t0 = time.perf_counter()
            with wedge_dispatcher(primary), hold_dispatch_lock(primary):
                pending = primary.submit(*reqs[1][:1], *reqs[1][1])
                quarantine_s = _wait_for(lambda: primary.quarantined, "P4b: the primary quarantines")
                _check(pending.exception(timeout=60) is not None, "P4b: the pending request did not fail")
            failover_s = _wait_for(lambda: follower.telemetry_snapshot()["promotions"] == 1,
                                   "P4b: the failover hook promoted the follower") + quarantine_s
            counts = FLIGHT.dump_counts()
            _check(counts.get("engine_quarantine") == 1, f"P4b: flight dumps {counts}")
            bundle = next(b for b in FLIGHT.bundles() if b["trigger"] == "engine_quarantine")
            loaded = load_bundle(bundle["path"])
            _check(loaded["trigger"] == "engine_quarantine" and f"engine:{primary.telemetry.engine_id}"
                   in loaded["contexts"], "P4b: the loaded bundle lacks the engine's context")
            follower.submit(*reqs[2][:1], *reqs[2][1]).result(timeout=300)
            out["failover"] = {"quarantine_s": quarantine_s, "quarantine_to_promoted_s": failover_s,
                               "flight_dumps": counts, "bundle_bytes": os.path.getsize(bundle["path"]),
                               "bundle_spans": len([e for e in loaded["trace"]["traceEvents"] if e["ph"] == "X"]),
                               "promoted_epoch": follower._repl_epoch, "wall_s": time.perf_counter() - t0}
        finally:
            follower.close()
            primary.close(checkpoint=False)
            FLIGHT.configure(directory=None)
            obs.reset()
    print(f"phase P4 {json.dumps(out)}")
    return out


def phase_p(torch, np) -> dict:
    """The replication plane on the card (P1 to P4)."""
    t0 = time.perf_counter()
    out = {"P1": phase_p1(torch, np)}
    print(f"phase P1 {json.dumps(out['P1'])}")
    out["P2"] = phase_p2(torch, np)
    print(f"phase P2 {json.dumps(out['P2'])}")
    out["P3"] = phase_p3(torch, np)
    out["P4"] = phase_p4(torch, np)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase P: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------- Phase Q: the comm plane

Q_STEPS = 6  # Q1's graph replays and eager steps, Q2's training steps (cut)
Q2_NO_SYNC_STEPS = 3  # Q2 steps timed without the metrics' sync
Q_SYNC_REPS = 3  # Q2's timed sync_state calls, and its timed Metric.sync() calls
Q3_REQUESTS = 4000  # K2's request generator, split between the two serving processes
Q_BENCH_ELEMENTS = 262144  # benchmarks/comm_bench.py's base cat-state size (fp32 elements)
Q_BENCH_SKEWS = (1.0, 0.5, 0.55, 0.6)  # its rank skews, world 4
Q_BENCH_REPEATS, Q_BENCH_SYNCS = 5, 30  # its overhead gate's rounds and syncs a round
Q_GATES = {"wire_reduction_ge_x": 4.0, "lossless_overhead_lt_pct": 5.0}  # its two gates
Q4_WORLD = 3
Q4_BATCHES = 4  # updates of each rank's flagship collection state
Q4_CAT = 4096  # float32 scores of the cat state the stall ladder quantizes
Q_CHILD_TIMEOUT_S = 300


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _q_labels(torch, gen, n: int, classes: int):
    return (torch.randint(0, classes, (n,), device="cuda", generator=gen),
            torch.randint(0, classes, (n,), device="cuda", generator=gen))


def _q_equal_trees(torch, got, want, what: str, skip_count: bool = False) -> int:
    """Every leaf ``torch.equal`` with its dtype (on the CPU); the number compared."""
    a, b = _k_leaves(got), _k_leaves(want)
    _check(set(a) == set(b), f"{what}: leaves {sorted(a)} vs {sorted(b)}")
    n = 0
    for path, x in a.items():
        if skip_count and path.endswith("_update_count"):
            continue
        y = b[path]
        x = torch.as_tensor(x).cpu()
        y = torch.as_tensor(y).cpu()
        _check(x.dtype == y.dtype and torch.equal(x, y), f"{what}: {path} differs")
        n += 1
    return n


def _q_to_cpu(torch, tree):
    if isinstance(tree, dict):
        return {k: _q_to_cpu(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_q_to_cpu(torch, v) for v in tree]
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def phase_q1(torch, entry_mod, confmat, card: str) -> dict:
    """The device path at world 1 over NCCL on cuda:0: the flagship metrics'
    update_state -> sync_state(s, group) -> compute_from at bench.py's shape,
    eager and captured in one CUDA graph, replayed Q_STEPS times."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from metrics_tpu_torch.utils.checks import traced
    from metrics_tpu_torch.utils.graphs import capture

    cfg = entry_mod.FULL_CONFIG
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        group = dist.group.WORLD
        metrics = entry_mod.make_metrics(cfg["classes"], "cuda")
        gen = torch.Generator(device="cuda").manual_seed(11)
        batches = [_q_labels(torch, gen, cfg["batch"], cfg["classes"]) for _ in range(Q_STEPS)]

        def step(states, preds, target):
            new, synced, values = {}, {}, {}
            for name, m in metrics.items():
                new[name] = m.update_state(states[name], preds, target)
                synced[name] = m.sync_state(new[name], group)
                values[name] = m.compute_from(synced[name])
            return new, synced, values

        # one eager collective first: the communicator exists before anything is timed or captured
        t0 = time.perf_counter()
        dist.all_reduce(torch.zeros(1, device="cuda"), group=group)
        torch.cuda.synchronize()
        communicator_s = time.perf_counter() - t0
        # eager, counted
        states = {n: m.init_state() for n, m in metrics.items()}
        confmat.launches = confmat.stat_score_launches = 0  # the eager path's run starts here
        t0 = time.perf_counter()
        for preds, target in batches:
            states, synced, values = step(states, preds, target)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3 / Q_STEPS
        eager_launches = {"stat_scores": confmat.stat_score_launches, "pair_count": confmat.launches}  # ... ends here
        _check(eager_launches == {"stat_scores": 2 * Q_STEPS, "pair_count": Q_STEPS},
               f"Q1 eager: launches {eager_launches}")
        _q_equal_trees(torch, synced, states, "Q1 eager: the world-of-one sync")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as eager_prof:
            step(states, *batches[0])
            torch.cuda.synchronize()
        eager_nccl = {}  # NCCL's operations in one eager step (its kernels too, where it launches any)
        for ev in eager_prof.events():
            if "nccl" in ev.name.lower():
                eager_nccl[ev.name[:60]] = eager_nccl.get(ev.name[:60], 0) + 1

        # the same step captured once: static states and labels, chained by copies between replays
        static_states = {n: m.init_state() for n, m in metrics.items()}
        static_p, static_t = (b.clone() for b in batches[0])
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream), traced():
            step(static_states, static_p, static_t)  # warm-up off the capture
        torch.cuda.current_stream().wait_stream(stream)
        before = {"stat_scores": confmat.stat_score_launches, "pair_count": confmat.launches}
        with traced():
            t0 = time.perf_counter()
            graph, (g_new, g_synced, g_values) = capture(lambda: step(static_states, static_p, static_t), stream)
            capture_ms = (time.perf_counter() - t0) * 1e3
        captured = {"stat_scores": confmat.stat_score_launches - before["stat_scores"],
                    "pair_count": confmat.launches - before["pair_count"]}  # a wrapper counts once, at capture
        _check(captured == {"stat_scores": 2, "pair_count": 1}, f"Q1: the graph captured {captured}")

        def replay_all():
            for n in static_states:
                for k, v in metrics[n].init_state().items():
                    static_states[n][k].copy_(v)
            for preds, target in batches:
                static_p.copy_(preds)
                static_t.copy_(target)
                graph.replay()
                for n in static_states:
                    for k in static_states[n]:
                        static_states[n][k].copy_(g_new[n][k])

        replay_all()
        torch.cuda.synchronize()
        compared = _q_equal_trees(torch, g_new, states, "Q1 graph: states against the eager fold")
        compared += _q_equal_trees(torch, g_synced, synced, "Q1 graph: synced states")
        compared += _q_equal_trees(torch, g_values, values, "Q1 graph: compute_from values")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        replay_all()
        end.record()
        torch.cuda.synchronize()
        replay_ms = start.elapsed_time(end) / Q_STEPS
        want = {k: captured[k] * Q_STEPS for k in ROUTES}
        attempts = []
        for attempt in range(3):
            times = _warm_profile(torch, lambda: (replay_all(), torch.cuda.synchronize()))
            # the second witness: the profiled replays all ran, or the states would fall short
            compared += _q_equal_trees(torch, g_new, states, f"Q1 profiled replays {attempt}: states")
            seen = {k: sum(len(v) for n, v in times.items() if K_PROFILE_NAMES[k][0] in n) for k in ROUTES}
            attempts.append(seen)
            if seen == want or not times:
                break
        # The profiler can lose a kernel record now and then (as in P3), never invent one. A replay
        # launches all its nodes or none, so a deficit under one replay's launches of a kernel, in
        # any attempt, still shows every replay launched it.
        for k in ROUTES:
            _check(not times or any(0 <= want[k] - a[k] < captured[k] for a in attempts),
                   f"Q1: profiled launches against captured x replays, each attempt: {attempts}")
        _check(all(a[k] <= want[k] for a in attempts for k in ROUTES),
               f"Q1: more launches profiled than captured x replays: {attempts}")
        # NCCL's own kernels in the replays (a world of one may need none for an in-place all-reduce)
        nccl = {n[:60]: len(v) for n, v in times.items() if "nccl" in n.lower()}
        _check(bool(eager_nccl), "Q1: no NCCL operation in the eager steps' profile")
    finally:
        dist.destroy_process_group()
    return {"card": card, "steps": Q_STEPS, "communicator_s": communicator_s, "eager_step_ms": eager_ms,
            "replay_step_ms": replay_ms,
            "capture_ms": capture_ms, "graph_nodes": _graph_nodes(graph), "leaves_equal": compared,
            "launches_eager": eager_launches, "launches_captured": captured, "launches_in_replays": want,
            "launches_profiled": seen, "profile_attempts": len(attempts), "profiled_each_attempt": attempts,
            "nccl_in_replays": nccl,
            "nccl_in_eager_profile": eager_nccl,
            "all_reduces_per_step": sum(len(m._reductions) for m in metrics.values()),
            "accuracy": float(values["accuracy"])}


def _q_child(mode: str, rank: int, port: int, out_dir: str) -> int:
    """A rank of Phase Q2 or Q3 (this script started with ``--q-rank``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
    try:
        out = _q2_rank(torch, rank) if mode == "q2" else _q3_rank(torch, rank)
        torch.save(out, os.path.join(out_dir, f"{mode}_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
    print("DONE", flush=True)
    return 0


def _q_spawn(mode: str, out_dir: str) -> list:
    """Both ranks of ``mode`` as processes of their own on cuda:0; their results."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--q-rank", mode, str(r), str(port), out_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for r, proc in enumerate(procs):
            out, err = proc.communicate(timeout=Q_CHILD_TIMEOUT_S)
            outs.append((proc.returncode, out, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(60)
    for r, (rc, out, err) in enumerate(outs):
        _check(rc == 0 and "DONE" in out, f"{mode} rank {r}: rc {rc}, stdout {out[-400:]!r}, stderr {err[-1500:]!r}")
    import torch

    return [torch.load(os.path.join(out_dir, f"{mode}_rank{r}.pt")) for r in range(2)]


def _q2_rank(torch, rank: int) -> dict:
    """One data-parallel rank: bench.py's step at full width on this rank's
    seeded batch, the metrics synced over dp every step."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh

    import metrics_tpu_torch.entry as entry_mod
    from metrics_tpu_torch.kernels import confmat
    from metrics_tpu_torch.obs.instrument import tree_nbytes
    from metrics_tpu_torch.parallel.sync import reduce_in_trace, use_mesh

    cfg = entry_mod.FULL_CONFIG
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("dp",))
    params, _, _ = entry_mod.make_inputs(0, 1, cfg["hidden"], cfg["classes"], cfg["layers"], "cuda")
    rng = np.random.default_rng(100 + rank)  # this rank's own batch
    x = torch.from_numpy(rng.standard_normal((cfg["batch"], cfg["hidden"])).astype(np.float32)).to("cuda")
    y = torch.from_numpy(rng.integers(0, cfg["classes"], cfg["batch"])).to("cuda")
    metrics = entry_mod.make_metrics(cfg["classes"], "cuda")
    step = entry_mod.make_dp_step(metrics)
    seen = []
    update_state = metrics["accuracy"].update_state

    def recording_update_state(state, preds, target):
        seen.append(preds.clone())
        return update_state(state, preds, target)

    with use_mesh(mesh):
        init = {n: m.init_state() for n, m in metrics.items()}
        step(params, init, x, y)  # warm-up: gloo's buffers, the kernels loaded
        metrics["accuracy"].update_state = recording_update_state
        states = {n: m.init_state() for n, m in metrics.items()}
        confmat.launches = confmat.stat_score_launches = 0  # the main path's run starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for _ in range(Q_STEPS):
            loss, params, states, values = step(params, states, x, y)
            losses.append(loss)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / Q_STEPS
        launches = {"stat_scores": confmat.stat_score_launches, "pair_count": confmat.launches}  # ... ends here
        # what the metrics' all-reduces move per participant a step: every registered state once
        sync_bytes = sum(tree_nbytes({k: states[n][k] for k in m._reductions}) for n, m in metrics.items())
        del metrics["accuracy"].update_state

        # the same step with each metric's compute_from on its local state (no metric sync)
        local = dict(states)
        p2 = params
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(Q2_NO_SYNC_STEPS):
            p2, _, logits = entry_mod.dp_sgd_step(p2, x, y, "dp")
            preds = torch.argmax(logits, dim=-1)
            for n, m in metrics.items():
                local[n] = m.update_state(local[n], preds, y)
                m.compute_from(local[n])
        torch.cuda.synchronize()
        no_sync_step_ms = (time.perf_counter() - t0) * 1e3 / Q2_NO_SYNC_STEPS

        synced = {n: m.sync_state(states[n], "dp") for n, m in metrics.items()}
        # the gathers on the card over gloo: the labels as a cat state, a row of the batch through int8
        gathers = {"cat": reduce_in_trace(y, "cat", "dp"), "int8": reduce_in_trace(x[0], None, "dp", codec="int8")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(Q_SYNC_REPS):
            for n, m in metrics.items():
                m.sync_state(states[n], "dp")
        torch.cuda.synchronize()
        sync_ms = (time.perf_counter() - t0) * 1e3 / Q_SYNC_REPS

    # the host path on the same states: each metric's Metric.sync() with the default dist_sync_fn
    # (gather_all_tensors: every state staged through numpy and all-gathered over gloo), then unsync
    stateful = entry_mod.make_metrics(cfg["classes"], "cuda")
    for n, m in stateful.items():
        for k in m._reductions:
            setattr(m, k, states[n][k])
    for m in stateful.values():  # warm-up
        m.sync()
        m.unsync()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(Q_SYNC_REPS):
        for m in stateful.values():
            m.sync()
            m.unsync()
    torch.cuda.synchronize()
    host_sync_ms = (time.perf_counter() - t0) * 1e3 / Q_SYNC_REPS
    for m in stateful.values():
        m.sync()
    host_synced = {n: {k: getattr(m, k) for k in m._reductions} for n, m in stateful.items()}
    return {"step_ms": step_ms, "no_sync_step_ms": no_sync_step_ms, "metric_sync_ms_per_step": sync_ms,
            "host_sync_ms": host_sync_ms, "host_synced": _q_to_cpu(torch, host_synced),
            "sync_bytes_per_step": sync_bytes, "launches": launches, "losses": torch.stack(losses).cpu(),
            "preds": torch.stack(seen).cpu(), "target": y.cpu(), "synced": _q_to_cpu(torch, synced),
            "values": _q_to_cpu(torch, values), "head_sum": float(params["head"].double().sum()),
            "gathers": _q_to_cpu(torch, gathers), "row": x[0].cpu(),
            "device": torch.cuda.get_device_name(0)}


def phase_q2(torch, entry_mod, out_dir: str, card: str) -> dict:
    """Data-parallel training at full width, two processes on cuda:0 over gloo."""
    t0 = time.perf_counter()
    ranks = _q_spawn("q2", out_dir)
    wall = time.perf_counter() - t0
    cfg = entry_mod.FULL_CONFIG
    for r, got in enumerate(ranks):
        _check(got["launches"] == {"stat_scores": 2 * Q_STEPS, "pair_count": Q_STEPS},
               f"Q2 rank {r}: launches {got['launches']} in {Q_STEPS} steps")
        _check(bool(torch.isfinite(got["losses"]).all()), f"Q2 rank {r}: non-finite loss")
    _check(ranks[0]["head_sum"] == ranks[1]["head_sum"], "Q2: the ranks' weights differ after the averaged updates")
    _check(torch.equal(ranks[0]["losses"], ranks[1]["losses"]), "Q2: the ranks' averaged losses differ")
    # one process over both ranks' batches: the same predictions, folded on the card
    metrics = entry_mod.make_metrics(cfg["classes"], "cuda")
    fold = {n: m.init_state() for n, m in metrics.items()}
    for got in ranks:
        target = got["target"].to("cuda")
        for preds in got["preds"]:
            preds = preds.to("cuda")
            fold = {n: m.update_state(fold[n], preds, target) for n, m in metrics.items()}
    compared = 0
    for r, got in enumerate(ranks):
        compared += _q_equal_trees(torch, got["synced"], fold, f"Q2 rank {r}: synced counts", skip_count=True)
        want = {n: m.compute_from(fold[n]) for n, m in metrics.items()}
        compared += _q_equal_trees(torch, got["values"], want, f"Q2 rank {r}: values")
        in_step = {n: {k: got["synced"][n][k] for k in leaves} for n, leaves in got["host_synced"].items()}
        compared += _q_equal_trees(torch, got["host_synced"], in_step, f"Q2 rank {r}: Metric.sync() against sync_state")
    # the all-gathers of CUDA tensors over gloo: the labels concatenated, the rows through int8
    from metrics_tpu_torch.comm.codec import Int8BlockCodec

    codec = Int8BlockCodec()
    want_int8 = torch.stack([torch.from_numpy(codec.decode(codec.encode(g["row"].numpy()))) for g in ranks])
    for r, got in enumerate(ranks):
        _check(torch.equal(got["gathers"]["cat"], torch.cat([g["target"] for g in ranks])), f"Q2 rank {r}: cat gather")
        _check(torch.equal(got["gathers"]["int8"], want_int8), f"Q2 rank {r}: int8 gather against the host codec")
    mean = lambda key: sum(g[key] for g in ranks) / len(ranks)  # noqa: E731
    return {"card": card, "ranks": 2, "steps": Q_STEPS, "config": cfg, "wall_s": wall,
            "step_ms": mean("step_ms"), "no_sync_step_ms": mean("no_sync_step_ms"),
            "metric_sync_ms_per_step": mean("metric_sync_ms_per_step"),
            # the metrics' sync timed alone, as a share of the step (the two step loops differ by
            # more than the sync between runs: the gradients' gloo all-reduce dominates both)
            "sync_share_pct": mean("metric_sync_ms_per_step") / mean("step_ms") * 100.0,
            "sync_bytes_per_step": mean("sync_bytes_per_step"),
            # Metric.sync() of the three metrics, the host path (gather_all_tensors over gloo)
            "host_sync_ms": mean("host_sync_ms"), "host_sync_share_pct": mean("host_sync_ms") / mean("step_ms") * 100.0,
            "launches_per_rank_step": {k: ranks[0]["launches"][k] / Q_STEPS for k in ROUTES},
            "leaves_equal": compared, "loss_first_last": [float(ranks[0]["losses"][0]), float(ranks[0]["losses"][-1])],
            "by_rank": [{k: g[k] for k in ("step_ms", "no_sync_step_ms", "metric_sync_ms_per_step",
                                             "host_sync_ms", "sync_bytes_per_step")} for g in ranks]}


def _q3_reqs(np):
    """K2's request generator (its seed, 1-16 int64 label pairs, 8 tenants) for Q3_REQUESTS requests."""
    rng = np.random.default_rng(5)

    def labels(rows):
        return rng.integers(0, K2_CLASSES, rows).astype(np.int64), rng.integers(0, K2_CLASSES, rows).astype(np.int64)

    return [(f"tenant-{int(rng.integers(0, K_TENANTS))}", labels(int(rng.integers(K2_ROWS[0], K2_ROWS[1] + 1))))
            for _ in range(Q3_REQUESTS)]


def _q3_engine(torch, np, reqs):
    from metrics_tpu_torch.engine import StreamingEngine

    rng = np.random.default_rng(6)
    engine = StreamingEngine(_k2_metric(), buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=K_TENANTS)
    _k_warm(engine, lambda rows: (rng.integers(0, K2_CLASSES, rows), rng.integers(0, K2_CLASSES, rows)),
            K_BUCKETS, [f"tenant-{t}" for t in range(K_TENANTS)])
    _k_submit(engine, reqs, K_THREADS)
    return engine


def _q3_rank(torch, rank: int) -> dict:
    """One serving rank: a K2 engine over its half of the requests, then the
    cross-process reads through the comm plane's host path."""
    import numpy as np

    from metrics_tpu_torch import comm, obs
    from metrics_tpu_torch.obs import instrument

    engine = _q3_engine(torch, np, _q3_reqs(np)[rank::2])
    try:
        torch.cuda.synchronize()
        obs.enable()  # the comm counters: raw and wire bytes of every member's sync
        t0 = time.perf_counter()
        synced_all = engine.compute_all(sync=True)
        sync_all_s = time.perf_counter() - t0
        obs.disable()
        all_bytes = {k: int(c.value(site="engine.compute")) for k, c in (("raw", instrument.COMM_RAW_BYTES),
                                                                           ("wire", instrument.COMM_WIRE_BYTES))}
        report = comm.last_report()
        t0 = time.perf_counter()
        one = engine.compute("tenant-3", sync=True)
        sync_one_s = time.perf_counter() - t0
        one_report = comm.last_report()
        local = engine.compute_all()
    finally:
        engine.close()
    return {"all": _q_to_cpu(torch, synced_all), "one": _q_to_cpu(torch, one), "local": _q_to_cpu(torch, local),
            "sync_all_s": sync_all_s, "sync_one_s": sync_one_s, "compute_all_bytes": all_bytes,
            "reports": [{k: getattr(rep, k) for k in ("site", "world", "raw_bytes", "wire_bytes", "retries",
                                                      "timeouts", "degraded_step", "stale")}
                        for rep in (report, one_report)]}


class _QMeter:
    """Counts the bytes one rank sends (benchmarks/comm_bench.py's meter)."""

    def __init__(self, inner) -> None:
        self._inner = inner
        self.sent = 0
        self.rank = getattr(inner, "rank", None)
        self.supports_broadcast = inner.supports_broadcast

    def world_size(self) -> int:
        return self._inner.world_size()

    def allgather(self, x):
        self.sent += int(x.nbytes)
        return self._inner.allgather(x)

    def broadcast_from(self, x, root, shape, dtype):
        if x is not None:
            self.sent += int(x.nbytes)
        return self._inner.broadcast_from(x, root, shape, dtype)


def _q_legacy_gather(np, transport, x):
    """The pre-comm gather protocol (comm_bench.py's ``_legacy_gather``):
    shapes, then pad-to-max + trim, fp32 on the wire, no exact broadcast."""
    world = transport.world_size()
    all_shapes = [tuple(int(d) for d in s) for s in transport.allgather(np.asarray(x.shape, np.int64))]
    if all(s == all_shapes[0] for s in all_shapes):
        return transport.allgather(x)
    max_shape = tuple(max(s[d] for s in all_shapes) for d in range(len(all_shapes[0])))
    gathered = transport.allgather(np.pad(x, [(0, m - s) for m, s in zip(max_shape, x.shape)]))
    return [np.asarray(gathered[i])[tuple(slice(0, d) for d in all_shapes[i])] for i in range(world)]


def _q_legacy_sync(torch, state, reductions, gather):
    """The pre-comm ``sync_state_host`` body (comm_bench.py's baseline) in torch:
    every leaf gathered and reduced where it lives."""
    ops = {"sum": lambda g: g.sum(0, dtype=g.dtype), "mean": lambda g: g.mean(0), "max": lambda g: g.amax(0),
           "min": lambda g: g.amin(0)}
    synced = dict(state)
    for name, reduction in reductions.items():
        val = state[name]
        if isinstance(val, list):
            synced[name] = [torch.cat(gather(torch.cat(val)))]
            continue
        gathered = torch.stack(gather(val))
        synced[name] = ops[reduction](gathered) if reduction in ops else torch.cat(list(gathered))
    synced["_update_count"] = torch.stack(gather(state["_update_count"])).sum(0, dtype=torch.int32)
    return synced


def _q_bench_gates(torch, np) -> dict:
    """benchmarks/comm_bench.py's two gates at its configuration, the states on the card."""
    from metrics_tpu_torch import comm

    rng = np.random.default_rng(0)
    shards = [rng.standard_normal(int(Q_BENCH_ELEMENTS * s)).astype(np.float32) for s in Q_BENCH_SKEWS]
    states = [{"preds": torch.from_numpy(sh).to("cuda"), "_update_count": torch.ones((), dtype=torch.int32,
                                                                                      device="cuda")} for sh in shards]
    world = len(shards)
    legacy_meters, comm_meters = [], []

    def legacy_rank(t):
        m = _QMeter(t)
        legacy_meters.append(m)
        _q_legacy_gather(np, m, states[t.rank]["preds"].cpu().numpy())
        return _q_legacy_gather(np, m, states[t.rank]["_update_count"].cpu().numpy())

    comm.LoopbackWorld(world).run([legacy_rank] * world)
    cfg = comm.CommConfig(policy=comm.CodecPolicy(lossy="int8"))

    def comm_rank(t):
        m = _QMeter(t)
        comm_meters.append(m)
        return comm.sync_pytree(states[t.rank], {"preds": "cat"}, transport=m, config=cfg, site="comm_bench")

    outs = comm.LoopbackWorld(world).run([comm_rank] * world)
    union = np.concatenate(shards)
    got = outs[0]["preds"]
    _check(got.is_cuda and tuple(got.shape) == union.shape and int(outs[0]["_update_count"]) == world,
           f"Q3 gates: the int8 union {got.device} {tuple(got.shape)}")
    err = float(np.max(np.abs(got.cpu().numpy() - union)))
    bound = float(max(np.abs(sh).max() for sh in shards)) / 254.0 + 1e-7
    _check(err <= bound, f"Q3 gates: int8 error {err} above absmax/254 = {bound}")
    ratio = sum(m.sent for m in legacy_meters) / sum(m.sent for m in comm_meters)
    _check(ratio >= Q_GATES["wire_reduction_ge_x"], f"Q3 gates: wire reduction {ratio}x under 4x")

    # the lossless planned path against the pre-comm sync, a zero-cost world of 2
    srng = np.random.default_rng(1)
    state = {f"leaf{i}": torch.from_numpy(srng.standard_normal(1024 * (1 + i % 4)).astype(np.float32)).to("cuda")
             for i in range(10)}
    state["counts"] = torch.from_numpy(srng.integers(0, 100, 64).astype(np.int32)).to("cuda")
    state["preds"] = torch.from_numpy(srng.standard_normal(16384).astype(np.float32)).to("cuda")
    state["_update_count"] = torch.full((), 3, dtype=torch.int32, device="cuda")
    reds = {f"leaf{i}": "sum" for i in range(10)} | {"counts": "sum", "preds": "cat"}

    class _NoCopyReplica(comm.Transport):
        def world_size(self):
            return 2

        def allgather(self, x):
            return [x, x]

    tr, lossless = _NoCopyReplica(), comm.CommConfig()
    legacy_gather = lambda x: [x, x]  # noqa: E731 — comm_bench.py's cheapest possible fake world
    a, b = _q_legacy_sync(torch, state, reds, legacy_gather), comm.sync_pytree(state, reds, transport=tr, config=lossless)
    for k in a:
        _check(torch.equal(torch.as_tensor(a[k]).cpu(), torch.as_tensor(b[k]).cpu()), f"Q3 gates: {k} differs")
    best_legacy = best_comm = float("inf")
    for _ in range(Q_BENCH_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(Q_BENCH_SYNCS):
            _q_legacy_sync(torch, state, reds, legacy_gather)
        torch.cuda.synchronize()
        best_legacy = min(best_legacy, time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(Q_BENCH_SYNCS):
            comm.sync_pytree(state, reds, transport=tr, config=lossless)
        torch.cuda.synchronize()
        best_comm = min(best_comm, time.perf_counter() - t0)
    overhead = (best_comm - best_legacy) / best_legacy * 100.0
    return {"wire_reduction_x": ratio, "legacy_wire_bytes": sum(m.sent for m in legacy_meters),
            "comm_wire_bytes": sum(m.sent for m in comm_meters), "int8_max_abs_err": err, "int8_bound": bound,
            "lossless_overhead_pct": overhead, "legacy_ms_per_sync": best_legacy * 1e3 / Q_BENCH_SYNCS,
            "comm_ms_per_sync": best_comm * 1e3 / Q_BENCH_SYNCS, "jax_gates": Q_GATES,
            "overhead_within_gate": overhead < Q_GATES["lossless_overhead_lt_pct"]}


def phase_q3(torch, np, out_dir: str, card: str) -> dict:
    """The engine's host sync, two serving processes on cuda:0, then comm_bench.py's gates."""
    t0 = time.perf_counter()
    ranks = _q_spawn("q3", out_dir)
    wall = time.perf_counter() - t0
    engine = _q3_engine(torch, np, _q3_reqs(np))  # one process over all the requests
    try:
        want = {k: _q_to_cpu(torch, v) for k, v in engine.compute_all().items()}
    finally:
        engine.close()
    _check(len(want) == K_TENANTS, f"Q3: {len(want)} tenants in the one-process engine")
    compared = 0
    for r, got in enumerate(ranks):
        _check(list(got["all"]) == list(want), f"Q3 rank {r}: tenants {list(got['all'])}")
        for key in want:
            compared += _q_equal_trees(torch, got["all"][key], want[key], f"Q3 rank {r} {key}")
        compared += _q_equal_trees(torch, got["one"], want["tenant-3"], f"Q3 rank {r} compute(sync=True)")
        _check(not all(torch.equal(got["local"]["tenant-3"][n], want["tenant-3"][n]) for n in want["tenant-3"]),
               f"Q3 rank {r}: the local read already equals the union")
        for rep in got["reports"]:
            _check(rep["site"] == "engine.compute" and rep["degraded_step"] == "none" and not rep["stale"]
                   and rep["world"] == 2, f"Q3 rank {r}: report {rep}")
    rep = ranks[0]["reports"][0]  # the last member's sync of the last tenant
    gates = _q_bench_gates(torch, np)
    return {"card": card, "ranks": 2, "requests": Q3_REQUESTS, "tenants": K_TENANTS, "wall_s": wall,
            "leaves_equal": compared, "compute_all_sync_ms": [g["sync_all_s"] * 1e3 for g in ranks],
            "compute_sync_ms": [g["sync_one_s"] * 1e3 for g in ranks],
            "compute_all_raw_wire_bytes": [g["compute_all_bytes"] for g in ranks],
            "state_bytes_per_tenant": sum(int(v.numel()) * v.element_size() for v in _k_leaves(
                _k2_metric().init_state()).values()),
            "last_report": rep, "comm_bench": gates}


def phase_q4(torch, np, confmat, obs, card: str) -> dict:
    """The ladder on the card: LoopbackWorld(3) threads holding flagship
    collection states on cuda:0 (updated by pair_count), a dead rank, a
    stalled transport, and an engine's comm breaker."""
    import threading
    from dataclasses import replace

    from metrics_tpu_torch import comm
    from metrics_tpu_torch.engine import GuardConfig
    from metrics_tpu_torch.obs import instrument
    from metrics_tpu_torch.obs.flight import FLIGHT

    col = _k2_metric()
    gen = torch.Generator(device="cuda").manual_seed(41)
    confmat.launches = confmat.stat_score_launches = 0
    states = []
    for _ in range(Q4_WORLD):
        s = {n: m.init_state() for n, m in col._modules.items()}
        for _ in range(Q4_BATCHES):
            preds, target = _q_labels(torch, gen, 4096, K2_CLASSES)
            s = {n: m.update_state(s[n], preds, target) for n, m in col._modules.items()}
        states.append(s)
    launches = {"stat_scores": confmat.stat_score_launches, "pair_count": confmat.launches}
    _check(launches == {"stat_scores": 2 * Q4_WORLD * Q4_BATCHES, "pair_count": Q4_WORLD * Q4_BATCHES},
           f"Q4: launches {launches}")

    # one rank dead: the survivors agree on {0, 1} and sync over it
    obs.enable()
    bundles_before = len(FLIGHT.bundles())
    lw = comm.LoopbackWorld(Q4_WORLD, timeout=2.0)
    cfg = comm.CommConfig(timeout_s=10.0, max_retries=0, backoff_base_s=0.01)
    reports = {r: [] for r in range(Q4_WORLD)}
    results = {}

    def rank_fn(r):
        tr = lw.transport(r) if r < 2 else comm.DeadPeerTransport(Q4_WORLD)
        c = replace(cfg, on_report=reports[r].append)
        results[r] = {n: comm.sync_pytree(states[r][n], col._modules[n]._reductions, transport=tr, config=c,
                                          site="q4.dead_peer") for n in states[r]}

    threads = [threading.Thread(target=rank_fn, args=(r,)) for r in range(Q4_WORLD)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
        _check(not th.is_alive(), "Q4: a rank did not finish its sync")
    dead_s = time.perf_counter() - t0
    for r in (0, 1):
        _check(len(results.get(r, {})) == 3, f"Q4: rank {r} did not sync")
        for rep in reports[r]:
            _check(rep.degraded_step == "live_subset" and rep.peers_lost == (2,) and rep.world_live == 2
                   and not rep.stale, f"Q4 rank {r}: {rep}")
        for n in states[r]:
            union = {k: states[0][n][k] + states[1][n][k] for k in states[0][n]}
            _q_equal_trees(torch, results[r][n], union, f"Q4 rank {r} {n}: live_subset against the survivors' union")
            _check(all(v.is_cuda for v in results[r][n].values()), f"Q4 rank {r} {n}: a synced leaf left the card")
    _check(all(rep.degraded_step == "local_state" and rep.stale for rep in reports[2]), "Q4: the dead rank's reports")
    shrink = [b for b in FLIGHT.bundles()[bundles_before:] if b["trigger"] == "live_set_shrink"]
    _check(len(shrink) >= 2 and all(b["trigger_attrs"]["lost"] == [2] for b in shrink),
           f"Q4: live_set_shrink bundles {[b['trigger'] for b in FLIGHT.bundles()[bundles_before:]]}")

    # a stalled transport under a deadline: retries, then lossless_only, then local state, stale
    ladder_state = dict(states[0]["confmat"])
    ladder_state["scores"] = [torch.randn(Q4_CAT, device="cuda", generator=gen)]
    ladder_reds = {"confmat": "sum", "scores": "cat"}
    ladder = []
    stall = comm.StallTransport(comm.ReplicaFakeTransport(2), stall_s=0.3, stalls=100)
    ladder_cfg = comm.CommConfig(policy=comm.CodecPolicy(lossy="int8"), timeout_s=0.05, max_retries=1,
                                 backoff_base_s=0.001, on_report=ladder.append)
    out = comm.sync_pytree(ladder_state, ladder_reds, transport=stall, config=ladder_cfg, site="q4.stall")
    rep = ladder[-1]
    steps = {step: int(instrument.COMM_DEGRADATIONS.value(site="q4.stall", step=step))
             for step in ("lossless_only", "local_state")}
    _check(rep.degraded_step == "local_state" and rep.stale and rep.retries == 2 and rep.timeouts == 4
           and steps == {"lossless_only": 1, "local_state": 1}, f"Q4 stall: {rep} {steps}")
    _check(out["confmat"] is ladder_state["confmat"], "Q4 stall: local state not served")

    # an engine whose syncs keep going stale: its comm breaker opens and pins sync
    engine = _q4_engine(torch, np, GuardConfig())
    try:
        with comm.use_config(transport=comm.DeadPeerTransport(2), max_retries=0):
            for _ in range(5):
                engine.compute("tenant-0", sync=True)
        snap, health = engine.telemetry_snapshot(), engine.health()
    finally:
        engine.close()
    obs.disable()
    _check(snap["sync_pinned"] > 0 and health["breakers"]["comm"]["state"] == "open" and health["state"] == "DEGRADED",
           f"Q4 breaker: pinned {snap['sync_pinned']}, health {health['state']} {health['breakers']['comm']}")
    return {"card": card, "world": Q4_WORLD, "launches": launches, "dead_peer_s": dead_s,
            "dead_peer_reports": [{k: getattr(x, k) for k in ("degraded_step", "peers_lost", "world_live",
                                                              "raw_bytes", "wire_bytes")} for x in reports[0]],
            "live_set_shrink_bundles": len(shrink),
            "stall": {"degraded_step": rep.degraded_step, "stale": rep.stale, "retries": rep.retries,
                      "timeouts": rep.timeouts, "rungs": steps},
            "breaker": {"sync_pinned": snap["sync_pinned"], "comm": health["breakers"]["comm"],
                        "health": health["state"]}}


def _q4_engine(torch, np, guard):
    from metrics_tpu_torch.engine import StreamingEngine

    rng = np.random.default_rng(8)
    engine = StreamingEngine(_k2_metric(), buckets=(64,), capacity=K_TENANTS, guard=guard)
    for _ in range(4):
        engine.submit("tenant-0", rng.integers(0, K2_CLASSES, 16), rng.integers(0, K2_CLASSES, 16))
    engine.flush(timeout=300)
    return engine


def phase_q(torch, np, entry_mod, confmat, obs, card: str) -> dict:
    """The comm plane on the card (Q1 to Q4)."""
    import tempfile

    from metrics_tpu_torch import comm

    t0 = time.perf_counter()
    out = {"Q1": phase_q1(torch, entry_mod, confmat, card)}
    print(f"phase Q1 {json.dumps(out['Q1'])}")
    with tempfile.TemporaryDirectory() as d:
        out["Q2"] = phase_q2(torch, entry_mod, d, card)
        print(f"phase Q2 {json.dumps(out['Q2'])}")
        out["Q3"] = phase_q3(torch, np, d, card)
        print(f"phase Q3 {json.dumps(out['Q3'])}")
    _check(comm.last_report().degraded_step == "none", f"Q: a degraded sync before Q4: {comm.last_report()}")
    out["Q4"] = phase_q4(torch, np, confmat, obs, card)
    print(f"phase Q4 {json.dumps(out['Q4'])}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase Q: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------- Phase R: the shard plane

R_REQUESTS = 8000  # benchmarks/engine_throughput.py --shard (:903-1000): seed 3, 32 tenants, 4 threads
R_SEED = 3
R_TENANTS = 32
R_SHARDS = 8
R_PAIRS = 1  # alternating pairs of each comparison (6 there)
R_SPEEDUP_FLOOR = 4.0  # its --shard-speedup-floor: a record here (8 dispatchers share one card and one interpreter)
R_GATE_PCT = 5.0  # its shard1_overhead_lt_5pct: a record here, as M1's
R_K2_REQUESTS = 256  # K2-style flagship requests over the 8 shards
R_K2_BUCKETS = (64,)
R_K2_CAPACITY = 16
R_RESIZE_REQUESTS = 250  # the first requests of the mix, served by the checkpointed shards of R3 and R5 (cut)
R_RESIZE_TO = 16


def _r_stream(np, n: int = R_REQUESTS):
    """The --shard mix: 4 heavy tenants with 64-row requests, 8 mid tenants with
    8-row requests, 20 light tenants batch-1; int64 preds and targets in {0, 1}."""
    rng = np.random.default_rng(R_SEED)
    out = []
    for _ in range(n):
        idx = int(rng.integers(0, R_TENANTS))
        rows = 64 if idx < 4 else (8 if idx < 12 else 1)
        out.append((f"tenant-{idx}", (rng.integers(0, 2, rows), rng.integers(0, 2, rows))))
    return out


def _r_warm(engine, np, tenants: int = R_TENANTS, buckets=K_BUCKETS) -> None:
    """The benchmark's warm-up: every tenant touched, then one request of each
    rung's rows a tenant, each answered before the next (so no drain coalesces
    a rung away: every shard captures every bucket), then a reset in place."""
    rng = np.random.default_rng(13)
    for k in range(tenants):
        engine.submit(f"tenant-{k}", np.ones(1, np.int64), np.ones(1, np.int64)).result(timeout=300)
    for rows in buckets:
        for k in range(tenants):
            engine.submit(f"tenant-{k}", rng.integers(0, 2, rows), rng.integers(0, 2, rows)).result(timeout=300)
    engine.flush(timeout=300)
    engine.reset()


def _r_pass(torch, np, reqs, shards) -> float:
    """One warmed, timed pass of the mix: ``shards=None`` is the bare engine."""
    from metrics_tpu_torch.classification import BinaryAccuracy
    from metrics_tpu_torch.engine import StreamingEngine
    from metrics_tpu_torch.shard import ShardConfig, ShardedEngine

    kw = dict(buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=R_TENANTS)
    engine = (StreamingEngine(BinaryAccuracy(device="cuda"), **kw) if shards is None
              else ShardedEngine(BinaryAccuracy(device="cuda"), config=ShardConfig(shards=shards), **kw))
    try:
        _r_warm(engine, np)
        seconds = _k_submit(engine, reqs, K_THREADS)
        snap = engine.telemetry_snapshot()
        _check(snap["processed"] == len(reqs) + R_TENANTS * (1 + len(K_BUCKETS)) and snap["failed"] == 0,
               f"R: shards={shards}: {snap['processed']} processed, {snap['failed']} failed")
        return len(reqs) / seconds
    finally:
        engine.close()


def _r_pairs(torch, np, reqs, a, b) -> dict:
    """R_PAIRS alternating pairs of passes ``a`` and ``b`` (shard counts, None =
    the bare engine); the median pair ratio a / b."""
    import statistics

    got = {a: [], b: []}
    for i in range(R_PAIRS):
        for side in ((a, b) if i % 2 == 0 else (b, a)):
            got[side].append(_r_pass(torch, np, reqs, side))
    ratios = [x / y for x, y in zip(got[a], got[b])]
    return {"median_ratio": statistics.median(ratios), "pair_ratios": ratios,
            "req_per_s": {str(a): got[a], str(b): got[b]},
            "best_req_per_s": {str(a): max(got[a]), str(b): max(got[b])}}


def _r_equal(torch, got: dict, want: dict, what: str) -> int:
    compared = 0
    for key, state in want.items():
        _check(key in got, f"{what}: {key} missing")
        a, b = _k_leaves(got[key]), _k_leaves(state)
        _check(set(a) == set(b), f"{what} {key}: leaves {sorted(a)} vs {sorted(b)}")
        for path, x in a.items():
            _check(x.dtype == b[path].dtype and torch.equal(x, b[path]), f"{what} {key}: {path} differs")
            compared += 1
    return compared


def phase_r_k2(torch, np) -> dict:
    """K2's flagship collection (C = 1000) over 8 shards, each with the guard's
    watchdog: the eight dispatchers capture at once, with no takeover and no
    fallback (each capture counted against the timeout times the captures in
    flight beside it); per-tenant states equal
    to the fold; the hand kernels' launches in the shards' replays against the
    profiler's count."""
    import threading

    from metrics_tpu_torch.engine import GuardConfig
    from metrics_tpu_torch.shard import ShardConfig, ShardedEngine

    kernels = ("stat_scores", "pair_count")
    rng = np.random.default_rng(5)

    def labels(rows):
        return rng.integers(0, K2_CLASSES, rows).astype(np.int64), rng.integers(0, K2_CLASSES, rows).astype(np.int64)

    def draw(n):
        return [(f"tenant-{int(rng.integers(0, R_TENANTS))}", labels(int(rng.integers(K2_ROWS[0], K2_ROWS[1] + 1))))
                for _ in range(n)]

    reqs, profile_reqs = draw(R_K2_REQUESTS), draw(K_PROFILED // 4)
    sharded = ShardedEngine(_k2_metric(), config=ShardConfig(shards=R_SHARDS), buckets=R_K2_BUCKETS, max_queue=K_QUEUE,
                            capacity=R_K2_CAPACITY, guard=GuardConfig(shed=False, **N3_WATCHDOG))
    try:
        # one tenant a shard, its 64-row request submitted from its own thread, all at once
        firsts = {}
        for k in range(R_TENANTS):
            firsts.setdefault(sharded.shard_of(f"tenant-{k}"), f"tenant-{k}")
        futures = []
        threads = [threading.Thread(target=lambda key=key: futures.append(sharded.submit(key, *labels(64))))
                   for key in firsts.values()]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        for fut in futures:
            _check(fut.exception(timeout=300) is None, f"R K2: a capturing request failed: {fut.exception()!r}")
        capture_wall_s = time.perf_counter() - t0
        captures = [g["warmup_ms"] + g["capture_ms"] for e in sharded.engines for g in e.graph_stats()]
        snap = sharded.telemetry_snapshot()
        _check(len(captures) == len(firsts) and snap["watchdog_restarts"] == 0 and snap["fused_fallbacks"] == 0,
               f"R K2: {len(captures)} graphs for {len(firsts)} shards, {snap['watchdog_restarts']} watchdog restarts")
        # a capture past the timeout beside 7 others is no hang: its deadline is stretched 8 times
        _check(sharded.health()["state"] == "SERVING", f"R K2: {sharded.health()['state']} after the captures")
        sharded.reset()
        seconds = _k_submit(sharded, reqs, K_THREADS)
        folds, rows = _k_fold(torch, _k2_metric(), reqs, "cuda")
        compared = 0
        for index, engine in enumerate(sharded.engines):
            mine = {k: v for k, v in folds.items() if sharded.shard_of(k) == index}
            compared += _k_check_states(torch, engine, mine, rows, f"R K2 shard {index}")
        prof = _replays_profiled(torch, sharded.engines, lambda: _k_submit(sharded, profile_reqs, K_THREADS), kernels,
                           T_PER_ROW, "R K2")
        graph_launches = _replay_launches(sharded.engines, kernels)
    finally:
        sharded.close()
    return {
        "requests": len(reqs), "req_per_s": len(reqs) / seconds, "shards_with_tenants": len(firsts),
        "concurrent_capture_ms": captures, "concurrent_capture_wall_s": capture_wall_s,
        "watchdog_timeout_s": N3_WATCHDOG["watchdog_timeout_s"],
        "captures_past_the_timeout": sum(ms > N3_WATCHDOG["watchdog_timeout_s"] * 1e3 for ms in captures),
        "state_leaves_equal": compared, "launches_all_replays": graph_launches,
        "launches_in_replays": prof["launches_in_replays"], "launches_profiled": prof["launches_profiled"],
        "profile_attempts": prof["profile_attempts"], "profiled_wall_s": prof["wall_s"],
        "profiled_idle_share": prof["idle_share"],
    }


def phase_r_resize(torch, np, root: str) -> tuple:
    """Per-tenant results over 8 checkpointed shards against a one-engine fold
    (R3), then a ``resize(8 -> 16)``: the migrated tenants bit-identical, the
    manifest at 16, and a restart recovers every tenant on its ring shard (R5)."""
    from metrics_tpu_torch.classification import BinaryAccuracy
    from metrics_tpu_torch.engine import CheckpointConfig
    from metrics_tpu_torch.shard import HashRing, ShardConfig, ShardedEngine

    reqs = _r_stream(np, R_RESIZE_REQUESTS)
    ck = CheckpointConfig(directory=os.path.join(root, "shards"), interval_s=3600.0)
    kw = dict(buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=R_TENANTS, checkpoint=ck)
    t0 = time.perf_counter()
    sharded = ShardedEngine(BinaryAccuracy(device="cuda"), config=ShardConfig(shards=R_SHARDS), **kw)
    build_s = time.perf_counter() - t0
    try:
        submit_s = _k_submit(sharded, reqs, K_THREADS)
        snap = sharded.telemetry_snapshot()
        _check(snap["processed"] == len(reqs) and snap["fused_fallbacks"] == 0,
               f"R3: {snap['processed']} processed for {len(reqs)} requests, {snap['fused_fallbacks']} fallbacks")
        folds, rows = _k_fold(torch, BinaryAccuracy(device="cuda"), reqs, "cuda")
        old, compared, per_shard = HashRing(R_SHARDS), 0, []
        for index, engine in enumerate(sharded.engines):
            mine = {k: v for k, v in folds.items() if old.shard_for(k) == index}
            _check(set(engine._keyed.keys) == set(mine), f"R3: shard {index} holds {engine._keyed.keys}")
            compared += _k_check_states(torch, engine, mine, rows, f"R3 shard {index}")
            per_shard.append(len(mine))
        metric = BinaryAccuracy(device="cuda")
        for key, fold in folds.items():
            _check(torch.equal(sharded.compute(key), metric.compute_from(fold)), f"R3: compute({key!r}) differs from the fold's")
        per_tenant = {"requests": len(reqs), "tenants": len(folds), "state_leaves_equal": compared,
                      "tenants_per_shard": per_shard, "req_per_s": len(reqs) / submit_s,
                      "captures": snap["compiles"], "fused_fallbacks": snap["fused_fallbacks"]}
        before = {k: v for e in sharded.engines for k, v in _p_states(e).items()}
        t0 = time.perf_counter()
        moved = sharded.resize(R_RESIZE_TO)
        resize_s = time.perf_counter() - t0
        new = HashRing(R_RESIZE_TO)
        _check(moved == {k: (old.shard_for(k), new.shard_for(k)) for k in before
                         if old.shard_for(k) != new.shard_for(k)}, f"R resize: moved {moved}")
        _check(all(dst >= R_SHARDS for _, dst in moved.values()), "R resize: a tenant moved between old shards")
        after = {}
        for index, engine in enumerate(sharded.engines):
            states = _p_states(engine)
            _check(all(new.shard_for(k) == index for k in states), f"R resize: shard {index} holds {list(states)}")
            after.update(states)
        migrated = _r_equal(torch, {k: after[k] for k in moved}, {k: before[k] for k in moved}, "R resize: migrated")
        kept = _r_equal(torch, after, before, "R resize")
        with open(os.path.join(ck.directory, "shard_manifest.json")) as fh:
            manifest = json.load(fh)
        _check(manifest["shards"] == R_RESIZE_TO, f"R resize: the manifest records {manifest}")
    finally:
        t0 = time.perf_counter()
        sharded.close()
        close_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restarted = ShardedEngine(BinaryAccuracy(device="cuda"), config=ShardConfig(shards=R_RESIZE_TO), **kw)
    try:
        restart_s = time.perf_counter() - t0
        recovered = {}
        for index, engine in enumerate(restarted.engines):
            states = _p_states(engine)
            _check(all(new.shard_for(k) == index for k in states), f"R restart: shard {index} holds {list(states)}")
            recovered.update(states)
        _check(set(recovered) == set(before), f"R restart: {len(recovered)} tenants of {len(before)}")
        _r_equal(torch, recovered, before, "R restart")
        recoveries = sum(e.telemetry_snapshot()["recoveries"] for e in restarted.engines)
    finally:
        restarted.close()
    return per_tenant, {"tenants": len(before), "moved": len(moved), "moved_leaves_equal": migrated,
                        "leaves_equal": kept, "resize_s": resize_s, "manifest": manifest, "restart_s": restart_s,
                        "shard_recoveries": recoveries, "build_s": build_s, "submit_s": submit_s, "close_s": close_s}


def phase_r(torch, np) -> dict:
    """The shard plane on the card: the --shard mix, 8 shards against 1 and 1
    against the bare engine, per-tenant results, the flagship over 8 shards,
    and a checkpointed resize."""
    import tempfile

    t0 = time.perf_counter()
    reqs = _r_stream(np)
    out = {"config": {"metric": "BinaryAccuracy", "requests": len(reqs), "tenants": R_TENANTS, "threads": K_THREADS,
                      "buckets": list(K_BUCKETS), "capacity": R_TENANTS, "pairs": R_PAIRS,
                      "rows": sum(a[0].shape[0] for _, a in reqs)}}
    scale = _r_pairs(torch, np, reqs, R_SHARDS, 1)
    out["R1_eight_vs_one"] = {**scale, "jax_floor_x": R_SPEEDUP_FLOOR, "meets_jax_floor": scale["median_ratio"] >= R_SPEEDUP_FLOOR}
    print(f"phase R1 {json.dumps(out['R1_eight_vs_one'])}")
    over = _r_pairs(torch, np, reqs, None, 1)
    overhead_pct = (over["median_ratio"] - 1.0) * 100.0
    out["R2_one_shard_overhead"] = {**over, "overhead_pct": overhead_pct, "gate_pct": R_GATE_PCT,
                                    "within_gate": overhead_pct < R_GATE_PCT}
    print(f"phase R2 {json.dumps(out['R2_one_shard_overhead'])}")
    with tempfile.TemporaryDirectory() as d:
        out["R3_per_tenant"], out["R5_resize"] = phase_r_resize(torch, np, d)
    print(f"phase R3 {json.dumps(out['R3_per_tenant'])}")
    print(f"phase R5 {json.dumps(out['R5_resize'])}")
    out["R4_flagship"] = phase_r_k2(torch, np)
    print(f"phase R4 {json.dumps(out['R4_flagship'])}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase R: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------- Phase S: the query plane

T_TENANTS = 8
T_ROWS = 64  # rows a request: one 64-row graph replay each
T_BUCKETS = (64,)
T_BEFORE = 48  # client writes acknowledged before the leader dies (cut)
T_AFTER = 48  # and after the failover (cut)
T_PROFILED = 24  # client writes in a profiled window
# benchmarks/engine_throughput.py --cluster's cadence (:700-706), seeded per node
T_CADENCE = dict(lease_ttl_s=1.0, heartbeat_interval_s=0.2, suspect_after_s=0.8, confirm_after_s=2.5,
                 tick_interval_s=0.05)
T_CLIENT = dict(retries=40, backoff_s=0.02, backoff_cap_s=0.25)  # a failover outlasts the default budget of 8
T_PAIRS = 1  # --cluster's supervision pairs (:679-745; 6 there)
T_GATE_PCT = 5.0  # its cluster_overhead_lt_5pct, and --part's part1_overhead_lt_5pct: records here, as M1's
T_WAIT_S = 120.0
T_PER_ROW = {"stat_scores": 2, "pair_count": 1}
U_PARTITIONS = 4
U_TENANTS_PER_PARTITION = 4
U_BEFORE = 64
U_AFTER = 48
U_SIBLING = 48  # writes to p0's other tenants while one of them migrates
U4_PARTITIONS, U4_HOSTS = 8, 4  # --part's scaling gate (:1400-1460)
U4_REQUESTS = 8000
U4_PAIRS = 1  # its alternating pairs (4 there)
U4_FLOOR = 3.2  # its --part-scale-floor: a record here (the hosts share one card)
U4_READY_S = 120.0


def _t_labels(np, rng):
    return rng.integers(0, K2_CLASSES, T_ROWS).astype(np.int64), rng.integers(0, K2_CLASSES, T_ROWS).astype(np.int64)


def _t_reqs(np, seed: int, n: int, keys):
    """``n`` 64-row flagship requests: every tenant of ``keys`` once, in order,
    then tenants drawn at random."""
    rng = np.random.default_rng(seed)
    return [(keys[i] if i < len(keys) else keys[int(rng.integers(0, len(keys)))], _t_labels(np, rng))
            for i in range(n)]


def _t_writable(engine) -> bool:
    """Accepts writes: neither a follower nor closed."""
    return not engine._repl_follower and not engine._closed


class _WriterPoll:
    """A thread that samples, every millisecond, how many engines of each group
    (a lineage, a partition) accept writes; the most seen at once, and the
    longest gap between two of its samples (how long the interpreter kept it
    waiting: a supervisor thread waits as long)."""

    def __init__(self, groups) -> None:
        import threading

        self._groups = groups
        self.most = dict.fromkeys(groups, 0)
        self.samples = 0
        self.max_gap_s = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="writer-poll", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        last = time.perf_counter()
        while not self._stop.wait(0.001):
            for name, engines in self._groups.items():
                self.most[name] = max(self.most[name], sum(_t_writable(e) for e in engines()))
            self.samples += 1
            now = time.perf_counter()
            self.max_gap_s, last = max(self.max_gap_s, now - last), now

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(10)
        return {"most_writable_at_once": dict(self.most), "samples": self.samples, "max_sample_gap_s": self.max_gap_s}


def _t_write(submit, reqs, acked: list, lock=None) -> None:
    """Each request through ``submit`` (a router's, or an engine's), its receipt
    awaited; the acknowledged ones appended to ``acked`` in order, each with
    whether the engine applied it inline (receipt bucket None: no dispatcher
    yet, as in the instant between a promotion's role flip and its dispatcher's
    start, one ``update_state`` of the whole request, which counts one update)."""
    for key, args in reqs:
        receipt = submit(key, *args).result(timeout=T_WAIT_S)
        item = (key, args, receipt["bucket"] is None)
        if lock is None:
            acked.append(item)
        else:
            with lock:
                acked.append(item)


def _t_fold(torch, acked):
    """The CPU fold of every acknowledged request, and the ``_update_count`` each
    tenant's state must show: its rows, or one for a request applied inline."""
    folds, _rows = _k_fold(torch, _k2_metric("cpu"), [(key, args) for key, args, _inline in acked], "cpu")
    counts = {}
    for key, args, inline in acked:
        counts[key] = counts.get(key, 0) + (1 if inline else args[0].shape[0])
    return folds, counts


def _t_caught_up(engines, leader: str, followers, what: str) -> float:
    target = engines[leader]._wal_seq
    return _wait_for(lambda: all(engines[f]._applier is not None and engines[f]._applier.bootstrapped
                                 and engines[f]._applier.applied_seq >= target for f in followers),
                     f"{what}: the followers caught up to seq {target}", timeout=T_WAIT_S)


def _replay_launches(engines, kernels) -> dict:
    out = dict.fromkeys(kernels, 0)
    for engine in engines:
        for name, n in engine.graph_launches().items():
            if name in out:
                out[name] += n
    return out


def _replays_profiled(torch, engines, run, kernels, per_row: dict, what: str) -> dict:
    """The hand kernels' launches in the engines' replays (captured x replays)
    against the profiler's count over one window of ``run`` (client writes and
    the followers' replays of them); profiled again, up to 3 times, until an
    attempt's deficit is under one replay's launches of each kernel. As in P3 and R4, the profiler may lose a few records at this
    launch rate: a lost replay would take a whole 64-row graph's launches of a
    kernel at once."""
    from torch.profiler import ProfilerActivity, profile

    attempts = []
    for _ in range(3):
        before = _replay_launches(engines, kernels)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _profiler_lead_in(torch)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        after = _replay_launches(engines, kernels)
        expected = {k: after[k] - before[k] for k in kernels}
        times = _kernel_times(prof, torch)
        seen = {k: sum(len(v) for n, v in times.items() if K_PROFILE_NAMES[k][0] in n) // K_PROFILE_NAMES[k][1]
                for k in kernels}
        attempts.append({"profiled": seen, "in_replays": expected})
        # an attempt within the rule below ends the retries: a later one may lose more records
        if not times or all(0 <= expected[k] - seen[k] < per_row[k] * T_BUCKETS[0] for k in kernels):
            break
    for k in kernels:
        _check(expected[k] > 0, f"{what}: {k} was never launched in a replay ({expected})")
        _check(not times or 0 <= expected[k] - seen[k] < per_row[k] * T_BUCKETS[0],
               f"{what}: profiled launches against captured x replays, each attempt: {attempts}")
    busy_us = sum(sum(v) for v in times.values())
    return {"launches_in_replays": expected, "launches_profiled": seen, "profile_attempts": attempts,
            "wall_s": wall_s, "idle_share": 1.0 - busy_us / (wall_s * 1e6) if times else None}


def phase_t1(torch, np, root: str) -> dict:
    """The JAX tests' three-node cluster at full width, live: 'a' a checkpointed
    primary shipping through a FanoutTransport of LoopbackLinks, 'b' and 'c'
    followers with promote_checkpoint, each supervised by a ClusterNode thread
    at the --cluster cadence over a DirectoryCoordStore. Writes go through a
    ClusterClient; 'a' dies (its node stops without releasing, its engine
    closes); a follower wins the lease at a higher epoch and promotes at it;
    writes go on; a's last epoch-1 shipment, delivered again, is refused at
    both links; 'a' is recovered from its directory, steps down and its node
    attaches it to the new leader. The states against a CPU fold of every
    acknowledged write; then, with the supervisors stopped (the profiler's
    teardown holds the interpreter past half a lease), the launches in the
    three engines' replays against the profiler."""
    import threading

    from metrics_tpu_torch.cluster import ClusterClient, ClusterConfig, ClusterNode, DirectoryCoordStore
    from metrics_tpu_torch.engine import CheckpointConfig, ReplConfig, StreamingEngine
    from metrics_tpu_torch.repl import FanoutTransport, FencedError, LoopbackLink

    names = ("a", "b", "c")
    links = {}

    def link(src, dst):
        return links.setdefault((src, dst), LoopbackLink())

    def ckpt(name):
        return CheckpointConfig(directory=os.path.join(root, name), interval_s=3600.0, retain=M_RETAIN,
                                wal_flush="fsync")

    def primary_cfg():
        return ReplConfig(role="primary", transport=FanoutTransport([link("a", "b"), link("a", "c")]),
                          ship_interval_s=0.01, heartbeat_interval_s=0.05, epoch=1)

    def node_for(name):
        return ClusterNode(engines[name], ClusterConfig(
            node_id=name, peers=tuple(n for n in names if n != name), store=store, link_factory=link,
            rng_seed=ord(name), **T_CADENCE))

    kw = dict(buckets=T_BUCKETS, max_queue=K_QUEUE, capacity=T_TENANTS)
    keys = [f"tenant-{k}" for k in range(T_TENANTS)]
    store = DirectoryCoordStore(os.path.join(root, "coord"))
    engines = {"a": StreamingEngine(_k2_metric(), checkpoint=ckpt("a"), replication=primary_cfg(), **kw)}
    for name in ("b", "c"):
        engines[name] = StreamingEngine(_k2_metric(), replication=ReplConfig(
            role="follower", transport=link("a", name), poll_interval_s=0.005, promote_checkpoint=ckpt(name)), **kw)
    shipped = []  # a's last WAL frame, kept to be delivered again after the failover
    fan = engines["a"]._repl_cfg.transport
    send = fan.send

    def recording_send(frames):
        send(frames)
        wal = [f for f in frames if type(f).__name__ == "WalFrame"]
        if wal:
            shipped[:] = wal[-1:]

    fan.send = recording_send
    # deterministic formation: 'a' holds epoch 1 before any node ticks
    _check(store.acquire_lease("a", T_CADENCE["lease_ttl_s"]) is not None, "T1: the first lease")
    nodes, poll, acked = {}, None, []
    reqs = _t_reqs(np, 31, T_BEFORE + T_AFTER + T_PROFILED, keys)
    before, after, profiled = reqs[:T_BEFORE], reqs[T_BEFORE:T_BEFORE + T_AFTER], reqs[T_BEFORE + T_AFTER:]
    lineage = dict(engines)  # the engines the sampler watches: a's recovered engine joins once it stepped down
    try:
        poll = _WriterPoll({"lineage": lambda: list(lineage.values())})
        nodes = {name: node_for(name) for name in names}
        form_s = _wait_for(lambda: all(nodes[n]._following == "a" for n in ("b", "c")), "T1: b and c follow a",
                           timeout=T_WAIT_S)
        client = ClusterClient(store, dict(engines), rng_seed=7, **T_CLIENT)
        t0 = time.perf_counter()
        _t_write(client.submit, before, acked)
        before_s = time.perf_counter() - t0
        _t_caught_up(engines, "a", ("b", "c"), "T1 before")
        epoch_before = store.read_lease().epoch
        # 'a' dies: its node stops without releasing the lease, its engine closes (no final snapshot)
        promoted = {}
        t_dead = time.perf_counter()

        def watch():
            while not promoted and time.perf_counter() - t_dead < T_WAIT_S:
                for n in ("b", "c"):
                    if _t_writable(engines[n]):
                        promoted[n] = time.perf_counter() - t_dead
                time.sleep(0.001)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        nodes["a"].close(release=False)
        engines["a"].close(checkpoint=False)
        _t_write(client.submit, after[:1], acked)
        first_ack_s = time.perf_counter() - t_dead
        watcher.join(T_WAIT_S)
        lease = store.read_lease()
        leader = lease.holder
        loser = "c" if leader == "b" else "b"
        _t_write(client.submit, after[1:], acked)
        _t_caught_up(engines, leader, (loser,), "T1 after")
        _check(leader in ("b", "c") and lease.epoch > epoch_before and engines[leader]._repl_epoch == lease.epoch
               and nodes[leader].failovers == 1 and nodes[loser]._following == leader,
               f"T1: lease {lease} after epoch {epoch_before}, epochs {[engines[n]._repl_epoch for n in names]}, "
               f"failovers {[nodes[n].failovers for n in names]}, {loser} follows {nodes[loser]._following}")
        # a's last shipment at epoch 1, delivered late: both of its links refuse it at the fence
        refused = 0
        for dst in ("b", "c"):
            try:
                link("a", dst).send(shipped)
            except FencedError:
                refused += 1
        _check(len(shipped) == 1 and shipped[0].epoch == epoch_before and refused == 2,
               f"T1: a's late epoch-{epoch_before} shipment refused at {refused} of 2 links")
        # 'a' recovered from its directory (no dispatcher started), its states equal to the
        # fold of what it acknowledged; it steps down, and its node attaches it to the new
        # leader, where it bootstraps into the new lineage
        t1 = time.perf_counter()
        engines["a"] = StreamingEngine(_k2_metric(), checkpoint=ckpt("a"), replication=primary_cfg(), start=False,
                                       **kw)
        recovered_s = time.perf_counter() - t1
        folds, counts = _t_fold(torch, acked[:T_BEFORE])
        recovered = _k_check_states(torch, None, folds, counts, "T1 a recovered", states=_p_states(engines["a"]))
        recovered_epoch = int(engines["a"]._repl_epoch)
        engines["a"].demote(None)
        lineage["a"] = engines["a"]
        nodes["a"] = node_for("a")
        rejoin_s = _wait_for(lambda: nodes["a"]._following == leader and engines["a"]._applier is not None,
                             "T1: a rejoins as a follower", timeout=T_WAIT_S)
        _t_caught_up(engines, leader, ("a", loser), "T1 rejoin")
        final = store.read_lease()
        cluster = {"lease": {"holder": final.holder, "epoch": final.epoch},
                   "failovers": {n: nodes[n].failovers for n in names},
                   "suspicions": {n: nodes[n].suspicions for n in names},
                   "lease_renewals": {n: nodes[n].lease_renewals for n in names},
                   "health": {n: engines[n].health()["cluster"] for n in names}}
        _check(final.holder == leader and final.epoch == lease.epoch,
               f"T1: the lease moved again after the failover: {final} after {lease}")
        for node in nodes.values():
            node.close(release=False)
        nodes = {}
        # with the supervisors stopped: a profiled window of writes on the leader and the
        # two followers' replays of them
        prof = _replays_profiled(torch, [engines[n] for n in names],
                           lambda: (_t_write(engines[leader].submit, profiled, acked),
                                    _t_caught_up(engines, leader, ("a", loser), "T1 profiled")),
                           ("stat_scores", "pair_count"), T_PER_ROW, "T1")
        folds, counts = _t_fold(torch, acked)
        leaves = {n: _k_check_states(torch, None, folds, counts, f"T1 {n}", states=_p_states(engines[n]))
                  for n in names}
        launches = _replay_launches([engines[n] for n in names], ("stat_scores", "pair_count"))
        polled = poll.stop()
        _check(polled["most_writable_at_once"]["lineage"] == 1,
               f"T1: engines that accepted writes at once: {polled}")
        out = {
            "leader": leader, "epoch_before": epoch_before, "lease_epoch": lease.epoch, "acknowledged": len(acked),
            "applied_inline": sum(inline for _k, _a, inline in acked), "form_s": form_s,
            "before_req_per_s": len(before) / before_s, "death_to_first_ack_s": first_ack_s,
            "death_to_promotion_s": promoted.get(leader), "redirects": client.redirects,
            "late_shipment_refused_links": refused, "a_recovered_ms": recovered_s * 1e3,
            "a_recovered_leaves_equal": recovered, "a_recovered_epoch": recovered_epoch, "a_rejoin_s": rejoin_s,
            "state_leaves_equal": leaves, "launches_all_replays": launches, **cluster, **prof, **polled,
        }
    finally:
        if poll is not None:
            poll.stop()
        for node in nodes.values():
            node.close(release=False)
        for engine in engines.values():
            engine.close(checkpoint=False)
    return out


def _t_supervisor(kind):
    """``None``, or a function attaching a ClusterNode or a partitions=1
    PartitionedNode at the --cluster cadence over a FakeCoordStore on the live
    clock (the --cluster and --part gates' supervisors)."""
    from metrics_tpu_torch.cluster import ClusterConfig, ClusterNode, FakeCoordStore
    from metrics_tpu_torch.part import PartConfig, PartitionedNode

    if kind == "cluster":
        return lambda engine: ClusterNode(engine, ClusterConfig(
            node_id="bench-a", peers=("bench-b",), store=FakeCoordStore(), rng_seed=0, **T_CADENCE))
    if kind == "part":
        return lambda engine: PartitionedNode({0: engine}, PartConfig(
            node_id="bench-a", peers=("bench-b",), store=FakeCoordStore(), partitions=1, rng_seed=0, **T_CADENCE))
    return None


def _t_pairs(torch, np, a, b, pairs: int = T_PAIRS) -> dict:
    """``pairs`` alternating pairs of P1's shipping K6 passes (the --cluster
    gate's pass) supervised by ``a`` and by ``b`` (``"none"``, ``"cluster"``,
    ``"part"``); the median pair ratio a / b less one, in %."""
    import statistics
    import tempfile

    from metrics_tpu_torch.classification import BinaryAccuracy

    reqs = _k6_reqs(np, K1_REQUESTS, K_TENANTS)
    folds, rows = _k_fold(torch, BinaryAccuracy(device="cuda"), reqs, "cuda")
    got = {a: [], b: []}
    for i in range(pairs):
        for side in ((a, b) if i % 2 == 0 else (b, a)):
            with tempfile.TemporaryDirectory() as d:
                got[side].append(_p1_pass(torch, np, reqs, folds, rows, d, True, _t_supervisor(side)))
    ratios = [x["req_per_s"] / y["req_per_s"] for x, y in zip(got[a], got[b])]
    overhead_pct = (statistics.median(ratios) - 1.0) * 100.0
    return {"overhead_pct": overhead_pct, "gate_pct": T_GATE_PCT, "within_gate": overhead_pct < T_GATE_PCT,
            "pair_ratios": ratios, f"{a}_req_per_s": [r["req_per_s"] for r in got[a]],
            f"{b}_req_per_s": [r["req_per_s"] for r in got[b]],
            "lease_renewals": [r.get("lease_renewals") for r in got[a] + got[b]],
            "lease_epochs": [r.get("lease_epoch") for r in got[a] + got[b]], "requests": len(reqs)}


def phase_t(torch, np) -> dict:
    """The cluster plane on the card: a live failover (T1) and the supervision
    overhead (T2)."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = {"T1": phase_t1(torch, np, d)}
    out["T1"]["seconds"] = time.perf_counter() - t0
    print(f"phase T1 {json.dumps(out['T1'])}")
    out["T2"] = _t_pairs(torch, np, "none", "cluster")
    print(f"phase T2 {json.dumps(out['T2'])}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase T: {out['seconds']:.1f} s")
    return out


def phase_u12(torch, np, root: str) -> dict:
    """2 hosts x 4 partitions of the flagship collection on one card over one
    FakeCoordStore on the live clock: 'a' leads p0 and p1 and follows p2 and
    p3, 'b' the reverse, each a PartitionedNode thread at the --cluster
    cadence; a PartitionedClient routes 16 tenants' writes. 'b' dies: p2 and
    p3 fail over to 'a' each on its own lease while p0 and p1 keep their
    epochs (U1). One tenant migrates from p0 to p2 while a thread writes p0's
    other tenants (U2). Then, the supervisors stopped, a profiled window of
    writes on a's four engines, the states against the fold, and p2's leader
    restarts from its directory."""
    import threading

    from metrics_tpu_torch.cluster import FakeCoordStore
    from metrics_tpu_torch.engine import CheckpointConfig, GuardConfig, ReplConfig, StreamingEngine
    from metrics_tpu_torch.part import (
        PartConfig,
        PartitionedClient,
        PartitionedNode,
        PartitionMap,
        migrate_tenant,
        partition_name,
        sweep_partitions,
    )
    from metrics_tpu_torch.repl import FanoutTransport, LoopbackLink

    hosts, home = ("a", "b"), {0: "a", 1: "a", 2: "b", 3: "b"}
    pids = range(U_PARTITIONS)
    links = {}

    def link(src, dst, part):
        return links.setdefault((src, dst, part), LoopbackLink())

    def ckpt(host, pid):
        return CheckpointConfig(directory=os.path.join(root, host, partition_name(pid)), interval_s=3600.0,
                                retain=M_RETAIN, wal_flush="fsync")

    kw = dict(buckets=T_BUCKETS, max_queue=K_QUEUE, capacity=2 * U_TENANTS_PER_PARTITION)
    store = FakeCoordStore()  # the live clock
    pmap = PartitionMap(U_PARTITIONS, seed=7, directory=os.path.join(root, "pmap"))
    keys, per_pid, i = [], {pid: 0 for pid in pids}, 0
    while len(keys) < U_PARTITIONS * U_TENANTS_PER_PARTITION:
        key = f"tenant-{i}"
        if per_pid[pmap.partition_of(key)] < U_TENANTS_PER_PARTITION:
            keys.append(key)
            per_pid[pmap.partition_of(key)] += 1
        i += 1
    engines = {h: {} for h in hosts}
    for pid in pids:
        leader = home[pid]
        other = "b" if leader == "a" else "a"
        engines[leader][pid] = StreamingEngine(
            _k2_metric(), checkpoint=ckpt(leader, pid), guard=GuardConfig(shed=False) if pid == 0 else None,
            replication=ReplConfig(role="primary", transport=FanoutTransport([link(leader, other, partition_name(pid))]),
                                   ship_interval_s=0.01, heartbeat_interval_s=0.05, epoch=1), **kw)
        engines[other][pid] = StreamingEngine(_k2_metric(), replication=ReplConfig(
            role="follower", transport=link(leader, other, partition_name(pid)), poll_interval_s=0.005,
            promote_checkpoint=ckpt(other, pid)), **kw)
        _check(store.acquire_lease(leader, T_CADENCE["lease_ttl_s"], name=partition_name(pid)) is not None,
               f"U1: the first lease of p{pid}")
    nodes, poll, acked, lock = {}, None, [], threading.Lock()
    reqs = _t_reqs(np, 41, U_BEFORE + U_AFTER + T_PROFILED, keys)
    before, after, profiled = reqs[:U_BEFORE], reqs[U_BEFORE:U_BEFORE + U_AFTER], reqs[U_BEFORE + U_AFTER:]
    try:
        poll = _WriterPoll({f"p{pid}": (lambda pid=pid: [engines[h][pid] for h in hosts]) for pid in pids})
        nodes = {h: PartitionedNode(engines[h], PartConfig(
            node_id=h, peers=tuple(x for x in hosts if x != h), store=store, partitions=U_PARTITIONS,
            link_factory=link, seed=7, rng_seed=ord(h), **T_CADENCE), pmap=pmap) for h in hosts}
        form_s = _wait_for(lambda: all(nodes[h]._slots[pid].following == home[pid]
                                       for pid in pids for h in hosts if h != home[pid]),
                           "U1: every follower slot attached", timeout=T_WAIT_S)
        client = PartitionedClient(store, engines, pmap=pmap, rng_seed=7, **T_CLIENT)
        t0 = time.perf_counter()
        _t_write(client.submit, before, acked)
        before_s = time.perf_counter() - t0
        for pid in pids:
            _t_caught_up({h: engines[h][pid] for h in hosts}, home[pid], [h for h in hosts if h != home[pid]],
                         f"U1 p{pid}")
        epochs = {pid: store.read_lease(partition_name(pid)).epoch for pid in pids}
        routes = {key: client.partition_of(key) for key in keys}
        # 'b' dies holding p2 and p3
        t_dead = time.perf_counter()
        nodes["b"].close(release=False)
        for engine in engines["b"].values():
            engine.close(checkpoint=False)
        failover_s = {}
        while len(failover_s) < 2:
            for pid in (2, 3):
                if pid not in failover_s and nodes["a"]._slots[pid].failovers:
                    failover_s[pid] = time.perf_counter() - t_dead
            _check(time.perf_counter() - t_dead < T_WAIT_S, f"U1: failovers of p2, p3 within {T_WAIT_S} s")
            time.sleep(0.002)
        _t_write(client.submit, after, acked)
        leases = {pid: store.read_lease(partition_name(pid)) for pid in pids}
        _check(all(leases[pid].holder == "a" for pid in pids) and nodes["a"].owned() == tuple(pids)
               and all(leases[pid].epoch == epochs[pid] for pid in (0, 1))
               and all(leases[pid].epoch > epochs[pid] and engines["a"][pid]._repl_epoch == leases[pid].epoch
                       for pid in (2, 3)),
               f"U1: leases {leases} against {epochs} before")
        _check({key: client.partition_of(key) for key in keys} == routes, "U1: a route moved")
        u1 = {"form_s": form_s, "before_req_per_s": len(before) / before_s, "failover_s": failover_s,
              "epochs_before": epochs, "epochs_after": {pid: leases[pid].epoch for pid in pids},
              "redirects": client.redirects, "acknowledged": len(acked)}
        # U2: one of p0's tenants moves to p2 while a thread keeps writing p0's others
        src, dst = engines["a"][0], engines["a"][2]
        moved = next(k for k in keys if pmap.partition_of(k) == 0)
        siblings = [k for k in keys if pmap.partition_of(k) == 0 and k != moved]
        entry_before = src.export_tenant(moved, retire=False)
        plan = migrate_tenant(moved, 2, pmap=pmap, src_engine=src, dst_engine=dst, node_id="a", dry_run=True)
        writer = threading.Thread(target=_t_write,
                                  args=(client.submit, _t_reqs(np, 43, U_SIBLING, siblings), acked, lock))
        t0 = time.perf_counter()
        writer.start()
        migrated = migrate_tenant(moved, 2, pmap=pmap, src_engine=src, dst_engine=dst, node_id="a")
        migrate_s = time.perf_counter() - t0
        writer.join(T_WAIT_S)
        _check(not writer.is_alive() and migrated is True and plan["valid"], f"U2: migrated {migrated}, plan {plan}")
        entry_after = dst.export_tenant(moved, retire=False)
        same = [np.array_equal(np.asarray(x), np.asarray(y)) for x, y in
                zip(_k_leaves(entry_before["state"]).values(), _k_leaves(entry_after["state"]).values())]
        _check(len(same) == len(_k_leaves(entry_before["state"])) and all(same), "U2: the moved state differs")
        _t_write(client.submit, _t_reqs(np, 44, 8, [moved]), acked)  # later writes fold onto the moved state
        manifest = PartitionMap(U_PARTITIONS, seed=7, directory=pmap.directory)
        _check(manifest.partition_of(moved) == 2 and moved not in list(src._keyed.keys)
               and manifest.epoch_floor(2) == plan["epoch_floor"], "U2: the manifest does not hold the move")
        final = {pid: store.read_lease(partition_name(pid)).epoch for pid in pids}
        u1["epochs_at_the_end"] = final
        u1["health"] = nodes["a"].health_view()
        _check(all(final[pid] == epochs[pid] for pid in (0, 1)), f"U: p0 or p1 changed epoch: {final} from {epochs}")
        for node in nodes.values():
            node.close(release=False)
        nodes = {}
        # the supervisors stopped: a profiled window of writes on a's four engines
        prof = _replays_profiled(torch, list(engines["a"].values()),
                           lambda: _t_write(lambda key, *args: engines["a"][pmap.partition_of(key)].submit(key, *args),
                                            profiled, acked),
                           ("stat_scores", "pair_count"), T_PER_ROW, "U1")
        u1.update(prof)
        u1["launches_all_replays"] = _replay_launches(list(engines["a"].values()), ("stat_scores", "pair_count"))
        folds, counts = _t_fold(torch, acked)
        leaves = 0
        for pid in pids:
            mine = {k: v for k, v in folds.items() if pmap.partition_of(k) == pid}
            leaves += _k_check_states(torch, None, mine, counts, f"U p{pid}", states=_p_states(engines["a"][pid]))
        # p2's leader restarts from its directory: the tenant is recovered there, and
        # the recovery sweep finds no tenant on a partition that does not route it
        dst.close(checkpoint=False)
        t0 = time.perf_counter()
        engines["a"][2] = StreamingEngine(_k2_metric(), checkpoint=ckpt("a", 2), **kw)
        restart_s = time.perf_counter() - t0
        swept = sweep_partitions(manifest, engines["a"])
        mine = {k: v for k, v in folds.items() if manifest.partition_of(k) == 2}
        restarted = _k_check_states(torch, None, mine, counts, "U2 restarted p2", states=_p_states(engines["a"][2]))
        _check(swept == 0 and moved in mine, f"U2: the sweep evicted {swept}")
        polled = poll.stop()
        _check(all(n == 1 for n in polled["most_writable_at_once"].values()),
               f"U: engines of one partition that accepted writes at once: {polled}")
        u1.update(polled)
        u1["state_leaves_equal"] = leaves
        u1["applied_inline"] = sum(inline for _k, _a, inline in acked)
        u2 = {"moved": moved, "plan": plan, "migrate_s": migrate_s, "sibling_writes": U_SIBLING,
              "restart_s": restart_s, "restarted_leaves_equal": restarted, "swept": swept}
    finally:
        if poll is not None:
            poll.stop()
        for node in nodes.values():
            node.close(release=False)
        for per_pid in engines.values():
            for engine in per_pid.values():
                engine.close(checkpoint=False)
    return {"U1": u1, "U2": u2}


def _u_host(seed: int, npart: int, requests: int) -> int:
    """One loopback host of U4 (this script started with ``--u-host``): a
    PartitionedNode leading ``npart`` partitions of ``BinaryAccuracy`` engines
    on cuda:0 on its own FakeCoordStore at the --cluster cadence; READY once
    every lease is held, then, on GO, its share of batch-1 writes from 4
    threads and one JSON line of its rate (engine_throughput.py's
    _part_host_child)."""
    import gc
    import threading

    import numpy as np

    from metrics_tpu_torch.classification import BinaryAccuracy
    from metrics_tpu_torch.cluster import FakeCoordStore
    from metrics_tpu_torch.engine import StreamingEngine
    from metrics_tpu_torch.part import PartConfig, PartitionedNode

    rng = np.random.default_rng(seed)
    engines = {pid: StreamingEngine(BinaryAccuracy(device="cuda"), buckets=(8,), max_queue=K_QUEUE, capacity=8)
               for pid in range(npart)}
    node = PartitionedNode(engines, PartConfig(node_id="host", peers=(), store=FakeCoordStore(), partitions=npart,
                                               rng_seed=seed, **T_CADENCE))
    try:
        deadline = time.perf_counter() + 30.0
        while len(node.owned()) < npart and time.perf_counter() < deadline:
            time.sleep(0.01)
        per = requests // npart
        streams = {pid: [(f"t{pid}-{rng.integers(0, 8)}", rng.integers(0, 2, 1), rng.integers(0, 2, 1))
                         for _ in range(per)] for pid in range(npart)}
        flat = [(pid, *streams[pid][i]) for i in range(per) for pid in range(npart)]
        for pid in range(npart):  # warm: slots allocated, the bucket captured
            for k in range(8):
                engines[pid].submit(f"t{pid}-{k}", np.ones(1, np.int64), np.ones(1, np.int64))
            engines[pid].flush(timeout=300)
            engines[pid].reset()
        print("READY" if len(node.owned()) == npart else "NOLEASE", flush=True)
        sys.stdin.readline()  # GO
        gc.collect()
        gc.disable()
        t0 = time.perf_counter()

        def client(tid: int) -> None:
            for i in range(tid, len(flat), 4):
                pid, key, p, t = flat[i]
                engines[pid].submit(key, p, t)

        threads = [threading.Thread(target=client, args=(tid,)) for tid in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for engine in engines.values():
            engine.flush(timeout=300)
        wall = time.perf_counter() - t0
        processed = sum(e.telemetry_snapshot()["processed"] for e in engines.values())
        print(json.dumps({"rps": len(flat) / wall, "wall": wall, "processed": processed}), flush=True)
    finally:
        gc.enable()
        node.close(release=False)
        for engine in engines.values():
            engine.close()
    return 0


def _u4_pass(n_hosts: int) -> dict:
    """U4_REQUESTS writes over U4_PARTITIONS partitions, led by ``n_hosts``
    processes on the one card, started together; the aggregate rate over the
    slowest host's wall."""
    per_host, npart = U4_REQUESTS // n_hosts, U4_PARTITIONS // n_hosts
    children = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--u-host", str(11 + i), str(npart),
                                  str(per_host)], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
                for i in range(n_hosts)]
    try:
        t0 = time.perf_counter()
        for ch in children:
            line = ch.stdout.readline()
            _check("READY" in line, f"U4: a host did not lead its partitions: {line!r}")
        ready_s = time.perf_counter() - t0
        for ch in children:
            ch.stdin.write("GO\n")
            ch.stdin.flush()
        done = [json.loads(ch.stdout.readline()) for ch in children]
        for ch in children:
            ch.stdin.close()
            _check(ch.wait(U4_READY_S) == 0, "U4: a host exited non-zero")
    finally:
        for ch in children:
            if ch.poll() is None:
                ch.kill()
                ch.wait(60)
    total = n_hosts * (per_host // npart) * npart
    _check(all(d["processed"] == (per_host // npart) * npart + 8 * npart for d in done),
           f"U4: processed {[d['processed'] for d in done]}")
    return {"req_per_s": total / max(d["wall"] for d in done), "host_walls_s": [d["wall"] for d in done],
            "ready_s": ready_s}


def phase_u(torch, np) -> dict:
    """The partition plane on the card: independent failovers and a live
    migration (U1, U2), the partition layer's overhead at partitions=1 (U3)
    and the 4-host write scaling (U4)."""
    import statistics
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = phase_u12(torch, np, d)
    out["U1"]["seconds_u1_u2"] = time.perf_counter() - t0
    print(f"phase U1 {json.dumps(out['U1'])}")
    print(f"phase U2 {json.dumps(out['U2'])}")
    out["U3"] = _t_pairs(torch, np, "cluster", "part")
    print(f"phase U3 {json.dumps(out['U3'])}")
    passes = {1: [], U4_HOSTS: []}
    for i in range(U4_PAIRS):
        for n in ((1, U4_HOSTS) if i % 2 == 0 else (U4_HOSTS, 1)):
            passes[n].append(_u4_pass(n))
    ratios = [four["req_per_s"] / one["req_per_s"] for one, four in zip(passes[1], passes[U4_HOSTS])]
    scale = statistics.median(ratios)
    out["U4"] = {"scale_x": scale, "jax_floor_x": U4_FLOOR, "meets_jax_floor": scale >= U4_FLOOR,
                 "pair_ratios": ratios, "one_host": passes[1], "four_hosts": passes[U4_HOSTS],
                 "partitions": U4_PARTITIONS, "requests": U4_REQUESTS}
    print(f"phase U4 {json.dumps(out['U4'])}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase U: {out['seconds']:.1f} s")
    return out


S_PARTITIONS = 8  # benchmarks/engine_throughput.py --query (:1779-2030)
S_QUANTS = (0.5, 0.99)
S_REGISTERED = 10**6
S_ACTIVE = 1024
S_SEED = 18
S_DASH_TENANTS = 512
S_HITS = 50
S_CACHE_FLOOR = 10.0  # its --query-cache-floor: a record here
S_PAIRS = 1  # the rollup storm's alternating pairs (6 there)
S_BUCKETS = (64,)  # the partitions' bucket ladder (the engine's default, 6 rungs, there): 1 capture an engine
S_GATE_PCT = 5.0  # its rollup_overhead_lt_5pct: a record here, as M1's


def _s_engine(**kw):
    from metrics_tpu_torch.engine import StreamingEngine
    from metrics_tpu_torch.sketch import QuantileSketch

    return StreamingEngine(QuantileSketch(quantiles=S_QUANTS, device="cuda"), buckets=S_BUCKETS, max_queue=4096, **kw)


def phase_s_exact(torch, np) -> dict:
    """(a) A global p99 over 10^6 registered and 1024 active tenants in 8
    partitions, read through a PartitionedClient with one node leading all 8,
    ``torch.equal`` to the per-tenant oracle on the card."""
    import functools

    from metrics_tpu_torch.cluster import FakeCoordStore
    from metrics_tpu_torch.engine import TierConfig
    from metrics_tpu_torch.part import PartitionedClient, PartitionMap, partition_name
    from metrics_tpu_torch.query import GlobalQuery
    from metrics_tpu_torch.sketch import QuantileSketch

    rng = np.random.default_rng(S_SEED)
    engines = [_s_engine(capacity=256, telemetry_labels={"partition": f"p{pid}"},
                         tier=TierConfig(hot_capacity=4096, idle_demote_s=3600.0, check_interval_s=3600.0))
               for pid in range(S_PARTITIONS)]
    store = FakeCoordStore()
    for pid in range(S_PARTITIONS):  # one node leads every partition: exactness is about the merge
        _check(store.acquire_lease("a", 600.0, name=partition_name(pid)) is not None, f"S1: the lease of p{pid}")
    client = PartitionedClient(store, {"a": dict(enumerate(engines))}, pmap=PartitionMap(S_PARTITIONS), retries=2,
                               rng_seed=5)
    try:
        t0 = time.perf_counter()
        per_part = [S_REGISTERED // S_PARTITIONS + (1 if pid < S_REGISTERED % S_PARTITIONS else 0)
                    for pid in range(S_PARTITIONS)]
        registered = sum(engines[pid].register_tenants([f"reg-{pid}-{i}" for i in range(per_part[pid])])
                         for pid in range(S_PARTITIONS))
        reg_s = time.perf_counter() - t0
        fed = {}
        t0 = time.perf_counter()
        for t in range(S_ACTIVE):
            key, pid = f"act-{t}", t % S_PARTITIONS
            fed[key] = [rng.lognormal(0.0, 1.5, 8 + int(rng.integers(0, 25))).astype(np.float32) for _ in range(1 + t % 2)]
            for batch in fed[key]:
                engines[pid].submit(key, batch)
        for engine in engines:
            engine.flush(timeout=300)
        feed_s = time.perf_counter() - t0
        metric = QuantileSketch(quantiles=S_QUANTS, device="cuda")
        gq = GlobalQuery(client, prefer="leader")
        t0 = time.perf_counter()
        value, report = gq.quantile(metric, S_QUANTS)
        torch.cuda.synchronize()
        global_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        states = []
        for key in sorted(fed):
            s = metric.init_state()
            for batch in fed[key]:
                s = metric.update_state(s, torch.from_numpy(batch).to("cuda"))
            states.append(s)
        oracle = functools.reduce(metric.merge_states, states)
        expect = metric.quantile_from(oracle, S_QUANTS)
        torch.cuda.synchronize()
        oracle_ms = (time.perf_counter() - t0) * 1e3
        # the engines count rows, the oracle's updates whole batches: every other leaf bit for bit
        merged = next(iter(gq.cache._entries.values())).state
        rows_fed = sum(batch.shape[0] for batches in fed.values() for batch in batches)
        _check(int(merged["_update_count"]) == rows_fed, f"S exactness: {int(merged['_update_count'])} updates "
               f"for {rows_fed} rows")
        leaves = _r_equal(torch, {"global": {k: v for k, v in merged.items() if k != "_update_count"}},
                          {"global": {k: v for k, v in oracle.items() if k != "_update_count"}},
                          "S exactness: the merged state")
        checks = {
            "registered_all": registered == S_REGISTERED,
            "every_tenant_accounted": report.tenants == S_REGISTERED + S_ACTIVE,
            "no_partition_missing": report.partitions_missing == (),
            "quantiles_equal_to_the_oracle": bool(torch.equal(value, expect)),
        }
        for name, ok in checks.items():
            _check(ok, f"S exactness: {name} failed (tenants {report.tenants}, {value.tolist()} vs {expect.tolist()})")
        launches = {}
        for engine in engines:
            for name, n in engine.graph_launches().items():
                launches[name] = launches.get(name, 0) + n
        _check(launches.get("hist_add", 0) > 0, f"S: hist_add was never launched in a replay ({launches})")
        rollup_ms = []  # one partition's fold alone: its slab and its 125,000 registrations
        for engine in engines:
            t1 = time.perf_counter()
            engine.rollup()
            torch.cuda.synchronize()
            rollup_ms.append((time.perf_counter() - t1) * 1e3)
    finally:
        for engine in engines:
            engine.close()
    return {"checks": checks, "registered": registered, "active": S_ACTIVE, "partitions": S_PARTITIONS,
            "registration_keys_per_s": S_REGISTERED / reg_s, "feed_s": feed_s, "global_query_ms": global_ms,
            "oracle_ms": oracle_ms, "quantiles": value.tolist(), "oracle_quantiles": expect.tolist(),
            "merged_leaves_equal": leaves, "merge_hops": report.merge_hops, "launches_in_replays": launches,
            "rollup_ms": rollup_ms}


def phase_s_cached(torch, np, root: str) -> dict:
    """(b) The cached path against the naive per-tenant scatter, served by
    followers: 8 journaled leaders shipping to 8 followers, one
    PartitionedClient over both ('a' the leaders, 'b' the followers), 512
    tenants written through it, ``GlobalQuery`` on ``prefer="replica"``: a
    populating miss, then 50 timed queries, every one a hit with no leader
    read, the value equal to the leaders' per-tenant oracle; the
    ``hist_add`` launches in the replays against the profiler."""
    import functools

    from metrics_tpu_torch import obs
    from metrics_tpu_torch.cluster import FakeCoordStore
    from metrics_tpu_torch.engine import CheckpointConfig, ReplConfig
    from metrics_tpu_torch.obs.instrument import QUERY_CACHE_HITS, QUERY_LEADER_READS
    from metrics_tpu_torch.part import PartitionedClient, PartitionMap, partition_name
    from metrics_tpu_torch.query import GlobalQuery
    from metrics_tpu_torch.repl import FanoutTransport, LoopbackLink
    from metrics_tpu_torch.sketch import QuantileSketch

    rng = np.random.default_rng(S_SEED + 1)
    store = FakeCoordStore()
    leaders, followers = {}, {}
    for pid in range(S_PARTITIONS):
        link, labels = LoopbackLink(), {"partition": partition_name(pid)}
        leaders[pid] = _s_engine(capacity=128, telemetry_labels=labels, checkpoint=CheckpointConfig(
            directory=os.path.join(root, f"p{pid}"), interval_s=0.05), replication=ReplConfig(
            role="primary", transport=FanoutTransport([link]), ship_interval_s=0.01, heartbeat_interval_s=0.05,
            epoch=1))
        followers[pid] = _s_engine(capacity=128, telemetry_labels=labels, replication=ReplConfig(
            role="follower", transport=link, poll_interval_s=0.01))
        _check(store.acquire_lease("a", 600.0, name=partition_name(pid)) is not None, f"S2: the lease of p{pid}")
    client = PartitionedClient(store, {"a": leaders, "b": followers}, pmap=PartitionMap(S_PARTITIONS), retries=4,
                               rng_seed=7)
    engines = [*leaders.values(), *followers.values()]

    def settle() -> float:
        """Until every follower covers a stable leader seq (a journal entry after
        the stamp would invalidate the cache mid-timing)."""
        t0 = time.perf_counter()
        while True:
            _check(time.perf_counter() - t0 < T_WAIT_S, "S2: the followers never caught up")
            for engine in leaders.values():
                engine.flush(timeout=300)
            seqs = {pid: e._wal_seq for pid, e in leaders.items()}
            if all(f._applier.bootstrapped and f._applier.applied_seq >= seqs[pid] for pid, f in followers.items()):
                time.sleep(0.15)
                if all(leaders[pid]._wal_seq == seqs[pid] for pid in leaders):
                    return time.perf_counter() - t0
            time.sleep(0.02)

    try:
        keys = [f"dash-{t}" for t in range(S_DASH_TENANTS)]
        t0 = time.perf_counter()
        for key in keys:
            client.submit(key, rng.lognormal(0.0, 1.0, 16).astype(np.float32))
        for engine in leaders.values():
            engine.flush(timeout=300)
        feed_s = time.perf_counter() - t0
        settle_s = settle()
        metric = QuantileSketch(quantiles=S_QUANTS, device="cuda")
        gq = GlobalQuery(client)  # prefer="replica": the dashboard's reads
        miss_value, miss = gq.quantile(metric, 0.99)
        obs.reset()
        obs.enable()
        hits = True
        try:
            t0 = time.perf_counter()
            for _ in range(S_HITS):
                value, r = gq.quantile(metric, 0.99)
                hits = hits and r.cache_hit and r.follower_served
            torch.cuda.synchronize()
            cached_s = (time.perf_counter() - t0) / S_HITS
            hit_count = sum(QUERY_CACHE_HITS.collect().values())
            leader_reads = sum(QUERY_LEADER_READS.collect().values())
        finally:
            obs.reset()
            obs.disable()
        states = {}
        for pid, engine in leaders.items():
            states.update(engine._read_states(None, False))
        oracle = functools.reduce(metric.merge_states, [states[k] for k in keys])
        expect = metric.quantile_from(oracle, 0.99)
        client.compute(keys[0], prefer="leader")  # warm the read path
        t0 = time.perf_counter()
        for key in keys:
            client.compute(key, prefer="leader")
        torch.cuda.synchronize()
        naive_s = time.perf_counter() - t0
        replays = _replay_launches(followers.values(), ("hist_add",))
        checks = {"every_timed_query_was_a_hit": hits and hit_count == S_HITS,
                  "hit_flow_never_touched_a_write_leader": leader_reads == 0,
                  "populating_miss_was_full_coverage": miss.partitions_missing == () and not miss.cache_hit,
                  "served_by_followers": miss.follower_served and {p.node for p in miss.partitions} == {"b"},
                  "value_equals_the_leaders_oracle": bool(torch.equal(value, expect) and torch.equal(miss_value, expect)),
                  "hist_add_in_the_followers_replays": replays["hist_add"] > 0}
        for name, ok in checks.items():
            _check(ok, f"S cached: {name} failed ({hit_count} hits of {S_HITS}, {leader_reads} leader reads)")
        more = [(keys[int(rng.integers(0, len(keys)))], rng.lognormal(0.0, 1.0, 16).astype(np.float32))
                for _ in range(T_PROFILED)]
        prof = _replays_profiled(torch, engines, lambda: ([client.submit(k, v).result(timeout=T_WAIT_S) for k, v in more],
                                                    settle()), ("hist_add",), {"hist_add": 2}, "S2")
    finally:
        for engine in engines:
            engine.close()
    ratio = naive_s / cached_s
    return {"checks": checks, "cached_ms": cached_s * 1e3, "naive_scatter_ms": naive_s * 1e3, "ratio_x": ratio,
            "jax_floor_x": S_CACHE_FLOOR, "meets_jax_floor": ratio >= S_CACHE_FLOOR, "leader_reads": leader_reads,
            "feed_s": feed_s, "settle_s": settle_s, "tenants": S_DASH_TENANTS, "timed_hits": S_HITS,
            "launches_in_follower_replays": replays, **prof}


def _s_storm_pass(torch, np, reqs, folds, rows, storm: bool) -> tuple:
    """One warmed, timed K6 pass, with a reader thread folding every tenant as
    fast as the engine lets it (``storm``) or without."""
    import threading

    from metrics_tpu_torch.classification import BinaryAccuracy
    from metrics_tpu_torch.engine import StreamingEngine

    engine = StreamingEngine(BinaryAccuracy(device="cuda"), buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=K_TENANTS)
    stop, rolled, reader = threading.Event(), [0], None
    try:
        rng = np.random.default_rng(13)
        _k_warm(engine, lambda n: (rng.integers(0, 2, n), rng.integers(0, 2, n)), K_BUCKETS,
                sorted({key for key, _ in reqs}))
        engine.rollup()  # warm the fold
        if storm:
            def fold_all() -> None:
                while not stop.is_set():
                    engine.rollup()
                    rolled[0] += 1
                    stop.wait(0.002)

            reader = threading.Thread(target=fold_all)
            reader.start()
        seconds = _k_submit(engine, reqs, K_THREADS)
        stop.set()
        if reader is not None:
            reader.join(60)
            _check(not reader.is_alive(), "S storm: the rollup thread did not stop")
        _k_check_states(torch, engine, folds, rows, f"S storm {'on' if storm else 'off'}")
        last = engine.rollup()
        _check(last.tenants == len(folds), f"S storm: a rollup counted {last.tenants} tenants")
    finally:
        stop.set()
        engine.close()
    return len(reqs) / seconds, rolled[0]


def phase_s_storm(torch, np) -> dict:
    """(c) The write path's cost of a continuous rollup storm: S_PAIRS pairs of
    K6 passes with and without, alternating which goes first."""
    import statistics

    from metrics_tpu_torch.classification import BinaryAccuracy

    reqs = _k6_reqs(np, K1_REQUESTS, K_TENANTS)
    folds, rows = _k_fold(torch, BinaryAccuracy(device="cuda"), reqs, "cuda")
    plain, stormed, ratios, served = [], [], [], 0
    for i in range(S_PAIRS):
        got = {}
        for side in ((False, True) if i % 2 == 0 else (True, False)):
            got[side] = _s_storm_pass(torch, np, reqs, folds, rows, side)
        plain.append(got[False][0])
        stormed.append(got[True][0])
        ratios.append(got[False][0] / got[True][0])
        served += got[True][1]
    _check(served > 0, "S storm: no rollup was served during the storms")
    overhead_pct = (statistics.median(ratios) - 1.0) * 100.0
    stormed_s = sum(len(reqs) / r for r in stormed)
    return {"overhead_pct": overhead_pct, "gate_pct": S_GATE_PCT, "within_gate": overhead_pct < S_GATE_PCT,
            "pair_ratios": ratios, "plain_req_per_s": plain, "stormed_req_per_s": stormed,
            "rollups_served": served, "stormed_s": stormed_s, "rollups_per_s": served / stormed_s,
            "requests": len(reqs)}


def phase_s(torch, np) -> dict:
    """The query plane on the card: exactness at 10^6 registered tenants, the
    cached path, and a rollup storm on the write path."""
    import tempfile

    t0 = time.perf_counter()
    out = {"S1_exactness": phase_s_exact(torch, np)}
    print(f"phase S1 {json.dumps(out['S1_exactness'])}")
    with tempfile.TemporaryDirectory() as d:
        out["S2_cached"] = phase_s_cached(torch, np, d)
    print(f"phase S2 {json.dumps(out['S2_cached'])}")
    out["S3_rollup_storm"] = phase_s_storm(torch, np)
    print(f"phase S3 {json.dumps(out['S3_rollup_storm'])}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase S: {out['seconds']:.1f} s")
    return out


V_SHAPES = ((1024, 1000, "bench.py's step"), (SIX_N, SIX_C, "J2's collection"))
V_UPDATES = 4  # updates of each metric at each shape
V_KAPPA_WEIGHTS = (None, "linear", "quadratic")
V_RTOL, V_ATOL = 1e-5, 1e-6  # the card against the CPU: float32 sums of equal counts in another order
V_GROUPS = {0: ["cm", "mcc", "jaccard", "kappa"]}  # the JAX collection's, after the first update
V_GROUPS_BUILT = {0: ["cm", "mcc"], 1: ["jaccard"], 2: ["kappa"]}
V_PARTITIONS = 4  # benchmarks/engine_throughput.py --pilot (:1544-1760)
V_HOT = 8
V_REQUESTS = 8000
V_HOT_FRAC = 0.85
V_HEAL_PAIRS = 1  # healed / hand-balanced pairs (2 there)
V_QUIET_PAIRS = 1  # quiet pilot on / off pairs (6 there)
V_HEAL_FLOOR = 0.9  # its --pilot-recovery-floor: a record here (the hosts share one card and one interpreter)
V_QUIET_GATE_PCT = 1.0  # its pilot_idle_cost_lt_1pct: a record here
V_HEAL_DEADLINE_S = 90.0
# the heal pass's PilotConfig (:1643-1649), journal directory aside
V_PILOT = dict(lease_ttl_s=2.0, tick_interval_s=0.05, evaluate_interval_s=0.25, ewma_alpha=0.6, min_observations=2,
               min_rate=5.0, migration_budget=4, budget_window_s=0.5, tenant_cooldown_s=120.0)
V_PART = dict(lease_ttl_s=5.0, heartbeat_interval_s=0.2, suspect_after_s=2.0, confirm_after_s=5.0,
              tick_interval_s=0.05)


def _v_multiclass(dev: str, classes: int) -> dict:
    from metrics_tpu_torch.classification import (
        MulticlassCohenKappa, MulticlassJaccardIndex, MulticlassMatthewsCorrCoef,
    )

    out = {"jaccard_macro": MulticlassJaccardIndex(classes, average="macro", device=dev)}
    for w in V_KAPPA_WEIGHTS:
        out[f"kappa_{w or 'none'}"] = MulticlassCohenKappa(classes, weights=w, device=dev)
    out["mcc"] = MulticlassMatthewsCorrCoef(classes, device=dev)
    return out


def _v_collection(dev: str, classes: int, groups: bool):
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch.classification import (
        MulticlassCohenKappa, MulticlassConfusionMatrix, MulticlassJaccardIndex, MulticlassMatthewsCorrCoef,
    )

    return MetricCollection({
        "cm": MulticlassConfusionMatrix(classes, device=dev),
        "jaccard": MulticlassJaccardIndex(classes, device=dev),
        "kappa": MulticlassCohenKappa(classes, weights="linear", device=dev),
        "mcc": MulticlassMatthewsCorrCoef(classes, device=dev),
    }, compute_groups=groups)


def _v_close(torch, got, want, what: str) -> float:
    """The card's value against the CPU's within (V_RTOL, V_ATOL); the largest absolute difference."""
    g, w = got.cpu().double(), want.double()
    _check(got.dtype == want.dtype == torch.float32 and got.shape == want.shape, f"{what}: dtype/shape")
    _check(bool(torch.isfinite(g).all()), f"{what}: non-finite {got}")
    _check(torch.allclose(g, w, rtol=V_RTOL, atol=V_ATOL), f"{what}: card {got} vs CPU {want}")
    return float((g - w).abs().max())


def _v_batches(torch, np, seed: int, n: int, classes: int, dev: str):
    """``V_UPDATES`` int64 (preds, target) label batches, 30% of preds equal to their target."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(V_UPDATES):
        target = rng.integers(0, classes, n)
        preds = np.where(rng.random(n) < 0.3, target, rng.integers(0, classes, n))
        out.append((torch.from_numpy(preds).to(dev), torch.from_numpy(target).to(dev)))
    return out


def phase_v1(torch, np, obs, instrument, confmat) -> dict:
    """The confusion-matrix family on the card at bench.py's width and J2's: each
    multiclass metric's int32 table against the plain pair count, one table
    launch an update, values against the port on the CPU; the binary and
    multilabel forms at J2's N; the four-metric collection's launches with
    groups on and off."""
    from metrics_tpu_torch.classification import (
        BinaryCohenKappa, BinaryJaccardIndex, BinaryMatthewsCorrCoef, MultilabelJaccardIndex,
        MultilabelMatthewsCorrCoef,
    )

    out = {"tolerance": {"rtol": V_RTOL, "atol": V_ATOL}, "shapes": {}}
    total_launches = {"pair_count": 0, "stat_scores": 0}
    worst = 0.0
    for n, classes, what in V_SHAPES:
        key = f"N{n}_C{classes}"
        batches = _v_batches(torch, np, n + classes, n, classes, "cuda")
        plain = sum(confmat.pair_count_bincount(t, p, classes, classes, None, None) for p, t in batches)
        rec = {"what": what, "metrics": {}}
        for name, m in _v_multiclass("cuda", classes).items():
            cpu = _v_multiclass("cpu", classes)[name]
            per_update = []
            obs.enable()
            try:
                instrument.KERNEL_LAUNCHES.clear()  # the main path's run starts here ...
                instrument.KERNEL_DISPATCHES.clear()
                for preds, target in batches:
                    before = _route_launches(instrument)
                    m.update(preds, target)
                    per_update.append(_diff(_route_launches(instrument), before))
                _no_reference_dispatch(instrument, f"phase V1 {name} {key}")  # ... and ends here
            finally:
                obs.disable()
            _check(per_update == [(0, 1)] * V_UPDATES, f"V1 {name} {key}: (stat-score, table) launches {per_update}")
            total_launches["pair_count"] += V_UPDATES
            _check(m.confmat.dtype == torch.int32 and torch.equal(m.confmat, plain),
                   f"V1 {name} {key}: the table differs from the plain pair count")
            for preds, target in batches:
                cpu.update(preds.cpu(), target.cpu())
            _check(torch.equal(m.confmat.cpu(), cpu.confmat), f"V1 {name} {key}: the table differs from the CPU's")
            value, want = m.compute(), cpu.compute()
            err = _v_close(torch, value, want, f"V1 {name} {key}")
            worst = max(worst, err)
            ms = _time_ms(lambda: m.update(*batches[0]), 20, warmup=2)
            prof = _update_profile(torch, lambda _s, b: m.update(*b), None, batches[0], "pair_count_", iters=10)
            # the profiler may drop some of a window's records: the table kernel's time over its recorded launches
            table = [k for k in prof["top_kernels"] if "pair_count_" in k["name"]]
            table_us = sum(k["us_per_update"] for k in table) / sum(k["launches_per_update"] for k in table) \
                if table else None
            rec["metrics"][name] = {"value": float(value), "cpu_value": float(want), "abs_err": err,
                                    "launches_per_update": dict(zip(ROUTES, per_update[-1])),
                                    "ms_per_update": ms, "device_us_per_update": prof["device_busy_us_per_update"],
                                    "table_kernel_us_per_launch": table_us,
                                    "pair_count_launches_recorded": prof["pair_count__launches_recorded"],
                                    "profiled_updates": 10, "profile_complete": prof["complete"],
                                    "idle_share": prof["idle_share"]}
            print(f"phase V1 {key} {name} {json.dumps(rec['metrics'][name])}")
        # the confusion matrix with the three metrics, groups on and off
        launches = {}
        cols = {"groups": _v_collection("cuda", classes, True), "no_groups": _v_collection("cuda", classes, False)}
        built = {k: list(v) for k, v in cols["groups"].compute_groups.items()}
        _check(built == V_GROUPS_BUILT, f"V1 {key}: groups at construction {built}, the JAX package's {V_GROUPS_BUILT}")
        obs.enable()
        try:
            for mode, col in cols.items():
                instrument.KERNEL_LAUNCHES.clear()
                instrument.KERNEL_DISPATCHES.clear()
                per_update = []
                for preds, target in batches:
                    before = _route_launches(instrument)
                    col.update(preds, target)
                    per_update.append(_diff(_route_launches(instrument), before))
                launches[mode] = per_update
                _no_reference_dispatch(instrument, f"phase V1 collection {mode} {key}")
        finally:
            obs.disable()
        groups = {k: list(v) for k, v in cols["groups"].compute_groups.items()}
        _check(groups == V_GROUPS, f"V1 {key}: groups {groups}, the JAX package forms {V_GROUPS}")
        _check(launches["groups"] == [(0, 3)] + [(0, 1)] * (V_UPDATES - 1), f"V1 {key}: {launches['groups']}")
        _check(launches["no_groups"] == [(0, 4)] * V_UPDATES, f"V1 {key}: {launches['no_groups']}")
        total_launches["pair_count"] += sum(t for _, t in launches["groups"] + launches["no_groups"])
        for mode, col in cols.items():
            for name, m in col.items(keep_base=True):
                _check(torch.equal(m.confmat, plain), f"V1 {key} collection {mode} {name}: table differs")
        val_on, val_off = cols["groups"].compute(), cols["no_groups"].compute()
        for name in val_on:
            _check(torch.equal(val_on[name], val_off[name]), f"V1 {key} {name}: groups on vs off")
        times = {mode: [] for mode in cols}
        for _ in range(TIMING_REPS):
            for mode, col in cols.items():
                times[mode].append(_time_ms(lambda: col.update(*batches[0]), V_UPDATES, warmup=1))
        rec["collection"] = {"groups": groups, "built": built,
                             "table_launches_per_update": {k: v[-1][1] for k, v in launches.items()},
                             "table_launches_forming_update": launches["groups"][0][1],
                             **{f"{mode}_ms_per_update": min(times[mode]) for mode in cols}}
        rec["collection"]["speedup"] = rec["collection"]["no_groups_ms_per_update"] / rec["collection"][
            "groups_ms_per_update"]
        print(f"phase V1 {key} collection {json.dumps(rec['collection'])}")
        out["shapes"][key] = rec

    # the binary and multilabel forms at J2's N: plain torch counts (no hand kernel), against the CPU
    rng = np.random.default_rng(18)
    scores = rng.random(SIX_N).astype(np.float32)
    target = (rng.random(SIX_N) < np.where(scores > 0.5, 0.8, 0.2)).astype(np.int32)
    ml_shape = (SIX_N // SIX_C, SIX_C)
    forms = {
        "binary_jaccard": (lambda d: BinaryJaccardIndex(device=d), (scores, target)),
        **{f"binary_kappa_{w or 'none'}": (lambda d, w=w: BinaryCohenKappa(weights=w, device=d), (scores, target))
           for w in V_KAPPA_WEIGHTS},
        "binary_mcc": (lambda d: BinaryMatthewsCorrCoef(device=d), (scores, target)),
        "multilabel_jaccard": (lambda d: MultilabelJaccardIndex(SIX_C, device=d),
                               (scores.reshape(ml_shape), target.reshape(ml_shape))),
        "multilabel_mcc": (lambda d: MultilabelMatthewsCorrCoef(SIX_C, device=d),
                           (scores.reshape(ml_shape), target.reshape(ml_shape))),
    }
    out["binary_multilabel"] = {}
    for name, (make, arrays) in forms.items():
        card, cpu = make("cuda"), make("cpu")
        dev_args = tuple(torch.from_numpy(a).cuda() for a in arrays)
        card.update(*dev_args)
        cpu.update(*(torch.from_numpy(a) for a in arrays))
        _check(card.confmat.dtype == torch.int32 and torch.equal(card.confmat.cpu(), cpu.confmat),
               f"V1 {name}: the int32 counts differ from the CPU's")
        err = _v_close(torch, card.compute(), cpu.compute(), f"V1 {name}")
        worst = max(worst, err)
        ms = _time_ms(lambda: card.update(*dev_args), 10, warmup=2)
        out["binary_multilabel"][name] = {"value": float(card.compute()), "abs_err": err, "ms_per_update": ms}
    print(f"phase V1 binary and multilabel at N={SIX_N} {json.dumps(out['binary_multilabel'])}")
    out["launches"] = total_launches
    out["max_abs_err_vs_cpu"] = worst
    return out


def _v_keys_on(pmap, pid: int, prefix: str, n: int) -> list:
    out, i = [], 0
    while len(out) < n:
        key = f"{prefix}-{i}"
        if pmap.partition_of(key) == pid:
            out.append(key)
        i += 1
    return out


def _v_storm(np, rng, hot: list, bg: list, n: int, hot_frac: float) -> list:
    """Batch-1 requests: ``hot_frac`` of them zipf(1.2) over ``hot``, the rest
    uniform over ``bg`` (the benchmark's pilot_storm, drawn in its order)."""
    if hot:
        w = 1.0 / np.arange(1, len(hot) + 1) ** 1.2
        w /= w.sum()
        hot_picks = rng.choice(len(hot), size=n, p=w)
    hot_mask = rng.random(n) < hot_frac
    bg_picks = rng.integers(0, len(bg), size=n)
    keys = [hot[hot_picks[j]] if hot and hot_mask[j] else bg[bg_picks[j]] for j in range(n)]
    return [(k, (rng.integers(0, 2, 1), rng.integers(0, 2, 1))) for k in keys]


class _VFleet:
    """One host leading ``V_PARTITIONS`` partitions of ``BinaryAccuracy`` engines
    on the card over a FakeCoordStore, telemetry reset first (the pilot rates
    counter deltas keyed by node and partition). Every accepted write is kept
    for the fold."""

    def __init__(self, torch, seed: int, tier_p0=None) -> None:
        import threading

        from metrics_tpu_torch import obs
        from metrics_tpu_torch.classification import BinaryAccuracy
        from metrics_tpu_torch.cluster import FakeCoordStore
        from metrics_tpu_torch.engine import GuardConfig, StreamingEngine
        from metrics_tpu_torch.part import PartConfig, PartitionedNode
        from metrics_tpu_torch.tier import TierConfig

        obs.reset()
        obs.enable()  # the engines' telemetry is the pilot's only input
        self.torch = torch
        self.store = FakeCoordStore()
        self.engines = {
            pid: StreamingEngine(BinaryAccuracy(device="cuda"), buckets=(64,), max_queue=K_QUEUE,
                                 capacity=tier_p0["capacity"] if tier_p0 and pid == 0 else 64,
                                 guard=GuardConfig(shed=False),
                                 tier=TierConfig(**tier_p0["tier"]) if tier_p0 and pid == 0 else None)
            for pid in range(V_PARTITIONS)
        }
        self.node = PartitionedNode(self.engines, PartConfig(node_id="bench-pilot", store=self.store,
                                                             partitions=V_PARTITIONS, rng_seed=seed, **V_PART))
        _wait_for(lambda: len(self.node.owned()) == V_PARTITIONS, "V: the host leads every partition", 30.0)
        self.acked, self.futures, self._lock = [], [], threading.Lock()

    def submit(self, key, args) -> bool:
        """One write routed by the live map; False if the source holds it (a migration's quarantine)."""
        from metrics_tpu_torch.guard.errors import TenantQuarantined

        try:
            fut = self.engines[self.node.pmap.partition_of(key)].submit(key, *args)
        except TenantQuarantined:
            return False
        with self._lock:
            self.acked.append((key, args))
            self.futures.append(fut)
        return True

    def warm(self, keys) -> None:
        """Every tenant resident and each engine's graph captured before any timed window."""
        for key in keys:
            _check(self.submit(key, (_v_zero(), _v_zero())), f"V: warm write of {key} refused")
        self.flush()

    def flush(self) -> None:
        for eng in self.engines.values():
            eng.flush(timeout=300)

    def pump(self, storm, threads: int = K_THREADS) -> float:
        """Timed: every request routed through the live partition map; a held
        (quarantined) write is re-routed after 2 ms, never dropped."""
        import threading

        from metrics_tpu_torch.utils.graphs import collector_paused

        def client(tid: int) -> None:
            for key, args in storm[tid::threads]:
                while not self.submit(key, args):
                    time.sleep(0.002)

        with collector_paused():
            t0 = time.perf_counter()
            workers = [threading.Thread(target=client, args=(tid,)) for tid in range(threads)]
            for th in workers:
                th.start()
            for th in workers:
                th.join(300)
                _check(not th.is_alive(), "V: a client thread did not finish")
            self.flush()
            seconds = time.perf_counter() - t0
        return len(storm) / seconds

    def check_states(self, what: str) -> int:
        """Every tenant's state, on the engine its partition map names and on no
        other, equal to a CPU fold of its accepted writes; every receipt answered."""
        from concurrent.futures import wait

        from metrics_tpu_torch.classification import BinaryAccuracy

        self.flush()
        self.torch.cuda.synchronize()
        done, not_done = wait(self.futures, timeout=60)
        _check(not not_done, f"{what}: {len(not_done)} receipts unanswered")
        errors = [f.exception() for f in done if f.exception() is not None]
        _check(not errors, f"{what}: {len(errors)} writes failed, first {errors[:1]!r}")
        folds, rows = _k_fold(self.torch, BinaryAccuracy(device="cpu"), self.acked, "cpu")
        compared = 0
        for key in folds:
            pid = self.node.pmap.partition_of(key)
            others = [p for p, e in self.engines.items() if p != pid and key in e._keyed.keys]
            _check(not others, f"{what} {key}: also resident on {others}")
            # read through the engine (a demoted tenant's state from host memory), its lock taken
            states = self.engines[pid]._read_states([key], False)
            compared += _k_check_states(self.torch, self.engines[pid], {key: folds[key]}, rows, what, states=states)
        return compared

    def close(self) -> None:
        self.node.close(release=False)
        for eng in self.engines.values():
            eng.close()


def _v_zero():
    import numpy as np

    return np.zeros(1, np.int64)


def _v_pilot_checks(pilot, obs, what: str) -> dict:
    """No fallback around the pilot: no failed action, no failed tick, no
    ``pilot_action_failed`` bundle."""
    from metrics_tpu_torch.obs.flight import FLIGHT

    dumped = FLIGHT.dump_counts().get("pilot_action_failed", 0)
    _check(pilot.actuator.failures == 0, f"{what}: {pilot.actuator.failures} actuator failures")
    _check(pilot.last_error is None, f"{what}: the pilot's last error {pilot.last_error!r}")
    _check(dumped == 0, f"{what}: {dumped} pilot_action_failed bundles")
    return {"actuator_failures": pilot.actuator.failures, "last_error": None, "action_failed_bundles": dumped}


def _v_heal_pass(torch, np, obs, seed: int, healed: bool, root: str) -> dict:
    """The zipf storm against a fleet whose hot set all starts on p0. Healed: a
    live AutoPilot must spread it, with no operator input, before the timed
    window (then paused); otherwise the layout is balanced by hand up front."""
    from metrics_tpu_torch.pilot import AutoPilot, PilotConfig, read_journal

    fleet = _VFleet(torch, seed)
    pilot = None
    try:
        rng = np.random.default_rng(seed)
        pmap = fleet.node.pmap
        hot = _v_keys_on(pmap, 0, "hot", V_HOT)
        bg = [k for pid in range(1, V_PARTITIONS) for k in _v_keys_on(pmap, pid, "bg", 2)]
        if not healed:
            for i, key in enumerate(hot):  # the operator's layout
                pmap.set_override(key, i % V_PARTITIONS)
        fleet.warm(hot + bg)
        storm = _v_storm(np, rng, hot, bg, V_REQUESTS, V_HOT_FRAC)
        rec = {"healed": healed}
        if healed:
            journal = os.path.join(root, f"journal-{seed}")
            pilot = AutoPilot(fleet.node, PilotConfig(node_id="bench-pilot", store=fleet.store,
                                                      journal_directory=journal, **V_PILOT))
            t0 = time.perf_counter()
            i = 0
            while len({pmap.partition_of(k) for k in hot}) < 3 and time.perf_counter() - t0 < V_HEAL_DEADLINE_S:
                fleet.submit(*storm[i % len(storm)])  # throttled: relative skew, not a crush of the pilot thread
                i += 1
                time.sleep(0.0005)
            rec["heal_s"] = time.perf_counter() - t0
            rec["warm_writes"] = i
            pilot.pause()  # actuation frozen for the timed window
            time.sleep(0.3)  # an in-flight cycle finishes
        rec["req_per_s"] = fleet.pump(storm)
        rec["spread"] = len({pmap.partition_of(k) for k in hot})
        rec["layout"] = {k: pmap.partition_of(k) for k in hot}
        rec["leaves_equal_fold"] = fleet.check_states(f"V2 {'healed' if healed else 'balanced'}")
        if pilot is not None:
            rec["migrations"] = pilot.actuator.executed
            rec.update(_v_pilot_checks(pilot, obs, "V2"))
            rec["journal_records"] = len(read_journal(journal))
            rec["hot_partitions"] = pilot.health()["hot_partitions"]
        return rec
    finally:
        if pilot is not None:
            pilot.close()
        fleet.close()


def _v_quiet_pass(torch, np, obs, seed: int, with_pilot: bool, root: str) -> dict:
    """A uniform mix on a balanced fleet: the pilot holds the lease, evaluates at
    its default cadence, journals every cycle and finds nothing to do; the only
    difference from the pass without it is the controller."""
    from metrics_tpu_torch.pilot import AutoPilot, PilotConfig, read_journal

    fleet = _VFleet(torch, seed)
    pilot = None
    try:
        rng = np.random.default_rng(seed)
        keys = [k for pid in range(V_PARTITIONS) for k in _v_keys_on(fleet.node.pmap, pid, "tenant", 2)]
        fleet.warm(keys)
        storm = _v_storm(np, rng, [], keys, V_REQUESTS, 0.0)
        journal = os.path.join(root, f"quiet-{seed}")
        if with_pilot:
            pilot = AutoPilot(fleet.node, PilotConfig(node_id="bench-pilot", store=fleet.store,
                                                      journal_directory=journal))
            _wait_for(lambda: pilot.role == "pilot", "V3: the pilot wins its lease", 10.0)
        rec = {"pilot": with_pilot, "req_per_s": fleet.pump(storm)}
        rec["leaves_equal_fold"] = fleet.check_states("V3")
        if pilot is not None:
            _check(pilot.role == "pilot" and pilot.cycles >= 1, f"V3: role {pilot.role}, {pilot.cycles} cycles")
            pilot.close()
            records = read_journal(journal)
            moves = [o for r in records for o in r["outcomes"] if o.get("kind") == "migrate_tenant"]
            _check(len(records) == pilot.cycles, f"V3: {len(records)} journal records for {pilot.cycles} cycles")
            _check(pilot.actuator.executed == 0 and not moves, f"V3: the quiet pilot acted: {moves}")
            rec.update({"cycles": pilot.cycles, "journal_records": len(records), "migrations": 0,
                        **_v_pilot_checks(pilot, obs, "V3")})
        return rec
    finally:
        if pilot is not None:
            pilot.close()
        fleet.close()


def phase_v4(torch, np, obs, root: str) -> dict:
    """Two AutoPilots over one store beside a live fleet on the card: the holder
    is closed without releasing its lease, the standby takes it within one TTL
    and numbers the shared journal on. Then a tier retune of p0's engine (hot
    capacity 4 -> 16) through the actuator: the next sweep keeps the 12
    tenants it was kept from hot, the slab grows to hold them (its graphs
    captured again), and every state equals the fold."""
    from metrics_tpu_torch.pilot import PILOT_LEASE, Actuator, AutoPilot, PilotConfig, RetuneTier, read_journal

    tier_p0 = {"capacity": 4, "tier": {"hot_capacity": 4, "check_interval_s": 0.0, "idle_demote_s": 1e9}}
    fleet = _VFleet(torch, 41, tier_p0=tier_p0)
    journal = os.path.join(root, "journal-v4")
    # tier_capacity_max = 4: the pilots' own policy never retunes; the retune below is the actuator's alone
    cfg = dict(V_PILOT, tier_capacity_max=4)
    pilots = {}
    try:
        rng = np.random.default_rng(41)
        keys = [k for pid in range(V_PARTITIONS) for k in _v_keys_on(fleet.node.pmap, pid, "tenant", 2)]
        fleet.warm(keys)
        pilots = {name: AutoPilot(fleet.node, PilotConfig(node_id=name, store=fleet.store,
                                                          journal_directory=journal, **cfg)) for name in ("a", "b")}
        _wait_for(lambda: any(p.role == "pilot" for p in pilots.values()), "V4: a pilot wins the lease", 10.0)
        holder = next(n for n, p in pilots.items() if p.role == "pilot")
        standby = "b" if holder == "a" else "a"
        fleet.pump(_v_storm(np, rng, [], keys, 1000, 0.0))
        _wait_for(lambda: pilots[holder].cycles >= 2, "V4: the holder's cycles", 10.0)
        epoch = pilots[holder].health()["lease_epoch"]
        pilots[holder].close(release=False)  # dies: its lease is left to run out
        taken = _wait_for(lambda: pilots[standby].role == "pilot", "V4: the standby takes the lease",
                          timeout=3 * cfg["lease_ttl_s"])
        _check(taken <= cfg["lease_ttl_s"] + cfg["tick_interval_s"],
               f"V4: the standby took {taken:.3f} s, one TTL is {cfg['lease_ttl_s']} s")
        fleet.pump(_v_storm(np, rng, [], keys, 1000, 0.0))
        _wait_for(lambda: pilots[standby].cycles >= 2, "V4: the standby's cycles", 10.0)
        new_epoch = pilots[standby].health()["lease_epoch"]
        lease = fleet.store.read_lease(PILOT_LEASE)
        _check(lease is not None and lease.holder == standby and lease.epoch == new_epoch, f"V4: the lease {lease}")
        records = read_journal(journal)
        seqs = [r["seq"] for r in records]
        nodes = [r["node"] for r in records]
        _check(seqs == list(range(len(records))), f"V4: journal seqs {seqs}")
        first_b = nodes.index(standby)
        _check(set(nodes[:first_b]) == {holder} and set(nodes[first_b:]) == {standby},
               f"V4: journal nodes {nodes}")
        _check(new_epoch > epoch, f"V4: lease epochs {epoch} -> {new_epoch}")
        rec = {"holder": holder, "standby": standby, "takeover_s": taken, "lease_ttl_s": cfg["lease_ttl_s"],
               "epochs": [epoch, new_epoch], "journal_records": len(records), "holder_records": first_b}
        pilots[standby].close()  # before the skewed writes below, which it would rebalance
        for name, p in pilots.items():
            rec[f"pilot_{name}"] = _v_pilot_checks(p, obs, f"V4 {name}")
            _check(p.actuator.executed == 0, f"V4: pilot {name} acted on a uniform mix")

        # the retune: hot capacity 4 -> 16 on p0, taking effect at the engine's next sweep. The
        # tenants are admitted one at a time first, so the slab holds the cap's rows before it and
        # grows after it because of it (its graphs then captured against the new slab)
        eng = fleet.engines[0]
        p0 = _v_keys_on(fleet.node.pmap, 0, "tiered", 12)
        for key in p0:
            _check(fleet.submit(key, (_v_zero(), _v_zero())), "V4: a tiered write refused")
            fleet.flush()
            eng._maybe_tier()
        before = {"hot": len(eng._keyed.keys), "slab_rows": eng._keyed.capacity,
                  "compiles": eng.telemetry_snapshot()["compiles"]}
        act = Actuator(PilotConfig(node_id=standby, store=fleet.store), fleet.node)
        outcome = act.execute([RetuneTier(pid=0, hot_capacity=16)], now=fleet.store.now())[0]
        _check(outcome["outcome"] == "ok" and outcome["was"] == 4 and eng._tier.cfg.hot_capacity == 16,
               f"V4: retune {outcome}")
        for key in p0:
            _check(fleet.submit(key, (_v_zero() + 1, _v_zero() + 1)), "V4: a tiered write refused")
        fleet.flush()
        eng._maybe_tier()
        after = {"hot": len(eng._keyed.keys), "slab_rows": eng._keyed.capacity,
                 "compiles": eng.telemetry_snapshot()["compiles"]}
        _check(before["hot"] == 4 and 12 <= after["hot"] <= 16 and after["slab_rows"] > before["slab_rows"],
               f"V4: the retune did not take effect at the next sweep: {before} -> {after}")
        rec["retune"] = {"outcome": outcome, "before": before, "after": after,
                         "leaves_equal_fold": fleet.check_states("V4")}
        return rec
    finally:
        for p in pilots.values():
            p.close(release=False)
        fleet.close()


def phase_v(torch, np, obs, instrument, confmat) -> dict:
    """The confusion-matrix family (V1) and the autopilot plane (V2-V4) on the card."""
    import statistics
    import tempfile

    t0 = time.perf_counter()
    out = {"V1": phase_v1(torch, np, obs, instrument, confmat)}
    out["V1"]["seconds"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as root:
        t1 = time.perf_counter()
        heal = []
        for i in range(V_HEAL_PAIRS):
            order = (True, False) if i % 2 == 0 else (False, True)
            pair = {h: _v_heal_pass(torch, np, obs, 21 + i, h, root) for h in order}
            heal.append(pair)
        ratios = [p[True]["req_per_s"] / p[False]["req_per_s"] for p in heal]
        for p in heal:
            _check(p[True]["spread"] >= 3, f"V2: the hot set spread over {p[True]['spread']} partitions")
            _check(p[True]["migrations"] >= 1, "V2: the pilot executed no migration")
        ratio = statistics.median(ratios)
        out["V2"] = {"healed_over_balanced_x": ratio, "jax_floor_x": V_HEAL_FLOOR,
                     "meets_jax_floor": ratio >= V_HEAL_FLOOR, "pair_ratios": ratios,
                     "passes": [{str(k): v for k, v in p.items()} for p in heal], "seconds": time.perf_counter() - t1}
        print(f"phase V2 {json.dumps(out['V2'])}")
        t1 = time.perf_counter()
        quiet = []
        for i in range(V_QUIET_PAIRS):
            order = (False, True) if i % 2 == 0 else (True, False)
            quiet.append({w: _v_quiet_pass(torch, np, obs, 31 + i, w, root) for w in order})
        costs = [q[False]["req_per_s"] / q[True]["req_per_s"] for q in quiet]
        cost_pct = (statistics.median(costs) - 1.0) * 100.0
        out["V3"] = {"quiet_pilot_cost_pct": cost_pct, "jax_limit_pct": V_QUIET_GATE_PCT,
                     "meets_jax_limit": cost_pct < V_QUIET_GATE_PCT, "pair_ratios": costs,
                     "passes": [{str(k): v for k, v in q.items()} for q in quiet],
                     "seconds": time.perf_counter() - t1}
        print(f"phase V3 {json.dumps(out['V3'])}")
        t1 = time.perf_counter()
        out["V4"] = phase_v4(torch, np, obs, root)
        out["V4"]["seconds"] = time.perf_counter() - t1
        print(f"phase V4 {json.dumps(out['V4'])}")
    obs.reset()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase V: {out['seconds']:.1f} s")
    return out


W_N = 10**6  # label pairs / scores an update (J2's N)
W_C = 100  # J2's classes
W_UPDATES = 4
W_MATRIX = (2**17, 8)  # the *_matrix input: rows x columns, W_MATRIX_CATS categories a column
W_MATRIX_CATS = 20
W_EXACT_MC = (16, 512 * 512, 21)  # MulticlassExactMatch: samples x positions, classes
W_EXACT_ML = (10**6, 10)  # MultilabelExactMatch: samples x labels
W_RANK = (2**15, 100)  # the ranking metrics: samples x labels (an (N, L, L) float32 comparison tensor)
W_DICE_MDMC = (10**4, W_C, 100)  # Dice samplewise: (N, C, X), N * X = 10^6 positions
W_PROFILED = 5  # updates timed by CUDA events and under the profiler, each metric
W_FLAGSHIP_GROUPS_BUILT = {0: ["accuracy"], 1: ["confmat"], 2: ["f1"], 3: ["hamming"]}  # the JAX package's
W_FLAGSHIP_GROUPS = {0: ["accuracy", "f1", "hamming"], 1: ["confmat"]}  # after the first update


def _w_counted(obs, instrument, calls, what: str, dev: str) -> list:
    """(stat-score, table) launches of each call, the counters set to 0 just
    before the first and read just after the last; no reference dispatch on a
    CUDA tensor."""
    obs.enable()
    try:
        instrument.KERNEL_LAUNCHES.clear()  # the path's run starts here ...
        instrument.KERNEL_DISPATCHES.clear()
        per_call = []
        for call in calls:
            before = _route_launches(instrument)
            call()
            per_call.append(_diff(_route_launches(instrument), before))
        if dev == "cuda":
            _no_reference_dispatch(instrument, f"phase {what}")  # ... and ends here
    finally:
        obs.disable()
    return per_call


def _w_expect(per_call: list, want: list, what: str, dev: str) -> None:
    """The launches the path must take on the card (none are counted on the CPU)."""
    _check(per_call == (want if dev == "cuda" else [(0, 0)] * len(want)), f"{what}: launches {per_call}, want {want}")


def _w_timed(torch, update, dev: str, iters: int = W_PROFILED) -> dict:
    """ms an update (CUDA events), device µs an update and the idle share
    (profiler). The profiler may lose a session's records (it recorded no
    device kernel in some): a session with fewer device kernels than half the
    updates is profiled again, up to 3 times, and if none has them the device
    figures are None (not measured)."""
    if dev != "cuda":
        return {}
    ms = _time_ms(update, iters, warmup=1)
    prof = _update_profile(torch, lambda _s, _b: update(), None, None, "", iters=iters)
    measured = prof["complete"]
    return {"ms_per_update": ms, "device_us_per_update": prof["device_busy_us_per_update"] if measured else None,
            "idle_share": prof["idle_share"] if measured else None,
            "device_launches_per_update": prof["launches_per_update"] if measured else None}


def _w_close(torch, got, want, what: str) -> float:
    """``_v_close`` for tensors of any shape; the largest absolute difference."""
    g, w = got.cpu().double(), want.double()
    _check(got.dtype == want.dtype and got.shape == want.shape, f"{what}: dtype/shape {got.dtype} {want.dtype}")
    _check(torch.allclose(g, w, rtol=V_RTOL, atol=V_ATOL, equal_nan=True), f"{what}: card {got} vs CPU {want}")
    diff = (g - w).abs()
    return float(diff[~diff.isnan()].max()) if bool((~diff.isnan()).any()) else 0.0


def _w_equal_states(torch, card, cpu, names, what: str) -> None:
    for name in names:
        a, b = getattr(card, name), getattr(cpu, name)
        if isinstance(a, list):
            a, b = torch.cat(a), torch.cat(b)
        _check(a.dtype == b.dtype and torch.equal(a.cpu(), b), f"{what}: state {name} differs from the CPU's")


def _w_record(torch, out: dict, key: str, err: float, launches, update, dev: str, iters: int = W_PROFILED) -> None:
    rec = {"max_abs_err_vs_cpu": err, "launches_per_update": launches, **_w_timed(torch, update, dev, iters)}
    out[key] = rec
    print(f"phase W {key} {json.dumps(rec)}")


def phase_w1(torch, np, obs, instrument, confmat, dev: str = "cuda", n: int = W_N, classes: int = W_C,
             matrix_shape=W_MATRIX) -> dict:
    """Nominal association on the card: the four modules over W_UPDATES updates
    of ``n`` int64 label pairs, each table ``torch.equal`` to the plain pair
    count of the same labels on the CPU, 1 table launch an update; the four
    functionals, 1 a call; ``cramers_v_matrix`` and ``theils_u_matrix`` over a
    (2^17, 8) matrix, D(D-1)/2 and D(D-1) launches; NaNs replaced by 0.0 and
    -1.0 and dropped. Values within (V_RTOL, V_ATOL) of the port on the CPU."""
    from metrics_tpu_torch import functional as F
    from metrics_tpu_torch import nominal
    from metrics_tpu_torch.functional.nominal.stats import _format_nominal

    rng = np.random.default_rng(19)
    cpu_batches = []
    for _ in range(W_UPDATES):
        target = rng.integers(0, classes, n)
        preds = np.where(rng.random(n) < 0.4, target, rng.integers(0, classes, n))
        cpu_batches.append((torch.from_numpy(preds), torch.from_numpy(target)))
    batches = [(p.to(dev), t.to(dev)) for p, t in cpu_batches]
    plain = sum(confmat.pair_count_bincount(p, t, classes, classes) for p, t in cpu_batches)
    out = {"metrics": {}, "launches": {"pair_count": 0, "stat_scores": 0}}
    worst = 0.0
    for name in ("CramersV", "PearsonsContingencyCoefficient", "TschuprowsT", "TheilsU"):
        m, cpu = getattr(nominal, name)(classes, device=dev), getattr(nominal, name)(classes, device="cpu")
        per = _w_counted(obs, instrument, [lambda b=b: m.update(*b) for b in batches], f"W1 {name}", dev)
        _w_expect(per, [(0, 1)] * W_UPDATES, f"W1 {name}", dev)
        out["launches"]["pair_count"] += sum(t for _, t in per)
        for b in cpu_batches:
            cpu.update(*b)
        _check(m.confmat.dtype == torch.int32 and torch.equal(m.confmat.cpu(), plain),
               f"W1 {name}: the table differs from the plain pair count")
        _check(torch.equal(cpu.confmat, plain), f"W1 {name}: the CPU table differs from the plain pair count")
        err = _w_close(torch, m.compute(), cpu.compute(), f"W1 {name}")
        worst = max(worst, err)
        _w_record(torch, out["metrics"], name, err, per[-1], lambda: m.update(*batches[0]), dev)
    for fn in ("cramers_v", "pearsons_contingency_coefficient", "tschuprows_t", "theils_u"):
        got = []
        per = _w_counted(obs, instrument, [lambda: got.append(getattr(F, fn)(*batches[0]))], f"W1 {fn}", dev)
        _w_expect(per, [(0, 1)], f"W1 {fn}", dev)
        out["launches"]["pair_count"] += per[0][1]
        err = _w_close(torch, got[0], getattr(F, fn)(*cpu_batches[0]), f"W1 {fn}")
        worst = max(worst, err)
        _w_record(torch, out["metrics"], fn, err, per[0], lambda: getattr(F, fn)(*batches[0]), dev)
    cols = matrix_shape[1]
    matrix_cpu = torch.from_numpy(rng.integers(0, W_MATRIX_CATS, matrix_shape))
    matrix = matrix_cpu.to(dev)
    for fn, pairs in (("cramers_v_matrix", cols * (cols - 1) // 2), ("theils_u_matrix", cols * (cols - 1))):
        got = []
        per = _w_counted(obs, instrument, [lambda: got.append(getattr(F, fn)(matrix))], f"W1 {fn}", dev)
        _w_expect(per, [(0, pairs)], f"W1 {fn}", dev)
        out["launches"]["pair_count"] += per[0][1]
        err = _w_close(torch, got[0], getattr(F, fn)(matrix_cpu), f"W1 {fn}")
        worst = max(worst, err)
        # one call is 28 or 56 functional calls: time and profile one, not W_PROFILED
        _w_record(torch, out["metrics"], fn, err, per[0], lambda: getattr(F, fn)(matrix), dev, iters=1)
    # one batch with NaNs: replaced by 0.0 or -1.0 (category -1: dropped by the pair count), or dropped
    p_nan, t_nan = (x.to(torch.float32) for x in cpu_batches[0])
    p_nan[torch.from_numpy(rng.random(n) < 0.05)] = float("nan")
    t_nan[torch.from_numpy(rng.random(n) < 0.05)] = float("nan")
    for key, kw in (("nan_replace_0", {"nan_replace_value": 0.0}), ("nan_replace_-1", {"nan_replace_value": -1.0}),
                    ("nan_drop", {"nan_strategy": "drop"})):
        m = nominal.CramersV(classes, device=dev, **kw)
        per = _w_counted(obs, instrument, [lambda: m.update(p_nan.to(dev), t_nan.to(dev))], f"W1 {key}", dev)
        _w_expect(per, [(0, 1)], f"W1 {key}", dev)
        out["launches"]["pair_count"] += per[0][1]
        strategy = kw.get("nan_strategy", "replace")
        want = confmat.pair_count_bincount(*_format_nominal(p_nan, t_nan, strategy, kw.get("nan_replace_value")),
                                           classes, classes)
        _check(m.confmat.dtype == torch.int32 and torch.equal(m.confmat.cpu(), want),
               f"W1 {key}: the table differs from the plain pair count")
        cpu = nominal.CramersV(classes, device="cpu", **kw)
        cpu.update(p_nan, t_nan)
        err = _w_close(torch, m.compute(), cpu.compute(), f"W1 {key}")
        err = max(err, _w_close(torch, F.cramers_v(p_nan.to(dev), t_nan.to(dev), **kw), F.cramers_v(p_nan, t_nan, **kw),
                                f"W1 {key} functional"))
        worst = max(worst, err)
        _w_record(torch, out["metrics"], key, err, per[0], lambda: m.update(p_nan.to(dev), t_nan.to(dev)), dev)
    out["max_abs_err_vs_cpu"] = worst
    return out


def _w_scores(np, rng, shape, pos_rate: float = 0.3):
    """float32 scores in [0, 1) and int32 targets that follow them."""
    scores = rng.random(shape).astype(np.float32)
    target = (rng.random(shape) < np.where(scores > 0.5, 1 - pos_rate, pos_rate)).astype(np.int32)
    return scores, target


def phase_w2(torch, np, obs, instrument, confmat, dev: str = "cuda", shapes=V_SHAPES, n: int = W_N,
             exact_mc=W_EXACT_MC, exact_ml=W_EXACT_ML) -> dict:
    """Hamming distance and exact match on the card: ``MulticlassHammingDistance``
    at V1's shapes, 1 stat-score launch an update, tp/fp/tn/fn equal to the
    plain stat scores; the binary and multilabel forms at 10^6; the flagship
    collection with a Hamming distance (the JAX package's groups, then 1
    stat-score and 1 table launch an update); exact match global and
    samplewise. States against the CPU, values within (V_RTOL, V_ATOL)."""
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch.classification import (
        BinaryHammingDistance, MulticlassExactMatch, MulticlassHammingDistance, MultilabelExactMatch,
        MultilabelHammingDistance,
    )
    from metrics_tpu_torch.entry import make_metrics

    out = {"metrics": {}, "launches": {"pair_count": 0, "stat_scores": 0}, "collection": {}}
    worst = 0.0
    counts = ("tp", "fp", "tn", "fn")
    for n_, classes, what in shapes:
        key = f"N{n_}_C{classes}"
        batches = _v_batches(torch, np, n_ + classes + 1, n_, classes, dev)
        m, cpu = MulticlassHammingDistance(classes, device=dev), MulticlassHammingDistance(classes, device="cpu")
        per = _w_counted(obs, instrument, [lambda b=b: m.update(*b) for b in batches], f"W2 hamming {key}", dev)
        _w_expect(per, [(1, 0)] * W_UPDATES, f"W2 hamming {key}", dev)
        out["launches"]["stat_scores"] += sum(s for s, _ in per)
        plain = [sum(x) for x in zip(*(confmat.stat_scores_bincount(t.cpu(), p.cpu(), classes) for p, t in batches))]
        for name, want in zip(counts, plain):
            _check(getattr(m, name).dtype == torch.int32 and torch.equal(getattr(m, name).cpu(), want.to(torch.int32)),
                   f"W2 hamming {key}: {name} differs from the plain stat scores")
        for p, t in batches:
            cpu.update(p.cpu(), t.cpu())
        err = _w_close(torch, m.compute(), cpu.compute(), f"W2 hamming {key}")
        worst = max(worst, err)
        _w_record(torch, out["metrics"], f"hamming_{key}", err, per[-1], lambda: m.update(*batches[0]), dev)

        # the flagship's metrics (bench.py's arguments) with a Hamming distance, in one collection
        metrics = make_metrics(classes, device=dev)
        metrics["hamming"] = MulticlassHammingDistance(classes, validate_args=False, device=dev)
        col = MetricCollection(metrics)
        built = {k: list(v) for k, v in col.compute_groups.items()}
        _check(built == W_FLAGSHIP_GROUPS_BUILT, f"W2 {key}: groups at construction {built}")
        per = _w_counted(obs, instrument, [lambda b=b: col.update(*b) for b in batches], f"W2 collection {key}", dev)
        _w_expect(per, [(len(built) - 1, 1)] + [(1, 1)] * (W_UPDATES - 1), f"W2 collection {key}", dev)
        groups = {k: list(v) for k, v in col.compute_groups.items()}
        _check(groups == W_FLAGSHIP_GROUPS, f"W2 {key}: groups {groups}, the JAX package forms {W_FLAGSHIP_GROUPS}")
        out["launches"]["stat_scores"] += sum(s for s, _ in per)
        out["launches"]["pair_count"] += sum(t for _, t in per)
        for name, want in zip(counts, plain):
            _check(torch.equal(getattr(col["hamming"], name).cpu(), want.to(torch.int32)),
                   f"W2 {key}: the collection's {name} differs from the plain stat scores")
        worst = max(worst, _w_close(torch, col.compute()["hamming"], cpu.compute(), f"W2 collection {key}"))
        rec = {"groups": groups, "built": built, "launches_per_update": per[1:], "launches_forming_update": per[0],
               **_w_timed(torch, lambda: col.update(*batches[0]), dev)}
        out["collection"][key] = rec
        print(f"phase W2 collection {key} {json.dumps(rec)}")

    rng = np.random.default_rng(20)
    scores, target = _w_scores(np, rng, n)
    ml_shape = (n // W_C, W_C)
    forms = {"binary_hamming": (lambda d: BinaryHammingDistance(device=d), (scores, target)),
             "multilabel_hamming": (lambda d: MultilabelHammingDistance(W_C, device=d),
                                    (scores.reshape(ml_shape), target.reshape(ml_shape)))}
    ml_scores, ml_target = _w_scores(np, rng, exact_ml)
    ml_scores = np.where(rng.random(exact_ml) < 0.9, ml_target, ml_scores).astype(np.float32)  # some rows all right
    mc_target = rng.integers(0, exact_mc[2], exact_mc[:2])
    mc_preds = mc_target.copy()
    wrong = rng.random(exact_mc[0]) < 0.5
    mc_preds[wrong, rng.integers(0, exact_mc[1], int(wrong.sum()))] += 1  # one position off in half the samples
    mc_preds %= exact_mc[2]
    for mda in ("global", "samplewise"):
        forms[f"multiclass_exact_match_{mda}"] = (
            lambda d, mda=mda: MulticlassExactMatch(exact_mc[2], multidim_average=mda, device=d), (mc_preds, mc_target))
    forms["multilabel_exact_match"] = (lambda d: MultilabelExactMatch(exact_ml[1], device=d), (ml_scores, ml_target))
    for name, (make, arrays) in forms.items():
        card, cpu = make(dev), make("cpu")
        args = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        per = _w_counted(obs, instrument, [lambda: card.update(*args)], f"W2 {name}", dev)
        _w_expect(per, [(0, 0)], f"W2 {name}", dev)  # plain torch counts: no hand kernel
        cpu.update(*(torch.from_numpy(a) for a in arrays))
        _w_equal_states(torch, card, cpu, list(card._defaults), f"W2 {name}")
        err = _w_close(torch, card.compute(), cpu.compute(), f"W2 {name}")
        worst = max(worst, err)
        _w_record(torch, out["metrics"], name, err, per[0], lambda: card.update(*args), dev)
    out["max_abs_err_vs_cpu"] = worst
    return out


def phase_w3(torch, np, obs, instrument, dev: str = "cuda", n: int = W_N, classes: int = W_C,
             rank_shape=W_RANK) -> dict:
    """Calibration, hinge and ranking on the card: binary calibration on 10^6
    scores with the 16 bin edges among them (the int32-valued bins equal to the
    CPU's bit for bit), multiclass at (10^6, 100); binary and multiclass hinge
    (both modes, squared or not); the three ranking metrics at (2^15, 100).
    Plain torch code: no hand kernel is launched."""
    from metrics_tpu_torch.classification import (
        BinaryCalibrationError, BinaryHingeLoss, MulticlassCalibrationError, MulticlassHingeLoss,
        MultilabelCoverageError, MultilabelRankingAveragePrecision, MultilabelRankingLoss,
    )
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _linspace01

    rng = np.random.default_rng(21)
    scores, target = _w_scores(np, rng, n)
    scores[:16] = _linspace01(16).numpy()  # the bin edges of n_bins = 15, as jnp.linspace gives them
    logits = rng.normal(0.0, 2.0, (n, classes)).astype(np.float32)
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs = (probs / probs.sum(1, keepdims=True)).astype(np.float32)  # rows summing to 1: no softmax on either side
    mc_target = np.where(rng.random(n) < 0.4, probs.argmax(1), rng.integers(0, classes, n)).astype(np.int64)
    rank_scores, rank_target = _w_scores(np, rng, rank_shape)
    forms = {
        "binary_calibration": (lambda d: BinaryCalibrationError(n_bins=15, device=d), (scores, target)),
        "multiclass_calibration": (lambda d: MulticlassCalibrationError(classes, n_bins=15, device=d),
                                   (probs, mc_target)),
        "binary_hinge": (lambda d: BinaryHingeLoss(device=d), (scores, target)),
        "binary_hinge_squared": (lambda d: BinaryHingeLoss(squared=True, device=d), (scores, target)),
        "multiclass_hinge_crammer_singer": (lambda d: MulticlassHingeLoss(classes, device=d), (logits, mc_target)),
        "multiclass_hinge_one_vs_all": (
            lambda d: MulticlassHingeLoss(classes, multiclass_mode="one-vs-all", device=d), (logits, mc_target)),
        "multiclass_hinge_squared": (lambda d: MulticlassHingeLoss(classes, squared=True, device=d),
                                     (logits, mc_target)),
        "coverage_error": (lambda d: MultilabelCoverageError(rank_shape[1], device=d), (rank_scores, rank_target)),
        "ranking_average_precision": (lambda d: MultilabelRankingAveragePrecision(rank_shape[1], device=d),
                                      (rank_scores, rank_target)),
        "ranking_loss": (lambda d: MultilabelRankingLoss(rank_shape[1], device=d), (rank_scores, rank_target)),
    }
    out = {"metrics": {}}
    worst = 0.0
    for name, (make, arrays) in forms.items():
        card, cpu = make(dev), make("cpu")
        args = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        per = _w_counted(obs, instrument, [lambda: card.update(*args)], f"W3 {name}", dev)
        _w_expect(per, [(0, 0)], f"W3 {name}", dev)
        cpu.update(*(torch.from_numpy(a) for a in arrays))
        if "calibration" in name:  # counts and 0/1 accuracy sums are integers below 2^24: exact in any order
            _w_equal_states(torch, card, cpu, ("count_bin", "acc_bin"), f"W3 {name}")
            worst = max(worst, _w_close(torch, card.conf_bin, cpu.conf_bin, f"W3 {name} conf_bin"))
        else:
            for key in card._defaults:
                worst = max(worst, _w_close(torch, getattr(card, key), getattr(cpu, key), f"W3 {name} {key}"))
        err = _w_close(torch, card.compute(), cpu.compute(), f"W3 {name}")
        worst = max(worst, err)
        _w_record(torch, out["metrics"], name, err, per[0], lambda: card.update(*args), dev)
    out["edges_binned_like_the_cpu"] = True
    out["max_abs_err_vs_cpu"] = worst
    return out


def phase_w4(torch, np, obs, instrument, dev: str = "cuda", n: int = W_N, classes: int = W_C,
             mdmc_shape=W_DICE_MDMC) -> dict:
    """Dice on the card through the legacy formatter: micro and macro on
    (10^6, 100) scores, samplewise on (N, C, X) scores; int32 counts (list
    states samplewise) equal to the CPU's, values within (V_RTOL, V_ATOL)."""
    from metrics_tpu_torch.classification import Dice

    rng = np.random.default_rng(22)
    scores = rng.random((n, classes)).astype(np.float32)
    target = np.where(rng.random(n) < 0.5, scores.argmax(1), rng.integers(0, classes, n)).astype(np.int64)
    mdmc = rng.random(mdmc_shape).astype(np.float32)
    mdmc_target = np.where(rng.random((mdmc_shape[0], mdmc_shape[2])) < 0.5, mdmc.argmax(1),
                           rng.integers(0, classes, (mdmc_shape[0], mdmc_shape[2]))).astype(np.int64)
    forms = {
        "dice_micro": (lambda d: Dice(device=d), (scores, target)),
        "dice_macro": (lambda d: Dice(average="macro", num_classes=classes, device=d), (scores, target)),
        "dice_samplewise": (lambda d: Dice(mdmc_average="samplewise", num_classes=classes, device=d),
                            (mdmc, mdmc_target)),
    }
    out = {"metrics": {}}
    worst = 0.0
    for name, (make, arrays) in forms.items():
        card, cpu = make(dev), make("cpu")
        args = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        per = _w_counted(obs, instrument, [lambda: card.update(*args)], f"W4 {name}", dev)
        _w_expect(per, [(0, 0)], f"W4 {name}", dev)
        cpu.update(*(torch.from_numpy(a) for a in arrays))
        _w_equal_states(torch, card, cpu, ("tp", "fp", "tn", "fn"), f"W4 {name}")
        err = _w_close(torch, card.compute(), cpu.compute(), f"W4 {name}")
        worst = max(worst, err)
        _w_record(torch, out["metrics"], name, err, per[0], lambda: card.update(*args), dev)
    out["max_abs_err_vs_cpu"] = worst
    return out


def phase_w(torch, np, obs, instrument, confmat, dev: str = "cuda", **sizes) -> dict:
    """The rest of classification and the nominal metrics on the card (W1-W4)."""
    t0 = time.perf_counter()
    out = {}
    for key, phase, kw in (("W1", phase_w1, ("n", "classes", "matrix_shape")),
                           ("W2", phase_w2, ("shapes", "n", "exact_mc", "exact_ml")),
                           ("W3", phase_w3, ("n", "classes", "rank_shape")),
                           ("W4", phase_w4, ("n", "classes", "mdmc_shape"))):
        t1 = time.perf_counter()
        args = (torch, np, obs, instrument, confmat) if key in ("W1", "W2") else (torch, np, obs, instrument)
        out[key] = phase(*args, dev=dev, **{k: v for k, v in sizes.items() if k in kw})
        out[key]["seconds"] = time.perf_counter() - t1
        print(f"phase {key}: {out[key]['seconds']:.1f} s")
    out["launches"] = {route: sum(out[k].get("launches", {}).get(route, 0) for k in ("W1", "W2")) for route in ROUTES}
    out["max_abs_err_vs_cpu"] = max(out[k]["max_abs_err_vs_cpu"] for k in ("W1", "W2", "W3", "W4"))
    out["seconds"] = time.perf_counter() - t0
    print(f"phase W: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------- Phase X: regression, pairwise, retrieval

X_N = 10**6  # scalar pairs an update (X1); values of X2's Tweedie and Spearman
X_UPDATES = 4
X_OUTPUTS = 8  # the multioutput case's columns
X_R2_ADJUSTED = 5
X_COSINE = (2**16, 512)  # rows x width, in two batches
X_KL = (2**16, 1000)
X_TWEEDIE_POWERS = (0.0, 1.0, 1.5, 2.0, 3.0)
X_KENDALL_N = 2**15
X_KENDALL_CPU_N = 2**12  # the CPU's grid (2^15 there took ~7 s): counts and the three variants' values
X_PAIRWISE = (4096, 512)
X_MANHATTAN = (2048, 256)
X_PRODUCT_ATOL = 1e-4  # linear and manhattan entries: sums of 256-512 products of order 1 in another order
X_MERGE_RTOL, X_MERGE_ATOL = 1e-4, 1e-5  # the parallel Welford merge against the sequential update
X_QUERIES = 10**4
X_CANDIDATES = 100  # documents a query: 10^6 in all, over X_UPDATES updates
X_EMPTY_SHARE = 0.05  # queries with no positive
X_ENGINE_REQUESTS = 2000  # K6's traffic shape at this depth
X_ENGINE_NAIVE = 300


def _x_card_only(torch, fn, what: str, dev: str, need_ops: bool = True, allow=()):
    """``fn()``, failing if any op in it but those named in ``allow`` returned
    a CPU tensor of more than one element (the data and every intermediate
    stay on the card; a host read of a scalar, or a scalar copied to the card,
    is allowed) and, with ``need_ops``, if no op in it ran on the card. Not
    checked on the CPU."""
    if dev != "cuda":
        return fn()
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    found, on_card = [], [0]

    class _Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            tensors = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
            found.extend(str(func) for t in tensors if t.device.type == "cpu" and t.numel() > 1
                         and str(func) not in allow)
            on_card[0] += any(t.is_cuda for t in tensors)
            return out

    with _Watch():
        result = fn()
    _check(not found, f"{what}: ops returned CPU tensors on the card's path: {sorted(set(found))[:6]}")
    _check(on_card[0] > 0 or not need_ops, f"{what}: no op ran on the card")
    return result


def _x_close(torch, got, want, what: str, rtol: float = V_RTOL, atol: float = V_ATOL) -> float:
    """The card's value (or tuple of values) against the CPU's: dtype and shape
    equal, within (rtol, atol). Returns the share of the tolerance used, the
    largest ``|card - cpu| / (atol + rtol |cpu|)`` (0: equal; at most 1)."""
    if isinstance(want, tuple):
        _check(isinstance(got, tuple) and len(got) == len(want), f"{what}: {type(got)} vs a tuple")
        return max(_x_close(torch, g, w, f"{what}[{i}]", rtol, atol) for i, (g, w) in enumerate(zip(got, want)))
    _check(got.dtype == want.dtype and got.shape == want.shape,
           f"{what}: dtype/shape {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    g, w = got.cpu().double(), want.cpu().double()
    _check(torch.allclose(g, w, rtol=rtol, atol=atol, equal_nan=True), f"{what}: card {got} vs CPU {want}")
    share = (g - w).abs() / (atol + rtol * w.abs())
    share = share[~share.isnan()]
    return float(share.max()) if share.numel() else 0.0


def _x_states(torch, card, cpu, what: str, rtol: float = V_RTOL, atol: float = V_ATOL) -> float:
    """Every state of ``card`` against ``cpu``'s (list states concatenated)."""
    worst = 0.0
    for name in cpu._defaults:
        a, b = getattr(card, name), getattr(cpu, name)
        if isinstance(a, list):
            a, b = torch.cat(a), torch.cat(b)
        worst = max(worst, _x_close(torch, a, b, f"{what} state {name}", rtol, atol))
    return worst


X_MARKER_CYCLES = 200_000  # a window marker's spin: ~100 µs at 1.98 GHz, against ~2 µs for a lead-in spin
X_MARKER_MIN_US = 20.0
X_PROFILE_SESSIONS = 3


def _x_profile_session(torch, calls: dict):
    """One profiler session over ``calls``: ``(window marker starts, device
    events sorted by start, wall µs of each window)``. A warm-up cycle of 128
    spin kernels, recorded and discarded, and 128 more at the head of the
    active cycle take a session's first records, which whole runs of this
    script lose (about 60; once more than 129). A long spin kernel
    (``X_MARKER_CYCLES``) before each window marks where it starts: the
    markers are told from the lead-ins by their device time, so a lost
    lead-in moves no window."""
    from torch.profiler import ProfilerActivity, profile, schedule

    walls, cycles = {}, []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: cycles.append(p.events())) as prof:
        for _ in range(128):
            torch.cuda._sleep(64)
        torch.cuda.synchronize()
        prof.step()  # the warm-up cycle ends; the active one records
        for _ in range(128):
            torch.cuda._sleep(64)
        for key, (call, iters) in calls.items():
            torch.cuda._sleep(X_MARKER_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
            walls[key] = (time.perf_counter() - t0) * 1e6
        prof.step()
    events = sorted((e for e in cycles[-1] if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in events
              if "spin_kernel" in e.name and e.time_range.elapsed_us() >= X_MARKER_MIN_US]
    return starts, events, walls


def _x_profile(torch, calls: dict) -> dict:
    """Device µs, device kernels and idle share an update of each entry of
    ``calls`` (key -> (zero-argument call, calls timed)), all in one profiler
    session (a session's set-up and teardown cost seconds in a whole run);
    a session that lost a window's marker is profiled again, up to
    ``X_PROFILE_SESSIONS`` sessions, and the figures say how many it took."""
    import bisect

    for session in range(1, X_PROFILE_SESSIONS + 1):
        starts, events, walls = _x_profile_session(torch, calls)
        if len(starts) == len(calls):
            break
        print(f"profile session {session}: {len(starts)} window markers for {len(calls)} windows")
    _check(len(starts) == len(calls),
           f"the profile holds {len(starts)} window markers for {len(calls)} windows in {session} sessions")
    spans = [[] for _ in calls]
    for e in events:
        if "spin_kernel" not in e.name and e.time_range.start >= starts[0]:
            spans[bisect.bisect_right(starts, e.time_range.start) - 1].append((e.time_range.start, e.time_range.end))
    busy = [_busy_us(s) for s in spans]
    return {key: {"device_us_per_update": b / iters, "idle_share": 1.0 - b / walls[key],
                  "device_launches_per_update": len(s) / iters, "profile_sessions": session}
            for (key, (_, iters)), s, b in zip(calls.items(), spans, busy)}


def _busy_us(spans) -> float:
    """µs covered by the union of ``spans`` (start, end): kernels that overlap
    count once (cuDNN's and cuBLAS's kernels on Hopper may start before their
    predecessor on the stream ends, programmatic dependent launch, and a sum
    of their durations then exceeds the window's wall time)."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def _x_record(torch, out: dict, key: str, err, update, dev: str, profiled: str = "update",
              profile: bool = True, iters: int = W_PROFILED, **extra) -> None:
    """ms an update (CUDA events) of ``update``, the call that does the
    metric's work on the card (``profiled`` names it); with ``profile`` (one
    form of each metric) the call waits in ``out["_profile"]`` for
    ``_x_finish``. ``extra`` joins the record."""
    rec = {"tolerance_share_vs_cpu": err, "profiled": profiled if profile else None, **extra}
    if dev == "cuda":
        rec["ms_per_update"] = _time_ms(update, iters, warmup=1)
        if profile:
            out.setdefault("_profile", {})[key] = (update, iters)
    out[key] = rec


def _x_finish(torch, out: dict, what: str) -> None:
    """Profile the calls ``_x_record`` left in ``out`` in one session, join
    their device figures to their records (each profile must hold device
    kernels), and print every record."""
    calls = out.pop("_profile", {})
    if calls:
        for key, figures in _x_profile(torch, calls).items():
            _check(figures["device_launches_per_update"] > 0, f"{what} {key}: the profiled call ran no device kernel")
            out[key].update(figures)
    for key, rec in out.items():
        print(f"phase {what} {key} {json.dumps(rec)}")


def _x_signed(np, rng, shape):
    """float32 targets around 2 and predictions that follow them (R² ~0.6)."""
    target = rng.normal(2.0, 1.0, shape).astype(np.float32)
    return (0.8 * target + rng.normal(0.0, 0.5, shape)).astype(np.float32), target


def phase_x1(torch, np, dev: str = "cuda", n: int = X_N, outputs: int = X_OUTPUTS) -> dict:
    """The moment metrics on the card: Pearson, concordance, R² (adjusted = 5)
    and explained variance over X_UPDATES updates of ``n`` scalar pairs, and
    their ``(n, outputs)`` forms; every state and value against the port on the
    CPU, within (V_RTOL, V_ATOL). Pearson merged from two halves through the
    stacked ``_final_aggregation`` route equals one metric fed the whole."""
    from metrics_tpu_torch import regression as R
    from metrics_tpu_torch.regression.moments import _final_aggregation

    rng = np.random.default_rng(20)
    cpu_batches = {cols: [tuple(torch.from_numpy(a) for a in _x_signed(np, rng, (n,) if cols == 1 else (n, cols)))
                          for _ in range(X_UPDATES)] for cols in (1, outputs)}
    forms = {
        "pearson": (lambda d: R.PearsonCorrCoef(device=d), 1),
        "concordance": (lambda d: R.ConcordanceCorrCoef(device=d), 1),
        "r2_adjusted": (lambda d: R.R2Score(adjusted=X_R2_ADJUSTED, device=d), 1),
        "explained_variance": (lambda d: R.ExplainedVariance(device=d), 1),
        f"pearson_{outputs}": (lambda d: R.PearsonCorrCoef(num_outputs=outputs, device=d), outputs),
        f"concordance_{outputs}": (lambda d: R.ConcordanceCorrCoef(num_outputs=outputs, device=d), outputs),
        f"r2_{outputs}_raw": (lambda d: R.R2Score(num_outputs=outputs, multioutput="raw_values", device=d), outputs),
        f"explained_variance_{outputs}_weighted":
            (lambda d: R.ExplainedVariance(multioutput="variance_weighted", device=d), outputs),
    }
    out = {"metrics": {}}
    worst = 0.0
    for key, (make, cols) in forms.items():
        card, cpu = make(dev), make("cpu")
        batches = [tuple(a.to(dev) for a in b) for b in cpu_batches[cols]]
        _x_card_only(torch, lambda: card.update(*batches[0]), f"X1 {key} update", dev)
        for b in batches[1:]:
            card.update(*b)
        for b in cpu_batches[cols]:
            cpu.update(*b)
        err = _x_states(torch, card, cpu, f"X1 {key}")
        value = _x_card_only(torch, card.compute, f"X1 {key} compute", dev)
        err = max(err, _x_close(torch, value, cpu.compute(), f"X1 {key}"))
        worst = max(worst, err)
        _x_record(torch, out["metrics"], key, err, lambda card=card, b=batches[0]: card.update(*b), dev,
                  profile=cols == 1)
    # two replicas' Welford states stacked (a sync's dist_reduce_fx=None gather), merged
    names = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")
    whole, halves = R.PearsonCorrCoef(device=dev), [R.PearsonCorrCoef(device=dev) for _ in range(2)]
    for i, b in enumerate(cpu_batches[1]):
        b = tuple(a.to(dev) for a in b)
        whole.update(*b)
        halves[i * 2 // X_UPDATES].update(*b)
    stacked = [torch.stack([getattr(m, k) for m in halves]) for k in names]
    merged = _final_aggregation(*stacked)
    merge_err = max(_x_close(torch, got, getattr(whole, k), f"X1 merged {k}", X_MERGE_RTOL, X_MERGE_ATOL)
                    for k, got in zip(names, merged))
    synced = R.PearsonCorrCoef(device=dev)
    for k, v in zip(names, stacked):
        setattr(synced, k, v)
    synced._update_called = True
    merge_err = max(merge_err, _x_close(torch, synced.compute(), whole.compute(), "X1 merged compute",
                                        X_MERGE_RTOL, X_MERGE_ATOL))
    _x_finish(torch, out["metrics"], "X1")
    out["pearson_merge_tolerance_share"] = merge_err
    out["tolerance_share_vs_cpu"] = worst
    return out


def phase_x2(torch, np, dev: str = "cuda", cosine=X_COSINE, kl=X_KL, n: int = X_N, kendall_n: int = X_KENDALL_N,
             kendall_cpu_n: int = X_KENDALL_CPU_N) -> dict:
    """Cosine similarity, KL divergence, Tweedie deviance, Spearman's and
    Kendall's rank correlations on the card, against the port on the CPU.
    Spearman's ranks equal the CPU's bit for bit. Kendall's three variants
    with ``t_test`` run at ``kendall_n`` on the card; on the first
    ``kendall_cpu_n`` pairs its counts equal the CPU's exactly and its values
    are held against the CPU's."""
    from metrics_tpu_torch import regression as R
    from metrics_tpu_torch.functional import regression as F
    from metrics_tpu_torch.functional.regression.misc import _kendall_counts, _rank_data

    rng = np.random.default_rng(21)
    out = {"metrics": {}}
    worst = 0.0

    def run(key, card, cpu, cpu_batches, profiled=None, work=None, profile=True, rtol=V_RTOL, atol=V_ATOL):
        nonlocal worst
        batches = [tuple(a.to(dev) for a in b) for b in cpu_batches]
        _x_card_only(torch, lambda: card.update(*batches[0]), f"X2 {key} update", dev, need_ops=work is None)
        for b in batches[1:]:
            card.update(*b)
        for b in cpu_batches:
            cpu.update(*b)
        err = _x_states(torch, card, cpu, f"X2 {key}", rtol, atol)
        value = _x_card_only(torch, card.compute, f"X2 {key} compute", dev)
        err = max(err, _x_close(torch, value, cpu.compute(), f"X2 {key}", rtol, atol))
        worst = max(worst, err)
        if work is None:
            _x_record(torch, out["metrics"], key, err, lambda: card.update(*batches[0]), dev, profile=profile)
        else:  # a list-state update appends; its compute does the work
            _x_record(torch, out["metrics"], key, err, lambda: work(*[torch.cat(c) for c in zip(*batches)]), dev,
                      profiled, profile)
            out["metrics"][key]["update_ms"] = _time_ms(lambda: card.update(*batches[0]), 3, 1) if dev == "cuda" \
                else None
        return batches

    # cosine similarity, two batches of (rows / 2, width)
    half = cosine[0] // 2
    cos = [tuple(torch.from_numpy(a) for a in _x_signed(np, rng, (half, cosine[1]))) for _ in range(2)]
    run("cosine_similarity", R.CosineSimilarity(device=dev), R.CosineSimilarity(device="cpu"), cos,
        "compute (the functional on the sample)", F.cosine_similarity)
    del cos
    # KL divergence, probabilities and log-probabilities
    p = rng.random(kl).astype(np.float32) + 0.01
    q = rng.random(kl).astype(np.float32) + 0.01
    p /= p.sum(-1, keepdims=True)
    q /= q.sum(-1, keepdims=True)
    run("kl_divergence", R.KLDivergence(device=dev), R.KLDivergence(device="cpu"),
        [(torch.from_numpy(p), torch.from_numpy(q))])
    run("kl_divergence_log_prob", R.KLDivergence(log_prob=True, device=dev),
        R.KLDivergence(log_prob=True, device="cpu"), [(torch.from_numpy(np.log(p)), torch.from_numpy(np.log(q)))],
        profile=False)
    del p, q
    # Tweedie deviance at each power, positive values
    tw = tuple(torch.from_numpy((rng.random(n) * 3 + 0.1).astype(np.float32)) for _ in range(2))
    for power in X_TWEEDIE_POWERS:
        run(f"tweedie_{power}", R.TweedieDevianceScore(power=power, device=dev),
            R.TweedieDevianceScore(power=power, device="cpu"), [tw], profile=power == 1.5)
    # Spearman with ties: scores on a grid of 4096 values
    sp_t = (rng.integers(0, 4096, n) / 4096).astype(np.float32)
    sp_p = (np.rint((0.7 * sp_t + 0.3 * rng.random(n)) * 4096) / 4096).astype(np.float32)
    sp = [(torch.from_numpy(sp_p), torch.from_numpy(sp_t))]
    card_sp = run("spearman", R.SpearmanCorrCoef(device=dev), R.SpearmanCorrCoef(device="cpu"), sp,
                  "compute (the functional on the sample)", F.spearman_corrcoef)
    for i, name in enumerate(("preds", "target")):
        _check(torch.equal(_rank_data(card_sp[0][i]).cpu(), _rank_data(sp[0][i])),
               f"X2 spearman: the {name}' ranks differ from the CPU's")
    out["spearman_ranks_equal"] = True
    # Kendall: the card at kendall_n; counts and values against the CPU's on the first kendall_cpu_n pairs
    kt = (rng.integers(0, 2048, kendall_n) / 2048).astype(np.float32)
    kp = (np.rint((0.6 * kt + 0.4 * rng.random(kendall_n)) * 2048) / 2048).astype(np.float32)
    kx, ky = torch.from_numpy(kp), torch.from_numpy(kt)
    counts = _kendall_counts(kx[:kendall_cpu_n].to(dev), ky[:kendall_cpu_n].to(dev))
    cpu_counts = _kendall_counts(kx[:kendall_cpu_n], ky[:kendall_cpu_n])
    _check(counts.dtype == torch.int64 and torch.equal(counts.cpu(), cpu_counts),
           f"X2 kendall: counts {counts.tolist()} vs the CPU's {cpu_counts.tolist()}")
    out["kendall_counts"] = {"n": kendall_cpu_n, "concordant_discordant_ties": counts.tolist()}
    for variant, alternative in (("a", "two-sided"), ("b", "less"), ("c", "greater")):
        kw = {"variant": variant, "t_test": True, "alternative": alternative}
        key = f"kendall_{variant}"
        small = [(kx[:kendall_cpu_n], ky[:kendall_cpu_n])]
        run(f"{key}_n{kendall_cpu_n}", R.KendallRankCorrCoef(**kw, device=dev),
            R.KendallRankCorrCoef(**kw, device="cpu"), small, "compute (the functional on the sample)",
            lambda a, b, kw=kw: F.kendall_rank_corrcoef(a, b, **kw), profile=False)
        card = R.KendallRankCorrCoef(**kw, device=dev)
        card.update(kx.to(dev), ky.to(dev))
        tau, p_value = _x_card_only(torch, card.compute, f"X2 {key} compute", dev)
        _check(bool(torch.isfinite(tau)) and -1 <= float(tau) <= 1 and 0 <= float(p_value) <= 1,
               f"X2 {key} at N={kendall_n}: tau {tau}, p {p_value}")
        kxd, kyd = kx.to(dev), ky.to(dev)
        _x_record(torch, out["metrics"], f"{key}_n{kendall_n}", None,  # no CPU reference at this N
                  lambda kw=kw: F.kendall_rank_corrcoef(kxd, kyd, **kw), dev, "compute (the functional)",
                  profile=variant == "b", iters=2, n=kendall_n, tau=float(tau), p_value=float(p_value))
    _x_finish(torch, out["metrics"], "X2")
    out["tolerance_share_vs_cpu"] = worst
    return out


def phase_x3(torch, np, dev: str = "cuda", shape=X_PAIRWISE, manhattan=X_MANHATTAN) -> dict:
    """The four pairwise functionals on the card on ``shape`` x ``shape``
    (manhattan on ``manhattan``), and self mode, against the CPU: cosine and
    euclidean (the float64 expansion) within (V_RTOL, V_ATOL), linear and
    manhattan within (V_RTOL, X_PRODUCT_ATOL)."""
    from metrics_tpu_torch.functional import pairwise as P

    rng = np.random.default_rng(22)
    out = {"metrics": {}}
    worst = 0.0
    for kind in ("cosine_similarity", "euclidean_distance", "linear_similarity", "manhattan_distance"):
        fn = getattr(P, f"pairwise_{kind}")
        size = manhattan if kind == "manhattan_distance" else shape
        x, y = (torch.from_numpy(rng.normal(size=size).astype(np.float32)) for _ in range(2))
        xd, yd = x.to(dev), y.to(dev)
        atol = X_PRODUCT_ATOL if kind in ("linear_similarity", "manhattan_distance") else V_ATOL
        for mode, args, cpu_args in (("", (xd, yd), (x, y)), ("_self", (xd,), (x,))):
            key = f"{kind}{mode}"
            got = _x_card_only(torch, lambda: fn(*args), f"X3 {key}", dev)
            if mode:
                _check(bool((torch.diagonal(got) == 0).all()), f"X3 {key}: the diagonal is not 0")
            err = _x_close(torch, got, fn(*cpu_args), f"X3 {key}", V_RTOL, atol)
            worst = max(worst, err)
            _x_record(torch, out["metrics"], key, err, lambda fn=fn, args=args: fn(*args), dev, "call",
                      profile=not mode)
    _x_finish(torch, out["metrics"], "X3")
    out["tolerance_share_vs_cpu"] = worst
    return out


def _x_retrieval_data(np, rng, queries: int, candidates: int, graded: bool = False):
    """``queries`` x ``candidates`` documents, shuffled: float32 scores on a grid
    of 64 values (ties), relevance binary (or 0-3) and X_EMPTY_SHARE of the
    queries with no positive; int64 query ids."""
    n = queries * candidates
    idx = np.repeat(np.arange(queries, dtype=np.int64), candidates)
    preds = (rng.integers(0, 64, n) / 64).astype(np.float32)
    target = rng.integers(0, 4, n) if graded else (rng.random(n) < np.where(preds > 0.5, 0.3, 0.05)).astype(np.int64)
    target[np.isin(idx, np.arange(int(queries * X_EMPTY_SHARE)))] = 0
    order = rng.permutation(n)
    return preds[order], target[order], idx[order]


def phase_x4(torch, np, dev: str = "cuda", queries: int = X_QUERIES, candidates: int = X_CANDIDATES) -> dict:
    """The ten retrieval classes on the card over X_UPDATES updates of
    ``queries`` x ``candidates`` documents (ties, empty queries), each
    ``empty_target_action`` and ``ignore_index``, nDCG on graded targets too,
    against the CPU; "error" raises on the card."""
    from metrics_tpu_torch import retrieval as RT

    rng = np.random.default_rng(23)
    binary = _x_retrieval_data(np, rng, queries, candidates)
    graded = _x_retrieval_data(np, rng, queries, candidates, graded=True)
    ignored = list(binary)
    ignored[1] = np.where(rng.random(ignored[1].shape[0]) < 0.1, -100, ignored[1])

    def split(data):
        parts = [np.array_split(a, X_UPDATES) for a in data]
        return [tuple(torch.from_numpy(np.ascontiguousarray(p[i])) for p in parts) for i in range(X_UPDATES)]

    data = {"binary": split(binary), "graded": split(graded), "ignored": split(ignored)}
    forms = [("RetrievalMAP", {}, "binary"), ("RetrievalMRR", {}, "binary"),
             ("RetrievalPrecision", {"k": 10}, "binary"),
             ("RetrievalPrecision", {"k": 200, "adaptive_k": True}, "binary"),
             ("RetrievalRecall", {"k": 10}, "binary"), ("RetrievalFallOut", {"k": 10}, "binary"),
             ("RetrievalHitRate", {"k": 5}, "binary"), ("RetrievalRPrecision", {}, "binary"),
             ("RetrievalNormalizedDCG", {"k": 10}, "binary"), ("RetrievalNormalizedDCG", {}, "graded"),
             ("RetrievalPrecisionRecallCurve", {"max_k": 20}, "binary"),
             ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.2, "max_k": 20}, "binary")]
    forms += [("RetrievalMAP", {"empty_target_action": a}, "binary") for a in ("pos", "skip")]
    forms += [("RetrievalPrecisionRecallCurve", {"max_k": 10, "empty_target_action": a}, "binary")
              for a in ("pos", "skip")]
    forms += [("RetrievalMRR", {"ignore_index": -100}, "ignored"), ("RetrievalNormalizedDCG", {"ignore_index": -100},
                                                                    "ignored")]
    out = {"metrics": {}, "documents": queries * candidates}
    worst = 0.0
    profiled_classes = set()  # the first form of each class is profiled, its update timed
    for cls, kw, which in forms:
        key = "_".join([cls] + [f"{k}={v}" for k, v in kw.items()] + ([which] if which != "binary" else []))
        card, cpu = getattr(RT, cls)(**kw, device=dev), getattr(RT, cls)(**kw, device="cpu")
        batches = [tuple(a.to(dev) for a in b) for b in data[which]]
        for b, cb in zip(batches, data[which]):
            card.update(*b[:2], indexes=b[2])
            cpu.update(*cb[:2], indexes=cb[2])
        err = _x_states(torch, card, cpu, f"X4 {key}")
        t0 = time.perf_counter()
        value = _x_card_only(torch, card.compute, f"X4 {key} compute", dev)
        compute_ms = (time.perf_counter() - t0) * 1e3
        err = max(err, _x_close(torch, value, cpu.compute(), f"X4 {key}"))
        worst = max(worst, err)
        profile = cls not in profiled_classes
        profiled_classes.add(cls)
        extra = {"compute_ms_first": compute_ms}
        if dev == "cuda" and profile:
            timed = getattr(RT, cls)(**kw, device=dev)  # updates timed on their own instance
            extra["update_ms"] = _time_ms(lambda: timed.update(*batches[0][:2], indexes=batches[0][2]), 3, 1)
        _x_record(torch, out["metrics"], key, err, lambda card=card: (setattr(card, "_computed", None), card.compute()),
                  dev, "compute", profile=profile, iters=2, **extra)
    _x_finish(torch, out["metrics"], "X4")
    # "error" raises on the card while a query has no positive, and computes without one
    card = RT.RetrievalMAP(empty_target_action="error", device=dev)
    for b in data["binary"]:
        card.update(b[0].to(dev), b[1].to(dev), indexes=b[2].to(dev))
    try:
        card.compute()
        raise AssertionError("X4: empty_target_action='error' did not raise on the card")
    except ValueError as exc:
        _check("no positive target" in str(exc), f"X4 error action: {exc}")
    keep = (np.bincount(binary[2], weights=binary[1], minlength=queries) > 0)[binary[2]]  # queries with a positive
    card = RT.RetrievalMAP(empty_target_action="error", device=dev)
    cpu = RT.RetrievalMAP(empty_target_action="error", device="cpu")
    cols = [torch.from_numpy(np.ascontiguousarray(a[keep])) for a in binary]
    card.update(cols[0].to(dev), cols[1].to(dev), indexes=cols[2].to(dev))
    cpu.update(*cols[:2], indexes=cols[2])
    worst = max(worst, _x_close(torch, card.compute(), cpu.compute(), "X4 error action without empty queries"))
    out["error_action_raised"] = True
    out["tolerance_share_vs_cpu"] = worst
    return out


def _x_engine_reqs(np, rows, n: int, tenants: int, threads: int):
    """``n`` batch-1 requests over X1's first scalar rows: request i goes to a
    tenant of client thread ``i % threads`` (``_k_submit`` deals request i to
    that thread), so each tenant's requests reach the queue in list order and
    a fold in list order is the fold in receipt order."""
    rng = np.random.default_rng(24)
    per_thread = tenants // threads
    return [(f"tenant-{i % threads + threads * int(rng.integers(0, per_thread))}",
             (rows[0][i : i + 1], rows[1][i : i + 1])) for i in range(n)]


def _serve_forms(torch, np, what: str, forms: dict, rows, make_args, requests: int, dev: str,
                 may_demote=()) -> dict:
    """K6's traffic shape (batch-1 requests over ``rows``, 8 tenants, buckets
    (64, 256), capacity 8, 4 threads) serving each of ``forms`` (name ->
    metric factory(device)): every micro-batch one CUDA-graph replay (a
    capture a bucket and replays, no eager fallback; a form named in
    ``may_demote`` may instead be demoted by the engine at its first capture,
    which the record shows), every tenant's state against a CPU fold of its
    acknowledged requests in receipt order within (V_RTOL, V_ATOL), and req/s
    beside a naive loop of per-request updates."""
    from metrics_tpu_torch.engine import StreamingEngine

    reqs = _x_engine_reqs(np, rows, requests, K_TENANTS, K_THREADS)
    naive_rows = [(torch.from_numpy(rows[0][i : i + 1]).to(dev), torch.from_numpy(rows[1][i : i + 1]).to(dev))
                  for i in range(requests, requests + X_ENGINE_NAIVE)]
    out = {"metrics": {}}
    worst = 0.0
    for name, make in forms.items():
        naive = make(dev)  # per-request updates
        naive.update(*naive_rows[0])
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p, t in naive_rows:
            naive.update(p, t)
        if dev == "cuda":
            torch.cuda.synchronize()
        naive_rps = X_ENGINE_NAIVE / (time.perf_counter() - t0)
        keys = sorted({k for k, _ in reqs})
        engine = StreamingEngine(make(dev), buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=K_TENANTS)
        try:
            warm = _k_warm(engine, make_args, K_BUCKETS, keys)
            seconds = _k_submit(engine, reqs, K_THREADS)
            snap = engine.telemetry_snapshot()
            graphs = engine.graph_stats() if dev == "cuda" else []
            replays = sum(g["replays"] for g in graphs)
            demoted = name in may_demote and snap["fused_fallbacks"] > 0
            if dev == "cuda" and not demoted:
                _check(warm == len(K_BUCKETS) and snap["compiles"] == len(K_BUCKETS),
                       f"{what} {name}: {snap['compiles']} captures for {len(K_BUCKETS)} buckets")
                _check(replays > 0, f"{what} {name}: no graph replay")
            _check((demoted or (snap["fused"] and snap["fused_fallbacks"] == 0)) and not snap["degraded"],
                   f"{what} {name}: fused {snap['fused']}, {snap['fused_fallbacks']} fallbacks")
            states = engine._read_states(keys, window=False)  # copies, ordered after the engine's stream
        finally:
            engine.close()
        fold_metric, folds, counts = make("cpu"), {}, {}
        for key, args in reqs:
            folds[key] = fold_metric.update_state(folds.get(key) or fold_metric.init_state(),
                                                  *(torch.from_numpy(a) for a in args))
            counts[key] = counts.get(key, 0) + 1
        err, compared = 0.0, 0
        for key, fold in folds.items():
            for leaf, want in fold.items():
                got = states[key][leaf]
                if leaf == "_update_count":
                    _check(int(got) == counts[key], f"{what} {name} {key}: {int(got)} updates for {counts[key]} rows")
                    continue
                err = max(err, _x_close(torch, got, want, f"{what} {name} {key} {leaf}"))
                compared += 1
        worst = max(worst, err)
        rec = {"requests": requests, "req_per_s": requests / seconds, "naive_req_per_s": naive_rps,
               "speedup_vs_naive": requests / seconds / naive_rps, "captures": snap["compiles"],
               "replays": replays, "batches": snap["batches"], "fused_fallbacks": snap["fused_fallbacks"],
               "demoted_by_the_engine": demoted,
               "mean_batch_occupancy": snap["mean_batch_occupancy"], "latency_s": snap["latency_s"],
               "state_leaves_compared": compared, "tolerance_share_vs_cpu_fold": err}
        out["metrics"][name] = rec
        print(f"phase {what} {name} {json.dumps(rec)}")
    out["tolerance_share_vs_cpu"] = worst
    return out


def phase_x5(torch, np, dev: str = "cuda", requests: int = X_ENGINE_REQUESTS) -> dict:
    """K6's traffic shape serving R², Pearson, explained variance and Tweedie
    deviance over X1's scalar rows (``_serve_forms``)."""
    from metrics_tpu_torch import regression as R

    rng = np.random.default_rng(25)
    rows = _x_signed(np, rng, (requests + X_ENGINE_NAIVE,))
    forms = {"R2Score": lambda d: R.R2Score(device=d), "PearsonCorrCoef": lambda d: R.PearsonCorrCoef(device=d),
             "ExplainedVariance": lambda d: R.ExplainedVariance(device=d),
             "TweedieDevianceScore": lambda d: R.TweedieDevianceScore(device=d)}
    return _serve_forms(torch, np, "X5", forms, rows, lambda r: _x_signed(np, rng, (r,)), requests, dev)


def phase_x(torch, np, dev: str = "cuda", **sizes) -> dict:
    """The rest of regression, pairwise and retrieval on the card (X1-X5)."""
    t0 = time.perf_counter()
    out = {}
    for key, phase, kw in (("X1", phase_x1, ("n", "outputs")),
                           ("X2", phase_x2, ("cosine", "kl", "n", "kendall_n", "kendall_cpu_n")),
                           ("X3", phase_x3, ("shape", "manhattan")),
                           ("X4", phase_x4, ("queries", "candidates")),
                           ("X5", phase_x5, ("requests",))):
        t1 = time.perf_counter()
        out[key] = phase(torch, np, dev=dev, **{k: v for k, v in sizes.items() if k in kw})
        out[key]["seconds"] = time.perf_counter() - t1
        print(f"phase {key}: {out[key]['seconds']:.1f} s")
    out["tolerance_share_vs_cpu"] = max(out[k]["tolerance_share_vs_cpu"] for k in ("X1", "X2", "X3", "X4", "X5"))
    out["seconds"] = time.perf_counter() - t0
    print(f"phase X: {out['seconds']:.1f} s")
    return out


Y_N = 1024  # labels an update in Y1 and Y2 (bench.py's step)
Y_C = 1000
Y_UPDATES = 10
Y_CURVE_N = 10**6  # scores a BinaryAUROC update
Y_CURVE_T = 200
Y_CURVE_UPDATES = 2
Y_CURVE_CPU_COPIES = 2  # copies of the AUROC form recomputed on the CPU (each a 10^6 x 200 comparison there)
Y_SKETCH_N = 2**20
Y_TRACKER_STEPS = (3, 5)  # increments x updates
Y_MULTIOUT = (10**6, 8)
Y_NAN_SHARE = 0.01
Y_IMAGE = (16, 3, 512, 512)
Y_MS_SSIM = (8, 3, 256, 256)
Y_SSIM_3D = (2, 1, 64, 128, 128)
Y_SPECTRAL = (16, 8, 256, 256)
Y_D_LAMBDA = (8, 8, 128, 128)
Y_CPU_IMAGES = 2  # images of a per-image metric recomputed on the CPU
Y_SSIM_ATOL = 2e-5  # SSIM-like values: their variances cancel (E[x^2] - mu^2), so absolute error
Y_SAM_ATOL = 2e-5  # an arccos of a cosine near 1: float32 SAM is within 6e-6 of float64's on each device
Y_HOST_INDICES = ("aten.lift_fresh.default",)  # BootStrapper's resample indices, made from a numpy draw
Y_PER_COPY = {"stat_scores": 1, "pair_count": 1, "binned_curve": 1, "hist_add": 2}  # launches a copy an update


def _y_labels(np, rng, n: int, classes: int, hit: float = 0.7):
    """int64 targets and predictions equal to them at rate ``hit``."""
    target = rng.integers(0, classes, n)
    preds = np.where(rng.random(n) < hit, target, rng.integers(0, classes, n))
    return preds, target


def _y_tally(torch, call):
    """``(result, {kernel: launches})``: this thread's hand-kernel launches in ``call()``."""
    from metrics_tpu_torch.kernels import _tally

    with _tally.counting() as tally:
        out = call()
    return out, dict(tally)


def _y_as_copies(bs):
    """``bs`` switched to its per-copy path before any update, as the fall-back
    switches it: the port's copies path on the same seed."""
    from copy import deepcopy

    bs._use_vmap = False
    del bs._stacked_state
    bs.metrics = [deepcopy(bs.base_metric) for _ in range(bs.num_bootstraps)]
    return bs


def _y_stacked_vs_copies(torch, card, cpu_copies, what: str, copies=None) -> int:
    """Every state of each CPU copy ``torch.equal`` to its row of the card's
    stacked state (dtype included). Returns the states compared."""
    n = 0
    for i, m in enumerate(cpu_copies[:copies] if copies else cpu_copies):
        for key in m._defaults:
            got, want = card._stacked_state[key][i].cpu(), getattr(m, key)
            _check(got.dtype == want.dtype and torch.equal(got, want), f"{what}: copy {i} state {key!r} differs")
            n += 1
    return n


def phase_y1(torch, np, dev: str = "cuda", n: int = Y_N, classes: int = Y_C, updates: int = Y_UPDATES,
             curve_n: int = Y_CURVE_N, sketch_n: int = Y_SKETCH_N) -> dict:
    """BootStrapper over the hand kernels: the stacked update's
    ``torch.func.vmap`` reaches each kernel through its batching rule, one
    launch a copy; the Poisson copies take one launch a copy a chunk span."""
    from metrics_tpu_torch import BootStrapper, QuantileSketch
    from metrics_tpu_torch.classification import (
        BinaryAUROC, MulticlassAccuracy, MulticlassConfusionMatrix, MulticlassF1Score,
    )
    from metrics_tpu_torch.wrappers.bootstrapping import _bootstrap_sampler, _chunk_spans

    rng = np.random.default_rng(30)
    labels = [tuple(torch.from_numpy(a) for a in _y_labels(np, rng, n, classes)) for _ in range(updates)]
    scores = []
    for _ in range(Y_CURVE_UPDATES):
        t = rng.random(curve_n) < 0.3
        scores.append((torch.from_numpy(np.clip(rng.normal(0.35 + 0.3 * t, 0.2), 0, 1).astype(np.float32)),
                       torch.from_numpy(t.astype(np.int64))))
    values = [(torch.from_numpy(rng.lognormal(1.0, 1.5, sketch_n).astype(np.float32)),)]
    forms = {
        # key: (make(device), boots, strategy, batches, kernel, CPU copies compared)
        "accuracy_micro": (lambda d: MulticlassAccuracy(classes, average="micro", device=d), 20, "multinomial",
                           labels, "stat_scores", None),
        "confusion_matrix": (lambda d: MulticlassConfusionMatrix(classes, device=d), 8, "multinomial", labels,
                             "pair_count", None),
        "binary_auroc_T200": (lambda d: BinaryAUROC(thresholds=Y_CURVE_T, device=d), 10, "multinomial", scores,
                              "binned_curve", Y_CURVE_CPU_COPIES),
        "quantile_sketch": (lambda d: QuantileSketch(device=d), 4, "multinomial", values, "hist_add", None),
        "f1_poisson": (lambda d: MulticlassF1Score(classes, device=d), 10, "poisson", labels, "stat_scores", None),
    }
    out = {"metrics": {}, "launches": {}}
    worst = 0.0
    for key, (make, boots, strategy, batches, kernel, cpu_copies) in forms.items():
        card = BootStrapper(make(dev), boots, sampling_strategy=strategy, seed=0, quantile=0.95, raw=True)
        stacked = strategy == "multinomial"
        _check(card._use_vmap == stacked, f"Y1 {key}: _use_vmap {card._use_vmap} at construction")
        per_update = []
        for i, b in enumerate(batches):
            b_dev = tuple(x.to(dev) for x in b)
            size = b_dev[0].shape[0]
            if stacked:
                want = boots * Y_PER_COPY[kernel]
            else:  # one launch a copy a chunk span of its Poisson draw, from a copy of the generator
                gen = np.random.default_rng()
                gen.bit_generator.state = card._rng.bit_generator.state
                want = sum(len(_chunk_spans(int(_bootstrap_sampler(size, strategy, gen).size), True))
                           for _ in range(boots))
            call = lambda card=card, b=b_dev: card.update(*b)  # noqa: E731
            # the resample indices are drawn on the host (numpy's PCG64, as in the JAX package) and
            # enter as a CPU tensor (aten.lift_fresh), copied to the card once an update (a chunk)
            _, tally = _y_tally(torch, (lambda: _x_card_only(torch, call, f"Y1 {key} update", dev,
                                                             allow=Y_HOST_INDICES)) if i == 0 else call)
            expected = {kernel: want} if dev == "cuda" else {}  # the CPU rehearsal runs the plain versions
            _check(tally == expected, f"Y1 {key} update {i}: launches {tally}, expected {expected}")
            per_update.append(tally.get(kernel, 0))
        _check(card._use_vmap == stacked, f"Y1 {key}: fell back to the copies (a kernel must never cause it)")
        value = _x_card_only(torch, card.compute, f"Y1 {key} compute", dev)
        # the port's copies path on the CPU, with the same seed and batches
        cpu = _y_as_copies(BootStrapper(make("cpu"), boots, sampling_strategy=strategy, seed=0, quantile=0.95,
                                        raw=True)) if stacked else BootStrapper(make("cpu"), boots, seed=0,
                                                                               quantile=0.95, raw=True)
        if cpu_copies:  # the first copies only: each copy's rows are its row of the generator's (B, N) draw
            gen = np.random.default_rng(0)
            refs = [make("cpu") for _ in range(cpu_copies)]
            for b in batches:
                rows = torch.from_numpy(gen.integers(0, b[0].shape[0], (boots, b[0].shape[0])))
                for r, m in zip(rows, refs):
                    m.update(*[x.index_select(0, r) for x in b])
            compared = _y_stacked_vs_copies(torch, card, refs, f"Y1 {key}")
            err = max(_x_close(torch, value["raw"][i], m.compute().to(value["raw"].dtype), f"Y1 {key} raw[{i}]")
                      for i, m in enumerate(refs))
        else:
            for b in batches:
                cpu.update(*b)
            if stacked:
                compared = _y_stacked_vs_copies(torch, card, cpu.metrics, f"Y1 {key}")
            else:
                compared = 0
                for i, (mc, mg) in enumerate(zip(cpu.metrics, card.metrics)):
                    for s in mg._defaults:
                        _check(torch.equal(getattr(mg, s).cpu(), getattr(mc, s)), f"Y1 {key}: copy {i} state {s!r}")
                        compared += 1
            want = cpu.compute()
            _check(sorted(value) == sorted(want), f"Y1 {key}: statistics {sorted(value)}")
            err = max(_x_close(torch, value[k], want[k], f"Y1 {key} {k}") for k in want)
        worst = max(worst, err)
        out["launches"][key] = {kernel: sum(per_update)}
        _x_record(torch, out["metrics"], key, err, lambda card=card, b=tuple(x.to(dev) for x in batches[0]):
                  card.update(*b), dev, boots=boots, strategy=strategy, use_vmap=card._use_vmap,
                  launches_per_update=per_update, states_compared_bit_for_bit=compared)
    _x_finish(torch, out["metrics"], "Y1")
    out["tolerance_share_vs_cpu"] = worst
    return out


def phase_y2(torch, np, dev: str = "cuda", n: int = Y_N, classes: int = Y_C) -> dict:
    """The other wrappers on the flagship metrics: ClasswiseWrapper in a
    collection, MinMaxMetric over forwards, MetricTracker saved and restored
    mid-run, MultioutputWrapper on NaN rows."""
    import tempfile

    from metrics_tpu_torch import (
        ClasswiseWrapper, MeanSquaredError, MetricCollection, MetricTracker, MinMaxMetric, MultioutputWrapper, ckpt,
    )
    from metrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score

    rng = np.random.default_rng(31)
    batches = [tuple(torch.from_numpy(a) for a in _y_labels(np, rng, n, classes)) for _ in range(10)]
    out = {"metrics": {}}
    worst = 0.0

    # ClasswiseWrapper beside F1: the wrapper registers no states of its own, so it
    # is a compute group of its own in both packages: 2 stat-score launches an update,
    # against 1 (after the forming update) for the same metrics unwrapped
    def cols(d, wrap):
        acc = MulticlassAccuracy(classes, average=None, device=d)
        return MetricCollection({"acc": ClasswiseWrapper(acc) if wrap else acc,
                                 "f1": MulticlassF1Score(classes, device=d)})

    launches = {}
    for wrap in (True, False):
        card, cpu = cols(dev, wrap), cols("cpu", wrap)
        counts = []
        for i, b in enumerate(batches[:4]):
            b_dev = tuple(x.to(dev) for x in b)
            call = lambda card=card, b=b_dev: card.update(*b)  # noqa: E731
            _, tally = _y_tally(torch, (lambda: _x_card_only(torch, call, "Y2 classwise update", dev)) if i == 0 else call)
            counts.append(tally.get("stat_scores", 0))
            cpu.update(*b)
        value = _x_card_only(torch, card.compute, "Y2 classwise compute", dev)
        want = cpu.compute()
        _check(sorted(value) == sorted(want), f"Y2 classwise keys {sorted(value)[:4]}")
        worst = max(worst, max(_x_close(torch, value[k], want[k], f"Y2 classwise {k}") for k in want))
        launches["wrapped" if wrap else "unwrapped"] = {"per_update": counts, "groups": card.compute_groups}
    _check(dev != "cuda" or (launches["wrapped"]["per_update"] == [2, 2, 2, 2]
                             and launches["unwrapped"]["per_update"] == [2, 1, 1, 1]),
           f"Y2 classwise stat-score launches {launches}")
    out["classwise_stat_score_launches"] = launches
    wrapped = cols(dev, True)
    _x_record(torch, out["metrics"], "classwise_collection", worst,
              lambda b=tuple(x.to(dev) for x in batches[0]): wrapped.update(*b), dev)

    # MinMaxMetric over 10 forwards
    card, cpu = MinMaxMetric(MulticlassF1Score(classes, device=dev)), MinMaxMetric(MulticlassF1Score(classes, device="cpu"))
    err = 0.0
    for i, b in enumerate(batches):
        b_dev = tuple(x.to(dev) for x in b)
        got = _x_card_only(torch, lambda: card(*b_dev), "Y2 minmax forward", dev) if i == 0 else card(*b_dev)
        want = cpu(*b)
        err = max(err, max(_x_close(torch, got[k], want[k], f"Y2 minmax forward {i} {k}") for k in want))
    _check(card.min_val.device.type == card.max_val.device.type == torch.device(dev).type, "Y2 minmax extremes' device")
    err = max(err, max(_x_close(torch, v, cpu.compute()[k], f"Y2 minmax {k}") for k, v in card.compute().items()))
    worst = max(worst, err)
    _x_record(torch, out["metrics"], "minmax_f1_forward", err, lambda b=tuple(x.to(dev) for x in batches[0]): card(*b),
              dev)

    # MetricTracker over the flagship collection: saved after the second increment,
    # restored into a fresh tracker on the card, which must then end where the
    # uninterrupted run ends
    def tracker(d):
        return MetricTracker(MetricCollection({
            "accuracy": MulticlassAccuracy(classes, average="micro", device=d),
            "f1": MulticlassF1Score(classes, average="macro", device=d)}, compute_groups=True), maximize=[True, True])

    steps, per_step = Y_TRACKER_STEPS
    whole, cpu = tracker(dev), tracker("cpu")
    restored = None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tracker.ckpt")
        for s in range(steps):
            for t in (whole, cpu) if restored is None else (whole, cpu, restored):
                t.increment()
            for b in batches[s * per_step % 10: s * per_step % 10 + per_step]:
                b_dev = tuple(x.to(dev) for x in b)
                whole.update(*b_dev)
                cpu.update(*b)
                if restored is not None:
                    restored.update(*b_dev)
            if s == 1:
                ckpt.save(whole, path)
                restored = tracker(dev)
                ckpt.restore(restored, path)
                _check(restored.n_steps == 2, f"Y2 tracker restored {restored.n_steps} steps")
    got_all = _x_card_only(torch, whole.compute_all, "Y2 tracker compute_all", dev)
    for k, v in restored.compute_all().items():
        _check(torch.equal(v, got_all[k]), f"Y2 tracker: the restored run's {k} differs from the uninterrupted run's")
    _check(restored.best_metric(return_step=True) == whole.best_metric(return_step=True), "Y2 tracker best_metric")
    want_all = cpu.compute_all()
    err = max(_x_close(torch, got_all[k], want_all[k], f"Y2 tracker {k}") for k in want_all)
    _check(whole.best_metric(return_step=True)[1] == cpu.best_metric(return_step=True)[1], "Y2 tracker best step")
    worst = max(worst, err)
    best = whole.best_metric(return_step=True)
    _x_record(torch, out["metrics"], "tracker_flagship", err, lambda b=tuple(x.to(dev) for x in batches[0]):
              whole.update(*b), dev, steps=steps, updates_per_step=per_step, best=best)

    # MultioutputWrapper on (10^6, 8), 1% of the rows with a NaN
    rows, outputs = Y_MULTIOUT
    p = rng.normal(size=(rows, outputs)).astype(np.float32)
    y = (p + rng.normal(0, 0.5, size=(rows, outputs))).astype(np.float32)
    nan_rows = rng.choice(rows, int(rows * Y_NAN_SHARE), replace=False)
    p[nan_rows, rng.integers(0, outputs, nan_rows.size)] = np.nan
    p_cpu, y_cpu = torch.from_numpy(p), torch.from_numpy(y)
    p_dev, y_dev = p_cpu.to(dev), y_cpu.to(dev)
    card = MultioutputWrapper(MeanSquaredError(device=dev), outputs)
    cpu = MultioutputWrapper(MeanSquaredError(device="cpu"), outputs)
    _x_card_only(torch, lambda: card.update(p_dev, y_dev), "Y2 multioutput update", dev)
    cpu.update(p_cpu, y_cpu)
    value = _x_card_only(torch, card.compute, "Y2 multioutput compute", dev)
    _check(bool(torch.isfinite(value).all()), "Y2 multioutput: a NaN row reached the metric")
    err = _x_close(torch, value, cpu.compute(), "Y2 multioutput", V_RTOL, 1e-5)
    worst = max(worst, err)
    _x_record(torch, out["metrics"], f"multioutput_mse_{outputs}", err, lambda: card.update(p_dev, y_dev), dev)
    _x_finish(torch, out["metrics"], "Y2")
    out["tolerance_share_vs_cpu"] = worst
    return out


def phase_y3(torch, np, dev: str = "cuda", image=Y_IMAGE, ms=Y_MS_SSIM, vol=Y_SSIM_3D, spectral=Y_SPECTRAL,
             d_lambda=Y_D_LAMBDA) -> dict:
    """The image metrics that need no network at the sizes users score; a
    per-image metric's CPU value is taken over its first Y_CPU_IMAGES images
    (against the card's on the same images), the rest over the whole batch."""
    import metrics_tpu_torch.functional.image as F
    from metrics_tpu_torch import image as I

    rng = np.random.default_rng(32)

    def pair(shape):
        x = rng.random(shape, dtype=np.float32)
        return x, (0.75 * x + 0.25 * rng.random(shape, dtype=np.float32)).astype(np.float32)

    out = {"metrics": {}}
    worst = 0.0
    forms = []  # (key, module factory(device), cpu slice, atol, args as numpy)
    img = pair(image)
    forms += [("ssim", lambda d: I.StructuralSimilarityIndexMeasure(reduction="none", device=d), Y_CPU_IMAGES,
               Y_SSIM_ATOL, img),
              ("uqi", lambda d: I.UniversalImageQualityIndex(reduction="none", device=d), Y_CPU_IMAGES, Y_SSIM_ATOL,
               img),
              ("ms_ssim", lambda d: I.MultiScaleStructuralSimilarityIndexMeasure(reduction="none", data_range=1.0,
                                                                                 device=d),
               Y_CPU_IMAGES, Y_SSIM_ATOL, pair(ms)),
              ("ssim_3d", lambda d: I.StructuralSimilarityIndexMeasure(reduction="none", device=d), None, Y_SSIM_ATOL,
               pair(vol)),
              ("psnr_data_range_none", lambda d: I.PeakSignalNoiseRatio(device=d), None, V_ATOL, img),
              ("psnr_dim_123", lambda d: I.PeakSignalNoiseRatio(data_range=1.0, dim=(1, 2, 3), reduction="none",
                                                                device=d), None, V_ATOL, img)]
    spec = pair(spectral)
    forms += [("ergas", lambda d: I.ErrorRelativeGlobalDimensionlessSynthesis(reduction="none", device=d), None,
               V_ATOL, spec),
              ("sam", lambda d: I.SpectralAngleMapper(reduction="none", device=d), None, Y_SAM_ATOL, spec),
              ("d_lambda", lambda d: I.SpectralDistortionIndex(device=d), Y_CPU_IMAGES, Y_SSIM_ATOL, pair(d_lambda)),
              ("total_variation", lambda d: I.TotalVariation(reduction="none", device=d), None, V_ATOL, img[:1])]
    for key, make, cut, atol, arrays in forms:
        on_dev = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        card = make(dev)
        # D-lambda's update appends its inputs to list states: no op runs until its compute
        _x_card_only(torch, lambda: card.update(*on_dev), f"Y3 {key} update", dev, need_ops=key != "d_lambda")
        value = _x_card_only(torch, card.compute, f"Y3 {key} compute", dev)
        _check(bool(torch.isfinite(value).all()), f"Y3 {key}: not finite")
        if cut:  # the same images on both devices
            small_card, cpu = make(dev), make("cpu")
            small_card.update(*(x[:cut] for x in on_dev))
            cpu.update(*(torch.from_numpy(a[:cut]) for a in arrays))
            err = _x_close(torch, small_card.compute(), cpu.compute(), f"Y3 {key}",
                           1e-6 if atol == Y_SSIM_ATOL else V_RTOL, atol)
        else:
            cpu = make("cpu")
            cpu.update(*(torch.from_numpy(a) for a in arrays))
            err = _x_close(torch, value, cpu.compute(), f"Y3 {key}", 1e-6 if atol == Y_SSIM_ATOL else V_RTOL, atol)
        worst = max(worst, err)
        if key == "d_lambda":  # its update appends; the functional does the module's compute work
            _x_record(torch, out["metrics"], key, err, lambda a=on_dev: F.spectral_distortion_index(*a), dev,
                      "the functional on the batch", shape=list(arrays[0].shape), cpu_images=cut)
        else:
            _x_record(torch, out["metrics"], key, err, lambda card=card, a=on_dev: card.update(*a), dev,
                      shape=list(arrays[0].shape), **({"cpu_images": cut} if cut else {}))
    # image_gradients: exact differences
    x = torch.from_numpy(img[0])
    got = _x_card_only(torch, lambda: F.image_gradients(x.to(dev)), "Y3 image_gradients", dev)
    for g, w, name in zip(got, F.image_gradients(x), ("dy", "dx")):
        _check(torch.equal(g.cpu(), w), f"Y3 image_gradients {name} differs from the CPU's")
    _x_record(torch, out["metrics"], "image_gradients", 0.0, lambda x=x.to(dev): F.image_gradients(x), dev,
              profiled="call", shape=list(image))
    _x_finish(torch, out["metrics"], "Y3")
    out["tolerance_share_vs_cpu"] = worst
    return out


def phase_y(torch, np, dev: str = "cuda", **sizes) -> dict:
    """The wrappers and the image metrics on the card (Y1-Y3)."""
    t0 = time.perf_counter()
    out = {}
    for key, phase, kw in (("Y1", phase_y1, ("n", "classes", "updates", "curve_n", "sketch_n")),
                           ("Y2", phase_y2, ("n", "classes")),
                           ("Y3", phase_y3, ("image", "ms", "vol", "spectral", "d_lambda"))):
        t1 = time.perf_counter()
        out[key] = phase(torch, np, dev=dev, **{k: v for k, v in sizes.items() if k in kw})
        out[key]["seconds"] = time.perf_counter() - t1
        print(f"phase {key}: {out[key]['seconds']:.1f} s")
    out["tolerance_share_vs_cpu"] = max(out[k]["tolerance_share_vs_cpu"] for k in ("Y1", "Y2", "Y3"))
    out["seconds"] = time.perf_counter() - t0
    print(f"phase Y: {out['seconds']:.1f} s")
    return out


Z_IMAGES = 64  # real and fake images an update (Z1)
Z_UPDATES = 2  # updates of each side at 299 x 299, then one real update at Z_BIG
Z_FID_SAMPLES = 2176  # FID's images a side: more than its 2048 features, or its covariances are singular
Z_BIG = 512
Z_KID = (10, 100)  # subsets, subset size
Z_IS_SPLITS = 10
Z_FEATURE_RTOL = 1e-4  # a tap's features against the CPU's: a 94-convolution float32 stack on each side
Z_VALUE_RTOL, Z_VALUE_ATOL = 1e-3, 1e-4  # FID, KID, IS from equal states: float32 traces, products and softmaxes
Z_FID_TRACE_RTOL = 1e-5  # FID's absolute tolerance over the sum of the covariance traces it is a difference of
Z_FID_REACH = 4.0  # FID's further absolute tolerance over the CPU twin's distance from float64 (_z1_join)
Z_LPIPS = (16, 3, 256, 256)
Z_LPIPS_RTOL = 1e-4  # LPIPS distances: float32 convolution stacks
Z_AUDIO = (8, 2, 64000)  # 4 s at 16 kHz
Z_SDR_FILTER = 512
Z_PIT = (8, 3, 32000)
Z_STOI = (8, 48000)
Z_STOI_FS = 16000
Z_AUDIO_ATOL = 1e-4  # dB, and STOI's 0-1 scale: float32 FFTs, correlations and Toeplitz solves on each side
Z_ENGINE_SAMPLES = 4000  # samples a served row (Z4)
Z_ENGINE_SDR_FILTER = 128  # the CPU fold's 2000 row solves stay within a second
# host constant tables copied to the card at their first use there (PIT's permutation table;
# STOI's window, band matrix and resample phases), as the JAX package's jnp.asarray of them
Z_HOST_TABLES = ("aten.lift_fresh.default",)
Z_HOST_COPIES = ("aten.lift_fresh.default", "aten._to_copy.default", "aten.detach.default")  # a host step's copies


def _z_carry(torch, card, cpu) -> None:
    """``card``'s states copied into ``cpu`` (a twin on the CPU)."""
    for name in card._defaults:
        value = getattr(card, name)
        setattr(cpu, name, [v.cpu() for v in value] if isinstance(value, list) else value.cpu())
    cpu._update_count = card._update_count
    cpu._update_called = True


def _z_seeded(np, compute, seed: int):
    """``compute()`` after ``np.random.seed(seed)``: KID's and IS's host draws."""
    np.random.seed(seed)
    return compute()


def phase_z1(torch, np, dev: str = "cuda", n: int = Z_IMAGES, updates: int = Z_UPDATES, big: int = Z_BIG,
             kid=Z_KID, fid_samples: int = Z_FID_SAMPLES) -> dict:
    """FID (both square roots, at the 2048 and the 64 tap), KID and IS over
    the port's InceptionV3 with its seeded random weights: Z_UPDATES updates
    of ``n`` real and ``n`` fake uint8 images at 299 x 299 and one real
    update at ``big`` x ``big`` (resized down, antialiased); the FID forms
    then take more updates of ``n`` a side, drawn on the card, up to
    ``fid_samples`` a side (fewer samples than features would leave every
    covariance singular). Each shared batch's first Y_CPU_IMAGES images go
    through the CPU's network too (taps 2048 and ``logits_unbiased``); every
    metric's states are carried to a CPU twin whose compute (the same numpy
    seed for KID and IS) the card's must match (``_z1_join``)."""
    from metrics_tpu_torch import image as I
    from metrics_tpu_torch.image import inception_net as N

    # FID's CPU twins (a float64 square root of 2048 x 2048 on the host with scipy, seconds that
    # hold the interpreter's lock; 300 products of 2048 x 2048 with Newton-Schulz) run one after
    # the other in a process of its own, spawned now so that its imports overlap the card's work,
    # and given the twins once the card's computes and profiles are done (two at once contend
    # for the host's cores); phase_z joins them after Z3 (_z1_join)
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    procs = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    procs.submit(_z_twin_warm)
    try:
        rng = np.random.default_rng(40)
        batches = []
        for _ in range(updates):
            real = rng.integers(0, 256, (n, 3, 299, 299), dtype=np.uint8)
            fake = np.clip(real.astype(np.int16) // 2 + rng.integers(0, 128, real.shape), 0, 255).astype(np.uint8)
            batches += [(real, True), (fake, False)]
        batches.append((rng.integers(0, 256, (n, 3, big, big), dtype=np.uint8), True))
        on_dev = [(torch.from_numpy(x).to(dev), real) for x, real in batches]
        out = {"metrics": {}, "features": {}}
        worst = 0.0

        card_net = N.InceptionFeatureExtractor(2048, allow_random_weights=True, device=dev).net
        cpu_net = N.InceptionFeatureExtractor(2048, allow_random_weights=True, device="cpu").net
        for tap in (2048, "logits_unbiased"):
            for i, ((x, real), (x_dev, _)) in enumerate(zip(batches, on_dev)):
                if i not in (0, len(batches) - 1):
                    continue  # a 299 x 299 batch and the resized one
                got = _x_card_only(torch, lambda x_dev=x_dev: N._forward(card_net, tap, x_dev[:Y_CPU_IMAGES]),
                                   f"Z1 InceptionV3 {tap}", dev)
                want = N._forward(cpu_net, tap, torch.from_numpy(x[:Y_CPU_IMAGES]))
                scale = float(want.abs().max())
                err = _x_close(torch, got, want, f"Z1 InceptionV3 {tap} {x.shape[-1]}", Z_FEATURE_RTOL, Z_FEATURE_RTOL * scale)
                worst = max(worst, err)
                out["features"][f"{tap}_{x.shape[-1]}"] = {"tolerance_share_vs_cpu": err, "max_abs": scale}

        forms = {
            "fid_scipy": lambda d: I.FrechetInceptionDistance(2048, sqrtm_backend="scipy", allow_random_weights=True,
                                                              device=d),
            "fid_newton": lambda d: I.FrechetInceptionDistance(2048, sqrtm_backend="newton", allow_random_weights=True,
                                                               device=d),
            # the 64 tap's covariance product is well conditioned, where the 2048 tap's is not (_z1_join)
            "fid64_scipy": lambda d: I.FrechetInceptionDistance(64, sqrtm_backend="scipy", allow_random_weights=True,
                                                                device=d),
            "fid64_newton": lambda d: I.FrechetInceptionDistance(64, sqrtm_backend="newton", allow_random_weights=True,
                                                                 device=d),
            "kid": lambda d: I.KernelInceptionDistance(2048, subsets=kid[0], subset_size=kid[1],
                                                       allow_random_weights=True, device=d),
            "inception_score": lambda d: I.InceptionScore(splits=Z_IS_SPLITS, allow_random_weights=True, device=d),
        }
        gen = torch.Generator(dev).manual_seed(44)
        n_real, n_fake = sum(x.shape[0] for x, real in batches if real), sum(x.shape[0] for x, real in batches if not real)
        extra = []  # (images on the card, real) up to fid_samples a side
        while n_real < fid_samples or n_fake < fid_samples:
            real = n_real <= n_fake
            x = torch.randint(0, 256, (n, 3, 299, 299), generator=gen, device=dev, dtype=torch.uint8)
            if not real:  # the shared fakes' recipe: a mixture of fakes leaves Newton-Schulz's product too far from normal
                x = x // 2 + torch.randint(0, 128, x.shape, generator=gen, device=dev, dtype=torch.uint8)
            extra.append((x, real))
            n_real, n_fake = n_real + n * real, n_fake + n * (not real)

        # KID's and IS's CPU twins take milliseconds and draw from numpy's global state: they run inline
        pending, fid_states = {}, {}
        for key, make in forms.items():
            card = make(dev)
            t0 = time.perf_counter()
            for x_dev, real in on_dev + (extra if key.startswith("fid") else []):
                args = (x_dev,) if key == "inception_score" else (x_dev, real)
                _x_card_only(torch, lambda args=args: card.update(*args), f"Z1 {key} update", dev)
            if dev == "cuda":
                torch.cuda.synchronize()
            updates_s = time.perf_counter() - t0
            extra_rec, twin = {}, None
            if key.startswith("fid"):
                states = {name: getattr(card, name).cpu().numpy() for name in card._defaults}
                fid_states[key] = (card.sqrtm_backend, card.num_features, states)
                extra_rec = {"features": card.num_features, "fid_samples_a_side": [int(states[f"{side}_features_num_samples"]) for side in ("real", "fake")],
                             "covariance_traces": [_z_cov_trace(np, states, side) for side in ("real", "fake")]}
            host = Z_HOST_COPIES if key in ("fid_scipy", "fid64_scipy", "kid", "inception_score") else ()
            result = _z_timed(lambda: _x_card_only(torch, lambda: _z_seeded(np, card.compute, 7),
                                                   f"Z1 {key} compute", dev, allow=host))
            if not key.startswith("fid"):
                cpu = make("cpu")
                _z_carry(torch, card, cpu)
                twin = _z_done(_z_timed(lambda: _z_seeded(np, cpu.compute, 7)))
            pending[key] = (result, twin, extra_rec)
            last = on_dev[0]
            args = (last[0],) if key == "inception_score" else last
            _x_record(torch, out["metrics"], key, None, lambda card=card, args=args: card.update(*args), dev,
                      iters=2, updates_s=updates_s, images=[list(x.shape) for x, _ in batches], **extra_rec)
            print(f"Z1 {key}: {updates_s:.1f} s of updates, compute {result[1]:.0f} ms")
        _x_finish(torch, out["metrics"], "Z1")  # profiled before the twins load the host
        for key, (backend, num_features, states) in fid_states.items():
            result, _, extra_rec = pending[key]
            reference = key in ("fid_scipy", "fid64_scipy")  # one float64 value a tap, shared with the Newton form
            pending[key] = (result, procs.submit(_z_fid_twin, backend, num_features, states, reference), extra_rec)
        out["_pending"] = (procs, pending)
    except BaseException:
        procs.shutdown(wait=True, cancel_futures=True)
        raise
    out["tolerance_share_vs_cpu"] = worst
    return out


def _z_timed(fn):
    """``(fn(), ms)``."""
    t0 = time.perf_counter()
    result = fn()
    return result, (time.perf_counter() - t0) * 1e3


def _z_done(result):
    """``result`` as a finished future."""
    from concurrent.futures import Future

    done = Future()
    done.set_result(result)
    return done


def _z_cov_trace(np, states: dict, side: str) -> float:
    """The trace of ``side``'s covariance from FID's states (sums centred on
    the first batch's mean), in float64."""
    n = int(states[f"{side}_features_num_samples"])
    mean_c = states[f"{side}_features_sum"].astype(np.float64) / n
    return float((np.trace(states[f"{side}_features_cov_sum"].astype(np.float64)) - n * mean_c @ mean_c) / (n - 1))


def _z_fid_float64(states: dict):
    """FID of the states in float64 with numpy alone, independent of the
    port's code: tr sqrt(S1 S2) is the sum of the square roots of the
    eigenvalues of S1^1/2 S2 S1^1/2, a symmetric matrix (two ``eigh``, the
    negative rounding of zero eigenvalues clipped). Returns ``(value,
    conditioning)``: the product's eigenvalues below 1e-9 and its largest,
    and the features zero on every image of each side."""
    import numpy as np

    mean, cov = {}, {}
    for side in ("real", "fake"):
        n = int(states[f"{side}_features_num_samples"])
        mean_c = states[f"{side}_features_sum"].astype(np.float64) / n
        cov[side] = (states[f"{side}_features_cov_sum"].astype(np.float64) - n * np.outer(mean_c, mean_c)) / (n - 1)
        mean[side] = mean_c + states[f"{side}_center"]
    w, u = np.linalg.eigh(cov["real"])
    root = (u * np.sqrt(np.clip(w, 0.0, None))) @ u.T
    eig = np.linalg.eigvalsh(root @ cov["fake"] @ root)  # the eigenvalues of S1 S2
    tr_sqrt = float(np.sqrt(np.clip(eig, 0.0, None)).sum())
    diff = mean["real"] - mean["fake"]
    conditioning = {"product_eigenvalues_below_1e-9": int((eig < 1e-9).sum()),
                    "largest_product_eigenvalue": float(eig.max()),
                    "features_zero_on_every_image": [int((np.diag(cov[side]) == 0).sum()) for side in ("real", "fake")]}
    return float(diff @ diff + np.trace(cov["real"]) + np.trace(cov["fake"]) - 2.0 * tr_sqrt), conditioning


def _z_twin_warm() -> None:
    """The imports of a FID twin, done in the twins' process ahead of them."""
    import torch  # noqa: F401

    from metrics_tpu_torch.image import FrechetInceptionDistance  # noqa: F401


def _z_fid_twin(backend: str, num_features: int, states: dict, reference: bool):
    """FID's compute on the CPU from the card's states (numpy), in a process of
    its own: ``(value, ms)``, and with ``reference`` the float64 value of the
    states and its conditioning (``_z_fid_float64``)."""
    import numpy as np
    import torch

    from metrics_tpu_torch.image import FrechetInceptionDistance

    twin = FrechetInceptionDistance(lambda imgs: imgs, num_features=num_features, sqrtm_backend=backend,
                                    device="cpu")
    for name, value in states.items():
        setattr(twin, name, torch.from_numpy(np.array(value)))
    twin._update_called = True
    value, ms = _z_timed(twin.compute)
    return (value, ms, *_z_fid_float64(states)) if reference else (value, ms)


def _z1_join(torch, out: dict) -> None:
    """Z1's values against their CPU twins': KID and IS within (Z_VALUE_RTOL,
    Z_VALUE_ATOL). FID within Z_VALUE_RTOL and an absolute tolerance of
    Z_FID_TRACE_RTOL of the sum of its covariance traces (it is a difference
    of traces whose float32 rounding scales with them) plus Z_FID_REACH times
    the CPU twin's distance from the float64 value of the same states: the
    random-weight net maps every image near one direction at the 2048 tap,
    so most eigenvalues of the covariance product sit at float32's rounding
    level, and the square root lifts a rounding of size r there to about
    sqrt(r), which float32 pipelines that round in another order do not
    share. At the 64 tap the product is well conditioned and that term is
    small. Newton-Schulz on the 2048 tap's product diverges in both packages
    (its normalised spectrum sits below float32's resolution, the JAX
    package's algorithm): the card's value must then be NaN where the CPU
    twin's is. Each record prints before its check."""
    procs, pending = out.pop("_pending")
    references = {}  # FID's float64 value and conditioning by tap, from its scipy form's twin
    try:
        for key, ((value, compute_ms), twin, extra_rec) in pending.items():
            want, cpu_compute_ms, *reference = twin.result()
            if "features" in extra_rec:
                reference = references.setdefault(extra_rec["features"], reference)
            values = value if isinstance(value, tuple) else (value,)
            finite = all(bool(torch.isfinite(v).all()) for v in values)
            cpu_values = want if isinstance(want, tuple) else (want,)
            rec = out["metrics"][key]
            rec.update(value=[_z_json(v) for v in values], finite=finite, compute_ms=compute_ms,
                       cpu_value=[_z_json(v) for v in cpu_values], cpu_compute_ms=cpu_compute_ms, atol=Z_VALUE_ATOL)
            if reference:
                reach = abs(float(want) - reference[0])
                rec.update(float64_value=reference[0], **reference[1], cpu_float32_reach=_z_json(reach),
                           card_minus_float64=_z_json(float(value) - reference[0]),
                           atol=Z_FID_TRACE_RTOL * sum(extra_rec["covariance_traces"])
                           + (Z_FID_REACH * reach if math.isfinite(reach) else 0.0))
            print(f"phase Z1 {key} against the CPU twin: {json.dumps(rec)}")
            _check(finite or key == "fid_newton", f"Z1 {key}: not finite: {value}")
            rec["tolerance_share_vs_cpu"] = _x_close(torch, value, want, f"Z1 {key}", Z_VALUE_RTOL, rec["atol"])
            out["tolerance_share_vs_cpu"] = max(out["tolerance_share_vs_cpu"], rec["tolerance_share_vs_cpu"])
    finally:
        procs.shutdown(wait=True, cancel_futures=True)


def _z_json(x):
    """A float for a JSON record: None where it is not finite."""
    x = float(x)
    return x if math.isfinite(x) else None


def phase_z2(torch, np, dev: str = "cuda", shape=Z_LPIPS) -> dict:
    """LPIPS over the alex, vgg and squeeze nets with the port's seeded random
    weights on ``shape`` image pairs in [-1, 1]; the first Y_CPU_IMAGES pairs
    against the CPU."""
    from metrics_tpu_torch import image as I

    rng = np.random.default_rng(41)
    img0 = rng.uniform(-1, 1, shape).astype(np.float32)
    img1 = np.clip(img0 + rng.normal(0, 0.3, shape), -1, 1).astype(np.float32)
    pair = (torch.from_numpy(img0).to(dev), torch.from_numpy(img1).to(dev))
    out = {"metrics": {}}
    worst = 0.0
    for net in ("alex", "vgg", "squeeze"):
        def make(d, net=net):
            return I.LearnedPerceptualImagePatchSimilarity(net, allow_random_weights=True, device=d)

        card = make(dev)
        _x_card_only(torch, lambda: card.update(*pair), f"Z2 {net} update", dev)
        value = _x_card_only(torch, card.compute, f"Z2 {net} compute", dev)
        _check(bool(torch.isfinite(value)) and float(value) > 0, f"Z2 {net}: {value}")
        small, cpu = make(dev), make("cpu")
        small.update(*(x[:Y_CPU_IMAGES] for x in pair))
        cpu.update(torch.from_numpy(img0[:Y_CPU_IMAGES]), torch.from_numpy(img1[:Y_CPU_IMAGES]))
        err = _x_close(torch, small.compute(), cpu.compute(), f"Z2 {net}", Z_LPIPS_RTOL, V_ATOL)
        worst = max(worst, err)
        _x_record(torch, out["metrics"], net, err, lambda card=card: card.update(*pair), dev, iters=2,
                  value=float(value), shape=list(shape), cpu_images=Y_CPU_IMAGES)
    _x_finish(torch, out["metrics"], "Z2")
    out["tolerance_share_vs_cpu"] = worst
    return out


def phase_z3(torch, np, dev: str = "cuda", audio=Z_AUDIO, pit=Z_PIT, stoi=Z_STOI) -> dict:
    """SDR (filter Z_SDR_FILTER), SI-SDR, SNR and SI-SNR on ``audio``; PIT with 3
    speakers over SI-SDR on ``pit`` by the exhaustive search and by scipy's
    assignment on the host; STOI and ESTOI on ``stoi`` at Z_STOI_FS; all on the
    whole batch against the CPU. ``SignalDistortionRatio``'s update runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync in it raises."""
    from metrics_tpu_torch import audio as A
    from metrics_tpu_torch.functional import audio as FA

    rng = np.random.default_rng(42)

    def signals(shape, noise):
        target = rng.normal(size=shape).astype(np.float32)
        return (target + noise * rng.normal(size=shape)).astype(np.float32), target

    speech = signals(audio, 0.3)
    target = rng.normal(size=pit).astype(np.float32)
    order = np.stack([rng.permutation(pit[1]) for _ in range(pit[0])])
    mixed = (np.take_along_axis(target, order[:, :, None], axis=1) + 0.3 * rng.normal(size=pit)).astype(np.float32)
    stoi_sig = signals(stoi, 0.8)
    stoi_sig[1][:, : stoi[1] // 6] *= 1e-4  # a silent lead-in: its frames are dropped
    forms = {
        "sdr": (lambda d: A.SignalDistortionRatio(filter_length=Z_SDR_FILTER, device=d), speech, ()),
        "si_sdr": (lambda d: A.ScaleInvariantSignalDistortionRatio(device=d), speech, ()),
        "snr": (lambda d: A.SignalNoiseRatio(device=d), speech, ()),
        "si_snr": (lambda d: A.ScaleInvariantSignalNoiseRatio(device=d), speech, ()),
        "pit_exhaustive": (lambda d: A.PermutationInvariantTraining(
            FA.scale_invariant_signal_distortion_ratio, use_linear_sum_assignment=False, device=d),
            (mixed, target), Z_HOST_TABLES),
        "pit_linear_sum_assignment": (lambda d: A.PermutationInvariantTraining(
            FA.scale_invariant_signal_distortion_ratio, use_linear_sum_assignment=True, device=d),
            (mixed, target), Z_HOST_COPIES),
        "stoi": (lambda d: A.ShortTimeObjectiveIntelligibility(Z_STOI_FS, device=d), stoi_sig, Z_HOST_TABLES),
        "estoi": (lambda d: A.ShortTimeObjectiveIntelligibility(Z_STOI_FS, extended=True, device=d), stoi_sig,
                  Z_HOST_TABLES),
    }
    out = {"metrics": {}}
    worst = 0.0
    for key, (make, arrays, host) in forms.items():
        on_dev = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        card = make(dev)
        if key == "sdr" and dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                _x_card_only(torch, lambda: card.update(*on_dev), f"Z3 {key} update", dev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            _x_card_only(torch, lambda: card.update(*on_dev), f"Z3 {key} update", dev, allow=host)
        value = _x_card_only(torch, card.compute, f"Z3 {key} compute", dev)
        _check(bool(torch.isfinite(value)), f"Z3 {key}: {value}")
        cpu = make("cpu")
        cpu.update(*(torch.from_numpy(a) for a in arrays))
        err = _x_close(torch, value, cpu.compute(), f"Z3 {key}", V_RTOL, Z_AUDIO_ATOL)
        worst = max(worst, err)
        _x_record(torch, out["metrics"], key, err, lambda card=card, a=on_dev: card.update(*a), dev, iters=2,
                  value=float(value), shape=list(arrays[0].shape),
                  **({"host_sync_in_update": False} if key == "sdr" and dev == "cuda" else {}))
    # the best permutations of both routes agree with each other and with the draw
    best = [FA.permutation_invariant_training(torch.from_numpy(mixed).to(dev), torch.from_numpy(target).to(dev),
                                              FA.scale_invariant_signal_distortion_ratio,
                                              use_linear_sum_assignment=lsa)[1].cpu() for lsa in (False, True)]
    _check(torch.equal(best[0], best[1]), "Z3 PIT: the two routes chose other permutations")
    _check(torch.equal(FA.pit_permutate(torch.from_numpy(mixed), best[0]),
                       torch.from_numpy(np.take_along_axis(mixed, np.argsort(order, axis=1)[:, :, None], axis=1))),
           "Z3 PIT: the best permutation does not undo the draw")
    _x_finish(torch, out["metrics"], "Z3")
    out["tolerance_share_vs_cpu"] = worst
    return out


def phase_z4(torch, np, dev: str = "cuda", requests: int = X_ENGINE_REQUESTS) -> dict:
    """K6's traffic shape serving SNR, SI-SNR, SI-SDR and SDR, a row a signal of
    Z_ENGINE_SAMPLES samples (``_serve_forms``); SDR's ``solve_ex`` may be
    captured or demoted by the engine, and the record says which."""
    from metrics_tpu_torch import audio as A

    rng = np.random.default_rng(43)

    def rows(n):
        target = rng.normal(size=(n, Z_ENGINE_SAMPLES)).astype(np.float32)
        return (target + 0.3 * rng.normal(size=target.shape)).astype(np.float32), target

    forms = {"SignalNoiseRatio": lambda d: A.SignalNoiseRatio(device=d),
             "ScaleInvariantSignalNoiseRatio": lambda d: A.ScaleInvariantSignalNoiseRatio(device=d),
             "ScaleInvariantSignalDistortionRatio": lambda d: A.ScaleInvariantSignalDistortionRatio(device=d),
             "SignalDistortionRatio": lambda d: A.SignalDistortionRatio(filter_length=Z_ENGINE_SDR_FILTER, device=d)}
    return _serve_forms(torch, np, "Z4", forms, rows(requests + X_ENGINE_NAIVE), rows, requests, dev,
                        may_demote=("SignalDistortionRatio",))


def phase_z(torch, np, dev: str = "cuda", **sizes) -> dict:
    """The image metrics with a network and audio on the card (Z1-Z4)."""
    t0 = time.perf_counter()
    out = {}
    for key, phase, kw in (("Z1", phase_z1, ("n", "updates", "big", "kid", "fid_samples")),
                           ("Z2", phase_z2, ("shape",)),
                           ("Z3", phase_z3, ("audio", "pit", "stoi")),
                           ("Z4", phase_z4, ("requests",))):
        t1 = time.perf_counter()
        try:
            out[key] = phase(torch, np, dev=dev, **{k: v for k, v in sizes.items() if k in kw})
        except BaseException:
            if "_pending" in out.get("Z1", {}):  # Z1's twins' process, not joined yet
                out["Z1"]["_pending"][0].shutdown(wait=True, cancel_futures=True)
            raise
        if key == "Z3":  # Z1's CPU twins ran beside Z2 and Z3; Z4's serving rates want the host to itself
            t2 = time.perf_counter()
            _z1_join(torch, out["Z1"])
            out[key]["twin_wait_s"] = time.perf_counter() - t2
        out[key]["seconds"] = time.perf_counter() - t1
        print(f"phase {key}: {out[key]['seconds']:.1f} s")
    out["tolerance_share_vs_cpu"] = max(out[k]["tolerance_share_vs_cpu"] for k in ("Z1", "Z2", "Z3", "Z4"))
    out["seconds"] = time.perf_counter() - t0
    print(f"phase Z: {out['seconds']:.1f} s")
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--replica-reader":
        return _p2_reader(sys.argv[2], float(sys.argv[3]))  # Phase P2's follower process
    if len(sys.argv) == 6 and sys.argv[1] == "--q-rank":
        return _q_child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])  # a rank of Phase Q2 or Q3
    if len(sys.argv) == 5 and sys.argv[1] == "--u-host":
        return _u_host(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))  # a host of Phase U4
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import metrics_tpu_torch.entry as entry_mod
    from metrics_tpu_torch import obs
    from metrics_tpu_torch.kernels import _build, cms_walk, confmat, scatter
    from metrics_tpu_torch.kernels import binned_curve as bc
    from metrics_tpu_torch.obs import instrument

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    # the card's integer issue rate: 128 lanes of each SM, one instruction each per clock
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_ops_per_s = sms * 128 * clock_mhz * 1e6
    print(f"issue rate: {sms} SMs x 128 lanes x {clock_mhz} MHz (clocks.max.sm) = {issue_ops_per_s} ops/s")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    names = (confmat.KERNEL_NAME, scatter.KERNEL_NAME, bc.KERNEL_NAME, cms_walk.KERNEL_NAME)
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all started together
        libs = dict(zip(names, pool.map(_build.build, names)))
    print(f"build {', '.join(f'{n}.cu' for n in names)}: {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"  {lib.name}")
        for ln in lib.with_suffix(".log").read_text().splitlines():
            if "ptxas" in ln or "spill" in ln:
                print(f"    {ln.strip()}")

    t_mark = [time.perf_counter()]

    def phases_took(names: str) -> None:
        print(f"phase {names}: {time.perf_counter() - t_mark[0]:.1f} s")
        t_mark[0] = time.perf_counter()

    route_err = phase_a(torch, confmat)
    scatter_err = phase_a_scatter(torch, scatter)
    scatter_err["cms_rows_add"] = max(scatter_err["cms_rows_add"], phase_a_cms_ids(torch, scatter))
    walk_err = phase_a_walk(torch, scatter, cms_walk)
    launches, args, step = phase_b(torch, confmat, entry_mod)
    steps = phase_c_steps(torch, entry_mod, step, args)
    main_shape = phase_c_kernel(torch, confmat, n=entry_mod.FULL_CONFIG["batch"], classes=entry_mod.FULL_CONFIG["classes"])
    six_shape = phase_c_kernel(torch, confmat, n=SIX_N, classes=SIX_C)  # Phase J2's shape, shared memory
    phase_d_profile(torch, entry_mod, step, args)
    del args, step
    phases_took("A-D")
    sketch_launches, sketch_data = phase_e(torch, scatter, cms_walk, obs, instrument)
    sketch_recs = phase_f(torch, scatter, cms_walk, sketch_data, issue_ops_per_s, clock_mhz * 1e6)
    del sketch_data
    phases_took("E-F")
    curve_err = phase_g(torch, bc)
    curve_launches, curve_data = phase_h(torch, bc, obs, instrument)
    curve_recs = phase_i(torch, bc, curve_data)
    del curve_data
    phases_took("G-I")
    collection_step = phase_j1(torch, entry_mod, obs, instrument, steps)
    six = phase_j2(torch, obs, instrument)
    phase_j3(torch)
    phases_took("J")
    engine = phase_k(torch, scatter)
    import numpy as np

    classification_l = phase_l(torch, np)
    durable = phase_m(torch, np, obs, instrument)
    guard = phase_n(torch, np)
    tier = phase_o(torch, np)
    replication = phase_p(torch, np)
    comm_plane = phase_q(torch, np, entry_mod, confmat, obs, card)
    shard_plane = phase_r(torch, np)
    query_plane = phase_s(torch, np)
    cluster_plane = phase_t(torch, np)
    partition_plane = phase_u(torch, np)
    pilot_plane = phase_v(torch, np, obs, instrument, confmat)
    classification_rest = phase_w(torch, np, obs, instrument, confmat)
    regression_rest = phase_x(torch, np)
    wrappers_image = phase_y(torch, np)
    network_image_audio = phase_z(torch, np)
    y1 = wrappers_image["Y1"]["launches"]  # BootStrapper's stacked (and Poisson) updates, by form

    def y1_launches(kernel: str) -> dict:
        return {form: rec[kernel] for form, rec in y1.items() if kernel in rec}

    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms")
    what = {"pair_count": ("train step, global atomics", "six-metric collection update, shared memory, clusters of 2"),
            "stat_scores": ("train step, one block", "six-metric collection update")}
    replaces = {"pair_count": "metrics_tpu/kernels/confmat.py:126",
                "stat_scores": "metrics_tpu/kernels/confmat.py:126, "
                               "metrics_tpu/functional/classification/stat_scores.py:334-339"}
    kernels = []
    for route in ROUTES:
        main, six_rec = main_shape[route], six_shape[route]
        kernels.append({
            "name": route,
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/pair_count.cu",
            "replaces": replaces[route],
            "launches": launches[route],
            "max_abs_err": route_err[route],
            **{k: main[k] for k in fields},
            "shapes": [{"shape": f"N={r['n']}, {r['rows']} x {r['cols']} int64 labels ({w})",
                        **{k: r[k] for k in fields}} for r, w in zip((main, six_rec), what[route])],
            # launches of each path's run: the dict step (Phase B), the same three metrics in a
            # collection (J1), the six-metric collection with groups on and off (J2)
            "launches_by_path": {
                "phase_b_dict_step": launches[route],
                "phase_j1_collection_and_dict_steps": collection_step["launches"][route],
                "phase_j1_per_step": {k: v[route] for k, v in collection_step["launches_per_step"].items()},
                "phase_j2_per_update": {k: v[route] for k, v in six["launches_per_update"].items()},
                "phase_j2_forming_update": six["launches_forming_update"][route],
                # the guard and tier planes around the flagship collection (Phases N3, O4)
                "phase_n3_takeover_inline": guard["N3"]["takeover"]["launches_counted_inline"][route],
                "phase_n3_replays_after_restart": guard["N3"]["takeover"]["launches_in_replays_after"][route],
                "phase_n3_governor_counted": guard["N3"]["governor"]["launches_counted"][route],
                "phase_o4_in_replays": tier["O4"]["flagship"]["launches_in_replays"][route],
                # a follower's replays of the flagship collection's shipped chunk records (Phase P3)
                "phase_p3_follower_replays": replication["P3"]["flagship"]["launches_in_replays"][route],
                "phase_p3_follower_replays_profiled": replication["P3"]["flagship"]["launches_profiled"][route],
                # the comm plane (Phase Q): the world-of-one step eager and in its graph's replays, a
                # data-parallel rank's step, the ladder's rank states
                "phase_q1_eager": comm_plane["Q1"]["launches_eager"][route],
                "phase_q1_replays": comm_plane["Q1"]["launches_in_replays"][route],
                "phase_q1_replays_profiled": comm_plane["Q1"]["launches_profiled"][route],
                "phase_q2_per_rank_step": comm_plane["Q2"]["launches_per_rank_step"][route],
                "phase_q4_rank_updates": comm_plane["Q4"]["launches"][route],
                # the shard plane (Phase R4): the flagship collection over 8 shards, in their replays
                "phase_r4_shard_replays": shard_plane["R4_flagship"]["launches_all_replays"][route],
                "phase_r4_shard_replays_profiled": shard_plane["R4_flagship"]["launches_profiled"][route],
                # the cluster and partition planes (Phases T1, U1): leaders that fail over, followers
                # that replay, a tenant that migrates; all replays, and a profiled window's
                "phase_t1_replays": cluster_plane["T1"]["launches_all_replays"][route],
                "phase_t1_replays_profiled": cluster_plane["T1"]["launches_profiled"][route],
                "phase_t1_replays_in_profiled_window": cluster_plane["T1"]["launches_in_replays"][route],
                "phase_u1_replays": partition_plane["U1"]["launches_all_replays"][route],
                "phase_u1_replays_profiled": partition_plane["U1"]["launches_profiled"][route],
                "phase_u1_replays_in_profiled_window": partition_plane["U1"]["launches_in_replays"][route],
                # the confusion-matrix family (Phase V1): Jaccard, kappa (3 weightings) and Matthews, one
                # table launch an update each at both shapes, and the four-metric collection's updates
                # (1 an update with groups, after 3 in the one that forms them; 4 without)
                "phase_v1_family_and_collections": pilot_plane["V1"]["launches"][route],
                "phase_v1_per_update": {key: {name: m["launches_per_update"][route]
                                              for name, m in rec["metrics"].items()}
                                        for key, rec in pilot_plane["V1"]["shapes"].items()},
                "phase_v1_collection_per_update": {key: rec["collection"]["table_launches_per_update"]
                                                   for key, rec in pilot_plane["V1"]["shapes"].items()}
                if route == "pair_count" else None,
                # the rest of classification and the nominal metrics (Phase W): W1 the nominal tables (1 a
                # module update or a functional call, D(D-1)/2 and D(D-1) a matrix), W2 multiclass Hamming
                # (1 stat-score launch an update) and the flagship collection with it (3 + 1 in the update
                # that forms the groups, then 1 + 1)
                "phase_w1_nominal": classification_rest["W1"]["launches"][route],
                "phase_w2_hamming_and_collection": classification_rest["W2"]["launches"][route],
                "phase_w_per_update": {
                    **{name: rec["launches_per_update"][ROUTES.index(route)]
                       for name, rec in classification_rest["W1"]["metrics"].items()},
                    **{name: rec["launches_per_update"][ROUTES.index(route)]
                       for name, rec in classification_rest["W2"]["metrics"].items() if name.startswith("hamming_N")},
                    **{f"collection_{key}": [p[ROUTES.index(route)] for p in rec["launches_per_update"]]
                       for key, rec in classification_rest["W2"]["collection"].items()},
                },
                # BootStrapper (Phase Y1): the stacked update under torch.func.vmap launches the kernel
                # once a copy through its batching rule, the Poisson copies once a copy a chunk span
                "phase_y1_bootstrap": y1_launches(route),
                "phase_y2_classwise_collection_per_update":
                    wrappers_image["Y2"]["classwise_stat_score_launches"] if route == "stat_scores" else None,
            },
        })
    shape_fields = ("shape", *fields)
    for kernel, rec, shapes in (
        ("hist_add", sketch_recs["hist_add"], ()),
        ("hist_max", sketch_recs["hist_max_p12"], (sketch_recs["hist_max_p12"], sketch_recs["hist_max_p16"])),
        # the ids route is the main path's (cms_table_update on the card); the columns route the registry's
        ("cms_rows_add", sketch_recs["cms_rows_add_ids"],
         (sketch_recs["cms_rows_add_ids"], sketch_recs["cms_rows_add"])),
    ):
        kernels.append({
            "name": kernel,
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/scatter.cu",
            "replaces": "metrics_tpu/kernels/scatter.py:84",
            "launches": sketch_launches[kernel],
            "max_abs_err": scatter_err[kernel],
            **{k: rec[k] for k in fields},
            **({"shapes": [{k: r[k] for k in shape_fields} for r in shapes]} if shapes else {}),
            **({"launches_by_path": {"phase_e_updates": sketch_launches[kernel],
                                     "phase_o4_in_replays": tier["O4"]["quantile"]["launches_in_replays"][kernel],
                                     "phase_o4_counted": tier["O4"]["quantile"]["launches_counted"][kernel],
                                     "phase_p3_follower_replays":
                                         replication["P3"]["quantile"]["launches_in_replays"][kernel],
                                     "phase_p3_follower_replays_profiled":
                                         replication["P3"]["quantile"]["launches_profiled"][kernel],
                                     # the query plane (Phase S1): 8 partitions' quantile engines
                                     "phase_s1_partition_replays":
                                         query_plane["S1_exactness"]["launches_in_replays"]["hist_add"],
                                     # S2: the followers that serve the cached query, and a profiled
                                     # window of leaders' and followers' replays
                                     "phase_s2_follower_replays":
                                         query_plane["S2_cached"]["launches_in_follower_replays"]["hist_add"],
                                     "phase_s2_replays_in_profiled_window":
                                         query_plane["S2_cached"]["launches_in_replays"]["hist_add"],
                                     "phase_s2_replays_profiled":
                                         query_plane["S2_cached"]["launches_profiled"]["hist_add"],
                                     # BootStrapper's stacked QuantileSketch (Phase Y1): 2 a copy an update
                                     "phase_y1_bootstrap": y1_launches("hist_add")}}
               if kernel == "hist_add" else {}),
        })
    walk = sketch_recs[f"cms_walk_{HH_BATCH}"]
    kernels.append({
        "name": "cms_walk",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/cms_walk.cu",
        "replaces": "metrics_tpu/sketch/kernels.py:296",
        "launches": sketch_launches["cms_walk"],
        "max_abs_err": walk_err,
        **{k: walk[k] for k in fields},
        **{k: walk[k] for k in WALK_FIELDS},
        "shapes": [{k: sketch_recs[f"cms_walk_{n}"][k] for k in (*shape_fields, *WALK_FIELDS)} for n in WALK_SHAPES],
    })
    main_curve = curve_recs[f"T{CURVE_T}_C1"]
    kernels.append({
        "name": "binned_curve",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/binned_curve.cu",
        "replaces": "metrics_tpu/kernels/binned_curve.py:45",
        "launches": curve_launches,
        "launches_by_path": {"phase_h_updates": curve_launches,
                             # BootStrapper's stacked BinaryAUROC (Phase Y1): 1 a copy an update
                             "phase_y1_bootstrap": y1_launches("binned_curve")},
        "max_abs_err": curve_err["max_abs_err"],
        **{k: main_curve[k] for k in fields},
        "shapes": [{k: curve_recs[key][k] for k in shape_fields}
                   for key in (f"T{CURVE_T}_C1", "T1024_C1", f"T{CURVE_T}_C{CURVE_COLS}")],
    })
    print(json.dumps({"step": steps, "collection_step": collection_step, "six_metric_collection": six,
                      "engine": engine, "binary_multilabel_mse": classification_l, "durable": durable,
                      "guard": guard, "tier": tier, "replication": replication, "comm": comm_plane,
                      "shard": shard_plane, "query": query_plane, "cluster": cluster_plane,
                      "partition": partition_plane, "pilot": pilot_plane, "classification_rest": classification_rest,
                      "regression_pairwise_retrieval": regression_rest, "wrappers_image": wrappers_image,
                      "network_image_audio": network_image_audio, "card": card}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
