#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, with one
NVIDIA Hopper card. It exits non-zero on any failed phase and when CUDA
is unavailable. Phases:

1. Device and build: the card's name and power limit (``nvidia-smi``),
   then ``nvcc`` builds the CUDA sources of ``bibfs_tpu_torch/csrc``.
2. Kernels against their plain torch versions, on the card, at the
   geometry of phase 3 and at a small ragged one, from a seeded random
   mid-search state: exact equality, median time per launch (CUDA events,
   25 launches), the least time the card could take (bytes moved over
   3.35 TB/s) and the least time any launch takes (an empty kernel,
   ``launch_floor_ms``), which is the real floor of the one-thread fold.
   Both instantiations of kernel 2, staged (the wrapper) and unstaged
   (:data:`UNSTAGED`), are held against the plain twin and timed. One
   ``step`` line per kernel instantiation and geometry carries its time,
   its bound and an estimate of the table sectors the claim touches
   (``est_sector_mb``, from the inputs); the pull kernels' lines also
   carry the bound with a byte frontier row (``bound_ms_byte_row``), and
   two more lines time the tiered route's rebuild of the next frontier
   after the tier pass (``rebuild_bits``, ``rebuild_pair``).
3. Main path: G(2^20, 8/2^20) (1,048,576 vertices, about 4.19M edges),
   plain ELL, 8 seeded pairs plus one src == dst pair, modes sync, alt,
   beamer, pallas, pallas_alt, fused and fused_alt. Every answer matches
   the serial oracle and passes ``validate_path``; fused == pallas == sync
   and fused_alt == pallas_alt == alt exactly on (best, meet, par_s,
   par_t, levels, edges); fused gives the same result with unroll 1 and 8;
   every kernel's launch count rises.
   Phase 2 also holds the batch-minor level (``minor_level``, both
   instantiations: int32 planes for ``minor``, int8 for ``minor8``)
   against its packed plain twin at the batch geometry of 256 queries on
   gnp-deg8-s20 and of 128 on the 3001-row graph and on one with five
   hubs of about 90 neighbours (rows wider than the slots the kernel
   stages), from a seeded mid-search state made on the card (the packed
   frontier and visited words, the planes, counters and meet keys
   exactly equal; the input key is the state's full vote), with a
   ``step`` line per instantiation
   (kernel ms, the twin's ms, the bound on the packed state, the bound of
   the int planes the kernel read before, an estimate of the dist and
   parent sectors the claims touch, the level launches of one batch).
4. Tiered: RMAT scale 20, edge factor 16 (about 15.7M edges; its host
   graph built by a child process started with the run, ``rmat_prep``,
   beside phases 1-8; its ``graph`` line adds the child's build and the
   wait for it); the kernels against their plain versions at its base table (kernels 3 and
   4 timed there too), then modes
   sync, pallas, pallas_alt and fused (which runs as pallas); oracle hops
   and pallas == sync exactly. Then batch routing on it: ``auto`` with
   256 queries takes the lock-step ``sync`` batch and ``minor`` is
   refused (a tier's parent key overflows int32); ``auto`` with 8 pairs
   matches the oracle; then 256 seeded pairs under ``auto``, checked
   and timed as in phase 9 (16 against the single-query search). Last,
   64 seeded pairs as lock-step ``pallas`` and ``pallas_alt`` batches
   (kernels 3 and 4 with a query axis, the tiered rebuild of their
   frontier plane after each tier pass), every query held to its
   single-query search on (best, meet, levels, edges, both parent rows)
   and to the oracle's hops, both batched kernels launched.
5. Batches (run between phases 3 and 4 on the phase 3 graph): 256 seeded
   pairs (one ``src == dst``, one to an isolated vertex) through
   ``time_batch_graph`` in modes minor8, minor and auto (a warm-up, then
   the median of 5), one ``batch`` line each with the batch ms, the ms per
   query beside a single ``fused`` solve's and the host reads per batch;
   minor8 (decoded) == minor == auto on every output, parent rows
   included; 16 pairs equal the single-query ``fused`` search in (best,
   meet, levels, edges) and the oracle in hops; every path passes
   ``validate_path``; both instantiations' launch counts rise.
6. Tiered batches on RMAT scale 17, edge factor 16 (the largest scale of
   the family whose tiers ``minor`` admits): 256 pairs in mode minor,
   checked as in phase 5 against the single-query ``sync`` search; then a
   600-vertex path graph whose deepest query passes the int8 cap: the
   minor8 refill equals minor.
7. The serving engine (run after phase 5 on the phase 3 graph):
   ``QueryEngine(n, edges, max_batch=256, cache_entries=512)`` on the
   default device (``cuda``). Wave A, 256 distinct seeded pairs (one
   ``src == dst``, one to an isolated vertex) under ``mode="auto"``: one
   ``minor8`` device flush of 255 queries, equal to
   ``solve_batch_graph(g, pairs, mode="minor8")`` on every field but the
   time, hops equal to the serial oracle, paths valid. Wave B, 256 pairs
   whose sources are wave A's (exact repeats, reverse twins, meet
   vertices): all from the distance cache, no new device batch. Wave C,
   16 fresh pairs below the crossover: the native host route; then the
   same 16 pairs as one device flush (``C[device]``, ``flush_threshold=1``
   on a second engine), the card's side of the crossover. Wave D,
   64 pairs through a second engine in ``mode="pallas"`` (kernel 3 with a
   query axis, the flush a lock-step batch) and a third in
   ``mode="pallas_alt"`` (kernel 4 with a query axis), each equal to
   ``solve_batch_graph`` in that mode. Every wave fails on any fallback,
   retry, injected fault, error or breaker that is not closed; each
   prints one ``{"phase": "engine", ...}`` line (queries and routes,
   flush ms, queries/s from submit to result, the launches of each
   kernel, the summed ms of the engine's trace spans, and the build
   seconds of the snapshot, the bucketed table and the native runtime).

8. The pipelined engine (run after phase 7 on the phase 3 graph):
   ``PipelinedQueryEngine(n, edges, max_batch=256, cache_entries=512,
   max_wait_ms=5.0)`` on the card. Wave P, 1024 seeded pairs with 2048
   distinct endpoints (so no answer comes from another's banked forest)
   submitted from 4 threads, ``flush_threshold=1`` so that every flush
   rides the card, beside a synchronous ``QueryEngine`` on the same pairs
   (pipelined, then sync; fresh engines): every answer equals the
   synchronous engine's field for field but the time,
   64 seeded ones the oracle's hops, and at least 4 device flushes launch
   ``minor_level<int8_t>``. Wave P-pallas, 64 pairs each through a
   pipelined engine in ``pallas`` (kernel 3) and ``pallas_alt`` (kernel
   4), beside the synchronous engine in that mode and equal to it (each
   flush a lock-step batch on the batched kernel).
   Wave S, a trickle of 8 fresh queries 20 ms apart from one thread at
   the default crossover: host routed deadline flushes, with per-query
   latency percentiles. Then the
   CLI as subprocesses over a ``.bin`` of the graph:
   ``python3 -m bibfs_tpu_torch.serve.cli g.bin --pipeline --pairs``
   (256 pairs whose hops equal the oracle's), and a stdin stream that
   answers ``health`` and ``stats`` and exits 0 on SIGTERM with every
   queued result printed. Each wave prints one ``{"phase":
   "engine_pipelined", ...}`` line (wall and queries/s beside the
   synchronous engine's, flushes by cause, the worst queue wait and
   batch service, the stage clock's overlap, the span ms, the peak
   device memory) and fails on any fallback, retry or error, a ticket
   still pending after ``close()`` or an engine thread still alive.
   Between wave P[pallas*] and wave S, the network front door
   (``net_phase``): a ``NetServer`` on 127.0.0.1 over a pipelined engine
   like wave P's (``max_queue`` 1024, above the door's in-flight bound of
   512). Wave N: wave P's 1024 pairs from 4 ``NetClient`` threads (128 in
   flight each), every answer equal to wave P's (no new host search), no
   fallback, retry or error, ``minor_level<int8_t>`` launched. Then, the
   engine's distance cache emptied before each: N[traced], 64 queries
   sampled into a ``DTracer`` spool whose merge gives each one
   ``net_client`` -> ``net_ingress`` -> (``queue``, ``resolve``) and no
   orphan; N[deadline], 64 queries with ``deadline_ms = 1``, each a right
   answer or one ``timeout``, the timeouts equal to the rise of
   ``bibfs_net_deadline_misses_total``; N[capacity], a burst of 64 at a
   second door with ``max_inflight = 8``, its refusals equal to the rise
   of ``bibfs_net_rejections_total{reason="capacity"}`` and every
   admitted answer right; N[control], ``ping``, ``health``, ``stats``,
   ``metrics`` (the render holds ``NET_METRIC_FAMILIES``) and
   ``flightrec``. One ``{"phase": "net", ...}`` line a wave (wall,
   queries/s, the client-side p50 / p99, launches, seconds). The CLI
   wave adds ``bibfs-torch-serve --pipeline --port 0 --port-file F
   --metrics-port 0 --trace-spool DIR`` as a child (``N[CLI]``): 64
   queries sampled at this process's client equal the oracle, its
   ``/metrics`` lists the net families and ``/healthz`` answers 200,
   SIGTERM drains it to exit 0, and every sampled query's trace spans
   both processes with no orphan.

9. The lock-step batch of the per-query modes (run after phase 5 on the
   phase 3 graph): kernels 3 and 4 with a query axis
   (``pull_dual_batch``, ``pull_single_batch``) against their plain twins
   on seeded mid-search batches of 256, 37 and 1 queries (about a fifth
   not listed, a random side per listed query for kernel 4) and of 256
   with one listed query (a tail's launch), the
   query-packed plane made from the state's rows, exactly, with a
   ``step`` line each (kernel ms, the twin's ms, the bound for the
   listed rows and PR 9's bound, the listed rows, the table walks per
   launch); then phase 5's 256 pairs
   through ``time_batch_graph`` in modes sync, sync_unfused, alt, beamer,
   beamer_alt, pallas, pallas_alt and fused, every count set to 0 just
   before and read after (both batched kernels must launch): 32 pairs
   equal the single-query search on (best, meet, levels, edges, both
   parent rows), all 256 the oracle's hops, every path valid; one
   ``batch`` line per mode with the peak device memory. Then the sizes
   for the crossover: lock-step sync and pallas and minor8 at 8, 16, 32,
   64 and 128 queries, one ``batch_sweep`` line each. Last, a deep tail:
   the deepest of the pairs alone (B = 1) and beside 255 pad lanes that
   finish at round 0, against its single-query search, in modes sync,
   alt, beamer, pallas and pallas_alt, one ``batch_tail`` line each.

10. The blocked tile route (run last), on three graphs:
   ``grid_graph(128, 1024, perforation=0.02)`` (131,072 vertices, the
   route's full fit at 256 queries) and the two geometries of the JAX
   package's blocked soak, G(2000, 64/2000) and a 64x64 grid (512
   queries). Per graph, the round's two kernels (``blocked_level``: int8
   ``wgmma`` products fed by TMA, both sides of 32 queries per block,
   unoccupied slots skipped, the stamp, counts, degree sums and meet
   vote in its epilogue; ``blocked_fold``: the ``[B]`` vectors) against
   their plain twins on a seeded mid-search state (the search's own
   state after some rounds) at B = 256, a ragged 37 and 1: the next
   plane, the stamped dist, the occupancy flags, the counts, degree sums
   and meet key, and every folded vector exactly equal, one ``step``
   line each (the kernel's ms, the fold's, the round's, the twins'; the
   bound of PR 11's formula: every live tile, the plane read, the next
   plane written and the dist entries this state reads and writes over
   3.35 TB/s, against the int8 products over the card's dense int8
   rate; ``bound_ms_occupied``: only the tiles and sub-planes of
   occupied (group, block column) pairs; both with the epilogue's
   ``deg`` and other-side dist bytes; the occupied share of (group,
   slot) pairs; the bound with the whole dist plane read and written;
   one ``torch.sparse.mm`` of the adjacency and the plane, the expansion
   alone, as a yardstick). Then with every count set to 0: one seeded
   batch per graph through ``blocked_batch_dispatch`` (a warm-up, the
   median of 3), every hop equal to the serial oracle and every path
   valid, timed beside a ``minor8`` batch of the same pairs whose hops
   it equals (one ``{"phase": "blocked_batch", ...}`` line each, with
   the ms per round); on the large grid a ``QueryEngine(blocked=True)``
   wave and a ``PipelinedQueryEngine(blocked=True)`` wave of 256
   distinct pairs (4 submitter threads), each one blocked flush equal to
   ``solve_blocked_batch`` on every field but the time, with no
   fallback, retry, error or open breaker. Both kernels must have
   launched in each.

11. The graph store and the distance oracle (run after phase 10). The
   multi-source BFS sweep kernel ``msbfs_sweep_kernel`` (``csrc/msbfs.cu``:
   one cooperative launch runs every level of a sweep, pushing from a
   frontier worklist or, on dense levels, pulling over the CSR; new bits
   stamped into the ``int16 [n, K]`` plane) at K = 32, 64 and 65 on the
   store's graph, ``grid_graph(500, 500, perforation=0.02, seed=1)``
   (250,000 vertices: the JAX package's oracle soak,
   ``bench_oracle.json``), and on gnp-deg8-s20: the whole sweep on the
   card against the NumPy host sweep (every entry; one launch and one
   host read each), one level from the sweep's own mid state against
   ``msbfs_level_plain`` and a span of 64 levels from it against the
   range twin ``msbfs_levels_plain`` (every output equal), and
   ``build_index`` on the card (on the host too at K = 64 on the grid,
   the same index); one ``step`` line each with the level's ms (with the
   dense-pull rule, every level pulled, every level pushed, and with an
   empty frontier: the launch's own cost), its
   frontier bound (``md.frontier_bytes``: what the level's frontier
   needs, over 3.35 TB/s) and its dense bound (every vertex's CSR row,
   pending and reach words), the span's ms against its twin's, the plain
   level's ms, one ``torch.sparse.mm`` of the adjacency and the 0/1
   pending plane as a yardstick, the sweep's ms (first and warm: the
   call from a host CSR, its plane copied back), its time on the card
   (the CSR there, no copy: ``sweep()`` with its seeding, and the kernel
   alone from a seeded state against the sum of its levels' frontier
   bounds, from the host plane), its levels, dense and sparse levels,
   launches and host reads, and the build's ms split into its sweeps,
   copies, NumPy scoring and index construction
   (``bibfs_tpu_torch.cli.ab.build_split``), and its launches; at K = 64 the sweep on the card under other shares of the
   pull rule (1/16, 1/8, 1/2). One ``msbfs_floor`` line: a sweep of
   20,000 one-vertex levels (a path among the grid's vertices, checked),
   its us a level.
   Then, with every
   count set to 0, the store's path: waves of 2,000 seeded Zipf pairs
   (skew 1.3, a quarter repeats) through a store without an oracle
   (``B[sync]``) and through ``GraphStore(oracle_k=64)`` holding the grid
   and a vertex-relabelled twin (its index built on the card): the
   synchronous and the pipelined engine on the grid, the pipelined one on
   the twin; one update batch (24 adds, 8 deletes) answered by the
   overlay route (64 queries); a compaction swap; and a second update
   with a compaction forced from inside a device flush's launch, whose
   batch must finish on the old snapshot while the next wave sees the
   new one. Every answer equals the native host solver's on the graph it
   was served against (audited against the serial oracle on a sample),
   exactly the queries the oracle answered at submit carry no path and
   every other found answer a valid one, no ticket is lost or left
   outstanding,
   the version moves forward and the index is rebuilt at the new
   generation. One ``{"phase": "store", ...}`` line per wave (routes,
   wall, queries/s, flush and span ms, latency percentiles), and
   ``store_launches``: ``msbfs_sweep`` and ``minor_level[minor8]`` must
   have launched.

12. The durable store (run after phase 11). With every count set to 0,
   ``GraphStore(wal_dir=..., fsync="always", oracle_k=64,
   retain_history=True, sidecar_layouts=("ell",))`` in a directory under
   the gitignored ``.chip_durable/`` holds phase 3's gnp-deg8-s20 and phase
   11's grid-500x500 (their indexes swept on the card), serves a first
   wave of 256 Zipf pairs on each, acks two update batches on each (24 adds
   and 8 deletes, then 16 and 8) and compacts both: a checkpoint ``.bin``
   and a sidecar holding the ``ell.*`` and ``oracle.*`` groups, the index
   built on the card by ``msbfs_sweep`` (``durable_checkpoint``: seconds
   of the updates and the compaction, its spans, the sidecar's and the
   bin's MB). A spawned child recovers the store (both graphs mapped, both
   indexes adopted), acks three more batches on the grid and is
   SIGKILLed after the last ack (``durable_crash``). A second spawned
   process then recovers it: both graphs mapped, gnp's digest and version
   the checkpoint's, the grid's live digest the killed child's, every acked
   add present and every acked delete gone; it serves 2,000 Zipf pairs
   (skew 1.3, a quarter repeats) on gnp through the sync engine and again
   with ``mode="pallas"``, every answer equal to the native host solver's
   on the recovered snapshot, ``minor_level[minor8]`` and
   ``pull_dual_batch`` launched and no ``msbfs_sweep`` (the indexes came
   from the sidecars). It recovers the directory again with
   ``mmap_arrays=False`` (the rebuild path), folds the grid's replayed
   batches into a new checkpoint, sets a residency budget one byte below
   the two graphs' resident bytes (the grid, least recently used, is
   demoted to the cold tier) and serves 2,000 Zipf pairs on the grid: its
   promote counted, every answer exact (``durable_memory``). One
   ``{"phase": "durable", ...}`` line splits each recovery's seconds per
   graph (the sidecar mapped and its digest recomputed, or the ``.bin``
   rebuilt; the WAL replay; the registration with the index adopted)
   beside the upload to the card, the first answer and the first flush of
   256 pairs.

13. The query kinds (run after phase 12). Its inputs are made at the start
   of the run: an update batch of each graph (24 adds, 8 deletes), the
   seeded query streams, and four spawned workers computing the host kind
   rung's answers (NumPy delta-stepping and Yen's on each graph's second
   version) beside phases 1-12. The two kernels of ``csrc/query_device.cu``
   are held to their plain twins on the card, exactly, with one ``step``
   line each (kernel ms, the twin's, passes or levels, launches, the bound
   and a ``torch.sparse.mm`` yardstick): ``delta_stepping_kernel`` on 4
   seeded gnp-deg8-s20 pairs and on grid-500x500's 0 -> 249999 at weight
   seed 0, which must read the reference's 2663.0 over 1014 edges, 532
   buckets and 2,964,583 relaxations, every path of its weight and valid;
   ``restricted_sweep_kernel`` on Yen's first iteration of a gnp pair and
   of a grid pair 100 hops apart, the batched tails the host solver's.
   Then a ``GraphStore(wal_dir=..., retain_history=True)`` under
   ``.chip_durable/`` holds both graphs, each batch acked and compacted
   (versions 1 and 2). With every count set to 0, the synchronous engine
   serves 200 queries of the mix ``pt=0.5, msbfs=0.2, weighted=0.15,
   kshortest=0.1, asof=0.05`` (16 sources, k = 3, as-of versions 1 and 2)
   on gnp in waves of 100, the pipelined engine 150 more, and an engine on
   the grid 64 ``MultiSource`` queries of 32 shared sources and 16
   ``Weighted``: every answer equals the native host solver's hops on the
   version asked (point-to-point, as-of, each source of a multi-source
   query) or the host kind rung's (weighted distances, with a path of that
   weight; k-shortest path lists), the device rungs resolve queries of
   their kinds, no ticket is lost and ``msbfs_sweep``, ``delta_stepping``
   and ``restricted_sweep`` launch. An engine built under
   ``BIBFS_FAULTS=weighted_device:p=1`` serves 8 of the grid's weighted
   queries on the host rung, the fallback counted, every answer the device
   rung's. One ``{"phase": "query_kinds", ...}`` line per wave (kinds,
   routes, kind cache, wall, latency percentiles, fallbacks), and
   ``query_kinds_total`` splits the phase's seconds and says how the host
   references went (``refs_report``: the seconds until the last was done,
   and per kind the workers' wall and CPU seconds). ``kind_refs_main()``
   times the references alone.

14. The vertex-sharded search and the data-parallel batch (run after
   phase 13) on phase 3's gnp-deg8-s20 and phase 4's rmat-s20-ef16, not
   cut: kernels 1, 3 and 4 at a shard's geometry of 4 ranks (the local
   rows, their slots global ids, the global frontier, ``row_offset`` of
   rank 1 on gnp and rank 3 on rmat), each exactly against its twin with
   a ``step`` line (``"step": "shard"``: ms, the twin's, the bytes bound);
   then the one-device dense search's raw outputs of phase 3's pairs in
   every mode and of phase 4's in ``sync`` and ``beamer`` (1 pair a mode
   timed), and its ``minor8`` batch of 512 seeded gnp pairs (timed). Both host graphs are written
   once to a temporary directory and 4 ranks spawned
   (``parallel.mesh.launch``: one card each over NCCL where there are 4
   cards, else all on this card over staged gloo) map them, keep their own
   rows and run: one round's exchange timed (bytes packed and as bools,
   the gather's and the reductions' ms, each rank's peer access), every
   (mode, pair) solved (the mode that ran, hops against the oracle, a path
   ``validate_path`` accepts, all six raw outputs, ``sharded.RAW_FIELDS``,
   equal to the dense search's, parent rows by digest), 1 pair a
   mode timed (5 searches each) beside the dense search, one gnp pair's
   ``fused`` and ``sync`` searches profiled on every rank
   (``sharded.profile_search``: wall, rounds, the card's busy ms, NCCL's
   kernels' ms, the host's ms inside the collective calls; one
   ``sharded_profile`` line each), and the
   data-parallel ``minor8`` batch (128 queries a rank, the median of 3)
   equal to the one-device batch. The phase checks
   the transport it asked for, that kernels 1, 3, 4, the fold and the
   ``minor8`` level launched on the ranks, and prints one line with its
   seconds, its transport and a digest of every answer (the same on one
   card and on four). ``shard_main()`` runs this phase alone.

15. Serving from a rank pool, the 2D search and checkpoints (run after
   phase 14, on phase 3's gnp-deg8-s20 and phase 14's saved host graph):
   one ``parallel.pool.MeshPool`` of 4 ranks for the whole phase
   (``mesh_pool``: its transport and spawn seconds). On the ranks first (a
   ``call`` job, before the counts are zeroed), each rank holds kernels
   1, 3 and 4 at its own shard (``row_offset``) and minor_level at each dp
   wave's slice (128 queries: both instantiations; 256: ``minor8``, which
   the waves take) exactly against their twins and timed (``"step":
   "shard"`` lines of each rank; the level's ms a rank and slice in the
   kernels line's ``mesh_ranks``). With the ranks' counts
   zeroed, engines over one ``GraphStore`` of gnp: the dp sub-path
   (``MeshConfig(shard_min_n=n + 1)``, the default dp crossover of 512
   queries) in a warm-up wave and synchronous waves of 512 and 1024, and
   one pipelined wave of 1024, every answer (found, hops, path) equal to
   a one-device engine's on the same pairs and (found, hops) to the
   native host solver's (``mesh_dp`` lines: the mesh's flush ms beside
   the one-device engine's); one wave of 64 below the crossover, counted
   as a reroute and served by the device rung (``mesh_reroute``); the
   vertex-sharded sub-path (``shard_min_n=0``) in ``fused`` (16 queries),
   ``pallas`` (16) and ``pallas_alt`` (8), the queries one after another
   on the ranks (``mesh_sharded``: ms a query, the exchange bytes packed
   and as bools); a hot swap between two waves of the same 512 pairs on
   the pipelined engine over a second store graph, G(2^17, 8/2^17) (a
   compaction of gnp-deg8-s20 is ~25 s of host code), 64 of them joined
   by an edge in the swapped snapshot, with 0 stale answers
   (``mesh_swap``). Then the 2D search on
   a 2x2 grid of the ranks: phase 3's 9 pairs in ``sync`` and ``alt``
   equal to the dense search on every field but the path (the 2D parent
   is the max over the blocks' first hits), each path valid, 2 pairs a
   mode timed beside the dense search (``mesh_2d``), and one round's
   exchanges timed with the 2D and 1D bytes a side
   (``mesh_2d_exchange``). Then a ``pallas`` checkpointed search of
   phase 3's first pair stopped after one chunk on this card and resumed
   on this card, on the 1D pool and on the 2x2 grid, each equal to the
   one-shot search (``mesh_checkpoint``: the snapshot's MB, the seconds
   of the stopped chunk). ``mesh_launches`` (the ranks' counts: kernels
   1, 3, 4, the fold and ``minor_level[minor8]`` must have launched),
   then each dp wave's pairs sent once more as one dp job
   (``mesh_dp_split``: the ranks' batch clock against the job's round
   trip), and ``mesh_total`` (seconds, spawn seconds, the flush ms, a
   digest of the answers). ``shard_main()`` runs phases 14 and 15 alone,
   rmat-s20 built by :func:`rmat_prep`'s child beside gnp's build.
   ``main()``'s ``done`` line holds each phase's seconds (``phases_s``).

16. Whole-graph analytics (run after phase 15) on three seeded graphs,
   each built on the host with a ``graph`` line of its tiles and bytes:
   G(10,000, 128/9,999) (n not a tile multiple: 79 x 79 tiles, 102 MB of
   int8), G(5,000, 64/4,999) (40 x 40 tiles, 105 MB of f32 weights a
   seed) and phase 10's 64x64 grid (a Bellman depth over 126 sweeps).
   Independent host references by scipy first (Dijkstra with
   ``indices``, ``connected_components`` mapped to min labels, a float64
   sparse power iteration, a row-blocked ``(A @ A) * A`` triangle count).
   Then each kernel of ``csrc/semiring.cu`` against its plain twin on the
   card at the rungs' shapes: ``minplus_fixpoint`` over each graph's
   packed tile rows (SSSP planes of C = 8 and 4 on gnp-5000 and 1 on the
   grid, labels on gnp-10000 and the grid) bit for bit with equal rounds,
   and its status words (sweeps in one block and on the grid, active block
   rows) equal to what the worklist twin's sweeps give, after a
   ``minplus_floor`` line (a near-empty sweep's ms in each mode, on a
   2,000-vertex path); ``pagerank`` on gnp-10000 within 1e-6,
   the same ranks on a second run, iterations equal or one off at a
   straddled tolerance; ``tricount`` on every 256-column chunk of
   gnp-10000 exactly; the last two over gnp-10000's packed tile rows,
   whose pack (``pack_tile_rows``) is held to its twin bit for bit. One
   ``step`` line each: the median ms of 5 launches, the twin's ms, the
   bound (the live tiles' and the plane's bytes a sweep or step times the
   sweeps or steps over 3.35 TB/s; for a triangle chunk the larger of the
   tile bytes and the dense product's int8 operations over 1,979 TOP/s;
   for the pack the int8 table read and its eighth written; for the
   fixpoint also ``needed_bound_ms``, the bytes its worklist sweeps need,
   ``floor_ms``, its sweeps at the floor's cost, ``active_rows`` and the
   sweeps by mode), beside it
   for PageRank and a chunk ``bound_packed_ms`` (the packed rows they
   read, bcol and the vectors) and ``pack_ms``, for PageRank ``step_ms``
   (one launch of 50 power steps that no tolerance ends, divided by 50:
   the steady step without the solve's set-up and host read, beside
   ``library_call_ms``) and ``floor_ms_per_step`` (the same on an
   edgeless table of the same rows: a step with no row work), and a
   one-call PyTorch
   yardstick (``torch.sparse.mm`` of the adjacency and one vector a power
   step, a dense ``torch.matmul`` of a chunk); and ``msbfs_plane_blocked``
   (row B, torch code with no hand kernel) on the grid from 64 sources
   against the ELL sweep's plane, with its bound and a ``torch.sparse.mm``
   yardstick. With the counts zeroed, the
   engines on the card: a synchronous and a pipelined wave of the four
   kinds on gnp-10000 (PageRank, components, triangles on their blocked
   rungs; SSSP over the f32 table's x5 gate on the host rung; between
   them ``A[warm]``, one more PageRank on the warm synchronous engine),
   one flush
   of 8 + 4 SSSP queries of two weight seeds on gnp-5000 (two planes on
   the blocked rung), and over a ``GraphStore`` of the grid the four
   kinds blocked, a repeat on a second (pipelined) engine from the
   ``store`` route, then an adds-only update of 8 edges, compacted, after
   which SSSP and components are maintained incrementally (two
   ``incremental`` events). Every answer equals the scipy references
   (PageRank within 2e-4), every wave's routes are the expected ones, and
   no engine falls back, retries, errs or opens a breaker (one
   ``analytics`` line a wave); ``analytics_launches`` (each kernel
   launched). After the counts are read, ``analytics_split``
   (:func:`pagerank_split`): a PageRank answer's time on a new engine,
   first flush and warm, and its route's steps one by one (a pack into a
   new allocation, the launch's set-up, the kernel, the status and ranks
   reads; the engine open and closed); then ``analytics_total`` (the
   phase's seconds by part). The pipelined engine of gnp-10000 also
   answers one ``analytics`` op through a ``NetServer`` (``N[analytics]``),
   equal to its own answer. On
   the host, ``analytics_phase("cpu", graphs=...)`` with small graphs
   rehearses it (the rungs forced as the card's gates place them).

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the card's name and power limit, and before that the ``kernels``
JSON line.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import queue
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from bibfs_tpu_torch.cli.ab import build_split
from bibfs_tpu_torch.graph.csr import (
    build_csr,
    build_ell,
    build_tiered,
    canonical_pairs,
)
from bibfs_tpu_torch.graph.blocked import build_blocked, build_blocked_weights
from bibfs_tpu_torch.graph.generate import gnp_random_graph, grid_graph, rmat_graph
from bibfs_tpu_torch.ops import _cuda
from bibfs_tpu_torch.ops import blocked_expand as be
from bibfs_tpu_torch.ops import bitmap as bm
from bibfs_tpu_torch.ops import fused_level as fl
from bibfs_tpu_torch.ops import minor_level as ml
from bibfs_tpu_torch.ops import msbfs_device as md
from bibfs_tpu_torch.ops import pull_expand as pe
from bibfs_tpu_torch.ops import semiring_plane as sr
from bibfs_tpu_torch.ops.expand import pack_dual
from bibfs_tpu_torch.solvers import batch_minor as bmin
from bibfs_tpu_torch.obs.trace import Tracer, set_tracer
from bibfs_tpu_torch.oracle import build_index, multi_source_bfs
from bibfs_tpu_torch.serve import PipelinedQueryEngine, QueryEngine
from bibfs_tpu_torch.serve.loadgen import sample_skewed_pairs
from bibfs_tpu_torch.solvers import dense
from bibfs_tpu_torch.solvers import query_device as qd
from bibfs_tpu_torch.solvers.api import validate_path
from bibfs_tpu_torch.solvers.native import NativeGraph, solve_batch_native_graph
from bibfs_tpu_torch.solvers.serial import solve_serial_csr
from bibfs_tpu_torch.store import GraphStore
from bibfs_tpu_torch.solvers.timing import timed_batch_repeats

INF32 = 1 << 30
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12  # H100 SXM non-tensor-core rate (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate (data sheet)
SLEEP_CYCLES = 2_000_000  # keeps the card busy while the host enqueues a launch
REPS = 25

KERNELS = {  # wrapper, plain twin, source, the Pallas kernel it replaces
    "fused_dual_round": (fl.fused_dual_round, fl.fused_dual_round_plain,
                         "bibfs_tpu_torch/csrc/fused_level.cu",
                         "bibfs_tpu/ops/pallas_fused.py:145"),
    "fused_single_round": (fl.fused_single_round, fl.fused_single_round_plain,
                           "bibfs_tpu_torch/csrc/fused_level.cu",
                           "bibfs_tpu/ops/pallas_fused.py:249"),
    "pull_dual": (pe.pull_dual, pe.pull_dual_plain,
                  "bibfs_tpu_torch/csrc/pull_expand.cu",
                  "bibfs_tpu/ops/pallas_expand.py:195"),
    "pull_single": (pe.pull_single, pe.pull_single_plain,
                    "bibfs_tpu_torch/csrc/pull_expand.cu",
                    "bibfs_tpu/ops/pallas_expand.py:186"),
    # not a Pallas kernel: the scalar fixup after each fused round
    "fold_round": (fl.fold_round, fl.fold_round_plain,
                   "bibfs_tpu_torch/csrc/fused_level.cu",
                   "bibfs_tpu/solvers/dense.py:812"),
}
# the batch-minor level, one entry per instantiation (int32 planes for mode
# "minor", int8 for "minor8"); not a Pallas kernel but the XLA program of
# the reference's _level_scan. Its wrapper counts per instantiation.
MINOR = {
    "minor_level[minor]": ("minor", "bibfs_tpu_torch/csrc/batch_minor.cu",
                           "bibfs_tpu/solvers/batch_minor.py:133"),
    "minor_level[minor8]": ("minor8", "bibfs_tpu_torch/csrc/batch_minor.cu",
                            "bibfs_tpu/solvers/batch_minor.py:133"),
}
BATCH = 256  # queries of a batch at full size
# kernels 3 and 4 with a query axis (phase 9): what pallas_call's batching
# rule makes of the Pallas kernels under the reference's vmapped search
LOCKSTEP = {
    "pull_dual_batch": (pe.pull_dual_batch, pe.pull_dual_batch_plain,
                        "bibfs_tpu_torch/csrc/pull_expand.cu",
                        "bibfs_tpu/ops/pallas_expand.py:195"),
    "pull_single_batch": (pe.pull_single_batch, pe.pull_single_batch_plain,
                          "bibfs_tpu_torch/csrc/pull_expand.cu",
                          "bibfs_tpu/ops/pallas_expand.py:186"),
}
# the per-query modes a batch runs lock-step (fused runs as pallas)
LOCKSTEP_MODES = ("sync", "sync_unfused", "alt", "beamer", "beamer_alt",
                  "pallas", "pallas_alt", "fused")
SWEEP = (8, 16, 32, 64, 128)  # batch sizes of the crossover sweep
TAIL_MODES = ("sync", "alt", "beamer", "pallas", "pallas_alt")
# phase 10: (name, graph maker, batch of the batch drive, rounds run
# before the kernel is held to its twin: the planes are mid-search)
BLOCKED_GEOMS = (
    ("grid-128x1024",
     lambda: (128 * 1024, grid_graph(128, 1024, perforation=0.02, seed=1)),
     BATCH, 120),
    # (diameter ~3: after one round most queries are done, so its state is
    # the first round's)
    ("gnp-deg64", lambda: (2000, gnp_random_graph(2000, 64 / 2000, seed=1)),
     512, 0),
    ("grid-64x64", lambda: (64 * 64, grid_graph(64, 64, perforation=0.02, seed=1)),
     512, 12),
)


# phase 10's two kernels a blocked round launches: the source, and what each
# replaces (neither is a Pallas kernel): the XLA dot_general of the
# expansion with its body's stamp, and the body's [B] updates
BLOCKED_KERNELS = {
    "blocked_level": ("bibfs_tpu_torch/csrc/blocked_expand.cu",
                      "bibfs_tpu/ops/blocked_expand.py:82",
                      {"ported": "PR 11", "redesigned": "PR 12"}),
    "blocked_fold": ("bibfs_tpu_torch/csrc/blocked_expand.cu",
                     "bibfs_tpu/solvers/dense.py:225", {"ported": "PR 12"}),
}


# phase 11: the multi-source BFS sweep of the oracle's index builds; not a
# Pallas kernel but the XLA while_loop of the reference's ELL sweep
MSBFS = ("bibfs_tpu_torch/csrc/msbfs.cu", "bibfs_tpu/ops/msbfs_device.py:89",
         {"ported": "PR 13", "redesigned": "PR 14"})
SPAN = 64  # levels of the range check from the mid state
DENSE_SHARES = (1 / 16, 1 / 8, 1 / 2)  # the pull rule's share, besides 1/4
FLOOR_PATH = 20_000  # a path's vertices: a sweep of one-vertex levels
MSBFS_KS = (32, 64, 65)  # landmarks per sweep (1, 2 and 3 mask words)
ORACLE_K = 64  # the JAX package's oracle soak (bench_oracle.json)
STORE_QUERIES = 2000  # the soak's traffic: Zipf skew 1.3, a quarter repeats
# phase 11's graphs: (geometry, vertices, edge maker, the level whose state
# the kernel is held to its plain version on, the sources' seed)
MSBFS_GEOMS = (
    ("grid-500x500", 500 * 500,
     lambda: grid_graph(500, 500, perforation=0.02, seed=1), 200, 71),
    ("gnp-deg8-s20", 1 << 20,
     lambda: gnp_random_graph(1 << 20, 8 / (1 << 20), seed=7), 4, 73),
)


# the unstaged instantiation of kernel 2, which the wrapper takes only
# where the bitmap does not fit shared memory (not counted in .launches)
UNSTAGED = fl._single_round_unstaged


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def reset_counts() -> None:
    for wrapper, *_ in (*KERNELS.values(), *LOCKSTEP.values()):
        wrapper.launches = 0
    for key in ml.minor_level.launches:
        ml.minor_level.launches[key] = 0
    be.blocked_level.launches = 0
    be.blocked_fold.launches = 0
    md.msbfs_levels.launches = 0
    qd.delta_stepping.launches = 0
    qd.restricted_sweep.launches = 0
    sr.minplus_fixpoint.launches = 0
    sr.pagerank_blocked.launches = 0
    sr.triangles_chunk_blocked.launches = 0
    sr.pack_tile_rows.launches = 0


def counts() -> dict:
    out = {name: k[0].launches
           for name, k in (*KERNELS.items(), *LOCKSTEP.items())}
    for name, (key, *_r) in MINOR.items():
        out[name] = ml.minor_level.launches[key]
    out["blocked_level"] = be.blocked_level.launches
    out["blocked_fold"] = be.blocked_fold.launches
    out["msbfs_sweep"] = md.msbfs_levels.launches
    out["delta_stepping"] = qd.delta_stepping.launches
    out["restricted_sweep"] = qd.restricted_sweep.launches
    out["minplus_fixpoint"] = sr.minplus_fixpoint.launches
    out["pagerank"] = sr.pagerank_blocked.launches
    out["tricount"] = sr.triangles_chunk_blocked.launches
    out["pack_tile_rows"] = sr.pack_tile_rows.launches
    return out


def max_abs_err(a, b) -> int:
    """Largest absolute difference over matching outputs (ints)."""
    err = 0
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            check(x.shape == y.shape, f"shape {tuple(x.shape)} != {tuple(y.shape)}")
            if x.numel():
                err = max(err, int((x.long() - y.long()).abs().max()))
        else:
            err = max(err, abs(int(x) - int(y)))
    return err


def time_launch(fn, prep=None, reps: int = REPS) -> float:
    """Median ms of one call of ``fn`` over ``reps`` calls (after 2
    warm-ups), each between two CUDA events; ``prep`` restores the inputs
    outside the timed interval, and a sleep kernel keeps the card busy
    while the host enqueues the call."""
    times = []
    for i in range(reps + 2):
        if prep is not None:
            prep()
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        if i >= 2:
            times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slots_needed(nbr_t, n_rows: int, front, want) -> int:
    """Table slots a row-at-a-time claim must read for this state: live
    slots of each row, in order, until every wanted side has a hit."""
    return int(slots_read(nbr_t, n_rows, front, want).sum())


def slots_read(nbr_t, n_rows: int, front, want):
    """Each row's table slots in :func:`slots_needed`, int64 ``[n_rows]``."""
    vals = pe.gather_bits(front, nbr_t, n_rows)
    live = nbr_t[:, :n_rows] < front.shape[0]
    want = want.to(torch.uint8)
    found = torch.zeros(n_rows, dtype=torch.uint8, device=nbr_t.device)
    read = torch.zeros(n_rows, dtype=torch.int64, device=nbr_t.device)
    for j in range(nbr_t.shape[0]):
        going = (found != want) & live[j]
        read += going.long()
        found |= torch.where(going, vals[j] & want, 0).to(torch.uint8)
    return read


def sector_bytes(nbr_t, n_rows: int, front, want, chunk: int) -> int:
    """Table bytes a claim in chunks of ``chunk`` slots pulls from device
    memory on this state, counted in 32-byte sectors (one slot of 8
    consecutive rows in the slot-major table): a row reads whole chunks
    of its live slots until every wanted side has a hit, and a sector is
    read when any of its 8 rows reads that slot."""
    width = nbr_t.shape[0]
    vals = pe.gather_bits(front, nbr_t, n_rows)
    live = nbr_t[:, :n_rows] < front.shape[0]
    want = want.to(torch.uint8)
    found = torch.zeros_like(want)
    read = torch.zeros(n_rows, dtype=torch.int64, device=nbr_t.device)
    for c in range(0, width, chunk):
        going = found != want
        hits = torch.zeros_like(want)
        for j in range(c, min(c + chunk, width)):
            read += going & live[j]
            hits |= torch.where(live[j], vals[j] & want, 0).to(torch.uint8)
        found |= torch.where(going, hits, 0).to(torch.uint8)
    touched = torch.arange(width, device=nbr_t.device)[:, None] < read[None, :]
    touched = torch.nn.functional.pad(touched, (0, -n_rows % 8))
    return int(touched.view(width, -1, 8).any(2).sum()) * 32


def mid_search(rng, n: int, rows: int, level: int):
    """A seeded mid-search side: ~30% of the vertices visited at levels
    0..level, the frontier being those at ``level``; parents random ids
    where visited."""
    dist = np.full(rows, INF32, np.int32)
    vis = rng.random(n) < 0.3
    dist[:n][vis] = rng.integers(0, level + 1, int(vis.sum()))
    par = np.where(dist < INF32, rng.integers(0, n, rows), -1).astype(np.int32)
    return dist, dist == level, par


def step_line(kernel: str, geometry: str, step: str, ms: float, **extra) -> None:
    print(json.dumps({"phase": "step", "kernel": kernel, "geometry": geometry,
                      "step": step, "ms": ms, **extra}), flush=True)


def pull_phase(nbr_t, deg, n: int, rng, geometry: str, timed: bool,
               results: dict | None) -> None:
    """Kernels 3 and 4 against their plain versions on one seeded
    mid-search state; with ``timed``, one ``step`` line per kernel, and
    the times into ``results`` when given."""
    dev = nbr_t.device
    n_pad = nbr_t.shape[1]
    cu = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    ds, frs, _ = mid_search(rng, n, n_pad, 2)
    dt, frt, _ = mid_search(rng, n, n_pad, 2)
    fr_s, fr_t = cu(frs), cu(frt)
    vis_s, vis_t = cu(ds < INF32), cu(dt < INF32)
    dual = pack_dual(fr_s, fr_t).contiguous()
    words = bm.frontier_words(n_pad)
    bits_s = bm.pack_bits(fr_s, words)
    pair = pe.pack_front(fr_s, fr_t, n_pad)
    unvisited_s = (~vis_s).to(torch.uint8)
    cases = {  # arguments, the sides each row wants, sides
        "pull_single": ((nbr_t, deg, bits_s, vis_s), unvisited_s, 1),
        "pull_dual": ((nbr_t, deg, pair, vis_s, vis_t),
                      unvisited_s | ((~vis_t).to(torch.uint8) << 1), 2),
    }
    for name, (args, want, k) in cases.items():
        wrapper, plain = KERNELS[name][:2]
        ref = plain(*args)
        got = wrapper(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        check(err == 0, f"{name} differs from its plain version (max {err})")
        if not timed:
            continue
        sl = slots_needed(nbr_t, n_pad, dual, want)
        # the function's bytes: per side the frontier bitmap read and the
        # next one written, the visited byte and 5 B of output per row;
        # 4 B per table slot needed; beside it, the bound with a byte
        # frontier row (one byte per vertex) in place of the bitmaps
        bits_row = 4 * ((n_pad + 31) // 32)
        nbytes = k * (2 * bits_row + 6 * n_pad) + 4 * sl
        b, by = bound_ms(nbytes, 4 * sl)
        b1, _ = bound_ms((1 + k) * n_pad + 5 * k * n_pad + 4 * sl, 4 * sl)
        # an estimate from this state, not measured: the table's sectors a
        # claim in chunks touches, plus the row entries read and written
        est = sector_bytes(nbr_t, n_pad, dual, want, pe.CHUNK) + n_pad * (4 + 6 * k)
        ms = time_launch(lambda: wrapper(*args))
        step_line(name, geometry, "bitmap" if k == 1 else "pair", ms,
                  bound_ms=b, bound_ms_byte_row=b1,
                  est_sector_mb=est / 1e6, est_sector_tb_per_s=est / ms / 1e9)
        if results is not None:
            results[name] = dict(max_abs_err=err, ms=ms,
                                 plain_ms=time_launch(lambda: plain(*args)),
                                 bound_ms=b, bound_by=by)
    if timed:
        # the tiered route rebuilds the next frontier after the tier pass
        nf_s, _, nf_t = pe.pull_dual(*cases["pull_dual"][0])[:3]
        step_line("pull_single", geometry, "rebuild_bits",
                  time_launch(lambda: bm.pack_bits(nf_s, words)))
        step_line("pull_dual", geometry, "rebuild_pair",
                  time_launch(lambda: pe.pack_front(nf_s, nf_t, n_pad)))


def kernel_phase(g, seed: int, results: dict | None, geometry: str,
                 time_pull: bool) -> None:
    """Each kernel against its plain version on one seeded state of
    graph ``g``; times and bounds go into ``results`` when given, and the
    pull kernels are timed when ``time_pull``."""
    dev = g.device
    rng = np.random.default_rng(seed)
    n, n_pad = g.n, g.n_pad
    cu = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731

    # one table serves all four kernels, as in the solver
    nbr_t, deg2 = fl.prepare_fused_tables(g.nbr, g.deg)
    rows = nbr_t.shape[1]

    pull_phase(nbr_t, deg2, n, rng, geometry, time_pull, results)

    # kernels 1 and 2 and the fold; the frontiers are bitmaps at the
    # parity of each side's level (source side at level 2, target at 3)
    ds, frs, ps = mid_search(rng, n, rows, 2)
    dt, frt, pt = mid_search(rng, n, rows, 3)
    dual = pack_dual(cu(frs), cu(frt)).contiguous()
    base = dict(
        bits=fl._bits_of_row(dual, 2, 3, rows),
        dist_s=cu(ds), dist_t=cu(dt), par_s=cu(ps), par_t=cu(pt),
    )
    cnt_s, cnt_t = int(frs.sum()), int(frt.sum())
    for name, alt, side_s in (("fused_dual_round", False, 0),
                              ("fused_single_round", True, 0),
                              ("fused_single_round", True, 1)):
        st0 = torch.tensor([2, 3, INF32, -1, cnt_s if side_s == 0 else cnt_t + 1,
                            cnt_t, 0, 0, 5, 7, 9, 11], dtype=torch.int32)

        def fresh():
            acc, key = fl.new_scratch(dev)
            return dict(bits=base["bits"].clone(),
                        dist_s=base["dist_s"].clone(), dist_t=base["dist_t"].clone(),
                        par_s=base["par_s"].clone(), par_t=base["par_t"].clone(),
                        state=st0.to(dev), acc=acc, key=key)

        def run(fn, b):
            fn(nbr_t, deg2, b["bits"], b["dist_s"], b["dist_t"],
               b["par_s"], b["par_t"], b["state"], b["acc"], b["key"])

        wrapper, plain = KERNELS[name][:2]
        p = fresh()
        run(plain, p)
        outs = ("bits", "dist_s", "dist_t", "par_s", "par_t", "acc", "key")
        # kernel 1, or kernel 2 unstaged and then through the wrapper (which
        # stages, as every geometry here fits), each exactly against the
        # plain twin; the fold below takes the wrapper's round
        for label, fn in ([("unstaged", UNSTAGED)] if alt else []) + [
                ("wrapper", wrapper)]:
            k = fresh()
            run(fn, k)
            torch.cuda.synchronize()
            err = max_abs_err([k[o] for o in outs], [p[o] for o in outs])
            check(err == 0, f"{name} ({label}, side {side_s}) differs from "
                  "its plain version")
        # the fold of this round's reductions, kernel against plain
        fl.fold_round(k["state"], k["acc"], k["key"], alt=alt)
        fl.fold_round_plain(p["state"], p["acc"], p["key"], alt=alt)
        torch.cuda.synchronize()
        ferr = max_abs_err([k["state"], k["acc"], k["key"]],
                           [p["state"], p["acc"], p["key"]])
        check(ferr == 0, f"fold_round (alt={alt}) differs from its plain version")
        if results is None or name in results:
            continue
        sides = (0, 1) if not alt else (side_s,)
        want = torch.zeros(rows, dtype=torch.uint8, device=dev)
        for s in sides:
            want |= ((base["dist_s" if s == 0 else "dist_t"] >= INF32)
                     .to(torch.uint8) << s)
        sl = slots_needed(nbr_t, rows, dual, want)
        new = [int((k[d] != base[d]).sum()) for d in ("dist_s", "dist_t")]
        # each advancing side reads its frontier bitmap and writes the next
        bitmaps = 2 * len(sides) * 4 * ((rows + 31) // 32)
        nbytes = 8 * rows + bitmaps + 4 * sl + 4 * sum(new) + 8 * sum(new)
        work = fresh()

        def prep(b=work):
            for key in ("dist_s", "dist_t", "par_s", "par_t"):
                b[key].copy_(base[key])
            b["state"].copy_(st0)
            b["acc"].zero_()
            b["key"].fill_(fl.NO_MEET)

        t_k = time_launch(lambda: run(wrapper, work), prep)
        t_p = time_launch(lambda: run(plain, work), prep)
        bms, by = bound_ms(nbytes, 4 * sl)
        steps = ({"persistent": time_launch(lambda: run(UNSTAGED, work), prep),
                  "staged": t_k} if alt else {"persistent": t_k})
        # estimates from this state, not measured: the whole table sectors
        # a claim touches in chunks of CHUNK slots and in a row-at-a-time
        # chain, plus the dist rows of both sides and the degree row
        est = {c: sector_bytes(nbr_t, rows, dual, want, c) + 12 * rows
               for c in (1, pe.CHUNK)}
        for step, ms in steps.items():
            step_line(name, geometry, step, ms, bound_ms=bms,
                      est_sector_mb=est[pe.CHUNK] / 1e6,
                      est_sector_mb_chain=est[1] / 1e6,
                      est_sector_tb_per_s=est[pe.CHUNK] / ms / 1e9)
        results[name] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p,
                             bound_ms=bms, bound_by=by, steps_ms=steps)
        if "fold_round" not in results:
            def fold_prep(b=work):
                prep()
                run(wrapper, b)

            results["fold_round"] = dict(
                max_abs_err=ferr,
                ms=time_launch(lambda: fl.fold_round(work["state"], work["acc"],
                                                     work["key"], alt=False),
                               fold_prep),
                plain_ms=time_launch(
                    lambda: fl.fold_round_plain(work["state"], work["acc"],
                                                work["key"], alt=False),
                    fold_prep),
                # reads and writes the state row, accumulators and key; one
                # thread, so the launch floor binds long before the bytes
                bound_ms=2 * (4 * 12 + 4 * 6 + 8) / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes",
            )


def oracle(n, csr, pairs):
    return [solve_serial_csr(n, csr[0], csr[1], s, d) for s, d in pairs]


def raw(g, s, d, mode, unroll=1):
    best, meet, par_s, par_t, levels, edges = dense._run(g, s, d, mode, unroll, None)
    return (best, meet, par_s, par_t, levels, edges)


def same_raw(a, b) -> bool:
    return (a[0] == b[0] and a[1] == b[1] and a[4] == b[4] and a[5] == b[5]
            and torch.equal(a[2], b[2]) and torch.equal(a[3], b[3]))


def drive(g, csr, pairs, want, modes, groups, repeats: int) -> list[dict]:
    """Solve every pair in every mode through ``time_search``; check each
    against the oracle and ``validate_path``, and each mode of a group
    against the group's first mode exactly."""
    rows = []
    ref = {}
    for mode in modes:
        times, teps, syncs, ran = [], [], [], set()
        for (s, d), w in zip(pairs, want):
            ts, res = dense.time_search(g, s, d, repeats=repeats, mode=mode)
            check(res.found == w.found and res.hops == w.hops,
                  f"{mode} {s}->{d}: hops {res.hops} != oracle {w.hops}")
            if res.found:
                check(validate_path(csr, res.path, s, d, hops=res.hops),
                      f"{mode} {s}->{d}: invalid path")
            out = raw(g, s, d, mode)
            check(out[2].shape == (g.n_pad,) and out[3].shape == (g.n_pad,),
                  f"{mode}: parent rows of the wrong shape")
            for group in groups:
                if mode in group:
                    key = (group[0], s, d)
                    if mode == group[0]:
                        ref[key] = out
                    else:
                        check(same_raw(out, ref[key]),
                              f"{mode} != {group[0]} on {s}->{d}")
            times.append(float(np.median(ts)))
            teps.append(res.edges_scanned / float(np.median(ts)))
            syncs.append(res.host_syncs)
            ran.add(res.mode)
        rows.append(dict(mode=mode, ran=sorted(ran),
                         median_search_ms=float(np.median(times)) * 1e3,
                         median_teps=float(np.median(teps)),
                         host_syncs_per_solve=float(np.mean(syncs))))
        print(json.dumps({"phase": "solve", **rows[-1]}), flush=True)
    return rows


def seeded_pairs(rng, candidates, k: int) -> list[tuple[int, int]]:
    pick = rng.choice(candidates, size=(k, 2))
    pairs = [(int(a), int(b)) for a, b in pick]
    return pairs + [(pairs[0][0], pairs[0][0])]


def hub_edges(n: int, seed: int) -> np.ndarray:
    """G(n, 3/n) plus five hubs of about 90 neighbours each."""
    rng = np.random.default_rng(seed)
    hubs = [(h, int(v)) for h in range(5)
            for v in rng.choice(np.arange(5, n), 90, replace=False)]
    return np.concatenate([gnp_random_graph(n, 3.0 / n, seed=seed),
                           np.array(hubs)])


def minor_state(g, rows: int, b: int, dt8: bool, seed: int):
    """A seeded mid-search state of the batch-minor planes ``[rows, b]``,
    made on the card: about 30% of the vertices visited per side at levels
    0..2 (the frontier those at 2), about a fifth of the queries inactive,
    and the last two queries pad queries (``src == dst == 0``)."""
    dev = g.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pdt = torch.int8 if dt8 else torch.int32
    inf = ml.plane_inf(pdt)
    live = torch.arange(rows, device=dev)[:, None] < g.n

    def rand_int(hi):
        return torch.randint(0, hi, (rows, b), generator=gen, device=dev,
                             dtype=torch.int32)

    def side():
        vis = (torch.rand((rows, b), generator=gen, device=dev) < 0.3) & live
        return torch.where(vis, rand_int(3), inf).to(pdt)

    ds, dt = side(), side()
    hi = g.width if dt8 else g.n
    ps = torch.where(ds < inf, rand_int(hi), -1).to(pdt)
    pt = torch.where(dt < inf, rand_int(hi), -1).to(pdt)
    for plane, start in ((ds, inf), (dt, inf), (ps, -1), (pt, -1)):
        plane[:, -2:] = start
    ds[0, -2:] = 0
    dt[0, -2:] = 0
    dual = (ds == 2).to(pdt) | ((dt == 2).to(pdt) << 1)
    active = (torch.rand(b, generator=gen, device=dev) < 0.8).to(torch.int32)
    active[-2:] = 0
    return dual, [ds, dt, ps, pt], active


def minor_kernel_phase(g, geometry: str, seed: int, results: dict | None,
                       bpairs=None, lanes: int | None = None,
                       modes=None) -> dict:
    """The batch-minor level (both instantiations) against its packed plain
    twin on one seeded mid-search state at the batch geometry of ``BATCH``
    queries (``batch_minor._minor_geometry``): the packed frontier and
    visited words, the distance and parent planes, counters and meet keys
    exactly equal. The input key is the full vote of the state's planes
    (the state is random and has no earlier level). With ``results``, one
    ``step`` line per instantiation: kernel ms over 25 launches, the
    twin's ms over 5, the bound on the packed state, the bound of the
    int planes the kernel read before (``bound_ms_int_planes``), an
    estimate of the dist and parent sectors the claims touch, and the
    level launches of one batch of ``bpairs``. With ``lanes`` (and no
    ``results``), the check runs at ``pad_batch(lanes)`` queries for the
    instantiations of ``modes`` (default both) and the kernel is timed
    too: returns ``{name: {lanes, max_abs_err, ms}}``."""
    nbr_t = dense._kernel_table(g.tables, g.nbr, g.deg)
    n_tab = nbr_t.shape[1]
    b = bmin.pad_batch(lanes if lanes is not None else
                       BATCH if results is not None else BATCH // 2)
    out = {}
    for name, (mode, *_src) in MINOR.items():
        if modes is not None and mode not in modes:
            continue
        dt8 = mode == "minor8"
        n_pad2, _wp, tc, _b = bmin._minor_geometry(g, b, dt8)
        dual, (ds, dt, ps, pt), active = minor_state(g, n_pad2, b, dt8, seed)
        front = ml.pack_front(dual)
        key = ml.meet_vote(ds, dt)
        base = [ml.pack_vis(ds, dt), ds, dt, ps, pt]
        del dual
        lvl = 3
        work_k = [p.clone() for p in base]
        work_p = [p.clone() for p in base]
        got = ml.minor_level(nbr_t, g.deg, front, *work_k, lvl, active, key)
        want = ml.minor_level_packed_plain(nbr_t, g.deg, front, *work_p, lvl,
                                           active, key, tc=tc)
        torch.cuda.synchronize()
        err = max_abs_err(list(got) + work_k, list(want) + work_p)
        check(err == 0, f"{name} differs from its plain twin at {geometry}")
        if results is None:
            if lanes is not None:
                out[name] = dict(lanes=b, max_abs_err=err, ms=time_launch(
                    lambda: ml.minor_level(nbr_t, g.deg, front, *work_k,
                                           lvl, active, key, checked=True),
                    lambda: [x.copy_(y) for x, y in zip(work_k, base)],
                    reps=5))
            del front, base, work_k, work_p, got, want, ds, dt, ps, pt
            continue
        e = ds.element_size()
        inf = ml.plane_inf(ds.dtype)
        new_s, new_t = work_p[1] != ds, work_p[2] != dt
        claims = int(new_s.sum() + new_t.sum())
        # votes that read the other side's dist: a claim on one side only,
        # where the other side was visited before
        vote_reads = int((new_s & ~new_t & (dt < inf)).sum()
                         + (new_t & ~new_s & (ds < inf)).sum())
        # rows where some active query is unvisited on a side read their
        # live table slots, and each slot one neighbour's front words
        wants = (((ds[:n_tab] >= inf) | (dt[:n_tab] >= inf))
                 & (active[None, :] > 0)).any(1)
        slots = int(torch.minimum(g.deg, torch.tensor(g.width, device=g.device))
                    [wants].sum())
        row = b // 4  # bytes of a pair row: 2 bits per query
        vis_words = int((work_p[0] != base[0]).sum())
        # the function's bytes on the packed state: front and vis read and
        # front_n written once, the vis words that change, a dist and a
        # parent entry per claim, the dist entries the votes read, the live
        # slots of the wanting rows, the degree row; 2 bit tests per slot
        # and query
        nbytes = (3 * n_pad2 * row + 4 * vis_words
                  + (2 * claims + vote_reads) * e + 4 * slots + 4 * n_tab)
        b_ms, by = bound_ms(nbytes, 2 * slots * b)
        # the int-plane count: dual, dist_s and dist_t read and dual_n
        # written once, a dist and a parent entry per claim, the slots
        plane = n_pad2 * b * e
        b_int, _ = bound_ms(4 * plane + 2 * e * claims + 4 * slots + 4 * n_tab,
                            2 * slots * b)
        # 32-byte sectors of the dist and parent planes holding a claim
        per = 32 // e
        sectors = sum(int(c.view(n_pad2, b // per, per).any(2).sum())
                      for c in (new_s, new_t))
        del new_s, new_t, wants

        def restore(work):
            for x, y in zip(work, base):
                x.copy_(y)

        ms = time_launch(lambda: ml.minor_level(nbr_t, g.deg, front, *work_k,
                                                lvl, active, key, checked=True),
                         lambda: restore(work_k))
        plain_ms = time_launch(lambda: ml.minor_level_packed_plain(
            nbr_t, g.deg, front, *work_p, lvl, active, key, tc=tc),
            lambda: restore(work_p), reps=5)
        before = ml.minor_level.launches[mode]
        batch_raw(g, bpairs, mode)
        per_batch = ml.minor_level.launches[mode] - before
        step_line(name, geometry, "packed", ms, plain_ms=plain_ms, bound_ms=b_ms,
                  bound_ms_int_planes=b_int,
                  est_claim_sector_mb=2 * sectors * 32 / 1e6,
                  gather_gb=slots * row / 1e9, launches_per_batch=per_batch,
                  n_pad2=n_pad2, b=b, tc=tc, claims=claims,
                  vote_reads=vote_reads)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=by)
        del front, base, work_k, work_p, got, want, ds, dt, ps, pt
        torch.cuda.empty_cache()
    return out


def batch_pairs(rng, n: int, csr, k: int) -> np.ndarray:
    """``k`` seeded pairs over ``[0, n)``; pair 0 is ``src == dst`` and
    pair 1 ends at an isolated vertex (when the graph has one)."""
    pairs = rng.integers(0, n, size=(k, 2))
    pairs[0, 1] = pairs[0, 0]
    isolated = np.flatnonzero(np.diff(csr[0]) == 0)
    if isolated.size:
        pairs[1, 1] = isolated[0]
    return pairs


def batch_raw(g, pairs, mode):
    """The finished raw outputs of one batch (6 tensors on the card)."""
    _, thunk, finish = dense._batch_dispatch(g, pairs, mode)
    out = finish(thunk())
    torch.cuda.synchronize()
    return out


def same_batch(a, b, n: int) -> bool:
    """Every output equal, the parent rows on the live columns."""
    for x, y in zip(a, b):
        if x.dim() == 2:
            x, y = x[:, :n], y[:, :n]
        if not torch.equal(x, y):
            return False
    return True


def batch_drive(g, csr, pairs, geometry: str, modes, single: str,
                k_check: int = 16) -> dict:
    """Time each batch mode (``time_batch_graph``: a warm-up, then the
    median of 5), check every found path, and hold the first ``k_check``
    pairs against the single-query ``single`` search and the serial
    oracle. Returns each mode's finished raw outputs."""
    n = g.n
    raws = {}
    sub = [(int(s), int(d)) for s, d in pairs[:k_check]]
    want = oracle(n, csr, sub)
    ones = [raw(g, s, d, single) for s, d in sub]
    single_ms = float(np.median([
        np.median(dense.time_search(g, s, d, repeats=5, mode=single)[0])
        for s, d in sub])) * 1e3
    for mode in modes:
        times, res = dense.time_batch_graph(g, pairs, repeats=5, mode=mode)
        out = batch_raw(g, pairs, mode)
        raws[mode] = out
        best, meet, _ps, _pt, levels, edges = (o.cpu() for o in out)
        for i, ((s, d), w, one) in enumerate(zip(sub, want, ones)):
            check((int(best[i]), int(meet[i]), int(levels[i]), int(edges[i]))
                  == (one[0], one[1], one[4], one[5]),
                  f"{geometry} {mode} {s}->{d} differs from single {single}")
            check(res[i].found == w.found and res[i].hops == w.hops,
                  f"{geometry} {mode} {s}->{d}: hops {res[i].hops} != oracle "
                  f"{w.hops}")
        for (s, d), r in zip(pairs, res):
            if r.found:
                check(validate_path(csr, r.path, int(s), int(d), hops=r.hops),
                      f"{geometry} {mode} {s}->{d}: invalid path")
        ms = float(np.median(times)) * 1e3
        print(json.dumps({
            "phase": "batch", "geometry": geometry, "mode": mode,
            "ran": res[0].mode, "b": len(pairs), "batch_ms": ms,
            "ms_per_query": ms / len(pairs), "single_mode": single,
            "single_ms": single_ms, "host_reads_per_batch": res[0].host_syncs,
            "found": sum(r.found for r in res), "times_ms": [t * 1e3 for t in times],
        }), flush=True)
    return raws


def refill_phase(dev) -> None:
    """A path graph with one query deeper than the int8 cap: the capped
    query comes back through the refill equal to the int32 batch."""
    n = 600
    edges = np.array([[i, i + 1] for i in range(n - 1)])
    g = dense.DeviceGraph.build(n, edges, device=dev)
    pairs = np.array([[0, n - 1], [0, 10], [5, 5], [100, 480], [7, 300]])
    _, thunk, finish = dense._batch_dispatch(g, pairs, "minor8")
    rawk = thunk()
    check(bool(rawk[-1][0]) and not bool(rawk[-1][1]),
          "the deep query was not capped under minor8")
    a = finish(rawk)
    b = batch_raw(g, pairs, "minor")
    check(same_batch(a, b, n), "minor8 refill differs from minor")
    res = dense.solve_batch_graph(g, pairs, mode="minor8")
    check(res[0].hops == n - 1 and res[0].path == list(range(n)),
          "the refilled query's path is wrong")
    print(json.dumps({"phase": "batch_refill", "ok": True,
                      "hops": [r.hops for r in res]}), flush=True)


def lockstep_state(g, b: int, seed: int):
    """A seeded mid-search batch made on the card: per side ``[b, n_pad]``
    visited rows (about 30% of the vertices) and frontier rows (a third
    of those), the listed queries (about four fifths; query 0 where the
    draw lists none) and a random side per listed query for kernel 4, both
    on the host, as the wrappers take them."""
    dev = g.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    live = torch.arange(g.n_pad, device=dev) < g.n
    vis = (torch.rand((2, b, g.n_pad), generator=gen, device=dev) < 0.3) & live
    fr = vis & (torch.rand((2, b, g.n_pad), generator=gen, device=dev) < 1 / 3)
    active = torch.rand(b, generator=gen, device=dev) < 0.8
    side = torch.rand(b, generator=gen, device=dev) < 0.5
    if not active.any():
        active[0] = True
    qids = torch.nonzero(active).flatten()
    return fr, vis, qids.cpu(), side[qids].cpu()


def lockstep_bound(nbr_t, n_pad: int, fr, vis, qids, side, dual: bool,
                   written) -> tuple[list, str, float, float]:
    """The bounds of one batched launch, one per row count of
    ``written``: each listed query's frontier bits and visited row read
    once per expanded side, that many queries' output rows (nf, parent)
    and next frontier bits written once, and 4 B for each table slot
    some listed query's claim needs (the table read once for all of
    them); operations, 4 per slot per query. Returns the bounds (ms),
    what bounds the first, the table MB needed and the slots per query."""
    k = 2 if dual else 1
    union = torch.zeros(n_pad, dtype=torch.int64, device=nbr_t.device)
    slots = 0
    for i, q in enumerate(qids.tolist()):
        if dual:
            front = pack_dual(fr[0, q], fr[1, q])
            want_q = ((~vis[0, q]).to(torch.uint8)
                      | ((~vis[1, q]).to(torch.uint8) << 1))
        else:
            t = int(side[i])
            front = fr[t, q].to(torch.uint8)
            want_q = (~vis[t, q]).to(torch.uint8)
        read = slots_read(nbr_t, n_pad, front, want_q)
        union = torch.maximum(union, read)
        slots += int(read.sum())
    bits_row = 4 * bm.frontier_words(n_pad)
    bounds = [bound_ms(len(qids) * k * (bits_row + n_pad)
                       + rows * k * (5 * n_pad + bits_row)
                       + 4 * int(union.sum()), 4 * slots) for rows in written]
    return ([ms for ms, _ in bounds], bounds[0][1], 4 * int(union.sum()) / 1e6,
            slots / len(qids))


def lockstep_kernel_phase(g, geometry: str, results: dict) -> None:
    """Kernels 3 and 4 with a query axis against their plain twins on
    seeded mid-search batches (:func:`lockstep_state`) of ``BATCH``, 37
    and 1 queries, and of ``BATCH`` with one listed query (a tail's
    launch), the plane packed from the state's rows, every output exactly
    equal (the next plane included), and one ``step`` line each: kernel
    ms over 25 launches (the wrapper: its launch metadata, the plane copy
    where a word has no listed query, and the launch), the twin's ms over
    5, the bound for the listed rows and PR 9's (every query's rows
    written, :func:`lockstep_bound`), the listed rows, the table walks per
    launch (the plane words with a listed query: the kernels walk the
    table once per word) and the plane's MB."""
    nbr_t = dense._kernel_table(g.tables, g.nbr, g.deg)
    n_pad = g.n_pad
    for b, seed, one in ((BATCH, 25, False), (37, 26, False), (1, 27, False),
                         (BATCH, 28, True)):
        fr, vis, qids, side = lockstep_state(g, b, seed)
        if one:  # the tail: one listed query among b
            qids, side = qids[:1], side[:1]
        plane = pe.pack_plane(fr[0], fr[1])
        vis_l = (vis[0][qids.to(g.device)], vis[1][qids.to(g.device)])
        cases = {"pull_dual_batch": (nbr_t, g.deg, plane, *vis_l, qids),
                 "pull_single_batch": (nbr_t, g.deg, plane, *vis_l, qids, side)}
        walks = int(torch.unique(qids >> 4).numel())
        for name, args in cases.items():
            wrapper, plain = LOCKSTEP[name][:2]
            got = wrapper(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            check(err == 0, f"{name} differs from its plain twin at {geometry} "
                  f"B={b}")
            del got, want
            dual = name == "pull_dual_batch"
            (b_ms, b9_ms), by, table_mb, per_q = lockstep_bound(
                nbr_t, n_pad, fr, vis, qids, side, dual, (len(qids), b))
            ms = time_launch(lambda: wrapper(*args, checked=True))
            plain_ms = time_launch(lambda: plain(*args), reps=5)
            step_line(name, geometry, "query_axis", ms, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_ms_pr9=b9_ms, b=b,
                      active=len(qids), table_walks=walks,
                      plane_mb=plane.numel() * 4 / 1e6,
                      ms_per_active_query=ms / len(qids),
                      table_mb_needed=table_mb, slots_per_query=per_q)
            if b == BATCH and not one:
                results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                     bound_ms=b_ms, bound_by=by)
        del fr, vis, cases, plane, vis_l
        torch.cuda.empty_cache()


def lockstep_drive(g, csr, pairs, geometry: str, modes, k_check: int,
                   repeats: int = 3) -> None:
    """Each per-query mode as one lock-step batch of ``pairs``
    (``time_batch_graph``: a warm-up, then the median of ``repeats``):
    the first ``k_check`` queries' raw outputs (best, meet, levels, edges,
    both parent rows) equal their single-query search's, every query's
    hops equal the serial oracle's and every found path is valid. One
    ``batch`` line per mode with the batch ms, ms per query, host reads
    per batch and the peak device memory above the resident graph."""
    pairs_l = [(int(s), int(d)) for s, d in pairs]
    want = oracle(g.n, csr, pairs_l)
    for mode in modes:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times, res = dense.time_batch_graph(g, pairs, repeats=repeats, mode=mode)
        peak = torch.cuda.max_memory_allocated() - base
        ran = res[0].mode
        out = batch_raw(g, pairs, mode)
        for i, (s, d) in enumerate(pairs_l[:k_check]):
            one = raw(g, s, d, ran)
            check((int(out[0][i]), int(out[1][i]), int(out[4][i]), int(out[5][i]))
                  == (one[0], one[1], one[4], one[5])
                  and torch.equal(out[2][i], one[2])
                  and torch.equal(out[3][i], one[3]),
                  f"{geometry} lock-step {mode} {s}->{d} differs from its "
                  f"single {ran} search")
        del out
        for (s, d), r, w in zip(pairs_l, res, want):
            check(r.found == w.found and r.hops == w.hops,
                  f"{geometry} lock-step {mode} {s}->{d}: hops {r.hops} != "
                  f"oracle {w.hops}")
            if r.found:
                check(validate_path(csr, r.path, s, d, hops=r.hops),
                      f"{geometry} lock-step {mode} {s}->{d}: invalid path")
        ms = float(np.median(times)) * 1e3
        print(json.dumps({
            "phase": "batch", "geometry": geometry, "mode": mode, "ran": ran,
            "b": len(pairs_l), "batch_ms": ms, "ms_per_query": ms / len(pairs_l),
            "host_reads_per_batch": res[0].host_syncs,
            "peak_mem_gb": peak / 2**30, "found": sum(r.found for r in res),
            "times_ms": [t * 1e3 for t in times],
        }), flush=True)
        torch.cuda.empty_cache()


def sweep_phase(g, pairs, geometry: str) -> None:
    """The sizes for the crossover: lock-step ``sync`` and ``pallas`` and
    ``minor8`` on the first B pairs for each B of :data:`SWEEP`, one
    ``batch_sweep`` line per size (a warm-up, then the median of 3 each);
    the three modes agree on every query's hops."""
    for b in SWEEP:
        sub = pairs[:b]
        line = {"phase": "batch_sweep", "geometry": geometry, "b": b}
        hops = {}
        for mode in ("sync", "pallas", "minor8"):
            times, res = dense.time_batch_graph(g, sub, repeats=3, mode=mode)
            ms = float(np.median(times)) * 1e3
            line[mode] = dict(batch_ms=ms, ms_per_query=ms / b,
                              host_reads=res[0].host_syncs)
            hops[mode] = [(r.found, r.hops) for r in res]
        check(hops["sync"] == hops["pallas"] == hops["minor8"],
              f"sweep B={b}: the modes disagree on hops")
        print(json.dumps(line), flush=True)


def tail_phase(g, pairs, geometry: str) -> None:
    """A lock-step batch whose queries finish rounds apart: the deepest of
    ``pairs`` (by ``minor8``'s hops, which phase 5 held to the oracle)
    alone (B = 1) and beside ``BATCH - 1`` pad lanes ``(0, 0)`` that
    finish at round 0 (an engine's rung padding: one active query of 256
    every round), against its single-query search (``time_search``), in
    the modes of :data:`TAIL_MODES`. One ``batch_tail`` line per mode
    (ms: medians of 5 after a warm-up); the three agree on the hops and
    every pad lane has hops 0."""
    deep = dense.solve_batch_graph(g, pairs, mode="minor8")
    i = max(range(len(deep)),
            key=lambda j: deep[j].hops if deep[j].found else -1)
    s, d = int(pairs[i][0]), int(pairs[i][1])
    padded = np.array([(s, d)] + [(0, 0)] * (BATCH - 1), np.int64)
    for mode in TAIL_MODES:
        single_t, one = dense.time_search(g, s, d, repeats=5, mode=mode)
        b1_t, r1 = dense.time_batch_graph(g, padded[:1], repeats=5, mode=mode)
        pad_t, rp = dense.time_batch_graph(g, padded, repeats=5, mode=mode)
        check(one.hops == r1[0].hops == rp[0].hops == deep[i].hops
              and all(r.found and r.hops == 0 for r in rp[1:]),
              f"{geometry} tail {mode} {s}->{d}: the batches disagree")
        print(json.dumps({
            "phase": "batch_tail", "geometry": geometry, "mode": mode,
            "pair": [s, d], "hops": deep[i].hops,
            "single_ms": float(np.median(single_t)) * 1e3,
            "b1_ms": float(np.median(b1_t)) * 1e3,
            "pad256_ms": float(np.median(pad_t)) * 1e3,
            "host_reads": [one.host_syncs, r1[0].host_syncs, rp[0].host_syncs],
        }), flush=True)
    torch.cuda.empty_cache()


def routing_phase(g2, csr2, pairs2, want2) -> None:
    """rmat-s20-ef16: a 256-query batch routes to the lock-step ``sync``
    batch and ``minor`` is refused (a tier's key overflows int32); 8
    pairs under ``auto`` run lock-step and match the oracle; then 256
    seeded pairs under ``auto`` (:func:`lockstep_drive`, 16 held against
    the single-query search)."""
    check(bmin.auto_batch_mode(g2, BATCH) == "sync", "auto did not pick sync")
    try:
        dense.solve_batch_graph(g2, np.zeros((BATCH, 2), np.int64), mode="minor")
    except ValueError as e:
        refused = str(e)
    else:
        fail("minor was not refused on rmat-s20-ef16")
    res = dense.solve_batch_graph(g2, pairs2[:8], mode="auto")
    for (s, d), w, r in zip(pairs2[:8], want2[:8], res):
        check(r.mode == "sync" and r.found == w.found and r.hops == w.hops,
              f"auto (8 pairs) {s}->{d} differs from the oracle")
    print(json.dumps({"phase": "batch_routing", "ok": True, "auto_256": "sync",
                      "minor_refused": refused,
                      "host_reads_8": res[0].host_syncs}), flush=True)
    pairs256 = batch_pairs(np.random.default_rng(59), g2.n, csr2, BATCH)
    lockstep_drive(g2, csr2, pairs256, "rmat-s20-ef16", ["auto"], k_check=16)


FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")


def fields(r) -> tuple:
    return tuple(getattr(r, f) for f in FIELDS)


def engine_clean(eng, wave: str) -> dict:
    """Fail unless the engine never degraded: no fallback, retry, error,
    bisection or injected fault, and a closed breaker."""
    st = eng.stats()
    res = st["resilience"]
    check(not any(res["fallbacks"].values()), f"wave {wave}: fallbacks {res['fallbacks']}")
    check(res["retries"] == 0, f"wave {wave}: {res['retries']} retries")
    check(not any(res["errors"].values()), f"wave {wave}: errors {res['errors']}")
    check(res["bisections"] == 0, f"wave {wave}: host batch bisected")
    check(res["faults"] is None, f"wave {wave}: a fault plan is set")
    check(res["breaker"]["state"] == "closed", f"wave {wave}: breaker {res['breaker']}")
    for name, route in st["routes"].items():  # the blocked rung's own breaker
        if "breaker" in route:
            check(route["breaker"]["state"] == "closed",
                  f"wave {wave}: {name} breaker {route['breaker']}")
    return st


def against_oracle(n, csr, pairs, results, wave: str) -> None:
    for (s, d), r, w in zip(pairs, results, oracle(n, csr, pairs)):
        check(r.found == w.found and r.hops == w.hops,
              f"engine wave {wave} {s}->{d}: hops {r.hops} != oracle {w.hops}")
        if r.found:
            check(validate_path(csr, r.path, s, d, hops=r.hops),
                  f"engine wave {wave} {s}->{d}: invalid path")


def engine_wave(eng, pairs, wave: str, **extra) -> tuple[list, dict]:
    """Serve ``pairs`` through ``eng`` with every kernel count set to 0
    just before; returns the results and the line it prints."""
    before = dict(eng.counters)
    tracer = Tracer()
    prev = set_tracer(tracer)
    reset_counts()
    t0 = time.perf_counter()
    try:
        res = eng.query_many(pairs)
    finally:
        wall = time.perf_counter() - t0
        set_tracer(prev)
    launches = counts()
    spans: dict = {}
    for ev in tracer.events():
        if ev.get("ph") == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    st = engine_clean(eng, wave)
    routed = {k: st[k] - before[k] for k in (
        "trivial", "cache_served", "device_queries", "host_queries",
        "device_batches", "blocked_queries")}
    ran = sorted({r.mode for r in res if r.mode is not None})
    line = {"phase": "engine", "wave": wave, "queries": len(pairs), **routed,
            "modes": ran,
            # the batch's own clock (device or native batch); 0 from the cache
            "flush_ms": max(r.time_s for r in res) * 1e3,
            "wall_ms": wall * 1e3, "queries_per_s": len(pairs) / wall,
            "launches": {k: v for k, v in launches.items() if v},
            "spans_ms": spans,
            "host_backend": st["host_backend"], "bucket": st["bucket"], **extra}
    print(json.dumps(line), flush=True)
    return res, line


def engine_phase(g, n, edges, pairs_all, csr) -> None:
    """Phase 7: the serving engine on the main-path graph (module
    docstring). ``g`` is the phase 3 graph the waves are held against."""
    from bibfs_tpu_torch.native.build import ensure_built

    t0 = time.perf_counter()
    eng = QueryEngine(n, edges, max_batch=BATCH, cache_entries=512)
    snapshot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.graph  # the bucketed table, built and uploaded
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ensure_built()
    native_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng._current_rt().get_host_solver()  # the native CSR and scratch
    native_graph_s = time.perf_counter() - t0
    builds = dict(snapshot_s=snapshot_s, table_s=table_s,
                  native_build_s=native_build_s, native_graph_s=native_graph_s)

    # wave A: one minor8 flush of 255 queries, equal to solve_batch_graph.
    # Every endpoint is distinct, so each banked forest is its root's
    # only one and wave B's meet vertices are in it
    rng = np.random.default_rng(29)
    isolated = np.flatnonzero(np.diff(csr[0]) == 0)
    check(isolated.size > 0, "the main-path graph has no isolated vertex")
    ends = rng.choice(np.setdiff1d(np.arange(n), isolated[:1]), 2 * BATCH,
                      replace=False).reshape(BATCH, 2)
    ends[0, 1] = ends[0, 0]  # src == dst: resolved at submit
    ends[1, 1] = isolated[0]
    pairs_a = [(int(s), int(d)) for s, d in ends]
    res_a, line = engine_wave(eng, pairs_a, "A", **builds)
    check(line["device_batches"] == 1 and line["device_queries"] == BATCH - 1
          and line["trivial"] == 1 and line["host_queries"] == 0,
          f"wave A routes: {line}")
    check(line["modes"] == ["minor8"], f"wave A ran {line['modes']}")
    check(line["launches"].get("minor_level[minor8]", 0) > 0,
          "wave A did not launch minor_level_kernel<int8_t>")
    want = dense.solve_batch_graph(g, pairs_a, mode="minor8")
    for (s, d), r, w in zip(pairs_a, res_a, want):
        if s == d:
            check((r.found, r.hops, r.path) == (w.found, w.hops, w.path),
                  f"wave A trivial {s}: {r}")
        else:
            check(fields(r) == fields(w),
                  f"wave A {s}->{d}: engine {fields(r)} != batch {fields(w)}")
    against_oracle(n, csr, pairs_a, res_a, "A")

    # wave B: sources of wave A, all answered from the distance cache
    pairs_b = []
    for k, ((s, d), r) in enumerate(zip(pairs_a[1:], res_a[1:])):
        if len(pairs_b) == BATCH:
            break
        if k % 3 == 0 or not r.found:
            pairs_b.append((s, d))
        elif k % 3 == 1:
            pairs_b.append((d, s))
        else:
            j = r.path.index(r.meet)
            pairs_b.append((s, r.path[j]) if j else (d, s))
    pairs_b += pairs_a[1: 1 + BATCH - len(pairs_b)]
    res_b, line = engine_wave(eng, pairs_b, "B")
    check(line["cache_served"] == BATCH and line["device_batches"] == 0
          and line["host_queries"] == 0 and not line["launches"],
          f"wave B was not served from the cache: {line}")
    against_oracle(n, csr, pairs_b, res_b, "B")

    # wave C: 16 fresh pairs below the crossover, on the native host route
    used = {v for p in pairs_a for v in p}
    fresh = np.setdiff1d(np.random.default_rng(31).choice(n, 64, replace=False),
                         np.array(sorted(used)))
    pairs_c = [(int(s), int(d)) for s, d in fresh[:32].reshape(16, 2)]
    res_c, line = engine_wave(eng, pairs_c, "C")
    check(line["host_queries"] == 16 and line["device_batches"] == 0,
          f"wave C routes: {line}")
    check(eng.host_backend_resolved == "native",
          f"wave C host backend {eng.host_backend_resolved}")
    against_oracle(n, csr, pairs_c, res_c, "C")
    del eng, res_a, res_b, want
    torch.cuda.empty_cache()

    # wave C[device]: the same 16 pairs as one device flush, the reading
    # the host route is held against below the crossover
    t0 = time.perf_counter()
    eng_c = QueryEngine(n, edges, pairs=pairs_all, flush_threshold=1,
                        max_batch=BATCH, cache_entries=512)
    eng_c.graph
    res_cd, line = engine_wave(eng_c, pairs_c, "C[device]",
                               setup_s=time.perf_counter() - t0)
    check(line["device_batches"] == 1 and line["device_queries"] == 16
          and line["host_queries"] == 0, f"wave C[device] routes: {line}")
    for (s, d), r, w in zip(pairs_c, res_cd, res_c):
        check((r.found, r.hops) == (w.found, w.hops),
              f"wave C[device] {s}->{d}: hops {r.hops} != host {w.hops}")
    against_oracle(n, csr, pairs_c, res_cd, "C[device]")
    del eng_c
    torch.cuda.empty_cache()

    # wave D: the pull kernels through the engine (kernel 3 under pallas,
    # kernel 4 under pallas_alt), each engine over the same graph
    pairs_d = [(int(s), int(d)) for s, d in np.random.default_rng(37).choice(
        n, 128, replace=False).reshape(64, 2)]
    for mode, kernel in (("pallas", "pull_dual_batch"),
                         ("pallas_alt", "pull_single_batch")):
        t0 = time.perf_counter()
        eng_d = QueryEngine(n, edges, pairs=pairs_all, mode=mode,
                            max_batch=BATCH, cache_entries=512)
        eng_d.graph
        res_d, line = engine_wave(eng_d, pairs_d, f"D[{mode}]",
                                  setup_s=time.perf_counter() - t0)
        check(line["device_batches"] == 1
              and line["device_queries"] == len(pairs_d)
              and line["modes"] == [mode], f"wave D[{mode}] routes: {line}")
        check(line["launches"].get(kernel, 0) > 0,
              f"wave D[{mode}] did not launch {kernel}")
        want = dense.solve_batch_graph(g, pairs_d, mode=mode)
        for (s, d), r, w in zip(pairs_d, res_d, want):
            check(fields(r) == fields(w),
                  f"wave D[{mode}] {s}->{d}: engine {fields(r)} != batch {fields(w)}")
        against_oracle(n, csr, pairs_d, res_d, f"D[{mode}]")
        del eng_d
        torch.cuda.empty_cache()


def span_ms(tracer) -> dict:
    """The summed ms of each span name a tracer recorded."""
    spans: dict = {}
    for ev in tracer.events():
        if ev.get("ph") == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    return spans


def pipe_close(eng, tickets, wave: str) -> dict:
    """Check the engine never degraded and its pipeline holds no error,
    then close it: no ticket may stay pending and no engine thread
    alive. Returns the stats read before the close."""
    st = engine_clean(eng, wave)
    pipe = st["pipeline"]
    check(not pipe["errors"], f"wave {wave}: pipeline errors {pipe['errors']}")
    check(pipe["outstanding"] == 0, f"wave {wave}: {pipe['outstanding']} outstanding")
    eng.close()
    check(all(t.done() for t in tickets), f"wave {wave}: a ticket pending after close()")
    live = [th.name for th in threading.enumerate() if th.name.startswith("bibfs-")]
    check(not live, f"wave {wave}: engine threads alive after close(): {live}")
    return st


def submit_from_threads(eng, pairs, k: int) -> tuple[list, list, float]:
    """Submit ``pairs`` from ``k`` threads (striped), then wait for every
    ticket; returns the tickets and results in pair order and the wall
    from the threads' common start to the last result."""
    tickets: list = [None] * len(pairs)
    errors: list = []
    start = threading.Barrier(k + 1)

    def worker(j):
        try:
            start.wait(timeout=60)
            for i in range(j, len(pairs), k):
                tickets[i] = eng.submit(*pairs[i])
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(j,)) for j in range(k)]
    for th in threads:
        th.start()
    start.wait(timeout=60)
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout=300)
    check(not errors and not any(th.is_alive() for th in threads),
          f"submitter threads failed: {errors}")
    results = [t.wait(timeout=300) for t in tickets]
    return tickets, results, time.perf_counter() - t0


def pipelined_wave(eng, pairs, threads: int):
    """Serve ``pairs`` through a pipelined engine with every kernel count
    set to 0 just before; returns the tickets, the results and a dict of
    the wave's readings."""
    tracer = Tracer()
    prev = set_tracer(tracer)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        tickets, res, wall = submit_from_threads(eng, pairs, threads)
    finally:
        set_tracer(prev)
    launches = counts()
    st = eng.stats()
    pipe = st["pipeline"]
    return tickets, res, dict(
        wall_ms=wall * 1e3, queries_per_s=len(pairs) / wall,
        device_batches=st["device_batches"], device_queries=st["device_queries"],
        host_queries=st["host_queries"], cache_served=st["cache_served"],
        flushes={k: pipe[k] for k in ("flushes", "depth_flushes",
                                      "deadline_flushes", "drain_flushes")},
        submit_blocked=pipe["submit_blocked"],
        queue_wait_max_ms=pipe["queue_wait_max_ms"],
        batch_service_max_ms=pipe["batch_service_max_ms"],
        overlap=st["overlap"], stages=st["stages"], latency_ms=st["latency_ms"],
        spans_ms=span_ms(tracer),
        launches={k: v for k, v in launches.items() if v},
        base_mem_gb=base_mem / 2**30,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)


def sync_wave(n, edges, pairs_all, pairs, **kw) -> tuple[list, float]:
    """The same pairs through a synchronous engine: results and wall."""
    eng = QueryEngine(n, edges, pairs=pairs_all, max_batch=BATCH,
                      cache_entries=512, **kw)
    eng.graph
    t0 = time.perf_counter()
    res = eng.query_many(pairs)
    wall = time.perf_counter() - t0
    engine_clean(eng, "sync")
    eng.close()
    return res, wall


def cli_phase(n, edges, csr, pairs) -> dict:
    """``bibfs-torch-serve`` as subprocesses over a ``.bin`` of the graph:
    ``--pipeline --pairs`` (hops held against the oracle), then a stdin
    stream answering ``health`` and ``stats`` and drained by SIGTERM, then
    the ``--port`` child (started first: its start-up overlaps the other
    two)."""
    import contextlib

    from bibfs_tpu_torch.graph.io import write_graph_bin

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    cmd = [sys.executable, "-m", "bibfs_tpu_torch.serve.cli"]
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        gpath = os.path.join(tmp, "g.bin")
        write_graph_bin(gpath, n, edges)
        net_child = cli_net_start(cmd, env, root, gpath, tmp)
        stack.callback(stop_child, net_child["proc"])
        ppath = os.path.join(tmp, "pairs.txt")
        np.savetxt(ppath, np.asarray(pairs), fmt="%d")
        spath = os.path.join(tmp, "stats.json")
        t0 = time.perf_counter()
        run = subprocess.run(
            cmd + [gpath, "--pipeline", "--pairs", ppath, "--no-path",
                   "--max-batch", str(BATCH), "--stats-json", spath],
            capture_output=True, text=True, env=env, cwd=root, timeout=600)
        out["pairs_wall_s"] = time.perf_counter() - t0
        check(run.returncode == 0, f"CLI --pipeline --pairs exited {run.returncode}: {run.stderr[-2000:]}")
        lines = run.stdout.splitlines()
        check(len(lines) == len(pairs), f"CLI printed {len(lines)} lines for {len(pairs)} pairs")
        wants = oracle(n, csr, pairs)
        for (s, d), line, w in zip(pairs, lines, wants):
            want = (f"{s} -> {d}: length = {w.hops}" if w.found
                    else f"{s} -> {d}: no path")
            check(line == want, f"CLI line {line!r} != oracle {want!r}")
        with open(spath) as f:
            st = json.load(f)
        res = st["resilience"]
        check(not any(res["fallbacks"].values()) and res["retries"] == 0
              and not any(res["errors"].values()), f"CLI --pairs degraded: {res}")
        out.update(pairs_routes={k: st[k] for k in (
            "device_batches", "device_queries", "host_queries", "cache_served")},
            pairs_flushes=st["pipeline"]["flushes"])

        # the stdin stream: queued (no flush below max_batch until EOF or
        # SIGTERM), two control replies, then SIGTERM drains
        stream = pairs[:8]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd + [gpath, "--no-path"], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, env=env, cwd=root)
        lines_q: queue.Queue = queue.Queue()

        def reader():
            for ln in proc.stdout:
                lines_q.put(ln.rstrip("\n"))
            lines_q.put(None)

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        try:
            for s, d in stream:
                proc.stdin.write(f"{s} {d}\n")
            proc.stdin.write("health\nstats\n")
            proc.stdin.flush()
            replies = [lines_q.get(timeout=300) for _ in range(2)]
            check(replies[0] is not None and replies[0].startswith("health ")
                  and replies[1] is not None and replies[1].startswith("stats "),
                  f"CLI stdin control replies: {[r and r[:80] for r in replies]}")
            health = json.loads(replies[0].split(" ", 1)[1])
            stats = json.loads(replies[1].split(" ", 1)[1])
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
            err = proc.stderr.read()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        th.join(timeout=60)
        got = []
        while True:
            ln = lines_q.get(timeout=60)
            if ln is None:
                break
            got.append(ln)
        out["stdin_wall_s"] = time.perf_counter() - t0
        check(rc == 0, f"CLI stdin run exited {rc} on SIGTERM: {err[-2000:]}")
        check("SIGTERM: draining" in err, "CLI stdin run did not drain on SIGTERM")
        want = [f"{s} -> {d}: length = {w.hops}" if w.found else f"{s} -> {d}: no path"
                for (s, d), w in zip(stream, oracle(n, csr, stream))]
        check(got == want, f"CLI stdin results {got} != oracle {want}")
        check(health["state"] == "ready", f"CLI health {health['state']}")
        check(stats["device"].startswith("cuda"), f"CLI engine device {stats['device']}")
        out.update(stdin_queries=len(stream), health=health["state"],
                   stats_device=stats["device"])

        # the network door as a user serves it, traced across processes
        net = cli_net_child(net_child, pairs[:NET_SUB], wants[:NET_SUB])
        print(json.dumps({"phase": "net", "wave": "N[CLI]", **net}), flush=True)
        out["net_s"] = net["s"]
    return out


def stop_child(proc) -> None:
    """Kill a child still running (a failed phase leaves none behind)."""
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=60)


def cli_net_start(cmd, env, root, gpath, tmp, dev_name: str = "cuda") -> dict:
    """Start ``bibfs-torch-serve --pipeline --port 0 --port-file F
    --metrics-port 0 --trace-spool DIR`` over ``gpath``; returns its
    handle for :func:`cli_net_child` (the process, a queue of its stderr
    lines, the spool and port file paths, its start time)."""
    spool = os.path.join(tmp, "spool")
    port_file = os.path.join(tmp, "net.port")
    proc = subprocess.Popen(
        cmd + [gpath, "--pipeline", "--no-path", "--device", dev_name,
               "--port", "0", "--port-file", port_file, "--metrics-port", "0",
               "--trace-spool", spool],
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, env=env, cwd=root)
    err_q: queue.Queue = queue.Queue()

    def reader():
        for ln in proc.stderr:
            err_q.put(ln.rstrip("\n"))
        err_q.put(None)

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    return {"proc": proc, "err_q": err_q, "reader": th, "spool": spool,
            "port_file": port_file, "t0": time.perf_counter(),
            "dev_name": dev_name}


def cli_net_child(child: dict, pairs, wants) -> dict:
    """The ``--port`` child :func:`cli_net_start` started: ``pairs``
    sampled at a NetClient of this process (its spans spooled beside the
    child's) equal the oracle's ``wants``; ``/metrics`` lists the net
    families, ``/healthz`` answers 200; SIGTERM drains it to exit 0; every
    sampled query's trace spans both processes with no orphan. ``s`` is
    the time from this call; ``ready_s`` the child's start-up from its
    start, overlapped with the other CLI runs."""
    import urllib.request

    from bibfs_tpu_torch.obs import dtrace
    from bibfs_tpu_torch.obs.names import NET_METRIC_FAMILIES
    from bibfs_tpu_torch.serve.net import NetClient, read_port_file

    t0 = time.perf_counter()
    proc, err_q, th = child["proc"], child["err_q"], child["reader"]
    spool, port_file, dev_name = (child["spool"], child["port_file"],
                                  child["dev_name"])
    err: list = []
    client = None
    tracer = dtrace.DTracer(spool, "smoke", sample=1.0)
    prev = dtrace.set_dtracer(tracer)
    try:
        metrics_url = None
        while metrics_url is None:
            ln = err_q.get(timeout=300)
            check(ln is not None, f"CLI --port child ended: {err[-20:]}")
            err.append(ln)
            if ln.startswith("[Obs] serving /metrics on "):
                metrics_url = ln.split(" on ", 1)[1].strip()
        deadline = time.monotonic() + 300
        addr = None
        while addr is None:
            check(proc.poll() is None, f"CLI --port child died: {err[-20:]}")
            check(time.monotonic() < deadline, "CLI --port: no port file")
            addr = read_port_file(port_file)
            if addr is None:
                time.sleep(0.05)
        ready_s = time.perf_counter() - child["t0"]
        client = NetClient(*addr)
        t1 = time.perf_counter()
        tickets = [client.submit(s, d) for s, d in pairs]
        outs = [net_outcome(t) for t in tickets]
        wall = time.perf_counter() - t1
        for (s, d), o, w in zip(pairs, outs, wants):
            check(o == ("ok", w.found, w.hops), f"CLI --port {s}->{d}: {o}, oracle {w.hops}")
        stats = client.request("stats")
        check(stats["device"].startswith(dev_name),
              f"CLI --port device {stats['device']}")
        with urllib.request.urlopen(metrics_url, timeout=30) as r:
            body = r.read().decode()
        for fam in NET_METRIC_FAMILIES:
            check(fam in body, f"CLI --port /metrics lacks {fam}")
        with urllib.request.urlopen(metrics_url.replace("/metrics", "/healthz"),
                                    timeout=30) as r:
            health_status = r.status
        check(health_status == 200, f"CLI --port /healthz {health_status}")
        client.close()
        client = None
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
    finally:
        dtrace.set_dtracer(prev)
        tracer.close()
        if client is not None:
            client.close()
        stop_child(proc)
    th.join(timeout=60)
    while True:
        ln = err_q.get(timeout=60)
        if ln is None:
            break
        err.append(ln)
    check(rc == 0, f"CLI --port exited {rc} on SIGTERM: {err[-20:]}")
    check(any("SIGTERM: draining" in ln for ln in err), "CLI --port did not drain")
    rep = dtrace.merge_spools(spool)
    crossed = dtrace.cross_process_traces(rep, min_procs=2)
    sampled = {t.span.ctx.trace_id for t in tickets}
    check(sampled <= {t["trace"] for t in crossed},
          f"CLI --port: {len(sampled - {t['trace'] for t in crossed})} sampled "
          "queries not traced across both processes")
    return {"queries": len(pairs), "ready_s": ready_s, "wall_ms": wall * 1e3,
            "cross_process_traces": len(crossed), "spans": rep["spans"],
            "orphans": rep["orphan_parents"], "healthz": health_status,
            "device": stats["device"], "device_queries": stats["device_queries"],
            "host_queries": stats["host_queries"],
            "s": time.perf_counter() - t0}


# ---- phase 8's network door --------------------------------------------
NET_CLIENTS = 4  # NetClient threads of the main wave, one connection each
NET_SUB = 64  # queries of each sub-wave


def series_value(text: str, series: str) -> float:
    """The value of one exposition series (``name`` or ``name{labels}``)
    in a Prometheus render."""
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    fail(f"series {series} is not in the render")


def net_outcome(ticket, timeout: float = 300.0) -> tuple:
    """``("ok", found, hops)`` or ``("error", kind, message)`` of a
    NetTicket; a reply that never comes raises."""
    try:
        r = ticket.wait(timeout=timeout)
    except TimeoutError:
        raise
    except Exception as e:  # a structured refusal: returned, checked after
        return ("error", getattr(e, "kind", type(e).__name__), str(e))
    return ("ok", r.found, r.hops)


def net_drive(host: str, port: int, pairs, k: int, window: int | None = None,
              **kw) -> tuple:
    """``k`` NetClient threads, each on its own connection, submit their
    stripe of ``pairs``, each keeping at most ``window`` queries in flight
    (None: every submit before the first wait). Returns the outcomes in
    pair order, the client-side latencies (submit to the reader's resolve
    stamp, s), the tickets and the wall from the threads' common start to
    the last reply."""
    from collections import deque

    from bibfs_tpu_torch.serve.net import NetClient

    outs: list = [None] * len(pairs)
    lats: list = [None] * len(pairs)
    tickets: list = [None] * len(pairs)
    errors: list = []
    start = threading.Barrier(k + 1)

    def worker(j):
        client = NetClient(host, port)
        try:
            start.wait(timeout=60)
            sent: deque = deque()

            def reap():
                i, t0 = sent.popleft()
                outs[i] = net_outcome(tickets[i])
                lats[i] = tickets[i].t_done - t0

            for i in range(j, len(pairs), k):
                if window is not None and len(sent) >= window:
                    reap()
                t0 = time.perf_counter()
                tickets[i] = client.submit(*pairs[i], **kw)
                sent.append((i, t0))
            while sent:
                reap()
        except Exception as e:  # reported below
            errors.append(f"{type(e).__name__}: {e}")
        finally:
            client.close()

    threads = [threading.Thread(target=worker, args=(j,)) for j in range(k)]
    for th in threads:
        th.start()
    start.wait(timeout=60)
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not errors and not any(th.is_alive() for th in threads),
          f"net clients failed: {errors}")
    return outs, lats, tickets, wall


def net_threads_gone(wave: str) -> None:
    """Wait for every front-door thread (server IO and completer, client
    readers) to end after its close."""
    deadline = time.monotonic() + 10.0
    while True:
        live = [th.name for th in threading.enumerate()
                if th.name.startswith("bibfs-net")]
        if not live:
            return
        check(time.monotonic() < deadline,
              f"net {wave}: threads alive after close: {live}")
        time.sleep(0.05)


def net_percentiles(lats) -> dict:
    ms = np.asarray(lats, dtype=np.float64) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms.max())}


def net_phase(n, edges, pairs_all, pairs, truth, dev_name: str = "cuda"
              ) -> None:
    """Phase 8's network door (module docstring): a ``NetServer`` over a
    pipelined engine like wave P's, ``pairs`` (with ``truth``, their
    ``(found, hops)``) through ``NET_CLIENTS`` clients, then the traced,
    deadline, admission and control sub-waves. ``dev_name="cpu"``
    rehearses it on the host (the engine's device route forced, the
    launch check skipped)."""
    from bibfs_tpu_torch.obs import dtrace
    from bibfs_tpu_torch.obs.metrics import REGISTRY
    from bibfs_tpu_torch.obs.names import NET_METRIC_FAMILIES
    from bibfs_tpu_torch.serve.net import NetClient, NetServer

    on_card = dev_name == "cuda"
    t_phase = time.perf_counter()
    opts = {} if on_card else {"device": "cpu", "device_batches": True}
    # max_queue above the door's in-flight bound (512): the IO thread
    # must never park in the engine's admission gate
    eng = PipelinedQueryEngine(n, edges, pairs=pairs_all, max_batch=BATCH,
                               cache_entries=512, max_wait_ms=5.0,
                               flush_threshold=1, max_queue=4 * BATCH, **opts)
    eng.graph
    srv = NetServer(eng)
    check(srv._max_inflight < eng.max_queue,
          f"net: in-flight bound {srv._max_inflight} >= max_queue {eng.max_queue}")
    setup_s = time.perf_counter() - t_phase
    laps = {"setup": setup_s}

    def wrong(outs, subset, wave):
        for p, o in zip(subset, outs):
            if o[0] == "ok":
                check(o[1:] == truth[p], f"net {wave} {p}: {o} != {truth[p]}")

    # wave N: the pairs through 4 clients, every answer the truth's
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.synchronize()
    reset_counts()
    # each client keeps 128 in flight: 4 x 128 = the door's bound of 512
    outs, lats, _t, wall = net_drive(srv.host, srv.port, pairs, NET_CLIENTS,
                                     window=srv._max_inflight // NET_CLIENTS)
    launches = counts()
    check(all(o[0] == "ok" for o in outs),
          f"net N: refusals {[o for o in outs if o[0] != 'ok'][:4]}")
    wrong(outs, pairs, "N")
    st = engine_clean(eng, "N")
    if on_card:
        check(launches.get("minor_level[minor8]", 0) > 0,
              "net N did not launch minor_level_kernel<int8_t>")
    pipe = st["pipeline"]
    laps["N"] = time.perf_counter() - t0
    print(json.dumps({
        "phase": "net", "wave": "N", "queries": len(pairs),
        "clients": NET_CLIENTS, "wall_ms": wall * 1e3,
        "queries_per_s": len(pairs) / wall, **net_percentiles(lats),
        "minor_level_launches": launches.get("minor_level[minor8]", 0),
        "launches": {k: v for k, v in launches.items() if v},
        "device_batches": st["device_batches"],
        "device_queries": st["device_queries"],
        "host_queries": st["host_queries"], "cache_served": st["cache_served"],
        "flushes": pipe["flushes"], "queue_wait_max_ms": pipe["queue_wait_max_ms"],
        "engine_latency_ms": st["latency_ms"], "stages": st["stages"],
        "overlap": st["overlap"], "setup_s": setup_s,
        "s": laps["N"]}), flush=True)

    # N[traced]: sampled at the client, spooled, merged: each query a trace
    # of net_client -> net_ingress -> (queue, resolve), no orphan
    t0 = time.perf_counter()
    eng.dist_cache.invalidate(eng.graph_id)
    sub = pairs[:NET_SUB]
    spool = tempfile.TemporaryDirectory(prefix="chip-spool-")
    tracer = dtrace.DTracer(spool.name, "smoke", sample=1.0)
    prev = dtrace.set_dtracer(tracer)
    try:
        outs, lats, tickets, wall = net_drive(srv.host, srv.port, sub, 1)
    finally:
        dtrace.set_dtracer(prev)
        tracer.close()
    check(all(o[0] == "ok" for o in outs), "net N[traced]: a refusal")
    wrong(outs, sub, "N[traced]")
    rep = dtrace.merge_spools(spool.name)
    spool.cleanup()
    check(rep["truncated_lines"] == 0 and rep["orphan_parents"] == 0,
          f"net N[traced]: {rep['truncated_lines']} torn lines, "
          f"{rep['orphan_parents']} orphans")
    spans: dict = {}
    for ev in rep["events"]:
        if ev["ph"] == "X":
            a = ev["args"]
            spans.setdefault(a["trace"], {})[ev["name"]] = (a["span"], a.get("parent"))
    for t in tickets:
        tr = spans.get(t.span.ctx.trace_id, {})
        check({"net_client", "net_ingress", "queue", "resolve"} <= tr.keys(),
              f"net N[traced]: trace spans {sorted(tr)}")
        client, ingress = tr["net_client"], tr["net_ingress"]
        check(client[1] is None and ingress[1] == client[0]
              and tr["queue"][1] == ingress[0] and tr["resolve"][1] == ingress[0],
              f"net N[traced]: parentage {tr}")
    laps["N[traced]"] = time.perf_counter() - t0
    print(json.dumps({"phase": "net", "wave": "N[traced]", "queries": len(sub),
                      "traces": len(spans), "spans": rep["spans"],
                      "orphans": rep["orphan_parents"], "wall_ms": wall * 1e3,
                      **net_percentiles(lats), "s": laps["N[traced]"]}), flush=True)

    # N[deadline]: 1 ms deadlines; each gets its result or one timeout, and
    # the timeouts equal the counter's delta (late results answer nothing)
    t0 = time.perf_counter()
    eng.dist_cache.invalidate(eng.graph_id)
    sub = pairs[NET_SUB: 2 * NET_SUB]
    misses = "bibfs_net_deadline_misses_total"
    before = series_value(REGISTRY.render(), misses)
    outs, lats, _t, wall = net_drive(srv.host, srv.port, sub, 1, deadline_ms=1.0)
    eng.flush(timeout=300)
    time.sleep(0.2)  # past a late result's landing
    delta = series_value(REGISTRY.render(), misses) - before
    timeouts = sum(o[:2] == ("error", "timeout") for o in outs)
    check(all(o[0] == "ok" or o[1] == "timeout" for o in outs),
          f"net N[deadline]: {[o for o in outs if o[0] != 'ok' and o[1] != 'timeout'][:4]}")
    wrong(outs, sub, "N[deadline]")
    check(timeouts == delta, f"net N[deadline]: {timeouts} timeouts, counter +{delta}")
    st = eng.stats()
    res = st["resilience"]
    check(not any(res["fallbacks"].values()) and res["retries"] == 0
          and set(k for k, v in res["errors"].items() if v) <= {"timeout"},
          f"net N[deadline]: resilience {res}")
    laps["N[deadline]"] = time.perf_counter() - t0
    print(json.dumps({"phase": "net", "wave": "N[deadline]", "queries": len(sub),
                      "deadline_ms": 1.0, "timeouts": timeouts,
                      "results": len(sub) - timeouts, "counter_delta": delta,
                      "engine_errors": res["errors"], "wall_ms": wall * 1e3,
                      "s": laps["N[deadline]"]}), flush=True)

    # N[capacity]: a second door with an in-flight bound of 8 takes a burst;
    # its refusals equal the counter's delta, every admitted answer right
    t0 = time.perf_counter()
    eng.dist_cache.invalidate(eng.graph_id)
    sub = pairs[2 * NET_SUB: 3 * NET_SUB]
    small = NetServer(eng, max_inflight=8)
    series = 'bibfs_net_rejections_total{reason="capacity"}'
    before = series_value(REGISTRY.render(), series)
    outs, lats, _t, wall = net_drive(small.host, small.port, sub, 1)
    delta = series_value(REGISTRY.render(), series) - before
    small.close()
    refused = sum(o[:2] == ("error", "capacity") for o in outs)
    check(all(o[0] == "ok" or (o[1] == "capacity" and "(capacity)" in o[2])
              for o in outs), f"net N[capacity]: {[o for o in outs if o[0] != 'ok'][:4]}")
    wrong(outs, sub, "N[capacity]")
    check(refused == delta, f"net N[capacity]: {refused} refused, counter +{delta}")
    laps["N[capacity]"] = time.perf_counter() - t0
    print(json.dumps({"phase": "net", "wave": "N[capacity]", "queries": len(sub),
                      "max_inflight": 8, "refused": refused,
                      "admitted": len(sub) - refused, "counter_delta": delta,
                      "wall_ms": wall * 1e3, "s": laps["N[capacity]"]}), flush=True)

    # N[control]: the control ops over the wire
    t0 = time.perf_counter()
    client = NetClient(srv.host, srv.port)
    try:
        check(client.request("ping") == {"pong": True}, "net: ping")
        health = client.request("health")
        check(health["state"] in ("ready", "degraded"), f"net: health {health}")
        stats = client.request("stats")
        check(stats["graph"]["n"] == n and stats["device"].startswith(dev_name),
              f"net: stats {stats['graph']} on {stats['device']}")
        render = client.request("metrics")["render"]
        for fam in NET_METRIC_FAMILIES:
            check(fam in render, f"net: metrics render lacks {fam}")
        fr = client.request("flightrec")
        check(fr["pid"] == os.getpid() and fr["capacity"] > 0
              and any(e["kind"] == "batch" for e in fr["entries"]),
              f"net: flightrec {sorted(fr)}")
    finally:
        client.close()
    srv.close()
    net_threads_gone("N[control]")
    # the deadline wave's cancellations are the engine's only errors
    # (checked above); nothing else may be left in its pipeline
    pipe = eng.stats()["pipeline"]
    check(not pipe["errors"] and pipe["outstanding"] == 0,
          f"net: pipeline {pipe['errors']}, {pipe['outstanding']} outstanding")
    eng.close()
    live = [th.name for th in threading.enumerate() if th.name.startswith("bibfs-")]
    check(not live, f"net: threads alive after close: {live}")
    laps["N[control]"] = time.perf_counter() - t0
    print(json.dumps({"phase": "net", "wave": "N[control]",
                      "ops": ["ping", "health", "stats", "metrics", "flightrec"],
                      "health": health["state"], "flight_entries": len(fr["entries"]),
                      "s": laps["N[control]"],
                      "phase_s": time.perf_counter() - t_phase}), flush=True)
    del eng
    if on_card:
        torch.cuda.empty_cache()


def net_analytics(eng, res, queries, wave: str) -> None:
    """One ``analytics`` op over the wire on ``eng`` (a wave just served
    ``queries`` with answers ``res`` on it): each kind's summary equals
    the engine's own answer's (its time aside)."""
    from bibfs_tpu_torch.analytics.queries import analytics_summary
    from bibfs_tpu_torch.serve.net import NetClient, NetServer

    t0 = time.perf_counter()
    srv = NetServer(eng)
    client = NetClient(srv.host, srv.port)
    try:
        got = client.request("analytics", kind="triangles")
    finally:
        client.close()
        srv.close()
    want = analytics_summary(next(r for q, r in zip(queries, res)
                                  if type(q).__name__ == "Triangles"))
    got.pop("time_s", None)
    want.pop("time_s", None)
    check(got == want, f"net analytics on {wave}: {got} != {want}")
    net_threads_gone("N[analytics]")
    print(json.dumps({"phase": "net", "wave": "N[analytics]", "engine": wave,
                      "kind": "triangles", "answer": got,
                      "s": time.perf_counter() - t0}), flush=True)


def pipelined_run(n, edges, pairs_all, pairs, wave: str, threads: int, **kw):
    """A fresh pipelined engine with ``flush_threshold=1`` (every flush
    rides the card) serving ``pairs`` from ``threads`` threads, closed
    and checked clean; returns the results and the wave's readings."""
    t0 = time.perf_counter()
    eng = PipelinedQueryEngine(n, edges, pairs=pairs_all, max_batch=BATCH,
                               cache_entries=512, max_wait_ms=5.0,
                               flush_threshold=1, **kw)
    eng.graph
    setup_s = time.perf_counter() - t0
    tickets, res, line = pipelined_wave(eng, pairs, threads)
    pipe_close(eng, tickets, wave)
    check(line["host_queries"] == 0 and line["device_queries"] == len(pairs),
          f"wave {wave} routes: {line}")
    del eng
    torch.cuda.empty_cache()
    return res, dict(line, setup_s=setup_s)


def in_turns(n, edges, pairs_all, pairs, wave: str, threads: int, **kw):
    """The pipelined and then the synchronous engine on the same pairs
    (fresh engines): every answer equals the synchronous run's field for
    field. Returns the pipelined run's results and readings, with both
    walls."""
    res_a, line_a = pipelined_run(n, edges, pairs_all, pairs, wave, threads, **kw)
    want, sync_a = sync_wave(n, edges, pairs_all, pairs, flush_threshold=1, **kw)
    for (s, d), r, w in zip(pairs, res_a, want):
        check(fields(r) == fields(w) and r.mode == w.mode,
              f"wave {wave} {s}->{d}: pipelined {fields(r)} != sync {fields(w)}")
    line_a.update(
        sync_wall_ms=sync_a * 1e3, sync_queries_per_s=len(pairs) / sync_a,
        turns_wall_ms={"pipelined": [line_a["wall_ms"]],
                       "sync": [sync_a * 1e3]})
    return res_a, line_a


def pipeline_phase(n, edges, pairs_all, csr) -> None:
    """Phase 8: the pipelined engine on the main-path graph (module
    docstring)."""
    # wave P: 1024 pairs, 2048 distinct endpoints, 4 submitter threads
    rng = np.random.default_rng(41)
    ends = rng.choice(n, 2 * 4 * BATCH, replace=False).reshape(4 * BATCH, 2)
    pairs_p = [(int(s), int(d)) for s, d in ends]
    res_p, line = in_turns(n, edges, pairs_all, pairs_p, "P", threads=4)
    check(line["device_batches"] >= 4, f"wave P ran {line['device_batches']} device flushes")
    check(line["launches"].get("minor_level[minor8]", 0) > 0,
          "wave P did not launch minor_level_kernel<int8_t>")
    sample = [pairs_p[i] for i in np.random.default_rng(43).choice(len(pairs_p), 64, replace=False)]
    by_pair = dict(zip(pairs_p, res_p))
    against_oracle(n, csr, sample, [by_pair[p] for p in sample], "P")
    print(json.dumps({"phase": "engine_pipelined", "wave": "P", "queries": len(pairs_p),
                      "threads": 4, **line,
                      "modes": sorted({r.mode for r in res_p if r.mode})}), flush=True)
    # wave P's answers (equal to the synchronous engine's, a sample to the
    # oracle's) are the network door's truth: no new host search
    truth = {p: (r.found, r.hops) for p, r in zip(pairs_p, res_p)}
    del res_p

    # the network front door over a pipelined engine on the card
    net_phase(n, edges, pairs_all, pairs_p, truth)

    # wave P-pallas: the pull kernels through the pipelined engine
    pairs_k = [(int(s), int(d)) for s, d in np.random.default_rng(47).choice(
        n, 128, replace=False).reshape(64, 2)]
    for mode, kernel in (("pallas", "pull_dual_batch"),
                         ("pallas_alt", "pull_single_batch")):
        res_k, line = in_turns(n, edges, pairs_all, pairs_k, f"P[{mode}]",
                               threads=1, mode=mode)
        check(all(r.mode == mode for r in res_k), f"wave P[{mode}] ran another mode")
        check(line["launches"].get(kernel, 0) > 0, f"wave P[{mode}] did not launch {kernel}")
        against_oracle(n, csr, pairs_k[:16], res_k[:16], f"P[{mode}]")
        print(json.dumps({"phase": "engine_pipelined", "wave": f"P[{mode}]",
                          "queries": len(pairs_k), "threads": 1, **line}), flush=True)

    # wave S: a trickle below the crossover, 20 ms apart: deadline flushes
    # on the host route
    eng = PipelinedQueryEngine(n, edges, pairs=pairs_all, max_batch=BATCH,
                               cache_entries=512, max_wait_ms=5.0)
    eng._current_rt().get_host_solver()
    pairs_s = [(int(s), int(d)) for s, d in np.random.default_rng(53).choice(
        n, 16, replace=False).reshape(8, 2)]
    reset_counts()
    tickets = []
    t0 = time.perf_counter()
    for s, d in pairs_s:
        tickets.append(eng.submit(s, d))
        time.sleep(0.02)
    res_s = [t.wait(timeout=120) for t in tickets]
    wall = time.perf_counter() - t0
    launches = counts()
    st = pipe_close(eng, tickets, "S")
    against_oracle(n, csr, pairs_s, res_s, "S")
    pipe = st["pipeline"]
    check(st["host_queries"] == len(pairs_s) and st["device_batches"] == 0
          and not any(launches.values()), f"wave S routes: {st['host_queries']} host")
    check(pipe["deadline_flushes"] >= 1, f"wave S: no deadline flush ({pipe})")
    print(json.dumps({"phase": "engine_pipelined", "wave": "S", "queries": len(pairs_s),
                      "interval_ms": 20, "wall_ms": wall * 1e3,
                      "flushes": {k: pipe[k] for k in ("flushes", "depth_flushes",
                                                       "deadline_flushes", "drain_flushes")},
                      "queue_wait_max_ms": pipe["queue_wait_max_ms"],
                      "batch_service_max_ms": pipe["batch_service_max_ms"],
                      "latency_ms": st["latency_ms"], "stages": st["stages"],
                      "host_backend": st["host_backend"]}), flush=True)
    del eng

    # the CLI, as a user runs it
    cli = cli_phase(n, edges, csr, pairs_p[:BATCH])
    print(json.dumps({"phase": "engine_pipelined", "wave": "CLI", **cli}), flush=True)


def blocked_mid_state(g, pairs, rounds: int) -> dict:
    """A seeded mid-search state of the blocked search: ``pairs`` after
    ``rounds`` rounds of its body (the two kernels each round). Returns
    the state (the plane ``fr``, ``dist``, the flags ``occ``, the round
    vectors, ``rnd``); the next level is ``rnd + 1``."""
    srcs = torch.as_tensor(pairs[:, 0], dtype=torch.int32, device=g.device)
    dsts = torch.as_tensor(pairs[:, 1], dtype=torch.int32, device=g.device)
    st = dense._blocked_state(srcs, dsts, g.deg, torch.int8)
    body = dense._make_blocked_body(g.tab, g.bcol, g.deg, rc=1)
    for _ in range(rounds):
        if not bool(st["any"]):
            break
        body(st)
    return st


def sparse_adjacency(n_pad: int, csr, dev):
    """The graph's 0/1 adjacency as a float32 CSR tensor on the card (for
    the ``torch.sparse.mm`` yardstick)."""
    row_ptr, col_ind = csr
    crow = np.concatenate([row_ptr, np.full(n_pad + 1 - len(row_ptr),
                                            row_ptr[-1])])
    return torch.sparse_csr_tensor(
        torch.as_tensor(crow, dtype=torch.int64, device=dev),
        torch.as_tensor(col_ind, dtype=torch.int64, device=dev),
        torch.ones(len(col_ind), dtype=torch.float32, device=dev),
        size=(n_pad, n_pad))


def clone_state(st) -> dict:
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in st.items()}


def blocked_bounds(g, st, reach, new) -> dict:
    """The least time the card could take for one round from this state,
    whatever implements it (ms over 3.35 TB/s and the dense int8 rate).
    ``bound_ms`` (PR 11's formula): every live tile, the whole plane read
    and the next plane written, 4 B per dist entry a live row reaches and
    per entry stamped; ``bound_ms_occupied``: only the tiles and
    sub-planes of occupied (group, block column) pairs of groups with a
    live query, each tile once. Both add the epilogue's bytes: ``deg`` of
    the block rows computed and the other side's dist where one side is
    new; the int8 bound counts 2 operations per multiply-add."""
    c, n_pad = st["fr"].shape
    b = c // 2
    nb, bw = g.nblocks, g.bwidth
    bcol = g.bcol.long()
    real = bcol < nb  # [nb, bw]
    nnz = int(real.sum())
    live = st["live"] > 0
    reads = int((reach & live.repeat(2)[:, None]).sum())
    stamped = int(new.sum(dtype=torch.int64))
    other = int((new[:b] ^ new[b:]).sum(dtype=torch.int64))
    gl = torch.zeros(-(-b // be.GROUP) * be.GROUP, dtype=torch.bool,
                     device=live.device)
    gl[:b] = live
    glive = gl.reshape(-1, be.GROUP).any(1)  # [ng]
    occ = (st["occ"] > 0) & glive[:, None]  # [ng, nb]
    # occ[g, bcol[bi, k]] per (group, block row, slot)
    trip = occ[:, bcol.clamp(max=nb - 1)] & real[None]  # [ng, nb, bw]
    n_trip = int(trip.sum())
    tiles = int(trip.any(0).sum())
    rows_on = int(trip.any(2).any(0).sum())
    # an occupied (group, block column) pair's sub-plane: 128 bytes of
    # each of the group's real rows
    rows_g = (b - be.GROUP * torch.arange(glive.numel(), device=live.device)
              ).clamp(max=be.GROUP)
    sub_bytes = int((occ.sum(1) * rows_g).sum()) * 2 * 128
    extra = 4 * (reads + stamped + other)
    whole = nnz * 128 * 128 + 2 * c * n_pad + 4 * n_pad + extra
    part = (tiles * 128 * 128 + sub_bytes + c * n_pad
            + 4 * 128 * rows_on + extra)
    b_ms, by = bound_ms(whole, 0)
    ops_ms = 2 * nnz * 128 * 128 * c / INT8_OPS_PER_S * 1e3
    if ops_ms > b_ms:
        b_ms, by = ops_ms, "operations"
    o_ms, o_by = bound_ms(part, 0)
    o_ops = 2 * n_trip * 128 * 128 * 2 * be.GROUP / INT8_OPS_PER_S * 1e3
    if o_ops > o_ms:
        o_ms, o_by = o_ops, "operations"
    return dict(bound_ms=b_ms, bound_by=by, bound_ms_int8_ops=ops_ms,
                bound_ms_full_dist=bound_ms(whole + 8 * c * n_pad, 0)[0],
                bound_ms_occupied=o_ms, bound_by_occupied=o_by,
                occupied_share=n_trip / max(glive.numel() * nnz, 1),
                occupied_slots=n_trip, occupied_tiles=tiles, live_tiles=nnz,
                dist_reads=reads, stamped=stamped, other_side_reads=other)


def fold_bound_ms(b: int) -> float:
    """The fold's bytes: the [B] vectors read and written once (best, meet,
    levels, edges, live: 4 B; key: 8 B; scan_cur, cnt, scan: 2 x 4 B),
    the any word written."""
    return bound_ms(2 * b * (5 * 4 + 8 + 3 * 8) + 4, 0)[0]


def blocked_kernel_phase(g, csr, geometry: str, rounds: int, seed: int,
                         results: dict | None) -> None:
    """``blocked_level`` and ``blocked_fold`` against their plain twins at
    B = 256, 37 and 1 on a seeded mid-search state
    (:func:`blocked_mid_state`): the next plane, the stamped dist, the
    flags, the counts, degree sums and meet key, and every folded vector
    exactly equal. One ``step`` line each with the kernel's ms (25
    launches, dist and the vectors restored outside the timed interval),
    the fold's, the round's (both), the twins' (5), the bounds of
    :func:`blocked_bounds` and one ``torch.sparse.mm`` of the adjacency
    and the plane (the expansion alone; no single PyTorch call computes
    the round)."""
    adj = sparse_adjacency(g.n_pad, csr, g.device)
    rng = np.random.default_rng(seed)
    for b in (BATCH, 37, 1):
        pairs = rng.integers(0, g.n, size=(b, 2))
        st = blocked_mid_state(g, pairs, rounds)
        lvl = st["rnd"] + 1
        c, n_pad = st["fr"].shape
        sk, sp = clone_state(st), clone_state(st)
        fr_k, occ_k = be.blocked_level(g.tab, g.bcol, g.deg, sk["fr"],
                                       sk["dist"], sk["occ"], sk, lvl)
        fr_p, occ_p = be.blocked_level_plain(g.tab, g.bcol, g.deg, sp["fr"],
                                             sp["dist"], sp["occ"], sp, lvl)
        torch.cuda.synchronize()
        outs = ("plane", "dist", "occ", "cnt", "scan", "key")
        err = max_abs_err([fr_k, sk["dist"], occ_k, sk["cnt"], sk["scan"],
                           sk["key"]],
                          [fr_p, sp["dist"], occ_p, sp["cnt"], sp["scan"],
                           sp["key"]])
        check(err == 0, f"blocked_level differs from its plain twin at "
              f"{geometry} B={b} (outputs {outs})")
        be.blocked_fold(sk, lvl)
        be.blocked_fold_plain(sp, lvl)
        torch.cuda.synchronize()
        ferr = max_abs_err([sk[k] for k in be.ROUND_VECTORS],
                           [sp[k] for k in be.ROUND_VECTORS])
        check(ferr == 0, f"blocked_fold differs from its plain twin at "
              f"{geometry} B={b}")
        reach = be.expand_blocked_plane(
            st["fr"].T, g.tab, g.bcol,
            rc=be.chunk_block_rows(g.bwidth, c, 4)).T
        bounds = blocked_bounds(g, st, reach, fr_p > 0)
        del reach, fr_k, fr_p, sk, sp
        d0 = st["dist"].clone()
        v0 = {k: st[k].clone() for k in be.ROUND_VECTORS}

        def prep():
            st["dist"].copy_(d0)
            for k in be.ROUND_VECTORS:
                st[k].copy_(v0[k])

        def level():
            return be.blocked_level(g.tab, g.bcol, g.deg, st["fr"], st["dist"],
                                    st["occ"], st, lvl, checked=True)

        def both():
            level()
            be.blocked_fold(st, lvl, checked=True)

        def plain():
            be.blocked_level_plain(g.tab, g.bcol, g.deg, st["fr"], st["dist"],
                                   st["occ"], st, lvl)

        ms = time_launch(level, prep=prep)
        fold_ms = time_launch(lambda: be.blocked_fold(st, lvl, checked=True),
                              prep=prep)
        round_ms = time_launch(both, prep=prep)
        plain_ms = time_launch(plain, prep=prep, reps=5)
        fold_plain_ms = time_launch(lambda: be.blocked_fold_plain(st, lvl),
                                    prep=prep, reps=5)
        prep()
        fr32 = st["fr"].T.float().contiguous()
        sparse_ms = time_launch(lambda: torch.sparse.mm(adj, fr32), reps=5)
        step_line("blocked_level", geometry, "round", ms, plain_ms=plain_ms,
                  fold_ms=fold_ms, fold_plain_ms=fold_plain_ms,
                  round_ms=round_ms, fold_bound_ms=fold_bound_ms(b), b=b,
                  level=lvl, live_queries=int(st["live"].sum()),
                  plane_mb=c * n_pad / 1e6, sparse_mm_ms=sparse_ms, **bounds)
        if results is not None and b == BATCH:
            results["blocked_level"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bounds["bound_ms"], bound_by=bounds["bound_by"],
                bound_ms_occupied=bounds["bound_ms_occupied"])
            results["blocked_fold"] = dict(
                max_abs_err=ferr, ms=fold_ms, plain_ms=fold_plain_ms,
                bound_ms=fold_bound_ms(b), bound_by="bytes")
        del st, d0, v0, fr32
        torch.cuda.empty_cache()


def blocked_batch_phase(g, gell, csr, geometry: str, b: int, seed: int):
    """One seeded batch of ``b`` pairs through the blocked search (a
    warm-up, the median of 3): every hop equal to the serial oracle, every
    path valid, and a ``minor8`` batch of the same pairs (the median of 3)
    equal in hops. Returns the pairs and the blocked results."""
    pairs = batch_pairs(np.random.default_rng(seed), g.n, csr, b)
    stats = {"host_syncs": 0}
    _p, thunk = bmin.blocked_batch_dispatch(g, pairs, stats=stats)
    times, out = timed_batch_repeats(thunk, 3, device=g.device)
    res = dense._materialize_blocked_batch(out, pairs, float(np.median(times)),
                                           *csr)
    del out
    pl = [(int(s), int(d)) for s, d in pairs]
    against_oracle(g.n, csr, pl, res, f"blocked {geometry}")
    times8, res8 = dense.time_batch_graph(gell, pairs, repeats=3, mode="minor8")
    for (s, d), r, r8 in zip(pl, res, res8):
        check((r.found, r.hops) == (r8.found, r8.hops),
              f"blocked {geometry} {s}->{d}: hops {r.hops} != minor8 {r8.hops}")
    ms, ms8 = float(np.median(times)) * 1e3, float(np.median(times8)) * 1e3
    reads = stats["host_syncs"] // 4
    print(json.dumps({
        "phase": "blocked_batch", "geometry": geometry, "b": b,
        "batch_ms": ms, "ms_per_query": ms / b, "minor8_ms": ms8,
        "minor8_per_blocked": ms8 / ms,
        "host_reads_per_batch": reads,
        # a round is one read; the last read ends the loop
        "ms_per_round": ms / max(reads - 1, 1),
        "found": sum(r.found for r in res),
        "times_ms": [t * 1e3 for t in times],
        "minor8_times_ms": [t * 1e3 for t in times8]}), flush=True)
    return pl, res


def blocked_engine_phase(n, edges, pairs_all, csr, g, geometry: str) -> int:
    """A sync and a pipelined engine wave of 256 distinct pairs with the
    blocked rung: one blocked flush each, every answer equal to
    ``solve_blocked_batch`` on every field but the time and to the
    oracle's hops, no degrade. Returns the kernels' launches."""
    ends = np.random.default_rng(61).choice(n, 2 * BATCH, replace=False)
    pairs = [(int(s), int(d)) for s, d in ends.reshape(BATCH, 2)]
    want = dense.solve_blocked_batch(g, pairs, csr=csr)
    eng = QueryEngine(n, edges, pairs=pairs_all, blocked=True,
                      max_batch=BATCH, cache_entries=0)
    res, line = engine_wave(eng, pairs, f"E[blocked {geometry}]")
    check(line["blocked_queries"] == BATCH and line["device_batches"] == 0
          and line["host_queries"] == 0 and line["modes"] == ["blocked"],
          f"blocked sync wave routes: {line}")
    launches = {k: line["launches"].get(k, 0) for k in BLOCKED_KERNELS}
    check(all(launches.values()),
          f"the blocked sync wave did not launch every kernel: {launches}")
    for (s, d), r, w in zip(pairs, res, want):
        check(fields(r) == fields(w),
              f"blocked sync wave {s}->{d}: {fields(r)} != {fields(w)}")
    against_oracle(n, csr, pairs, res, "E[blocked]")
    eng.close()
    del eng, res
    pipe = PipelinedQueryEngine(n, edges, pairs=pairs_all, blocked=True,
                                max_batch=BATCH, flush_threshold=BATCH,
                                max_wait_ms=None, cache_entries=0)
    tickets, res_p, info = pipelined_wave(pipe, pairs, threads=4)
    st = pipe_close(pipe, tickets, f"P[blocked {geometry}]")
    check(st["blocked_queries"] == BATCH and st["device_batches"] == 0
          and st["host_queries"] == 0, f"blocked pipelined wave routes: {info}")
    for k in BLOCKED_KERNELS:
        check(info["launches"].get(k, 0) > 0,
              f"the blocked pipelined wave did not launch {k}")
        launches[k] += info["launches"][k]
    for (s, d), r, w in zip(pairs, res_p, want):
        check(fields(r) == fields(w),
              f"blocked pipelined wave {s}->{d}: {fields(r)} != {fields(w)}")
    print(json.dumps({"phase": "engine_pipelined", "wave": f"P[blocked {geometry}]",
                      "queries": BATCH, "blocked_queries": st["blocked_queries"],
                      "flush_ms": max(r.time_s for r in res_p) * 1e3,
                      **info}), flush=True)
    return launches


def blocked_phase(dev, results: dict) -> int:
    """Phase 10 (module docstring). Returns the kernels' launches on the
    route's path (batches and engine waves)."""
    launches = dict.fromkeys(BLOCKED_KERNELS, 0)
    for geometry, make, b, rounds in BLOCKED_GEOMS:
        t0 = time.perf_counter()
        n, edges = make()
        pairs_all = canonical_pairs(n, edges)
        csr = build_csr(n, pairs=pairs_all)
        bg = build_blocked(n, pairs=pairs_all)
        g = dense.BlockedDeviceGraph.from_host(bg, device=dev)
        gell = dense.DeviceGraph.build(n, edges, device=dev, pairs=pairs_all)
        torch.cuda.synchronize()
        print(json.dumps({"phase": "graph", "name": geometry, "n": n,
                          "edges": int(pairs_all.shape[0]) // 2,
                          "nblocks": bg.nblocks, "bwidth": bg.bwidth,
                          "live_tiles": bg.nnz_blocks,
                          "tab_mb": bg.tab_bytes / 1e6,
                          "waste": bg.bwidth * 128 * bg.n_pad
                          / max(len(pairs_all), 1),
                          "build_s": time.perf_counter() - t0}), flush=True)
        blocked_kernel_phase(g, csr, geometry, rounds, 71,
                             results if geometry == BLOCKED_GEOMS[0][0] else None)
        reset_counts()
        blocked_batch_phase(g, gell, csr, geometry, b, 73)
        for name in BLOCKED_KERNELS:
            launches[name] += counts()[name]
            check(counts()[name] > 0,
                  f"the {geometry} batch did not launch {name}")
        if geometry == BLOCKED_GEOMS[0][0]:
            for name, k in blocked_engine_phase(n, edges, pairs_all, csr, g,
                                                geometry).items():
                launches[name] += k
        del g, gell
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "blocked_launches", **launches}), flush=True)
    return launches


def msbfs_bound(n: int, nnz: int, words: int, changed: int,
                stamps: int) -> tuple[float, str]:
    """The least time one level could take if it read every vertex (a
    pull, ``bound_ms``): the CSR (``row_ptr`` int64, ``col_ind`` int32),
    the pending and reach words read once, the next pending words written,
    the changed reach words and one int16 stamp per new (vertex, search)
    bit written, and the flag; against one OR per gathered word over the
    card's integer rate."""
    nbytes = (8 * (n + 1) + 4 * nnz + 3 * 4 * n * words + 4 * changed
              + 2 * stamps + 4)
    return bound_ms(nbytes, nnz * words)


def frontier_ms(nbytes) -> float:
    """Bytes a level's frontier needs (``md.frontier_bytes``) over the
    card's memory rate, in ms."""
    return float(nbytes) / HBM_BYTES_PER_S * 1e3


def msbfs_sources(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).choice(n, max(MSBFS_KS), replace=False)


def host_sweeps(out_dir: str) -> None:
    """Phase 11's host references, in a child process started with the
    run (its minute of NumPy overlaps phases 1-10): the NumPy sweep of
    each graph's widest source set, saved into ``out_dir`` (the sweeps are
    independent per source, so it holds every narrower set's columns),
    and each K's frontier bytes by level (``md.frontier_bytes`` of the
    plane's first K columns)."""
    for geometry, n, make, _level, seed in MSBFS_GEOMS:
        row_ptr, col_ind = build_csr(n, make())
        t0 = time.perf_counter()
        want = multi_source_bfs(n, row_ptr, col_ind, msbfs_sources(n, seed))
        ms = (time.perf_counter() - t0) * 1e3
        np.save(os.path.join(out_dir, f"{geometry}.npy"), want)
        levels = {str(k): md.frontier_bytes(row_ptr, col_ind,
                                            want[:, :k]).tolist()
                  for k in MSBFS_KS}
        with open(os.path.join(out_dir, f"{geometry}.json"), "w") as f:
            json.dump({"host_sweep_ms": ms, "frontier_bytes": levels}, f)


def rmat_prep(out_dir: str) -> None:
    """Phase 4's graph, rmat-s20-ef16, built on the host in a child process
    started with the run (its minute of NumPy overlaps phases 1-8): the
    tiered host graph (``sharded.save_host_graph``), the CSR and the edge
    count, saved into ``out_dir`` for :func:`rmat_load`."""
    from bibfs_tpu_torch.solvers.sharded import save_host_graph

    t0 = time.perf_counter()
    n2, e2 = rmat_graph(20, edge_factor=16, seed=7)
    p2 = canonical_pairs(n2, e2)
    row_ptr, col_ind = build_csr(n2, pairs=p2)
    save_host_graph(build_tiered(n2, pairs=p2), os.path.join(out_dir, "host"))
    np.save(os.path.join(out_dir, "row_ptr.npy"), row_ptr)
    np.save(os.path.join(out_dir, "col_ind.npy"), col_ind)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"n": int(n2), "edges": int(e2.shape[0]),
                   "build_s": time.perf_counter() - t0}, f)


def rmat_load(proc, out_dir: str) -> tuple:
    """Wait for :func:`rmat_prep` and map what it saved: ``(n, edges,
    csr, host graph, its build seconds, the wait)``."""
    from bibfs_tpu_torch.solvers.sharded import load_host_graph

    t0 = time.perf_counter()
    proc.join(timeout=600)
    check(proc.exitcode == 0, f"rmat-s20 build failed (exit {proc.exitcode})")
    wait_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    csr = (np.load(os.path.join(out_dir, "row_ptr.npy")),
           np.load(os.path.join(out_dir, "col_ind.npy")))
    return (meta["n"], meta["edges"], csr,
            load_host_graph(os.path.join(out_dir, "host")), meta["build_s"],
            wait_s)


def msbfs_phase(geometry: str, n: int, csr, mid_level: int, seed: int,
                ref_dir: str, results: dict | None, host_build: bool) -> None:
    """Phase 11's kernel checks on one graph (module docstring): per K, the
    whole sweep on the card against the host sweep (:func:`host_sweeps`),
    one level from the sweep's mid state held to its plain version and
    timed (with the rule's pick, every level pulled, every level pushed),
    a span of :data:`SPAN` levels from that state held to the range twin,
    and ``build_index`` on the card."""
    dev = torch.device("cuda")
    rp_np, ci_np = csr
    rp, ci = md.upload_csr(rp_np, ci_np, dev)
    nnz = int(ci_np.shape[0])
    src_all = msbfs_sources(n, seed)
    want = np.load(os.path.join(ref_dir, f"{geometry}.npy"))
    with open(os.path.join(ref_dir, f"{geometry}.json")) as f:
        ref = json.load(f)
    adj = sparse_adjacency(n, csr, dev)
    share = md.DENSE_SHARE
    for k in MSBFS_KS:
        src = src_all[:k]
        sweeps = []
        for _ in range(2):  # the second is warm
            stats: dict = {}
            torch.cuda.synchronize()
            before = md.msbfs_levels.launches
            t0 = time.perf_counter()
            plane = md.msbfs_plane_csr(n, rp_np, ci_np, src, device=dev,
                                       stats=stats)
            sweeps.append((time.perf_counter() - t0) * 1e3)
            check(md.msbfs_levels.launches - before == 1
                  and (stats["launches"], stats["host_reads"]) == (1, 1),
                  f"msbfs sweep {geometry} K={k}: {stats}")
        check(np.array_equal(plane, want[:, :k]),
              f"msbfs sweep {geometry} K={k} differs from the host sweep")
        # the sweep on the card: the CSR already there, no copy back; the
        # whole sweep() (the state seeded, the launch, its status read)
        device_ms = time_launch(lambda: md.sweep(n, rp, ci, src), reps=3)
        reach0, pending0, dist0 = md.seed_state(
            n, torch.as_tensor(src, device=dev))
        reach, dist = reach0.clone(), dist0.clone()

        def reseed():
            reach.copy_(reach0)
            dist.copy_(dist0)

        # and the kernel alone, from the seeded state (its one status read)
        kernel_ms = time_launch(lambda: md.msbfs_levels(
            rp, ci, pending0, reach, dist, 1, md.INT16_MAX + 1, checked=True),
            reseed, reps=3)
        check(torch.equal(dist.cpu(), torch.from_numpy(want[:, :k])),
              f"msbfs sweep {geometry} K={k}: the timed launch differs")
        # the sweep's mid state, in one launch
        pending, st = md.msbfs_levels(rp, ci, pending0, reach0, dist0, 1,
                                      mid_level)
        check(st["levels"] == mid_level, f"msbfs mid state {geometry} {st}")
        reach, dist = reach0.clone(), dist0.clone()
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        lvl = mid_level + 1
        nxt = md.msbfs_level(rp, ci, pending, reach, dist, lvl, flag)
        reach_p, dist_p = reach0.clone(), dist0.clone()
        flag_p = torch.zeros(1, dtype=torch.int32, device=dev)
        nxt_p = md.msbfs_level_plain(rp, ci, pending, reach_p, dist_p, lvl,
                                     flag_p)
        torch.cuda.synchronize()
        err = max_abs_err([nxt, reach, dist, flag],
                          [nxt_p, reach_p, dist_p, flag_p])
        check(err == 0, f"msbfs_sweep {geometry} K={k} level {lvl} differs "
              f"from msbfs_level_plain (max abs err {err})")
        check(int(flag_p) == 1, f"msbfs mid state {geometry} K={k} is empty")
        changed = int((nxt_p != 0).sum())
        stamps = int((dist_p == lvl).sum())
        # the span: SPAN levels from the same state, kernel against twin
        reach_s, dist_s = reach0.clone(), dist0.clone()
        span_p, span_st = md.msbfs_levels(rp, ci, pending, reach_s, dist_s,
                                          lvl, lvl + SPAN - 1)
        reach_t, dist_t = reach0.clone(), dist0.clone()
        t0 = time.perf_counter()
        span_tp, span_tst = md.msbfs_levels_plain(rp, ci, pending, reach_t,
                                                  dist_t, lvl,
                                                  lvl + SPAN - 1)
        torch.cuda.synchronize()
        span_plain_ms = (time.perf_counter() - t0) * 1e3
        span_err = max_abs_err([span_p, reach_s, dist_s],
                               [span_tp, reach_t, dist_t])
        check(span_err == 0
              and (span_st["levels"], span_st["run"])
              == (span_tst["levels"], span_tst["run"]),
              f"msbfs_sweep {geometry} K={k} levels {lvl}..{lvl + SPAN - 1} "
              f"differ from msbfs_levels_plain (max abs err {span_err}, "
              f"{span_st} against {span_tst})")

        def restore():
            reach.copy_(reach0)
            dist.copy_(dist0)
            flag.zero_()

        def one_level():
            md.msbfs_level(rp, ci, pending, reach, dist, lvl, flag,
                           checked=True)

        ms = time_launch(one_level, restore)
        idle = torch.zeros_like(pending)  # a launch with nothing to push
        forced = {"empty_ms": time_launch(lambda: md.msbfs_level(
            rp, ci, idle, reach, dist, lvl, flag, checked=True), restore)}
        for mode, forced_share in (("pull", 0.0), ("push", 2.0)):
            md.DENSE_SHARE = forced_share  # every level pulled, or pushed
            try:
                forced[f"{mode}_ms"] = time_launch(one_level, restore)
            finally:
                md.DENSE_SHARE = share
        span_ms = time_launch(lambda: md.msbfs_levels(
            rp, ci, pending, reach, dist, lvl, lvl + SPAN - 1, checked=True),
            restore, reps=5)
        plain_ms = time_launch(lambda: md.msbfs_level_plain(
            rp, ci, pending, reach, dist, lvl, flag), restore, reps=5)
        plane01 = md.unpack_words(pending)[:, :k].float()
        library_ms = time_launch(lambda: torch.sparse.mm(adj, plane01))
        dense_ms, dense_by = msbfs_bound(n, nnz, md.plane_words(k), changed,
                                         stamps)
        by_level = ref["frontier_bytes"][str(k)]
        check(len(by_level) == int(want[:, :k].max()) + 2,
              f"frontier bytes {geometry} K={k}: {len(by_level)} levels")
        b_ms = frontier_ms(by_level[lvl])
        sweep_bound = frontier_ms(sum(by_level))
        torch.cuda.synchronize()
        before = md.msbfs_levels.launches
        # the build split into its sweeps, copies, scoring and index
        idx, build = build_split(
            {m: mod for m, mod in sys.modules.items()
             if m.startswith("bibfs_tpu_torch.")},
            n, rp_np, ci_np, k, dev, torch.cuda.synchronize)
        build_launches = md.msbfs_levels.launches - before
        extra = {}
        if host_build and k == ORACLE_K:
            t0 = time.perf_counter()
            host_idx = build_index(n, rp_np, ci_np, k, device="host")
            extra["host_build_index_ms"] = (time.perf_counter() - t0) * 1e3
            check(np.array_equal(host_idx.landmarks, idx.landmarks)
                  and np.array_equal(host_idx.dist, idx.dist),
                  f"build_index {geometry} K={k}: card != host")
        if k == max(MSBFS_KS):  # timed beside phases 1-10
            extra["host_sweep_ms"] = ref["host_sweep_ms"]
        if k == ORACLE_K:  # the sweep under other shares of the pull rule
            extra["share_sweeps"] = {}
            for other in DENSE_SHARES:
                got: dict = {}
                md.DENSE_SHARE = other
                try:
                    other_ms = time_launch(
                        lambda: md.sweep(n, rp, ci, src, stats=got), reps=3)
                finally:
                    md.DENSE_SHARE = share
                extra["share_sweeps"][f"{other:g}"] = dict(
                    ms=other_ms, dense_levels=got["dense_levels"])
        step_line("msbfs_sweep", geometry, f"K={k}", ms, k=k, level=lvl,
                  bound_ms=b_ms, bound_by="bytes", dense_bound_ms=dense_ms,
                  dense_bound_by=dense_by, **forced, plain_ms=plain_ms,
                  library_ms=library_ms, max_abs_err=err,
                  changed_words=changed, new_stamps=stamps,
                  span_levels=span_st["run"], span_ms=span_ms,
                  span_plain_ms=span_plain_ms, span_max_abs_err=span_err,
                  sweep_ms=sweeps[-1], first_sweep_ms=sweeps[0],
                  sweep_device_ms=device_ms, sweep_kernel_ms=kernel_ms,
                  sweep_bound_ms=sweep_bound,
                  sweep_over_bound=kernel_ms / sweep_bound, **stats,
                  build_index_ms=build["build_ms"],
                  build_split_ms={key[:-3]: build[key] for key in
                                  ("sweeps_ms", "copies_ms", "scoring_ms",
                                   "index_ms")},
                  build_index_launches=build_launches,
                  index_mb=idx.dist.nbytes / 1e6, **extra)
        if results is not None and k == ORACLE_K:
            results["msbfs_sweep"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by="bytes",
                dense_bound_ms=dense_ms, max_abs_err=max(err, span_err),
                library_ms=library_ms, sweep_ms=kernel_ms,
                sweep_bound_ms=sweep_bound, launches_per_sweep=1)
        del reach0, reach, reach_p, reach_s, reach_t, dist0, dist, dist_p
        del dist_s, dist_t, pending, pending0, plane01, idle
        torch.cuda.empty_cache()


def msbfs_floor(n: int) -> None:
    """A sweep's cost a level when the level does almost nothing: one
    source at the end of a path of :data:`FLOOR_PATH` vertices among
    ``n`` (the grid's vertex count, so the grid's block count), every
    level one pushed vertex: the launch, the barrier and a few dependent
    loads. Checked against the path's distances."""
    dev = torch.device("cuda")
    path = np.stack([np.arange(FLOOR_PATH - 1), np.arange(1, FLOOR_PATH)], 1)
    rp, ci = md.upload_csr(*build_csr(n, path), dev)
    stats: dict = {}
    ms = time_launch(lambda: md.sweep(n, rp, ci, np.zeros(1), stats=stats),
                     reps=3)
    plane = md.sweep(n, rp, ci, np.zeros(1)).cpu().numpy()[:, 0]
    want = np.full(n, -1, dtype=np.int16)
    want[:FLOOR_PATH] = np.arange(FLOOR_PATH)
    check(np.array_equal(plane, want), "msbfs floor: the path's distances")
    print(json.dumps({"phase": "msbfs_floor", "n": n, "levels":
                      stats["levels"], "sweep_ms": ms,
                      "us_per_level": ms * 1e3 / stats["levels"]}),
          flush=True)


def native_hops(n: int, edges, pairs, csr=None) -> list:
    """``(found, hops)`` of every pair by the native host solver's threaded
    batch on ``edges``; 8 seeded pairs audited against the serial oracle
    (on ``csr``, the CSR of ``edges``, when given)."""
    ng = NativeGraph.build(n, edges)
    res = solve_batch_native_graph(ng, np.asarray(pairs, dtype=np.int64))
    out = [(r.found, r.hops) for r in res]
    row_ptr, col_ind = build_csr(n, edges) if csr is None else csr
    for i in np.random.default_rng(53).choice(len(pairs), 8, replace=False):
        s, d = (int(v) for v in pairs[i])
        w = solve_serial_csr(n, row_ptr, col_ind, s, d)
        check((w.found, w.hops) == out[i],
              f"native {s}->{d} {out[i]} != serial {(w.found, w.hops)}")
    return out


def store_wave(eng, pairs, wave: str, graph: str, truth, edges, csr=None
               ) -> tuple[list, dict]:
    """Serve ``pairs`` on ``graph`` through a store-backed engine; every
    answer equal to ``truth`` (``(found, hops)`` per pair), exactly the
    queries the oracle answered at submit pathless, and every other found
    answer's path valid on ``edges`` (whose CSR ``csr`` is, when given).
    Returns the results and the printed line. The kernel counts are not
    reset here."""
    before = dict(eng.counters)
    consult = eng._consult_oracle
    served = []  # (src, dst, answered by the oracle) in submit order

    def record(t, name):
        hit = consult(t, name)
        served.append((t.src, t.dst, hit))
        return hit

    eng._consult_oracle = record
    tracer = Tracer()
    prev = set_tracer(tracer)
    t0 = time.perf_counter()
    try:
        res = eng.query_many(pairs, graph=graph)
    finally:
        wall = time.perf_counter() - t0
        set_tracer(prev)
        del eng._consult_oracle
    st = engine_clean(eng, wave)
    routed = {k: st[k] - before[k] for k in (
        "trivial", "oracle_served", "cache_served", "device_queries",
        "host_queries", "overlay_queries", "device_batches")}
    check(len(res) == len(pairs) and all(r is not None for r in res),
          f"store wave {wave}: a ticket is missing")
    if csr is None:
        csr = build_csr(eng._store.current(graph).n, edges)
    consults = iter(served)
    pathless = 0
    for (s, d), r, w in zip(pairs, res, truth):
        check((r.found, r.hops) == w,
              f"store wave {wave} {s}->{d}: {(r.found, r.hops)} != {w}")
        if s == d:
            continue  # trivial: answered before the oracle
        cs, cd, by_oracle = next(consults)
        check((cs, cd) == (int(s), int(d)),
              f"store wave {wave}: consult {cs}->{cd} out of order at {s}->{d}")
        if by_oracle:
            pathless += 1
            check(r.path is None,
                  f"store wave {wave} {s}->{d}: an oracle answer has a path")
        elif r.found:
            check(r.path is not None
                  and validate_path(csr, r.path, s, d, hops=r.hops),
                  f"store wave {wave} {s}->{d}: a {r.hops}-hop answer off "
                  "the oracle without a valid path")
    check(next(consults, None) is None and pathless == routed["oracle_served"],
          f"store wave {wave}: {pathless} oracle answers at submit, "
          f"{routed['oracle_served']} counted")
    line = {"phase": "store", "wave": wave, "graph": graph,
            "queries": len(pairs), **routed, "pathless": pathless,
            "flush_ms": max(r.time_s for r in res) * 1e3,
            "wall_ms": wall * 1e3, "queries_per_s": len(pairs) / wall,
            "spans_ms": span_ms(tracer),
            "version": st["graph"]["version"]}
    if "latency_ms" in st:
        line["latency_ms"] = st["latency_ms"]
        check(st["pipeline"]["outstanding"] == 0,
              f"store wave {wave}: tickets left outstanding")
    print(json.dumps(line), flush=True)
    return res, line


def store_phase(n: int, edges, csr) -> dict:
    """Phase 11's main path (module docstring); returns the kernel counts
    of the run."""
    perm = np.random.default_rng(43).permutation(n)
    twin = perm[edges]  # the same graph, vertices relabelled
    pairs = sample_skewed_pairs(n, STORE_QUERIES, seed=47, skew=1.3,
                                repeat_fraction=0.25,
                                degrees=np.diff(csr[0]))
    truth = native_hops(n, edges, pairs)
    reset_counts()
    # the baseline: the same traffic through a store without an oracle
    plain_store = GraphStore(compact_threshold=None)
    plain_store.add("grid", n, edges)
    base = QueryEngine(store=plain_store, max_batch=1024)
    store_wave(base, pairs, "B[sync]", "grid", truth, edges)
    base.close()
    plain_store.close()
    del base, plain_store
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    store = GraphStore(oracle_k=ORACLE_K, compact_threshold=None)
    store.add("grid", n, edges)
    store.add("twin", n, twin)
    for name in ("grid", "twin"):
        check(store.wait_for_index(name, timeout=600),
              f"store: no index for {name}")
    index_s = time.perf_counter() - t0
    ost = store.stats()["graphs"]["grid"]["oracle"]
    print(json.dumps({"phase": "store_index", "graphs": 2, "k": ORACLE_K,
                      "build_s": index_s,
                      "launches_both_graphs": md.msbfs_levels.launches,
                      "index": ost["index"]}), flush=True)
    eng = QueryEngine(store=store, max_batch=1024)
    res, _line = store_wave(eng, pairs, "O[sync]", "grid", truth, edges)
    # depth-only flushing at 128 queued misses: few, large device flushes
    pipe = PipelinedQueryEngine(store=store, max_batch=1024,
                                flush_threshold=128, max_wait_ms=None)
    res_p, _line = store_wave(pipe, pairs, "O[pipelined]", "grid", truth,
                              edges)
    for r, w in zip(res, res_p):
        check((r.found, r.hops) == (w.found, w.hops), "sync != pipelined")
    twin_pairs = perm[pairs[:500]]
    store_wave(pipe, twin_pairs, "O[pipelined twin]", "twin", truth[:500],
               twin)

    # one live update batch: the overlay route answers, exactly
    rng = np.random.default_rng(59)
    have = {tuple(e) for e in store.current("grid").undirected_edges().tolist()}
    adds = []
    while len(adds) < 24:
        u, v = (int(x) for x in rng.integers(0, n, 2))
        e = (min(u, v), max(u, v))
        if u != v and e not in have:
            have.add(e)
            adds.append(e)
    dels = [tuple(int(x) for x in edges[i])
            for i in rng.choice(len(edges), 8, replace=False)]
    store.update("grid", adds=adds, dels=dels)
    check(store.oracle("grid") is None, "store: a delete left the index live")
    # 64 pairs across the updated edges, each to a vertex near the far
    # endpoint (the overlay route is a host BFS: short pairs keep it brief)
    side = 500
    ov_pairs = []
    for u, v in adds + dels:
        for a, b in ((u, v), (v, u)):
            r, c = divmod(b, side)
            dr, dc = (int(x) for x in rng.integers(-6, 7, 2))
            near = (min(max(r + dr, 0), side - 1) * side
                    + min(max(c + dc, 0), side - 1))
            ov_pairs.append((a, near if near != a else b))
    merged = store.overlay("grid").merged_edges()
    _res, line = store_wave(pipe, ov_pairs, "U[overlay]", "grid",
                            native_hops(n, merged, ov_pairs), merged)
    check(line["overlay_queries"] == len(set(ov_pairs)),
          f"store: overlay route answered {line['overlay_queries']}")
    ms_per_query = line["wall_ms"] / len(ov_pairs)

    # the compaction swap: a new version, the index rebuilt at its gen
    t0 = time.perf_counter()
    v2 = store.compact("grid")
    compact_ms = (time.perf_counter() - t0) * 1e3
    check(v2.version == 2, f"store: compaction made v{v2.version}")
    check(store.wait_for_index("grid", timeout=600), "store: no v2 index")
    st = store.stats()["graphs"]["grid"]
    check(st["oracle"]["ready"] and st["oracle"]["index"]["version"] == 2
          and st["oracle"]["index"]["gen"] == st["oracle"]["gen"],
          f"store: v2 index {st['oracle']}")
    v2_edges = v2.undirected_edges()

    # a swap while a device flush is in flight: a second update (every
    # edge of 8 victims deleted) compacted from inside the flush's launch
    sw_rng = np.random.default_rng(61)
    victims = sw_rng.choice(n, 8, replace=False)
    ends = sw_rng.choice(np.setdiff1d(np.arange(n), victims), (248, 2))
    sw_pairs = [(int(s), int(d)) for s, d in ends if s != d]
    sw_pairs += [(int(ends[i, 0]), int(v)) for i, v in enumerate(victims)]
    cut = [(int(u), int(v)) for u, v in v2_edges.tolist()
           if u in set(victims.tolist()) or v in set(victims.tolist())]
    want_v2 = native_hops(n, v2_edges, sw_pairs)
    swap: dict = {}
    launch = eng._device_launch

    def launch_then_swap(p):
        if not swap:
            swap["in_flight"] = len(p)
            t1 = time.perf_counter()
            store.update("grid", dels=cut)
            swap["snapshot"] = store.compact("grid")
            swap["swap_ms"] = (time.perf_counter() - t1) * 1e3
        return launch(p)

    # the synchronous engine flushes the wave's misses as one batch, bound
    # to the snapshot it pinned before the swap
    eng._device_launch = launch_then_swap
    try:
        _res, line_in = store_wave(eng, sw_pairs, "S[in flight]", "grid",
                                   want_v2, v2_edges)
    finally:
        eng._device_launch = launch
    check(swap.get("in_flight", 0) > 0, "store: no device flush met the swap")
    v3 = swap["snapshot"]
    check(v3.version == 3 and store.current("grid") is v3,
          f"store: the forced swap made v{v3.version}")
    v3_edges = v3.undirected_edges()
    want_v3 = native_hops(n, v3_edges, sw_pairs)
    changed = sum(a != b for a, b in zip(want_v2, want_v3))
    check(changed >= len(victims), f"store: only {changed} answers changed")
    _res, line_post = store_wave(pipe, sw_pairs, "S[after]", "grid", want_v3,
                                 v3_edges)
    check(store.wait_for_index("grid", timeout=600), "store: no v3 index")
    st = store.stats()["graphs"]["grid"]
    check(st["version"] == 3 and st["oracle"]["index"]["version"] == 3
          and st["oracle"]["index"]["gen"] == st["oracle"]["gen"]
          and st["oracle"]["failures"] == 0, f"store: v3 index {st['oracle']}")
    _res, line_idx = store_wave(pipe, sw_pairs, "S[indexed]", "grid", want_v3,
                                v3_edges)
    eng.close()
    pipe.close()
    store.close()
    check(not pipe._flusher.is_alive(), "store: the flusher outlived close")
    launches = counts()
    print(json.dumps({"phase": "store_swap", "compact_ms": compact_ms,
                      "overlay_ms_per_query": ms_per_query,
                      "in_flight_queries": swap["in_flight"],
                      "forced_swap_ms": swap["swap_ms"],
                      "changed_answers": changed, "stale_answers": 0,
                      "wall_ms_in_flight": line_in["wall_ms"],
                      "wall_ms_after": line_post["wall_ms"],
                      "wall_ms_indexed": line_idx["wall_ms"],
                      "store": {k: st[k] for k in ("version", "swaps",
                                                   "compactions")},
                      "oracle": {k: st["oracle"][k] for k in (
                          "builds", "repairs", "aborts", "failures", "gen")}}),
          flush=True)
    print(json.dumps({"phase": "store_launches", **{
        k: v for k, v in launches.items() if v}}), flush=True)
    for name in ("msbfs_sweep", "minor_level[minor8]"):
        check(launches[name] > 0, f"kernel {name} was not launched on the "
              "store's path")
    return launches


def store_and_oracle_phase(gnp_csr, results: dict, host_ref, ref_dir: str
                           ) -> dict:
    """Phase 11 (module docstring); ``host_ref`` is the
    :func:`host_sweeps` process writing into ``ref_dir``."""
    t0 = time.perf_counter()
    (grid, n, make, grid_level, grid_seed), gnp = MSBFS_GEOMS
    edges = make()
    csr = build_csr(n, edges)
    print(json.dumps({"phase": "graph", "name": grid, "n": n,
                      "edges": int(edges.shape[0]),
                      "build_s": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    host_ref.join(timeout=900)
    check(host_ref.exitcode == 0,
          f"the host sweeps' process ended with {host_ref.exitcode}")
    print(json.dumps({"phase": "host_sweeps_wait", "s": time.perf_counter() - t0}),
          flush=True)
    msbfs_phase(grid, n, csr, grid_level, grid_seed, ref_dir, results,
                host_build=True)
    msbfs_floor(n)
    check(len(gnp_csr[0]) - 1 == gnp[1], "phase 11 needs the gnp-deg8-s20 CSR")
    msbfs_phase(gnp[0], gnp[1], gnp_csr, gnp[3], gnp[4], ref_dir, None,
                host_build=False)
    return store_phase(n, edges, csr)


# ---- phase 12: the durable store ---------------------------------------
def fresh_batch(rng, n: int, csr, k_add: int, k_del: int, added: set,
                deleted: set) -> tuple[list, list]:
    """``k_add`` seeded edges the graph lacks and ``k_del`` it has (its
    first CSR ``csr`` less ``deleted``, plus ``added``), none touched by an
    earlier batch; both sets take the batch."""
    rp, ci = csr
    adds: list = []
    while len(adds) < k_add:
        u, v = sorted(int(x) for x in rng.integers(0, n, 2))
        e = (u, v)
        if (u == v or e in added or e in deleted or e in adds
                or v in ci[rp[u]:rp[u + 1]]):
            continue
        adds.append(e)
    dels: list = []
    while len(dels) < k_del:
        u = int(rng.integers(0, n))
        row = ci[rp[u]:rp[u + 1]]
        if row.size == 0:
            continue
        v = int(row[int(rng.integers(0, row.size))])
        e = (min(u, v), max(u, v))
        if e in deleted or e in dels:
            continue
        dels.append(e)
    added.update(adds)
    deleted.update(dels)
    return adds, dels


def has_edge(csr, u: int, v: int) -> bool:
    rp, ci = csr
    return bool((ci[rp[u]:rp[u + 1]] == v).any())


def live_has(store, name: str, u: int, v: int) -> bool:
    """Whether ``name``'s live graph (its snapshot and pending overlay)
    holds the edge ``u``-``v``."""
    e = (min(u, v), max(u, v))
    ov = store.overlay(name)
    if ov is not None:
        adds, dels = ov.capture()
        if e in adds:
            return True
        if e in dels:
            return False
    return has_edge(store.current(name).csr(), *e)


def live_digest(store, name: str) -> str:
    """The content digest of ``name``'s live graph, pending overlay
    included."""
    from bibfs_tpu_torch.store import content_digest

    ov = store.overlay(name)
    snap = store.current(name)
    if ov is None:
        return snap.digest
    return content_digest(snap.n, canonical_pairs(snap.n, ov.merged_edges()))


def check_acked(store, name: str, batches, wave: str) -> None:
    """Every acked add of ``batches`` is in ``name``'s live graph and every
    acked delete is not."""
    for adds, dels in batches:
        for u, v in adds:
            check(live_has(store, name, u, v),
                  f"{wave}: acked add {u}-{v} of {name} is missing")
        for u, v in dels:
            check(not live_has(store, name, u, v),
                  f"{wave}: acked delete {u}-{v} of {name} is back")


def engine_options(dev_name: str) -> dict:
    """Phase 12's engine options: on the CPU (a rehearsal at a small size)
    the device route is forced, as the tests force it."""
    if dev_name == "cuda":
        return {"max_batch": 1024}
    return {"max_batch": 1024, "device": dev_name, "device_batches": True}


def crash_child(root: str, batches, conn, dev_name: str) -> None:
    """Phase 12's crash: recover the store, ack ``batches`` on the grid
    one by one (each ack reported with the live graph's digest), then
    wait to be killed."""
    store = GraphStore.from_dir(root, durable=True, fsync="always",
                                oracle_k=ORACLE_K, retain_history=True,
                                compact_threshold=None,
                                sidecar_layouts=("ell",), device=dev_name)
    st = store.stats()["graphs"]
    conn.send({"recovered": {name: g["durable"]["recovered"]["remapped"]
                             for name, g in st.items()},
               "indexes": {name: g["durable"]["recovered"]["index_adopted"]
                           for name, g in st.items()}})
    for i, (adds, dels) in enumerate(batches):
        store.update("grid", adds=adds, dels=dels)  # returning is the ack
        conn.send({"acked": i, "digest": live_digest(store, "grid"),
                   "version": store.current("grid").version})
    time.sleep(3600)


def recovery_split(store, seconds: float) -> dict:
    """One recovery's seconds per graph (``recovered["split_s"]``: the
    base snapshot mapped or rebuilt, the WAL replay, the registration with
    the index adopted) beside the whole ``from_dir``."""
    out = {"from_dir_s": seconds, "graphs": {}}
    for name, g in store.stats()["graphs"].items():
        rec = g["durable"]["recovered"]
        out["graphs"][name] = {
            "base_s": rec["split_s"]["base"],
            "replay_s": rec["split_s"]["replay"],
            "register_s": rec["split_s"]["register"],
            "replayed_records": rec["replayed_records"],
            "remapped": rec["remapped"], "tier": g["tier"],
            "index_adopted": rec["index_adopted"],
            "version": g["version"], "digest": g["digest"],
        }
    return out


def first_answers(eng, name: str, pairs, dev) -> dict:
    """The seconds to the card's tables of ``name`` (built where the
    snapshot lacks them, copied from its host arrays, uploaded), to the
    first answer (one query; the route that answered it reported) and to
    the first flush of ``BATCH`` queries."""
    t0 = time.perf_counter()
    eng._graph_rt(name).graph  # noqa: B018  the upload
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = dict(eng.counters)
    s, d = (int(x) for x in pairs[0])
    eng.query(s, d, graph=name)
    t2 = time.perf_counter()
    route = [k for k in ("oracle_served", "cache_served", "host_queries",
                         "device_queries") if eng.counters[k] > before[k]]
    eng.query_many(pairs[1:1 + BATCH], graph=name)
    t3 = time.perf_counter()
    return {"upload_s": t1 - t0, "first_answer_s": t2 - t1,
            "first_answer_route": route, "first_flush_s": t3 - t2}


def durable_respawn(root: str, expect: dict, conn, dev_name: str) -> None:
    """Phase 12's respawn (module docstring), in a fresh process: the
    mapped recovery and its waves, then the rebuild path, the grid's fold,
    the residency budget and the promote. Sends the kernel counts of the
    run to the parent."""
    dev = torch.device(dev_name)
    on_card = dev.type == "cuda"
    reset_counts()
    lines: dict = {}
    kw = engine_options(dev_name)
    t0 = time.perf_counter()
    store = GraphStore.from_dir(root, durable=True, fsync="always",
                                oracle_k=ORACLE_K, retain_history=True,
                                compact_threshold=None, device=dev_name)
    lines["mapped"] = recovery_split(store, time.perf_counter() - t0)
    g = lines["mapped"]["graphs"]
    check(g["gnp"]["remapped"] and g["gnp"]["tier"] == "mapped"
          and g["gnp"]["index_adopted"] and g["gnp"]["replayed_records"] == 0,
          f"durable: gnp recovered as {g['gnp']}")
    check(g["gnp"]["digest"] == expect["gnp"]["digest"]
          and g["gnp"]["version"] == expect["gnp"]["version"],
          "durable: gnp is not the checkpointed snapshot")
    check(g["grid"]["remapped"]
          and g["grid"]["replayed_records"] == len(expect["crash_batches"]),
          f"durable: grid recovered as {g['grid']}")
    check(live_digest(store, "grid") == expect["grid"]["digest"],
          "durable: the grid's live digest is not the killed process's")
    check(store.oracle("gnp") is not None and store.oracle("grid") is None,
          "durable: the adopted indexes")
    check_acked(store, "gnp", expect["gnp"]["batches"], "durable")
    check_acked(store, "grid", expect["grid"]["batches"]
                + expect["crash_batches"], "durable")
    gnp_n = store.current("gnp").n
    pairs = sample_skewed_pairs(gnp_n, STORE_QUERIES, seed=83, skew=1.3,
                                repeat_fraction=0.25,
                                degrees=np.diff(store.current("gnp").csr()[0]))
    eng = QueryEngine(store=store, **kw)
    lines["mapped"].update(first_answers(eng, "gnp", pairs, dev))
    gnp_edges = store.current("gnp").undirected_edges()
    gnp_csr = build_csr(gnp_n, gnp_edges)
    truth = native_hops(gnp_n, gnp_edges, pairs, csr=gnp_csr)
    res, _ = store_wave(eng, pairs, "R[gnp mapped]", "gnp", truth, gnp_edges,
                        csr=gnp_csr)
    pal = QueryEngine(store=store, mode="pallas", **kw)
    res_p, _ = store_wave(pal, pairs, "R[gnp mapped pallas]", "gnp", truth,
                          gnp_edges, csr=gnp_csr)
    check(all(r.hops == w.hops for r, w in zip(res, res_p)),
          "durable: pallas != auto on the mapped graph")
    eng.close()
    pal.close()
    store.close()
    mapped_counts = counts()
    print(json.dumps({"phase": "durable_launches", "path": "mapped",
                      **{k: v for k, v in mapped_counts.items() if v}}),
          flush=True)
    if on_card:
        for name in ("minor_level[minor8]", "pull_dual_batch"):
            check(mapped_counts[name] > 0,
                  f"kernel {name} was not launched on the recovered store")
        check(mapped_counts["msbfs_sweep"] == 0,
              "durable: the respawn swept though its indexes were adopted")
    del res, res_p, gnp_csr
    if on_card:
        torch.cuda.empty_cache()

    # the rebuild path on the same directory, then the fold, the budget
    t0 = time.perf_counter()
    store = GraphStore.from_dir(root, durable=True, fsync="always",
                                mmap_arrays=False, retain_history=True,
                                compact_threshold=None)
    lines["rebuild"] = recovery_split(store, time.perf_counter() - t0)
    g = lines["rebuild"]["graphs"]
    check(not g["gnp"]["remapped"] and g["gnp"]["tier"] == "hot"
          and g["gnp"]["digest"] == expect["gnp"]["digest"],
          f"durable: the rebuilt gnp {g['gnp']}")
    check(live_digest(store, "grid") == expect["grid"]["digest"],
          "durable: the rebuilt grid's live digest")
    eng = QueryEngine(store=store, **kw)
    lines["rebuild"].update(first_answers(eng, "gnp", pairs, dev))
    t0 = time.perf_counter()
    folded = store.compact("grid")
    lines["rebuild"]["grid_fold_s"] = time.perf_counter() - t0
    check(folded.digest == expect["grid"]["digest"]
          and folded.version == expect["grid"]["version"] + 1,
          "durable: the grid's fold is not the killed process's graph")
    grid_n = folded.n
    grid_edges = folded.undirected_edges().copy()
    grid_pairs = sample_skewed_pairs(grid_n, STORE_QUERIES, seed=89, skew=1.3,
                                     repeat_fraction=0.25,
                                     degrees=np.diff(folded.csr()[0]))
    grid_csr = build_csr(grid_n, grid_edges)
    grid_truth = native_hops(grid_n, grid_edges, grid_pairs, csr=grid_csr)
    before = store.memory_stats()
    store.residency_budget = before["resident_bytes"] - 1
    rebalanced = store.rebalance()
    check(rebalanced["demoted"] == ["grid"]
          and store.current("grid").tier == "cold",
          f"durable: the budget demoted {rebalanced['demoted']}")
    store_wave(eng, grid_pairs, "R[grid promoted]", "grid", grid_truth,
               grid_edges, csr=grid_csr)
    after = store.memory_stats()
    check(after["graphs"]["grid"]["tier"] == "hot"
          and after["graphs"]["grid"]["promotions"] == 1,
          f"durable: the grid after its wave {after['graphs']['grid']}")
    print(json.dumps({"phase": "durable_memory", "rebalance": rebalanced,
                      "before": before, "after": after}), flush=True)
    eng.close()
    store.close()
    rebuild_counts = {k: v - mapped_counts[k] for k, v in counts().items()}
    print(json.dumps({"phase": "durable_launches", "path": "rebuild",
                      **{k: v for k, v in rebuild_counts.items() if v}}),
          flush=True)
    if on_card:
        check(rebuild_counts["minor_level[minor8]"] > 0,
              "kernel minor_level[minor8] was not launched on the rebuilt store")
    print(json.dumps({"phase": "durable", **lines}), flush=True)
    conn.send({"counts": counts()})


def durable_phase(gnp_n: int, gnp_pairs, gnp_csr, grid=None,
                  dev_name: str = "cuda") -> dict:
    """Phase 12 (module docstring): the durable store built, served,
    updated and checkpointed here; a spawned child acks more and is
    SIGKILLed; a second spawned child recovers and serves. ``grid``
    (``(n, edges)``, default phase 11's grid) and ``dev_name="cpu"`` run
    it small on the CPU. Returns the kernel counts of the build here and
    of the respawn's run."""
    import shutil

    if grid is None:
        grid = (MSBFS_GEOMS[0][1], MSBFS_GEOMS[0][2]())
    graphs = {"grid": grid}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".chip_durable")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=root)
    ctx = multiprocessing.get_context("spawn")
    try:
        reset_counts()
        csrs = {"gnp": gnp_csr}
        t0 = time.perf_counter()
        store = GraphStore(wal_dir=tmp, fsync="always", oracle_k=ORACLE_K,
                           retain_history=True, compact_threshold=None,
                           sidecar_layouts=("ell",), device=dev_name)
        store.add("gnp", gnp_n, pairs=gnp_pairs)
        for name, (n, edges) in graphs.items():
            store.add(name, n, edges)
            csrs[name] = build_csr(n, edges)
        add_s = time.perf_counter() - t0
        for name in store.names():
            check(store.wait_for_index(name, timeout=600),
                  f"durable: no index for {name}")
        index_s = time.perf_counter() - t0 - add_s
        # a first wave on each graph: its tables built and uploaded
        eng = QueryEngine(store=store, **engine_options(dev_name))
        for name in store.names():
            snap = store.current(name)
            pairs = sample_skewed_pairs(snap.n, BATCH, seed=79, skew=1.3,
                                        repeat_fraction=0.25,
                                        degrees=np.diff(csrs[name][0]))
            edges = snap.undirected_edges()
            store_wave(eng, pairs, f"D[{name} v1]", name,
                       native_hops(snap.n, edges, pairs, csr=csrs[name]),
                       edges, csr=csrs[name])
        expect: dict = {}
        added: dict = {name: set() for name in store.names()}
        deleted: dict = {name: set() for name in store.names()}
        rng = np.random.default_rng(97)
        checkpoint = {}
        for name in store.names():
            n = store.current(name).n
            batches = [fresh_batch(rng, n, csrs[name], k_add, k_del,
                                   added[name], deleted[name])
                       for k_add, k_del in ((24, 8), (16, 8))]
            t1 = time.perf_counter()
            for adds, dels in batches:
                store.update(name, adds=adds, dels=dels)
            update_s = time.perf_counter() - t1
            tracer = Tracer()
            prev = set_tracer(tracer)
            t1 = time.perf_counter()
            try:
                snap = store.compact(name)
            finally:
                set_tracer(prev)
            compact_s = time.perf_counter() - t1
            st = store.stats()["graphs"][name]
            sidecar = os.path.join(tmp, st["durable"]["arrays"])
            with open(os.path.join(sidecar, "manifest.json")) as f:
                groups = sorted(json.load(f)["arrays"])
            check(snap.version == 2 and st["oracle"]["ready"]
                  and st["oracle"]["index"]["version"] == 2,
                  f"durable: the {name} checkpoint {st['oracle']}")
            for group in ("ell.nbr", "oracle.dist", "oracle.landmarks"):
                check(group in groups, f"durable: {name}'s sidecar lacks {group}")
            check_acked(store, name, batches, "checkpoint")
            checkpoint[name] = {
                "updates_s": update_s, "compact_s": compact_s,
                "spans_ms": span_ms(tracer),
                "sidecar_mb": sum(
                    os.path.getsize(os.path.join(sidecar, f))
                    for f in os.listdir(sidecar)) / 2 ** 20,
                "bin_mb": os.path.getsize(
                    os.path.join(tmp, st["durable"]["bin"])) / 2 ** 20,
                "groups": groups, "version": snap.version,
            }
            expect[name] = {"digest": snap.digest, "version": snap.version,
                            "batches": batches}
        eng.close()
        store.close()
        build_counts = counts()
        print(json.dumps({"phase": "durable_checkpoint", "add_s": add_s,
                          "index_s": index_s, "graphs": checkpoint,
                          "launches": {k: v for k, v in build_counts.items()
                                       if v}}), flush=True)
        if dev_name == "cuda":
            check(build_counts["msbfs_sweep"] > 0,
                  "durable: the checkpoint's index was not swept on the card")
            torch.cuda.empty_cache()
        del store, eng

        # the crash: a child acks the grid's batches and is SIGKILLed
        n = graphs["grid"][0]
        crash = [fresh_batch(rng, n, csrs["grid"], k_add, k_del,
                             added["grid"], deleted["grid"])
                 for k_add, k_del in ((12, 4), (8, 4), (6, 2))]
        parent, child = ctx.Pipe()
        t0 = time.perf_counter()
        proc = ctx.Process(target=crash_child,
                           args=(tmp, crash, child, dev_name), daemon=True)
        proc.start()
        acks = []
        try:
            check(parent.poll(600), "durable: the crash child never recovered")
            opened = parent.recv()
            check(all(opened["recovered"].values())
                  and all(opened["indexes"].values()),
                  f"durable: the crash child's recovery {opened}")
            for _ in crash:
                check(parent.poll(600), "durable: an ack never came")
                acks.append(parent.recv())
            os.kill(proc.pid, signal.SIGKILL)
        finally:
            if proc.is_alive():
                proc.kill()
            proc.join(60)
        check(proc.exitcode == -signal.SIGKILL,
              f"durable: the crash child ended with {proc.exitcode}")
        expect["grid"]["digest"] = acks[-1]["digest"]
        expect["grid"]["version"] = acks[-1]["version"]
        expect["crash_batches"] = crash
        print(json.dumps({"phase": "durable_crash", "acked": len(acks),
                          "child_s": time.perf_counter() - t0,
                          "killed_by": "SIGKILL"}), flush=True)

        # the respawn
        parent, child = ctx.Pipe()
        t0 = time.perf_counter()
        proc = ctx.Process(target=durable_respawn,
                           args=(tmp, expect, child, dev_name),
                           daemon=True)
        proc.start()
        try:
            proc.join(900)
            got = parent.recv() if parent.poll(1) else None
        finally:
            if proc.is_alive():
                proc.kill()
                proc.join(60)
        check(proc.exitcode == 0 and got is not None,
              f"durable: the respawn ended with {proc.exitcode}")
        print(json.dumps({"phase": "durable_respawn",
                          "s": time.perf_counter() - t0}), flush=True)
        return {"build": build_counts, "respawn": got["counts"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- phase 13: the query kinds ---------------------------------------------
# the kinds' two device programs: the XLA while_loops of the reference's
# device delta-stepping and batched restricted BFS (neither is a Pallas
# kernel)
QUERY_KERNELS = {
    "delta_stepping": ("bibfs_tpu_torch/csrc/query_device.cu",
                       "bibfs_tpu/solvers/query_device.py:50"),
    "restricted_sweep": ("bibfs_tpu_torch/csrc/query_device.cu",
                         "bibfs_tpu/solvers/query_device.py:226"),
}
KIND_MIX = "pt=0.5,msbfs=0.2,weighted=0.15,kshortest=0.1,asof=0.05"
# the waves cut from 1,000 + 300, then from 400 + 300: the host references
# of the typed queries (Yen's ~12-17 s each, delta-stepping's ~3 s) run
# beside phases 1-12 on 4 of the host's cores; at 1,000 + 300 they take
# ~500 s of 4 workers alone (kind_refs_main) and ran past those phases,
# at 400 + 300 ~360 s, slowing the phases' own host work
KIND_QUERIES = {"sync": 200, "pipelined": 150}
KIND_WAVE = 100  # queries a synchronous query_many serves (one flush)
KIND_SEEDS = {"sync": 131, "pipelined": 137, "grid": 139, "batch": 149,
              "pairs": 151}
KIND_BATCH = (24, 8)  # adds and deletes of the update batch of each graph
KIND_REF_WORKERS = 4
# the grid's weighted pair and the reference's own numbers for it
# (bibfs_tpu's delta_stepping_device on the CPU, weight seed 0)
GRID_PAIR = (0, 249999)
GRID_WANT = {"dist": 2663.0, "hops": 1014, "buckets": 532,
             "relaxations": 2964583}
GRID_HOPS = 100  # hops of the restricted sweep's grid pair
DELTA_FLOOR_PATH = 2_000  # a path's vertices: a delta solve of empty passes
GRID_FAULTED = 8  # weighted grid queries of the faulted wave

_KIND_REF: dict = {}


def edges_after(n: int, pairs: np.ndarray, adds, dels) -> np.ndarray:
    """The canonical pairs (both directions, row-major) of ``pairs`` with
    the undirected ``adds`` added and ``dels`` deleted."""
    codes = pairs[:, 0].astype(np.int64) * n + pairs[:, 1]
    both = lambda es: np.asarray(  # noqa: E731
        [u * n + v for u, v in es] + [v * n + u for u, v in es],
        dtype=np.int64)
    codes = np.union1d(codes[~np.isin(codes, both(dels))], both(adds))
    return np.stack([codes // n, codes % n], axis=1)


def kind_ref_init(graph_dir: str) -> None:
    """A host-reference worker: the graphs as of their second version."""
    for name in ("gnp", "grid"):
        z = np.load(os.path.join(graph_dir, f"{name}.npz"))
        _KIND_REF[name] = (int(z["n"]), z["row_ptr"], z["col_ind"], {})


def kind_ref(name: str, q):
    """The port's host kind rung's answer to one query on ``name`` as of
    its second version: delta-stepping (``(found, dist)``) or Yen's
    (``(found, paths)``); then the worker's wall and CPU seconds for it."""
    from bibfs_tpu_torch.query.kshortest import yen_k_shortest
    from bibfs_tpu_torch.query.weighted import delta_stepping, synthetic_weights

    t0, c0 = time.perf_counter(), time.process_time()
    n, rp, ci, weights = _KIND_REF[name]
    if q.kind == "weighted":
        seed = int(q.weight_seed)
        if seed not in weights:
            weights[seed] = synthetic_weights(rp, ci, seed)
        r = delta_stepping(n, rp, ci, weights[seed], q.src, q.dst)
        out = (r.found, r.dist)
    else:
        r = yen_k_shortest(n, rp, ci, q.src, q.dst, q.k)
        out = (r.found, r.paths)
    return out, time.perf_counter() - t0, time.process_time() - c0


def refs_report(prep) -> dict:
    """How the host references went: their count and workers, the
    seconds from the pool's start until the last was done, and per kind
    the count and the workers' wall and CPU seconds (wall well above CPU:
    the workers waited for cores)."""
    kinds: dict = {}
    for key, fut in prep["refs"].items():
        _out, wall, cpu = fut.result()
        k = kinds.setdefault(prep["ref_kind"][key], {"n": 0, "wall_s": 0.0,
                                                     "cpu_s": 0.0})
        k["n"] += 1
        k["wall_s"] += wall
        k["cpu_s"] += cpu
    return {"references": len(prep["refs"]), "workers": prep["workers"],
            "refs_done_s": max(prep["ref_done"]) - prep["ref_t0"],
            "by_kind": kinds}


def kind_prep(gnp_n: int, gnp_pairs, gnp_csr, ref_dir: str, grid=None,
              workers: int = KIND_REF_WORKERS, sizes=KIND_QUERIES) -> dict:
    """Phase 13's inputs, made at the start of the run: each graph's update
    batch and its second version's CSR, the seeded query streams (``sizes``:
    queries a wave), and a pool of spawned workers computing the host kind
    rung's answers to the weighted and k-shortest queries (NumPy minutes
    that overlap phases 1-12). ``grid`` (``(n, edges)``, default phase
    11's) runs it small."""
    from concurrent.futures import ProcessPoolExecutor

    from bibfs_tpu_torch.query import MultiSource, Weighted
    from bibfs_tpu_torch.serve.loadgen import parse_query_mix, sample_query_mix

    if grid is None:
        grid = (MSBFS_GEOMS[0][1], MSBFS_GEOMS[0][2]())
    gn = grid[0]
    gpairs = canonical_pairs(gn, grid[1])
    graphs = {"gnp": (gnp_n, gnp_pairs, gnp_csr),
              "grid": (gn, gpairs, build_csr(gn, pairs=gpairs))}
    rng = np.random.default_rng(KIND_SEEDS["batch"])
    prep: dict = {"graphs": {}, "queries": {}}
    for name, (n, pairs, csr) in graphs.items():
        adds, dels = fresh_batch(rng, n, csr, *KIND_BATCH, set(), set())
        v2 = edges_after(n, pairs, adds, dels)
        csr2 = build_csr(n, pairs=v2)
        np.savez(os.path.join(ref_dir, f"{name}.npz"), n=n, row_ptr=csr2[0],
                 col_ind=csr2[1])
        prep["graphs"][name] = dict(n=n, pairs=pairs, csr=csr, batch=(adds, dels),
                                    pairs2=v2, csr2=csr2)
    mix = parse_query_mix(KIND_MIX)
    for wave, q in sizes.items():
        prep["queries"][wave] = sample_query_mix(
            gnp_n, q, mix, seed=KIND_SEEDS[wave], ms_sources=16, k=3,
            weight_seed=0, versions=(1, 2))
    grng = np.random.default_rng(KIND_SEEDS["grid"])
    shared = tuple(int(x) for x in grng.choice(gn, 32, replace=False))
    prep["queries"]["grid"] = (
        [MultiSource(shared, int(grng.integers(gn))) for _ in range(64)]
        + [Weighted(*(int(x) for x in grng.choice(gn, 2, replace=False)))
           for _ in range(16)])
    tasks = {("gnp", q.cache_key()): ("gnp", q)
             for wave in sizes for q in prep["queries"][wave]
             if q.kind in ("weighted", "kshortest")}
    tasks.update({("grid", q.cache_key()): ("grid", q)
                  for q in prep["queries"]["grid"] if q.kind == "weighted"})
    pool = ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=kind_ref_init, initargs=(ref_dir,))
    prep.update(pool=pool, workers=workers, ref_t0=time.perf_counter(),
                ref_done=[],
                ref_kind={k: f"{g}:{q.kind}" for k, (g, q) in tasks.items()})
    prep["refs"] = {key: pool.submit(kind_ref, *task)
                    for key, task in tasks.items()}
    for fut in prep["refs"].values():
        fut.add_done_callback(
            lambda _f: prep["ref_done"].append(time.perf_counter()))
    return prep


def yen_first_cands(n: int, csr, s: int, d: int) -> list:
    """The spur candidates of Yen's first iteration from ``s`` to ``d``
    (``yen_k_shortest``'s construction with one accepted path)."""
    from bibfs_tpu_torch.query.kshortest import bfs_restricted

    first = bfs_restricted(n, *csr, s, d)
    check(first is not None, f"restricted sweep: no path {s}->{d}")
    return [(first[i], set(first[:i]), {(first[i], first[i + 1])})
            for i in range(len(first) - 1)]


def delta_pass_bytes(tgt, wts, s: int, d: int, delta: float) -> int:
    """The bytes the passes of one delta-stepping solve need, counted on
    its twin's passes: each in-bucket vertex's distance (4 B) and its live
    slots (8 B a target and weight: the class test reads the weight), each
    relaxed slot's target distance (4 B), and each distance a pass lowers
    (4 B written)."""
    deg = (tgt < tgt.shape[0]).sum(dim=1)
    acc = torch.zeros((), dtype=torch.int64, device=tgt.device)
    relaxed = 0

    def on_pass(frontier, old, new, cnt):
        nonlocal relaxed
        acc.add_(4 * frontier.sum() + 8 * (deg * frontier).sum()
                 + 4 * (new < old).sum())
        relaxed += cnt

    qd.delta_stepping_plain(tgt, wts, s, d, delta, on_pass=on_pass)
    return int(acc) + 4 * relaxed


def delta_floor(n: int, dev) -> float:
    """``delta_stepping_kernel``'s cost a pass when a pass does almost
    nothing: a path of :data:`DELTA_FLOOR_PATH` vertices among ``n`` (the
    grid's vertex count, so its block count and table rows), end to end,
    a vertex or two a bucket: every pass runs in one block, a few
    dependent loads and the block's syncs. Checked against the path's
    weight. Returns microseconds a pass."""
    from bibfs_tpu_torch.graph.csr import build_ell
    from bibfs_tpu_torch.query.weighted import path_weight, synthetic_weights

    last = DELTA_FLOOR_PATH - 1
    pairs = canonical_pairs(n, np.stack(
        [np.arange(last), np.arange(1, DELTA_FLOOR_PATH)], 1))
    rp, ci = build_csr(n, pairs=pairs)
    w = synthetic_weights(rp, ci, 0)
    tables = qd.delta_tables(build_ell(n, pairs=pairs), 0, device=dev)
    stats: dict = {}
    res = qd.delta_stepping_device(n, rp, ci, w, tables, 0, last, stats=stats)
    check(res.path == list(range(DELTA_FLOOR_PATH))
          and path_weight(rp, ci, w, res.path) == res.dist,
          f"delta floor: {res.hops} hops, weight {res.dist}")
    delta = float(w.mean())
    ms = time_launch(lambda: qd.delta_stepping(*tables, 0, last, delta),
                     reps=3)
    us = ms * 1e3 / stats["passes"]
    print(json.dumps({"phase": "delta_floor", "n": n, "path": last + 1,
                      "passes": stats["passes"],
                      "solo_passes": stats.get("solo_passes"), "ms": ms,
                      "us_per_pass": us}), flush=True)
    return us


def delta_check(geometry: str, n: int, graph_pairs, csr, pairs, dev,
                on_card: bool, want=None, us_per_pass=None) -> dict:
    """``delta_stepping_kernel`` against its plain twin on the card for
    each pair (weight seed 0): the distance vectors equal, the buckets,
    relaxations and passes equal, the path of that weight and valid; one
    ``step`` line each, its bound the bytes the passes need
    (:func:`delta_pass_bytes`), beside the whole table read and written
    every pass (``dense_bound_ms``) and, given the kernel's cost a near
    empty pass (:func:`delta_floor`), that cost times the passes
    (``barrier_floor_ms``). Returns the last pair's numbers."""
    from bibfs_tpu_torch.graph.csr import build_ell
    from bibfs_tpu_torch.query.weighted import path_weight, synthetic_weights

    rp, ci = csr
    w = synthetic_weights(rp, ci, 0)
    delta = float(w.mean())
    tgt, wts = qd.delta_tables(build_ell(n, pairs=graph_pairs), 0, device=dev)
    n_pad, width = tgt.shape
    adj_w = torch.sparse_csr_tensor(
        torch.from_numpy(rp), torch.from_numpy(ci.astype(np.int64)),
        torch.from_numpy(w.astype(np.float32)), size=(n, n)).to(dev)
    line: dict = {}
    for s, d in pairs:
        stats: dict = {}
        before = qd.delta_stepping.launches
        res = qd.delta_stepping_device(n, rp, ci, w, (tgt, wts), s, d,
                                       stats=stats)
        check(qd.delta_stepping.launches - before == int(on_card),
              f"delta_stepping {geometry} {s}->{d}: "
              f"{qd.delta_stepping.launches - before} launches a solve")
        got, info = qd.delta_stepping(tgt, wts, s, d, delta)
        (twin, tinfo), plain_ms = timed_once(
            lambda: qd.delta_stepping_plain(tgt, wts, s, d, delta), on_card)
        check(torch.equal(got, twin),
              f"delta_stepping {geometry} {s}->{d}: kernel != twin")
        for key in ("buckets", "relaxations", "passes"):
            check(info[key] == tinfo[key] == stats[key],
                  f"delta_stepping {geometry} {s}->{d}: {key} "
                  f"{info[key]} / twin {tinfo[key]}")
        check(res.found, f"delta_stepping {geometry} {s}->{d}: no path")
        check(path_weight(rp, ci, w, res.path) == res.dist
              and validate_path(csr, res.path, s, d, hops=res.hops),
              f"delta_stepping {geometry} {s}->{d}: bad path")
        if want is not None:
            got_want = {"dist": res.dist, "hops": res.hops,
                        "buckets": res.buckets,
                        "relaxations": res.relaxations}
            check(got_want == want,
                  f"delta_stepping {geometry} {s}->{d}: {got_want} != {want}")
        # the bytes the passes need, a few operations a relaxation; beside
        # it every pass reading the whole table (8 B a slot) and the
        # distances, and writing them
        b_ms, b_by = bound_ms(delta_pass_bytes(tgt, wts, s, d, delta),
                              4 * info["relaxations"])
        dense_ms, dense_by = bound_ms(
            (n_pad * width * 8 + n_pad * 8) * info["passes"],
            4 * n_pad * width * info["passes"])
        line = dict(passes=info["passes"], buckets=info["buckets"],
                    relaxations=info["relaxations"], dist=res.dist,
                    hops=res.hops, solo_passes=info.get("solo_passes"),
                    grid_passes=info.get("grid_passes"),
                    solo_cap=qd.DELTA_SOLO_CAP, lanes=qd.delta_lanes(width),
                    bound_ms=b_ms, bound_by=b_by,
                    dense_bound_ms=dense_ms, dense_bound_by=dense_by,
                    max_abs_err=float((got - twin).abs().max()),
                    launches_per_solve=stats["launches"])
        if on_card:
            x = torch.zeros(n, 1, device=dev)
            x[s] = 1.0
            line.update(
                ms=time_launch(lambda: qd.delta_stepping(tgt, wts, s, d, delta)),
                plain_ms=plain_ms,
                # a yardstick, not the same function: one pass as a
                # weighted sparse product with the frontier column
                library_ms=time_launch(lambda: torch.sparse.mm(adj_w, x)))
            line["over_bound"] = line["ms"] / b_ms
            line["over_dense_bound"] = line["ms"] / dense_ms
            if us_per_pass is not None:
                line["barrier_floor_ms"] = us_per_pass * info["passes"] / 1e3
            step_line("delta_stepping", geometry, f"{s}->{d}", line["ms"],
                      width=width, **{k: v for k, v in line.items()
                                      if k != "ms"})
    del tgt, wts, adj_w
    return line


def restricted_check(geometry: str, n: int, csr, s: int, d: int, dev,
                     on_card: bool, tail_every: int = 1) -> dict:
    """``restricted_sweep_kernel`` against its plain twin on Yen's first
    iteration from ``s`` to ``d``: the planes equal entry for entry, the
    levels equal, the batched tails the host solver's (every
    ``tail_every``-th candidate: each is a host BFS); one ``step``
    line."""
    from bibfs_tpu_torch.query.kshortest import _spur_batch_host, descend_min_id

    rp, ci = csr
    cands = yen_first_cands(n, csr, s, d)
    b = qd._pad_candidates(len(cands))
    seeds = qd.candidate_seeds(n, rp, ci, cands)
    seed, blocked = qd.seed_planes(seeds, n, b, dev)
    entries = qd.seed_entries(seeds, dev)
    rpd, cid = md.upload_csr(rp, ci, dev)
    got = seed.clone()
    before = qd.restricted_sweep.launches
    st = qd.restricted_sweep(rpd, cid, got, blocked, d, seeds=entries)
    check(qd.restricted_sweep.launches - before == int(on_card),
          f"restricted_sweep {geometry}: "
          f"{qd.restricted_sweep.launches - before} launches an iteration")
    twin = seed.clone()
    st2, plain_ms = timed_once(lambda: qd.restricted_sweep_plain(
        rpd, cid, twin, blocked, d), on_card)
    check(torch.equal(got, twin),
          f"restricted_sweep {geometry} {s}->{d}: kernel != twin")
    check((st["levels"], st["run"]) == (st2["levels"], st2["run"]),
          f"restricted_sweep {geometry}: levels {st} / twin {st2}")
    plane = got[:, : len(cands)].cpu().numpy()
    some = list(range(0, len(cands), tail_every))
    tails = []
    for j in some:
        spur, _bn, be = cands[j]
        col = np.where(plane[:, j] >= qd.INF32, -1, plane[:, j])
        tails.append(descend_min_id(rp, ci, col, spur, d, banned_edges=be))
    check(tails == _spur_batch_host(n, rp, ci, d, [cands[j] for j in some]),
          f"restricted_sweep {geometry} {s}->{d}: tails != host")
    by_level = md.frontier_bytes(
        rp, ci, np.where(plane >= qd.INF32, -1, plane).astype(np.int16))
    b_ms = frontier_ms(int(by_level.sum()))
    line = dict(candidates=len(cands), padded=b, levels=st["levels"],
                run=st["run"], dense_levels=st.get("dense_levels"),
                sparse_levels=st.get("sparse_levels"),
                solo_levels=st.get("solo_levels"),
                grid_levels=st.get("grid_levels"),
                solo_cap=qd.sweep_solo_cap(md.lanes_per_vertex(n, len(ci))),
                bound_ms=b_ms, bound_by="bytes",
                max_abs_err=int((got.long() - twin.long()).abs().max()),
                launches_per_iteration=1)
    if on_card:
        work = seed.clone()
        line.update(
            ms=time_launch(lambda: qd.restricted_sweep(
                rpd, cid, work, blocked, d, seeds=entries),
                lambda: work.copy_(seed)),
            plain_ms=plain_ms)
        adj = torch.sparse_csr_tensor(
            rpd, cid.to(torch.int64), torch.ones(cid.numel(), device=dev),
            size=(n, n))
        plane01 = (seed[:, : len(cands)] == 1).float()
        # a yardstick: one level as a sparse product with the 0/1 plane
        line["library_ms"] = time_launch(lambda: torch.sparse.mm(adj, plane01))
        line["over_bound"] = line["ms"] / b_ms
        step_line("restricted_sweep", geometry, f"{s}->{d}", line["ms"],
                  **{k: v for k, v in line.items() if k != "ms"})
    return line


def solve_query_check(n: int, pairs, csr, lv, dev, on_card: bool) -> dict:
    """``solve_query`` on ``dev`` (the card is its default and the CLI's)
    for one query of each device kind on the grid, against its host tier
    (``device="cpu"``): the multi-source and k-shortest answers equal, the
    weighted pair the reference's numbers (or, cut small, the host's
    distance) over a valid path of that weight. Prints one line and
    returns it: each kind's ms and the kernels' launches."""
    import dataclasses

    from bibfs_tpu_torch.query import KShortest, MultiSource, Weighted
    from bibfs_tpu_torch.query.weighted import path_weight, synthetic_weights
    from bibfs_tpu_torch.solvers.api import solve_query

    near = int(np.flatnonzero(lv == min(10, int(lv.max())))[0])
    srcs = tuple(int(x) for x in np.flatnonzero(lv == int(lv.max()) // 2)[:8])
    wq = GRID_PAIR if n > GRID_PAIR[1] else (0, n - 1)
    line: dict = {"phase": "solve_query", "geometry": "grid-500x500"}

    def fields(res):
        out = dataclasses.asdict(res)
        out.pop("time_s")
        return out

    before = counts()
    for kind, q in (("msbfs", MultiSource(srcs, near)),
                    ("kshortest", KShortest(0, near, k=3)),
                    ("weighted", Weighted(*wq))):
        t0 = time.perf_counter()
        got = solve_query(n, pairs, q, device=dev)
        line[f"{kind}_ms"] = (time.perf_counter() - t0) * 1e3
        if kind != "weighted":
            want = solve_query(n, pairs, q, device="cpu")
            check(fields(got) == fields(want),
                  f"solve_query {kind}: device tier != host tier")
            continue
        w = synthetic_weights(*csr, 0)
        check(got.found and path_weight(*csr, w, got.path) == got.dist
              and validate_path(csr, got.path, *wq, hops=got.hops),
              f"solve_query weighted {wq}: bad path")
        if wq == GRID_PAIR:
            got_want = {"dist": got.dist, "hops": got.hops,
                        "buckets": got.buckets,
                        "relaxations": got.relaxations}
            check(got_want == GRID_WANT,
                  f"solve_query weighted: {got_want} != {GRID_WANT}")
        else:
            want = solve_query(n, pairs, q, device="cpu")
            check(got.dist == want.dist, "solve_query weighted: distance")
    after = counts()
    line["launches"] = {k: after[k] - before[k] for k in QUERY_KERNELS}
    line["launches"]["msbfs_sweep"] = (after["msbfs_sweep"]
                                       - before["msbfs_sweep"])
    if on_card:
        for name, got in line["launches"].items():
            check(got > 0, f"solve_query launched no {name}")
    print(json.dumps(line), flush=True)
    return line


def timed_once(fn, on_card: bool):
    """``fn()`` and its ms between two CUDA events (None off the card): a
    plain twin's time from its one checked run (the slowest twins take
    seconds a run)."""
    if not on_card:
        return fn(), None
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def percentiles_ms(lats) -> dict:
    a = np.asarray(lats, dtype=np.float64) * 1e3
    return {f"p{p}": float(np.percentile(a, p)) for p in (50, 95, 99)}


def kind_truth(prep, name: str, queries) -> dict:
    """What every answer must be: ``(found, hops)`` of point-to-point and
    as-of queries and of each source of a multi-source query by the native
    host solver on the version asked; the host kind rung's weighted and
    k-shortest answers from the reference workers."""
    gr = prep["graphs"][name]
    n = gr["n"]
    want_pairs: dict = {1: [], 2: []}
    for q in queries:
        if q.kind == "pt":
            want_pairs[2].append((q.src, q.dst))
        elif q.kind == "asof":
            want_pairs[int(q.version)].append((q.inner.src, q.inner.dst))
        elif q.kind == "msbfs":
            want_pairs[2].extend((s, q.dst) for s in q.sources)
    hops: dict = {}
    for v, pairs in want_pairs.items():
        if not pairs:
            continue
        pairs = list(dict.fromkeys(pairs))
        ps = gr["pairs"] if v == 1 else gr["pairs2"]
        csr = gr["csr"] if v == 1 else gr["csr2"]
        trivial = [p for p in pairs if p[0] == p[1]]
        pairs = [p for p in pairs if p[0] != p[1]]
        got = native_hops(n, ps, pairs, csr) if pairs else []
        hops.update({(v, p): h for p, h in zip(pairs, got)})
        hops.update({(v, p): (True, 0) for p in trivial})
    return hops


def check_kind_answers(prep, name: str, queries, results, hops, wave: str):
    """Every answer equal to the truth of :func:`kind_truth` (weighted:
    the same distance and a path of that weight; k-shortest: the host
    rung's path lists; multi-source: ``per_source`` and ``best``)."""
    from bibfs_tpu_torch.query.weighted import path_weight, synthetic_weights

    gr = prep["graphs"][name]
    weights: dict = {}
    for q, r in zip(queries, results):
        check(not isinstance(r, BaseException), f"{wave}: {q} failed: {r}")
        if q.kind in ("pt", "asof"):
            v, p = (2, q) if q.kind == "pt" else (int(q.version), q.inner)
            want = hops[(v, (p.src, p.dst))]
            check((r.found, r.hops) == want, f"{wave}: {q} {r.hops} != {want}")
            if r.found:
                csr = gr["csr"] if v == 1 else gr["csr2"]
                check(validate_path(csr, r.path, p.src, p.dst, hops=r.hops),
                      f"{wave}: {q} invalid path")
        elif q.kind == "msbfs":
            per = tuple(hops[(2, (s, q.dst))] for s in q.sources)
            per = tuple(h if f else None for f, h in per)
            check(r.per_source == per, f"{wave}: {q} per_source")
            best = min((i for i, h in enumerate(per) if h is not None),
                       key=lambda i: per[i], default=None)
            check(r.best == best, f"{wave}: {q} best {r.best} != {best}")
            if r.found:
                check(validate_path(gr["csr2"], r.path, q.sources[best], q.dst,
                                    hops=r.hops), f"{wave}: {q} invalid path")
        else:
            want = prep["refs"][(name, q.cache_key())].result()[0]
            if q.kind == "weighted":
                check((r.found, r.dist) == want, f"{wave}: {q} {r.dist} != {want}")
                if r.found:
                    rp, ci = gr["csr2"]
                    seed = int(q.weight_seed)
                    if seed not in weights:
                        weights[seed] = synthetic_weights(rp, ci, seed)
                    check(path_weight(rp, ci, weights[seed], r.path) == r.dist,
                          f"{wave}: {q} path weight")
            else:
                check((r.found, r.paths) == want, f"{wave}: {q} paths")


def kind_wave(eng, queries, wave: str, graph: str, waves: int = 1) -> tuple:
    """Serve ``queries`` through ``eng`` in ``waves`` calls of
    ``query_many``; returns the results and the line it prints."""
    before = eng.stats()["query_kinds"]
    lats: list = []
    res: list = []
    tracer = Tracer()
    prev = set_tracer(tracer)
    t0 = time.perf_counter()
    size = -(-len(queries) // waves)
    try:
        for i in range(0, len(queries), size):
            t1 = time.perf_counter()
            if isinstance(eng, PipelinedQueryEngine):
                tickets = [eng.submit_query(q) for q in queries[i:i + size]]
                res += [t.wait(timeout=600) for t in tickets]
                lats += [t.t_done - t.t_submit for t in tickets]
            else:
                got = eng.query_many(queries[i:i + size], return_errors=True)
                res += got
                lats += [time.perf_counter() - t1] * len(got)
    finally:
        wall = time.perf_counter() - t0
        set_tracer(prev)
    st = eng.stats()
    routes = {k: {r: c - before.get(k, {}).get(r, 0) for r, c in v.items()
                  if c - before.get(k, {}).get(r, 0)}
              for k, v in st["query_kinds"].items()}
    kinds: dict = {}
    for q in queries:
        kinds[q.kind] = kinds.get(q.kind, 0) + 1
    line = {"phase": "query_kinds", "wave": wave, "graph": graph,
            "queries": len(queries), "kinds": kinds,
            "routes": {k: v for k, v in routes.items() if v},
            "kind_cache": st["kind_cache"], "wall_ms": wall * 1e3,
            "queries_per_s": len(queries) / wall,
            "latency_ms": percentiles_ms(lats),
            "spans_ms": span_ms(tracer),
            "fallbacks": {k: v for k, v in
                          st["resilience"]["fallbacks"].items() if v}}
    if isinstance(eng, PipelinedQueryEngine):  # one wave per engine
        line.update(flushes={k: st["pipeline"][k] for k in (
            "flushes", "depth_flushes", "deadline_flushes", "drain_flushes")},
            overlap=st["overlap"])
    print(json.dumps(line), flush=True)
    return res, line


def query_kinds_phase(prep, dev_name: str = "cuda",
                      results: dict | None = None) -> dict:
    """Phase 13 (module docstring) from :func:`kind_prep`'s inputs; on
    ``dev_name="cpu"`` (a rehearsal at a small size) the engines' device
    rungs are forced and nothing is timed. Returns the kernels' launches
    in the serving waves."""
    import shutil

    dev = torch.device(dev_name)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    gnp, grid = prep["graphs"]["gnp"], prep["graphs"]["grid"]
    # 1. the kernels against their twins, on the graphs' first versions
    t0 = time.perf_counter()
    rng = np.random.default_rng(KIND_SEEDS["pairs"])
    linked = np.flatnonzero(np.diff(gnp["csr"][0]) > 0)
    gpairs = [tuple(int(x) for x in rng.choice(linked, 2, replace=False))
              for _ in range(4)]
    gn = grid["n"]
    grid_pair = GRID_PAIR if gn > GRID_PAIR[1] else (0, gn - 1)
    us_per_pass = delta_floor(gn, dev) if on_card else None
    delta_check("gnp-deg8-s20", gnp["n"], gnp["pairs"], gnp["csr"], gpairs,
                dev, on_card)
    line = delta_check("grid-500x500", gn, grid["pairs"], grid["csr"],
                       [grid_pair], dev, on_card,
                       want=GRID_WANT if grid_pair == GRID_PAIR else None,
                       us_per_pass=us_per_pass)
    rline = restricted_check("gnp-deg8-s20", gnp["n"], gnp["csr"], *gpairs[0],
                             dev, on_card)
    lv = multi_source_bfs(gn, *grid["csr"], np.array([0]))[:, 0]
    far = np.flatnonzero(lv == min(GRID_HOPS, int(lv.max())))
    gline = restricted_check("grid-500x500", gn, grid["csr"], 0, int(far[0]),
                             dev, on_card, tail_every=10)
    solve_query_check(gn, grid["pairs"], grid["csr"], lv, dev, on_card)
    if results is not None and on_card:
        results["delta_stepping"] = {
            k: line[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "dense_bound_ms", "barrier_floor_ms",
                                 "library_ms", "max_abs_err", "passes",
                                 "solo_passes", "grid_passes", "solo_cap",
                                 "launches_per_solve")}
        results["restricted_sweep"] = {
            **{k: gline[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "max_abs_err", "candidates",
                                     "levels", "dense_levels", "solo_levels",
                                     "grid_levels", "solo_cap",
                                     "launches_per_iteration")},
            "gnp_ms": rline["ms"], "gnp_plain_ms": rline["plain_ms"],
            "gnp_bound_ms": rline["bound_ms"]}
    kernels_s = time.perf_counter() - t0
    torch.cuda.empty_cache() if on_card else None

    # 2. serving: a durable store holding both graphs, one batch acked and
    # compacted on each (versions 1 and 2)
    t0 = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".chip_durable")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=root)
    store = GraphStore(wal_dir=tmp, retain_history=True, device=dev_name)
    engines: list = []
    try:
        store.add("gnp", gnp["n"], pairs=gnp["pairs"])
        store.add("grid", gn, pairs=grid["pairs"])
        for name, gr in (("gnp", gnp), ("grid", grid)):
            store.update(name, *gr["batch"])
            store.compact(name)
            check([e["version"] for e in store.history(name)] == [1, 2],
                  f"query kinds: {name} history {store.history(name)}")
            got = store.current(name).csr()
            check(all(np.array_equal(a, b) for a, b in zip(got, gr["csr2"])),
                  f"query kinds: {name} version 2 differs from its batch")
        store_s = time.perf_counter() - t0
        force = not on_card

        def engine(cls, graph, **kw):
            eng = cls(store=store, graph=graph, device=dev_name,
                      **({"device_batches": True} if force else {}), **kw)
            if force:  # the CPU's calibrated crossovers keep them off
                eng.routes["msbfs_device"].min_sources = 1
                eng.routes["weighted_device"].min_batch = 1
                eng.routes["kshortest_device"].min_k = 2
            engines.append(eng)
            return eng

        t0 = time.perf_counter()
        truth = kind_truth(prep, "gnp", [q for w in KIND_QUERIES
                                         for q in prep["queries"][w]])
        gtruth = kind_truth(prep, "grid", prep["queries"]["grid"])
        truth_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for fut in prep["refs"].values():
            fut.result()
        refs_wait_s = time.perf_counter() - t0
        reset_counts()
        sync = engine(QueryEngine, "gnp")
        qs = prep["queries"]["sync"]
        res, sline = kind_wave(sync, qs, "K[sync]", "gnp-deg8-s20",
                               waves=len(qs) // KIND_WAVE)
        check_kind_answers(prep, "gnp", qs, res, truth, "K[sync]")
        pipe = engine(PipelinedQueryEngine, "gnp")
        qs = prep["queries"]["pipelined"]
        res, pline = kind_wave(pipe, qs, "K[pipelined]", "gnp-deg8-s20")
        check_kind_answers(prep, "gnp", qs, res, truth, "K[pipelined]")
        gsync = engine(QueryEngine, "grid")
        qs = prep["queries"]["grid"]
        gres, gwline = kind_wave(gsync, qs, "K[grid]", "grid-500x500")
        check_kind_answers(prep, "grid", qs, gres, gtruth, "K[grid]")
        launches = counts()
        print(json.dumps({"phase": "query_kinds_launches", **launches}),
              flush=True)
        for eng, wave in ((sync, "K[sync]"), (pipe, "K[pipelined]"),
                          (gsync, "K[grid]")):
            engine_clean(eng, wave)
        served = {}
        for eng in (sync, pipe, gsync):
            for kind, routes in eng.stats()["query_kinds"].items():
                for route, c in routes.items():
                    served[(kind, route)] = served.get((kind, route), 0) + c
        for kind in ("msbfs", "weighted", "kshortest"):
            check(served.get((kind, f"{kind}_device"), 0) > 0,
                  f"query kinds: no {kind} query on {kind}_device")
        total = sum(c for (k, r), c in served.items() if k != "pt")
        typed = sum(1 for w in KIND_QUERIES for q in prep["queries"][w]
                    if q.kind != "pt") + len(prep["queries"]["grid"])
        check(total == typed, f"query kinds: {total} of {typed} typed "
              "queries resolved")
        if on_card:
            for name in ("msbfs_sweep", "delta_stepping", "restricted_sweep"):
                check(launches[name] > 0,
                      f"kernel {name} was not launched by the query kinds")
        # the weighted device rung faulted: the host rung answers
        qs = [q for q in prep["queries"]["grid"]
              if q.kind == "weighted"][:GRID_FAULTED]
        os.environ["BIBFS_FAULTS"] = "weighted_device:p=1"
        try:
            faulted = engine(QueryEngine, "grid")
        finally:
            del os.environ["BIBFS_FAULTS"]
        check(faulted._faults is not None, "the fault plan was not read")
        fres, fline = kind_wave(faulted, qs, "K[grid, weighted_device "
                                "faulted]", "grid-500x500")
        check_kind_answers(prep, "grid", qs, fres, gtruth, "K[faulted]")
        dev_res = [r for q, r in zip(prep["queries"]["grid"], gres)
                   if q.kind == "weighted"][:GRID_FAULTED]
        check([r.dist for r in fres] == [r.dist for r in dev_res],
              "faulted wave: host rung != device rung")
        fst = faulted.stats()
        check(fst["resilience"]["fallbacks"].get("weighted_device->weighted",
                                                  0) >= 1,
              "faulted wave: no weighted_device->weighted fallback counted")
        check(fst["query_kinds"].get("weighted") == {"weighted": len(qs)},
              f"faulted wave: {fst['query_kinds']}")
        line = {"phase": "query_kinds_total", "kernels_s": kernels_s,
                "store_s": store_s, "truth_s": truth_s,
                "refs_wait_s": refs_wait_s, **refs_report(prep),
                "s": time.perf_counter() - t_phase}
        print(json.dumps(line), flush=True)
        return launches
    finally:
        for eng in engines:
            eng.close()
        store.close()
        prep["pool"].shutdown(cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)


# ---- phase 14: the vertex-sharded search and the data-parallel batch ------
SHARD_RANKS = 4
# the kernels of the sharded path, each held to its twin at a shard's
# geometry (local rows, global ids, a nonzero row offset)
SHARD_KERNELS = ("fused_dual_round", "pull_dual", "pull_single")
SHARD_RMAT_MODES = ("sync", "beamer")
SHARD_TIMED = 1  # pairs a mode timed on the ranks, 5 searches each
# modes whose gnp search is profiled on every rank (where a round's time
# goes: the card busy or waiting, the collectives' kernels and calls)
SHARD_PROFILED = ("fused", "sync")
DP_QUERIES = 512  # the data-parallel minor8 batch: 128 queries a rank


def shard_kernel_phase(host, n: int, geometry: str, rank: int, seed: int,
                       results: dict | None, names=SHARD_KERNELS) -> None:
    """Kernels 1, 3 and 4 at rank ``rank``'s shard of ``SHARD_RANKS``:
    the local rows of the host graph on this card (their slots global
    ids, the dead ones at the sentinel ``n_pad``), a seeded mid-search
    state with the global frontier, ``row_offset = rank * n_loc``; each
    exactly against its twin, one ``step`` line with its ms, the twin's
    and the bytes bound, into ``results[name]["sharded"]`` when given."""
    dev = torch.device("cuda")
    n_pad = host.n_pad
    n_loc = n_pad // SHARD_RANKS
    off = rank * n_loc
    cu = lambda a: torch.as_tensor(np.array(a)).to(dev)  # noqa: E731
    nbr_t, deg = fl.prepare_fused_tables(cu(host.nbr[off:off + n_loc]),
                                         cu(host.deg[off:off + n_loc]),
                                         id_space=n_pad)
    rng = np.random.default_rng(seed)
    ds, frs, ps = mid_search(rng, n, n_pad, 2)
    dt, frt, pt = mid_search(rng, n, n_pad, 3)
    fr_s, fr_t = cu(frs), cu(frt)
    loc = slice(off, off + n_loc)
    base = dict(dist_s=cu(ds[loc]), dist_t=cu(dt[loc]), par_s=cu(ps[loc]),
                par_t=cu(pt[loc]))
    vis_s, vis_t = base["dist_s"] < INF32, base["dist_t"] < INF32
    dual = pack_dual(fr_s, fr_t).contiguous()
    words_in = 4 * ((n_pad + 31) // 32)  # a global bitmap, per side
    words_out = 4 * ((n_loc + 31) // 32)  # the next one, the local rows
    want_s = (~vis_s).to(torch.uint8)
    want_t = (~vis_t).to(torch.uint8)
    geom = f"{geometry}/shard{rank}of{SHARD_RANKS}"
    meta = dict(n_loc=n_loc, id_space=n_pad, row_offset=off)
    kw = dict(id_space=n_pad)
    pulls = {
        "pull_single": ((nbr_t, deg, bm.pack_bits(fr_s, bm.frontier_words(n_pad)),
                         vis_s), want_s, 1),
        "pull_dual": ((nbr_t, deg, pe.pack_front(fr_s, fr_t, n_pad), vis_s,
                       vis_t), want_s | (want_t << 1), 2),
    }
    for name, (args, want, k) in pulls.items():
        if name not in names:
            continue
        wrapper, plain = KERNELS[name][:2]
        ref = plain(*args, **kw)
        got = wrapper(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        check(err == 0, f"{name} at {geom} differs from its plain version")
        sl = slots_needed(nbr_t, n_loc, dual, want)
        nbytes = k * (words_in + words_out + 6 * n_loc) + 4 * sl
        b, by = bound_ms(nbytes, 4 * sl)
        ms = time_launch(lambda: wrapper(*args, **kw))
        pms = time_launch(lambda: plain(*args, **kw), reps=5)
        step_line(name, geom, "shard", ms, bound_ms=b, plain_ms=pms, **meta)
        if results is not None:
            results[name]["sharded"] = dict(geometry=geom, max_abs_err=err,
                                            ms=ms, plain_ms=pms, bound_ms=b,
                                            bound_by=by, **meta)
    if "fused_dual_round" not in names:
        return
    st0 = torch.tensor([2, 3, INF32, -1, int(frs.sum()), int(frt.sum()),
                        0, 0, 5, 7, 9, 11], dtype=torch.int32)

    def fresh():
        acc, key = fl.new_scratch(dev)
        return dict(bits=fl._bits_of_row(dual, 2, 3, n_pad),
                    **{k: v.clone() for k, v in base.items()},
                    state=st0.to(dev), acc=acc, key=key)

    def run(fn, b):
        fn(nbr_t, deg, b["bits"], b["dist_s"], b["dist_t"], b["par_s"],
           b["par_t"], b["state"], b["acc"], b["key"], id_space=n_pad,
           row_offset=off)

    wrapper, plain = KERNELS["fused_dual_round"][:2]
    p, kk = fresh(), fresh()
    run(plain, p)
    run(wrapper, kk)
    torch.cuda.synchronize()
    outs = ("bits", "dist_s", "dist_t", "par_s", "par_t", "acc", "key")
    err = max_abs_err([kk[o] for o in outs], [p[o] for o in outs])
    check(err == 0, f"fused_dual_round at {geom} differs from its plain version")
    sl = slots_needed(nbr_t, n_loc, dual, want_s | (want_t << 1))
    new = [int((kk[d] != base[d]).sum()) for d in ("dist_s", "dist_t")]
    nbytes = 8 * n_loc + 2 * (words_in + words_out) + 4 * sl + 12 * sum(new)
    b, by = bound_ms(nbytes, 4 * sl)
    work = fresh()

    def prep(w=work):
        for key in base:
            w[key].copy_(base[key])
        w["state"].copy_(st0)
        w["acc"].zero_()
        w["key"].fill_(fl.NO_MEET)

    ms = time_launch(lambda: run(wrapper, work), prep)
    pms = time_launch(lambda: run(plain, work), prep, reps=5)
    step_line("fused_dual_round", geom, "shard", ms, bound_ms=b, plain_ms=pms,
              **meta)
    if results is not None:
        results["fused_dual_round"]["sharded"] = dict(
            geometry=geom, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
            bound_by=by, **meta)


def shard_reference(graph: dict, modes, dev, dp_pairs=None) -> dict:
    """The one-device dense search's raw outputs of every (mode, pair) of
    ``graph`` on this process's device (parent rows as digests of their
    first ``n`` entries), its median ms over the first ``SHARD_TIMED``
    pairs of each mode (5 searches each), and the one-device ``minor8``
    batch of ``dp_pairs`` with its median ms (3 batches)."""
    host, n = graph["host"], graph["n"]
    g = (dense.DeviceGraph.from_tiered(host, dev) if graph["tiered"]
         else dense.DeviceGraph.from_ell(host, dev))
    ref = {}
    for mode in modes:
        for s, d in graph["pairs"]:
            o = raw(g, s, d, mode)
            ref[mode, s, d] = (int(o[0]), int(o[1]), row_digest(o[2], n),
                               row_digest(o[3], n), int(o[4]), int(o[5]))
        ref["ms", mode] = float(np.median([
            dense.time_search(g, s, d, repeats=5, mode=mode)[1].time_s
            for s, d in graph["pairs"][:SHARD_TIMED]])) * 1e3
    if dp_pairs is not None:
        times, res = dense.time_batch_graph(g, dp_pairs, repeats=3,
                                            mode="minor8")
        ref["dp"] = [fields(r) for r in res]
        ref["dp_ms"] = float(np.median(times)) * 1e3
    del g
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ref


def row_digest(row, n: int) -> str:
    import hashlib

    a = row.cpu().numpy() if isinstance(row, torch.Tensor) else np.asarray(row)
    return hashlib.sha256(np.ascontiguousarray(a[:n]).tobytes()).hexdigest()


def shard_phase(gnp: dict, rmat: dict, results: dict | None,
                dev_name: str = "cuda", save_dir: str | None = None) -> dict:
    """Phase 14 (module docstring). ``gnp`` and ``rmat`` are dicts of the
    host graph (``host``), its ``name``, ``n``, the CSR (``csr``), the
    seeded pairs and their oracle answers (``want``) and ``tiered``; ``dev_name="cpu"``
    rehearses the phase on gloo ranks (no kernel is launched or timed).
    Returns the rank launches of the phase's path, summed over the
    ranks. ``save_dir`` keeps the saved host graphs there (``gnp``,
    ``rmat``) for phase 15."""
    from bibfs_tpu_torch.parallel.collectives import frontier_exchange_bytes
    from bibfs_tpu_torch.parallel.mesh import launch
    from bibfs_tpu_torch.solvers import sharded as sh

    t_phase = time.perf_counter()
    dev = torch.device(dev_name)
    on_card = dev.type == "cuda"
    if on_card:
        t0 = time.perf_counter()
        shard_kernel_phase(gnp["host"], gnp["n"], gnp["name"], 1, 81,
                           results)
        shard_kernel_phase(rmat["host"], rmat["n"], rmat["name"], 3, 82,
                           None, names=("pull_dual", "pull_single"))
        print(json.dumps({"phase": "sharded_kernels_vs_plain", "ok": True,
                          "s": time.perf_counter() - t0}), flush=True)
    modes = tuple(sh.SHARDED_MODES)
    dp_pairs = batch_pairs(np.random.default_rng(91), gnp["n"], gnp["csr"],
                           DP_QUERIES)
    t0 = time.perf_counter()
    ref = {"gnp": shard_reference(gnp, modes, dev, dp_pairs),
           "rmat": shard_reference(rmat, SHARD_RMAT_MODES, dev)}
    ref_s = time.perf_counter() - t0
    jobs, keys = [], []
    for name, graph, gmodes in (("gnp", gnp, modes),
                                ("rmat", rmat, SHARD_RMAT_MODES)):
        jobs.append(dict(kind="exchange", graph=name))
        keys.append(("exchange", name))
        for mode in gmodes:
            for s, d in graph["pairs"]:
                jobs.append(dict(kind="solve", graph=name, src=s, dst=d,
                                 mode=mode, raw="digest"))
                keys.append(("solve", name, mode, s, d))
            for s, d in graph["pairs"][:SHARD_TIMED]:
                jobs.append(dict(kind="solve", graph=name, src=s, dst=d,
                                 mode=mode, repeats=5))
                keys.append(("timed", name, mode, s, d))
    for mode in SHARD_PROFILED:
        s, d = gnp["pairs"][0]
        jobs.append(dict(kind="profile", graph="gnp", src=s, dst=d,
                         mode=mode, repeats=5))
        keys.append(("profile", mode))
    jobs.append(dict(kind="dp", graph="gnp", pairs=dp_pairs, dt8=True,
                     repeats=3))
    keys.append(("dp",))
    with tempfile.TemporaryDirectory(prefix="chip-shard-") as scratch:
        tmp = save_dir or scratch
        t0 = time.perf_counter()
        paths = {name: sh.save_host_graph(graph["host"], os.path.join(tmp, name))
                 for name, graph in (("gnp", gnp), ("rmat", rmat))}
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = launch(sh.sharded_jobs, SHARD_RANKS, paths, jobs,
                     device=dev.type, timeout_s=900)
        ranks_s = time.perf_counter() - t0
    got = dict(zip(keys, out["results"]))
    transport = out["transport"]
    want_transport = ("nccl" if on_card and torch.cuda.device_count()
                      >= SHARD_RANKS else "gloo-staged" if on_card else "gloo")
    check(transport == want_transport,
          f"sharded: transport {transport}, expected {want_transport}")
    answers = []
    for name, graph, gmodes in (("gnp", gnp, modes),
                                ("rmat", rmat, SHARD_RMAT_MODES)):
        ex = got["exchange", name]
        print(json.dumps({"phase": "sharded_exchange",
                          "geometry": graph["name"],
                          "transport": transport, "ranks": SHARD_RANKS,
                          "bytes_packed_per_side": frontier_exchange_bytes(
                              ex["n_loc"]),
                          "bytes_bool_per_side": ex["n_loc"],
                          **{k: ex[k] for k in ("n_loc", "bytes_packed",
                                                "bytes_bool", "gather_ms",
                                                "reduce_ms")},
                          "peer_access": [r["peer_access"]
                                          for r in out["ranks"]]}),
              flush=True)
        for mode in gmodes:
            ran = sh.resolve_sharded_mode(mode, (1,) if graph["tiered"] else ())
            times, syncs = [], []
            for (s, d), w in zip(graph["pairs"], graph["want"]):
                o = got["solve", name, mode, s, d]
                res = o[7]
                check(o[0] == ran, f"sharded {name} {mode}: ran {o[0]}")
                check(res.found == w.found and res.hops == w.hops,
                      f"sharded {name} {mode} {s}->{d}: hops {res.hops} != "
                      f"oracle {w.hops}")
                if res.found:
                    check(validate_path(graph["csr"], res.path, s, d,
                                        hops=res.hops),
                          f"sharded {name} {mode} {s}->{d}: invalid path")
                r = ref[name][mode, s, d]
                for i, field in enumerate(sh.RAW_FIELDS):
                    check(o[1 + i] == r[i],
                          f"sharded {name} {mode} {s}->{d}: {field} "
                          "differs from the dense search")
                answers.append([name, mode, s, d, *o[:7], res.path])
            for s, d in graph["pairs"][:SHARD_TIMED]:
                t = got["timed", name, mode, s, d]
                check(t.hops == got["solve", name, mode, s, d][7].hops,
                      f"sharded {name} {mode}: timed answer differs")
                times.append(t.time_s)
                syncs.append(t.host_syncs)
            print(json.dumps({"phase": "sharded_solve",
                              "geometry": graph["name"],
                              "mode": mode, "ran": ran,
                              "transport": transport,
                              "median_search_ms": float(np.median(times)) * 1e3,
                              "dense_median_search_ms": ref[name]["ms", mode],
                              "host_syncs_per_solve": float(np.mean(syncs))}),
                  flush=True)
    for mode in SHARD_PROFILED:
        ranks = got["profile", mode]
        print(json.dumps({"phase": "sharded_profile", "geometry": gnp["name"],
                          "mode": mode, "transport": transport,
                          "ranks": ranks}), flush=True)
    dp = got["dp",]
    check([fields(r) for r in dp] == ref["gnp"]["dp"],
          "data-parallel minor8 batch differs from the one-device batch")
    check({r.mode for r in dp} == {"minor8"}, "data-parallel batch mode")
    answers.append(["dp", [fields(r) for r in dp]])
    print(json.dumps({"phase": "sharded_dp_batch", "geometry": gnp["name"],
                      "queries": len(dp_pairs),
                      "lanes_per_rank": bmin.pad_batch(
                          -(-len(dp_pairs) // SHARD_RANKS)),
                      "batch_ms": dp[0].time_s * 1e3,
                      "one_device_batch_ms": ref["gnp"]["dp_ms"],
                      "transport": transport}), flush=True)
    launches: dict = {}
    for job_counts in out["launches"]:
        for k, v in job_counts.items():
            launches[k] = launches.get(k, 0) + v
    print(json.dumps({"phase": "sharded_launches", **launches}), flush=True)
    if on_card:
        for k in (*SHARD_KERNELS, "fold_round", "minor_level[minor8]"):
            check(launches.get(k, 0) > 0,
                  f"kernel {k} was not launched on the sharded path")
    import hashlib

    digest = hashlib.sha256(json.dumps(answers, default=str).encode()
                            ).hexdigest()
    print(json.dumps({"phase": "sharded_total", "transport": transport,
                      "ranks": SHARD_RANKS, "answers": len(answers),
                      "digest": digest, "reference_s": ref_s,
                      "save_s": save_s, "ranks_s": ranks_s,
                      "s": time.perf_counter() - t_phase}), flush=True)
    return launches


def shard_graphs(with_rmat: bool = True) -> tuple[dict, dict | None]:
    """Phase 14's two graphs built on the host alone (for running the
    phase by itself, :func:`shard_main`): gnp-deg8-s20 and rmat-s20-ef16
    (None without ``with_rmat``), with the pairs and oracle answers of
    phases 3 and 4. rmat-s20 is built by :func:`rmat_prep`'s child beside
    gnp's build; its dict keeps the directory the child saved it in
    (``dir``), which its mapped host graph reads."""
    if with_rmat:
        rmat_dir = tempfile.TemporaryDirectory()
        proc = multiprocessing.get_context("spawn").Process(
            target=rmat_prep, args=(rmat_dir.name,), daemon=True)
        proc.start()
    n = 1 << 20
    edges = gnp_random_graph(n, 8 / n, seed=7)
    p = canonical_pairs(n, edges)
    csr = build_csr(n, pairs=p)
    pairs = seeded_pairs(np.random.default_rng(7), np.arange(n), 8)
    gnp = dict(host=build_ell(n, pairs=p), name="gnp-deg8-s20", n=n,
               csr=csr, pairs=pairs, want=oracle(n, csr, pairs), tiered=False,
               edges=edges, pairs_all=p)
    if not with_rmat:
        return gnp, None
    n2, _edges, csr2, host2, _build_s, _wait_s = rmat_load(proc,
                                                           rmat_dir.name)
    linked = np.flatnonzero(np.diff(csr2[0]) > 0)
    pairs2 = seeded_pairs(np.random.default_rng(7), linked, 8)
    rmat = dict(host=host2, name="rmat-s20-ef16", n=n2, csr=csr2,
                pairs=pairs2, want=oracle(n2, csr2, pairs2), tiered=True,
                dir=rmat_dir)
    return gnp, rmat


# ---- phase 15: serving from a rank pool, the 2D search, checkpoints ------

MESH_DP = (512, 1024)  # the synchronous dp waves' batch (the pipelined: 1024)
MESH_SHARDED = (("fused", 16), ("pallas", 16), ("pallas_alt", 8))
MESH_REROUTE = 64  # a below-crossover wave
MESH_SWAP = 512  # the hot swap's pairs, served before and after the swap
MESH_SWAP_N = 1 << 17  # the swapped graph's vertices (gnp, degree 8)
MESH_SWAP_ADDS = 64  # of them joined by a new edge in the swapped snapshot
MESH_2D_TIMED = 2  # pairs a 2D mode timed, 3 searches each
MESH_KERNELS = ("fused_dual_round", "fold_round", "pull_dual", "pull_single",
                "minor_level[minor8]")


def mesh_rank_check(rj, key: str, seed: int) -> list:
    """Run on every rank of phase 15's pool (a ``call`` job): kernels 1, 3
    and 4 at this rank's shard of ``key`` (its rows, ``row_offset``), and
    minor_level over the rank's replica at each dp wave's slice
    (``MESH_DP[i] // SHARD_RANKS`` queries: both instantiations at the
    first, minor8, which the waves take, at the others), each exactly
    against its twin (a difference exits the rank, which fails the pool's
    wait) and timed. Returns every rank's step results."""
    host = rj.host(key)
    rank = rj.mesh.rank
    results = {name: {} for name in SHARD_KERNELS}
    shard_kernel_phase(host, host.n, "gnp-deg8-s20/pool", rank, seed + rank,
                       results)
    mine = {name: dict(results[name].get("sharded", {}), rank=rank)
            for name in SHARD_KERNELS}
    for i, b in enumerate(MESH_DP):
        got = minor_kernel_phase(
            rj.replica(key), f"gnp-deg8-s20/pool-rank{rank}",
            seed + 16 + 4 * i + rank, None, lanes=b // SHARD_RANKS,
            modes=None if i == 0 else ("minor8",))
        for name, r in got.items():
            mine.setdefault(name, []).append(dict(r, rank=rank))
        torch.cuda.empty_cache()
    return rj.mesh.all_gather_object(mine)


def fresh_pairs(rng, n: int, k: int) -> list:
    """``k`` seeded pairs with ``src != dst`` (none resolves inline)."""
    out = [(int(a), int(b)) for a, b in rng.integers(0, n, size=(2 * k, 2))
           if a != b]
    return out[:k]


def mesh_truth(n, edges, csr, pairs, results, wave: str) -> None:
    """Every answer's (found, hops) equals the native host solver's; 8
    paths ``validate_path`` accepts."""
    truth = native_hops(n, edges, pairs, csr)
    for (s, d), r, w in zip(pairs, results, truth):
        check((r.found, r.hops) == w,
              f"mesh wave {wave} {s}->{d}: {(r.found, r.hops)} != {w}")
    for i in np.random.default_rng(61).choice(len(pairs), min(8, len(pairs)),
                                              replace=False):
        (s, d), r = pairs[i], results[i]
        if r.found:
            check(validate_path(csr, r.path, s, d, hops=r.hops),
                  f"mesh wave {wave} {s}->{d}: invalid path")


def mesh_delta(eng, before: dict) -> dict:
    """The mesh route's counters since ``before`` (an earlier
    ``mesh_counters``)."""
    now = mesh_counters(eng)
    return {k: (now[k] - before[k] if isinstance(now[k], (int, float))
                else {kk: now[k][kk] - before[k][kk] for kk in now[k]})
            for k in now}


def mesh_counters(eng) -> dict:
    st = eng.stats()
    m = st["routes"]["mesh"]
    return dict(mesh_queries=st["mesh_queries"],
                device_queries=st["device_queries"],
                host_queries=st["host_queries"], batches=dict(m["batches"]),
                exchange=dict(m["exchange_bytes"]),
                reroutes=m["crossover_reroutes"])


def mesh_phase(gnp: dict, gnp_dir: str, dev_name: str = "cuda") -> dict:
    """Phase 15 (module docstring). ``gnp`` is phase 14's dict plus its
    edges (``edges``) and canonical pairs (``pairs_all``); ``gnp_dir`` the
    directory phase 14 saved its host graph in. ``dev_name="cpu"``
    rehearses the phase on gloo ranks at a small size (the dp crossover's
    graph floor lowered to the graph, no kernel launched or timed).
    Returns the ranks' launches and the kernel checks."""
    from bibfs_tpu_torch.parallel.collectives import frontier_exchange_bytes
    from bibfs_tpu_torch.parallel.pool import MeshPool
    from bibfs_tpu_torch.serve.routes import MeshConfig
    from bibfs_tpu_torch.solvers import checkpoint as ck
    from bibfs_tpu_torch.solvers.sharded2d import (
        Sharded2DHost,
        frontier_exchange_bytes_2d,
    )

    t_phase = time.perf_counter()
    dev = torch.device(dev_name)
    on_card = dev.type == "cuda"
    n, csr, host, edges = gnp["n"], gnp["csr"], gnp["host"], gnp["edges"]
    rng = np.random.default_rng(157)
    answers: list = []
    want_transport = ("nccl" if on_card and torch.cuda.device_count()
                      >= SHARD_RANKS else "gloo-staged" if on_card else "gloo")
    base_cfg = dict(dp_min_n=None if on_card else 0)
    opts = dict(cache_entries=0, max_batch=1024, device=dev,
                flush_threshold=32, device_batches=None if on_card else True)
    pool = MeshPool(SHARD_RANKS, dev.type, timeout_s=600)
    store = GraphStore(compact_threshold=None)
    engines: list = []

    def engine(cls=QueryEngine, graph="gnp", **kw):
        eng = cls(store=store, graph=graph, **{**opts, **kw})
        engines.append(eng)
        return eng

    try:
        check(pool.transport == want_transport,
              f"mesh: pool transport {pool.transport}, expected "
              f"{want_transport}")
        print(json.dumps({"phase": "mesh_pool", "ranks": pool.ranks,
                          "transport": pool.transport,
                          "spawn_s": pool.spawn_s}), flush=True)
        pool.graph("gnp", gnp_dir)
        checks = None
        if on_card:  # on the ranks, before the counts are zeroed
            t0 = time.perf_counter()
            checks = pool.call("jobs", [dict(
                kind="call", fn="chip_smoke:mesh_rank_check",
                args=dict(key="gnp", seed=151))])["results"][0]
            print(json.dumps({"phase": "mesh_kernels_vs_plain", "ok": True,
                              "ranks": len(checks),
                              "s": time.perf_counter() - t0}), flush=True)
        pool.counts(reset=True)
        t0 = time.perf_counter()
        store.add("gnp", n, edges, pairs=gnp["pairs_all"])
        store_s = time.perf_counter() - t0
        one = engine()
        # ---- the data-parallel sub-path: dp crossover, the default batch
        dp_eng = engine(mesh=MeshConfig(pool=pool, shard_min_n=n + 1,
                                        **base_cfg))
        cross = dp_eng.routes["mesh"].stats()["crossover"]
        flushes = []
        for wave, b in (("D0 warm-up", MESH_DP[0]),
                        *((f"D[{b}]", b) for b in MESH_DP)):
            pairs = fresh_pairs(rng, n, b)
            before = mesh_counters(dp_eng)
            t0 = time.perf_counter()
            got = dp_eng.query_many(pairs)
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = one.query_many(pairs)
            one_wall = time.perf_counter() - t0
            if on_card:
                torch.cuda.empty_cache()
            check([fields(r)[:3] for r in got] == [fields(r)[:3]
                                                   for r in want],
                  f"mesh dp wave {wave}: answers differ from the one-device "
                  "engine's")
            mesh_truth(n, edges, csr, pairs, got, wave)
            delta = mesh_delta(dp_eng, before)
            check(delta["mesh_queries"] == b and delta["batches"]["dp"] == 1,
                  f"mesh dp wave {wave}: routed {delta}")
            engine_clean(dp_eng, wave)
            line = {"phase": "mesh_dp", "wave": wave, "queries": b,
                    "flush_ms": got[0].time_s * 1e3,
                    "one_device_flush_ms": want[0].time_s * 1e3,
                    "one_device_mode": want[0].mode, "wall_ms": wall * 1e3,
                    "one_device_wall_ms": one_wall * 1e3,
                    "lanes_per_rank": bmin.pad_batch(-(-b // SHARD_RANKS)),
                    "transport": pool.transport, "crossover": cross}
            print(json.dumps(line), flush=True)
            if "warm" not in wave:
                flushes.append(dict(line, pairs=pairs, answers=[
                    fields(r)[:2] for r in got]))
            answers.append([wave, [fields(r)[:3] for r in got]])
        # the queue flushes at the wave's depth: one batch of the wave
        pipe = engine(PipelinedQueryEngine, max_wait_ms=None,
                      flush_threshold=MESH_DP[-1],
                      mesh=MeshConfig(pool=pool, shard_min_n=n + 1,
                                      **base_cfg))
        pairs = fresh_pairs(rng, n, MESH_DP[-1])
        t0 = time.perf_counter()
        got = pipe.query_many(pairs)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = one.query_many(pairs)
        one_wall = time.perf_counter() - t0
        if on_card:
            torch.cuda.empty_cache()
        check([fields(r)[:3] for r in got] == [fields(r)[:3] for r in want],
              "mesh pipelined dp wave: answers differ from the one-device "
              "engine's")
        check(pipe.stats()["mesh_queries"] == len(pairs),
              "mesh pipelined dp wave: not every query served on the mesh")
        engine_clean(pipe, "P[dp]")
        print(json.dumps({"phase": "mesh_dp", "wave": "P[1024]",
                          "queries": len(pairs),
                          "flush_ms": got[0].time_s * 1e3,
                          "one_device_flush_ms": want[0].time_s * 1e3,
                          "wall_ms": wall * 1e3,
                          "one_device_wall_ms": one_wall * 1e3}), flush=True)
        answers.append(["P", [fields(r)[:3] for r in got]])
        # ---- below the crossover: a routing decision, counted
        pairs = fresh_pairs(rng, n, MESH_REROUTE)
        before = mesh_counters(dp_eng)
        got = dp_eng.query_many(pairs)
        mesh_truth(n, edges, csr, pairs, got, "reroute")
        delta = mesh_delta(dp_eng, before)
        check(delta["reroutes"] == 1 and delta["mesh_queries"] == 0
              and delta["device_queries"] == len(pairs),
              f"mesh reroute wave: {delta}")
        print(json.dumps({"phase": "mesh_reroute", "queries": len(pairs),
                          **delta}), flush=True)
        # ---- the vertex-sharded sub-path, one query after another
        linked = np.flatnonzero(np.diff(csr[0]) > 0)
        for mode, k in MESH_SHARDED:
            eng = engine(mesh=MeshConfig(pool=pool, shard_min_n=0, mode=mode))
            pairs = seeded_pairs(np.random.default_rng(163), linked, k)[:k]
            before = mesh_counters(eng)
            t0 = time.perf_counter()
            got = eng.query_many(pairs)
            wall = time.perf_counter() - t0
            mesh_truth(n, edges, csr, pairs, got, f"S[{mode}]")
            delta = mesh_delta(eng, before)
            check(delta["mesh_queries"] == len(pairs)
                  and delta["batches"]["sharded"] >= 1,
                  f"mesh sharded wave {mode}: routed {delta}")
            engine_clean(eng, f"S[{mode}]")
            print(json.dumps({"phase": "mesh_sharded", "mode": mode,
                              "queries": len(pairs), "wall_ms": wall * 1e3,
                              "ms_per_query": wall * 1e3 / len(pairs),
                              "exchange_bytes": delta["exchange"],
                              "transport": pool.transport}), flush=True)
            answers.append([mode, [fields(r)[:3] for r in got]])
        for eng in engines:
            if eng is not one:
                eng.close()
        # ---- a hot swap between two halves of a wave, on a graph of at
        # most 2^17 vertices (a compaction of gnp-deg8-s20 alone takes
        # ~25 s of host code, PERF.md)
        ns = min(n, MESH_SWAP_N)
        es = gnp_random_graph(ns, 8 / ns, seed=167)
        store.add("swap", ns, es)
        pipe = engine(PipelinedQueryEngine, max_wait_ms=None,
                      flush_threshold=MESH_SWAP, graph="swap",
                      mesh=MeshConfig(pool=pool, shard_min_n=ns + 1,
                                      **base_cfg))
        pairs = fresh_pairs(rng, ns, MESH_SWAP)
        old = native_hops(ns, es, pairs)
        got_old = pipe.query_many(pairs)
        check([(r.found, r.hops) for r in got_old] == old,
              "mesh swap: pre-swap answers differ from the host solver's")
        adds = np.array(pairs[:MESH_SWAP_ADDS], dtype=np.int64)
        t0 = time.perf_counter()
        store.update("swap", adds=adds)
        store.compact("swap")
        swap_s = time.perf_counter() - t0
        edges2 = np.concatenate([np.asarray(es, np.int64), adds])
        new = native_hops(ns, edges2, pairs)
        got_new = pipe.query_many(pairs)
        stale = sum((r.found, r.hops) != w for r, w in zip(got_new, new))
        changed = sum(a != b for a, b in zip(old, new))
        check(stale == 0, f"mesh swap: {stale} stale answers")
        check(changed >= MESH_SWAP_ADDS // 2,
              f"mesh swap: the update changed only {changed} answers")
        st = pipe.stats()
        check(st["mesh_queries"] == 2 * len(pairs),
              "mesh swap: not every query served on the mesh")
        print(json.dumps({"phase": "mesh_swap", "n": ns,
                          "queries": 2 * len(pairs),
                          "changed": changed, "stale": stale,
                          "swap_s": swap_s,
                          "versions": st["graph"]["version"]}), flush=True)
        answers.append(["swap", [(r.found, r.hops) for r in got_new]])
        pipe.close()
        one.close()
        # ---- the 2D block-partitioned search on a 2x2 grid of the ranks
        t0 = time.perf_counter()
        blocks = Sharded2DHost.build(n, edges, 2, 2, pairs=gnp["pairs_all"])
        build2d_s = time.perf_counter() - t0
        pool.graph("gnp2d", blocks.save(os.path.join(
            os.path.dirname(gnp_dir), "gnp2d")))
        pairs = gnp["pairs"]
        jobs = [dict(kind="exchange2d", graph="gnp2d", reps=10)]
        jobs += [dict(kind="solve2d", graph="gnp2d", src=s, dst=d, mode=m)
                 for m in ("sync", "alt") for s, d in pairs]
        jobs += [dict(kind="solve2d", graph="gnp2d", src=s, dst=d, mode=m,
                      repeats=3) for m in ("sync", "alt")
                 for s, d in pairs[:MESH_2D_TIMED]]
        t0 = time.perf_counter()
        out = pool.call("jobs", jobs)["results"]
        ranks2d_s = time.perf_counter() - t0
        ex2d, out = out[0], out[1:]
        g = dense.DeviceGraph.from_ell(host, dev)
        k = 0
        for m in ("sync", "alt"):
            for s, d in pairs:
                # all but the path: the 2D parent is the max over the
                # blocks' first hits, the dense one the row's first hit
                r = out[k]
                w = fields(dense.solve_dense_graph(g, s, d, mode=m))
                k += 1
                check(fields(r)[:2] + fields(r)[3:] == w[:2] + w[3:],
                      f"2D {m} {s}->{d} differs from the dense search")
                if r.found:
                    check(validate_path(csr, r.path, s, d, hops=r.hops),
                          f"2D {m} {s}->{d}: invalid path")
                answers.append(["2d", m, s, d, fields(r)[:3]])
        timed = out[k:]
        for i, m in enumerate(("sync", "alt")):
            ts = [t.time_s for t in timed[i * MESH_2D_TIMED:
                                          (i + 1) * MESH_2D_TIMED]]
            dms = [dense.time_search(g, s, d, repeats=3, mode=m)[1].time_s
                   for s, d in pairs[:MESH_2D_TIMED]] if on_card else []
            print(json.dumps({
                "phase": "mesh_2d", "mode": m, "grid": [2, 2],
                "median_search_ms": float(np.median(ts)) * 1e3,
                "dense_median_search_ms": (float(np.median(dms)) * 1e3
                                           if dms else None),
                "transport": pool.transport}), flush=True)
        n_loc1 = host.n_pad // SHARD_RANKS
        print(json.dumps({
            "phase": "mesh_2d_exchange", "grid": [2, 2],
            "bytes_per_side_2d": frontier_exchange_bytes_2d(blocks.n_pad, 2,
                                                            2),
            "bytes_per_side_1d": frontier_exchange_bytes(n_loc1),
            "transpose_ms": ex2d["transpose_ms"],
            "gather_ms": ex2d["gather_ms"], "fold_ms": ex2d["fold_ms"],
            "build_s": build2d_s, "ranks_s": ranks2d_s,
            "transport": pool.transport}), flush=True)
        # ---- checkpoint: stopped on one card, resumed on all three
        s, d = pairs[0]
        one_shot = dense.solve_dense_graph(g, s, d, mode="pallas")
        ck_dir = os.path.join(os.path.dirname(gnp_dir), "ckpt")
        os.makedirs(ck_dir, exist_ok=True)
        path0 = os.path.join(ck_dir, "stopped.ckpt")
        t0 = time.perf_counter()
        stopped = ck.solve_checkpointed(g, s, d, mode="pallas", chunk=1,
                                        path=path0, max_chunks=1)
        chunk_s = time.perf_counter() - t0
        check(stopped is None, "checkpoint: the stopped search finished")
        t0 = time.perf_counter()
        ck.solve_checkpointed(g, s, d, mode="pallas", chunk=1)
        nofile_s = time.perf_counter() - t0
        copies = {}
        for where in ("card", "1d", "2d"):
            copies[where] = os.path.join(ck_dir, f"{where}.ckpt")
            with open(path0, "rb") as f, open(copies[where], "wb") as o:
                o.write(f.read())
        t0 = time.perf_counter()
        res = {"card": ck.resume(copies["card"], g, src=s, dst=d, chunk=2)}
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["1d"], res["2d"] = pool.call("jobs", [
            dict(kind="resume", graph="gnp", substrate="1d", src=s, dst=d,
                 path=copies["1d"], chunk=2),
            dict(kind="resume", graph="gnp2d", substrate="2d", src=s, dst=d,
                 path=copies["2d"], chunk=2)])["results"]
        mesh_s = time.perf_counter() - t0
        for where, r in res.items():
            want = fields(one_shot)
            got = fields(r)
            if where == "2d":  # its parent rule: the max over the blocks
                want, got = want[:2] + want[3:], got[:2] + got[3:]
                if r.found:
                    check(validate_path(csr, r.path, s, d, hops=r.hops),
                          "checkpoint resumed on 2x2: invalid path")
            check(got == want, f"checkpoint resumed on {where} differs from "
                  "the one-shot search")
        print(json.dumps({
            "phase": "mesh_checkpoint", "mode": "pallas", "pair": [s, d],
            "levels": one_shot.levels,
            "snapshot_mb": os.path.getsize(path0) / 1e6,
            "first_chunk_with_snapshot_s": chunk_s,
            "chunked_no_file_s": nofile_s,
            "chunks_no_file": one_shot.levels // 2 + 1,
            "resume_card_s": card_s, "resume_1d_and_2d_s": mesh_s,
            "modes": {k: r.mode for k, r in res.items()}}), flush=True)
        answers.append(["ckpt", {k: fields(r)[:2] for k, r in res.items()}])
        del g
        launches = pool.counts()
        print(json.dumps({"phase": "mesh_launches", **launches}), flush=True)
        if on_card:
            for name in MESH_KERNELS:
                check(launches.get(name, 0) > 0,
                      f"kernel {name} was not launched on the mesh path")
        # the dp flush split (after the counts are read): each wave's pairs
        # sent again as one dp job, its batch clock on the ranks against
        # the job's round trip (the rest: the ranks' parent copies and path
        # walks, the results' gather and return)
        for ln in flushes:
            t0 = time.perf_counter()
            res = pool.call("jobs", [dict(
                kind="dp", graph="gnp", pairs=np.asarray(ln["pairs"]),
                dt8=on_card)])["results"][0]
            trip = (time.perf_counter() - t0) * 1e3
            check([fields(r)[:2] for r in res] == ln["answers"],
                  f"mesh dp split {ln['queries']}: answers differ from the "
                  "wave's")
            print(json.dumps({
                "phase": "mesh_dp_split", "queries": ln["queries"],
                "round_trip_ms": trip, "ranks_batch_ms": res[0].time_s * 1e3,
                "rest_ms": trip - res[0].time_s * 1e3,
                "wave_flush_ms": ln["flush_ms"],
                "transport": pool.transport}), flush=True)
    finally:
        for eng in engines:
            eng.close()
        pool.close()
        store.close()
    import hashlib

    digest = hashlib.sha256(json.dumps(answers, default=str).encode()
                            ).hexdigest()
    print(json.dumps({"phase": "mesh_total", "transport": pool.transport,
                      "spawn_s": pool.spawn_s, "store_s": store_s,
                      "answers": len(answers), "digest": digest,
                      "flush_ms": {ln["wave"]: [ln["flush_ms"],
                                                ln["one_device_flush_ms"]]
                                   for ln in flushes},
                      "wall_ms": {ln["wave"]: [ln["wall_ms"],
                                               ln["one_device_wall_ms"]]
                                  for ln in flushes},
                      "s": time.perf_counter() - t_phase}), flush=True)
    return {"launches": launches, "checks": checks}


# ---- phase 16: whole-graph analytics -----------------------------------------
# the kernels of the blocked analytics rungs (csrc/semiring.cu): the wrapper
# that counts its launches, the source, and the XLA program of the JAX
# package it replaces (none is a Pallas kernel; the pack replaces nothing:
# it packs the int8 tiles that line of the reference builds, once a graph)
ANALYTICS_KERNELS = {
    "minplus_fixpoint": (sr.minplus_fixpoint, "bibfs_tpu_torch/csrc/semiring.cu",
                         "bibfs_tpu/ops/semiring_plane.py:105"),
    "pagerank": (sr.pagerank_blocked, "bibfs_tpu_torch/csrc/semiring.cu",
                 "bibfs_tpu/ops/semiring_plane.py:138"),
    "tricount": (sr.triangles_chunk_blocked, "bibfs_tpu_torch/csrc/semiring.cu",
                 "bibfs_tpu/ops/semiring_plane.py:180"),
    "pack_tile_rows": (sr.pack_tile_rows, "bibfs_tpu_torch/csrc/semiring.cu",
                       "bibfs_tpu/graph/blocked.py:139"),
}
# phase 16's graphs: name -> (vertices, edge maker)
ANALYTICS_GRAPHS = {
    # dense-ish, near the 256 MB tile budget: 79 x 79 tiles, 102 MB int8
    "gnp-10000-d128": (10_000, lambda: gnp_random_graph(
        10_000, 128 / 9_999, seed=161)),
    # 40 x 40 tiles: the f32 weight tables of two seeds fit the x5 gate
    "gnp-5000-d64": (5_000, lambda: gnp_random_graph(5_000, 64 / 4_999,
                                                     seed=163)),
    # phase 10's grid: a Bellman depth of over 126 sweeps
    "grid-64x64": (64 * 64, lambda: grid_graph(64, 64, perforation=0.02,
                                               seed=1)),
}
ANALYTICS_SSSP = {0: 8, 1: 4}  # gnp-5000's flush: SSSP queries a weight seed
ANALYTICS_ADDS = 8  # the adds-only update batch of the grid
ANALYTICS_REPS = 5  # launches a kernel is timed over
PR_TOL = 1e-8  # the PageRank queries' tolerance (the kernels resolve 5e-7)
PR_FIXED_STEPS = 50  # power steps of the kernel's timed fixed run
RANK_ERR = 1e-6  # the PageRank kernel against its twin
RANK_REF_ERR = 2e-4  # PageRank against the float64 host reference


def analytics_graph(name: str, n: int, make) -> dict:
    """One of phase 16's graphs built on the host: edges, pairs, CSR and
    the blocked tiling, with a ``graph`` line of its bytes."""
    t0 = time.perf_counter()
    edges = make()
    pairs = canonical_pairs(n, edges)
    csr = build_csr(n, pairs=pairs)
    bg = build_blocked(n, pairs=pairs)
    g = dict(name=name, n=n, edges=edges, pairs=pairs, csr=csr, bg=bg)
    print(json.dumps({"phase": "graph", "name": name, "n": n,
                      "edges": int(pairs.shape[0] // 2), "n_pad": bg.n_pad,
                      "nblocks": bg.nblocks, "bwidth": bg.bwidth,
                      "nnz_tiles": bg.nnz_blocks, "tab_bytes": bg.tab_bytes,
                      "f32_weight_bytes": 4 * bg.tab_bytes,
                      "build_s": time.perf_counter() - t0}), flush=True)
    return g


def analytics_refs(n: int, csr, sources: dict | None = None) -> dict:
    """Independent host references by scipy, none through the semiring
    product: Dijkstra from ``sources`` (weight seed -> sources) under the
    seeded weights, connected components mapped to min labels, a float64
    sparse power iteration, and the row-blocked ``(A @ A) * A`` triangle
    count."""
    import scipy.sparse as sps
    from scipy.sparse import csgraph

    from bibfs_tpu_torch.query.weighted import synthetic_weights

    rp, ci = csr
    a = sps.csr_matrix((np.ones(ci.size), ci, rp), shape=(n, n))
    out: dict = {"dist": {}}
    for seed, srcs in (sources or {}).items():
        w = sps.csr_matrix((synthetic_weights(rp, ci, seed), ci, rp),
                           shape=(n, n))
        rows = csgraph.dijkstra(w, indices=[int(s) for s in srcs])
        for s, row in zip(srcs, rows):
            out["dist"][seed, int(s)] = row
    _count, lab = csgraph.connected_components(a, directed=False)
    mins = np.full(lab.max() + 1, n, dtype=np.int64)
    np.minimum.at(mins, lab, np.arange(n))
    out["labels"] = mins[lab]
    deg = np.diff(rp).astype(np.float64)
    dangling = deg == 0
    r = np.full(n, 1.0 / n)
    for _ in range(100):
        contrib = np.where(dangling, 0.0, r / np.maximum(deg, 1.0))
        rn = 0.15 / n + 0.85 * (a @ contrib + r[dangling].sum() / n)
        done = np.abs(rn - r).sum() <= PR_TOL
        r = rn
        if done:
            break
    out["ranks"] = r
    ai = a.astype(np.int64)
    tri = 0
    for r0 in range(0, n, 1000):
        rows = ai[r0:r0 + 1000]
        tri += int((rows @ ai).multiply(rows).sum())
    out["triangles"] = tri // 6
    return out


MINPLUS_FLOOR_PATH = 2000  # the floor runs' path: 16 block rows, 2000 sweeps
MINPLUS_FLOOR_WIDTH = 128  # the grid floor's slots a block row (32 lanes a row)
B_SOURCES = 64  # msbfs_plane_blocked's sources on the grid


def minplus_floor(dev, put) -> dict:
    """A near-empty (min, +) sweep's ms in each mode: labels from vertex 0
    (0 there, +inf elsewhere) along a path of 2,000 vertices, one vertex
    lowered a sweep, 2,000 sweeps (1-3 block rows active after sweep 0,
    which takes all 16 on the grid). ``solo``: the path's own table (3
    slots a block row: a lane a row, every later sweep in one block);
    ``grid``: the same rows with 125 more slots a block row, all pointing
    at an empty 17th block row that never changes (32 lanes a row: every
    sweep on the grid). Prints one ``minplus_floor`` line; returns the ms
    a sweep of each (sweep 0 in it)."""
    n = MINPLUS_FLOOR_PATH
    edges = np.array([[v, v + 1] for v in range(n - 1)])
    bg = build_blocked(n, pairs=canonical_pairs(n, edges))
    out, line = {}, {"phase": "minplus_floor", "path": n}
    wide = np.zeros((bg.nblocks + 1, MINPLUS_FLOOR_WIDTH, 128, 128), np.int8)
    wide[: bg.nblocks, : bg.bwidth] = bg.tab
    wcol = np.full((bg.nblocks + 1, MINPLUS_FLOOR_WIDTH), bg.nblocks,
                   np.int32)
    wcol[: bg.nblocks, : bg.bwidth] = np.where(
        bg.bcol < bg.nblocks, bg.bcol, bg.nblocks)
    for mode, tab, bcol in (("solo", bg.tab, bg.bcol), ("grid", wide, wcol)):
        tab, bcol = put(tab), put(bcol)
        rows = sr.pack_tile_rows(tab)
        init = torch.full((bcol.shape[0] * 128, 1), float("inf"),
                          device=dev)
        init[0, 0] = 0.0
        planes, status = sr._minplus_launch(rows, None, bcol, init,
                                            max_rounds=init.shape[0])
        rounds, solo, grid, active = status.tolist()
        plane = planes[rounds & 1][:, 0]
        # sweep 0 takes every block row, on the grid in both
        want = (rounds - 1, 1) if mode == "solo" else (0, rounds)
        check(rounds == n and bool((plane[:n] == 0).all())
              and bool(torch.isinf(plane[n:]).all())
              and (solo, grid) == want,
              f"minplus floor {mode}: {rounds} rounds, split {solo}/{grid}")
        ms = time_launch(lambda: sr._minplus_launch(
            rows, None, bcol, init, max_rounds=init.shape[0]),
            reps=ANALYTICS_REPS)
        out[mode] = ms / rounds
        line[mode] = dict(ms=ms, rounds=rounds, ms_per_sweep=ms / rounds,
                          solo_sweeps=solo, grid_sweeps=grid,
                          active_rows=active, bwidth=int(bcol.shape[1]),
                          group=sr.minplus_group(int(bcol.shape[1])))
    print(json.dumps(line), flush=True)
    return out


def msbfs_blocked_step(g: dict, dev, put) -> None:
    """Row B (``msbfs_plane_blocked``, torch code off every serving path)
    on the card: 64 seeded sources on the grid, its int16 plane against
    the ELL sweep's (B1, ``msbfs_plane_csr``) from the same sources; the
    median ms of 5 calls (CUDA events; a host read a level in it), its
    bound (a level reads the live int8 tiles and the f32 frontier plane and
    writes the next plane and the new int32 distances, times its levels),
    and ``torch.sparse.mm`` of the adjacency and the 0/1 plane, one a
    level, as the yardstick. One ``step`` line."""
    bg = g["bg"]
    srcs = np.random.default_rng(181).choice(g["n"], B_SOURCES, replace=False)
    bdg = dense.BlockedDeviceGraph.from_host(bg, device=dev)
    got = md.msbfs_plane_blocked(bdg, srcs)
    rp, ci = g["csr"]
    want = md.msbfs_plane_csr(g["n"], rp, ci, srcs, device=dev)
    err = int(np.abs(got.astype(np.int64) - np.asarray(want, np.int64)).max())
    check(err == 0 and got.shape == (g["n"], B_SOURCES),
          f"msbfs_plane_blocked: differs from msbfs_levels by {err}")
    ms = time_launch(lambda: md.msbfs_plane_blocked(bdg, srcs),
                     reps=ANALYTICS_REPS)
    levels = int(got.max()) + 1  # the last level finds nothing
    kp = max(8, -(-B_SOURCES // 8) * 8)
    per_level = bg.nnz_blocks * 128 * 128 + bg.n_pad * kp * (4 + 4 + 4)
    adj = sparse_adjacency(bg.n_pad, g["csr"], dev)
    plane = torch.zeros(bg.n_pad, kp, device=dev)
    plane[put(srcs), torch.arange(B_SOURCES, device=dev)] = 1.0
    lib_ms = time_launch(lambda: torch.sparse.mm(adj, plane), reps=REPS)
    step_line("msbfs_plane_blocked", g["name"], f"K={B_SOURCES}", ms,
              levels=levels, bound_ms=per_level * levels / HBM_BYTES_PER_S
              * 1e3, bound_by="bytes", max_abs_err=err,
              library_ms=lib_ms * levels, library_call_ms=lib_ms,
              library="torch.sparse.mm of the adjacency and the 0/1 [n_pad, "
                      "K] plane, one a level", route="torch (no hand kernel)")


def analytics_kernel_phase(graphs: dict, results: dict) -> None:
    """Each analytics kernel against its plain twin on the card at the
    shapes the rungs give it (exact planes, rounds, counts; PageRank within
    :data:`RANK_ERR`), timed, with its bound, the twin's ms and a one-call
    PyTorch yardstick where there is one; one ``step`` line each."""
    dev = torch.device("cuda")

    def put(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def twin_ms(fn) -> float:
        # the twin's second call (the first, compared, warmed it up), its
        # host reads included, between two events
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    tile_el = 128 * 128
    floors = minplus_floor(dev, put)
    # D1: SSSP planes (gnp-5000: C = 8 and 4; the grid: C = 1) and labels,
    # over each graph's packed tile rows
    bits = {name: sr.pack_tile_rows(put(graphs[name]["bg"].tab))
            for name in ("gnp-5000-d64", "grid-64x64", "gnp-10000-d128")}
    cases = []
    for name, seeds in (("gnp-5000-d64", ANALYTICS_SSSP), ("grid-64x64", {0: 1})):
        g = graphs[name]
        for seed, c in seeds.items():
            srcs = np.random.default_rng(seed).choice(g["n"], c, replace=False)
            init = np.full((g["bg"].n_pad, c), np.inf, np.float32)
            init[srcs, np.arange(c)] = 0.0
            w = put(build_blocked_weights(g["bg"], g["pairs"], seed=seed))
            cases.append((name, f"sssp C={c}", w, False, put(init), 4))
    for name in ("gnp-10000-d128", "grid-64x64"):
        bg = graphs[name]["bg"]
        cases.append((name, "components", put(bg.tab), True,
                      put(np.arange(bg.n_pad, dtype=np.float32)[:, None]), 1))
    for name, step, table, from_tab, init, itemsize in cases:
        bg = graphs[name]["bg"]
        bcol, rows = put(bg.bcol), bits[name]
        got, rounds = sr.minplus_fixpoint(table, bcol, init, from_tab=from_tab,
                                          bits=rows)
        want, want_rounds = sr.minplus_fixpoint_plain(table, bcol, init,
                                                      from_tab=from_tab)
        check(torch.equal(got, want) and rounds == want_rounds,
              f"minplus_fixpoint {name} {step}: differs from its twin "
              f"(rounds {rounds} / {want_rounds})")
        # the worklist twin's sweeps: what the kernel's status words must
        # say (its one-block / grid split, the active block rows), and the
        # bytes those sweeps need
        wl, wl_rounds, sweeps = sr.minplus_fixpoint_worklist(
            table, bcol, init, from_tab=from_tab)
        planes, status = sr._minplus_launch(
            rows, None if from_tab else table, bcol, init,
            max_rounds=bg.n_pad)
        k_rounds, solo, grid, active = status.tolist()
        want_split = sr.minplus_sweep_modes(bg.bwidth, sweeps)
        check(torch.equal(wl, want) and wl_rounds == rounds == k_rounds
              and torch.equal(planes[k_rounds & 1], want)
              and (solo, grid) == want_split
              and active == sum(len(a) for a in sweeps),
              f"minplus_fixpoint {name} {step}: worklist {wl_rounds} rounds, "
              f"split {(solo, grid)} / {want_split}, active {active}")
        plain_ms = twin_ms(lambda: sr.minplus_fixpoint_plain(
            table, bcol, init, from_tab=from_tab))
        ms = time_launch(lambda: sr.minplus_fixpoint(
            table, bcol, init, from_tab=from_tab, bits=rows),
            reps=ANALYTICS_REPS)
        c = init.shape[1]
        per_round = bg.nnz_blocks * tile_el * itemsize + 2 * bg.n_pad * c * 4
        bound = per_round * rounds / HBM_BYTES_PER_S * 1e3
        needed = sr.minplus_needed_bytes(table, bcol, sweeps, c,
                                         from_tab=from_tab)
        line = dict(rounds=rounds, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes", max_abs_err=0, library_ms=None,
                    ms_per_round=ms / rounds, c=c,
                    needed_bound_ms=needed / HBM_BYTES_PER_S * 1e3,
                    needed_mb=needed / 1e6,
                    floor_ms=solo * floors["solo"] + grid * floors["grid"],
                    active_rows=active, solo_sweeps=solo, grid_sweeps=grid,
                    group=sr.minplus_group(bg.bwidth), nblocks=bg.nblocks)
        step_line("minplus_fixpoint", name, step, ms, **line)
        if (name, step) == ("gnp-5000-d64", "sssp C=8"):
            # the kernels line's bound: what this run's sweeps need
            results["minplus_fixpoint"] = dict(
                line, ms=ms, geometry=name, step=step,
                bound_ms=line["needed_bound_ms"], whole_table_bound_ms=bound)
    del cases, bits
    msbfs_blocked_step(graphs["grid-64x64"], dev, put)
    # the pack, then D2 and D3 over its rows, on gnp-10000
    g = graphs["gnp-10000-d128"]
    bg = g["bg"]
    tab, bcol, deg = put(bg.tab), put(bg.bcol), put(bg.deg)
    bits = sr.pack_tile_rows(tab)
    err = int((bits.cpu() != sr.pack_tile_rows_plain(tab.cpu())).sum())
    check(err == 0, f"pack_tile_rows: {err} words differ from its twin")
    plain_ms = twin_ms(lambda: sr.pack_tile_rows_plain(tab))
    pack_ms = time_launch(lambda: sr.pack_tile_rows(tab), reps=ANALYTICS_REPS)
    packed_bytes = bg.nnz_blocks * 128 * 16  # the stored tiles' packed rows
    line = dict(plain_ms=plain_ms,
                bound_ms=(bg.tab_bytes + bg.tab_bytes // 8) / HBM_BYTES_PER_S
                * 1e3, bound_by="bytes", max_abs_err=err, library_ms=None,
                tab_bytes=bg.tab_bytes, bits_bytes=bits.numel() * 4)
    step_line("pack_tile_rows", g["name"], "pack", pack_ms, **line)
    results["pack_tile_rows"] = dict(line, ms=pack_ms, geometry=g["name"])
    kw = dict(n=g["n"], damping=0.85, tol=PR_TOL, max_iters=100)
    ranks, iters, delta = sr.pagerank_blocked(tab, bcol, deg, bits=bits, **kw)
    again, iters2, _ = sr.pagerank_blocked(tab, bcol, deg, bits=bits, **kw)
    check(torch.equal(ranks, again) and iters == iters2,
          "pagerank: two runs differ")
    want, want_iters, want_delta = sr.pagerank_blocked_plain(tab, bcol, deg, **kw)
    plain_ms = twin_ms(lambda: sr.pagerank_blocked_plain(tab, bcol, deg, **kw))
    err = float((ranks - want).abs().max())
    tol_eff = max(PR_TOL, sr.PAGERANK_TOL_FLOOR)
    iters_ok = iters == want_iters or (
        abs(iters - want_iters) == 1 and abs(want_delta - tol_eff) <= 1e-7)
    check(err <= RANK_ERR and iters_ok,
          f"pagerank: max abs {err}, iters {iters} / twin {want_iters} "
          f"(delta {want_delta})")
    ms = time_launch(lambda: sr.pagerank_blocked(tab, bcol, deg, bits=bits,
                                                 **kw), reps=ANALYTICS_REPS)
    # the kernel's steady power step: one launch of PR_FIXED_STEPS steps (a
    # negative tolerance ends none early), no host read in the interval
    # (its scratch's zeroed words, one fill, are); and the same on an
    # edgeless table of the same rows, one sentinel slot a block row: a
    # step with no row work (the grid barrier, the items' sums, the
    # epilogue)
    edgeless = (
        torch.zeros((bg.nblocks, 128, 1, 4), dtype=torch.int32,
                    device=dev).permute(0, 2, 1, 3),
        torch.full((bg.nblocks, 1), bg.nblocks, dtype=torch.int32,
                   device=dev),
        torch.zeros_like(deg))

    def fixed_ms(rows, cols, degs) -> float:
        run = []
        ms = time_launch(lambda: run.append(sr._pagerank_launch(
            rows, cols, degs, n=g["n"], damping=0.85, tol=-1.0,
            max_iters=PR_FIXED_STEPS)), reps=ANALYTICS_REPS)
        steps = int(run[-1][1][0])
        check(steps == PR_FIXED_STEPS,
              f"pagerank: a fixed run took {steps} steps")
        return ms / PR_FIXED_STEPS

    step_ms = fixed_ms(bits, bcol, deg)
    floor_ms = fixed_ms(*edgeless)
    rp, ci = g["csr"]
    adj = sparse_adjacency(bg.n_pad, g["csr"], dev)
    vec = torch.rand(bg.n_pad, 1, device=dev)
    lib_ms = time_launch(lambda: torch.sparse.mm(adj, vec), reps=REPS)
    bound = bg.nnz_blocks * tile_el * iters / HBM_BYTES_PER_S * 1e3
    # a step: the packed rows, bcol, deg, contrib and the ranks read, the
    # next ranks and contrib written
    step_bytes = packed_bytes + bcol.numel() * 4 + 5 * bg.n_pad * 4
    line = dict(iters=iters, twin_iters=want_iters, delta=delta,
                twin_delta=want_delta, max_abs_err=err, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes",
                bound_packed_ms=step_bytes * iters / HBM_BYTES_PER_S * 1e3,
                pack_ms=pack_ms, library_ms=lib_ms * iters,
                library_call_ms=lib_ms, ms_per_iter=ms / iters,
                step_ms=step_ms, floor_ms_per_step=floor_ms,
                fixed_steps=PR_FIXED_STEPS,
                library="torch.sparse.mm of the adjacency and one vector, "
                        "one a power step")
    step_line("pagerank", g["name"], "pagerank", ms, **line)
    results["pagerank"] = dict(line, ms=ms, geometry=g["name"])
    # D3: every chunk against its twin, one chunk timed
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    for c0 in range(0, g["n"], sr.TRI_CHUNK):
        got = sr.triangles_chunk_blocked(tab, bcol, c0, bits=bits)
        want = sr.triangles_chunk_blocked_plain(tab, bcol, c0)
        check(torch.equal(got, want), f"tricount chunk {c0}: {int(got)} != "
              f"twin {int(want)}")
        total += got
    plain_ms = twin_ms(lambda: sr.triangles_chunk_blocked_plain(tab, bcol, 0))
    chunks = -(-g["n"] // sr.TRI_CHUNK)
    ms = time_launch(lambda: sr.triangles_chunk_blocked(tab, bcol, 0, total,
                                                        bits=bits),
                     reps=ANALYTICS_REPS)
    plane = sr.triangle_plane(tab, bcol, 0)
    dense = torch.zeros(bg.n_pad, bg.n_pad, device=dev)
    dense[put(np.repeat(np.arange(g["n"]), np.diff(rp))), put(ci)] = 1.0
    lib_ms = time_launch(lambda: torch.matmul(dense, plane), reps=REPS)
    del dense
    ops = 2 * bg.nnz_blocks * tile_el * sr.TRI_CHUNK
    t_bytes = bg.tab_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    # the chunk's packed rows: its block rows' stored tiles and those of
    # every block row they hold (u's rows), each read once
    rows_x = bg.bcol[: 2]
    held = np.unique(rows_x[rows_x < bg.nblocks])
    brs = np.union1d(np.arange(min(2, bg.nblocks)), held)
    tiles = int((bg.bcol[brs] < bg.nblocks).sum())
    line = dict(chunks=chunks, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_packed_ms=(tiles * 128 * 16 + bg.bcol[brs].size * 4)
                / HBM_BYTES_PER_S * 1e3,
                pack_ms=pack_ms, max_abs_err=0, library_ms=lib_ms,
                library="dense torch.matmul of the adjacency and the chunk's "
                        "[n_pad, 256] plane (f32)")
    step_line("tricount", g["name"], "chunk c0=0", ms, **line)
    results["tricount"] = dict(line, ms=ms, geometry=g["name"])


def analytics_counts() -> dict:
    return {k: w.launches for k, (w, _s, _r) in ANALYTICS_KERNELS.items()}


def analytics_wave(eng, queries, wave: str, graph: str,
                   expect: dict) -> list:
    """Serve ``queries`` through ``eng`` (``query_many`` on the
    synchronous engine, one ``submit_query`` a query on the pipelined);
    check the engine clean and each kind's new answers counted on the
    route ``expect`` names; print one ``analytics`` line."""
    before = eng.stats()["query_kinds"]
    t0 = time.perf_counter()
    if isinstance(eng, PipelinedQueryEngine):
        res = [t.wait(timeout=600) for t in
               [eng.submit_query(q) for q in queries]]
    else:
        res = eng.query_many(queries)
    wall = time.perf_counter() - t0
    st = engine_clean(eng, wave)
    routes = {k: {r: c - before.get(k, {}).get(r, 0) for r, c in v.items()
                  if c - before.get(k, {}).get(r, 0)}
              for k, v in st["query_kinds"].items()}
    routes = {k: v for k, v in routes.items() if v}
    check(routes == expect, f"analytics wave {wave}: routes {routes}, "
          f"expected {expect}")
    print(json.dumps({"phase": "analytics", "wave": wave, "graph": graph,
                      "queries": len(queries), "routes": routes,
                      "wall_ms": wall * 1e3,
                      "answer_ms": {type(r).__name__: r.time_s * 1e3
                                    for r in res},
                      "kind_cache": st["kind_cache"]}), flush=True)
    return res


def check_analytics(queries, res, ref: dict, wave: str) -> None:
    """Every answer of a wave against the scipy references."""
    from bibfs_tpu_torch.analytics import (
        ComponentsResult,
        PageRankResult,
        SsspResult,
        TrianglesResult,
    )

    for q, r in zip(queries, res):
        if isinstance(r, SsspResult):
            want = ref["dist"][int(q.weight_seed), int(q.source)]
            check(np.array_equal(r.dist, want),
                  f"{wave}: sssp from {q.source} differs from Dijkstra")
        elif isinstance(r, ComponentsResult):
            check(np.array_equal(r.labels, ref["labels"]),
                  f"{wave}: labels differ from connected_components")
        elif isinstance(r, PageRankResult):
            err = float(np.max(np.abs(r.ranks - ref["ranks"])))
            check(err <= RANK_REF_ERR, f"{wave}: ranks off by {err}")
        elif isinstance(r, TrianglesResult):
            check(r.count == ref["triangles"],
                  f"{wave}: {r.count} triangles, scipy {ref['triangles']}")


def pagerank_split(big: dict, ref: dict) -> dict:
    """Where a PageRank answer's time goes on the card. A new synchronous
    engine over ``big`` (the allocator's cache emptied first, as the
    kernel checks leave it for the waves): a labelling uploads the tiles
    and packs their rows, then the engine's answer on its first PageRank
    flush and on a warm one (``answer_ms``). Then the route's steps one by
    one on that runtime, the card synchronized between them. ``cold``,
    the cache emptied: ``alloc_ms`` the packed rows' allocation alone
    (with the device allocations it made) and ``bits_ms`` a pack into a
    new allocation (what a flush that packs first pays); in each state
    ``setup_ms`` the launch's host part (scratch, zeroed words, the
    call), ``wait_status_ms`` the status read that waits for the kernel,
    ``ranks_ms`` the ranks' copy to the host and ``kernel_ms`` the same
    launch alone between CUDA events; ``warm`` the same with the engine
    open, ``closed`` after it closed, with ``pack_host_ms`` the host's part
    of a pack into a cached allocation (median of 5). Prints one
    ``analytics_split`` line; returns it."""
    from bibfs_tpu_torch.analytics import Components, PageRank

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    eng = QueryEngine(big["n"], big["edges"], pairs=big["pairs"])
    analytics_wave(eng, [Components()], "A[split tiles]", big["name"],
                   {"components": {"components_blocked": 1}})
    answer = {}
    for k, state in enumerate(("first", "warm")):
        qs = [PageRank(tol=(2 + k) * PR_TOL)]
        res = analytics_wave(eng, qs, f"A[split {state}]", big["name"],
                             {"pagerank": {"pagerank_blocked": 1}})
        check_analytics(qs, res, ref, f"A[split {state}]")
        answer[state] = res[0].time_s * 1e3
    bg = eng._current_rt().blocked_graph()
    n = big["n"]
    kw = dict(n=n, damping=0.85, tol=max(PR_TOL, sr.PAGERANK_TOL_FLOOR),
              max_iters=100)
    line = {"phase": "analytics_split", "graph": big["name"],
            "answer_ms": answer}

    def allocs() -> int:
        return int(torch.cuda.memory_stats().get("num_device_alloc", 0))

    def launch():
        return sr._pagerank_launch(bg.bits, bg.bcol, bg.deg, **kw)

    def steps() -> dict:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ranks, status = launch()
        t1 = time.perf_counter()
        iters, _ = sr._status("pagerank_kernel", status)
        t2 = time.perf_counter()
        ranks[iters & 1][:n].cpu().numpy()
        t3 = time.perf_counter()
        return dict(setup_ms=(t1 - t0) * 1e3, wait_status_ms=(t2 - t1) * 1e3,
                    ranks_ms=(t3 - t2) * 1e3, iters=iters,
                    kernel_ms=time_launch(launch, reps=1))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    a0, t0 = allocs(), time.perf_counter()
    probe = torch.empty(tuple(bg.bits.shape), dtype=torch.int32,
                        device=bg.device)
    torch.cuda.synchronize()
    cold = dict(alloc_ms=(time.perf_counter() - t0) * 1e3,
                alloc_device_allocs=allocs() - a0)
    del probe
    torch.cuda.empty_cache()
    a0, t0 = allocs(), time.perf_counter()
    bits = sr.pack_tile_rows(bg.tab)
    torch.cuda.synchronize()
    cold.update(bits_ms=(time.perf_counter() - t0) * 1e3,
                bits_device_allocs=allocs() - a0)
    check(torch.equal(bits, bg.bits), "pagerank split: a pack differs")
    del bits
    line["cold"] = dict(cold, **steps())
    line["warm"] = steps()
    eng.close()
    line["closed"] = steps()
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sr.pack_tile_rows(bg.tab)
        host.append((time.perf_counter() - t0) * 1e3)
    line["closed"]["pack_host_ms"] = float(np.median(host))
    print(json.dumps(line), flush=True)
    return line


def analytics_phase(dev_name: str = "cuda", results: dict | None = None,
                    graphs: dict | None = None) -> dict:
    """Phase 16 (module docstring). ``dev_name="cpu"`` with small
    ``graphs`` (name -> (n, edge maker), the three names of
    :data:`ANALYTICS_GRAPHS`) rehearses it on the host: the engines' rungs
    run the twins and no kernel is timed or counted. Returns the launches
    of the engines' waves."""
    from bibfs_tpu_torch.analytics import Components, PageRank, Sssp, Triangles

    t_phase = time.perf_counter()
    on_card = dev_name == "cuda"
    spec = graphs or ANALYTICS_GRAPHS
    g = {name: analytics_graph(name, *spec[name]) for name in spec}
    big, mid, grid = (g["gnp-10000-d128"], g["gnp-5000-d64"],
                      g["grid-64x64"])
    graphs_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    rng = np.random.default_rng(167)
    sssp_src = {seed: rng.choice(mid["n"], k, replace=False)
                for seed, k in ANALYTICS_SSSP.items()}
    big_src = int(rng.integers(big["n"]))
    refs = {
        "big": analytics_refs(big["n"], big["csr"], {0: [big_src]}),
        "mid": analytics_refs(mid["n"], mid["csr"], sssp_src),
        "grid": analytics_refs(grid["n"], grid["csr"], {0: [0]}),
    }
    refs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if on_card:
        analytics_kernel_phase(g, results if results is not None else {})
        torch.cuda.empty_cache()
    kernels_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    opts = {} if on_card else {"device": "cpu"}

    def rungs(eng, host_sssp=False):
        # the host rehearsal reads the cpu calibration's crossovers: force
        # the blocked rungs on, and SSSP off where the card's x5 gate is
        if not on_card:
            for kind in ("sssp", "pagerank", "components", "triangles"):
                eng.routes[f"{kind}_blocked"].min_edges = 0
            if host_sssp:
                eng.routes["sssp_blocked"].min_edges = 1 << 40
        return eng

    reset_counts()
    # gnp-10000: pagerank, components, triangles blocked; sssp over the x5
    # gate on the host rung; synchronous then pipelined
    qs = [PageRank(tol=PR_TOL), Components(), Triangles(), Sssp(big_src)]
    expect = {"pagerank": {"pagerank_blocked": 1},
              "components": {"components_blocked": 1},
              "triangles": {"triangles_blocked": 1}, "sssp": {"sssp": 1}}
    for cls, wave in ((QueryEngine, "A[sync]"),
                      (PipelinedQueryEngine, "A[pipelined]")):
        eng = rungs(cls(big["n"], big["edges"], pairs=big["pairs"], **opts),
                    host_sssp=True)
        res = analytics_wave(eng, qs, wave, big["name"], expect)
        check_analytics(qs, res, refs["big"], wave)
        if cls is PipelinedQueryEngine:
            # the same engine behind the network door: its analytics op
            net_analytics(eng, res, qs, wave)
        if cls is QueryEngine:
            # a PageRank answer on the warm engine (its tiles and packed
            # rows built; another tolerance, so no cache answers it)
            warm = [PageRank(tol=10 * PR_TOL)]
            res = analytics_wave(eng, warm, "A[warm]", big["name"],
                                 {"pagerank": {"pagerank_blocked": 1}})
            check_analytics(warm, res, refs["big"], "A[warm]")
        eng.close()
        del eng
    # gnp-5000: one flush of 12 SSSP queries, two planes (C = 8 and 4)
    qs = [Sssp(int(s), weight_seed=seed) for seed, srcs in sssp_src.items()
          for s in srcs]
    eng = rungs(QueryEngine(mid["n"], mid["edges"], pairs=mid["pairs"],
                            **opts))
    res = analytics_wave(eng, qs, "A[planes]", mid["name"],
                         {"sssp": {"sssp_blocked": len(qs)}})
    check_analytics(qs, res, refs["mid"], "A[planes]")
    eng.close()
    del eng
    # the grid through a GraphStore: the four kinds blocked, a repeat
    # from the store route, an adds-only update maintained incrementally
    store = GraphStore(compact_threshold=None, device=dev_name)
    store.add("grid", grid["n"], grid["edges"])
    qs = [Sssp(0), Components(), PageRank(tol=PR_TOL), Triangles()]
    eng = rungs(QueryEngine(store=store, graph="grid", **opts))
    res = analytics_wave(
        eng, qs, "A[store]", grid["name"],
        {k: {f"{k}_blocked": 1} for k in ("sssp", "components", "pagerank",
                                          "triangles")})
    check_analytics(qs, res, refs["grid"], "A[store]")
    pipe = rungs(PipelinedQueryEngine(store=store, graph="grid", **opts))
    res = analytics_wave(
        pipe, qs, "A[store repeat]", grid["name"],
        {k: {"store": 1} for k in ("sssp", "components", "pagerank",
                                   "triangles")})
    check_analytics(qs, res, refs["grid"], "A[store repeat]")
    pipe.close()
    rng = np.random.default_rng(173)
    have = {tuple(p) for p in grid["pairs"].tolist()}
    adds = []
    while len(adds) < ANALYTICS_ADDS:
        u, v = (int(x) for x in rng.integers(grid["n"], size=2))
        if u != v and (u, v) not in have:
            have.update({(u, v), (v, u)})
            adds.append((u, v))
    ev0 = dict(store.analytics.stats()["events"])
    store.update("grid", adds=adds)
    store.compact("grid")
    edges2 = np.concatenate([grid["edges"], np.array(adds)])
    pairs2 = canonical_pairs(grid["n"], edges2)
    ref2 = analytics_refs(grid["n"], build_csr(grid["n"], pairs=pairs2),
                          {0: [0]})
    qs = [Sssp(0), Components()]
    res = analytics_wave(eng, qs, "A[incremental]", grid["name"],
                         {"sssp": {"store": 1}, "components": {"store": 1}})
    check_analytics(qs, res, ref2, "A[incremental]")
    ev = store.analytics.stats()["events"]
    check(ev["incremental"] - ev0["incremental"] == 2,
          f"analytics: incremental events {ev0} -> {ev}")
    eng.close()
    store.close()
    launches = analytics_counts()
    waves_s = time.perf_counter() - t0
    print(json.dumps({"phase": "analytics_launches", **launches}), flush=True)
    if on_card:
        for name, count in launches.items():
            check(count > 0, f"kernel {name} was not launched by the "
                  "analytics waves")
        t0 = time.perf_counter()
        pagerank_split(big, refs["big"])
        waves_s += time.perf_counter() - t0
    print(json.dumps({"phase": "analytics_total", "graphs_s": graphs_s,
                      "refs_s": refs_s, "kernels_s": kernels_s,
                      "waves_s": waves_s, "store_events": ev,
                      "s": time.perf_counter() - t_phase}), flush=True)
    return launches


def kind_refs_main(sync: int = KIND_QUERIES["sync"],
                   pipelined: int = KIND_QUERIES["pipelined"],
                   workers: int = KIND_REF_WORKERS) -> int:
    """Phase 13's host references alone, nothing else running: the gnp
    graph of phase 3 and phase 11's grid, the typed queries of waves of
    ``sync`` and ``pipelined`` queries, ``workers`` processes; prints
    :func:`refs_report` and the wall. ``python3 -c 'import chip_smoke;
    chip_smoke.kind_refs_main(1000, 300)'`` from the root of a checkout
    (no card needed)."""
    t0 = time.perf_counter()
    n = 1 << 20
    edges = gnp_random_graph(n, 8 / n, seed=7)
    pairs = canonical_pairs(n, edges)
    csr = build_csr(n, pairs=pairs)
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as ref_dir:
        t0 = time.perf_counter()
        prep = kind_prep(n, pairs, csr, ref_dir, workers=workers,
                         sizes={"sync": sync, "pipelined": pipelined})
        prep_s = time.perf_counter() - t0
        for fut in prep["refs"].values():
            fut.result()
        print(json.dumps({"phase": "kind_refs_alone", "sync": sync,
                          "pipelined": pipelined, "graph_s": build_s,
                          "prep_s": prep_s, **refs_report(prep),
                          "cores": os.cpu_count(),
                          "wall_s": time.perf_counter() - t0}), flush=True)
        prep["pool"].shutdown()
    return 0


def shard_main(profile_only: bool = False) -> int:
    """Phases 14 and 15 alone, at full size, on every card there is (four
    for NCCL, else one shared): ``python3 -c 'import chip_smoke, sys;
    sys.exit(chip_smoke.shard_main())'`` from the root of a checkout.
    ``profile_only`` builds gnp alone and runs its exchange and
    profiles (the phase's ``sharded_exchange`` and ``sharded_profile``
    lines) on the ranks, nothing else."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    print(json.dumps({"phase": "build", "nvcc_s": _cuda.build(),
                      "total_s": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    gnp, rmat = shard_graphs(with_rmat=not profile_only)
    print(json.dumps({"phase": "shard_graphs",
                      "s": time.perf_counter() - t0}), flush=True)
    if profile_only:
        from bibfs_tpu_torch.parallel.mesh import launch
        from bibfs_tpu_torch.solvers import sharded as sh

        s, d = gnp["pairs"][0]
        jobs = [dict(kind="exchange", graph="gnp")] + [
            dict(kind="profile", graph="gnp", src=s, dst=d, mode=mode,
                 repeats=5) for mode in SHARD_PROFILED]
        out = launch(sh.sharded_jobs, SHARD_RANKS, {"gnp": gnp["host"]},
                     jobs, timeout_s=600)
        print(json.dumps({"phase": "sharded_exchange",
                          "geometry": gnp["name"], "ranks": SHARD_RANKS,
                          **out["results"][0]}), flush=True)
        for mode, ranks in zip(SHARD_PROFILED, out["results"][1:]):
            print(json.dumps({"phase": "sharded_profile",
                              "geometry": gnp["name"], "mode": mode,
                              "transport": out["transport"], "ranks": ranks}),
                  flush=True)
        return 0
    results = {name: {} for name in SHARD_KERNELS}
    with tempfile.TemporaryDirectory(prefix="chip-mesh-") as mesh_dir:
        shard_phase(gnp, rmat, results, save_dir=mesh_dir)
        print(json.dumps({"kernels_sharded": results}), flush=True)
        mesh = mesh_phase(gnp, os.path.join(mesh_dir, "gnp"))
    print(json.dumps({"kernels_mesh": mesh}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    laps: dict = {}  # each phase's seconds, in the order they ran
    t_lap = [t_start]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # phase 11's NumPy references, computed beside phases 1-10
    ref_dir = tempfile.TemporaryDirectory()
    host_ref = multiprocessing.get_context("spawn").Process(
        target=host_sweeps, args=(ref_dir.name,), daemon=True)
    host_ref.start()
    # phase 4's rmat-s20 host graph, built beside phases 1-8
    rmat_dir = tempfile.TemporaryDirectory()
    rmat_proc = multiprocessing.get_context("spawn").Process(
        target=rmat_prep, args=(rmat_dir.name,), daemon=True)
    rmat_proc.start()

    # phase 1: build
    t0 = time.perf_counter()
    build_s = _cuda.build()
    print(json.dumps({"phase": "build", "nvcc_s": build_s,
                      "total_s": time.perf_counter() - t0}), flush=True)
    for name, log in _cuda.build_logs().items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")):
                print(f"ptxas {name}: {line.strip()}")
    lap("1 build")

    # the main-path graph: G(2^20, 8/2^20), plain ELL
    t0 = time.perf_counter()
    n = 1 << 20
    edges = gnp_random_graph(n, 8 / n, seed=7)
    pairs_all = canonical_pairs(n, edges)
    csr = build_csr(n, pairs=pairs_all)
    gnp_host = build_ell(n, pairs=pairs_all)  # kept for phase 14's ranks
    g = dense.DeviceGraph.from_ell(gnp_host, dev)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "graph", "name": "gnp-deg8-s20", "n": n,
                      "edges": int(edges.shape[0]), "width": g.width,
                      "build_s": time.perf_counter() - t0}), flush=True)
    # phase 13's inputs and its host references, computed beside phases 1-12
    t0 = time.perf_counter()
    kind_dir = tempfile.TemporaryDirectory()
    kinds = kind_prep(n, pairs_all, csr, kind_dir.name)
    print(json.dumps({"phase": "query_kinds_prep",
                      "s": time.perf_counter() - t0,
                      "references": len(kinds["refs"])}), flush=True)
    lap("graph and phase 13 prep")

    # phase 2: kernels against their plain versions
    results: dict = {}
    kernel_phase(g, seed=11, results=results, geometry="gnp-deg8-s20",
                 time_pull=True)
    n_small = 3001  # a row count that is a multiple of no block
    e_small = gnp_random_graph(n_small, 3.0 / n_small, seed=5)
    g_small = dense.DeviceGraph.build(n_small, e_small, device=dev)
    kernel_phase(g_small, seed=12, results=None, geometry="gnp-3001",
                 time_pull=False)
    # the batch-minor level at the batch geometries, both instantiations
    bpairs = batch_pairs(np.random.default_rng(17), n, csr, BATCH)
    minor_kernel_phase(g, "gnp-deg8-s20", 21, results, bpairs)
    minor_kernel_phase(g_small, "gnp-3001", 22, None)
    del g_small
    # ELL rows wider than the 32 table slots the level kernel stages
    g_hubs = dense.DeviceGraph.build(n_small, hub_edges(n_small, 6), device=dev)
    check(g_hubs.width > 32, "the hub graph has no wide rows")
    minor_kernel_phase(g_hubs, "hubs-3001", 23, None)
    del g_hubs
    # the least time any launch takes: an empty kernel between two events
    floor_ms = time_launch(lambda: torch.cuda._sleep(0))
    print(json.dumps({"phase": "kernels_vs_plain", "ok": True,
                      "launch_floor_ms": floor_ms}), flush=True)
    lap("2 kernels")

    # phase 3: the main path
    rng = np.random.default_rng(7)
    pairs = seeded_pairs(rng, np.arange(n), 8)
    want = oracle(n, csr, pairs)
    reset_counts()
    drive(g, csr, pairs, want,
          ["sync", "alt", "beamer", "pallas", "pallas_alt", "fused", "fused_alt"],
          [("sync", "pallas", "fused"), ("alt", "pallas_alt", "fused_alt")],
          repeats=5)
    for s, d in pairs:
        check(same_raw(raw(g, s, d, "fused", 1), raw(g, s, d, "fused", 8)),
              f"fused unroll 1 != unroll 8 on {s}->{d}")
    main_counts = counts()
    print(json.dumps({"phase": "main_path_launches", **main_counts}), flush=True)
    for name in KERNELS:
        check(main_counts[name] > 0, f"kernel {name} was not launched on the main path")
    lap("3 main path")

    # phase 5: the batched search on the main-path graph, 256 queries
    reset_counts()
    raws = batch_drive(g, csr, bpairs, "gnp-deg8-s20", ["minor8", "minor", "auto"],
                       "fused")
    batch_counts = counts()
    print(json.dumps({"phase": "batch_launches", **batch_counts}), flush=True)
    for name in MINOR:
        check(batch_counts[name] > 0, f"kernel {name} was not launched by the batches")
    check(same_batch(raws["minor8"], raws["minor"], n),
          "minor8 (decoded) differs from minor")
    check(same_batch(raws["auto"], raws["minor8"], n), "auto differs from minor8")
    del raws
    torch.cuda.empty_cache()
    lap("5 batches")

    # phase 9: the lock-step batch of the per-query modes, 256 queries
    lockstep_kernel_phase(g, "gnp-deg8-s20", results)
    reset_counts()
    lockstep_drive(g, csr, bpairs, "gnp-deg8-s20", LOCKSTEP_MODES, k_check=32)
    lockstep_counts = counts()
    print(json.dumps({"phase": "lockstep_launches", **lockstep_counts}), flush=True)
    for name in LOCKSTEP:
        check(lockstep_counts[name] > 0,
              f"kernel {name} was not launched by the lock-step batches")
    sweep_phase(g, bpairs, "gnp-deg8-s20")
    tail_phase(g, bpairs, "gnp-deg8-s20")
    lap("9 lock-step")

    # phase 7: the serving engine on the main-path graph
    engine_phase(g, n, edges, pairs_all, csr)
    lap("7 engine")

    # phase 8: the pipelined engine on the main-path graph
    pipeline_phase(n, edges, pairs_all, csr)
    lap("8 pipelined")

    # phase 4: tiered RMAT scale 20
    del g
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # kept for phase 14's ranks
    n2, e2_count, csr2, rmat_host, child_s, wait_s = rmat_load(
        rmat_proc, rmat_dir.name)
    g2 = dense.DeviceGraph.from_tiered(rmat_host, dev)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "graph", "name": "rmat-s20-ef16", "n": n2,
                      "edges": e2_count, "width": g2.width,
                      "child_build_s": child_s, "wait_s": wait_s,
                      "tiers": [list(m) for m in g2.tier_meta],
                      "build_s": time.perf_counter() - t0}), flush=True)
    # the kernels against their plain versions at the tiered base table
    kernel_phase(g2, seed=13, results=None, geometry="rmat-s20-ef16",
                 time_pull=True)
    print(json.dumps({"phase": "kernels_vs_plain_tiered", "ok": True}),
          flush=True)
    linked = np.flatnonzero(np.diff(csr2[0]) > 0)
    pairs2 = seeded_pairs(np.random.default_rng(7), linked, 8)
    want2 = oracle(n2, csr2, pairs2)
    reset_counts()
    rows = drive(g2, csr2, pairs2, want2, ["sync", "pallas", "pallas_alt", "fused"],
                 [("sync", "pallas", "fused")], repeats=3)
    check(rows[-1]["ran"] == ["pallas"], "tiered fused did not run as pallas")
    tier_counts = counts()
    print(json.dumps({"phase": "tiered_launches", **tier_counts}), flush=True)
    for name in ("pull_dual", "pull_single"):
        check(tier_counts[name] > 0, f"kernel {name} not launched on the tiered path")
    routing_phase(g2, csr2, pairs2, want2)
    # the lock-step kernel modes on the tiered graph: kernels 3 and 4 with
    # a query axis and the rebuild of their plane after each tier pass
    pairs64 = batch_pairs(np.random.default_rng(67), n2, csr2, 64)
    pairs64[2:] = np.random.default_rng(67).choice(linked, size=(62, 2))
    reset_counts()
    lockstep_drive(g2, csr2, pairs64, "rmat-s20-ef16", ["pallas", "pallas_alt"],
                   k_check=64)
    tl_counts = counts()
    print(json.dumps({"phase": "tiered_lockstep_launches", **tl_counts}),
          flush=True)
    for name in LOCKSTEP:
        check(tl_counts[name] > 0,
              f"kernel {name} was not launched by the tiered lock-step batches")
    lap("4 rmat-s20")

    # phase 6: tiered batches at RMAT scale 17 (the largest scale of the
    # family whose tiers the minor layout admits), and the int8 refill
    del g2
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n3, e3 = rmat_graph(17, edge_factor=16, seed=7)
    p3 = canonical_pairs(n3, e3)
    csr3 = build_csr(n3, pairs=p3)
    g3 = dense.DeviceGraph.build(n3, e3, layout="tiered", device=dev, pairs=p3)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "graph", "name": "rmat-s17-ef16", "n": n3,
                      "edges": int(e3.shape[0]), "width": g3.width,
                      "tiers": [list(m) for m in g3.tier_meta],
                      "build_s": time.perf_counter() - t0}), flush=True)
    linked3 = np.flatnonzero(np.diff(csr3[0]) > 0)
    pairs3 = batch_pairs(np.random.default_rng(19), n3, csr3, BATCH)
    pairs3[2:] = np.random.default_rng(19).choice(linked3, size=(BATCH - 2, 2))
    batch_drive(g3, csr3, pairs3, "rmat-s17-ef16", ["minor"], "sync")
    del g3
    refill_phase(dev)
    lap("6 rmat-s17")

    # phase 10: the blocked tile route
    torch.cuda.empty_cache()
    blocked_launches = blocked_phase(dev, results)
    lap("10 blocked")

    # phase 11: the graph store and the distance oracle
    torch.cuda.empty_cache()
    store_launches = store_and_oracle_phase(csr, results, host_ref,
                                            ref_dir.name)
    ref_dir.cleanup()
    lap("11 store")

    # phase 12: the durable store, its crash and its respawn
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    durable = durable_phase(n, pairs_all, csr)
    print(json.dumps({"phase": "durable_total", "s": time.perf_counter() - t0}),
          flush=True)
    respawn = durable["respawn"]
    lap("12 durable")

    # phase 13: the query kinds
    torch.cuda.empty_cache()
    kind_launches = query_kinds_phase(kinds, results=results)
    kind_dir.cleanup()
    lap("13 query kinds")

    # phase 14: the vertex-sharded search and the data-parallel batch
    torch.cuda.empty_cache()
    mesh_dir = tempfile.TemporaryDirectory(prefix="chip-mesh-")
    gnp = dict(host=gnp_host, name="gnp-deg8-s20", n=n, csr=csr, pairs=pairs,
               want=want, tiered=False, edges=edges, pairs_all=pairs_all)
    shard_launches = shard_phase(
        gnp,
        dict(host=rmat_host, name="rmat-s20-ef16", n=n2, csr=csr2,
             pairs=pairs2, want=want2, tiered=True),
        results, save_dir=mesh_dir.name)
    lap("14 sharded")

    # phase 15: serving from a rank pool, the 2D search, checkpoints
    torch.cuda.empty_cache()
    mesh = mesh_phase(gnp, os.path.join(mesh_dir.name, "gnp"))
    mesh_dir.cleanup()
    rmat_dir.cleanup()
    lap("15 mesh")
    checks = mesh["checks"]

    # phase 16: whole-graph analytics
    torch.cuda.empty_cache()
    analytics_launches = analytics_phase(results=results)
    lap("16 analytics")

    kernels = []
    for name, (_w, _p, source, replaces) in KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=main_counts[name],
                            launches_sharded=shard_launches.get(name, 0),
                            launches_mesh=mesh["launches"].get(name, 0),
                            **({"mesh_ranks": [c[name] for c in checks]}
                               if name in SHARD_KERNELS else {}),
                            **results[name], library_ms=None,
                            launch_floor_ms=floor_ms))
    for name, (_mode, source, replaces) in MINOR.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=batch_counts[name],
                            launches_durable=respawn[name],
                            launches_data_parallel=shard_launches.get(name, 0),
                            launches_mesh=mesh["launches"].get(name, 0),
                            mesh_ranks=[r for c in checks
                                        for r in c.get(name, [])],
                            **results[name], library_ms=None,
                            launch_floor_ms=floor_ms))
    for name, (_w, _p, source, replaces) in LOCKSTEP.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=lockstep_counts[name],
                            launches_durable=respawn[name],
                            **results[name], library_ms=None,
                            launch_floor_ms=floor_ms))
    for name, (source, replaces, history) in BLOCKED_KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, **history,
                            launches=blocked_launches[name], **results[name],
                            library_ms=None, launch_floor_ms=floor_ms))
    kernels.append(dict(name="msbfs_sweep", route="cuda", source=MSBFS[0],
                        replaces=MSBFS[1], **MSBFS[2],
                        launches=store_launches["msbfs_sweep"],
                        launches_durable_checkpoint=durable["build"][
                            "msbfs_sweep"],
                        launches_durable=respawn["msbfs_sweep"],
                        **results["msbfs_sweep"], launch_floor_ms=floor_ms))
    for name, (source, replaces) in QUERY_KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=kind_launches[name],
                            **results[name], launch_floor_ms=floor_ms))
    for name, (_w, source, replaces) in ANALYTICS_KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=analytics_launches[name],
                            **results[name], launch_floor_ms=floor_ms))
    print(json.dumps({"phase": "done", "total_s": time.perf_counter() - t_start,
                      "phases_s": laps}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
