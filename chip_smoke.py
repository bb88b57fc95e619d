#!/usr/bin/env python3
"""Drive every path of the port on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--n-log2 24]

The paths: HACC in-situ halo finding, the halo products (most-bound
centers and SO masses), ArborX's neighbor lists, the adjacency-graph
DBSCAN, the grid DBSCAN, the eps-pairwise ops, the query engine's
other predicates (IntersectsBox, all-hits rays) and trees (box leaves,
30-bit codes) with its stack backend and generic callbacks, and the pair
traversal's DBSCAN and correlation and DenseBox, the sharded halo
pipeline (distributed FDBSCAN, the catalog merge, the span tracer) on an
in-process mesh of shards of the card, and the nearest family (kNN,
EMST, MLS interpolation, nearest-hit ray casting) on the nearest kernel,
and the in-situ training mode: xlstm-350m trained at full width and depth
under the supervisor through a fault, with embedding clustering on the
traversal and segment kernels, and served; attention, the dense FFN and
MoE: deepseek-moe-16b served at full size and trained at full width with
router clustering on its own routers, gemma2-9b served an 8192-token
prompt at full size; Mamba, cross-attention and the encoder: one group
of jamba-1.5-large served at full width (and an 8192-token prompt),
llama-3.2-vision-11b served at full size, seamless-m4t-v2 trained at full
size with the in-situ analysis and served; the dry run's plan
(sharding rules, meshes, memory per device, op counts) held against
what the card measures; the static checks (the op audits, host syncs
held to the card's own sync warnings) and the example twins; and the
scale-safety interpreter (index widths, precision and bounds at a
symbolic N of 1e9), on the card as on the CPU.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit. Phases, each of which must pass:

1. Build the kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, started together) and print ``-Xptxas -v``, the card's name
   and its power limit. The all-pairs tile kernel must spill nothing, and
   its SASS (``cuobjdump -sass``) and its prologue's hold no ``FFMA``,
   ``HMMA`` or ``HGMMA``. No instance of the traversal kernel (and not its
   pack prologue, nor DenseBox's scan-record prologue, nor either instance
   of the SO count's kernel) may spill,
   none but POTENTIAL may hold an ``FFMA``, and
   POTENTIAL must hold as many as a probe kernel that holds only its IEEE
   1/sqrt sequence (both counts printed), and HISTOGRAM as many as a
   probe holding only its bin sequence (an IEEE square root and
   division); each traversal instance,
   POTENTIAL, the counter instance of COUNT, the box and ray
   instances on point and box leaves, EDGE, HISTOGRAM, DenseBox's two and
   MIN_LABEL's int64 instance included, must read its node and
   box-leaf records with 128-bit loads (``LDG.E.128``); their registers
   and counts of 128-bit and narrower ``LDG`` are printed. No instance of the stencil kernel (and neither of
   its two prologues) may hold an ``FFMA``; their registers and spills
   are printed. Every ``FMUL`` and ``FADD`` of the stencil and all-pairs
   kernels must carry ``.FTZ`` (``pairwise.cu`` flushes subnormals as
   XLA:CPU does). No instance of the segment kernel may spill or hold an
   atomic (``ATOM``/``RED``: its sums are combined in a fixed order), and
   its D = 8 and D = 1 instances must read with 128-bit loads (or
   ``LDGSTS`` copies). No instance of the nearest kernel (KNN, EMST,
   RAY) may hold an ``FFMA``; their registers, stack frames, spills and
   128-bit loads are printed.
2. Each kernel against its plain PyTorch version on the card: the
   traversal's node records (``pack_tree``, bit for bit) and its
   epilogues (COUNT, MIN_LABEL, FILL at an exact capacity, at
   half of it and with int64 offsets, FIXED with overflowing and ample
   buffers) on a tree of 2^20 clustered points (exact), MIN_LABEL over
   int64 labels offset by 2^32 (bit-equal to its plain version and to the
   int32 instance's result plus 2^32), POTENTIAL (bit
   for bit, with an active mask), the counter instance of COUNT (all six
   rows, counts equal to COUNT's) and every instance from random start
   nodes, a quarter of them ``SENTINEL``, on the same tree, COUNT with a
   radius per query (4096 queries, radii up to 2 eps, timed against its
   plain version for phase 9's SO rows) and the SO count's kernel on the
   same queries (equal to COUNT and to its plain version, its counters'
   hops and far tests to the plain walk's), and POTENTIAL's 1/sqrt sequence
   on 2^24 positive floats against its plain version; every box and ray
   instance (COUNT with and without early exit, its counters, FILL with
   int32 and int64 offsets, FIXED) and spheres on box leaves, on the
   same tree and on a box-leaf tree of its points' eps-boxes, with
   2^14 boxes (a quarter degenerate) and 2^12 rays (axis-aligned ones,
   components in (-1e-12, 0), origins on leaf-box faces), from the root
   and from random start nodes, bit for bit, each kind against one plain
   walk (FIXED's with the counter rows, the queries twice in one lockstep,
   from the root and from the start nodes, whose rows and counts give
   COUNT's, FILL's and FIXED's plain outputs), and on the box-leaf tree a
   random sample of 2^12 boxes and
   spheres and 2^10 rays (kernel and plain walk on the same sample); the
   segment
   reductions at the catalog's shapes, 2^24 x 8 and 2^24 x 1, on the
   catalog's shape of ids (360,001 runs: 300,000 of 2-9 rows, 60,000 of
   Pareto sizes, one of 300,000 rows, then a neutral tail of a fifth of
   the rows; sums within the bound of two summation orders with the
   count column exact, maxima exact, each bit-equal over two calls); the
   stencil kernels and their slot-class prologue on 2^21 uniform points
   in 128^3 eps-cells at capacities 16 and 48, every slot, and the all-pairs
   kernels at m x n = 1 x 5000, 129 x 257 and 3001 x 5003 for d = 1, 3,
   64, 100 and 257, at 300 x 70,000
   (candidates split across blocks) and at exact ties, eps2 the plain
   version's own d2 of chosen pairs (all bit-exact); EDGE at capacities
   1, 2 and 8 for a random parent and core mask, HISTOGRAM at 16 bins
   and 2 eps from the pair start nodes, its bin sequence on 2^24 squared
   distances (bin edges and subnormals included), and DenseBox's two on
   its trees of the 2^20 points at min_pts 2 and 5 (cell and point
   leaves, exactly the dense cells' run heads and the loose points; cells
   taken whole and scanned; the query order a permutation; their scan
   records with and without labels), all bit for bit; the stencil and all-pairs kernels on inputs with subnormal coordinates,
   products and differences, at eps2 = 0 and above; the nearest kernel on
   the 2^20 tree, bit for bit with its pops: KNN at k = 1, 4, 16 and 40
   (past the local-memory buffer) for 2^16 sampled particles and 2^12
   uniform points, EMST from singleton components and from 64 random
   ones for 2^16 sampled particles, RAY for 2^11 skewers on the point
   tree and on a tree of the particles' eps-boxes.
3. The card against the plain path on the CPU: the in-situ step at 2^15
   particles (labels, core mask, rounds and the catalog's integer fields
   exact, float fields to a stated tolerance); at 2^14, ``query_csr``
   exact, ``query_csr_device`` at half the total, ``query_csr_buffered``
   from capacity 8 and ``dbscan_graph_cc``, all exact; ``fdbscan_grid``
   and ``fdbscan_grid_auto`` (from capacity 2) at 2^15 uniform points,
   and ``eps_neighbor_counts``/``eps_min_label`` at 2^12 x 64, all exact;
   at 2^14 ``fdbscan(use_64bit=False)``, ``fdbscan(use_stack=True,
   early_stop=False)``, ``query_count(backend="stack", with_stats=True)``
   and the generic ``query`` with the quickstart's index-sum callback,
   exact (the generic query launches no kernel); ``fdbscan_pair``
   (capacity 8), ``fdbscan_densebox`` and ``pair_count_histogram`` (2 eps)
   at 2^15 Plummer particles, exact, and ROADMAP C9's four points, where
   the reference's DenseBox wraps, equal to ``fdbscan``; on 4 shards of
   the card against 4 shards of the CPU at 2^14 slab-sorted Plummer
   particles, ``halo_pipeline_sharded`` (int64 ids): labels, core mask,
   rounds, overflow and catalog integers exact (floats to a stated
   tolerance), and ``dbscan_distributed`` at int32 and int64 ids on the
   card equal to the CPU pipeline's labels, core mask, rounds and
   overflow; at 2^14 Plummer particles ``knn`` (k = 16, self), ``emst``
   (edges, weights, rounds), ``raycast`` and ``raycast_all`` (2^10
   skewers on the eps-box tree) bit for bit, and ``mls_interpolate`` (k =
   8, 2^12 uniform targets) within 1e-5 + 8 cond 2^-24, cond each
   target's Gram matrix's condition number; the LM stack at smoke size
   (xlstm-350m's ``smoke()``, float32, TF32 off) on the card against the
   same weights on the CPU: ``train_loss`` and every gradient leaf, five
   ``train_step``s (parameters, losses), ``prefill`` plus two
   ``decode_step``s (the same tokens, logits close) and the in-situ
   embedding statistics from the same sampled rows and projection (the
   same integers), each within the tolerance stated in ``phase3_lm``;
   and the six architectures of attention, the dense FFN and MoE
   (gemma2-9b, phi3-medium-14b, codeqwen1.5-7b, granite-20b,
   deepseek-moe-16b, qwen3-moe-235b-a22b) and the three of Mamba,
   cross-attention and the encoder (jamba-1.5-large, llama-3.2-vision-11b,
   seamless-m4t-v2, their frontends' embeddings from one seeded draw) at
   ``smoke()``: ``train_loss`` with its aux loss and every gradient leaf
   (Mamba's backward runs on the card only here), ``prefill`` and two
   decode steps (logits and caches: KV slots, Mamba's state and conv
   window, the cross layers' memory K/V) on the card against the CPU,
   within the tolerances stated in ``phase3_attention_archs``.
4. The main path: ``InsituAnalyzer`` in simulation mode over two analysis
   steps of 2^24 particles (4096 Plummer spheres plus 20% background).
   The launch counters are set to 0 before each step and read after it;
   every kernel must have launched in each step. The step's time and peak
   memory are the path's own; the kernels' inputs for phase 9 are recorded
   afterwards, in an untimed rerun of the second step.
5. Neighbor lists at full size, on phase 4's cloud and eps: ``query_csr``
   exact (counters set to 0 before it: COUNT 1, FILL 1), then
   ``query_csr_device`` at half the total with no host synchronisation
   (``torch.cuda.set_sync_debug_mode("error")``), int64 offsets, the whole
   fill once through its plain version, and ``query_csr_buffered`` from
   capacity 32, each against the exact result.
6. ``dbscan_graph_cc`` on phase 4's generator at the largest power of two
   n <= 2^24 whose run fits in 60 GB of device memory, with the neighbor
   capacity at the smallest power of two at or above the largest count;
   its labels and core mask must equal ``fdbscan``'s on the same points.
7. Grid DBSCAN at full size: 2^24 uniform points in the unit cube, eps =
   2^-8 (the mean spacing, 256^3 cells), ``min_pts = 5``:
   ``fdbscan_grid_auto`` from capacity 4, then ``fdbscan_grid`` at the
   capacity it found, timed, with stencil_count 1 and stencil_min_label
   rounds + 1 launches; the same run on the points of the cube's first
   octant (2^21 points, 128^3 cells: the plain stencils take about a
   minute over the whole grid) with the kernels and with the plain
   stencil versions in their place, whose labels, core mask and rounds
   must be the kernels' own; both kernels against their plain versions at the path's
   own inputs, timed as the path runs them (one slot-class mask shared by
   the launches) and with the mask made per launch, with the pair and
   class tests they make; and the grid's counts against the exact
   ``fdbscan`` counts, every difference explained by pairs inside the
   rounding band of the grid's distance formula.
8. The all-pairs ops at full size: 2^16 points in d = 64 from 64 Gaussian
   clusters, eps the 1% quantile of the pairwise distances of a 512-row
   sample; ``eps_neighbor_counts`` then ``eps_min_label`` (core = counts
   >= 5), each kernel against its plain version, with the issue floor of
   the exact order (pair tests x (2d + 4) FP32 instructions over the SMs'
   128 lanes a clock at the card's top SM clock) and the kernel's share of
   it.
10. The halo products on phase 4's generator, eps and ``InsituConfig``
   (run before phase 9's line): ``fdbscan``, ``halo_catalog``, one tree,
   then in one ``shared_pack`` ``most_bound_centers`` at 2 eps and
   ``so_masses`` (Delta = 200, r_max = 0.1) on the most-bound centers of
   the slots with ``count > 0``, each timed with its peak memory;
   counters set to 0 before them, POTENTIAL 1 launch, the SO count 22 and
   COUNT none; every most-bound particle a member of its halo; POTENTIAL
   against its plain version on every 16th member, bit for bit; each of
   the 22 SO launches bit-equal to COUNT (the rope walk it replaced) on
   its inputs and timed against it in one call (COUNT, SO, SO, COUNT),
   with its hops, longest chain of dependent hops and far tests from its
   counter instance; the first and the last SO launch's 256 valid halos
   with the most hops through its plain version on a CPU copy of the
   tree, with equal counts, hops and far tests; the SO counts of 64
   sampled halos at R_Delta and at r_max against a brute-force count
   with the kernel's distance formula; the bracketed share and the
   median distance from most-bound particle to centre of mass; and one
   launch of COUNT's counter instance at the final SO radii, its largest
   and 99th-percentile ``nodes_visited`` and its time against COUNT's,
   beside the SO count's counters on the same queries.
11. The query engine at 2^24 on phase 4's cloud and eps (run before
   phase 9's line), each step with its seconds, peak memory and launches
   by instance (counters set to 0 before it): ``build_bvh`` over 30-bit
   and 63-bit codes and Table 1's counts (points sharing a code, the
   largest run), ``fdbscan(use_64bit=False)`` == ``fdbscan()``;
   IntersectsBox eps-cubes with ``query_count`` (each count >= the
   sphere's, 64 sampled against brute force), with counters,
   ``query_csr`` (each row holds the sphere's row) and
   ``query_csr_buffered`` from 32 (== ``query_csr``); a tree of the
   particles' eps-boxes (``build_bvh_objects``) and 2^20 skewers with
   ``query_count`` and ``query_csr``, 64 sampled rows against a
   brute-force slab test over all boxes and their t sums from the generic
   ``query`` bit for bit (no counter moves); spheres of radius 0 ==
   degenerate boxes on that tree; rays from particles on the point tree;
   the stack rungs ``fdbscan(use_stack=True)`` with and without early
   exit at the largest power of two that finishes in 60 s, labels ==
   ``fdbscan``'s (torch ops, no kernel). Every new (predicate, leaf)
   instance of COUNT, and FILL and FIXED on the box and ray paths, must
   have launched.
12. The pair traversal and DenseBox on phase 4's cloud and eps at 2^24
   (run before phase 9's line), each step with its seconds, peak memory
   and launches by instance: ``fdbscan``, ``fdbscan_pair(edge_capacity=8)``
   and ``fdbscan_densebox``, whose labels and core mask must equal
   ``fdbscan``'s (both rounds, the grid's cell count and its largest run,
   DenseBox's m tree leaves against n, and its seconds by stage printed:
   grid, tree, count, union rounds, border); ``pair_count_histogram`` at r_max = 4 eps over 16 bins, whose
   total must equal (the sum of ``query_count(within(p, 4 eps))`` - n) / 2.
14. The nearest family at full width on phase 4's cloud and eps (run
   before phase 9's line), each call with its seconds, peak memory and
   launches (counters set to 0 before it): ``knn`` self-query at k = 16
   (one launch; the sets equal a brute force (every squared distance,
   then ``topk``) on 4,096 sampled queries wherever the 16th and 17th
   squared distances are more than 1e-6 apart, relative); ``emst`` (n - 1 edges forming one union-find
   component; a launch a round; one round's component intervals timed);
   ``mls_interpolate`` (k = 8) onto 2^20 uniform targets, 1,024 of them
   against a float64 solve within 1e-5 + 8 cond 2^-24; ``raycast`` of
   phase 11's 2^20 skewers on its tree of eps-boxes, each hit the least
   slab t of its ``raycast_all`` row and each miss an empty row. Phase 9
   gets a row for each instance (``nearest_knn``, ``nearest_other_component``
   at the third round's components, ``nearest_ray``) with its pops, the
   bound's operations per pop, registers, stack frame and its plain time
   on a sample named in ``plain_input``.
15. The in-situ training mode at full width and depth (run before phase
   9's line), through the port's entry points: ``repro_torch.launch.train``'s
   ``main`` trains xlstm-350m, 3.4e8 parameters (``count_params`` within
   5% of 0.34e9) in bf16 with float32 moments, on ``SyntheticTokens`` at
   batch 8 x 128 tokens for 12 steps under its supervisor, running
   ``InsituAnalyzer(mode="training")`` every 5: once uninterrupted (each
   step timed by the supervisor; one checkpoint, at the end), once
   checkpointing every 5 with a fault injected at step 7 through its
   ``fault_hook``. The resumed
   run's state must equal the uninterrupted run's bit for bit, its
   analyses repeat the uninterrupted run's, and the mean loss of the last
   5 steps be below the first 5's. The hook reads the launch counters
   and sets them to 0 before each step: COUNT, MIN_LABEL and both segment
   kernels must launch in every analysis and none outside one; each
   analysis is timed by its fenced ``insitu`` span. Then the embedding
   statistics with 80% of the rows collapsed onto row 0 (the clustered
   fraction must rise), ``router_cluster_stats`` on a seeded router tree
   of deepseek-moe-16b's shape (27, 2048, 64) (finite), and serving:
   ``repro_torch.launch.serve``'s ``main`` prefills 4 prompts of 32 tokens
   into a 48-slot cache and decodes to 16 tokens (bf16, timed on its
   second call), and at float32 on the trained weights the last of 16
   decode steps' logits against the full forward over the 48 tokens
   within the reference test's tolerance. Printed with the card: the
   median train step in ms and tokens/s, each analysis in ms with its
   launches, prefill ms, decode ms a step and peak memory.
16. Attention, the dense FFN and MoE at full width through the port's
   entry points (run before phase 9's line): (a) ``launch.serve``'s
   ``main`` serves deepseek-moe-16b at full size, 1.64e10 parameters
   (``count_params`` within 5% of 16.4e9) in bf16, 4 prompts of 32 tokens
   decoded to 16, timed on its second call, with the bytes bound of a
   decode step; (b) at float32, full width, 2 groups plus layer 0 and
   no-drop capacity, the last of 16 decode steps' logits against the
   full forward over the 48 tokens within the reference test's
   tolerance; (c) ``launch.train``'s ``main`` (``config=`` 4 groups plus
   layer 0, full width, 2.9e9 parameters, bf16 with float32 moments)
   trains 10 steps at batch 8 x 128 with ``InsituAnalyzer(mode=
   "training")`` every 5 clustering the trained routers: the loss must
   fall, the aux loss stay finite, and COUNT, MIN_LABEL and both segment
   kernels launch in every analysis and in none outside one; (d)
   gemma2-9b (9.24e9 parameters, bf16) serves one 8192-token prompt
   (the blockwise path, the 4096-token window, softcaps, sandwich norms,
   GeGLU, GQA 16/8) decoded 16 tokens past it, and on one ``attn_local``
   and one ``attn`` layer at 8192 tokens the blockwise path agrees with
   ``_sdpa`` and its full mask within 1e-2 norm-relative. Printed with
   the card: prefill, decode ms a step, the train step, each analysis
   with its launches, peak memory.
17. Mamba, cross-attention and the encoder at full width through the
   port's entry points (run after phase 16, before phase 9's line): (a)
   ``launch.serve``'s ``main(config=)`` serves jamba-1.5-large cut to one
   group (8 layers: attention, 7 Mamba, 4 MoE) and 8 experts, 2.59e10
   parameters (``count_params`` within 1%), in bf16: one group at its
   published 16 experts is 4.52e10 parameters, 90.5 GB, more than the
   card holds, and the full model 3.99e11. 4 prompts of 32 tokens decoded
   to 16, timed on its second call, with the bytes bound of a decode step,
   then one 8192-token prompt (32 chunks of 256) decoded 16 tokens past
   it; (b) at float32, the last of 16 decode steps' logits against the
   full forward over the 48 tokens within the reference test's tolerance
   for jamba (one group, 2 experts with no-drop capacity, ``ssm_chunk``
   16 so that the tokens run as 3 chunks; 1.14e10 parameters),
   llama-3.2-vision-11b (one group of 5 layers with its cross layer) and
   seamless-m4t-v2 at full size; (c) llama-3.2-vision-11b serves at full
   size (9.81e9 parameters, bf16, 1601 x 7680 vision embeddings a
   request), 4 prompts of 32 tokens decoded to 16, with the decode's
   bytes bound; (d) ``launch.train``'s ``main`` trains seamless-m4t-v2 at
   full size (1.67e9 parameters, bf16 with float32 moments) 10 steps at
   batch 8 x 128 tokens plus 1024 frames of 1024, running
   ``InsituAnalyzer(mode="training")`` every 5, one checkpoint at the
   end: the loss must fall and COUNT, MIN_LABEL and both segment kernels
   launch in every analysis and in none outside one; then 4 prompts are
   served on the trained weights. Jamba's training needs more than one
   card (one group at 8 experts is 3.1e11 bytes of state), so Mamba's
   backward runs on the card only in phase 3. Printed with the card:
   prefill, decode ms a step with its bound, the train step in ms and
   tokens/s, each analysis with its launches, peak memory.
18. The sharding rules, the meshes and the dry run's plan against the
   card (run after phase 17, before phase 9's line; reads phases 15-17's
   records): ``make_host_mesh()`` is a (1, 1) NCCL ``DeviceMesh`` on the
   card; every xlstm-350m parameter placed by ``param_placements`` with
   ``distribute_tensor`` comes back bit-equal through ``to_local()``;
   ``memory_model``'s ``params`` at phase 15's shape equals the bytes of
   the bf16 parameters phase 15 trained; ``op_cost`` counts one
   xlstm-350m train step (the dry run's ``build_cell`` at batch 8 x 32)
   on ``meta`` and on the card, with equal FLOPs; every (arch x
   ``shapes_for`` x single/multi) cell of the plan computes at the
   card's ``total_memory``, one line each (``fits_hbm``, GB a device,
   the plan's dominant term). Printed beside them: the plan's total
   against phases 15-17's measured peaks, and the model FLOPs of phases
   15 and 17's train steps as TFLOP/s and their share of 989.
19. The static checks on the card (run after phase 18, before phase 9's
   line): every registered op audit of ``repro_torch.staticcheck`` at its
   full size returns no finding; each audited call's host syncs, as the
   dispatch rule counts them, equal the card's warnings under
   ``torch.cuda.set_sync_debug_mode("warn")`` op by op and stay within
   the allowance the registry counts from the code's loops, and the calls
   allowed none (``query_csr_device``, the wavefront backend,
   ``eps_neighbor_counts``) run clean under ``"error"``; one in-situ step
   of phase 4's cloud under the trace, its host syncs by op, source line
   and stage held to the card's warnings, its largest intermediate
   against n^2; the example twins' ``main`` (galaxy finding, distributed
   halo finding on 8 shards, the quickstart), and galaxy finding at full
   size on phase 4's cloud.
20. The scale-safety interpreter on the card (run after phase 19, before
   phase 9's line): every registered absint audit and seeded fixture of
   ``repro_torch.staticcheck.absint_registry`` on the card and on the CPU,
   with the same findings on both (rule, op and, for W1, the interval),
   the registered audits clean with no unknown op and each fixture firing
   exactly its rule; ``fdbscan`` on phase 4's 2^24-point cloud analysed
   at a symbolic N of 1e9, clean, with its ops, values, seconds and peak
   memory; and ``python -m repro_torch.staticcheck --absint`` on the card
   (its ``main``) returning 0.
9. One JSON line with each kernel's launches on its path, time per launch
   at that path's inputs, bound with the card's name and power limit
   beside it, plain version's time and library yardstick. The traversal
   rows add their hops, hops per second, the time of one pack of the tree
   (in ``ms`` for FILL and FIXED, whose paths pack at each launch; not for
   COUNT and MIN_LABEL, which share ``fdbscan``'s one pack) and the
   instance's registers; the stencil rows their pair and class tests,
   tests per second, the time of the slot-class prologue alone (shared by
   ``fdbscan_grid``'s launches, so not in ``ms``) and registers; the
   segment rows their share of the bound, whether a second call gave the
   same bits, and the instance's registers and 128-bit loads. Phase 10
   adds ``wavefront_potential`` (its hits and the bound's operations per
   hit), ``wavefront_count_so_mass`` (the 22 launches of the SO count,
   ``wavefront_sphere_count``: mean ms and bound per launch, COUNT's mean
   ms in the same turns, and each launch's ms, COUNT's ms, hops, longest
   chain and far tests, its bytes the packed records, spans and right
   children it reads, and its plain version's time on the heaviest halos
   of the first and last launch) and
   ``wavefront_count_stats`` (with COUNT's time at the same inputs);
   their plain times are taken on a part of the input, named in
   ``plain_input``. Phase 11 adds a row for each instance on its path
   (COUNT, its counters, FILL and FIXED for IntersectsBox on points;
   COUNT and FILL for rays on box leaves; COUNT for spheres and boxes on
   box leaves and rays on points), with its ``ops_per_hop`` and its plain
   time on a part of the input. Phase 12 adds ``wavefront_edge``,
   ``wavefront_histogram``, ``wavefront_dense_count`` and
   ``wavefront_dense_min_label`` at their first launch's inputs there,
   with hops and, for DenseBox, the cells taken whole, the cells scanned
   and the points scanned (the bound's operations) and its tree's m
   leaves, the plain version over every query (HISTOGRAM: over 2^12 of
   them). Phase 13 adds
   ``wavefront_min_label_int64`` at the inputs of its first launch there,
   with the int32 instance's time on the same inputs and the plain
   version over every query of the launch.
13. The sharded halo pipeline at full width (run before phase 9's line):
   phase 4's cloud and eps, sorted by x and cut into 4 slabs, on 4 shards
   of the card (``ShardMesh(4, "cuda")``), the ghost buffer (``halo_cap``)
   set from the points within eps of each slab face; each step with its
   seconds, peak memory and launches by instance (counters set to 0
   before it): ``fdbscan``; ``dbscan_distributed`` at int32 and int64 ids,
   whose labels and core mask must equal ``fdbscan``'s with no halo
   overflow (rounds and ghost rows per shard printed; MIN_LABEL's int64
   instance must have launched); ``halo_pipeline_sharded`` without SO,
   whose catalog integers must equal the single-device ``halo_catalog``'s
   (floats within rtol 1e-4); ``halo_pipeline_traced`` under a
   ``SpanTracer`` (equal to it), then one in-situ step of phase 4's cloud
   stage by stage under the same tracer (labels == ``fdbscan``'s); each
   span's seconds printed and the Chrome trace written to
   ``build/phase13_trace.json``; ``sharded_neighbor_csr``, whose total
   must equal ``query_csr``'s on the whole cloud; and at 2^20,
   ``halo_pipeline_sharded`` with SO masses (Delta = 200, r_max = 0.1),
   equal to ``so_masses`` on one tree around its centers.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the port beside this file, it exits nonzero and prints no
result. It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import importlib
import contextlib
import itertools
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
DEV = "cuda"

# H100 SXM data sheet: HBM rate and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Float operations per node visit of the traversal: per axis two
# subtractions and two maxes, then three products, two sums, one compare.
FLOPS_PER_HOP = 3 * 4 + 3 + 2 + 1
# Operations per POTENTIAL hit besides the hop: an add (d2 + soft2), the
# square root, the reciprocal and a subtraction.
OPS_PER_POTENTIAL_HIT = 4
# Drift time step: the typical core velocity moves a particle by about a
# quarter of the linking length.
DT = 1e-3
OVERDENSITY = 1e4
SPHERES_AT_2_24 = 4096
# scikit-learn DBSCAN's default min_samples, the point itself counted.
GRID_MIN_PTS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def plummer_cloud(seed: int, n: int):
    """Positions and velocities of ``n`` particles: Plummer spheres with
    Pareto(1.5) masses (the generator of ``examples/halo_catalog.py``, all
    spheres drawn at once), plus 20% uniform background at rest.

    Each sphere's scale radius puts its central density at OVERDENSITY
    times the mean of the unit box, so a core particle has about 200
    neighbours within the paper's linking length. The number of spheres
    scales with n (4096 at 2^24), which keeps the spheres' sizes."""
    rng = np.random.default_rng(seed)
    n_spheres = max(16, SPHERES_AT_2_24 * n >> 24)
    n_bg = n // 5
    w = rng.pareto(1.5, n_spheres) + 1
    sizes = rng.multinomial(n - n_bg, w / w.sum())
    centers = rng.uniform(0.1, 0.9, (n_spheres, 3))
    a_s = (3.0 * sizes / (4.0 * np.pi * OVERDENSITY * n)) ** (1.0 / 3.0)
    a = np.repeat(a_s, sizes)
    mtot = np.repeat(sizes / n, sizes)        # G = 1, unit total mass
    u = rng.uniform(0.02, 0.98, a.size)
    r = a / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    direction = rng.standard_normal((a.size, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    pos = np.repeat(centers, sizes, axis=0) + r[:, None] * direction
    sigma2 = mtot / (6.0 * np.sqrt(r ** 2 + a ** 2))
    vel = rng.standard_normal((a.size, 3)) * np.sqrt(sigma2)[:, None]
    pos = np.concatenate([pos, rng.uniform(0, 1, (n_bg, 3))])
    vel = np.concatenate([vel, np.zeros((n_bg, 3))])
    pos = np.clip(pos, 0.0, 1.0 - 1e-6).astype(np.float32)
    return pos, vel.astype(np.float32), n - n_bg


def sm_clock_hz() -> float:
    """The card's top SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def tap(module, name: str, calls: list, keep_args: bool = True,
        every: bool = False, last: bool = False):
    """Record (args, kwargs, result) of the first call of ``module.name``
    (of every call with ``every``, of only the latest with ``last``); with
    ``keep_args=False`` only its result, the arguments as None."""
    fn = getattr(module, name)

    def recorded(*args, **kwargs):
        res = fn(*args, **kwargs)
        rec = (args, kwargs, res) if keep_args else (None, None, res)
        if last:
            calls[:] = [rec]
        elif every or not calls:
            calls.append(rec)
        return res

    setattr(module, name, recorded)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def exclusive_scan(torch, counts, dtype):
    """CSR offsets (q+1,) of ``dtype`` from per-query counts."""
    return torch.cat([torch.zeros(1, dtype=dtype, device=counts.device),
                      torch.cumsum(counts, 0, dtype=dtype)])


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def ptxas_report(text: str) -> dict:
    """{mangled kernel: {"registers", "stack_frame", "spill_stores",
    "spill_loads"}} from an ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes "
                                      r"spill stores, (\d+) bytes spill loads",
                                      line)):
            out[name]["stack_frame"] = int(m.group(1))
            out[name]["spill_stores"] = int(m.group(2))
            out[name]["spill_loads"] = int(m.group(3))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


SASS_OPS = ("FFMA", "HMMA", "HGMMA", "FMUL", "FADD", "ATOM", "ATOMG", "ATOMS",
            "RED", "LDGSTS")
# FP32 multiplies and adds without the flush-to-zero modifier.
NO_FTZ = "FMUL/FADD without .FTZ"
ATOMIC_OPS = ("ATOM", "ATOMG", "ATOMS", "RED")


def sass_counts(so: Path) -> dict:
    """{mangled kernel: {opcode: count}} over ``SASS_OPS`` in the SASS of
    the shared library ``so``, its global loads split into 128-bit
    ones ("LDG.128") and narrower ones ("LDG.other"), and its FMUL and
    FADD instructions that lack ``.FTZ`` (``NO_FTZ``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name = {}, None
    pattern = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = dict.fromkeys(SASS_OPS + ("LDG.128", "LDG.other", NO_FTZ), 0)
        elif name and "/*" in line:
            instr = line.split(";")[0]
            for op in pattern.findall(instr):
                out[name][op] += 1
            out[name][NO_FTZ] += len(re.findall(r"\b(?:FMUL|FADD)(?!\.FTZ)\b(?!\.)",
                                                instr)) + len(re.findall(
                r"\b(?:FMUL|FADD)\.(?!FTZ)", instr))
            if m := re.search(r"\bLDG((?:\.\w+)*)", instr):
                out[name]["LDG.128" if ".128" in m.group(1) else "LDG.other"] += 1
    return out


def kernel_report(source: str, tags: dict) -> dict:
    """{key: {"registers", "spill_stores", "spill_loads", "sass"}} of the
    kernels of ``csrc/<source>.cu`` whose mangled names hold ``tags[key]``,
    from the build's ``-Xptxas -v`` log and ``cuobjdump -sass``."""
    from repro_torch.kernels import _build
    ptxas = ptxas_report(_build.build_log(source))
    sass = sass_counts(_build.BUILD_DIR / f"{source}.so")
    out = {}
    for key, tag in tags.items():
        pt = [v for k, v in ptxas.items() if tag in k]
        ss = [v for k, v in sass.items() if tag in k]
        require(len(pt) == 1 and len(ss) == 1, f"{key}: one kernel named {tag}")
        out[key] = {**pt[0], "sass": ss[0]}
    return out


def tile_kernel_report():
    """Registers, spills and SASS opcode counts of the all-pairs kernels,
    keyed by epilogue ("pairwise_count": COUNT, "pairwise_min_label":
    MIN_LABEL; "pairwise_norms": the prologue both launch). Fails if a
    tile kernel spills or any of them holds an FFMA, HMMA or HGMMA, or an
    FMUL or FADD without ``.FTZ`` (``pairwise.cu`` flushes subnormals as
    XLA:CPU does, ROADMAP C7)."""
    out = kernel_report("pairwise", {
        "pairwise_count": "pairwise_tile_kernelILi0E",
        "pairwise_min_label": "pairwise_tile_kernelILi1E",
        "pairwise_norms": "pairwise_norms_kernel"})
    for key, rep in out.items():
        bad = {op: rep["sass"][op] for op in ("FFMA", "HMMA", "HGMMA", NO_FTZ)
               if rep["sass"][op]}
        require(not bad, f"{key}: SASS holds {bad}")
        if key != "pairwise_norms":
            require(rep["spill_stores"] == rep["spill_loads"] == 0,
                    f"{key}: ptxas reports spills {rep}")
    return out


# The traversal template's instances (epilogue, predicate, box leaves,
# offset type, counters), its pack prologue, DenseBox's kernel and its
# scan-record prologue, and the probe that holds only
# POTENTIAL's 1/sqrt sequence, by a tag of their mangled names.
PREDICATE_IDS = {"sphere": 0, "box": 1, "ray": 2}
# The (predicate, leaf kind) pairs that B1 (a)-(c) added; spheres on point
# leaves were there before.
NEW_KINDS = (("box", "point"), ("box", "box"), ("ray", "point"),
             ("ray", "box"), ("sphere", "box"))


def wave_tag(epi: int, pred: str = "sphere", leaf: str = "point",
             off: str = "i", stats: bool = False) -> str:
    return (f"wavefront_kernelILi{epi}ELi{PREDICATE_IDS[pred]}"
            f"ELb{int(leaf == 'box')}E{off}Lb{int(stats)}EE")


WAVEFRONT_KERNELS = {"wavefront_count": wave_tag(0),
                     "wavefront_count_stats": wave_tag(0, stats=True),
                     "wavefront_min_label": wave_tag(1),
                     "wavefront_min_label64": wave_tag(9),
                     "wavefront_fill": wave_tag(2),
                     "wavefront_fill_int64": wave_tag(2, off="x"),
                     "wavefront_fixed": wave_tag(3),
                     "wavefront_potential": wave_tag(4),
                     "wavefront_edge": wave_tag(5),
                     "wavefront_histogram": wave_tag(10),
                     "wavefront_histogram_shared": wave_tag(6),
                     "wavefront_dense_count": "dense_kernelILi7EE",
                     "wavefront_dense_min_label": "dense_kernelILi8EE",
                     "wavefront_sphere_count": "sphere_count_kernelILb0E",
                     "wavefront_sphere_count_stats": "sphere_count_kernelILb1E",
                     "wavefront_pack": "pack_kernel",
                     "wavefront_dense_records": "dense_records_kernel",
                     "rsqrt_probe": "rsqrt_probe_kernel",
                     "bin_probe": "bin_probe_kernel",
                     "histogram_edges": "histogram_edges_kernel",
                     "threshold_probe": "threshold_probe_kernel"}
for _pred, _leaf in NEW_KINDS:
    _k = f"{_pred}_{_leaf}"
    WAVEFRONT_KERNELS.update({
        f"wavefront_count_{_k}": wave_tag(0, _pred, _leaf),
        f"wavefront_count_stats_{_k}": wave_tag(0, _pred, _leaf, stats=True),
        f"wavefront_fill_{_k}": wave_tag(2, _pred, _leaf),
        f"wavefront_fill_int64_{_k}": wave_tag(2, _pred, _leaf, off="x"),
        f"wavefront_fixed_{_k}": wave_tag(3, _pred, _leaf)})
del _pred, _leaf, _k


def wavefront_report():
    """Registers, spills, SASS opcode and load counts of every instance of
    the traversal kernel, of its pack prologue, of DenseBox's kernel and
    its record prologue, of the histogram's thresholds prologue and of the
    probes.
    Fails if one spills; if a kernel other than POTENTIAL, the histogram's
    IEEE-bin instance (past PRIVATE_HISTOGRAM_BINS) and the thresholds
    prologue holds an FFMA (a contracted multiply-add would round the
    distance otherwise than the plain version); if one of those holds
    another number of FFMAs than its probe, whose only FFMAs are those of
    the IEEE sequence (the 1/sqrt's, or the bin's square root and
    division; so their distances have none either); if the private-bin
    histogram instance holds a shared-memory atomic (``ATOMS``); or if a
    traversal instance has fewer than two 128-bit loads (the halves of an
    internal node's record, and of a box leaf's; with fewer, records would
    be read in pieces)."""
    out = kernel_report("wavefront", WAVEFRONT_KERNELS)
    probes = {"wavefront_potential": "rsqrt_probe",
              "wavefront_histogram_shared": "bin_probe",
              "histogram_edges": "bin_probe"}
    for key, rep in out.items():
        require(rep["spill_stores"] == rep["spill_loads"] == 0,
                f"{key}: ptxas reports spills {rep}")
        ffma = rep["sass"]["FFMA"]
        if key in probes:
            probe_ffma = out[probes[key]]["sass"]["FFMA"]
            require(ffma == probe_ffma, f"{key}: {ffma} FFMA, its IEEE "
                    f"sequence alone ({probes[key]}) has {probe_ffma}")
            log(f"[1] {key}: {ffma} FFMA, the probe holding only its IEEE "
                f"sequence {probe_ffma}")
        elif key not in probes.values():
            require(ffma == 0, f"{key}: SASS holds an FFMA")
        if key not in ("wavefront_pack", "wavefront_dense_records", "histogram_edges",
                       "threshold_probe", *probes.values()):
            require(rep["sass"]["LDG.128"] >= 2,
                    f"{key}: fewer than two 128-bit loads {rep['sass']}")
    private = out["wavefront_histogram"]
    require(private["sass"]["ATOMS"] == 0,
            f"wavefront_histogram (private bins): SASS holds ATOMS {private['sass']}")
    log(f"[1] wavefront_histogram (private bins): {private['registers']} registers, "
        f"spills {private['spill_stores']}/{private['spill_loads']}, "
        f"{private['sass']['FFMA']} FFMA, {private['sass']['ATOMS']} ATOMS, "
        f"{private['sass']['LDG.128']} LDG.E.128; the thresholds prologue "
        f"{out['histogram_edges']['registers']} registers, "
        f"{out['histogram_edges']['sass']['FFMA']} FFMA")
    return out


# The stencil kernel's instances (epilogue; coordinates in registers for
# D <= 4, or read at each use) and its two prologues.
STENCIL_KERNELS = {"stencil_count": "eps_kernelILi0ELb1E",
                   "stencil_count_wide": "eps_kernelILi0ELb0E",
                   "stencil_min_label": "eps_kernelILi1ELb1E",
                   "stencil_min_label_wide": "eps_kernelILi1ELb0E",
                   "stencil_classes": "real_mask_kernel",
                   "stencil_pad_min": "pad_min_kernel"}


def stencil_report():
    """Registers, spills and SASS opcode counts of every instance of the
    stencil kernel and of its prologues. Fails if one holds an FFMA (a
    contracted multiply-add would round d2 otherwise than the plain
    version) or an FMUL or FADD without ``.FTZ``."""
    out = kernel_report("pairwise", STENCIL_KERNELS)
    for key, rep in out.items():
        require(rep["sass"]["FFMA"] == 0, f"{key}: SASS holds an FFMA")
        require(rep["sass"][NO_FTZ] == 0,
                f"{key}: SASS holds an FMUL or FADD without .FTZ")
    return out


# The segment kernel's instances: (sum or max) x (D = 8 and D = 1 with
# 16-byte loads, or any width at run time with scalar loads).
SEGMENT_KERNELS = {"segment_sum_d8": "segment_kernelILi0ELi8ELb1E",
                   "segment_sum_d1": "segment_kernelILi0ELi1ELb1E",
                   "segment_sum_scalar": "segment_kernelILi0ELi0ELb0E",
                   "segment_max_d8": "segment_kernelILi1ELi8ELb1E",
                   "segment_max_d1": "segment_kernelILi1ELi1ELb1E",
                   "segment_max_scalar": "segment_kernelILi1ELi0ELb0E"}


def segment_report():
    """Registers, spills and SASS opcode counts of every instance of the
    segment kernel. Fails if one spills or holds an atomic (the design
    combines partials in a fixed order, so a sum would lose its
    reproducibility), or if a 16-byte-load instance has no 128-bit load
    (or ``LDGSTS`` copy)."""
    out = kernel_report("segment", SEGMENT_KERNELS)
    for key, rep in out.items():
        require(rep["spill_stores"] == rep["spill_loads"] == 0,
                f"{key}: ptxas reports spills {rep}")
        atomics = {op: rep["sass"][op] for op in ATOMIC_OPS if rep["sass"][op]}
        require(not atomics, f"{key}: SASS holds atomics {atomics}")
        if not key.endswith("scalar"):
            require(rep["sass"]["LDG.128"] + rep["sass"]["LDGSTS"] > 0,
                    f"{key}: no 128-bit load {rep['sass']}")
    return out


def phase1_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[1] built {sorted(logs)} in {time.perf_counter() - t0:.1f} s "
        f"into {_build.BUILD_DIR}")
    for name, text in logs.items():
        log(f"--- nvcc -Xptxas -v: {name}.cu ---\n{text.strip()}")
    tiles, wave = tile_kernel_report(), wavefront_report()
    stencil, seg = stencil_report(), segment_report()
    for key, rep in {**tiles, **wave, **stencil, **seg}.items():
        log(f"[1] {key}: {rep['registers']} registers, spills "
            f"{rep['spill_stores']}/{rep['spill_loads']} bytes, SASS {rep['sass']}")
    near = nearest_report()
    card = card_identity()
    log(f"[1] card: {card}")
    return card, tiles, wave, stencil, seg, near


def phase2_kernels(seed: int, n_tree: int = 1 << 20, n_rows: int = 1 << 24):
    """Phase 2's traversal and segment checks; returns the per-query-radii
    times of :func:`phase2_traversal_options`."""
    import torch
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.kernels import segment as ks
    from repro_torch.kernels import wavefront as kw

    n = n_tree
    pos, _, _ = plummer_cloud(seed + 1, n)
    pts = torch.from_numpy(pos).to(DEV)
    bvh = build_bvh(pts, *scene_bounds(pts))
    eps = hacc_benchmark_epsilon(1.0, n)
    r2 = torch.full((n,), eps, dtype=torch.float32, device=DEV) ** 2
    order = bvh.leaf_perm
    got, want = kw.pack_tree(bvh), kw.pack_tree_plain(bvh)
    for f in got._fields:
        require(torch.equal(getattr(got, f).view(torch.int32),
                            getattr(want, f).view(torch.int32)), f"pack_tree {f}")
    log(f"[2] pack_tree: {n - 1} internal and {n} leaf records bit-equal "
        f"to the plain version")
    for stop in (None, 2):
        got = kw.wavefront_count(bvh, pts, r2, stop_at=stop, order=order)
        want = kw.wavefront_count_plain(bvh, pts, r2, stop)
        require(torch.equal(got, want), f"wavefront_count stop_at={stop}")
        log(f"[2] wavefront_count stop_at={stop}: exact over {n} queries, "
            f"mean count {got.float().mean().item():.2f}")
    core = kw.wavefront_count(bvh, pts, r2, stop_at=2, order=order) >= 2
    labels = torch.from_numpy(
        np.random.default_rng(seed + 2).permutation(n).astype(np.int32)).to(DEV)
    got = kw.wavefront_min_label(bvh, pts, r2, labels, core, core, n, order=order)
    want = kw.wavefront_min_label_plain(bvh, pts, r2, labels, core, core, n)
    require(torch.equal(got, want), "wavefront_min_label")
    log(f"[2] wavefront_min_label: exact over {int(core.sum())} core queries")
    # B1 (e): int64 labels whose high word matters.
    wide = labels.long() + (1 << 32)
    got64 = kw.wavefront_min_label(bvh, pts, r2, wide, core, core, n + (1 << 32),
                                   order=order)
    want64 = kw.wavefront_min_label_plain(bvh, pts, r2, wide, core, core,
                                          n + (1 << 32))
    require(got64.dtype == torch.int64 and torch.equal(got64, want64),
            "wavefront_min_label over int64 labels")
    require(torch.equal(got64, got.long() + (1 << 32)),
            "the int64 instance == the int32 instance + 2^32")
    log(f"[2] wavefront_min_label over int64 labels (+2^32): bit-equal to its "
        f"plain version and to the int32 instance's result + 2^32")

    counts = kw.wavefront_count(bvh, pts, r2, order=order)
    for dtype, cut in ((torch.int32, 1), (torch.int32, 2), (torch.int64, 1)):
        offsets = exclusive_scan(torch, counts, dtype)
        cap = int(offsets[-1]) // cut
        got = kw.wavefront_fill(bvh, pts, r2, offsets, cap, order=order)
        want = kw.wavefront_fill_plain(bvh, pts, r2, offsets, cap)
        require(torch.equal(got, want),
                f"wavefront_fill {dtype} offsets, capacity total/{cut}")
        log(f"[2] wavefront_fill, {dtype} offsets, capacity {cap} "
            f"(total {int(offsets[-1])}): exact")
    largest = int(counts.max())
    for cap in (16, 1 << (largest - 1).bit_length()):
        got = kw.wavefront_fixed(bvh, pts, r2, cap, order=order)
        want = kw.wavefront_fixed_plain(bvh, pts, r2, cap)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"wavefront_fixed capacity {cap}")
        log(f"[2] wavefront_fixed capacity {cap} (largest count {largest}): "
            f"exact")
    del got, want, counts
    small = phase2_traversal_options(seed, bvh, pts, r2, eps, order, n_rows)
    phase2_predicates(seed, bvh, pts, eps)
    pair_kernel_checks(seed, bvh, pts, eps)
    phase2_nearest(seed, bvh, pts, eps)

    rows, segs = n_rows, 1 << 20
    ids, tail = catalog_ids(seed + 3, rows)
    rng = np.random.default_rng(seed + 4)
    ids_t = torch.from_numpy(ids).to(DEV)
    data = torch.from_numpy(rng.standard_normal((rows, 8), np.float32)).to(DEV)
    data[:, 0] = 1.0                          # the count column
    data[-tail:] = 0.0
    got = ks.segment_sum_sorted(data, ids_t, segs)
    want = ks.segment_sum_sorted_plain(data, ids_t, segs)
    tol = sum_tolerance(torch, data, ids_t, segs)
    diff = (got - want).abs()
    require(bool((diff <= tol).all()), "segment_sum")
    require(torch.equal(got[:, 0], want[:, 0]), "segment_sum count column")
    again = ks.segment_sum_sorted(data, ids_t, segs)
    require(torch.equal(again.view(torch.int32), got.view(torch.int32)),
            "segment_sum: two calls differ")
    log(f"[2] segment_sum_sorted {rows}x8 on {int(ids[-1]) + 1} catalog-shaped "
        f"runs: max abs err {diff.max().item():.3g} "
        f"({(diff / tol.clamp(min=1e-30)).max().item():.3g} of the bound), "
        f"counts exact, two calls bit-equal")
    del data, got, want, again, tol, diff
    vals = torch.from_numpy(rng.standard_normal((rows, 1), np.float32)).to(DEV)
    vals[-tail:] = -ks.SEG_NEG_BIG
    vals[torch.from_numpy(rng.random(rows) < 0.1).to(DEV)] = -ks.SEG_NEG_BIG
    got = ks.segment_max_sorted(vals, ids_t, segs)
    want = ks.segment_max_sorted_plain(vals, ids_t, segs)
    require(torch.equal(got, want), "segment_max")
    require(torch.equal(ks.segment_max_sorted(vals, ids_t, segs).view(torch.int32),
                        got.view(torch.int32)), "segment_max: two calls differ")
    log(f"[2] segment_max_sorted {rows}x1 (mixed signs): exact, two calls "
        f"bit-equal")
    return small


def bits_equal(torch, a, b) -> bool:
    """Same shape and the same bits (float32 and bfloat16 compared as the
    integers of their width)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype in ints:
        a, b = a.view(ints[a.dtype]), b.view(ints[a.dtype])
    return torch.equal(a, b)


def phase2_traversal_options(seed, bvh, pts, r2, eps, order, n_values):
    """POTENTIAL, the counter instance and start nodes against their plain
    versions on phase 2's tree, the 1/sqrt sequence on ``n_values``
    positive floats, and COUNT with a radius per query, whose kernel and
    plain times phase 9's rows of the SO path report (the plain version
    cannot walk the SO path at full size)."""
    import torch
    from repro_torch.core.query import node_depths
    from repro_torch.kernels import wavefront as kw

    n = pts.shape[0]
    rng = np.random.default_rng(seed + 5)
    bits = rng.integers(1, 0x7F800000, n_values, dtype=np.int64).astype(np.int32)
    x = torch.from_numpy(bits).to(DEV).view(torch.float32)
    seq = kw.inv_sqrt_rn(x)
    require(bits_equal(torch, seq, kw.inv_sqrt_plain(x)), "1/sqrt sequence")
    differ = (torch.rsqrt(x).view(torch.int32) != seq.view(torch.int32)).float().mean()
    log(f"[2] 1/sqrt: the kernel's __frcp_rn(__fsqrt_rn(x)) == inv_sqrt_plain "
        f"on {n_values} positive floats (normal and subnormal); torch.rsqrt "
        f"differs from it on a share {differ.item():.4g}")
    del x, seq

    active = torch.from_numpy(rng.random(n) < 0.75).to(DEV)
    soft2 = float(np.float32(eps * 1e-2) ** 2)
    got = kw.wavefront_potential(bvh, pts, r2, soft2, active, order=order)
    want = kw.wavefront_potential_plain(bvh, pts, r2, soft2, active)
    require(bits_equal(torch, got, want), "wavefront_potential")
    log(f"[2] wavefront_potential: bit-equal over {int(active.sum())} active "
        f"queries of {n}, mean {got[active].mean().item():.6g}")

    depths = node_depths(bvh)
    for stop in (None, 2):
        got, stats = kw.wavefront_count(bvh, pts, r2, stop_at=stop, order=order,
                                        depths=depths)
        want, want_stats = kw.wavefront_count_plain(bvh, pts, r2, stop,
                                                    depths=depths)
        require(torch.equal(got, want) and torch.equal(stats, want_stats),
                f"wavefront_count with counters, stop_at={stop}")
        require(torch.equal(got, kw.wavefront_count(bvh, pts, r2, stop_at=stop,
                                                    order=order)),
                f"counts with and without counters, stop_at={stop}")
        log(f"[2] wavefront_count with counters, stop_at={stop}: counts and "
            f"the six rows exact; totals {stats.sum(1, dtype=torch.int64).tolist()}")

    start = torch.from_numpy(rng.integers(0, 2 * n - 1, n).astype(np.int32)).to(DEV)
    start[torch.from_numpy(rng.random(n) < 0.25).to(DEV)] = -1
    got = kw.wavefront_count(bvh, pts, r2, order=order, start=start, depths=depths)
    want = kw.wavefront_count_plain(bvh, pts, r2, None, start, depths)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "COUNT with counters from start nodes")
    counts = got[0]
    labels = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(DEV)
    got = kw.wavefront_min_label(bvh, pts, r2, labels, active, active, n,
                                 order=order, start=start)
    require(torch.equal(got, kw.wavefront_min_label_plain(
        bvh, pts, r2, labels, active, active, n, start)),
        "MIN_LABEL from start nodes")
    offsets = exclusive_scan(torch, counts, torch.int64)
    total = int(offsets[-1])
    got = kw.wavefront_fill(bvh, pts, r2, offsets, total, order=order, start=start)
    require(torch.equal(got, kw.wavefront_fill_plain(bvh, pts, r2, offsets, total,
                                                     start)),
            "FILL from start nodes")
    got = kw.wavefront_fixed(bvh, pts, r2, 16, order=order, start=start)
    want = kw.wavefront_fixed_plain(bvh, pts, r2, 16, start)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "FIXED from start nodes")
    got = kw.wavefront_potential(bvh, pts, r2, soft2, active, order=order,
                                 start=start)
    require(bits_equal(torch, got, kw.wavefront_potential_plain(
        bvh, pts, r2, soft2, active, start)), "POTENTIAL from start nodes")
    log(f"[2] start nodes ({int((start == -1).sum())} of {n} SENTINEL): COUNT "
        f"with counters, MIN_LABEL, FILL ({total} hits), FIXED and POTENTIAL "
        f"exact")
    del got, want, counts, labels, offsets, start

    q = 4096
    sel = torch.from_numpy(rng.choice(n, q, replace=False)).to(DEV)
    centers = pts[sel].contiguous()
    radii = torch.from_numpy(rng.uniform(0, 2 * eps, q).astype(np.float32)).to(DEV)
    rq2 = radii * radii
    got = kw.wavefront_count(bvh, centers, rq2)
    ms = cuda_ms(torch, lambda: kw.wavefront_count(bvh, centers, rq2), 3)
    want, plain_ms = timed_once(torch, lambda: kw.wavefront_count_plain(
        bvh, centers, rq2))
    require(torch.equal(got, want), "COUNT with a radius per query")
    # The SO count's kernel on the same queries: COUNT's counts, its plain
    # version's, and its counters' hops and far tests those of the plain
    # walk (every node tested once).
    sphere = kw.wavefront_sphere_count(bvh, centers, rq2)
    require(torch.equal(sphere, want), "the SO count == COUNT, a radius per query")
    sphere_ms = cuda_ms(torch, lambda: kw.wavefront_sphere_count(bvh, centers, rq2), 3)
    (plain_cnt, plain_st), sphere_plain_ms = timed_once(
        torch, lambda: kw.wavefront_sphere_count_plain(bvh, centers, rq2,
                                                      with_stats=True))
    cnt, st = kw.wavefront_sphere_count(bvh, centers, rq2, with_stats=True)
    require(torch.equal(sphere, plain_cnt) and torch.equal(cnt, sphere)
            and torch.equal(st[0], plain_st[0]) and torch.equal(st[2], plain_st[2]),
            "the SO count and its counters against its plain version")
    log(f"[2] the SO count ({q} queries, radii up to 2 eps): == COUNT and its "
        f"plain version, counters' hops and far tests == the plain walk's "
        f"({int(st[0].sum())} hops, longest chain {int(st[1].max())}); kernel "
        f"{sphere_ms:.4f} ms, plain {sphere_plain_ms:.1f} ms")
    del sphere, plain_cnt, plain_st, cnt, st
    got = kw.wavefront_count(bvh, centers, rq2, depths=depths)
    stats_ms = cuda_ms(torch, lambda: kw.wavefront_count(bvh, centers, rq2,
                                                         depths=depths), 3)
    want, stats_plain_ms = timed_once(torch, lambda: kw.wavefront_count_plain(
        bvh, centers, rq2, depths=depths))
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "counters with a radius per query")
    small = {"plain_input": f"phase 2: {q} points of the {n}-point cloud as "
                            f"centres, radii uniform in [0, 2 eps]",
             "ms_at_plain_input": ms, "plain_ms": plain_ms,
             "stats_ms_at_plain_input": stats_ms,
             "stats_plain_ms": stats_plain_ms,
             "sphere_ms_at_plain_input": sphere_ms,
             "sphere_plain_ms": sphere_plain_ms}
    log(f"[2] COUNT with a radius per query ({q} queries, radii up to 2 eps): "
        f"exact, counters exact; kernel {ms:.4f} ms (with counters "
        f"{stats_ms:.4f}), plain {plain_ms:.1f} ms ({stats_plain_ms:.1f})")
    return small


def skewers(torch, seed: int, m: int, lo, hi, pts):
    """``m`` rays through the cloud (lines of sight): origins uniform on
    the scene's low-z face aimed at uniform points of its high-z face;
    1/16 of them along z exactly, from under a random particle; 1/64 with
    an x component in (-1e-12, 0), whose inverse is +inf. Returns
    (origins, directions) float32 on the card."""
    rng = np.random.default_rng(seed)
    lo, hi = lo.cpu().numpy(), hi.cpu().numpy()
    o = rng.uniform(lo, hi, (m, 3)).astype(np.float32)
    o[:, 2] = lo[2]
    target = rng.uniform(lo, hi, (m, 3)).astype(np.float32)
    target[:, 2] = hi[2]
    d = target - o
    axis = np.arange(0, m, 16)
    under = pts[torch.from_numpy(rng.integers(0, pts.shape[0], axis.size))
                .to(pts.device)].cpu().numpy()
    o[axis, :2] = under[:, :2]
    d[axis] = (0.0, 0.0, 1.0)
    tiny = np.arange(1, m, 64)
    d[tiny, 0] = -rng.uniform(0, 1e-12, tiny.size).astype(np.float32)
    return torch.from_numpy(o).to(DEV), torch.from_numpy(d).to(DEV)


# Phase 2's sample on the box-leaf tree, whose walks are the longest:
# boxes and spheres, and rays.
Q_BOX_ON_BOXES = 1 << 12
Q_RAY_ON_BOXES = 1 << 10


def phase2_predicates(seed, bvh, pts, eps, q_box: int = 1 << 14,
                      q_ray: int = 1 << 12):
    """B1 (a)-(c) on the card against the plain versions, bit for bit:
    COUNT (with and without early exit), its counter instance, FILL
    (int32 offsets at the exact capacity, int64 at half) and FIXED for
    boxes (up to 4 eps wide, a quarter degenerate) and rays (from points
    of the cloud's box in random directions, a quarter along z, 1/64 with
    a component in (-1e-12, 0), some from particles and from leaf-box
    faces) on phase 2's point tree and on a box-leaf tree of its points'
    eps-boxes, and spheres on the box-leaf tree; from the root and from
    random start nodes, a quarter of them SENTINEL. A plain walk lasts as
    long as its longest query's (one torch iteration a hop), so the query
    counts are small and each plain run is held against several kernel
    outputs: COUNT with early exit against the saturated plain counts, the
    exact FILL against FIXED's plain rows, wide enough for every hit. On
    the box-leaf tree, whose walks are the longest, the kinds run on a
    random sample of the queries (``Q_BOX_ON_BOXES`` boxes and spheres,
    ``Q_RAY_ON_BOXES`` rays; kernel and plain version on the same sample,
    every sampled query bit for bit)."""
    import torch
    tq = importlib.import_module("repro_torch.core.query")
    from repro_torch.core.bvh import build_bvh_objects
    from repro_torch.core.geometry import safe_inv, scene_bounds
    from repro_torch.kernels import wavefront as kw

    n = pts.shape[0]
    lo, hi = scene_bounds(pts)
    trees = {"point": bvh, "box": build_bvh_objects(pts - eps, pts + eps, lo, hi)}
    got, want = kw.pack_tree(trees["box"]), kw.pack_tree_plain(trees["box"])
    require(got.leaves.shape == (n, 8) and all(
        torch.equal(getattr(got, f).view(torch.int32),
                    getattr(want, f).view(torch.int32)) for f in got._fields),
        "pack_tree of the box-leaf tree")
    rng = np.random.default_rng(seed + 21)
    sel = torch.from_numpy(rng.choice(n, q_box, replace=False)).to(DEV)
    half = torch.from_numpy(rng.uniform(0, 2 * eps, (q_box, 3))
                            .astype(np.float32)).to(DEV)
    blo, bhi = pts[sel] - half, pts[sel] + half
    blo[: q_box // 4] = bhi[: q_box // 4] = pts[sel[: q_box // 4]]
    lo_np, hi_np = lo.cpu().numpy(), hi.cpu().numpy()
    o = rng.uniform(lo_np, hi_np, (q_ray, 3)).astype(np.float32)
    d = rng.standard_normal((q_ray, 3)).astype(np.float32)
    d[::4] = (0.0, 0.0, 1.0)
    d[1::64, 0] = -rng.uniform(0, 1e-12, d[1::64].shape[0]).astype(np.float32)
    o, d = torch.from_numpy(o).to(DEV), torch.from_numpy(d).to(DEV)
    k = torch.from_numpy(rng.integers(0, n, q_ray)).to(DEV)
    o[2::5] = pts[k[2::5]]                      # from a particle
    o[3::5] = pts[k[3::5]] - eps                # from a leaf box's low corner
    d[3::10, 0] = -3e-13
    geo = {"box": (blo.contiguous(), bhi.contiguous()),
           "ray": (o, safe_inv(d)),
           "sphere": (pts[sel].contiguous(),
                      torch.full((q_box,), eps, device=DEV) ** 2)}
    on_boxes = {"box": Q_BOX_ON_BOXES, "sphere": Q_BOX_ON_BOXES,
                "ray": Q_RAY_ON_BOXES}
    sample_rng = np.random.default_rng(seed + 22)
    for pred, leaf in NEW_KINDS:
        t0 = time.perf_counter()
        b = trees[leaf]
        qa, qb = geo[pred]
        if leaf == "box" and on_boxes[pred] < qa.shape[0]:
            keep = torch.from_numpy(np.sort(sample_rng.choice(
                qa.shape[0], on_boxes[pred], replace=False))).to(DEV)
            qa, qb = qa[keep].contiguous(), qb[keep].contiguous()
        q = qa.shape[0]
        depths = tq.node_depths(b)
        start = torch.from_numpy(rng.integers(0, 2 * n - 1, q).astype(np.int32)).to(DEV)
        start[torch.from_numpy(rng.random(q) < 0.25).to(DEV)] = -1
        got = {st is None: kw.wavefront_count(b, qa, qb, pred=pred, start=st,
                                              depths=depths)
               for st in (None, start)}
        width = 1 << max(max(int(g[0].max()) for g in got.values()) - 1,
                         0).bit_length()
        # One plain walk serves both start settings: the queries twice in
        # one lockstep, the first copy from the root, the second from the
        # start nodes.
        rows, counts, stats = plain_fixed_walk(
            kw, b, torch.cat([qa, qa]), torch.cat([qb, qb]),
            torch.cat([torch.zeros_like(start), start]), depths, pred, width)
        walks = {}
        for part, st in ((slice(0, q), None), (slice(q, 2 * q), start)):
            g, want = got[st is None], counts[part]
            # With early exit a count saturates at stop_at: min(count, 2).
            require(torch.equal(g[0], want) and torch.equal(g[1], stats[:, part])
                    and torch.equal(kw.wavefront_count(b, qa, qb, pred=pred,
                                                       start=st), want)
                    and torch.equal(kw.wavefront_count(b, qa, qb, pred=pred,
                                                       start=st, stop_at=2),
                                    want.clamp(max=2)),
                    f"COUNT and its counters {pred}/{leaf}, start={st is not None}")
            fixed = kw.wavefront_fixed(b, qa, qb, width, pred=pred, start=st)
            require(torch.equal(fixed[0], rows[part]) and torch.equal(fixed[1], want),
                    f"FIXED {pred}/{leaf} (width {width}), start={st is not None}")
            walks[st is None] = rows[part], want
        # FIXED rows wide enough for every hit hold each query's hits in
        # walk order: compacted, they are FILL's plain output, whole from
        # the root (int32 offsets) and cut at half the total from the start
        # nodes (int64 offsets).
        rows, counts = walks[False]
        offsets, want = tq._compact_csr(rows, counts, torch.int64)
        cap = int(offsets[-1]) // 2
        require(torch.equal(
            kw.wavefront_fill(b, qa, qb, offsets, cap, pred=pred, start=start),
            want[:cap]),
            f"FILL {pred}/{leaf}, int64 offsets at half capacity, from start nodes")
        rows, root = walks[True]
        offsets, want = tq._compact_csr(rows, root)
        require(torch.equal(kw.wavefront_fill(b, qa, qb, offsets, int(offsets[-1]),
                                              pred=pred), want),
                f"FILL {pred}/{leaf}, int32 offsets, exact capacity")
        log(f"[2] {pred} queries on {leaf} leaves ({q} queries, {int(root.sum())} "
            f"hits from the root, {int(counts.sum())} from start nodes, "
            f"{int((start == -1).sum())} SENTINEL): COUNT (stop_at None and 2), "
            f"counters, FIXED, FILL (int64 at half capacity from start nodes, "
            f"int32 exact), bit-equal to one plain walk from the root and "
            f"the start nodes ({time.perf_counter() - t0:.1f} s)")


def plain_fixed_walk(kw, bvh, qa, qb, start, depths, pred: str, width: int):
    """FIXED's plain version from ``start`` with the counter rows:
    ``(rows, counts, stats)``. FIXED never ends a walk early, and neither
    does COUNT without ``stop_at``, so the lockstep walk and its counter
    rows are COUNT's, and its carries hold COUNT's plain counts."""
    import torch
    buf = torch.full((qa.shape[0], width), -1, dtype=torch.int32,
                     device=qa.device)
    lanes, carry0 = kw.fixed_carry(qa.shape[0], qa.device)
    carry, _, stats = kw.lockstep_traverse(
        bvh, qa, qb, lanes, carry0, kw.fixed_epilogue(bvh, buf), start=start,
        depths=depths, pred=pred)
    return buf, carry[:, 0].to(torch.int32), stats


def catalog_ids(seed: int, rows: int):
    """Sorted segment ids of the halo catalog's shape over ``rows`` rows, and
    the length of their neutral tail. At 2^24 rows: 300,000 runs of 2-9
    rows, 60,000 runs of Pareto(1.5) sizes and one run of 300,000 rows (the
    largest halo at 2^24 particles holds 276,420) in random order, then a
    fifth of the rows carrying the last id, as the catalog's noise rows do;
    counts in proportion at other sizes."""
    rng = np.random.default_rng(seed)
    scale = rows / 2 ** 24
    tail, big = rows // 5, max(1, round(300_000 * scale))
    small = rng.integers(2, 10, max(1, round(300_000 * scale)))
    rest = rows - tail - big - int(small.sum())
    w = rng.pareto(1.5, max(1, round(60_000 * scale))) + 1.0
    med = np.maximum(10, np.floor(w / w.sum() * rest)).astype(np.int64)
    med[-1] += rest - int(med.sum())
    runs = rng.permutation(np.concatenate([small, med, [big]]))
    ids = np.repeat(np.arange(len(runs), dtype=np.int32), runs)
    return np.concatenate([ids, np.full(tail, ids[-1], np.int32)]), tail


def sum_tolerance(torch, data, seg, nseg):
    """Two summation orders of the same m terms differ by at most
    2 (m - 1) u sum|x| (u = 2^-24, recursive summation's bound), per
    segment and column."""
    from repro_torch.kernels import segment as ks
    rows_per = torch.bincount(seg.long().clamp(0, nseg - 1), minlength=nseg).float()
    abs_sum = ks.segment_sum_sorted_plain(data.abs(), seg, nseg)
    return 2.0 * (rows_per - 1).clamp(min=0)[:, None] * 2.0 ** -24 * abs_sum


def phase3_whole_path(seed: int, cfg, n: int = 1 << 15, n_lists: int = 1 << 14):
    import torch
    from repro_torch.analysis import insitu
    from repro_torch.data.pipeline import hacc_benchmark_epsilon

    pos, vel, _ = plummer_cloud(seed + 4, n)
    eps = hacc_benchmark_epsilon(1.0, n)
    out = {}
    for dev in (DEV, "cpu"):
        res_calls, cat_calls = [], []
        t0 = time.perf_counter()
        with tap(insitu, "fdbscan", res_calls), \
                tap(insitu, "halo_catalog", cat_calls):
            stats = insitu.simulation_halo_stats(pos, vel, cfg, eps, device=dev)
        stats = {k: float(v) for k, v in stats.items()}
        log(f"[3] simulation_halo_stats on {dev}: "
            f"{time.perf_counter() - t0:.1f} s")
        out[dev] = (res_calls[0][2], cat_calls[0][2], stats)
    (res_g, cat_g, st_g), (res_c, cat_c, st_c) = out[DEV], out["cpu"]
    for f in res_g._fields:
        require(torch.equal(getattr(res_g, f).cpu(), getattr(res_c, f)),
                f"DbscanResult.{f}")
    for f in cat_g._fields:
        a, b = getattr(cat_g, f).cpu(), getattr(cat_c, f)
        if a.dtype.is_floating_point:
            # Sums of up to 1e5 float32 terms in another order.
            require(torch.allclose(a, b, rtol=1e-4, atol=1e-6), f"HaloCatalog.{f}")
        else:
            require(torch.equal(a, b), f"HaloCatalog.{f}")
    for k in st_g:
        require(abs(st_g[k] - st_c[k]) <= 1e-4 * abs(st_c[k]) + 1e-6, k)
    log(f"[3] card == CPU at {n} particles: labels, core mask, "
        f"{int(res_g.num_rounds)} rounds and catalog ints exact; stats {st_g}")

    tq = importlib.import_module("repro_torch.core.query")
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.dbscan import dbscan_graph_cc
    from repro_torch.core.geometry import scene_bounds
    # The neighbor lists run at 2^14: the plain path on the CPU takes a
    # minute per 2^18 points for these four calls.
    pos, _, _ = plummer_cloud(seed + 5, n_lists)
    eps = hacc_benchmark_epsilon(1.0, n_lists)
    out = {}
    for dev in (DEV, "cpu"):
        t0 = time.perf_counter()
        pts = torch.from_numpy(pos).to(dev)
        bvh = build_bvh(pts, *scene_bounds(pts))
        pred = tq.within(pts, eps)
        # The card takes queries in Morton order, the CPU in index order:
        # the order changes no result.
        exact = tq.query_csr(bvh, pred, sort_queries=dev == DEV)
        cap = int(exact.total) // 2
        out[dev] = (exact, tq.query_csr_device(bvh, pred, cap),
                    tq.query_csr_buffered(bvh, pred, capacity=8),
                    dbscan_graph_cc(pos, eps, 2, device=dev))
        log(f"[3] neighbor lists and dbscan_graph_cc on {dev}: "
            f"{time.perf_counter() - t0:.1f} s")
    for what, got, want in zip(("query_csr", "query_csr_device", "buffered",
                                "dbscan_graph_cc"), out[DEV], out["cpu"]):
        for f in want._fields:
            a, b = getattr(got, f), getattr(want, f)
            same = torch.equal(a.cpu(), b) if torch.is_tensor(b) else a == b
            require(same, f"{what}.{f} card vs CPU")
    exact, trunc, buffered, _ = out[DEV]
    require(bool(trunc.overflowed), "query_csr_device at half the total")
    log(f"[3] card == CPU at {n_lists} particles: query_csr ({int(exact.total)} "
        f"hits), query_csr_device (capacity {trunc.indices.numel()}), "
        f"query_csr_buffered ({buffered.attempts} attempts) and "
        f"dbscan_graph_cc (capacity 64) exact")
    phase3_engine(pos, eps)


def phase3_engine(pos, eps):
    """The 32-bit build, the stack backend and the generic engine, card
    against CPU: ``fdbscan(use_64bit=False)``, ``fdbscan(use_stack=True,
    early_stop=False)``, ``query_count(backend="stack", with_stats=True)``
    and ``query`` with the quickstart's index-sum callback, all exact; the
    generic query launches no kernel."""
    import torch
    tq = importlib.import_module("repro_torch.core.query")
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.dbscan import fdbscan
    from repro_torch.core.geometry import scene_bounds

    def index_sum(acc, qi, j, d2):
        return acc + j, False

    out, kernels = {}, kernel_wrappers()
    for dev in (DEV, "cpu"):
        t0 = time.perf_counter()
        pts = torch.from_numpy(pos).to(dev)
        bvh = build_bvh(pts, *scene_bounds(pts))
        pred = tq.within(pts, eps)
        res = [fdbscan(pos, eps, 2, use_64bit=False, device=dev),
               fdbscan(pos, eps, 2, use_stack=True, early_stop=False, device=dev),
               tq.query_count(bvh, pred, backend="stack", with_stats=True)]
        reset_counts(kernels)
        res.append(tq.query(bvh, pred, index_sum,
                            torch.zeros((), dtype=torch.int64), sort_queries=True))
        require(not any(fn.launches for fn in kernels.values()),
                "the generic query launches no kernel")
        require(int(res[-1].sum()) == int(tq.query_csr(bvh, pred).indices
                                          .sum(dtype=torch.int64)),
                "index sums == the CSR's")
        out[dev] = res
        log(f"[3] fdbscan (32-bit codes; stack backend without early exit), "
            f"query_count(backend='stack', with_stats=True) and the generic "
            f"query on {dev}: {time.perf_counter() - t0:.1f} s")
    for name, got, want in zip(("fdbscan(use_64bit=False)",
                                "fdbscan(use_stack=True, early_stop=False)",
                                "query_count(backend='stack', with_stats=True)",
                                "query index sums"), out[DEV], out["cpu"]):
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, w in zip(got, want):
            for a, b in (zip(g, w) if isinstance(w, tuple) else ((g, w),)):
                require(torch.equal(a.cpu(), b), f"{name} card vs CPU")
    log(f"[3] card == CPU at {pos.shape[0]} particles: fdbscan over 30-bit "
        f"codes, fdbscan with the stack backend, the stack backend's counts "
        f"and six counter rows, and the generic query's index sums exact")


def phase4_main_path(seed: int, n: int, cfg):
    import torch
    from repro_torch.analysis import insitu
    from repro_torch.core import dbscan
    query = importlib.import_module("repro_torch.core.query")
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.halos import catalog
    from repro_torch.kernels.wavefront import wavefront_count

    t0 = time.perf_counter()
    cloud = plummer_cloud(seed, n)
    pos_t = torch.from_numpy(cloud[0]).to(DEV)
    vel_t = torch.from_numpy(cloud[1]).to(DEV)
    n_sph = cloud[2]
    eps = hacc_benchmark_epsilon(1.0, n)
    log(f"[4] {n} particles ({n_sph} in spheres), eps {eps:.6g}; "
        f"made in {time.perf_counter() - t0:.1f} s")

    analyzer = insitu.InsituAnalyzer(cfg, device=DEV)
    kernels = kernel_wrappers(HACC_KERNELS)
    r2 = torch.full((n,), eps, dtype=torch.float32, device=DEV) ** 2
    launches_by_step = []
    for step in range(2):
        if step:
            pos_t = pos_t + vel_t * DT       # step 0's positions are freed
        # Only fdbscan's result is kept: it lives through the step anyway.
        res_calls = []
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with tap(insitu, "fdbscan", res_calls, keep_args=False):
            t0 = time.perf_counter()
            stats = analyzer.maybe_run({"positions": pos_t, "velocities": vel_t},
                                       step)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        launches_by_step.append(launches)
        labels = res_calls[0][2].labels
        nprov = int(torch.unique(labels[labels >= 0]).numel())
        del res_calls, labels
        log(f"[4] step {step}: {secs:.3f} s, peak memory {peak / 2**30:.2f} GiB, "
            f"{nprov} provisional halos, launches {launches}")
        log(f"[4] step {step} stats: {json.dumps(stats)}")
        require(stats["insitu/halo_overflow"] == 0,
                f"halo_overflow with {nprov} provisional halos: raise capacity")
        for k, v in launches.items():
            require(v > 0, f"kernel {k} was not launched in step {step}")

        bvh = build_bvh(pos_t, *scene_bounds(pos_t))
        cnt = wavefront_count(bvh, pos_t, r2, order=bvh.leaf_perm).float()
        pct = torch.quantile(cnt[:n_sph][::16], torch.tensor(
            [0.5, 0.9, 0.99], device=DEV)).tolist()
        log(f"[4] step {step}: mean eps-neighbour count {cnt.mean().item():.2f} "
            f"over all, {cnt[:n_sph].mean().item():.2f} over sphere particles "
            f"(their 50/90/99th percentiles {pct})")
        del bvh, cnt

    # The kernels' inputs for phase 9: step 1's path once more, untimed,
    # keeping each kernel's first call.
    taps = {"wavefront_count": (query, "wavefront_count"),
            "wavefront_min_label": (dbscan, "wavefront_min_label"),
            "segment_sum_sorted": (catalog, "segment_sum_sorted"),
            "segment_max_sorted": (catalog, "segment_max_sorted")}
    calls = {k: [] for k in taps}
    with contextlib.ExitStack() as stack:
        for k, (mod, name) in taps.items():
            stack.enter_context(tap(mod, name, calls[k]))
        insitu.simulation_halo_stats(pos_t, vel_t, cfg, eps, 1, device=DEV)
    records = {k: v[0] for k, v in calls.items()}
    return launches_by_step, records, cloud


@contextlib.contextmanager
def sync_debug_error(torch):
    """Any host synchronisation inside raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def phase5_neighbor_lists(seed: int, n: int, card: str, wave: dict):
    import torch
    tq = importlib.import_module("repro_torch.core.query")
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.kernels import wavefront as kw

    pos, _, _ = plummer_cloud(seed, n)
    pts = torch.from_numpy(pos).to(DEV)
    del pos
    eps = hacc_benchmark_epsilon(1.0, n)
    bvh = build_bvh(pts, *scene_bounds(pts))
    pred = tq.within(pts, eps)
    order = bvh.leaf_perm            # a self-join: threads in leaf order
    kernels = kernel_wrappers()

    for run in range(2):
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        exact = tq.query_csr(bvh, pred, order=order)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
        log(f"[5] query_csr exact at {n} points, run {run}: "
            f"{int(exact.total)} hits in {secs:.4f} s, peak memory "
            f"{peak / 2**30:.2f} GiB, launches {launches}")
        require(launches == {"wavefront_count": 1, "wavefront_fill": 1},
                "query_csr launches COUNT once and FILL once")
        if not run:
            del exact
    total, secs_exact = int(exact.total), secs
    require(not bool(exact.overflowed) and exact.indices.numel() == total
            and bool((exact.indices >= 0).all()), "query_csr exact")

    cap = total // 2
    with sync_debug_error(torch):
        trunc = tq.query_csr_device(bvh, pred, cap, order=order)
    require(bool(trunc.overflowed) and torch.equal(trunc.offsets, exact.offsets)
            and torch.equal(trunc.indices, exact.indices[:cap]),
            "query_csr_device at half the total is the exact prefix")
    del trunc
    log(f"[5] query_csr_device capacity {cap}: no host sync, overflowed, "
        f"indices == the exact run's first {cap}")

    wide = tq.query_csr_device(bvh, pred, total, index_dtype=torch.int64,
                               order=order)
    require(wide.offsets.dtype == torch.int64
            and torch.equal(wide.offsets, exact.offsets.long())
            and torch.equal(wide.indices, exact.indices), "int64 offsets")
    del wide
    log("[5] index_dtype=int64: offsets == the int32 offsets, indices equal")

    centers, r2 = pred.centers.contiguous(), tq.squared_radii(pred)
    fill_args = (bvh, centers, r2, exact.offsets, total)
    plain, plain_ms, hops = plain_fill(torch, kw, *fill_args)
    require(torch.equal(plain, exact.indices), "plain fill on the card")
    del plain
    log(f"[5] the whole fill through its plain version on the card: "
        f"bit-equal, {plain_ms:.1f} ms, {hops} hops")

    fixed_calls = []
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tap(tq, "wavefront_fixed", fixed_calls):
        buffered = tq.query_csr_buffered(bvh, pred, capacity=32, order=order)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    fixed_launches = kw.wavefront_fixed.launches
    require(torch.equal(buffered.offsets, exact.offsets)
            and torch.equal(buffered.indices, exact.indices),
            "query_csr_buffered == query_csr")
    require(fixed_launches == buffered.attempts, "one FIXED launch per attempt")
    log(f"[5] query_csr_buffered from capacity 32: {buffered.attempts} "
        f"attempts (last capacity {32 << (buffered.attempts - 1)}), "
        f"{secs:.3f} s, peak memory {peak / 2**30:.2f} GiB (the exact "
        f"result held beside it), == query_csr")
    del buffered
    fixed_args, fixed_kwargs, _ = fixed_calls[0]
    fixed_calls.clear()

    # The kernels line's rows: FILL at query_csr's inputs, FIXED at
    # query_csr_buffered's first attempt.
    wave_src = "src/repro_torch/kernels/csrc/wavefront.cu"
    ms = cuda_ms(torch, lambda: kw.wavefront_fill(*fill_args, order=order), 3)
    count_ms = cuda_ms(torch, lambda: kw.wavefront_count(
        bvh, centers, r2, order=order), 3)
    log(f"[5] FILL {ms:.3f} ms and COUNT {count_ms:.3f} ms per launch; FILL "
        f"is {ms / (secs_exact * 1e3):.3f} of the {secs_exact:.4f} s "
        f"query_csr call")
    # The cost of the self-join's scattered rows: the same queries, taken
    # by the same threads in the same order, with their rows laid out in
    # thread order, so that a warp writes neighbouring rows. The walks are
    # identical; only where the hits land differs.
    perm = order.long()
    p_centers, p_r2 = centers[perm].contiguous(), r2[perm]
    p_offsets = exclusive_scan(torch, kw.wavefront_count(bvh, p_centers, p_r2),
                               torch.int32)
    rows_ms = cuda_ms(torch, lambda: kw.wavefront_fill(
        bvh, p_centers, p_r2, p_offsets, total), 3)
    del p_centers, p_r2, p_offsets
    log(f"[5] FILL with rows in thread order: {rows_ms:.3f} ms (scattered "
        f"rows: {ms:.3f} ms)")
    q, offsets = centers.shape[0], exact.offsets
    # Reads: tree, order, centers, r2 and row starts; writes: the indices.
    nb = (tree_bytes(bvh) + q * (4 + 12 + 4)
          + offsets.numel() * offsets.element_size() + total * 4)
    b_ms, b_by = bound(nb, hops * FLOPS_PER_HOP)
    rows = [{"name": "wavefront_fill", "route": "cuda", "source": wave_src,
             "replaces": "src/repro/kernels/wavefront.py:245",
             "launches": launches.get("wavefront_fill", 0),
             "path": "query_csr exact",
             "card": card,
             "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
             **traversal_fields(torch, kw, bvh, hops, ms, wave,
                                "wavefront_fill"),
             "capacity": total, "queries": q,
             "count_ms": count_ms, "query_csr_s": secs_exact,
             "rows_in_thread_order_ms": rows_ms}]
    del exact, fill_args, offsets

    cap = fixed_args[3]
    got = kw.wavefront_fixed(*fixed_args, **fixed_kwargs)
    ms = cuda_ms(torch, lambda: kw.wavefront_fixed(*fixed_args, **fixed_kwargs), 3)
    want, plain_ms, hops = plain_fixed(torch, kw, *fixed_args)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "wavefront_fixed on query_csr_buffered's input")
    del got, want
    # Reads: tree, order, centers, r2; writes: the buffer and the counts.
    nb = tree_bytes(bvh) + q * (4 + 12 + 4) + q * cap * 4 + q * 4
    b_ms, b_by = bound(nb, hops * FLOPS_PER_HOP)
    rows.append({"name": "wavefront_fixed", "route": "cuda", "source": wave_src,
                 "replaces": "src/repro/kernels/wavefront.py:97",
                 "launches": fixed_launches,
                 "path": "query_csr_buffered from capacity 32", "card": card,
                 "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                 **traversal_fields(torch, kw, bvh, hops, ms, wave,
                                    "wavefront_fixed"),
                 "capacity": cap, "queries": q})
    return rows


def plain_fill(torch, kw, bvh, centers, r2, offsets, capacity):
    """The plain FILL on the card: indices, milliseconds and hops."""
    indices = torch.full((capacity,), -1, dtype=torch.int32, device=DEV)
    lanes, start = kw.fill_lanes(offsets, capacity)
    (_, hops), ms = timed_once(torch, lambda: kw.lockstep_traverse(
        bvh, centers, r2, lanes, start, kw.fill_epilogue(bvh, indices)))
    return indices, ms, hops


def plain_fixed(torch, kw, bvh, centers, r2, capacity):
    """The plain FIXED on the card: (buf, counts), milliseconds and hops."""
    buf = torch.full((centers.shape[0], capacity), -1, dtype=torch.int32,
                     device=DEV)
    lanes, carry0 = kw.fixed_carry(centers.shape[0], DEV)
    (carry, hops), ms = timed_once(torch, lambda: kw.lockstep_traverse(
        bvh, centers, r2, lanes, carry0, kw.fixed_epilogue(bvh, buf)))
    return (buf, carry[:, 0].to(torch.int32)), ms, hops


def traversal_fields(torch, kw, bvh, hops: int, ms: float, wave: dict,
                     key: str, shared: bool = False) -> dict:
    """A traversal row's hops, hops per second, the time of one pack of
    the tree alone, whether ``ms`` holds a pack per launch (not where the
    path's traversals share one, ``shared``), and the registers of the
    kernel instance."""
    return {"hops": hops, "ghops_per_s": hops / ms * 1e-6,
            "pack_ms": cuda_ms(torch, lambda: kw.pack_tree(bvh), 5),
            "pack_per_launch": not shared,
            "registers": wave[key]["registers"]}


def bound(nbytes, ops):
    """(least milliseconds, "bytes" or "operations") for moving ``nbytes``
    once and doing ``ops`` float32 operations on the card."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def tree_bytes(bvh) -> int:
    return sum(t.numel() * t.element_size() for t in
               (bvh.leaf_perm, bvh.left_child, bvh.rope, bvh.node_lo,
                bvh.node_hi))


def sphere_tree_bytes(bvh) -> int:
    """What ``sphere_count_kernel`` reads of the tree: the packed records
    (32 B an internal node, 16 B a leaf), and per internal node its span
    and right child (4 B each)."""
    n = bvh.num_leaves
    return (n - 1) * (32 + 4 + 4) + n * 16


def timed_once(torch, fn):
    """(result, milliseconds) of one call, from CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def phase6_graph_dbscan(seed: int, n_max: int, min_pts: int = 2,
                        budget: float = 60e9):
    import torch
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.dbscan import dbscan_graph_cc, fdbscan
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.kernels import wavefront as kw

    total_mem = torch.cuda.get_device_properties(0).total_memory
    n = n_max
    while True:
        pos, _, _ = plummer_cloud(seed, n)
        pts = torch.from_numpy(pos).to(DEV)
        eps = hacc_benchmark_epsilon(1.0, n)
        bvh = build_bvh(pts, *scene_bounds(pts))
        r2 = torch.full((n,), eps, dtype=torch.float32, device=DEV) ** 2
        largest = int(kw.wavefront_count(bvh, pts, r2, order=bvh.leaf_perm).max())
        cap = 1 << (largest - 1).bit_length()
        del bvh, r2
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_per_process_memory_fraction(min(1.0, budget / total_mem))
        kw.wavefront_fixed.launches = 0
        res = None
        try:
            t0 = time.perf_counter()
            res = dbscan_graph_cc(pts, eps, min_pts, cap, device=DEV)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError:
            pass
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        if res is not None:
            break
        torch.cuda.empty_cache()
        log(f"[6] dbscan_graph_cc at n = {n}, capacity {cap} (largest count "
            f"{largest}): does not fit in {budget / 1e9:.0f} GB; halving n")
        n //= 2
    peak = torch.cuda.max_memory_allocated()
    launches = kw.wavefront_fixed.launches
    require(launches == 1, "dbscan_graph_cc launches FIXED once")
    ref = fdbscan(pts, eps, min_pts, device=DEV)
    require(torch.equal(res.labels, ref.labels)
            and torch.equal(res.core_mask, ref.core_mask),
            "dbscan_graph_cc == fdbscan")
    nclu = int(torch.unique(res.labels[res.labels >= 0]).numel())
    cut = (f"cut from {n_max} by the (n, capacity) neighbour buffer"
           if n < n_max else "not cut")
    log(f"[6] dbscan_graph_cc at n = {n} ({cut}), capacity {cap} (largest "
        f"count {largest}), "
        f"min_pts {min_pts}: {secs:.3f} s, peak memory {peak / 2**30:.2f} GiB "
        f"({peak / 1e9:.2f} GB), FIXED launches {launches}, {nclu} clusters; "
        f"labels and core mask == fdbscan bit for bit")


def pair_ops(d: int) -> int:
    """Float operations per pair test of the eps-pairwise kernels at width
    d: d products and d sums for x.y, the norm sum, 2 x.y, the difference
    and the compare."""
    return 2 * d + 4


def stencil_tests(torch, cell_pts, nbr, chunk: int = 1 << 20):
    """(pair tests, class tests) of a stencil pass: per cell i, |R(i)| *
    T(i) tests between real slots and T(i) + |R(i)| + 1 tests against the
    padding vector, R(i) the cell's real slots and T(i) the real slots of
    its stencil's cells (the sink and ids outside [0, ncells] read the
    sink). The pair tests are the pass's own work: a padded slot sits at
    BIG and needs no arithmetic of its own."""
    from repro_torch.kernels.pairwise import BIG
    big = torch.tensor(BIG, dtype=torch.float32).view(torch.int32).item()
    occ = (cell_pts.view(torch.int32) != big).any(-1).sum(1)
    ncells = nbr.shape[0]
    pairs = classes = 0
    for lo in range(0, ncells, chunk):
        hi = min(lo + chunk, ncells)
        ids = nbr[lo:hi].long()
        ids = torch.where((ids >= 0) & (ids <= ncells), ids, ncells)
        t = occ[ids].sum(1)
        pairs += int((occ[lo:hi] * t).sum())
        classes += int((t + occ[lo:hi] + 1).sum())
    return pairs, classes


def uniform_cube(seed: int, n: int):
    return np.random.default_rng(seed).random((n, 3), dtype=np.float32)


def grid_eps(n: int) -> float:
    """The power of two nearest the mean spacing n^(-1/3) of n points in
    the unit cube; binning by a power of two is exact."""
    return 2.0 ** -round(np.log2(n) / 3)


def gaussian_clusters(seed: int, n: int, d: int = 64, k: int = 64):
    """n points in d dimensions from k Gaussian clusters of equal weight:
    centres N(0, 1), spread 0.05 per axis."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, d))
    pts = centres[rng.integers(0, k, n)] + 0.05 * rng.standard_normal((n, d))
    return pts.astype(np.float32)


def quantile_eps(pts, q: float, seed: int, rows: int = 512) -> float:
    """sqrt of the q-quantile of the squared pairwise distances over a
    seeded sample of ``rows`` points, as the reference's in-situ analysis
    picks eps (``eps_quantile = 0.01`` over ``sample_rows = 512``)."""
    rng = np.random.default_rng(seed)
    sample = pts[rng.choice(len(pts), min(rows, len(pts)), replace=False)]
    s = sample.astype(np.float64)
    d2 = ((s[:, None] - s[None]) ** 2).sum(-1)
    return float(np.sqrt(np.quantile(d2[np.triu_indices(len(s), 1)], q)))


def device_profile(torch, fn, top: int = 8):
    """Wall seconds of ``fn()`` under ``torch.profiler``, the device's busy
    seconds in it, and its ``top`` kernels as (ms, launches, name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only: the operators that launched them carry the
    # same time again.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    return wall, busy, [(e.self_device_time_total / 1e3, e.count, e.key[:60])
                        for e in events[:top]]


def phase2_pairwise_kernels(seed: int, n_log2: int = 21):
    import torch
    from repro_torch.core import fdbscan_grid as tgrid
    from repro_torch.kernels import pairwise as kp
    from repro_torch.kernels.ops import eps_squared

    n = 1 << n_log2
    eps = grid_eps(n)
    pts = torch.from_numpy(uniform_cube(seed + 6, n)).to(DEV)
    dims = tgrid.grid_dims_for(np.zeros(3), np.ones(3), eps)
    nbr = tgrid.stencil_neighbor_map(dims, device=DEV)
    eps2 = eps_squared(eps)
    rng = np.random.default_rng(seed + 7)
    labels = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(DEV)
    core = torch.from_numpy(rng.random(n) < 0.5).to(DEV)
    for cap in (16, 48):             # 48 is not a multiple of a warp
        bins = tgrid.bin_points(pts, np.zeros(3, np.float32), eps, dims, cap)
        require(not bool(bins.overflowed), f"capacity {cap} overflows")
        slot = bins.slot_of_point.long()
        lab = tgrid._scatter_slots(labels, kp.SENTINEL_LABEL, bins, slot)
        cor = tgrid._scatter_slots(core, False, bins, slot, dtype=torch.bool)
        require(torch.equal(kp.slot_classes(bins.cell_pts),
                            kp.slot_classes_plain(bins.cell_pts)),
                f"slot_classes capacity {cap}")
        got = kp.stencil_count(bins.cell_pts, nbr, eps2)
        require(torch.equal(got, kp.stencil_count_plain(bins.cell_pts, nbr, eps2)),
                f"stencil_count capacity {cap}")
        mean = got.view(-1)[slot].float().mean().item()
        got = kp.stencil_min_label(bins.cell_pts, lab, cor, nbr, eps2)
        want = kp.stencil_min_label_plain(bins.cell_pts, lab, cor, nbr, eps2)
        require(torch.equal(got, want), f"stencil_min_label capacity {cap}")
        log(f"[2] stencil_count and stencil_min_label, {dims} cells, capacity "
            f"{cap}: exact at all {got.numel()} slots (padded ones included), "
            f"slot classes exact; mean count {mean:.3f} over {n} points")
        del bins, slot, lab, cor, got, want
    del pts, nbr, labels, core

    def held(x, y, lab, cor, eps2, what):
        got = kp.pairwise_count(x, y, eps2)
        require(torch.equal(got, kp.pairwise_count_plain(x, y, eps2)),
                f"pairwise_count {what}")
        got_m = kp.pairwise_min_label(x, y, lab, cor, eps2)
        require(torch.equal(got_m, kp.pairwise_min_label_plain(x, y, lab, cor, eps2)),
                f"pairwise_min_label {what}")
        return got, got_m

    def rows(*shape):
        return torch.from_numpy(rng.random(shape, dtype=np.float32)).to(DEV)

    # m and n off multiples of the 128-row tile and of 4; D below, at and
    # past the 16-feature chunk, and one that does not divide it.
    for (m, n), d in itertools.product(((1, 5000), (129, 257), (3001, 5003)),
                                       (1, 3, 64, 100, 257)):
        x, y = rows(m, d), rows(n, d)
        eps2 = eps_squared(quantile_eps(torch.cat([x, y]).cpu().numpy(), 0.01,
                                        seed + d))
        lab = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(DEV)
        cor = torch.from_numpy(rng.random(n) < 0.4).to(DEV)
        got, got_m = held(x, y, lab, cor, eps2, f"{m} x {n}, d={d}")
        log(f"[2] pairwise_count and pairwise_min_label {m} x {n}, d={d}: "
            f"exact; mean count {got.float().mean().item():.2f}, "
            f"{int((got_m != kp.SENTINEL_LABEL).sum())} rows with a core hit")
    # m << n: 3 row tiles, the candidates split across blocks.
    x, y = rows(300, 64), rows(70_000, 64)
    eps2 = eps_squared(quantile_eps(y.cpu().numpy(), 0.01, seed + 4))
    lab = torch.from_numpy(rng.permutation(70_000).astype(np.int32)).to(DEV)
    cor = torch.from_numpy(rng.random(70_000) < 0.4).to(DEV)
    got, _ = held(x, y, lab, cor, eps2, "300 x 70000 (split candidates)")
    log(f"[2] all-pairs kernels 300 x 70000, d=64, candidates split: exact; "
        f"mean count {got.float().mean().item():.1f}")
    # Exact ties: eps2 the plain version's own d2 of a chosen pair, whose
    # label is made the least, so that the tie decides its row's label.
    ties = 0
    for d in (3, 64, 257):
        x, y = rows(700, d), rows(900, d)
        d2 = kp._d2(x, kp._sq_norms(x), y, kp._sq_norms(y))
        cor = torch.ones(900, dtype=torch.bool, device=DEV)
        for i, j in zip(rng.integers(0, 700, 8), rng.integers(0, 900, 8)):
            eps2 = float(d2[i, j])
            require(np.float32(eps2) == d2[i, j].item(), "a tie at eps")
            lab = torch.from_numpy(rng.permutation(900).astype(np.int32)).to(DEV)
            lab[j] = -1
            _, got_m = held(x, y, lab, cor, eps2, f"tie at d={d}")
            require(int(got_m[i]) == -1, f"the tie pair decides its row, d={d}")
            ties += int((d2 == d2[i, j]).sum())
    log(f"[2] all-pairs kernels at exact ties (d = 3, 64, 257; 8 values of "
        f"eps2 each, the plain d2 of a pair; {ties} tie pairs): exact")


def phase3_grid_and_pairwise(seed: int, n: int = 1 << 15, n_pairs: int = 1 << 12):
    import torch
    from repro_torch.core import fdbscan_grid as tgrid
    from repro_torch.kernels import ops

    pts = uniform_cube(seed + 8, n)
    eps = grid_eps(n)
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    dims = tgrid.grid_dims_for(lo, hi, eps)
    # The CPU runs the auto driver only (its last attempt is fdbscan_grid
    # at the capacity it found): the plain path there takes ~40 s a run at
    # 2^18 points. Cut to 2^16, then to 2^15, to keep the whole script
    # under 900 s with phases 15 and 16.
    t0 = time.perf_counter()
    auto_c, info_c = tgrid.fdbscan_grid_auto(
        pts, eps, GRID_MIN_PTS, scene_lo=lo, scene_hi=hi, capacity=2,
        with_info=True, device="cpu")
    log(f"[3] fdbscan_grid_auto on cpu: {time.perf_counter() - t0:.1f} s, {info_c}")
    t0 = time.perf_counter()
    auto_g, info_g = tgrid.fdbscan_grid_auto(
        pts, eps, GRID_MIN_PTS, scene_lo=lo, scene_hi=hi, capacity=2,
        with_info=True, device=DEV)
    grid_g, ovf = tgrid.fdbscan_grid(pts, eps, GRID_MIN_PTS, scene_lo=lo,
                                     grid_dims=dims, capacity=info_c.capacity,
                                     device=DEV)
    log(f"[3] fdbscan_grid_auto and fdbscan_grid on {DEV}: "
        f"{time.perf_counter() - t0:.1f} s")
    require(tuple(info_g) == tuple(info_c), "GridAutoInfo card vs CPU")
    require(not bool(ovf), "fdbscan_grid overflowed at the auto capacity")
    for what, res in (("fdbscan_grid_auto", auto_g), ("fdbscan_grid", grid_g)):
        for f in auto_c._fields:
            require(torch.equal(getattr(res, f).cpu(), getattr(auto_c, f)),
                    f"{what}.{f} card vs CPU")
    nclu = int(torch.unique(auto_c.labels[auto_c.labels >= 0]).numel())
    log(f"[3] card == CPU at {n} uniform points, eps {eps}, dims {dims}: "
        f"{info_c}, {int(auto_c.num_rounds)} rounds, "
        f"{int(auto_c.core_mask.sum())} core points, {nclu} clusters; labels, "
        f"core mask, rounds and overflowed exact")

    x = gaussian_clusters(seed + 9, n_pairs)
    eps = quantile_eps(x, 0.01, seed + 10)
    out = {}
    for dev in (DEV, "cpu"):
        xt = torch.from_numpy(x).to(dev)
        counts = ops.eps_neighbor_counts(xt, xt, eps)
        ids = torch.arange(n_pairs, dtype=torch.int32, device=dev)
        out[dev] = (counts, ops.eps_min_label(xt, xt, ids, counts >= 5, eps))
    for what, a, b in zip(("eps_neighbor_counts", "eps_min_label"), out[DEV],
                          out["cpu"]):
        require(torch.equal(a.cpu(), b), f"{what} card vs CPU")
    log(f"[3] card == CPU: eps_neighbor_counts and eps_min_label at "
        f"{n_pairs} x 64, eps {eps:.6g}, mean count "
        f"{out['cpu'][0].float().mean().item():.1f}")


def phase7_grid(seed: int, n: int, card: str, stencil: dict):
    import torch
    from repro_torch.core import fdbscan_grid as tgrid
    tq = importlib.import_module("repro_torch.core.query")
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.dbscan import count_neighbors, fdbscan
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise as kp

    t0 = time.perf_counter()
    pts = torch.from_numpy(uniform_cube(seed + 11, n)).to(DEV)
    eps = grid_eps(n)
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    dims = tgrid.grid_dims_for(lo, hi, eps)
    log(f"[7] {n} uniform points, eps {eps} ({dims} cells), min_pts "
        f"{GRID_MIN_PTS}; made in {time.perf_counter() - t0:.1f} s")
    kernels = {"stencil_count": kp.stencil_count,
               "stencil_min_label": kp.stencil_min_label}

    def zero():
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    held = zero()               # earlier phases' tensors, counted in the peak
    t0 = time.perf_counter()
    auto, info = tgrid.fdbscan_grid_auto(pts, eps, GRID_MIN_PTS, scene_lo=lo,
                                         scene_hi=hi, capacity=4,
                                         with_info=True, device=DEV)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    rounds = int(auto.num_rounds)
    peak = torch.cuda.max_memory_allocated() - held
    log(f"[7] fdbscan_grid_auto from capacity 4: {info}, {secs:.3f} s, peak "
        f"memory {peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held "
        f"before, {rounds} rounds, launches {launches}")
    require(launches == {"stencil_count": 1, "stencil_min_label": rounds + 1},
            "overflowing attempts launch nothing; the last one 1 and rounds + 1")
    cap = info.capacity

    runs = []
    for run in range(2):
        held = zero()
        t0 = time.perf_counter()
        res, ovf = tgrid.fdbscan_grid(pts, eps, GRID_MIN_PTS, scene_lo=lo,
                                      grid_dims=dims, capacity=cap, device=DEV)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        launches = {k: fn.launches for k, fn in kernels.items()}
        rounds = int(res.num_rounds)
        runs.append(secs)
        log(f"[7] fdbscan_grid capacity {cap}, run {run}: {secs:.4f} s, peak "
            f"memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB) above the "
            f"{held / 2**30:.2f} GiB held before, {rounds} rounds, launches "
            f"{launches}")
        require(not bool(ovf), "fdbscan_grid overflowed at the auto capacity")
        require(launches == {"stencil_count": 1, "stencil_min_label": rounds + 1},
                "fdbscan_grid launches stencil_count 1, stencil_min_label "
                "rounds + 1")
    for f in res._fields:
        require(torch.equal(getattr(res, f), getattr(auto, f)),
                f"fdbscan_grid.{f} == fdbscan_grid_auto's")
    del auto
    # The same run on the points of the cube's first octant (the same cells
    # and occupancy, an eighth of the grid: the plain stencils test every
    # slot pair of every cell, about a minute over the whole grid) with the
    # plain stencil versions in place of the kernels (which it does not
    # launch): labels, core mask and rounds must be the kernels' own.
    t0 = time.perf_counter()
    octant = pts[(pts < 0.5).all(dim=1)]
    o_dims = tgrid.grid_dims_for(lo, lo + 0.5, eps)
    o_res, o_ovf = tgrid.fdbscan_grid(octant, eps, GRID_MIN_PTS, scene_lo=lo,
                                      grid_dims=o_dims, capacity=cap,
                                      device=DEV)
    require(not bool(o_ovf), "fdbscan_grid overflowed on the octant")
    with swapped(kp, "stencil_count", kp.stencil_count_plain), \
            swapped(kp, "stencil_min_label", kp.stencil_min_label_plain):
        plain_res, _ = tgrid.fdbscan_grid(octant, eps, GRID_MIN_PTS,
                                          scene_lo=lo, grid_dims=o_dims,
                                          capacity=cap, device=DEV)
    torch.cuda.synchronize()
    for f in o_res._fields:
        require(torch.equal(getattr(plain_res, f), getattr(o_res, f)),
                f"fdbscan_grid.{f}: the kernels' == the plain versions'")
    log(f"[7] fdbscan_grid on the first octant ({octant.shape[0]} points, "
        f"{o_dims} cells) with the kernels and with the plain stencil "
        f"versions: {time.perf_counter() - t0:.1f} s; labels, core mask and "
        f"{int(plain_res.num_rounds)} rounds equal")
    del plain_res, o_res, octant
    wall, busy, top = device_profile(torch, lambda: tgrid.fdbscan_grid(
        pts, eps, GRID_MIN_PTS, scene_lo=lo, grid_dims=dims, capacity=cap,
        device=DEV))
    log(f"[7] one fdbscan_grid run under torch.profiler: wall {wall:.4f} s, "
        f"device busy {busy:.4f} s, idle share {1 - busy / wall:.3f}; device "
        f"time by kernel: " + "; ".join(
            f"{ms:.3f} ms x{cnt} {name}" for ms, cnt, name in top))

    # The kernels' inputs: the same run once more, untimed, keeping the
    # count pass and the first and last min-label passes (tapped where the
    # path calls them, so that the wrappers' counters stay untouched).
    count_calls, min_calls, last_min = [], [], []
    with tap(ops, "cell_stencil_counts", count_calls), \
            tap(ops, "cell_stencil_min_label", min_calls), \
            tap(ops, "cell_stencil_min_label", last_min, last=True):
        tgrid.fdbscan_grid(pts, eps, GRID_MIN_PTS, scene_lo=lo, grid_dims=dims,
                           capacity=cap, device=DEV)
    # The octant above holds rounds 2..R at an eighth of the size; the
    # last round is held here at the path's full shapes too.
    t0 = time.perf_counter()
    tapped, _, got = last_min[0]
    want = kp.stencil_min_label_plain(*tapped[:-1], ops.eps_squared(tapped[-1]))
    require(torch.equal(got, want),
            "stencil_min_label's last round on the grid path's input")
    log(f"[7] stencil_min_label's last pass (pass {rounds + 1}) on the "
        f"path's full-size input == its plain version "
        f"({time.perf_counter() - t0:.1f} s)")
    del last_min, tapped, got, want
    rows = []
    for name, calls, plain in (
            ("stencil_count", count_calls, kp.stencil_count_plain),
            ("stencil_min_label", min_calls, kp.stencil_min_label_plain)):
        tapped, _, got = calls[0]
        args = (*tapped[:-1], ops.eps_squared(tapped[-1]))
        want, plain_ms = timed_once(torch, lambda: plain(*args))
        require(torch.equal(got, want), f"{name} on the grid path's input")
        del want
        cell_pts, nbr = args[0], args[-2]
        # As on the path: the launches share one slot-class mask.
        with kp.shared_classes(cell_pts):
            kp._classes(cell_pts)
            ms = cuda_ms(torch, lambda: kernels[name](*args), 5)
        ms_alone = cuda_ms(torch, lambda: kernels[name](*args), 5)
        class_ms = cuda_ms(torch, lambda: kp.slot_classes(cell_pts), 5)
        ncells, s = nbr.shape
        c, d = cell_pts.shape[1:]
        all_slots = ncells * s * c * c
        pairs, classes = stencil_tests(torch, cell_pts, nbr)
        # Reads: the cells, the map (labels and core too); writes: (ncells, C).
        nb = sum(t.numel() * t.element_size() for t in args[:-1]) + ncells * c * 4
        b_ms, b_by = bound(nb, pairs * pair_ops(d))
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/pairwise.cu",
                     "replaces": ("src/repro/kernels/pairwise.py:166"
                                  if name == "stencil_count" else
                                  "src/repro/kernels/pairwise.py:197"),
                     "launches": launches[name],
                     "path": f"fdbscan_grid at {n} points, capacity {cap}",
                     "card": card, "max_abs_err": 0.0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None, "pair_tests": pairs,
                     "class_tests": classes,
                     "tests_per_s": (pairs + classes) / ms * 1e3,
                     "all_slot_pair_tests": all_slots, "bytes": nb,
                     "ops_per_pair": pair_ops(d), "class_ms": class_ms,
                     "class_per_launch": False, "ms_class_per_launch": ms_alone,
                     "registers": stencil[name]["registers"],
                     "fdbscan_grid_s": runs})
        log(f"[7] {name} on the path's input == its plain version "
            f"({plain_ms:.1f} ms); kernel {ms:.3f} ms with the class mask "
            f"shared, {ms_alone:.3f} ms with it made per launch (mask alone "
            f"{class_ms:.3f} ms), bound {b_ms:.3f} ms ({b_by}: {nb} bytes, "
            f"{pairs} pair tests between real slots); the kernel makes "
            f"{pairs + classes} tests ({classes} against the padding vector) "
            f"where testing every slot pair makes {all_slots}")
    counts_cells = count_calls[0][2]
    del count_calls, min_calls, args, tapped

    # The grid's per-point counts against the exact (Σ(x−y)²) BVH counts.
    bins = tgrid.bin_points(pts, lo, eps, dims, cap)
    grid_counts = tgrid._gather_slots(counts_cells, bins.slot_of_point.long(), 0)
    del bins, counts_cells
    bvh = build_bvh(pts, *scene_bounds(pts))
    exact = count_neighbors(bvh, pts, pts, eps, order=bvh.leaf_perm)
    diff = grid_counts - exact
    idx = torch.nonzero(diff).flatten()
    # Every pair the expanded formula can put on the other side of eps lies
    # in the band |d² − eps²| <= 8u(‖x‖² + ‖y‖² + 2|x·y|), u = 2^-24, so
    # within sqrt(eps² + 96u) < 1.25 eps in the unit cube: find them there.
    csr = tq.query_csr(bvh, tq.within(pts[idx], 1.25 * eps), sort_queries=True)
    rows_of = torch.repeat_interleave(
        torch.arange(idx.numel(), device=DEV), csr.offsets.diff().long())
    xi = pts[idx].double()[rows_of]
    yj = pts[csr.indices.long()].double()
    d2 = ((xi - yj) ** 2).sum(1)
    xx, yy, xy = (xi * xi).sum(1), (yj * yj).sum(1), (xi * yj).sum(1)
    band = 8 * 2.0 ** -24 * (xx + yy + 2 * xy.abs())
    in_band = ((d2 - eps * eps).abs() <= band).int()
    band_pairs = torch.zeros(idx.numel(), dtype=torch.int32, device=DEV)
    band_pairs.index_add_(0, rows_of, in_band)
    explained = bool((band_pairs >= diff[idx].abs()).all())
    del xi, yj, d2, xx, yy, xy, band, in_band, csr, rows_of, bvh

    ref = fdbscan(pts, eps, GRID_MIN_PTS, device=DEV)
    pairs = (int(exact.sum(dtype=torch.int64)) - n) // 2
    ndiff = idx.numel()
    core_diff = int((res.core_mask != ref.core_mask).sum())
    label_diff = int((res.labels != ref.labels).sum())
    nclu = int(torch.unique(res.labels[res.labels >= 0]).numel())
    log(f"[7] against fdbscan: {pairs} eps-pairs; {ndiff} points "
        f"({ndiff / n:.5f}) with a different count (grid - exact: "
        f"{int((diff > 0).sum())} more, {int((diff < 0).sum())} fewer, "
        f"largest |difference| {int(diff.abs().max()) if ndiff else 0}, "
        f"sum of |differences| {int(diff.abs().sum(dtype=torch.int64))}), "
        f"{int(band_pairs.sum())} band pairs at them; {core_diff} core flags "
        f"and {label_diff} labels differ; grid {nclu} clusters, fdbscan "
        f"{int(torch.unique(ref.labels[ref.labels >= 0]).numel())}; "
        f"fdbscan {int(ref.num_rounds)} rounds, grid {rounds}")
    require(explained, "every count difference is explained by band pairs")
    del pts, ref, res, exact, grid_counts, diff, idx, band_pairs

    return rows


def phase8_all_pairs(seed: int, n: int, card: str, tiles: dict):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise as kp

    x_np = gaussian_clusters(seed + 12, n)
    eps = quantile_eps(x_np, 0.01, seed + 13)
    x = torch.from_numpy(x_np).to(DEV)
    del x_np
    ids = torch.arange(n, dtype=torch.int32, device=DEV)
    kernels = {"pairwise_count": kp.pairwise_count,
               "pairwise_min_label": kp.pairwise_min_label}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = ops.eps_neighbor_counts(x, x, eps)
    core = counts >= 5
    minlab = ops.eps_min_label(x, x, ids, core, eps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    log(f"[8] {n} x 64 from 64 clusters, eps {eps:.6g}: eps_neighbor_counts "
        f"+ eps_min_label in {secs:.4f} s, launches {launches}; mean count "
        f"{counts.float().mean().item():.1f}, {int(core.sum())} core, "
        f"{int((minlab != kp.SENTINEL_LABEL).sum())} rows with a core hit")
    require(launches == {"pairwise_count": 1, "pairwise_min_label": 1},
            "one launch of each all-pairs kernel")
    eps2 = ops.eps_squared(eps)
    eps_t = torch.tensor(eps, dtype=torch.float32)
    sentinel = kp.SENTINEL_LABEL
    # Without FMA each of a pair's 2d + 4 operations is one FP32
    # instruction; an SM issues 128 lanes of them a clock.
    clock = sm_clock_hz()
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * 128
    rows = []
    for name, args, got, plain, library in (
            ("pairwise_count", (x, x, eps2), counts, kp.pairwise_count_plain,
             lambda: (torch.cdist(x, x) <= eps_t).sum(1)),
            ("pairwise_min_label", (x, x, ids, core, eps2), minlab,
             kp.pairwise_min_label_plain,
             lambda: torch.where((torch.cdist(x, x) <= eps_t) & core,
                                 ids, sentinel).amin(1))):
        want, plain_ms = timed_once(torch, lambda: plain(*args))
        require(torch.equal(got, want), f"{name} on the all-pairs input")
        del want
        ms = cuda_ms(torch, lambda: kernels[name](*args), 3)
        lib_ms = cuda_ms(torch, library, 3)
        torch.cuda.empty_cache()
        m, d = x.shape
        nb = sum(t.numel() * t.element_size() for t in args[:-1]
                 if torch.is_tensor(t)) + m * 4
        b_ms, b_by = bound(nb, m * n * pair_ops(d))
        floor_ms = m * n * pair_ops(d) / (lanes * clock) * 1e3
        require(floor_ms <= ms, f"{name} faster than the FP32 issue floor")
        rep = tiles[name]
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/pairwise.cu",
                     "replaces": ("src/repro/kernels/pairwise.py:91"
                                  if name == "pairwise_count" else
                                  "src/repro/kernels/pairwise.py:113"),
                     "launches": launches[name],
                     "path": f"eps_neighbor_counts + eps_min_label, {n} x {d}",
                     "card": card, "max_abs_err": 0.0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms,
                     "library": "torch.cdist <= eps, then sum / masked amin",
                     "pair_tests": m * n, "ops_per_pair": pair_ops(d),
                     "exact_floor_ms": floor_ms, "sm_clock_hz": clock,
                     "fp32_issue_share": floor_ms / ms,
                     "registers": rep["registers"],
                     "spill_bytes": rep["spill_stores"] + rep["spill_loads"],
                     "sass": rep["sass"]})
        log(f"[8] {name} == its plain version ({plain_ms:.1f} ms); kernel "
            f"{ms:.3f} ms, exact-order floor {floor_ms:.3f} ms at "
            f"{clock / 1e6:.0f} MHz (share {floor_ms / ms:.3f}), bound "
            f"{b_ms:.3f} ms ({b_by}), cdist {lib_ms:.3f} ms")
    return rows


def brute_counts(torch, pts, center, r):
    """Points within ``r`` of ``center`` by the kernel's distance formula,
    ((dx*dx + dy*dy) + dz*dz) <= r*r, one float32 op at a time (no FMA)."""
    d = pts - center
    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    return int((d2 <= r * r).sum())


def phase10_halo_products(seed: int, n: int, cfg, card: str, wave: dict,
                          small: dict):
    import torch
    tq = importlib.import_module("repro_torch.core.query")
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.dbscan import fdbscan
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.halos import centers as hc
    from repro_torch.halos import halo_catalog, most_bound_centers, so_masses
    from repro_torch.halos.so_mass import sphere_counts
    from repro_torch.kernels import wavefront as kw

    t0 = time.perf_counter()
    pos, vel, _ = plummer_cloud(seed, n)
    pts = torch.from_numpy(pos).to(DEV)
    vel_t = torch.from_numpy(vel).to(DEV)
    del pos, vel
    eps = hacc_benchmark_epsilon(1.0, n)
    res = fdbscan(pts, eps, cfg.min_pts, device=DEV)
    cat = halo_catalog(pts, vel_t, res.labels, capacity=cfg.halo_capacity,
                       min_count=cfg.halo_min_count, device=DEV)
    del res, vel_t
    require(not bool(cat.overflow), "halo catalog overflow: raise capacity")
    nh = int(cat.num_halos)
    bvh = build_bvh(pts, *scene_bounds(pts))
    torch.cuda.synchronize()
    log(f"[10] {n} particles, eps {eps:.6g}: {nh} halos of at least "
        f"{cfg.halo_min_count} particles; fdbscan, catalog and tree in "
        f"{time.perf_counter() - t0:.1f} s")

    valid = cat.count > 0
    kernels = kernel_wrappers(("wavefront_potential", "wavefront_count",
                               "wavefront_sphere_count"))
    so_mod = importlib.import_module("repro_torch.halos.so_mass")
    pot_calls, so_calls = [], []
    reset_counts(kernels)
    with kw.shared_pack(bvh), tap(hc, "wavefront_potential", pot_calls), \
            tap(so_mod, "wavefront_sphere_count", so_calls, every=True):
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mb = most_bound_centers(pts, cat.particle_halo, 2 * eps,
                                capacity=cfg.halo_capacity, bvh=bvh, device=DEV)
        torch.cuda.synchronize()
        mb_s = time.perf_counter() - t0
        mb_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        so = so_masses(pts, mb.center, valid, delta=200.0, r_max=0.1, bvh=bvh,
                       device=DEV)
        torch.cuda.synchronize()
        so_s = time.perf_counter() - t0
        so_peak = torch.cuda.max_memory_allocated()
    launches = {k: fn.launches for k, fn in kernels.items()}
    log(f"[10] most_bound_centers (2 eps): {mb_s:.4f} s, peak memory "
        f"{mb_peak / 2**30:.2f} GiB; so_masses (Delta 200, r_max 0.1): "
        f"{so_s:.4f} s, peak {so_peak / 2**30:.2f} GiB ({resident / 2**30:.2f} "
        f"GiB resident before: points, tree, catalog); launches {launches}")
    require(launches == {"wavefront_potential": 1, "wavefront_count": 0,
                         "wavefront_sphere_count": 22},
            "the halo products launch POTENTIAL once, the SO count 22 times "
            "and COUNT never")

    ph = cat.particle_halo
    idx = mb.index[:nh]
    require(bool((idx >= 0).all()) and torch.equal(
        ph[idx.long()], torch.arange(nh, dtype=torch.int32, device=DEV)),
        "every most-bound particle is a member of its halo")
    require(bool((mb.index[nh:] == -1).all()), "empty slots have no center")

    # POTENTIAL against its plain version on every 16th member.
    args, kwargs, phi = pot_calls[0]
    _, centers, r2, soft2, active = args
    members = torch.nonzero(active).flatten()
    sub = members[::16]
    sub_mask = torch.zeros_like(active)
    sub_mask[sub] = True
    want, plain_ms = timed_once(torch, lambda: kw.wavefront_potential_plain(
        bvh, centers, r2, soft2, sub_mask))
    require(bits_equal(torch, phi[sub], want[sub]),
            "wavefront_potential on the path's input, every 16th member")
    del want, sub_mask
    with kw.shared_pack(bvh):
        ms = cuda_ms(torch, lambda: kw.wavefront_potential(*args, **kwargs), 3)
    depths = tq.node_depths(bvh)
    # POTENTIAL never ends early, nor does COUNT without stop_at: the
    # counters of the same queries are POTENTIAL's walk.
    _, st = kw.wavefront_count(bvh, centers[members].contiguous(), r2[members],
                               depths=depths)
    hops = int(st[0].sum(dtype=torch.int64))
    hits = int(st[3].sum(dtype=torch.int64))
    q = centers.shape[0]
    # Reads: tree, order, centers, r2, active; writes: the potentials.
    nb = tree_bytes(bvh) + q * (4 + 12 + 4 + 1) + q * 4
    b_ms, b_by = bound(nb, hops * FLOPS_PER_HOP + hits * OPS_PER_POTENTIAL_HIT)
    log(f"[10] wavefront_potential == its plain version on {sub.numel()} of "
        f"{members.numel()} members ({plain_ms:.1f} ms); kernel {ms:.3f} ms, "
        f"{hops} hops, {hits} hits, bound {b_ms:.4f} ms ({b_by})")
    rows = [{"name": "wavefront_potential", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/wavefront.cu",
             "replaces": "src/repro/kernels/wavefront.py:97",
             "launches": launches["wavefront_potential"],
             "path": "most_bound_centers at 2 eps", "card": card,
             "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
             "plain_input": "every 16th member of the path's queries",
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
             **traversal_fields(torch, kw, bvh, hops, ms, wave,
                                "wavefront_potential", shared=True),
             "hits": hits, "ops_per_hit": OPS_PER_POTENTIAL_HIT,
             "queries": q, "active": members.numel(),
             "path_s": mb_s, "path_peak_gib": mb_peak / 2**30}]
    del st, phi, pot_calls, args, kwargs, members, sub

    # Each SO launch: bit-equal to COUNT (the rope walk it replaced) on the
    # launch's inputs, both timed in one call in turns COUNT, SO, SO, COUNT,
    # and the SO count's hops, longest chain and far tests from its counter
    # instance. The first and the last launch also against the plain
    # version on their heaviest valid halos, where contained subtrees and
    # the lanes' sub-walks of a full stack do the work.
    per, heavy = [], []
    n_heavy = min(256, int(valid.sum()))
    with kw.shared_pack(bvh):
        for i, (args, kwargs, got) in enumerate(so_calls):
            b, c, rr = args
            require(torch.equal(kw.wavefront_count(b, c, rr), got),
                    "the SO count == COUNT on an SO launch's inputs")
            a1 = cuda_ms(torch, lambda: kw.wavefront_count(b, c, rr), 1, warmup=0)
            b1 = cuda_ms(torch, lambda: kw.wavefront_sphere_count(b, c, rr), 1)
            b2 = cuda_ms(torch, lambda: kw.wavefront_sphere_count(b, c, rr), 1,
                         warmup=0)
            a2 = cuda_ms(torch, lambda: kw.wavefront_count(b, c, rr), 1, warmup=0)
            cnt, st = kw.wavefront_sphere_count(b, c, rr, with_stats=True)
            require(torch.equal(cnt, got), "SO counts with and without counters")
            if i in (0, len(so_calls) - 1):
                hv = torch.topk(torch.where(valid, st[0], -1), n_heavy).indices
                heavy.append((c[hv], rr[hv], got[hv], st[:, hv]))
            # Reads: records, spans, right children, centres, r2; writes: counts.
            nb = sphere_tree_bytes(bvh) + c.shape[0] * (12 + 4) + c.shape[0] * 4
            h_i, f_i = (int(st[k].sum(dtype=torch.int64)) for k in (0, 2))
            per.append(((b1 + b2) / 2, (a1 + a2) / 2, h_i, int(st[1].max()), f_i,
                        *bound(nb, (h_i + f_i) * FLOPS_PER_HOP)))
    del so_calls, cnt, st
    # Both launches' heaviest halos in one plain walk on the CPU, where a
    # lockstep step costs a fraction of its launches and syncs on the card
    # (the walk takes as many steps as the heaviest halo's hops).
    cpu_bvh = type(bvh)(*(t.cpu() if torch.is_tensor(t) else t for t in bvh))
    h_c, h_r, h_cnt = (torch.cat(x).cpu() for x in list(zip(*heavy))[:3])
    h_st = torch.cat([h[3] for h in heavy], 1).cpu()
    t0 = time.perf_counter()
    p_cnt, p_st = kw.wavefront_sphere_count_plain(cpu_bvh, h_c, h_r, with_stats=True)
    heavy_plain = {"launches": [0, len(per) - 1], "queries": h_c.shape[0],
                   "max_hops": int(p_st[0].max()), "device": "cpu",
                   "ms": (time.perf_counter() - t0) * 1e3}
    require(torch.equal(p_cnt, h_cnt) and torch.equal(p_st[0], h_st[0])
            and torch.equal(p_st[2], h_st[2]),
            f"the plain version on the {n_heavy} heaviest valid halos of the "
            "first and the last SO launch")
    del cpu_bvh, heavy
    ms_l, count_l, hops_l, chain_l, far_l, bound_l, by_l = (list(x) for x in zip(*per))
    log(f"[10] SO launches (ms, COUNT's ms in the same turns, hops, longest "
        f"chain of dependent hops): "
        f"{[(round(a, 4), round(b, 2), c, d) for a, b, c, d, *_ in per]}")
    so_ms = sum(ms_l) / len(ms_l)
    count_ms = sum(count_l) / len(count_l)
    so_bound = sum(bound_l) / len(bound_l)
    so_by = max(set(by_l), key=by_l.count)
    log(f"[10] the SO count {so_ms:.4f} ms a launch against COUNT's {count_ms:.2f} "
        f"(A/B in one call), bound {so_bound:.4f} ms ({so_by}); {card}")
    log(f"[10] the plain version == the SO count, its hops and far tests on "
        f"the heaviest valid halos of the first and last launch: {heavy_plain}")
    rows.append({"name": "wavefront_count_so_mass",
                 "wrapper": "wavefront_sphere_count", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/wavefront.cu",
                 "replaces": "src/repro/kernels/wavefront.py:97",
                 "launches": launches["wavefront_sphere_count"],
                 "path": "so_masses (Delta 200, r_max 0.1; a radius per query)",
                 "card": card, "max_abs_err": 0.0, "ms": so_ms,
                 "count_ms": count_ms,
                 "plain_ms": small["sphere_plain_ms"],
                 "plain_input": small["plain_input"],
                 "ms_at_plain_input": small["sphere_ms_at_plain_input"],
                 "bound_ms": so_bound, "bound_by": so_by, "library_ms": None,
                 **traversal_fields(torch, kw, bvh,
                                    round(sum(hops_l) / len(hops_l)), so_ms,
                                    wave, "wavefront_sphere_count", shared=True),
                 "ms_per_launch": ms_l, "count_ms_per_launch": count_l,
                 "hops_per_launch": hops_l,
                 "longest_chain_per_launch": chain_l,
                 "far_tests_per_launch": far_l,
                 "plain_on_heaviest": heavy_plain,
                 "bound_ms_per_launch": bound_l, "queries": valid.numel(),
                 "valid_halos": int(valid.sum()),
                 "path_s": so_s, "path_peak_gib": so_peak / 2**30})

    # 64 sampled valid halos against a brute-force count.
    rng = np.random.default_rng(seed + 10)
    vi = torch.nonzero(valid).flatten()
    pick = vi[torch.from_numpy(rng.choice(vi.numel(), min(64, vi.numel()),
                                          replace=False)).to(DEV)]
    r_edge = torch.full((pick.numel(),), 0.1, dtype=torch.float32, device=DEV)
    edge = sphere_counts(bvh, pts, mb.center[pick], r_edge)
    for i, h in enumerate(pick.tolist()):
        c = mb.center[h]
        require(brute_counts(torch, pts, c, so.r_delta[h]) == int(so.count[h]),
                f"SO count of halo {h} at R_Delta against brute force")
        require(brute_counts(torch, pts, c, r_edge[i]) == int(edge[i]),
                f"SO count of halo {h} at r_max against brute force")
    share = float(so.bracketed[vi].float().mean())
    dist = (mb.center[vi] - cat.center[vi]).norm(dim=1) / eps
    log(f"[10] SO counts of {pick.numel()} sampled halos at R_Delta and at "
        f"r_max == brute force; bracketed share {share:.4f} of {vi.numel()} "
        f"valid halos; median most-bound to centre-of-mass distance "
        f"{dist.median().item():.4f} eps; largest M200 "
        f"{so.m_delta.max().item():.0f} particles")

    # The counters at the final SO radii: query_count(with_stats=True)
    # launches the counter instance of COUNT, once.
    for fn in kernels.values():
        fn.launches = 0
    pred = tq.within(mb.center[vi].contiguous(), so.r_delta[vi])
    with kw.shared_pack(bvh):
        cnt, stats = tq.query_count(bvh, pred, with_stats=True)
        stat_launches = kw.wavefront_count.launches
        require(stat_launches == 1 and torch.equal(cnt, so.count[vi]),
                "one counter launch at R_Delta gives the SO counts")
        c, rr = pred.centers.contiguous(), tq.squared_radii(pred)
        stats_ms = cuda_ms(torch, lambda: kw.wavefront_count(
            bvh, c, rr, depths=depths), 3)
        off_ms = cuda_ms(torch, lambda: kw.wavefront_count(bvh, c, rr), 3)
        so_cnt, so_st = kw.wavefront_sphere_count(bvh, c, rr, with_stats=True)
    require(torch.equal(so_cnt, cnt), "the SO count's counters at R_Delta")
    nodes = stats.nodes_visited.float()
    p99 = torch.quantile(nodes, 0.99).item()
    hops = int(stats.nodes_visited.sum(dtype=torch.int64))
    qv = vi.numel()
    nb = tree_bytes(bvh) + depths.numel() * 4 + qv * (12 + 4) + 6 * qv * 4
    b_ms, b_by = bound(nb, hops * FLOPS_PER_HOP)
    log(f"[10] counters at R_Delta over {qv} halos: nodes_visited largest "
        f"{int(nodes.max())}, 99th percentile {p99:.0f}, total {hops}; "
        f"max depth {int(stats.max_depth.max())}; counter instance "
        f"{stats_ms:.4f} ms against {off_ms:.4f} ms without; the SO count "
        f"there: {int(so_st[0].sum(dtype=torch.int64))} hops, largest "
        f"{int(so_st[0].max())}, longest chain {int(so_st[1].max())}")
    rows.append({"name": "wavefront_count_stats", "wrapper": "wavefront_count",
                 "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/wavefront.cu",
                 "replaces": "src/repro/kernels/wavefront.py:97",
                 "launches": stat_launches,
                 "path": "query_count(with_stats=True) at the final SO radii",
                 "card": card, "max_abs_err": 0.0, "ms": stats_ms,
                 "stats_off_ms": off_ms, "plain_ms": small["stats_plain_ms"],
                 "plain_input": small["plain_input"],
                 "ms_at_plain_input": small["stats_ms_at_plain_input"],
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                 **traversal_fields(torch, kw, bvh, hops, stats_ms, wave,
                                    "wavefront_count_stats", shared=True),
                 "queries": qv, "max_nodes_visited": int(nodes.max()),
                 "p99_nodes_visited": p99})
    return rows


# Float operations a hop of the box and slab tests. Box: per axis two
# subtractions, two maxes and a product, then two sums and the compare (18,
# as the sphere's). Ray: per axis two subtractions, two products, a min and
# a max, then two maxes and two mins across axes, the max with 0 and the
# compare. The flushes of subnormals (compares and selects) are not counted.
BOX_FLOPS_PER_HOP = 3 * 5 + 2 + 1
RAY_FLOPS_PER_HOP = 3 * 6 + 4 + 1 + 1
OPS_PER_HOP = {"sphere": FLOPS_PER_HOP, "box": BOX_FLOPS_PER_HOP,
               "ray": RAY_FLOPS_PER_HOP}
# HISTOGRAM per pair: the max, the square root, the division, the product
# and the floor. DenseBox per scanned point: three differences, three
# squares, two sums, the compare; per cell hit, the far corner: per axis a
# sum, a product, a difference, an abs and a sum, then three squares, two
# sums and the compare.
OPS_PER_BIN = 5
OPS_PER_SCAN_TEST = 9
OPS_PER_CELL_TEST = 3 * 5 + 3 + 2 + 1
STACK_RUNG_S = 60.0


@contextlib.contextmanager
def counted_step(torch, name: str, kernels: dict, tag: str = "[11]"):
    """Counters set to 0 before the block; its seconds (host clock to a
    synchronize), peak memory and launches by instance printed after."""
    reset_counts(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = {"step": name}
    t0 = time.perf_counter()
    yield rec
    torch.cuda.synchronize()
    rec["s"] = time.perf_counter() - t0
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["launches"] = instance_counts(kernels)
    log(f"{tag} {name}: {rec['s']:.3f} s, peak memory {rec['peak_gib']:.2f} "
        f"GiB, launches {rec['launches']}")


def rows_contain(torch, big, small, n: int, chunks: int = 16) -> bool:
    """Whether each row of the CSR ``small`` is, as a set, inside the same
    row of ``big``; in chunks of rows, by sorted keys row * n + index."""
    q = big.offsets.numel() - 1
    edges = np.linspace(0, q, chunks + 1).astype(np.int64)

    def keys(csr, a, b):
        off = csr.offsets.long()
        rows = torch.repeat_interleave(torch.arange(a, b, device=DEV),
                                       off[a + 1:b + 1] - off[a:b])
        return rows * n + csr.indices[int(off[a]):int(off[b])].long()

    for a, b in zip(edges[:-1].tolist(), edges[1:].tolist()):
        kb = keys(big, a, b).sort().values
        ks = keys(small, a, b)
        if ks.numel() and (kb.numel() == 0 or not bool(
                (kb[torch.searchsorted(kb, ks).clamp(max=kb.numel() - 1)]
                 == ks).all())):
            return False
    return True


def predicate_row(torch, kw, *, name, wrapper, pred, leaf, bvh, run, sub_run,
                  plain, hops, nbytes, launches, path, plain_input, card,
                  wave, wave_key):
    """A phase 9 row of a B1 (a)-(c) instance at phase 11's inputs:
    ``run()`` the path's launch (pack included, as the protocols pack per
    launch), ``sub_run()`` and ``plain()`` the kernel and its plain version
    on a part of the inputs, which must agree bit for bit."""
    ms = cuda_ms(torch, run, 3)
    got = sub_run()
    sub_ms = cuda_ms(torch, sub_run, 3)
    want, plain_ms = timed_once(torch, plain)
    same = all(torch.equal(g, w) for g, w in zip(
        got if isinstance(got, tuple) else (got,),
        want if isinstance(want, tuple) else (want,)))
    require(same, f"{name} {pred}/{leaf} on a part of the path's input")
    b_ms, b_by = bound(nbytes, hops * OPS_PER_HOP[pred])
    return {"name": name, "wrapper": wrapper, "instance": f"{pred}/{leaf}",
            "route": "cuda", "source": "src/repro_torch/kernels/csrc/wavefront.cu",
            "replaces": ("src/repro/kernels/wavefront.py:245" if wrapper ==
                         "wavefront_fill" else "src/repro/kernels/wavefront.py:97"),
            "launches": launches, "path": path, "card": card,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "plain_input": plain_input, "ms_at_plain_input": sub_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ops_per_hop": OPS_PER_HOP[pred],
            **traversal_fields(torch, kw, bvh, hops, ms, wave, wave_key)}


def phase11_predicates(seed: int, n: int, card: str, wave: dict):
    import torch
    tq = importlib.import_module("repro_torch.core.query")
    from repro_torch.core import morton
    from repro_torch.core.bvh import build_bvh, build_bvh_objects
    from repro_torch.core.dbscan import fdbscan
    from repro_torch.core.geometry import aabb_aabb_dist2, ray_box, safe_inv, scene_bounds
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.kernels import wavefront as kw

    t_all = time.perf_counter()
    pos, _, _ = plummer_cloud(seed, n)
    pts = torch.from_numpy(pos).to(DEV)
    del pos
    eps = hacc_benchmark_epsilon(1.0, n)
    lo, hi = scene_bounds(pts)
    kernels = kernel_wrappers()
    rng = np.random.default_rng(seed + 30)
    rows, steps = [], []
    sub_box = torch.from_numpy(rng.choice(n, min(n, 1 << 14), replace=False)).to(DEV)

    # 1. The 32-bit build: Table 1's shared codes, and fdbscan over it.
    with counted_step(torch, "build_bvh(use_64bit=False)", kernels) as rec:
        bvh32 = build_bvh(pts, lo, hi, use_64bit=False)
    steps.append(rec)
    with counted_step(torch, "build_bvh (63-bit codes)", kernels) as rec:
        bvh = build_bvh(pts, lo, hi)
    steps.append(rec)
    unit = morton.normalize_points(pts, lo, hi)
    table = {}
    for bits, codes in ((32, morton.morton32(unit)), (64, morton.morton64(unit))):
        _, inverse, counts = torch.unique(codes, return_inverse=True,
                                          return_counts=True)
        table[bits] = {"shared": int((counts[inverse] > 1).sum()),
                       "largest_run": int(counts.max())}
    del unit, codes, inverse, counts, bvh32
    log(f"[11] Table 1 at {n} particles: 30-bit codes shared by "
        f"{table[32]['shared']} points ({table[32]['shared'] / n:.4f}), "
        f"largest run {table[32]['largest_run']}; 63-bit codes shared by "
        f"{table[64]['shared']} ({table[64]['shared'] / n:.6f}), largest run "
        f"{table[64]['largest_run']}")
    with counted_step(torch, "fdbscan(use_64bit=False)", kernels) as rec:
        r32 = fdbscan(pts, eps, 2, use_64bit=False, device=DEV)
    steps.append(rec)
    r64 = fdbscan(pts, eps, 2, device=DEV)
    require(all(torch.equal(getattr(r32, f), getattr(r64, f)) for f in r32._fields),
            "fdbscan over 30-bit codes == over 63-bit codes")
    log(f"[11] fdbscan(use_64bit=False): labels, core mask and "
        f"{int(r64.num_rounds)} rounds == fdbscan()'s")
    del r32, r64

    # 2. IntersectsBox: each particle's eps-cube.
    order = bvh.leaf_perm
    sphere = tq.within(pts, eps)
    cubes = tq.intersects_box(pts - eps, pts + eps)
    qa, qb = cubes.lo.contiguous(), cubes.hi.contiguous()
    sph_counts = tq.query_count(bvh, sphere, order=order)
    with counted_step(torch, "IntersectsBox query_count (eps-cubes)", kernels) as rec:
        bc = tq.query_count(bvh, cubes, order=order)
    steps.append(rec)
    count_launches = rec["launches"].get("wavefront_count box/point", 0)
    require(bool((bc >= sph_counts).all()), "cube counts >= sphere counts")
    for i in rng.choice(n, 64, replace=False).tolist():
        brute = int((aabb_aabb_dist2(qa[i].expand(n, 3), qb[i].expand(n, 3),
                                     pts, pts) <= 0).sum())
        require(brute == int(bc[i]), f"cube count of particle {i} against brute force")
    with counted_step(torch, "IntersectsBox query_count(with_stats=True)", kernels) as rec:
        bc2, bst = tq.query_count(bvh, cubes, order=order, with_stats=True)
    steps.append(rec)
    stats_launches = rec["launches"].get("wavefront_count box/point", 0)
    require(torch.equal(bc, bc2), "counts with and without counters")
    box_hops = int(bst.nodes_visited.sum(dtype=torch.int64))
    log(f"[11] IntersectsBox counts: mean {bc.float().mean().item():.2f} "
        f"(sphere {sph_counts.float().mean().item():.2f}), largest {int(bc.max())}; "
        f">= the sphere counts; 64 sampled == brute force; {box_hops} hops")
    scsr = tq.query_csr(bvh, sphere, order=order)
    with counted_step(torch, "IntersectsBox query_csr exact", kernels) as rec:
        bcsr = tq.query_csr(bvh, cubes, order=order)
    steps.append(rec)
    csr_launches = rec["launches"]
    require(torch.equal(bcsr.offsets[1:] - bcsr.offsets[:-1], bc),
            "CSR row lengths == counts")
    require(rows_contain(torch, bcsr, scsr, n), "each cube row holds the sphere row")
    total = int(bcsr.total)
    log(f"[11] IntersectsBox query_csr: {total} hits (sphere {int(scsr.total)}); "
        f"every row holds its sphere row as a set")
    del scsr, bst, bc2
    with counted_step(torch, "IntersectsBox query_csr_buffered from 32", kernels) as rec:
        buf = tq.query_csr_buffered(bvh, cubes, capacity=32, order=order)
    steps.append(rec)
    require(torch.equal(buf.offsets, bcsr.offsets)
            and torch.equal(buf.indices, bcsr.indices),
            "query_csr_buffered == query_csr")
    log(f"[11] query_csr_buffered: {buf.attempts} attempts, == query_csr")
    fixed_launches = rec["launches"].get("wavefront_fixed box/point", 0)
    cap = 32 << (buf.attempts - 1)
    del buf
    sq = sub_box.numel()
    sa, sb = qa[sub_box].contiguous(), qb[sub_box].contiguous()
    s_off = exclusive_scan(torch, kw.wavefront_count(bvh, sa, sb, pred="box"),
                           torch.int32)
    s_tot = int(s_off[-1])
    plain_input = f"{sq} sampled queries of the {n}"
    box_q_bytes = tree_bytes(bvh) + n * (4 + 12 + 12)
    common = dict(pred="box", leaf="point", bvh=bvh, card=card, wave=wave,
                  plain_input=plain_input)
    rows.append(predicate_row(
        torch, kw, name="wavefront_count_box_point", wrapper="wavefront_count",
        run=lambda: kw.wavefront_count(bvh, qa, qb, pred="box", order=order),
        sub_run=lambda: kw.wavefront_count(bvh, sa, sb, pred="box"),
        plain=lambda: kw.wavefront_count_plain(bvh, sa, sb, pred="box"),
        hops=box_hops, nbytes=box_q_bytes + n * 4, launches=count_launches,
        path="query_count(IntersectsBox eps-cubes)", wave_key="wavefront_count_box_point",
        **common))
    depths = tq.node_depths(bvh)
    rows.append(predicate_row(
        torch, kw, name="wavefront_count_stats_box_point", wrapper="wavefront_count",
        run=lambda: kw.wavefront_count(bvh, qa, qb, pred="box", order=order,
                                       depths=depths),
        sub_run=lambda: kw.wavefront_count(bvh, sa, sb, pred="box", depths=depths),
        plain=lambda: kw.wavefront_count_plain(bvh, sa, sb, None, None, depths,
                                               pred="box"),
        hops=box_hops, nbytes=box_q_bytes + depths.numel() * 4 + n * 4 * 7,
        launches=stats_launches,
        path="query_count(IntersectsBox eps-cubes, with_stats=True)",
        wave_key="wavefront_count_stats_box_point", **common))
    rows.append(predicate_row(
        torch, kw, name="wavefront_fill_box_point", wrapper="wavefront_fill",
        run=lambda: kw.wavefront_fill(bvh, qa, qb, bcsr.offsets, total, pred="box",
                                      order=order),
        sub_run=lambda: kw.wavefront_fill(bvh, sa, sb, s_off, s_tot, pred="box"),
        plain=lambda: kw.wavefront_fill_plain(bvh, sa, sb, s_off, s_tot, pred="box"),
        hops=box_hops, nbytes=box_q_bytes + (n + 1) * 4 + total * 4,
        launches=csr_launches.get("wavefront_fill box/point", 0),
        path="query_csr(IntersectsBox eps-cubes) exact", wave_key="wavefront_fill_box_point",
        **common))
    rows.append(predicate_row(
        torch, kw, name="wavefront_fixed_box_point", wrapper="wavefront_fixed",
        run=lambda: kw.wavefront_fixed(bvh, qa, qb, 32, pred="box", order=order),
        sub_run=lambda: kw.wavefront_fixed(bvh, sa, sb, 32, pred="box"),
        plain=lambda: kw.wavefront_fixed_plain(bvh, sa, sb, 32, pred="box"),
        hops=box_hops, nbytes=box_q_bytes + n * 32 * 4 + n * 4,
        launches=fixed_launches,
        path=f"query_csr_buffered(IntersectsBox eps-cubes) from 32 (to {cap}); "
             f"ms at the first attempt's capacity 32",
        wave_key="wavefront_fixed_box_point", **common))
    del bcsr, cubes, qa, qb, sph_counts, bc

    # 3. Box leaves and rays: the particles' eps-boxes, 2^20 skewers.
    with counted_step(torch, "build_bvh_objects over the eps-boxes", kernels) as rec:
        obvh = build_bvh_objects(pts - eps, pts + eps, lo, hi)
    steps.append(rec)
    m = max(1 << 10, n >> 4)
    o, d = skewers(torch, seed + 31, m, lo, hi, pts)
    rays = tq.ray(o, d)
    ro, rinv = o, safe_inv(d)
    with counted_step(torch, f"rays query_count ({m} skewers, box leaves)", kernels) as rec:
        rc = tq.query_count(obvh, rays, sort_queries=True)
    steps.append(rec)
    ray_count_launches = rec["launches"].get("wavefront_count ray/box", 0)
    with counted_step(torch, "rays query_csr exact (box leaves)", kernels) as rec:
        rcsr = tq.query_csr(obvh, rays, sort_queries=True)
    steps.append(rec)
    ray_csr_launches = rec["launches"]
    require(torch.equal(rcsr.offsets[1:] - rcsr.offsets[:-1], rc), "ray CSR == counts")
    axis = torch.arange(0, m, 16, device=DEV)
    require(bool((rc[axis] >= 1).all()), "every axis-aligned skewer pierces "
            "the box of the particle above its origin")
    blo, bhi = pts - eps, pts + eps
    sample = rng.choice(m, 64, replace=False)
    sample[:8] = np.arange(0, 16 * 8, 16)           # axis-aligned ones
    sample[8:12] = np.arange(1, 64 * 4, 64)         # inverse +inf ones
    t_rows = []
    for i in sample.tolist():
        t, hit = ray_box(ro[i].expand(n, 3), rinv[i].expand(n, 3), blo, bhi)
        a, b = int(rcsr.offsets[i]), int(rcsr.offsets[i + 1])
        row = rcsr.indices[a:b].long()
        require(int(hit.sum()) == b - a and bool(hit[row].all()),
                f"ray {i}: CSR row == brute-force slab test")
        t_rows.append(t[row].cpu().numpy())
    kernels_before = instance_counts(kernels)
    with counted_step(torch, "generic query: index and t sums of 64 rays "
                             "(torch ops on the card)", kernels) as rec:
        sums = tq.query(obvh, tq.ray(o[sample], d[sample]),
                        lambda c, qi, j, t: ((c[0] + j, c[1] + t, c[2] + 1), False),
                        (torch.zeros((), dtype=torch.int64),
                         torch.zeros((), dtype=torch.float32),
                         torch.zeros((), dtype=torch.int32)))
    steps.append(rec)
    require(rec["launches"] == {}, "the generic query moves no counter")
    del kernels_before
    for k, i in enumerate(sample.tolist()):
        a, b = int(rcsr.offsets[i]), int(rcsr.offsets[i + 1])
        acc = np.float32(0)
        for v in t_rows[k]:
            acc = np.float32(acc + v)
        require(int(sums[2][k]) == b - a and int(sums[0][k]) == int(
            rcsr.indices[a:b].sum(dtype=torch.int64)), f"ray {i}: generic query")
        require(np.float32(sums[1][k].item()).view(np.int32)
                == acc.view(np.int32), f"ray {i}: t sum bits")
    log(f"[11] rays on box leaves: {int(rcsr.total)} hits, mean "
        f"{rc.float().mean().item():.2f} a ray, largest {int(rc.max())}; 64 "
        f"sampled rows == a brute-force slab test over all {n} boxes, and "
        f"their t sums (in rope order, from the generic query) bit-equal")
    depths_o = tq.node_depths(obvh)
    rq = m
    sub_ray = torch.from_numpy(rng.choice(m, min(m, 1 << 12), replace=False)).to(DEV)
    r_sa, r_sb = ro[sub_ray].contiguous(), rinv[sub_ray].contiguous()
    r_off = exclusive_scan(torch, kw.wavefront_count(obvh, r_sa, r_sb, pred="ray"),
                           torch.int32)
    r_tot = int(r_off[-1])
    rorder = tq.query_sort_permutation(obvh, o)
    ray_hops = int(kw.wavefront_count(obvh, ro, rinv, pred="ray", order=rorder,
                                      depths=depths_o)[1][0].sum(dtype=torch.int64))
    rtotal = int(rcsr.total)
    ray_bytes = tree_bytes(obvh) + rq * (4 + 12 + 12)
    common = dict(pred="ray", leaf="box", bvh=obvh, card=card, wave=wave,
                  plain_input=f"{sub_ray.numel()} sampled skewers of the {m}")
    rows.append(predicate_row(
        torch, kw, name="wavefront_count_ray_box", wrapper="wavefront_count",
        run=lambda: kw.wavefront_count(obvh, ro, rinv, pred="ray", order=rorder),
        sub_run=lambda: kw.wavefront_count(obvh, r_sa, r_sb, pred="ray"),
        plain=lambda: kw.wavefront_count_plain(obvh, r_sa, r_sb, pred="ray"),
        hops=ray_hops, nbytes=ray_bytes + rq * 4, launches=ray_count_launches,
        path=f"query_count(Ray) of {m} skewers on the eps-box tree",
        wave_key="wavefront_count_ray_box", **common))
    rows.append(predicate_row(
        torch, kw, name="wavefront_fill_ray_box", wrapper="wavefront_fill",
        run=lambda: kw.wavefront_fill(obvh, ro, rinv, rcsr.offsets, rtotal,
                                      pred="ray", order=rorder),
        sub_run=lambda: kw.wavefront_fill(obvh, r_sa, r_sb, r_off, r_tot, pred="ray"),
        plain=lambda: kw.wavefront_fill_plain(obvh, r_sa, r_sb, r_off, r_tot,
                                              pred="ray"),
        hops=ray_hops, nbytes=ray_bytes + (rq + 1) * 4 + rtotal * 4,
        launches=ray_csr_launches.get("wavefront_fill ray/box", 0),
        path=f"query_csr(Ray) of {m} skewers on the eps-box tree, exact",
        wave_key="wavefront_fill_ray_box", **common))
    del rcsr, rc

    # Spheres of radius 0 on the box leaves == degenerate boxes [p, p].
    oorder = obvh.leaf_perm
    with counted_step(torch, "Within(p, 0) query_count on the eps-box tree", kernels) as rec:
        c0 = tq.query_count(obvh, tq.within(pts, 0.0), order=oorder)
    steps.append(rec)
    s0_launches = rec["launches"].get("wavefront_count sphere/box", 0)
    with counted_step(torch, "IntersectsBox([p, p]) query_count on the eps-box tree",
                      kernels) as rec:
        c1 = tq.query_count(obvh, tq.intersects_box(pts, pts), order=oorder)
    steps.append(rec)
    b0_launches = rec["launches"].get("wavefront_count box/box", 0)
    require(torch.equal(c0, c1), "sphere r=0 == degenerate box on box leaves")
    require(bool((c0 >= 1).all()), "each particle lies in its own eps-box")
    log(f"[11] radius-0 spheres == degenerate boxes on the eps-box tree: mean "
        f"{c0.float().mean().item():.2f} boxes a particle")
    zero = torch.zeros(n, dtype=torch.float32, device=DEV)
    hops0 = int(kw.wavefront_count(obvh, pts, zero, order=oorder, depths=depths_o)[1][0]
                .sum(dtype=torch.int64))
    s_pts = pts[sub_box].contiguous()
    for pred, qb_, launches, name in (("sphere", zero, s0_launches,
                                       "wavefront_count_sphere_box"),
                                      ("box", pts, b0_launches,
                                       "wavefront_count_box_box")):
        s_qb = qb_[sub_box].contiguous()
        rows.append(predicate_row(
            torch, kw, name=name, wrapper="wavefront_count", pred=pred, leaf="box",
            bvh=obvh, card=card, wave=wave,
            plain_input=f"{sub_box.numel()} sampled particles of the {n}",
            run=lambda p=pred, b=qb_: kw.wavefront_count(obvh, pts, b, pred=p,
                                                         order=oorder),
            sub_run=lambda p=pred, b=s_qb: kw.wavefront_count(obvh, s_pts, b, pred=p),
            plain=lambda p=pred, b=s_qb: kw.wavefront_count_plain(obvh, s_pts, b,
                                                                   pred=p),
            hops=hops0, nbytes=tree_bytes(obvh) + n * (4 + 12 + 12 + 4),
            launches=launches,
            path=("query_count(Within(p, 0))" if pred == "sphere" else
                  "query_count(IntersectsBox([p, p]))") + " on the eps-box tree",
            wave_key=name))
    del c0, c1, zero, obvh, depths_o

    # Rays on the point tree, from particles: each hits at least its own
    # particle (t = 0 on every axis), unless a component's inverse is +inf.
    k = torch.from_numpy(rng.integers(0, n, m)).to(DEV)
    po = pts[k].contiguous()
    pd = d.clone()
    with counted_step(torch, f"rays from particles query_count ({m}, point tree)",
                      kernels) as rec:
        pc = tq.query_count(bvh, tq.ray(po, pd), sort_queries=True)
    steps.append(rec)
    rp_launches = rec["launches"].get("wavefront_count ray/point", 0)
    pinv = safe_inv(pd)
    finite = torch.isfinite(pinv).all(1)
    require(bool((pc[finite] >= 1).all()), "a ray from a particle hits it")
    for i in sample[:16].tolist():
        _, hit = ray_box(po[i].expand(n, 3), pinv[i].expand(n, 3), pts, pts)
        require(int(hit.sum()) == int(pc[i]), f"ray {i} on points: brute force")
    log(f"[11] rays from particles on the point tree: mean "
        f"{pc.float().mean().item():.3f} points a ray; those with finite "
        f"inverses >= 1; 16 sampled == brute force")
    porder = tq.query_sort_permutation(bvh, po)
    hops_p = int(kw.wavefront_count(bvh, po, pinv, pred="ray", order=porder,
                                    depths=depths)[1][0].sum(dtype=torch.int64))
    ps_a, ps_b = po[sub_ray].contiguous(), pinv[sub_ray].contiguous()
    rows.append(predicate_row(
        torch, kw, name="wavefront_count_ray_point", wrapper="wavefront_count",
        pred="ray", leaf="point", bvh=bvh, card=card, wave=wave,
        plain_input=f"{sub_ray.numel()} sampled rays of the {m}",
        run=lambda: kw.wavefront_count(bvh, po, pinv, pred="ray", order=porder),
        sub_run=lambda: kw.wavefront_count(bvh, ps_a, ps_b, pred="ray"),
        plain=lambda: kw.wavefront_count_plain(bvh, ps_a, ps_b, pred="ray"),
        hops=hops_p, nbytes=tree_bytes(bvh) + m * (4 + 12 + 12 + 4),
        launches=rp_launches, path=f"query_count(Ray) of {m} rays from particles "
                                   f"on the point tree",
        wave_key="wavefront_count_ray_point"))
    del pc, po, pd, pinv, depths

    seen = set()
    for rec in steps:
        seen.update(k for k in rec["launches"] if " " in k)
    for pred, leaf in NEW_KINDS:
        require(f"wavefront_count {pred}/{leaf}" in seen,
                f"COUNT {pred}/{leaf} launched in phase 11")
    for key in ("wavefront_fill box/point", "wavefront_fixed box/point",
                "wavefront_fill ray/box"):
        require(key in seen, f"{key} launched in phase 11")
    del bvh

    # 4. The stack rungs: fdbscan(use_stack=True), its count pass in torch
    # ops (the reference's stack backend is no kernel either).
    def rung(size: int, early: bool):
        p_, _, _ = plummer_cloud(seed, size)
        p_ = torch.from_numpy(p_).to(DEV)
        e_ = hacc_benchmark_epsilon(1.0, size)
        with counted_step(torch, f"fdbscan(use_stack=True, early_stop={early}) "
                                 f"at 2^{size.bit_length() - 1}: count pass in "
                                 f"torch ops on the card", kernels) as rec:
            r = fdbscan(p_, e_, 2, use_stack=True, early_stop=early, device=DEV)
        ref = fdbscan(p_, e_, 2, device=DEV)
        require(torch.equal(r.labels, ref.labels) and torch.equal(
            r.core_mask, ref.core_mask), "stack rung labels == fdbscan's")
        require("wavefront_count sphere/point" not in rec["launches"],
                "the stack rung's count pass launches no kernel")
        return rec

    # The largest power of two that finishes within the limit: a guess
    # from a probe at 2^18, then one power up at a time while a run
    # finishes, one down while it does not.
    probe = rung(min(n, 1 << 18), False)
    log2n = n.bit_length() - 1
    k = min(log2n, 18 + int(np.floor(np.log2(STACK_RUNG_S / max(probe["s"], 1e-3)))))
    fits = {}
    while k not in fits and 10 <= k <= log2n:
        fits[k] = rung(1 << k, False)
        if fits[k]["s"] > STACK_RUNG_S:
            log(f"[11] 2^{k} took {fits[k]['s']:.1f} s, over {STACK_RUNG_S:.0f} s")
            k -= 1
        elif k < log2n:
            k += 1
    passed = [j for j, r in fits.items() if r["s"] <= STACK_RUNG_S]
    require(bool(passed), f"a stack rung finishes in {STACK_RUNG_S:.0f} s")
    k = max(passed)
    slow = fits[k]
    fast = rung(1 << k, True)
    require(fast["s"] <= STACK_RUNG_S, "rung (2) within the time")
    log(f"[11] stack rungs at 2^{k} (the largest power of two <= 2^{log2n} that "
        f"finishes in {STACK_RUNG_S:.0f} s; torch ops, not a kernel): rung (2) "
        f"{fast['s']:.2f} s, rung (2b) {slow['s']:.2f} s; labels == fdbscan's")
    log(f"[11] phase 11 steps: {json.dumps(steps)}; table {json.dumps(table)}; "
        f"{time.perf_counter() - t_all:.1f} s")
    return rows


def c9_points(torch):
    """ROADMAP C9's four points: (0,0,0), (1,1,1) and the centres of cells
    (1,1,1) and (1431,153,611) of DenseBox's grid at eps = 1e-3 (1733^3
    cells of eps/sqrt(3)), whose int32 linear ids differ by exactly 2^32.
    The reference's DenseBox puts the two centres in one cluster; they lie
    0.9 apart."""
    from repro_torch.core.geometry import scene_bounds
    base = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    lo = scene_bounds(base)[0].double()
    cs = float(torch.tensor(1e-3) / torch.tensor(3 ** 0.5))
    cells = torch.tensor([[1.5, 1.5, 1.5], [1431.5, 153.5, 611.5]], dtype=torch.float64)
    return torch.cat([base, (lo + cells * cs).float()])


def histogram_threshold_checks(torch, kw, n_bins: int = 16, chunk: int = 1 << 26):
    """HISTOGRAM_PRIVATE's thresholds at phase 12's r_max (4 eps at 2^24
    particles): the card's (``histogram_edges_kernel``) bit-equal to the
    CPU twin's, also at other r_max and n_bins; and the bin the walk's
    rule gives (``threshold_probe_kernel``: a first bin from rsqrtf, the
    thresholds deciding near an edge) equal to the IEEE sequence's
    (``bin_probe_kernel``) on every float32 in [0, fl(r_max)^2], the
    squared distances a hit can have, at that r_max with 16, 23 and 1
    bins and at two other r_max."""
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    r_max = 4 * hacc_benchmark_epsilon(1.0, 1 << 24)
    for r, nb in ((r_max, n_bins), (r_max, kw.PRIVATE_HISTOGRAM_BINS), (1e-4, 7),
                  (1.0, 3), (0.3, 100), (1e-4, 6145)):
        got = kw.histogram_edges(r, nb, DEV)
        want = kw.histogram_thresholds(r, nb, "cpu")
        require(torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)),
                f"histogram_edges r_max {r} n_bins {nb}: card == CPU twin")
    t0 = time.perf_counter()
    values = 0
    for r, nb in ((r_max, n_bins), (r_max, kw.PRIVATE_HISTOGRAM_BINS), (r_max, 1),
                  (1.0, 7), (1e-4, 2)):
        edges = kw.histogram_edges(r, nb, DEV)
        top = int(torch.tensor(r, dtype=torch.float32).square().view(torch.int32))
        for lo in range(0, top + 1, chunk):
            d2 = torch.arange(lo, min(lo + chunk, top + 1), dtype=torch.int32,
                              device=DEV).view(torch.float32)
            require(torch.equal(kw.threshold_bins_rn(d2, edges, r),
                                kw.histogram_bins_rn(d2, r, nb)),
                    f"r_max {r}, {nb} bins: the walk's bin against the IEEE bin on "
                    f"floats {lo}..{lo + chunk}")
        values += top + 1
    torch.cuda.synchronize()
    log(f"[2] HISTOGRAM's thresholds (r_max {r_max:.6g}, {n_bins} bins) card == CPU twin "
        f"bit for bit (and at five other r_max, n_bins); the walk's bin == "
        f"bin_probe_kernel's on every float32 in [0, fl(r_max)^2] at that r_max with "
        f"{n_bins}, {kw.PRIVATE_HISTOGRAM_BINS} and 1 bins, at r_max 1 with 7 and at "
        f"1e-4 with 2 ({values} values) in {time.perf_counter() - t0:.2f} s; "
        f"thresholds {kw.histogram_edges(r_max, n_bins, DEV).tolist()}")


def pair_kernel_checks(seed, bvh, pts, eps):
    """Phase 2's EDGE, HISTOGRAM and DenseBox checks on the 2^20 tree, and
    HISTOGRAM's bin sequence on 2^24 squared distances."""
    import torch
    from repro_torch.core.dbscan import densebox_tree
    from repro_torch.kernels import wavefront as kw

    n = pts.shape[0]
    rng = np.random.default_rng(seed + 40)
    perm = bvh.leaf_perm.long()
    centers = pts[perm].contiguous()
    r2 = torch.full((n,), eps, dtype=torch.float32, device=DEV) ** 2
    starts = kw.pair_starts(bvh)
    core = torch.from_numpy(rng.random(n) < 0.8).to(DEV)
    parent = torch.from_numpy(rng.integers(0, n // 64, n).astype(np.int32)).to(DEV)
    keys = kw.pair_keys(bvh, parent, core)
    for cap in (1, 2, 8):
        got = kw.wavefront_edge(bvh, centers, r2, keys, cap, start=starts)
        want = kw.wavefront_edge_plain(bvh, centers, r2, keys, cap, starts)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"wavefront_edge capacity {cap}")
        log(f"[2] wavefront_edge capacity {cap}: buffer and counts bit-equal "
            f"over {n} pair queries, {int(got[1].sum())} edges, "
            f"{int((got[1] == cap).sum())} full buffers")
    r2h = torch.full((n,), 2 * eps, dtype=torch.float32, device=DEV) ** 2
    got = kw.wavefront_histogram(bvh, centers, r2h, 2 * eps, 16, start=starts)
    want = kw.wavefront_histogram_plain(bvh, centers, r2h, 2 * eps, 16, starts)
    require(torch.equal(got, want), "wavefront_histogram 16 bins")
    log(f"[2] wavefront_histogram 16 bins (private) at 2 eps: exact, {int(got.sum())} "
        f"pairs, bins {got.tolist()}")
    # The three regimes: private bins up to PRIVATE_HISTOGRAM_BINS, the
    # block's shared bins up to SHARED_HISTOGRAM_BINS, the global bins past
    # it; every 16th query, so that the plain version stays short.
    sub = slice(None, None, 16)
    sc, sr, ss = centers[sub].contiguous(), r2h[sub].contiguous(), starts[sub].contiguous()
    times = {}
    for nb, regime in ((kw.PRIVATE_HISTOGRAM_BINS, "private"),
                       (kw.PRIVATE_HISTOGRAM_BINS + 1, "shared"),
                       (kw.SHARED_HISTOGRAM_BINS + 2048, "global")):
        got = kw.wavefront_histogram(bvh, sc, sr, 2 * eps, nb, start=ss)
        want = kw.wavefront_histogram_plain(bvh, sc, sr, 2 * eps, nb, ss)
        require(torch.equal(got, want), f"wavefront_histogram {nb} bins ({regime})")
        times[f"{nb} ({regime})"] = cuda_ms(torch, lambda: kw.wavefront_histogram(
            bvh, sc, sr, 2 * eps, nb, start=ss), 3)
    times["16 (private)"] = cuda_ms(torch, lambda: kw.wavefront_histogram(
        bvh, sc, sr, 2 * eps, 16, start=ss), 3)
    log(f"[2] wavefront_histogram at 2 eps over {sc.shape[0]} queries, "
        f"{int(got.sum())} pairs: exact in each regime; ms by bins {json.dumps(times)} "
        f"({card_identity()})")
    histogram_threshold_checks(torch, kw)
    d = torch.from_numpy(rng.random(1 << 24).astype(np.float32)).to(DEV) * (2 * eps)
    edges = (torch.arange(17, dtype=torch.float32, device=DEV) * (2 * eps / 16)) ** 2
    d2 = torch.cat([d * d, edges, torch.nextafter(edges, edges + 1),
                    torch.nextafter(edges, edges - 1),
                    torch.tensor([1e-40, 0.0, 1e-31], device=DEV)])
    require(torch.equal(kw.histogram_bins_rn(d2, 2 * eps, 16),
                        kw.histogram_bins(d2, 2 * eps, 16)),
            "HISTOGRAM's bin sequence against histogram_bins")
    log(f"[2] HISTOGRAM's bin sequence: {d2.numel()} squared distances (bin "
        f"edges, their neighbours and subnormals included) bit-equal to "
        f"histogram_bins")
    del got, want, d, d2, keys

    for min_pts in (2, 5):
        t = densebox_tree(pts, eps, min_pts)
        kinds = {k: int((t.kind == v).sum()) for k, v in (
            ("cell", kw.DENSE_CELL), ("point", kw.DENSE_POINT))}
        require(all(kinds.values()), f"DenseBox leaves of every kind {kinds}")
        heads = t.dense & t.grid.is_run_head()
        want_obj = torch.nonzero(heads | ~t.dense).flatten().int()
        require(torch.equal(t.obj, want_obj) and torch.equal(
            t.kind == kw.DENSE_CELL, heads[want_obj.long()]),
            "DenseBox's leaves: the dense cells' run heads and the loose points")
        require(torch.equal(t.order.sort().values,
                            torch.arange(n, dtype=torch.int32, device=DEV)),
                "DenseBox's query order is a permutation of the n points")
        lab = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(DEV)
        for scan_lab in (lab, None):
            require(torch.equal(kw.dense_scan_records(t.pts_sorted, scan_lab).view(torch.int32),
                                kw.dense_scan_records_plain(t.pts_sorted, scan_lab)
                                .view(torch.int32)), "dense_scan_records")
        words = t.words(lab)
        order = t.order
        for stop in (None, min_pts):
            tally = {}
            got = kw.wavefront_dense_count(t.bvh, t.pts_sorted, t.r2, words, t.pts_sorted,
                                           t.half, stop_at=stop, qmask=~t.dense,
                                           order=order)
            want = kw.wavefront_dense_count_plain(t.bvh, t.pts_sorted, t.r2, words,
                                                  t.pts_sorted, t.half, stop, ~t.dense,
                                                  tally)
            require(torch.equal(got, want), f"wavefront_dense_count min_pts "
                    f"{min_pts} stop_at {stop}")
            log(f"[2] wavefront_dense_count min_pts={min_pts} stop_at={stop}: exact; "
                f"leaves {kinds} ({t.bvh.num_leaves} of {n}), cell hits {tally}")
        qmask = torch.from_numpy(rng.random(n) < 0.7).to(DEV)
        tally = {}
        got = kw.wavefront_dense_min_label(t.bvh, t.pts_sorted, t.r2, words,
                                           t.pts_sorted, lab, t.half, qmask, n,
                                           order=order)
        want = kw.wavefront_dense_min_label_plain(t.bvh, t.pts_sorted, t.r2, words,
                                                  t.pts_sorted, lab, t.half, qmask, n,
                                                  tally)
        require(torch.equal(got, want), f"wavefront_dense_min_label min_pts {min_pts}")
        require(tally.get("whole", 0) > 0 and tally.get("scanned", 0) > 0,
                f"whole and partial cells {tally}")
        log(f"[2] wavefront_dense_min_label min_pts={min_pts}: exact over "
            f"{int(qmask.sum())} queries, cell hits {tally}")


def subnormal_rows(torch, rng, m, d, scale=1.0):
    """Rows mixing subnormal, tiny and ordinary coordinates and zeros."""
    x = rng.random((m, d)).astype(np.float32) * np.float32(scale)
    pick = rng.random((m, d))
    tiny = np.array([1e-20, -1e-20, 3e-39, -5e-40, 1e-45, 2e-19], np.float32)
    x[pick < 0.3] = rng.choice(tiny, int((pick < 0.3).sum()))
    x[pick > 0.9] = 0.0
    return torch.from_numpy(x).to(DEV)


def c7_kernel_checks(seed):
    """Phase 2's B5-B8 against their plain versions on inputs whose
    products and differences fall below FLT_MIN (ROADMAP C7)."""
    import torch
    from repro_torch.kernels import pairwise as kp
    rng = np.random.default_rng(seed + 41)
    for m, n, d in ((3001, 5003, 3), (3001, 5003, 64), (129, 257, 1)):
        x, y = subnormal_rows(torch, rng, m, d), subnormal_rows(torch, rng, n, d)
        lab = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(DEV)
        core = torch.from_numpy(rng.random(n) < 0.5).to(DEV)
        for eps2 in (0.0, float(np.float32(0.3 * d ** 0.5) ** 2)):
            require(torch.equal(kp.pairwise_count(x, y, eps2),
                                kp.pairwise_count_plain(x, y, eps2)) and
                    torch.equal(kp.pairwise_min_label(x, y, lab, core, eps2),
                                kp.pairwise_min_label_plain(x, y, lab, core, eps2)),
                    f"all pairs with subnormals at {m}x{n}x{d}, eps2 {eps2}")
    a = torch.tensor([[1e-20, 0.0, 0.0]], device=DEV)
    require(int(kp.pairwise_count(a, torch.zeros((1, 3), device=DEV), 0.0)[0]) == 1,
            "C7: (1e-20, 0, 0) against the origin at eps = 0")
    ncells, cap = 4096, 16
    cell_pts = torch.full((ncells + 1, cap, 3), kp.BIG, device=DEV)
    occ = torch.from_numpy(rng.random((ncells, cap)) < 0.6).to(DEV)
    cell_pts[:-1][occ] = subnormal_rows(torch, rng, int(occ.sum()), 3, 1e-3)
    nbr = torch.from_numpy(rng.integers(-3, ncells + 4, (ncells, 27)).astype(np.int32)).to(DEV)
    labels = torch.from_numpy(rng.permutation((ncells + 1) * cap).astype(np.int32)
                              .reshape(ncells + 1, cap)).to(DEV)
    core = torch.from_numpy(rng.random((ncells + 1, cap)) < 0.5).to(DEV)
    for eps2 in (0.0, 1e-6):
        require(torch.equal(kp.stencil_count(cell_pts, nbr, eps2),
                            kp.stencil_count_plain(cell_pts, nbr, eps2)) and
                torch.equal(kp.stencil_min_label(cell_pts, labels, core, nbr, eps2),
                            kp.stencil_min_label_plain(cell_pts, labels, core, nbr,
                                                       eps2)),
                f"stencil kernels with subnormals, eps2 {eps2}")
    log("[2] B5-B8 with subnormal inputs, products and differences (all pairs at "
        "3001x5003 for d = 3, 64 and 129x257x1; stencil at 4096 cells x 16): "
        "bit-equal to their plain versions at eps2 = 0 and above; C7's case "
        "counts 1")


def phase3_pair_and_densebox(seed: int, n: int = 1 << 15):
    """The card against the CPU path, exactly: fdbscan_pair, fdbscan_densebox
    and pair_count_histogram at ``n`` Plummer particles, and the C9 case."""
    import torch
    from repro_torch.core import correlation as tc
    from repro_torch.core import dbscan as td
    from repro_torch.data.pipeline import hacc_benchmark_epsilon

    pos, _, _ = plummer_cloud(seed + 42, n)
    eps = hacc_benchmark_epsilon(1.0, n)
    kernels = kernel_wrappers()
    for name, fn, kw_args in (("fdbscan_pair", td.fdbscan_pair, {"edge_capacity": 8}),
                              ("fdbscan_densebox", td.fdbscan_densebox, {})):
        reset_counts(kernels)
        a = fn(pos, eps, 2, device=DEV, **kw_args)
        launched = instance_counts(kernels)
        b = fn(pos, eps, 2, device="cpu", **kw_args)
        require(all(torch.equal(getattr(a, f).cpu(), getattr(b, f)) for f in a._fields),
                f"{name}: card == CPU")
        log(f"[3] {name} at {n}: labels, core mask and {int(a.num_rounds)} rounds "
            f"card == CPU; launches {launched}")
    reset_counts(kernels)
    a = tc.pair_count_histogram(pos, 2 * eps, 16, device=DEV)
    require(kernels["wavefront_histogram"].launches == 1, "one HISTOGRAM launch")
    require(kernels["histogram_edges"].launches == 1, "one thresholds prologue launch")
    require(torch.equal(a.cpu(), tc.pair_count_histogram(pos, 2 * eps, 16, device="cpu")),
            "pair_count_histogram: card == CPU")
    log(f"[3] pair_count_histogram at {n}, 2 eps, 16 bins: card == CPU, "
        f"{int(a.sum())} pairs")
    pts = c9_points(torch)
    got = td.fdbscan_densebox(pts, 1e-3, 2, device=DEV)
    want = td.fdbscan(pts, 1e-3, 2, device=DEV)
    require(torch.equal(got.labels, want.labels) and torch.equal(got.core_mask, want.core_mask),
            "C9: DenseBox == fdbscan on the four points")
    log(f"[3] C9: fdbscan_densebox labels {got.labels.tolist()} == fdbscan's "
        f"(the reference's int32 ids wrap and give [-1, -1, 2, 2])")


PAIR_KERNELS = ("wavefront_edge", "wavefront_histogram", "histogram_edges",
                "wavefront_dense_count", "wavefront_dense_min_label")
# fdbscan_densebox's stages, by the function of ``core.dbscan`` each runs in.
DENSEBOX_STAGES = {"grid": "build_cell_grid", "tree": "densebox_tree",
                   "count": "wavefront_dense_count",
                   "union": "wavefront_dense_min_label"}


@contextlib.contextmanager
def densebox_stages(torch, td, secs: dict):
    """Inside the block, ``fdbscan_densebox``'s seconds by stage go to
    ``secs``: the grid (``build_cell_grid``), the tree (the rest of
    ``densebox_tree``: the tree over the dense cells and loose points,
    its words and the query order), the count pass, the union rounds
    (every DENSE_MIN_LABEL call but the last, ``union_calls`` of them)
    and the border pass (the last). Each call is timed on the host clock
    between two synchronizes; what the stages leave out of a step's
    seconds (hooks, labels, the pre-union) is the step's other time."""
    times = {k: [] for k in DENSEBOX_STAGES}

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
            return res
        return run

    with contextlib.ExitStack() as stack:
        for key, name in DENSEBOX_STAGES.items():
            stack.enter_context(swapped(td, name, timed(key, getattr(td, name))))
        yield secs
    union = times["union"]
    secs.update({"grid": sum(times["grid"]),
                 "tree": sum(times["tree"]) - sum(times["grid"]),
                 "count": sum(times["count"]), "union": sum(union[:-1]),
                 "union_calls": len(union) - 1, "border": union[-1] if union else 0.0})


def phase12_pair_and_densebox(seed: int, n: int, card: str, wave: dict):
    """Phase 12: fdbscan_pair, fdbscan_densebox and pair_count_histogram at
    phase 4's cloud and eps, each step timed with its peak memory and
    launches by instance; then a phase 9 row for each new epilogue at the
    step's own inputs."""
    import torch
    tq = importlib.import_module("repro_torch.core.query")
    from repro_torch.core import correlation as tc
    from repro_torch.core import dbscan as td
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.cell_grid import build_cell_grid
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.kernels import wavefront as kw

    t_all = time.perf_counter()
    pos, _, _ = plummer_cloud(seed, n)
    pts = torch.from_numpy(pos).to(DEV)
    del pos
    eps = hacc_benchmark_epsilon(1.0, n)
    kernels = kernel_wrappers()
    steps, calls = [], {k: [] for k in PAIR_KERNELS}

    with counted_step(torch, "fdbscan", kernels, "[12]") as rec:
        ref = td.fdbscan(pts, eps, 2, device=DEV)
    steps.append(rec)
    with contextlib.ExitStack() as stack:
        for k in ("wavefront_edge", "wavefront_dense_count", "wavefront_dense_min_label"):
            stack.enter_context(tap(td, k, calls[k]))
        with counted_step(torch, "fdbscan_pair(edge_capacity=8)", kernels, "[12]") as rec:
            pr = td.fdbscan_pair(pts, eps, 2, edge_capacity=8, device=DEV)
        steps.append(rec)
        stages = {}
        with densebox_stages(torch, td, stages), \
                counted_step(torch, "fdbscan_densebox", kernels, "[12]") as rec:
            db = td.fdbscan_densebox(pts, eps, 2, device=DEV)
        rec["stages"] = stages
        steps.append(rec)
    for rec, names in ((steps[1], ("wavefront_edge", "wavefront_min_label")),
                       (steps[2], ("wavefront_dense_count", "wavefront_dense_min_label"))):
        for k in names:
            require(rec["launches"].get(f"{k} sphere/{'box' if 'dense' in k else 'point'}", 0) > 0,
                    f"{k} was not launched in {rec['step']}")
    for name, res in (("fdbscan_pair", pr), ("fdbscan_densebox", db)):
        require(torch.equal(res.labels, ref.labels) and
                torch.equal(res.core_mask, ref.core_mask),
                f"{name}: labels and core mask == fdbscan's")
    lo, hi = scene_bounds(pts)
    grid = build_cell_grid(pts, lo, hi, float(torch.tensor(eps) / torch.tensor(3 ** 0.5)))
    cells = int(torch.prod(grid.dims.long()))
    largest = int(grid.run_length.max())
    m = calls["wavefront_dense_count"][0][0][0].num_leaves
    other = rec["s"] - sum(v for k, v in stages.items() if k != "union_calls")
    log(f"[12] fdbscan_pair and fdbscan_densebox: labels and core mask == "
        f"fdbscan's; rounds pair {int(pr.num_rounds)}, densebox "
        f"{int(db.num_rounds)}, fdbscan {int(ref.num_rounds)}; DenseBox's grid "
        f"{grid.dims.tolist()} = {cells} cells ({cells / 2**31:.2f} x 2^31), "
        f"largest run {largest}, dense points (min_pts 2) "
        f"{int((grid.run_length >= 2).sum())}; DenseBox's tree {m} leaves of "
        f"{n} points ({m / n:.4f}); fdbscan_densebox {rec['s']:.4f} s by stage "
        f"{json.dumps(stages)}, other {other:.4f} s; {card}")
    del ref, pr, db, grid

    r_max = 4 * eps
    with tap(tc, "wavefront_histogram", calls["wavefront_histogram"]):
        with counted_step(torch, "pair_count_histogram(r_max=4 eps, 16 bins)", kernels,
                          "[12]") as rec:
            hist = tc.pair_count_histogram(pts, r_max, 16, device=DEV)
        steps.append(rec)
    require(rec["launches"].get("wavefront_histogram sphere/point", 0) == 1,
            "wavefront_histogram was not launched once in pair_count_histogram")
    require(rec["launches"].get("histogram_edges", 0) == 1,
            "histogram_edges was not launched once in pair_count_histogram")
    bvh = build_bvh(pts, lo, hi)
    within4 = int(tq.query_count(bvh, tq.within(pts, r_max), order=bvh.leaf_perm)
                  .sum(dtype=torch.int64))
    require(int(hist.sum()) * 2 == within4 - n,
            "histogram total == (sum of 4 eps counts - n) / 2")
    log(f"[12] pair_count_histogram: {int(hist.sum())} pairs == ({within4} - {n}) / 2; "
        f"bins {hist.tolist()}")
    del bvh, hist
    log(f"[12] phase 12 steps: {json.dumps(steps)}; {time.perf_counter() - t_all:.1f} s")
    return pair_rows(torch, kw, calls, steps, n, card, wave)


def pair_rows(torch, kw, calls, steps, n, card, wave):
    """Phase 9's rows of EDGE, HISTOGRAM, DENSE_COUNT and DENSE_MIN_LABEL,
    each at its first launch's inputs in phase 12: the kernel timed as the
    path runs it, its plain version and the hops (EDGE and the DenseBox
    pair: the plain version over every query, bit-equal to the kernel;
    HISTOGRAM: the plain version over 2^12 of the queries, the hops of all
    from the counter instance)."""
    src = "src/repro_torch/kernels/csrc/wavefront.cu"
    ref = "src/repro/kernels/wavefront.py:97"
    launches = {}
    for rec in steps:
        for key, v in rec["launches"].items():
            name = key.split(" ")[0]
            if name in PAIR_KERNELS:
                launches.setdefault(name, (v, rec["step"]))
    rows = []

    def row(name, bvh, shared, ms, plain_ms, nbytes, ops, hops, plain_input, extra):
        b_ms, b_by = bound(nbytes, ops)
        v, path = launches.get(name, (0, None))
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": ref,
                     "launches": v, "path": path, "card": card, "max_abs_err": 0.0,
                     "ms": ms, "plain_ms": plain_ms, "plain_input": plain_input,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     **traversal_fields(torch, kw, bvh, hops, ms, wave, name, shared),
                     **extra})

    (bvh, centers, r2, keys, cap), kwa, got = calls["wavefront_edge"][0]
    with kw.shared_pack(bvh):
        ms = cuda_ms(torch, lambda: kw.wavefront_edge(bvh, centers, r2, keys, cap, **kwa), 3)
    start = kwa["start"]
    lanes = torch.nonzero(keys[:, 1] >= 0).flatten()
    buf = torch.full((n, cap), -1, dtype=torch.int32, device=DEV)
    carry0 = torch.stack([torch.zeros_like(lanes), lanes], 1)
    (carry, hops), plain_ms = timed_once(torch, lambda: kw.lockstep_traverse(
        bvh, centers, r2, lanes, carry0, kw.edge_epilogue(bvh, keys, buf), start=start))
    require(torch.equal(buf, got[0]) and torch.equal(
        carry[:, 0].int(), got[1][lanes]), "wavefront_edge on phase 12's input")
    nb = tree_bytes(bvh) + n * (12 + 4 + 4 + 8 + 4) + buf.numel() * 4
    row("wavefront_edge", bvh, True, ms, plain_ms, nb, hops * FLOPS_PER_HOP, hops,
        "every query", {"capacity": cap, "edges": int(got[1].sum())})
    del buf, carry, got

    (bvh, centers, r2, r_max, n_bins), kwa, got = calls["wavefront_histogram"][0]
    ms = cuda_ms(torch, lambda: kw.wavefront_histogram(bvh, centers, r2, r_max, n_bins,
                                                        **kwa), 3)
    start = kwa["start"]
    _, stats = kw.wavefront_count(bvh, centers, r2, start=start,
                                  depths=importlib.import_module(
                                      "repro_torch.core.query").node_depths(bvh))
    hops = int(stats[0].sum(dtype=torch.int64))
    sub = torch.from_numpy(np.random.default_rng(7).choice(n, min(n, 1 << 12),
                                                           replace=False)).to(DEV)
    sc, sr, ss = centers[sub].contiguous(), r2[sub].contiguous(), start[sub].contiguous()
    sub_ms = cuda_ms(torch, lambda: kw.wavefront_histogram(bvh, sc, sr, r_max, n_bins,
                                                            start=ss), 3)
    want, plain_ms = timed_once(torch, lambda: kw.wavefront_histogram_plain(
        bvh, sc, sr, r_max, n_bins, ss))
    require(torch.equal(kw.wavefront_histogram(bvh, sc, sr, r_max, n_bins, start=ss), want),
            "wavefront_histogram on a part of phase 12's input")
    pairs = int(got.sum())
    # The thresholds prologue alone (launched by each call above, whose
    # times include it), and its plain twin on the card.
    edges_ms = cuda_ms(torch, lambda: kw.histogram_edges(r_max, n_bins, DEV), 10)
    want_edges, edges_plain_ms = timed_once(
        torch, lambda: kw.histogram_thresholds(r_max, n_bins, DEV))
    require(torch.equal(kw.histogram_edges(r_max, n_bins, DEV).view(torch.int32),
                        want_edges.view(torch.int32)),
            "histogram_edges on phase 12's input == its plain twin")
    nb = tree_bytes(bvh) + n * (12 + 4 + 4) + n_bins * 8
    row("wavefront_histogram", bvh, False, ms, plain_ms, nb,
        hops * FLOPS_PER_HOP + pairs * OPS_PER_BIN, hops,
        "2^12 sampled queries", {"ms_at_plain_input": sub_ms, "pairs": pairs,
                                 "n_bins": n_bins, "ops_per_pair": OPS_PER_BIN,
                                 "private_bins": n_bins <= kw.PRIVATE_HISTOGRAM_BINS,
                                 "edges_ms": edges_ms})
    # Bisection: about 31 steps a threshold, each a bin by the IEEE sequence.
    steps = 31 * (n_bins - 1)
    b_ms, b_by = bound((n_bins - 1) * 4, steps * OPS_PER_BIN)
    v, path = launches.get("histogram_edges", (0, None))
    rows.append({"name": "histogram_edges", "route": "cuda", "source": src,
                 "replaces": ref, "launches": v, "path": path, "card": card,
                 "max_abs_err": 0.0, "ms": edges_ms, "plain_ms": edges_plain_ms,
                 "plain_input": "the same r_max and n_bins", "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None, "n_bins": n_bins,
                 "registers": wave["histogram_edges"]["registers"]})
    log(f"[12] histogram_edges: {edges_ms:.4f} ms a launch x {v} in {path}, plain "
        f"{edges_plain_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}), "
        f"{rows[-1]['registers']} registers; {card}")
    del stats, got, want

    for name in ("wavefront_dense_count", "wavefront_dense_min_label"):
        args, kwa, got = calls[name][0]
        wrapper = getattr(kw, name)
        bvh = args[0]
        with kw.shared_pack(bvh):
            ms = cuda_ms(torch, lambda: wrapper(*args, **kwa), 3)
        tally = {}
        if name == "wavefront_dense_count":
            _, centers, r2, words, pts, half = args
            qmask, extra = kwa["qmask"], {"stop_at": kwa["stop_at"]}
            epi = kw.dense_epilogue(bvh, words, pts, centers, r2, half,
                                    stop_at=kwa["stop_at"], tally=tally)
            init = 0
        else:
            _, centers, r2, words, pts, scan_lab, half, qmask, init = args
            extra = {}
            epi = kw.dense_epilogue(bvh, words, pts, centers, r2, half,
                                    scan_lab=scan_lab, tally=tally)
        lanes = torch.nonzero(qmask).flatten()
        carry0 = torch.stack([torch.full_like(lanes, int(init)), lanes], 1)
        (carry, hops), plain_ms = timed_once(torch, lambda: kw.lockstep_traverse(
            bvh, centers, r2, lanes, carry0, epi))
        require(torch.equal(carry[:, 0].int(), got[lanes]), f"{name} on phase 12's input")
        ops = (hops * FLOPS_PER_HOP + tally["scan_tests"] * OPS_PER_SCAN_TEST
               + (tally["whole"] + tally["scanned"]) * OPS_PER_CELL_TEST)
        # The tree, a word per leaf, and per point its centre, r2, mask
        # bit, place in the order, result and (MIN_LABEL) label.
        m = bvh.num_leaves
        nb = tree_bytes(bvh) + m * 16 + n * (12 + 4 + 1 + 4 + 4 + (4 if init else 0))
        row(name, bvh, True, ms, plain_ms, nb, ops, hops, "every query in the launch's mask",
            {**extra, "queries": int(lanes.numel()), "tree_leaves": m, "points": n,
             **tally})
    for r in rows:
        if "hops" not in r:
            continue
        cells = "".join(f", {k} {r[k]}" for k in ("tree_leaves", "whole", "scanned",
                                                   "scan_tests") if k in r)
        log(f"[12] {r['name']}: {r['ms']:.4f} ms a launch x {r['launches']} in "
            f"{r['path']}, plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {r['hops']} hops{cells}, {r['ghops_per_s']:.1f} Ghops/s, "
            f"pack {r['pack_ms']:.4f} ms, {r['registers']} registers; {card}")
    return rows


def phase9_kernel_line(launches_by_step, records, more_rows, card, wave, seg_rep):
    import torch
    from repro_torch.kernels import segment as ks
    from repro_torch.kernels import wavefront as kw

    def per_step(name):
        return {"launches": launches_by_step[-1][name],
                "launches_by_step": [s[name] for s in launches_by_step],
                "path": "InsituAnalyzer step", "card": card}

    rows = []
    wave_src = "src/repro_torch/kernels/csrc/wavefront.cu"
    wave_ref = "src/repro/kernels/wavefront.py:97"

    (bvh, centers, r2), kw_args, got = records["wavefront_count"]
    q = centers.shape[0]
    # As on the path: fdbscan's traversals share one pack of the tree.
    with kw.shared_pack(bvh):
        ms = cuda_ms(torch, lambda: kw.wavefront_count(bvh, centers, r2, **kw_args),
                     3)
    lanes = torch.arange(q, device=DEV)
    (want, hops), plain_ms = timed_once(torch, lambda: kw.lockstep_traverse(
        bvh, centers, r2, lanes, torch.zeros(q, dtype=torch.int32, device=DEV),
        kw.count_epilogue(kw_args.get("stop_at"))))
    require(torch.equal(got, want), "wavefront_count on the main path's input")
    b_ms, b_by = bound(tree_bytes(bvh) + q * (4 + 12 + 4 + 4), hops * FLOPS_PER_HOP)
    rows.append({"name": "wavefront_count", "route": "cuda", "source": wave_src,
                 "replaces": wave_ref, **per_step("wavefront_count"),
                 "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                 **traversal_fields(torch, kw, bvh, hops, ms, wave,
                                    "wavefront_count", shared=True),
                 "stop_at": kw_args.get("stop_at")})

    (bvh, centers, r2, labels, core, mask, sentinel), kw_args, got = \
        records["wavefront_min_label"]
    with kw.shared_pack(bvh):
        ms = cuda_ms(torch, lambda: kw.wavefront_min_label(
            bvh, centers, r2, labels, core, mask, sentinel, **kw_args), 3)
    lanes = torch.nonzero(mask).flatten()
    init = torch.full((lanes.numel(),), sentinel, dtype=torch.int32, device=DEV)
    (best, hops), plain_ms = timed_once(torch, lambda: kw.lockstep_traverse(
        bvh, centers, r2, lanes, init, kw.min_label_epilogue(bvh, labels, core)))
    want = torch.full_like(got, sentinel)
    want[lanes] = best
    require(torch.equal(got, want), "wavefront_min_label on the main path's input")
    nb = tree_bytes(bvh) + q * (4 + 12 + 4 + 1 + 4) + labels.numel() * 5
    b_ms, b_by = bound(nb, hops * FLOPS_PER_HOP)
    rows.append({"name": "wavefront_min_label", "route": "cuda",
                 "source": wave_src, "replaces": wave_ref,
                 **per_step("wavefront_min_label"), "max_abs_err": 0.0,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None,
                 **traversal_fields(torch, kw, bvh, hops, ms, wave,
                                    "wavefront_min_label", shared=True)})

    seg_src = "src/repro_torch/kernels/csrc/segment.cu"
    for name, ref_line, instance, plain, library in (
            ("segment_sum_sorted", "src/repro/kernels/segment.py:106",
             "segment_sum_d8",
             ks.segment_sum_sorted_plain,
             lambda d, s, S: torch.zeros((S, d.shape[1]), device=DEV)
             .index_add_(0, s, d)),
            ("segment_max_sorted", "src/repro/kernels/segment.py:133",
             "segment_max_d1", ks.segment_max_sorted_plain,
             lambda d, s, S: torch.full((S, d.shape[1]), -ks.SEG_NEG_BIG,
                                        device=DEV)
             .index_reduce_(0, s, d, "amax", include_self=True))):
        (data, seg, nseg), _, got = records[name]
        wrapper = getattr(ks, name)
        ms = cuda_ms(torch, lambda: wrapper(data, seg, nseg), 10)
        plain_ms = cuda_ms(torch, lambda: plain(data, seg, nseg), 3)
        lib_ms = cuda_ms(torch, lambda: library(data, seg, nseg), 3)
        want = plain(data, seg, nseg)
        diff = (got - want).abs()
        err = diff.max().item()
        require(ks.vector_path(data, seg), f"{name}: the path's rows are aligned")
        extra = {"deterministic": torch.equal(
                     wrapper(data, seg, nseg).view(torch.int32), got.view(torch.int32)),
                 "registers": seg_rep[instance]["registers"],
                 "ldg128": seg_rep[instance]["sass"]["LDG.128"]}
        require(extra["deterministic"], f"{name}: two calls differ on the main path")
        if name == "segment_max_sorted":
            require(err == 0.0, "segment_max on the main path's input")
        else:
            # The kernel adds in a fixed order of its own (a thread's rows in
            # order, a scan over threads and warps, then the carry levels),
            # the plain version in row order. The largest halo holds ~3e5
            # rows, the neutral tail a fifth of all rows.
            tol = sum_tolerance(torch, data, seg, nseg)
            require(bool((diff <= tol).all()), "segment_sum on the main path's input")
            require(torch.equal(got[:, 0], want[:, 0]),
                    "segment_sum count column on the main path's input")
            extra["err_over_bound"] = (diff / tol.clamp(min=1e-30)).max().item()
        nrow, d = data.shape
        b_ms, b_by = bound(nrow * d * 4 + nrow * 4 + nseg * d * 4, nrow * d)
        rows.append({"name": name, "route": "cuda", "source": seg_src,
                     "replaces": ref_line, **per_step(name),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "share": b_ms / ms, **extra})
    rows += more_rows
    for row in rows:
        hops = (f", {row['ghops_per_s']:.1f} Ghops/s, pack {row['pack_ms']:.4f} "
                f"ms, {row['registers']} registers" if "hops" in row else "")
        if row["name"].startswith("segment_"):
            hops = (f", share {row['share']:.3f}, deterministic "
                    f"{row['deterministic']}, {row['registers']} registers")
        if "class_ms" in row:
            hops = (f", {row['tests_per_s']:.4g} tests/s, slot classes "
                    f"{row['class_ms']:.4f} ms, {row['registers']} registers")
        if "pops" in row:
            hops = (f", {row['pops']} pops, {row['ghops_per_s']:.1f} Gpops/s, "
                    f"{row['registers']} registers, stack frame "
                    f"{row['stack_frame']} bytes; plain on {row['plain_input']}"
                    f" (kernel {row['ms_at_plain_input']:.4f} ms there)")
        log(f"[9] {row['name']}: {row['ms']:.4f} ms/launch x {row['launches']} "
            f"per run of {row['path']}, "
            f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), library {row['library_ms']} ms{hops}; {card}")
    print(json.dumps({"kernels": rows}), flush=True)


def face_counts(torch, pts, shards: int, eps) -> "torch.Tensor":
    """(shards, 2): the points within eps of each slab's left and right x
    faces, the rows ``halo_exchange`` packs for the neighbours."""
    x = pts[:, 0].reshape(shards, -1)
    e = torch.tensor(float(eps), dtype=torch.float32, device=pts.device)
    lo, hi = x.amin(1, keepdim=True), x.amax(1, keepdim=True)
    return torch.stack([(x <= lo + e).sum(1), (x >= hi - e).sum(1)], 1)


def slab_cloud(torch, seed: int, n: int, shards: int):
    """``plummer_cloud(seed, n)`` slab-partitioned over ``shards`` (sorted
    by x) on the card, its eps, the largest face count (the halo buffer
    that cannot overflow) and the permutation from the cloud's order."""
    from repro_torch.core.distributed import slab_partition
    from repro_torch.data.pipeline import hacc_benchmark_epsilon

    pos, vel, _ = plummer_cloud(seed, n)
    pos, order = slab_partition(pos, shards)
    pts = torch.from_numpy(pos).to(DEV)
    vels = torch.from_numpy(vel[order]).to(DEV)
    eps = hacc_benchmark_epsilon(1.0, n)
    faces = face_counts(torch, pts, shards, eps)
    return pts, vels, eps, faces, torch.from_numpy(order).to(DEV)


def phase3_sharded(seed: int, n: int = 1 << 14, shards: int = 4):
    """The sharded path on ``shards`` shards of the card against as many
    of the CPU: ``halo_pipeline_sharded`` at int64 ids (its DBSCAN runs
    MIN_LABEL's int64 instance) on both, labels, core mask, rounds,
    overflow and catalog integers exact, catalog floats within the
    tolerance of two summation orders; and ``dbscan_distributed`` at int32
    and int64 ids on the card, equal to the CPU pipeline's labels, core
    mask, rounds and overflow. (One sharded DBSCAN takes about a minute
    at 2^16 on the CPU, a lockstep torch walk per pass.)"""
    import torch
    from repro_torch.core import ShardMesh, dbscan_distributed
    from repro_torch.halos import halo_pipeline_sharded

    pts, vels, eps, faces, _ = slab_cloud(torch, seed + 6, n, shards)
    halo_cap = int(faces.max())
    out = {}
    for dev in (DEV, "cpu"):
        t0 = time.perf_counter()
        out[dev] = halo_pipeline_sharded(
            pts.to(dev), vels.to(dev), eps, 2, mesh=ShardMesh(shards, dev),
            capacity=1 << 14, halo_cap=halo_cap, min_count=10,
            index_dtype=torch.int64)
        log(f"[3] halo_pipeline_sharded (int64 ids) on {shards} shards of "
            f"{dev}: {time.perf_counter() - t0:.1f} s")
    pipe, cpipe = out[DEV], out["cpu"]
    fields = ("labels", "core_mask", "rounds", "halo_overflow")
    for f in fields:
        require(torch.equal(getattr(pipe, f).cpu(), getattr(cpipe, f)),
                f"halo_pipeline_sharded {f} card vs CPU")
    for f in pipe.catalog._fields:
        a, b = getattr(pipe.catalog, f).cpu(), getattr(cpipe.catalog, f)
        if a.dtype.is_floating_point:
            require(torch.allclose(a, b, rtol=1e-4, atol=1e-6), f"catalog {f}")
        else:
            require(torch.equal(a, b), f"catalog {f} card vs CPU")
    for dt in (torch.int32, torch.int64):
        dist = dbscan_distributed(pts, eps, 2, mesh=ShardMesh(shards, DEV),
                                  halo_cap=halo_cap, index_dtype=dt)
        require(dist.labels.dtype == dt, "dbscan_distributed label dtype")
        for f in fields:
            require(torch.equal(getattr(dist, f).cpu().to(getattr(cpipe, f).dtype),
                                getattr(cpipe, f)),
                    f"dbscan_distributed {dt} {f} == the CPU pipeline's")
    require(not bool(pipe.halo_overflow), "halo overflow at phase 3")
    log(f"[3] card == CPU on {shards} shards at {n} particles (face counts "
        f"{faces.tolist()}, halo_cap {halo_cap}): halo_pipeline_sharded exact "
        f"({int(pipe.rounds)} rounds, {int(pipe.catalog.num_halos)} halos, "
        f"catalog ints exact, floats within rtol 1e-4); dbscan_distributed "
        f"at int32 and int64 ids on the card == the CPU pipeline's")


def staged_insitu_step(torch, tracer, pts, vels, eps, cfg, run: int):
    """One in-situ step (``fdbscan`` then ``halo_catalog``) stage by stage,
    each stage in a fenced span of ``tracer``: the split of the step's
    time. Returns the labels."""
    from repro_torch.core import dbscan as td
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.halos.catalog import halo_catalog
    from repro_torch.kernels.wavefront import shared_pack

    n = pts.shape[0]
    with tracer.span("insitu_staged", n=n, run=run):
        with tracer.span("build_bvh") as sp:
            bvh = sp.fence(build_bvh(pts, *scene_bounds(pts)))
        with shared_pack(bvh):
            with tracer.span("core_counts (with the pack)") as sp:
                core = sp.fence(td.count_neighbors(
                    bvh, pts, pts, eps, cfg.min_pts, order=bvh.leaf_perm)
                    >= cfg.min_pts)
            with tracer.span("union_rounds") as sp:
                parent, _ = td.union_rounds(bvh, pts, eps, core, n)
                sp.fence(parent)
            with tracer.span("border") as sp:
                border = sp.fence(td.min_core_label_on(
                    bvh, pts, eps, parent, core, ~core, n, order=bvh.leaf_perm))
        with tracer.span("finish_labels") as sp:
            labels = sp.fence(td._finish_labels(parent, border, core, n))
        with tracer.span("halo_catalog") as sp:
            sp.fence(halo_catalog(pts, vels, labels, capacity=cfg.halo_capacity,
                                  min_count=cfg.halo_min_count, device=DEV))
    return labels


def min_label64_row(torch, kw, call, launches, card, wave):
    """Phase 9's row of MIN_LABEL's int64 instance at the inputs of its
    first launch in phase 13, with the int32 instance timed on the same
    inputs (the labels fit) beside it."""
    (bvh, centers, r2, labels, core, mask, sentinel), kwa, got = call
    with kw.shared_pack(bvh):
        ms = cuda_ms(torch, lambda: kw.wavefront_min_label(
            bvh, centers, r2, labels, core, mask, sentinel, **kwa), 3)
        narrow = labels.to(torch.int32)
        ms32 = cuda_ms(torch, lambda: kw.wavefront_min_label(
            bvh, centers, r2, narrow, core, mask, sentinel, **kwa), 3)
        require(torch.equal(kw.wavefront_min_label(
            bvh, centers, r2, narrow, core, mask, sentinel, **kwa).long(), got),
            "the int32 instance == the int64 one on phase 13's input")
    lanes = torch.nonzero(mask).flatten()
    init = torch.full((lanes.numel(),), sentinel, dtype=torch.int64, device=DEV)
    (best, hops), plain_ms = timed_once(torch, lambda: kw.lockstep_traverse(
        bvh, centers, r2, lanes, init, kw.min_label_epilogue(bvh, labels, core)))
    want = torch.full_like(got, sentinel)
    want[lanes] = best
    require(torch.equal(got, want), "wavefront_min_label int64 on phase 13's input")
    q = centers.shape[0]
    nb = tree_bytes(bvh) + q * (4 + 12 + 4 + 1 + 8) + labels.numel() * 9
    b_ms, b_by = bound(nb, hops * FLOPS_PER_HOP)
    return {"name": "wavefront_min_label_int64", "wrapper": "wavefront_min_label",
            "instance": "sphere/point/int64", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wavefront.cu",
            "replaces": "src/repro/kernels/wavefront.py:97",
            "launches": launches,
            "path": "dbscan_distributed(index_dtype=int64), 2^24 on 4 shards",
            "card": card, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "plain_input": "every query of the launch (one shard's merge round)",
            "queries": int(lanes.numel()), "ms_int32_same_input": ms32,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            **traversal_fields(torch, kw, bvh, hops, ms, wave,
                               "wavefront_min_label64", shared=True)}


def phase13_sharded(seed: int, n: int, cfg, card: str, wave: dict,
                    shards: int = 4, n_so: int = 1 << 20):
    """Phase 13: the sharded halo pipeline at full width, phase 4's cloud
    and eps slab-partitioned over ``shards`` shards of the card, each step
    with its seconds, peak memory and launches by instance; the in-situ
    step's split by stage from the span tracer; SO at ``n_so``. Returns
    phase 9's row of MIN_LABEL's int64 instance."""
    import torch
    tq = importlib.import_module("repro_torch.core.query")
    from repro_torch.core import dbscan as td
    from repro_torch.core import (ShardMesh, dbscan_distributed, halo_exchange,
                                  sharded_neighbor_csr)
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.halos import (halo_catalog, halo_pipeline_sharded,
                                   halo_pipeline_traced, so_masses)
    from repro_torch.kernels import wavefront as kw
    from repro_torch.obs import SpanTracer, load_chrome_trace

    t_all = time.perf_counter()
    pts, vels, eps, faces, order = slab_cloud(torch, seed, n, shards)
    halo_cap = int(faces.max())
    mesh = ShardMesh(shards, DEV)
    kernels = kernel_wrappers()
    steps = []
    log(f"[13] {n} particles on {shards} shards, eps {eps:.6g}; points within "
        f"eps of each slab's faces {faces.tolist()}: halo_cap {halo_cap}")

    with counted_step(torch, "fdbscan", kernels, "[13]") as rec:
        ref = td.fdbscan(pts, eps, 2, device=DEV)
    steps.append(rec)

    first64 = []
    wrapper = td.wavefront_min_label

    def keep_first64(*args, **kwargs):
        res = wrapper(*args, **kwargs)
        if args[3].dtype == torch.int64 and not first64:
            first64.append((args, kwargs, res))
        return res

    for dt in (torch.int32, torch.int64):
        name = f"dbscan_distributed(index_dtype={str(dt)[6:]})"
        with swapped(td, "wavefront_min_label", keep_first64), \
                counted_step(torch, name, kernels, "[13]") as rec:
            res = dbscan_distributed(pts, eps, 2, mesh=mesh, halo_cap=halo_cap,
                                     index_dtype=dt)
        steps.append(rec)
        key = "wavefront_min_label sphere/point" + ("/int64" if dt == torch.int64
                                                    else "")
        require(rec["launches"].get(key, 0) > 0, f"{key} was not launched")
        require(not bool(res.halo_overflow), f"{name}: halo overflow")
        require(res.labels.dtype == dt, f"{name}: label dtype")
        require(torch.equal(res.labels.to(torch.int32), ref.labels)
                and torch.equal(res.core_mask, ref.core_mask),
                f"{name}: labels and core mask == fdbscan's")
        log(f"[13] {name}: labels and core mask == fdbscan's; "
            f"{int(res.rounds)} merge rounds (fdbscan {int(ref.num_rounds)})")
    launches64 = steps[-1]["launches"].get("wavefront_min_label sphere/point/int64", 0)
    del res
    n_loc = n // shards

    def ghosts(axis, p):
        gid = axis.index * n_loc + torch.arange(n_loc, device=DEV)
        return int(halo_exchange(p, gid, eps, halo_cap, axis).halo_valid.sum())

    log(f"[13] ghost rows per shard {mesh.run(ghosts, pts)}; per-shard "
        f"overflow {(faces > halo_cap).any(1).tolist()}")

    with counted_step(torch, "halo_pipeline_sharded", kernels, "[13]") as rec:
        pipe = halo_pipeline_sharded(pts, vels, eps, 2, mesh=mesh,
                                     capacity=cfg.halo_capacity,
                                     halo_cap=halo_cap,
                                     min_count=cfg.halo_min_count)
    steps.append(rec)
    with counted_step(torch, "halo_catalog (one device)", kernels, "[13]") as rec:
        single = halo_catalog(pts, vels, ref.labels, capacity=cfg.halo_capacity,
                              min_count=cfg.halo_min_count, device=DEV)
    steps.append(rec)
    require(torch.equal(pipe.labels, ref.labels), "pipeline labels == fdbscan's")
    diffs = {}
    for f in single._fields:
        a, b = getattr(pipe.catalog, f), getattr(single, f)
        if a.dtype.is_floating_point:
            # Sums of up to 3e5 float32 terms in other orders.
            require(torch.allclose(a, b, rtol=1e-4, atol=1e-6), f"catalog {f}")
            diffs[f] = (a - b).abs().max().item()
        else:
            require(torch.equal(a, b), f"catalog {f} == halo_catalog's")
    require(not bool(pipe.catalog.overflow), "catalog overflow")
    log(f"[13] halo_pipeline_sharded: {int(pipe.catalog.num_halos)} halos, "
        f"catalog ints == halo_catalog's; float max abs differences {diffs}")

    tracer = SpanTracer(process_name="chip_smoke phase 13")
    with counted_step(torch, "halo_pipeline_traced", kernels, "[13]") as rec:
        staged = halo_pipeline_traced(pts, vels, eps, 2, mesh=mesh,
                                      capacity=cfg.halo_capacity,
                                      halo_cap=halo_cap,
                                      min_count=cfg.halo_min_count,
                                      tracer=tracer)
    steps.append(rec)
    require(torch.equal(staged.labels, pipe.labels) and all(
        torch.equal(getattr(staged.catalog, f), getattr(pipe.catalog, f))
        for f in ("num_halos", "root", "count", "particle_halo")),
        "halo_pipeline_traced == halo_pipeline_sharded")
    del staged, pipe, single
    unsorted = torch.empty_like(pts)
    unsorted[order] = pts
    uvel = torch.empty_like(vels)
    uvel[order] = vels
    staged_insitu_step(torch, tracer, unsorted, uvel, eps, cfg, 0)   # warm-up
    labels = staged_insitu_step(torch, tracer, unsorted, uvel, eps, cfg, 1)
    require(torch.equal(labels, td.fdbscan(unsorted, eps, cfg.min_pts,
                                           device=DEV).labels),
            "the staged in-situ step's labels == fdbscan's")
    del unsorted, uvel, labels
    out = Path(__file__).resolve().parent / "build" / "phase13_trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    spans = [(e["name"], round(e["dur"] * 1e-6, 6))
             for e in load_chrome_trace(tracer.export(str(out)))]
    log(f"[13] spans (name, seconds), Chrome trace in {out}: {spans}")

    bvh = build_bvh(pts, *scene_bounds(pts))
    exact = tq.query_csr(bvh, tq.within(pts, eps), order=bvh.leaf_perm)
    per_shard = (exact.offsets[1:].long() - exact.offsets[:-1].long()) \
        .reshape(shards, -1).sum(1)
    del bvh
    with counted_step(torch, "sharded_neighbor_csr", kernels, "[13]") as rec:
        csr = sharded_neighbor_csr(pts, eps, capacity=int(per_shard.max()),
                                   mesh=mesh, halo_cap=halo_cap)
    steps.append(rec)
    require(not bool(csr.overflowed), "sharded_neighbor_csr overflowed")
    require(int(csr.total.sum()) == int(exact.total),
            "sharded_neighbor_csr's total == query_csr's")
    require(torch.equal(csr.total.long(), per_shard),
            "sharded_neighbor_csr's totals per shard")
    log(f"[13] sharded_neighbor_csr: {int(exact.total)} hits == query_csr's "
        f"on the whole cloud, per shard {csr.total.tolist()}")
    del csr, exact

    row = min_label64_row(torch, kw, first64[0], launches64, card, wave)
    del first64, ref, pts, vels

    pts2, vels2, eps2, faces2, _ = slab_cloud(torch, seed, n_so, shards)
    with counted_step(torch, f"halo_pipeline_sharded(SO) at {n_so}", kernels,
                      "[13]") as rec:
        pipe = halo_pipeline_sharded(pts2, vels2, eps2, 2, mesh=mesh,
                                     capacity=cfg.halo_capacity,
                                     halo_cap=int(faces2.max()),
                                     min_count=cfg.halo_min_count,
                                     so_delta=200.0, so_r_max=0.1)
    steps.append(rec)
    cat = pipe.catalog
    with counted_step(torch, f"so_masses at {n_so} (one device)", kernels,
                      "[13]") as rec:
        so = so_masses(pts2, cat.center, cat.count > 0, delta=200.0, r_max=0.1,
                       device=DEV)
    steps.append(rec)
    require(all(torch.equal(getattr(pipe.so, f), getattr(so, f))
                for f in so._fields), "sharded SO == so_masses")
    log(f"[13] SO at {n_so}: {int(cat.num_halos)} halos, the psum'd shard "
        f"counts == so_masses on one tree ({int(so.bracketed.sum())} "
        f"bracketed)")
    log(f"[13] phase 13 steps: {json.dumps(steps)}; "
        f"{time.perf_counter() - t_all:.1f} s")
    return [row]


# ---------------------------------------------------------------------------
# The nearest family (ROADMAP A10): knn, emst, mls_interpolate, raycast on
# the nearest kernel of csrc/nearest.cu; phases 1, 2, 3 and 14.
# ---------------------------------------------------------------------------

# The nearest kernel's instances, by a tag of their mangled names.
NEAREST_KERNELS = {"nearest_knn": "nearest_kernelILi0EE",
                   "nearest_other_component": "nearest_kernelILi1EE",
                   "nearest_ray": "nearest_kernelILi2EE"}
# Float operations per popped node: the one point-box distance (KNN,
# EMST) or slab test (RAY) the walk needs of each node it visits, as the
# traversal's rows count a hop.
NEAREST_OPS_PER_POP = {"nearest_knn": FLOPS_PER_HOP,
                       "nearest_other_component": FLOPS_PER_HOP,
                       "nearest_ray": RAY_FLOPS_PER_HOP}
KNN_K = 16
MLS_K = 8


def nearest_report():
    """Registers, stack frame, spills and SASS opcode and load counts of
    the nearest kernel's three instances. Fails if one holds an FFMA: a
    contracted multiply-add would round d² or a slab's t otherwise than
    the plain version."""
    out = kernel_report("nearest", NEAREST_KERNELS)
    for key, rep in out.items():
        require(rep["sass"]["FFMA"] == 0, f"{key}: SASS holds an FFMA")
        log(f"[1] {key}: {rep['registers']} registers, stack frame "
            f"{rep['stack_frame']} bytes, spills {rep['spill_stores']}/"
            f"{rep['spill_loads']} bytes, 0 FFMA, {rep['sass']['LDG.128']} "
            f"LDG.E.128")
    return out


def same_bits(torch, got, want) -> bool:
    return all(bits_equal(torch, g, w) for g, w in zip(got, want))


def mls_field(p):
    """The scalar field MLS interpolates: sin(4x) + y^2 - z/2."""
    return np.sin(4 * p[:, 0]) + p[:, 1] ** 2 - 0.5 * p[:, 2]


def mls_float64(src, vals, tgt, idx, dist):
    """The MLS solve of ``core/interpolate.py`` in float64 on the host for
    targets ``tgt`` (m, 3) with their neighbours ``idx``/``dist`` (m, k):
    ``(values, condition numbers of the Gram matrices)``."""
    dist = dist.astype(np.float64)
    radius = 1.1 * dist.max(1, keepdims=True) + 1e-12
    t = np.clip(dist / radius, 0.0, 1.0)
    w = (1 - t) ** 4 * (4 * t + 1)
    basis = np.concatenate([np.ones(idx.shape + (1,)),
                            src[idx].astype(np.float64) - tgt[:, None]], 2)
    a = basis * w[..., None]
    gram = np.einsum("qki,qkj->qij", a, basis) + 1e-8 * np.eye(4)
    rhs = np.einsum("qki,qk->qi", a, vals[idx].astype(np.float64))
    return np.linalg.solve(gram, rhs[..., None])[:, 0, 0], np.linalg.cond(gram)


def mls_tolerance(cond):
    """How far a float32 solve may stray: the Gram matrix's condition
    number times float32's unit roundoff, times 8, plus 1e-5."""
    return 1e-5 + 8 * cond * 2.0 ** -24


def phase2_nearest(seed, bvh, pts, eps, q: int = 1 << 16, q_ray: int = 1 << 11):
    """The nearest kernel against its plain versions on phase 2's tree, bit
    for bit with the pops: KNN at k = 1, 4, 16 and past the local buffer
    (``q`` sampled particles and ``q`` / 16 uniform points); EMST from
    singleton components and from a random 64-component map; RAY with
    ``q_ray`` skewers on the point tree and on a tree of the particles'
    eps-boxes."""
    import torch
    from repro_torch.core.bvh import build_bvh_objects
    from repro_torch.core.geometry import safe_inv, scene_bounds
    from repro_torch.kernels import nearest as kn
    temst = importlib.import_module("repro_torch.core.emst")

    n = pts.shape[0]
    rng = np.random.default_rng(seed + 60)
    sub = torch.from_numpy(rng.choice(n, q, replace=False)).to(DEV)
    queries = torch.cat([pts[sub], torch.from_numpy(
        rng.uniform(0, 1, (q // 16, 3)).astype(np.float32)).to(DEV)])
    walk = dict(records=kn.nearest_records(bvh), height=kn.check_height(bvh))
    t0 = time.perf_counter()
    for k in (1, 4, 16, kn.LOCAL_K + 8):
        got = kn.nearest_knn(bvh, queries, k, with_pops=True, **walk)
        want = kn.nearest_knn_plain(bvh, queries, k, True)
        require(same_bits(torch, got, want), f"nearest_knn k={k}")
        ties = int((got[1][:, 1:] == got[1][:, :-1]).sum())
        log(f"[2] nearest_knn k={k} on {queries.shape[0]} queries: indices, "
            f"distance bits and pops == the plain version's ({ties} equal "
            f"adjacent distances, in slot order; {int(got[2].sum())} pops; "
            f"{time.perf_counter() - t0:.1f} s so far)")
    for n_comp in (n, 64):
        comp = (torch.arange(n, dtype=torch.int32, device=DEV) if n_comp == n
                else torch.from_numpy(rng.integers(0, n_comp, n).astype(np.int32))
                .to(DEV))
        clo, chi = temst._node_component_intervals(bvh, comp[bvh.leaf_perm.long()])
        iv = torch.stack([clo, chi], 1)
        got = kn.nearest_other_component(bvh, pts[sub], comp[sub], comp, iv,
                                         with_pops=True, **walk)
        want = kn.nearest_other_component_plain(bvh, pts[sub], comp[sub], comp,
                                                iv, True)
        require(same_bits(torch, got, want), f"nearest_other_component {n_comp}")
        log(f"[2] nearest_other_component, {n_comp} components, {q} queries: "
            f"d2 bits, indices and pops == the plain version's")
    lo, hi = scene_bounds(pts)
    o, d = skewers(torch, seed + 61, q_ray, lo, hi, pts)
    inv = safe_inv(d)
    obvh = build_bvh_objects(pts - eps, pts + eps, lo, hi)
    for tree, leaf in ((bvh, "point"), (obvh, "box")):
        t0 = time.perf_counter()
        got = kn.nearest_ray(tree, o, inv, with_pops=True)
        want = kn.nearest_ray_plain(tree, o, inv, True)
        require(same_bits(torch, got, want), f"nearest_ray on {leaf} leaves")
        log(f"[2] nearest_ray, {q_ray} skewers on {leaf} leaves: index, t bits "
            f"and pops == the plain version's ({int((got[0] >= 0).sum())} hit; "
            f"{time.perf_counter() - t0:.1f} s)")


def phase3_nearest(seed: int, n: int = 1 << 14, m_rays: int = 1 << 10):
    """The card against the CPU at ``n`` Plummer particles: ``knn`` (k =
    16, self), ``emst`` (edges, weights, rounds), ``raycast`` and
    ``raycast_all`` (``m_rays`` skewers on the eps-box tree), all exact;
    ``mls_interpolate`` (n / 16 uniform targets) within ``mls_tolerance``
    of each other."""
    import torch
    from repro_torch.core import emst, knn, mls_interpolate, raycast, raycast_all
    from repro_torch.core.bvh import build_bvh, build_bvh_objects
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.data.pipeline import hacc_benchmark_epsilon

    pos, _, _ = plummer_cloud(seed + 62, n)
    eps = hacc_benchmark_epsilon(1.0, n)
    tgt = np.random.default_rng(seed + 63).uniform(0, 1, (n // 16, 3)).astype(np.float32)
    vals = mls_field(pos).astype(np.float32)
    dev_pts = torch.from_numpy(pos).to(DEV)
    o, d = skewers(torch, seed + 64, m_rays, *scene_bounds(dev_pts), dev_pts)
    out = {}
    for dev in (DEV, "cpu"):
        t0 = time.perf_counter()
        pts = torch.from_numpy(pos).to(dev)
        lo, hi = scene_bounds(pts)
        bvh = build_bvh(pts, lo, hi)
        obvh = build_bvh_objects(pts - eps, pts + eps, lo, hi)
        ro, rd = o.to(dev), d.to(dev)
        out[dev] = (knn(bvh, pts, pts, KNN_K),
                    emst(pts, device=dev),
                    raycast(obvh, ro, rd),
                    raycast_all(obvh, ro, rd, sort_queries=True),
                    mls_interpolate(pos, vals, tgt, MLS_K, device=dev))
        log(f"[3] knn, emst, raycast, raycast_all and mls_interpolate on {dev}: "
            f"{time.perf_counter() - t0:.1f} s")
    for what, got, want in zip(("knn", "emst", "raycast", "raycast_all"),
                               out[DEV][:4], out["cpu"][:4]):
        for f in want._fields:
            if f == "total_weight":
                continue
            require(bits_equal(torch, getattr(got, f).cpu(), getattr(want, f)),
                    f"{what}.{f} card vs CPU")
    # The total is a float32 sum of n - 1 weights, in another order on the
    # card: within the summation bound 2 (n - 1) 2^-24 sum |w|.
    total = float(out["cpu"][1].weights.double().sum())
    require(abs(float(out[DEV][1].total_weight) - float(out["cpu"][1].total_weight))
            <= 2 * (n - 1) * 2.0 ** -24 * total, "emst.total_weight card vs CPU")
    nn = out["cpu"][0]
    src_bvh = build_bvh(torch.from_numpy(pos), *scene_bounds(torch.from_numpy(pos)))
    tnn = knn(src_bvh, None, torch.from_numpy(tgt), MLS_K)
    _, cond = mls_float64(pos, vals, tgt, tnn.indices.numpy(), tnn.distances.numpy())
    diff = np.abs(out[DEV][4].cpu().numpy() - out["cpu"][4].numpy())
    require(bool((diff <= mls_tolerance(cond)).all()), "mls_interpolate card vs CPU")
    tree = out[DEV][1]
    log(f"[3] card == CPU at {n} particles: knn (k = {KNN_K}, mean distance "
        f"{nn.distances[:, -1].mean().item():.4g}), emst's edges, weights and "
        f"{int(tree.rounds)} rounds, raycast and raycast_all "
        f"({int(out[DEV][3].total)} hits of {m_rays} skewers) bit for bit; "
        f"emst's total weight ({float(tree.total_weight):.6g}) within the "
        f"summation bound; mls_interpolate within its tolerance (largest "
        f"difference {diff.max():.3g}, condition numbers up to {cond.max():.3g})")


def nearest_row(torch, *, name, run, sub_run, plain, pops, nbytes,
                launches, path, plain_input, card, near_rep, extra=None):
    """A phase 9 row of an instance of the nearest kernel: ``run()`` the
    path's launch at its inputs, ``sub_run()`` and ``plain()`` the kernel
    and its plain version on a named sample, equal bit for bit."""
    ms = cuda_ms(torch, run, 3)
    got = sub_run()
    sub_ms = cuda_ms(torch, sub_run, 3)
    want, plain_ms = timed_once(torch, plain)
    require(same_bits(torch, got, want), f"{name} on {plain_input}")
    b_ms, b_by = bound(nbytes, pops * NEAREST_OPS_PER_POP[name])
    rep = near_rep[name]
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/nearest.cu",
            "replaces": "none: no Pallas kernel; the vmapped while_loop "
                        "traverse_nearest_stack, src/repro/core/query.py:429",
            "launches": launches, "path": path, "card": card,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "plain_input": plain_input, "ms_at_plain_input": sub_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "pops": pops, "ops_per_pop": NEAREST_OPS_PER_POP[name],
            "ghops_per_s": pops / ms * 1e-6, "registers": rep["registers"],
            "stack_frame": rep["stack_frame"], **(extra or {})}


def phase14_nearest(seed: int, n: int, card: str, near_rep: dict,
                    n_sample: int = 1 << 16, n_brute: int = 4096,
                    n_targets: int = 1 << 20, n_check: int = 1024):
    """Phase 14: the nearest family at full width on phase 4's cloud and
    eps. Each call with its seconds, peak memory and launches (counters
    set to 0 before it): ``knn`` self-query at k = 16 (against its plain
    version on ``n_sample`` sampled queries and brute force on
    ``n_brute``); ``emst`` (n - 1 edges that span; one round's walk
    against its plain version on ``n_sample`` points); ``mls_interpolate``
    (k = 8) onto ``n_targets`` uniform targets (``n_check`` of them against
    a float64 solve); ``raycast`` of phase 11's skewers on its tree of
    eps-boxes (each hit the least slab t of its ray's ``raycast_all``
    row). Returns phase 9's rows of the three instances."""
    import torch
    from repro_torch.core import emst, knn, mls_interpolate, raycast, raycast_all
    from repro_torch.core.bvh import build_bvh, build_bvh_objects
    from repro_torch.core.geometry import ray_box, safe_inv, scene_bounds
    from repro_torch.core.union_find import connected_components
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.kernels import nearest as kn
    temst = importlib.import_module("repro_torch.core.emst")

    t_all = time.perf_counter()
    pos, _, _ = plummer_cloud(seed, n)
    pts = torch.from_numpy(pos).to(DEV)
    eps = hacc_benchmark_epsilon(1.0, n)
    kernels = kernel_wrappers(tuple(NEAREST_KERNELS) + ("wavefront_count",
                                                        "wavefront_fill"))
    rng = np.random.default_rng(seed + 70)
    steps, rows = [], []
    lo, hi = scene_bounds(pts)
    bvh = build_bvh(pts, lo, hi)
    height = kn.check_height(bvh)
    rec = kn.nearest_records(bvh)
    sample = torch.from_numpy(rng.choice(n, n_sample, replace=False)).to(DEV)
    sample_name = f"{n_sample} sampled particles of the {n}"
    log(f"[14] cloud, tree (height {height}) and records: "
        f"{time.perf_counter() - t_all:.1f} s")

    # 1. kNN self-query at k = 16 (threads in the Morton order of the
    # queries, as knn takes them).
    with counted_step(torch, f"knn self-query k={KNN_K}", kernels, "[14]") as r:
        nn = knn(bvh, pts, pts, KNN_K)
    steps.append(r)
    require(r["launches"].get("nearest_knn", 0) == 1, "knn launched nearest_knn once")
    require(bool((nn.indices >= 0).all()) and
            bool(torch.isfinite(nn.distances).all()), "knn: every slot filled")
    morton = importlib.import_module(
        "repro_torch.core.query").query_sort_permutation(bvh, pts)
    pops = int(kn.nearest_knn(bvh, pts, KNN_K, order=morton, records=rec,
                              height=height, with_pops=True)[2].sum(dtype=torch.int64))
    # Brute force: every squared distance of a query, as differences (not
    # cdist's matrix-product form, whose rounding is far coarser), then
    # topk.
    brute = torch.from_numpy(rng.choice(n, n_brute, replace=False)).to(DEV)
    agree = checked = 0
    cols = [pts[:, a].contiguous() for a in range(3)]
    for chunk in brute.split(32):
        q = pts[chunk]
        d2 = sum((c[None, :] - q[:, a, None]) ** 2 for a, c in enumerate(cols))
        best = torch.topk(d2, KNN_K + 1, largest=False)
        apart = best.values[:, KNN_K] - best.values[:, KNN_K - 1] > \
            1e-6 * best.values[:, KNN_K]
        want = torch.sort(best.indices[:, :KNN_K], 1).values
        got = torch.sort(nn.indices[chunk].long(), 1).values
        agree += int(((want == got).all(1) & apart).sum())
        checked += int(apart.sum())
        del d2, best
    del cols
    require(agree == checked, f"knn sets == brute force on {checked} queries")
    log(f"[14] knn checked: {time.perf_counter() - t_all:.1f} s")
    log(f"[14] knn: {KNN_K} neighbours of each of {n} particles; sets == "
        f"brute force + topk on {checked} of {n_brute} sampled queries (the "
        f"rest have the {KNN_K}th and {KNN_K + 1}th squared distances within "
        f"1e-6, relative); mean {KNN_K}th distance {nn.distances[:, -1].mean().item():.4g}"
        f" ({nn.distances[:, -1].mean().item() / eps:.3f} eps); {pops} pops; "
        f"tree height {height}")
    q_bytes = rec.numel() * 4 + n * (12 + 4)
    rows.append(nearest_row(
        torch, name="nearest_knn",
        run=lambda: kn.nearest_knn(bvh, pts, KNN_K, order=morton,
                                   records=rec, height=height),
        sub_run=lambda: kn.nearest_knn(bvh, pts[sample], KNN_K, records=rec,
                                       height=height),
        plain=lambda: kn.nearest_knn_plain(bvh, pts[sample], KNN_K),
        pops=pops, nbytes=q_bytes + n * KNN_K * 8,
        launches=r["launches"].get("nearest_knn", 0),
        path=f"knn self-query, k = {KNN_K}, {n} particles",
        plain_input=sample_name, card=card, near_rep=near_rep,
        extra={"s": r["s"], "peak_gib": r["peak_gib"]}))
    del nn
    log(f"[14] knn row: {time.perf_counter() - t_all:.1f} s")

    # 2. EMST, keeping the third round's component map (the last, where
    # there are fewer rounds).
    calls = {"n": 0}
    wrapped = temst.nearest_other_component

    def keep_third(bvh_, centers, qcomp, comp, intervals, **kw):
        calls["n"] += 1
        if calls["n"] <= 3:
            calls["args"] = (comp.clone(), intervals.clone())
        return wrapped(bvh_, centers, qcomp, comp, intervals, **kw)

    with swapped(temst, "nearest_other_component", keep_third):
        with counted_step(torch, "emst", kernels, "[14]") as r:
            tree = emst(pts, device=DEV)
        steps.append(r)
    rounds = int(tree.rounds)
    require(r["launches"].get("nearest_other_component", 0) == rounds,
            "emst launched nearest_other_component once a round")
    labels = connected_components(n, tree.edges[:, 0], tree.edges[:, 1])
    require(tree.edges.shape == (n - 1, 2) and bool((tree.edges >= 0).all())
            and bool((labels == 0).all()), "emst: n - 1 edges that span")
    log(f"[14] emst: {n - 1} edges spanning {n} particles (one union-find "
        f"component), {rounds} rounds, total weight "
        f"{float(tree.total_weight):.9g}, longest edge "
        f"{float(tree.weights.max()):.4g}")
    del tree, labels
    comp, iv = calls["args"]
    (clo, _), int_s = timed_once(torch, lambda: temst._node_component_intervals(
        bvh, comp[bvh.leaf_perm.long()]))
    require(torch.equal(clo, iv[:, 0]), "node_reduce's intervals again")
    log(f"[14] one round's component intervals (node_reduce, a host sync a "
        f"level): {int_s:.2f} ms")
    del clo
    e_pops = int(kn.nearest_other_component(
        bvh, pts, comp, comp, iv, order=bvh.leaf_perm, records=rec, height=height,
        with_pops=True)[2].sum(dtype=torch.int64))
    n_comp = int((comp == torch.arange(n, dtype=torch.int32, device=DEV)).sum())
    rows.append(nearest_row(
        torch, name="nearest_other_component",
        run=lambda: kn.nearest_other_component(bvh, pts, comp, comp, iv,
                                               order=bvh.leaf_perm, records=rec,
                                               height=height),
        sub_run=lambda: kn.nearest_other_component(bvh, pts[sample], comp[sample],
                                                   comp, iv, records=rec,
                                                   height=height),
        plain=lambda: kn.nearest_other_component_plain(bvh, pts[sample],
                                                       comp[sample], comp, iv),
        pops=e_pops, nbytes=q_bytes + n * 8 + iv.numel() * 4 + n * 8,
        launches=r["launches"].get("nearest_other_component", 0),
        path=f"emst, {n} particles; ms at the third round's {n_comp} components",
        plain_input=sample_name + " (third round)", card=card, near_rep=near_rep,
        extra={"s": r["s"], "peak_gib": r["peak_gib"], "rounds": rounds,
               "intervals_ms": int_s}))
    del comp, iv, calls
    log(f"[14] emst row: {time.perf_counter() - t_all:.1f} s")

    # 3. MLS onto uniform targets.
    tgt = rng.uniform(0, 1, (n_targets, 3)).astype(np.float32)
    vals = mls_field(pos).astype(np.float32)
    with counted_step(torch, f"mls_interpolate k={MLS_K} onto {n_targets} targets",
                      kernels, "[14]") as r:
        interp = mls_interpolate(pts, torch.from_numpy(vals).to(DEV),
                                 torch.from_numpy(tgt).to(DEV), MLS_K, device=DEV)
    steps.append(r)
    require(r["launches"].get("nearest_knn", 0) == 1, "mls launched nearest_knn once")
    chk = rng.choice(n_targets, n_check, replace=False)
    cnn = knn(bvh, pts, torch.from_numpy(tgt[chk]).to(DEV), MLS_K)
    want, cond = mls_float64(pos, vals, tgt[chk], cnn.indices.cpu().numpy(),
                             cnn.distances.cpu().numpy())
    diff = np.abs(interp[torch.from_numpy(chk).to(DEV)].cpu().numpy() - want)
    require(bool(np.isfinite(interp.cpu().numpy()).all()), "mls: finite values")
    require(bool((diff <= mls_tolerance(cond)).all()),
            "mls_interpolate within its tolerance of the float64 solve")
    log(f"[14] mls_interpolate: {n_targets} finite values; {n_check} sampled "
        f"targets within 1e-5 + 8 cond 2^-24 of a float64 solve (largest "
        f"difference {diff.max():.3g}, median {np.median(diff):.3g}; condition "
        f"numbers up to {cond.max():.3g}); error against the field "
        f"{np.abs(want - mls_field(tgt[chk])).max():.3g} at most")
    del interp, cnn
    log(f"[14] mls checked: {time.perf_counter() - t_all:.1f} s")

    # 4. Nearest hits of phase 11's skewers on the tree of eps-boxes.
    obvh = build_bvh_objects(pts - eps, pts + eps, lo, hi)
    m = max(1 << 10, n >> 4)
    o, d = skewers(torch, seed + 31, m, lo, hi, pts)
    with counted_step(torch, f"raycast ({m} skewers, eps-box leaves)", kernels,
                      "[14]") as r:
        hits = raycast(obvh, o, d)
    steps.append(r)
    require(r["launches"].get("nearest_ray", 0) == 1, "raycast launched nearest_ray once")
    with counted_step(torch, "raycast_all (the same skewers)", kernels, "[14]") as r2:
        allh = raycast_all(obvh, o, d, sort_queries=True)
    steps.append(r2)
    inv = safe_inv(d)
    off = allh.offsets.long()
    least = torch.full((m,), float("inf"), device=DEV)
    found = torch.zeros(m, dtype=torch.int32, device=DEV)
    leaf_of = torch.empty(n, dtype=torch.long, device=DEV)
    leaf_of[obvh.leaf_perm.long()] = torch.arange(n, device=DEV) + (n - 1)
    for a, b in zip(range(0, m, 1 << 16), range(1 << 16, m + (1 << 16), 1 << 16)):
        b = min(b, m)
        row = torch.repeat_interleave(torch.arange(a, b, device=DEV),
                                      off[a + 1:b + 1] - off[a:b])
        obj = allh.indices[int(off[a]):int(off[b])].long()
        t, hit = ray_box(o[row], inv[row], obvh.node_lo[leaf_of[obj]],
                         obvh.node_hi[leaf_of[obj]])
        require(bool(hit.all()), "raycast_all rows hold hits")
        least.scatter_reduce_(0, row, t, "amin")
        found.scatter_reduce_(0, row, (obj == hits.index[row].long()).int(), "amax")
    miss = hits.index < 0
    require(bool(((off[1:] == off[:-1]) == miss).all()), "misses have empty rows")
    require(bool((found[~miss] == 1).all()) and bits_equal(torch, hits.t[~miss],
                                                    least[~miss]),
            "each nearest hit is in its row at the row's least t")
    r_pops = int(kn.nearest_ray(obvh, o, inv, records=kn.nearest_records(obvh),
                                with_pops=True)[2].sum(dtype=torch.int64))
    log(f"[14] raycast: {int((~miss).sum())} of {m} skewers hit; each hit is "
        f"its raycast_all row's least slab t ({int(allh.total)} hits), each "
        f"miss an empty row; {r_pops} pops")
    orec = kn.nearest_records(obvh)
    order = importlib.import_module(
        "repro_torch.core.query").query_sort_permutation(obvh, o)
    every = max(1, m >> 12)
    rsub = torch.arange(0, m, every, device=DEV)
    rows.append(nearest_row(
        torch, name="nearest_ray",
        run=lambda: kn.nearest_ray(obvh, o, inv, order=order, records=orec),
        sub_run=lambda: kn.nearest_ray(obvh, o[rsub], inv[rsub], records=orec),
        plain=lambda: kn.nearest_ray_plain(obvh, o[rsub], inv[rsub]),
        pops=r_pops, nbytes=orec.numel() * 4 + m * (12 + 12 + 8),
        launches=r["launches"].get("nearest_ray", 0),
        path=f"raycast of {m} skewers on the tree of {n} eps-boxes",
        plain_input=f"{rsub.numel()} of the {m} skewers (every {every}th)",
        card=card, near_rep=near_rep,
        extra={"s": r["s"], "peak_gib": r["peak_gib"]}))
    log(f"[14] phase 14 steps: {json.dumps(steps)}; "
        f"{time.perf_counter() - t_all:.1f} s")
    return rows


LM_ARCH = "xlstm-350m"


def adam_close(got, want, lr: float, n_steps: int, what: str) -> None:
    """Parameters after Adam steps: within 2e-5 except where the
    normalized step turned on a gradient within rounding of zero (at most
    1e-3 of the entries, each off by at most two steps of ``lr`` a step)."""
    diff = (got.float().cpu() - want.float().cpu()).abs()
    far = float((diff > 2e-5).float().mean())
    require(far <= 1e-3 and float(diff.max()) <= 2 * lr * n_steps,
            f"{what}: {far:.2e} of entries past 2e-5, max {float(diff.max()):.3g}")


def phase3_lm(seed: int):
    """The LM stack at smoke size, the card against the CPU on the same
    weights (float32, TF32 off). Tolerances: ``train_loss`` rtol 1e-5;
    each gradient leaf rtol 1e-4 and atol 1e-6 (entries at most ~0.2); the
    five steps' losses rtol 1e-5 and parameters by ``adam_close``; the
    decoded tokens equal and their logits within 1e-4; the embedding
    statistics' integers equal and eps within 2^-20 relative."""
    import torch
    from repro_torch.analysis.insitu import (InsituConfig, embedding_stats_from,
                                             sample_embedding_draws)
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.spec import init_params
    from repro_torch.optim import adamw
    from repro_torch.tree import keystr, leaves, leaves_with_path, tree_map

    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH).smoke()
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10,
                              moment_dtype="float32")
    icfg = InsituConfig(sample_rows=128)
    params = init_params(lm.model_spec(cfg), seed, torch.float32, "cpu")
    base = steps.TrainState(params, adamw.init_opt_state(opt_cfg, params))
    rows, r = sample_embedding_draws(base.params["embed"], icfg, seed)
    out = {}
    for dev in (DEV, "cpu"):
        state = tree_map(lambda x: x.to(dev), base)
        data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                          global_batch=4, seed=seed), device=dev)
        loss, _, grads = steps.value_and_grad(state.params, cfg, data.batch_at(0))
        losses = []
        for i in range(5):
            state, m = steps.train_step(state, data.batch_at(i), cfg=cfg,
                                        opt_cfg=opt_cfg)
            losses.append(float(m["loss"]))
        params0 = tree_map(lambda x: x.to(dev), base.params)
        prompt = data.batch_at(9)["tokens"][:, :12]
        logits, cache = steps.prefill_step(params0, {"tokens": prompt}, cfg=cfg,
                                           cache_len=14)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        toks, logs = [tok], []
        for i in range(2):
            tok, logits, cache = steps.serve_step(params0, cache, tok, 12 + i, cfg=cfg)
            toks.append(tok)
            logs.append(logits)
        stats = embedding_stats_from(rows.to(dev), r.to(dev), icfg)
        out[dev] = (loss, grads, losses, state, torch.cat(toks, 1), logs, stats)
    (lg, gg, lsg, sg, tg, logg, stg), (lc, gc, lsc, sc, tc, logc, stc) = \
        out[DEV], out["cpu"]
    require(abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc)), "train_loss card vs CPU")
    for (path, a), b in zip(leaves_with_path(gg), leaves(gc)):
        require(torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-6),
                f"gradient {keystr(path)} card vs CPU")
    require(all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(lsg, lsc)),
            f"train_step losses card {lsg} vs CPU {lsc}")
    for (path, a), b in zip(leaves_with_path(sg.params), leaves(sc.params)):
        adam_close(a, b, opt_cfg.lr, 5, f"parameter {keystr(path)} after 5 steps")
    require(int(sg.opt.step) == int(sc.opt.step) == 5, "optimizer step")
    require(torch.equal(tg.cpu(), tc), f"decoded tokens card {tg.tolist()} vs CPU {tc.tolist()}")
    for a, b in zip(logg, logc):
        require(torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-4), "decode logits card vs CPU")
    for k in stc:
        if k == "insitu/embed_eps":
            require(abs(float(stg[k]) - float(stc[k])) <= 2.0 ** -20 * float(stc[k]), k)
        else:
            require(float(stg[k]) == float(stc[k]), f"{k} card vs CPU")
    log(f"[3] LM at smoke size, card == CPU within tolerance: train_loss "
        f"{float(lg):.6f}, {len(leaves(gg))} gradient leaves, 5 train steps "
        f"(losses {lsg}), tokens {tg.tolist()}, embedding stats "
        f"{ {k: float(v) for k, v in stg.items()} }; "
        f"{time.perf_counter() - t0:.1f} s")


def analysis_hook(kernels: dict, cadence: int):
    """A supervisor's ``fault_hook`` that reads the launch counters of
    ``kernels`` and sets them to 0 before each step: the train step
    launches none of them, so what launched since the previous step's
    hook is that step's analysis, which runs every ``cadence`` steps; a
    step without one must have launched nothing. Returns the hook and the
    list of (step, launches) it fills; call the hook once more with the
    step count after the run, for the last step's launches."""
    launches, last = [], []

    def hook(i):
        if last:
            j = last.pop()
            got = {k: fn.launches for k, fn in kernels.items()}
            if j % cadence == 0:
                launches.append((j, got))
            else:
                require(not any(got.values()),
                        f"launches {got} at step {j}, which has no analysis")
        reset_counts(kernels)
        last.append(i)

    return hook, launches


def phase15_lm(seed: int, card: str, smoke: bool = False, batch: int = 8,
               seq: int = 128, prompts: int = 4, prompt_len: int = 32,
               gen: int = 16):
    """Phase 15: in-situ training mode at full width and depth, through the
    port's entry points ``repro_torch.launch.train.main`` and
    ``repro_torch.launch.serve.main`` (``smoke``: their reduced config,
    for a rehearsal)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.analysis import insitu
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps, train
    from repro_torch.models import lm
    from repro_torch.models.spec import TensorSpec, count_params, init_params
    from repro_torch.obs import SpanTracer
    from repro_torch.tree import leaves, tree_map

    t_all = time.perf_counter()
    cfg = get_config(LM_ARCH)
    cfg = cfg.smoke() if smoke else cfg
    n_params = count_params(lm.model_spec(cfg))
    require(smoke or abs(n_params - 0.34e9) / 0.34e9 < 0.05,
            f"xlstm-350m has {n_params} parameters")
    # 12 steps (cut from 30 to make room for phase 16 and the groups'
    # recompute), a fault at 7, checkpoints and analyses every 5
    total, every, fault_at, cadence = 12, 5, 7, 5
    pdt = "float32" if smoke else "bf16"
    common = ["--arch", LM_ARCH, "--seed", str(seed), "--device", DEV] \
        + (["--smoke"] if smoke else [])
    log(f"[15] {LM_ARCH}: {n_params} parameters ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim}, "
        f"vocab {cfg.padded_vocab}), {pdt} with float32 moments; batch {batch} x {seq}")
    kernels = kernel_wrappers(HACC_KERNELS)
    (SRC.parent / "build").mkdir(exist_ok=True)

    def train_run(fault: bool):
        """``launch.train.main`` for 12 steps, analysing every 5; with a
        fault at step 7 and a checkpoint every 5 steps, or without them
        and checkpointing only at the end. The hook that the
        supervisor calls before each step reads the launch counters and
        sets them to 0: the train step launches none of the four kernels,
        so what launched since the last step's hook is that step's
        analysis. Returns main's result, the spans and the launches."""
        tracer, crashed = SpanTracer(), []
        count, launches = analysis_hook(kernels, cadence)

        def hook(i):
            count(i)
            if fault and i == fault_at and not crashed:
                crashed.append(i)
                raise RuntimeError("injected fault")

        ckpt = tempfile.mkdtemp(dir=str(SRC.parent / "build"))
        try:
            t0 = time.perf_counter()
            out = train.main(common + [
                "--steps", str(total), "--batch", str(batch), "--seq", str(seq),
                "--ckpt-dir", ckpt, "--ckpt-every", str(every if fault else total + 1),
                "--insitu-every", str(cadence), "--log-every", "1"],
                fault_hook=hook, tracer=tracer)
            secs = time.perf_counter() - t0
            hook(total)                       # the last step's launches
            out.update(seconds=secs, launches=launches, crashed=crashed,
                       tracer=tracer, checkpoints=CheckpointStore(ckpt).steps())
        finally:
            shutil.rmtree(ckpt)
        for j, got in launches:
            require(all(v > 0 for v in got.values()),
                    f"the analysis at step {j} launched {got}")
        return out

    def analyses(out):
        spans = [e for e in out["tracer"].events if e["name"] == "insitu"]
        names = {e["name"] for e in out["tracer"].events}
        require(names == {"insitu", "insitu/embed_stats", "insitu/router_stats",
                          "insitu/host_readback"}, f"spans {sorted(names)}")
        return [(e["args"]["step"], round(e["dur"] / 1e3, 1), got)
                for e, (_, got) in zip(spans, out["launches"])]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref = train_run(fault=False)
    train_peak = torch.cuda.max_memory_allocated()
    step_s = [st.seconds for st in ref["supervisor"].stats]
    med = float(np.median(step_s[1:]))
    losses = ref["losses"]
    require(len(losses) == total, f"{len(losses)} losses logged")
    log(f"[15] uninterrupted run: {ref['seconds']:.1f} s; losses "
        f"{[round(x, 4) for x in losses]}; checkpoints {ref['checkpoints']}")
    log(f"[15] train step (supervisor's clock, to the end of its device work): "
        f"median {med * 1e3:.1f} ms ({batch * seq / med:.0f} tokens/s), first "
        f"{step_s[0] * 1e3:.1f} ms, max of the rest {max(step_s[1:]) * 1e3:.1f} ms; "
        f"peak memory {train_peak / 2**30:.2f} GiB ({card})")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    require(last < first, f"mean loss of the last 5 steps {last} >= first 5's {first}")
    ref_ana = analyses(ref)
    at = list(range(0, total, cadence))
    require([a[0] for a in ref_ana] == at, "analyses at the cadence")

    got = train_run(fault=True)
    got_ana = analyses(got)
    for step, ms, launched in got_ana:
        log(f"[15] analysis at step {step}: {ms} ms, launches {launched}")
    require(got["supervisor"].restarts == 1 and got["crashed"] == [fault_at],
            "one restart")
    resumed = fault_at // every * every       # its analysis runs twice
    require([a[0] for a in got_ana] == sorted(at + [resumed]), "analyses at the cadence")
    hist, ref_hist = got["insitu"], ref["insitu"]
    k = at.index(resumed)
    require(hist[k] == hist[k + 1] and hist[:k] + hist[k + 1:] == ref_hist,
            "the resumed run's analyses repeat the uninterrupted run's")
    same = [torch.equal(a, b) for a, b in zip(leaves(got["state"]), leaves(ref["state"]))]
    require(all(same) and len(same) == len(leaves(ref["state"])),
            f"resumed state != uninterrupted run in {same.count(False)} leaves")
    log(f"[15] supervised run through the fault: {got['seconds']:.1f} s, restart 1 "
        f"after the fault at step {fault_at}, resumed from step {every}; "
        f"checkpoints {got['checkpoints']}; all {len(same)} leaves (parameters, "
        f"moments, step) bit-equal to the uninterrupted run, analyses equal")
    del got
    params = ref["state"].params
    param_bytes = sum(x.numel() * x.element_size() for x in leaves(params))

    # Collapse: 80% of the embedding rows onto row 0.
    icfg = insitu.InsituConfig(eps_quantile=0.005)
    emb = params["embed"]
    idx = torch.arange(emb.shape[0], device=emb.device)
    reset_counts(kernels)
    base = insitu.embedding_cluster_stats(params, icfg, 1, device=DEV)
    collapsed = insitu.embedding_cluster_stats(
        {"embed": torch.where((idx % 5 > 0)[:, None], emb[0][None], emb)},
        icfg, 1, device=DEV)
    launches = {k: fn.launches for k, fn in kernels.items()}
    require(all(v > 0 for v in launches.values()), f"collapse launches {launches}")
    f0 = float(base["insitu/embed_clustered_frac"])
    f1 = float(collapsed["insitu/embed_clustered_frac"])
    require(f1 > f0, f"clustered fraction {f0} -> {f1} after the collapse")
    log(f"[15] collapse: clustered fraction {f0:.4f} -> {f1:.4f}, clusters "
        f"{int(base['insitu/embed_num_clusters'])} -> "
        f"{int(collapsed['insitu/embed_num_clusters'])}; launches {launches}")

    # Router clustering on deepseek-moe-16b's router shape.
    routers = init_params({"layers": {"sub0_attn_moe": {"moe": {"router": TensorSpec(
        (27, 2048, 64), ("layers", "embed", None))}}}}, seed, torch.bfloat16, DEV)
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rstats = {k: float(v) for k, v in insitu.router_cluster_stats(
        routers, insitu.InsituConfig(), 0, device=DEV).items()}
    r_ms = (time.perf_counter() - t0) * 1e3
    r_launch = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    require(set(rstats) == {"insitu/router_eps", "insitu/router_collapsed_experts"}
            and all(np.isfinite(v) for v in rstats.values()), f"router stats {rstats}")
    require({"wavefront_count", "wavefront_min_label"} <= set(r_launch),
            f"router launches {r_launch}")
    log(f"[15] routers (27, 2048, 64): {rstats}, {r_ms:.1f} ms, launches {r_launch}")

    # Serving through launch.serve.main (bf16, its own weights from the
    # seed), timed on its second call; then float32 on the trained weights
    # against the full forward.
    argv = common + ["--requests", str(prompts), "--prompt-len", str(prompt_len),
                     "--gen-tokens", str(gen)]
    serve.main(argv)                           # warm-up
    torch.cuda.reset_peak_memory_stats()
    served = serve.main(argv)
    serve_peak = torch.cuda.max_memory_allocated()
    require(served["tokens"].shape == (prompts, gen), "served tokens' shape")
    pre_ms, dec_ms = served["prefill_ms"], served["decode_ms_per_step"]
    log(f"[15] serve (launch.serve, {pdt}): prefill {prompts} x {prompt_len} tokens "
        f"into a {prompt_len + gen}-slot cache {pre_ms:.1f} ms, decode {dec_ms:.2f} "
        f"ms a step ({gen - 1} steps of {prompts}), peak memory "
        f"{serve_peak / 2**30:.2f} GiB ({card})")
    c32 = cfg.scaled(dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda x: x.float(), params)
    del ref, params
    prompt = torch.tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (prompts, prompt_len)), dtype=torch.int32, device=DEV)
    cache_len = prompt_len + gen
    logits, cache = steps.prefill_step(p32, {"tokens": prompt}, cfg=c32,
                                       cache_len=cache_len)
    fed = [torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]]
    for i in range(gen):
        nxt, logits, cache = steps.serve_step(p32, cache, fed[-1], prompt_len + i,
                                              cfg=c32)
        fed.append(nxt)
    seq_all = torch.cat([prompt] + fed[:gen], 1)
    full_logits, _ = steps.prefill_step(p32, {"tokens": seq_all}, cfg=c32,
                                        cache_len=cache_len)
    err = float((logits - full_logits).abs().max())
    require(torch.allclose(logits, full_logits, atol=2e-3, rtol=1e-3),
            f"decode logits vs full forward at float32: max error {err}")
    log(f"[15] float32: last decode step's logits == the full forward over "
        f"{seq_all.shape[1]} tokens within atol 2e-3, rtol 1e-3 (max error {err:.3g})")
    summary = {"params": n_params, "param_bytes": param_bytes,
               "train_step_ms": round(med * 1e3, 2),
               "tokens_per_s": round(batch * seq / med),
               "analysis_ms": [a[1] for a in got_ana],
               "analysis_launches": got_ana[0][2], "prefill_ms": round(pre_ms, 2),
               "decode_ms_per_step": round(dec_ms, 3),
               "train_peak_gib": round(train_peak / 2**30, 2),
               "serve_peak_gib": round(serve_peak / 2**30, 2), "card": card,
               "s": round(time.perf_counter() - t_all, 1)}
    log(f"[15] summary: {json.dumps(summary)}")
    return summary


HYBRID_ARCHS = ("jamba-1.5-large-398b", "llama-3.2-vision-11b", "seamless-m4t-large-v2")
ATTN_ARCHS = ("gemma2-9b", "phi3-medium-14b", "codeqwen1.5-7b", "granite-20b",
              "deepseek-moe-16b", "qwen3-moe-235b-a22b")


def grads_close(torch, got, want, what: str, atol: float = 1e-6) -> float:
    """Gradient leaves within rtol 1e-4 and ``atol`` of the leaf's largest
    entry (at least 1e-3). Returns the largest difference over that
    entry."""
    worst = 0.0
    for (path, a), b in zip(got, want):
        scale = max(float(b.abs().max()), 1e-3)
        err = float((a.cpu() - b).abs().max()) / scale
        worst = max(worst, err)
        require(torch.allclose(a.cpu(), b, rtol=1e-4, atol=atol * scale),
                f"{what}: gradient {path} card vs CPU ({err:.3g} of its largest entry)")
    return worst


def frontend_batch(torch, cfg, rng, batch: int, dev) -> dict:
    """The frontend's stub embeddings (batch, frontend_tokens,
    frontend_dim) f32 from ``rng``, under both ``frames`` and ``vision``
    as ``SyntheticTokens`` gives them; {} without a frontend."""
    if not cfg.frontend_dim:
        return {}
    emb = torch.tensor(rng.standard_normal((batch, cfg.frontend_tokens, cfg.frontend_dim)),
                       dtype=torch.float32, device=dev)
    return {"frames": emb, "vision": emb}


# Deep Mamba stacks amplify roundings: at jamba's smoke size the f32
# gradients of the CPU and of JAX each lie up to 1.6e-5 of a leaf's
# largest entry from the same model in float64, so two f32 runs may lie
# twice that apart (the card from the CPU: up to 3.44e-5 on an H100).
# llama and seamless: the bound of tests/test_torch_hybrid.py.
GRAD_ATOL = {"jamba-1.5-large-398b": 1e-4, "llama-3.2-vision-11b": 1e-5,
             "seamless-m4t-large-v2": 1e-5}
# Its caches likewise: after its 8 layers, a float32 prefill and two
# decode steps leave Mamba states and conv windows (entries up to ~4) up
# to 2.7e-5 from float64's (8 seeds, on the CPU), so two f32 runs may lie
# twice that apart (the card from the CPU: up to 4.01e-5 on an H100).
CACHE_ATOL = {"jamba-1.5-large-398b": 1e-4}


def phase3_attention_archs(seed: int, batch: int = 2, s: int = 20):
    """The six architectures of attention, the dense FFN and MoE and the
    three of Mamba, cross-attention and the encoder (jamba, llama-3.2-vision,
    seamless, with their frontends' embeddings from one seeded draw) at
    smoke size (float32, TF32 off), the card against the CPU on the same
    weights: ``train_loss`` (rtol 1e-5) and its aux loss (rtol 1e-5,
    atol 1e-7) with every gradient leaf (``grads_close``; the three at
    ``GRAD_ATOL``), ``prefill`` of ``s - 2`` tokens into an ``s``-slot
    cache and two ``serve_step``s fed the same tokens: logits within rtol
    1e-4, atol 1e-4, the caches' leaves (KV slots, Mamba's state and conv
    window, the cross layers' memory K/V) within rtol 1e-5, atol 1e-5
    (jamba: ``CACHE_ATOL``). Logs each arch's loss, its gradients'
    largest difference over a leaf's largest entry and its caches'
    largest difference."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.spec import init_params
    from repro_torch.tree import keystr, leaves, leaves_with_path, tree_map

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    seen = {}
    for arch in ATTN_ARCHS + HYBRID_ARCHS:
        cfg = get_config(arch).smoke()
        params = init_params(lm.model_spec(cfg), seed, torch.float32, "cpu")
        toks = rng.integers(0, cfg.vocab, (batch, s + 1)).astype(np.int32)
        mask = rng.random((batch, s)) < 0.9
        emb = frontend_batch(torch, cfg, rng, batch, "cpu")
        out = {}
        for dev in (DEV, "cpu"):
            p = tree_map(lambda x: x.to(dev), params)
            front = {k: v.to(dev) for k, v in emb.items()}
            b = {"tokens": torch.tensor(toks[:, :-1], device=dev),
                 "labels": torch.tensor(toks[:, 1:], device=dev),
                 "loss_mask": torch.tensor(mask, device=dev), **front}
            loss, metrics, grads = steps.value_and_grad(p, cfg, b)
            logits, cache = steps.prefill_step(
                p, {"tokens": b["tokens"][:, :s - 2], **front}, cfg=cfg, cache_len=s)
            logs = [logits]
            for i in range(2):
                _, logits, cache = steps.serve_step(p, cache, b["tokens"][:, s - 2 + i:s - 1 + i],
                                                    s - 2 + i, cfg=cfg)
                logs.append(logits)
            out[dev] = (loss, metrics["aux_loss"], leaves_with_path(grads), logs,
                        leaves_with_path(cache))
        (lg, ag, gg, logg, cg), (lc, ac, gc, logc, cc) = out[DEV], out["cpu"]
        require(abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc)), f"{arch}: train_loss")
        require(abs(float(ag) - float(ac)) <= 1e-5 * abs(float(ac)) + 1e-7, f"{arch}: aux loss")
        g_err = grads_close(torch, [(keystr(q), a) for q, a in gg], [b for _, b in gc],
                            arch, GRAD_ATOL.get(arch, 1e-6))
        for i, (a, b) in enumerate(zip(logg, logc)):
            require(torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-4),
                    f"{arch}: logits of step {i} card vs CPU "
                    f"(max error {float((a.cpu() - b).abs().max()):.3g})")
        c_atol, c_err = CACHE_ATOL.get(arch, 1e-5), 0.0
        for (q, a), (_, b) in zip(cg, cc):
            err = float((a.cpu() - b).abs().max())
            c_err = max(c_err, err)
            require(torch.allclose(a.cpu(), b, rtol=1e-5, atol=c_atol),
                    f"{arch}: cache {keystr(q)} card vs CPU (max error {err:.3g})")
        seen[arch] = {"loss": round(float(lg), 5), "grad_err": float(f"{g_err:.3g}"),
                      "cache_err": float(f"{c_err:.3g}")}
    log(f"[3] attention, dense FFN, MoE, Mamba, cross-attention and the encoder at "
        f"smoke size, card == CPU within tolerance (train_loss, gradients, prefill, 2 "
        f"decode steps, caches): {json.dumps(seen)}; {time.perf_counter() - t0:.1f} s")


MOE_ARCH = "deepseek-moe-16b"
GEMMA_ARCH = "gemma2-9b"


def decode_bytes(cfg, n_params: int, batch: int, cache_len: int, dtype_bytes: int) -> int:
    """Bytes a decode step must move: every weight but the embedding table
    (of which it reads ``batch`` rows), the frontend's projection, the
    encoder and the cross layers' K/V projections (which only the prefill
    runs) once at ``dtype_bytes`` each, and every cache leaf (KV slots,
    recurrent states, the cross layers' memory K/V) once at its own
    dtype's size."""
    from repro_torch.models import blocks as B
    from repro_torch.models import lm
    from repro_torch.models.spec import count_params
    spec = lm.model_spec(cfg)
    unread = [spec[k] for k in ("frontend_proj", "encoder") if k in spec]
    unread += [{n: sub["attn"][n] for n in ("wk", "wv", "bk", "bv", "k_norm") if n in sub["attn"]}
               for key, sub in spec["layers"].items() if "_cross" in key]
    n_params -= sum(count_params(t) for t in unread)
    kv = 0
    layers = {"layers": (B.group_cache_shapes(cfg, batch, cache_len), cfg.n_groups)}
    if cfg.first_layer_dense_ff:
        layers["layer0"] = (B.group_cache_shapes(lm._dense_cfg(cfg), batch, cache_len), 1)
    for shapes, groups in layers.values():
        for sub in shapes.values():
            kv += groups * sum(int(np.prod(sh)) * dt.itemsize for sh, dt in sub.values())
    table = cfg.padded_vocab * cfg.d_model
    return (n_params - table + batch * cfg.d_model) * dtype_bytes + kv


def chunked_vs_full(torch, cfg, seed: int, s: int, dev: str) -> dict:
    """One ``attn_local`` and one ``attn`` layer of ``cfg`` (bf16, seeded
    weights) at ``s`` tokens: ``self_attention`` on its blockwise path
    against the same call with ``_sdpa`` and its full mask (the chunked
    threshold raised past ``s``). Returns each layer's norm-relative and
    largest absolute difference of the outputs."""
    from repro_torch.models import attention as A
    from repro_torch.models.spec import init_params
    p = init_params(A.attn_spec(cfg), seed, torch.bfloat16, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((1, s, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.arange(s, device=dev)[None]
    out = {}
    for kind, window in (("attn_local", cfg.sliding_window), ("attn", None)):
        with torch.no_grad():
            chunked, _ = A.self_attention(p, cfg, x, positions=pos, window=window)
            with swapped(A, "CHUNKED_THRESHOLD", s + 1):
                full, _ = A.self_attention(p, cfg, x, positions=pos, window=window)
        diff = (chunked.float() - full.float())
        out[kind] = {"rel": float(diff.norm() / full.float().norm()),
                     "max_abs": float(diff.abs().max()),
                     "max_out": float(full.float().abs().max())}
        del chunked, full, diff
    return out


# bf16: the blockwise path rounds its unnormalized tile probabilities to
# bf16, the full path its normalized ones, so outputs differ by roundings.
CHUNKED_REL_TOL = 1e-2


def free_card(torch) -> None:
    """Release what the previous step left: its tensors once a collection
    has run, then the allocator's cached blocks."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def serve_twice(serve, argv, config=None, params=None):
    """``launch.serve.main`` twice, the second call timed and traced for
    peak memory. Returns its result and the peak in bytes."""
    import torch
    serve.main(argv, config=config, params=params)      # warm-up
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    out = serve.main(argv, config=config, params=params)
    return out, torch.cuda.max_memory_allocated()


def decode_vs_full(torch, cfg, seed: int, prompts: int, plen: int, gen: int) -> float:
    """``cfg`` (float32) with seeded weights on the card: ``prefill_step``
    of ``prompts`` prompts of ``plen`` tokens (with the frontend's
    embeddings from the same seed), then ``gen`` ``serve_step``s, each fed
    the last one's token; the last step's logits must equal the full
    forward over the ``plen + gen`` tokens within the reference test's
    tolerance (atol 2e-3, rtol 1e-3). Returns the largest error."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.spec import init_params
    p32 = init_params(lm.model_spec(cfg), seed, torch.float32, DEV)
    rng = np.random.default_rng(seed)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (prompts, plen)), dtype=torch.int32,
                          device=DEV)
    front = frontend_batch(torch, cfg, rng, prompts, DEV)
    cache_len = plen + gen
    logits, cache = steps.prefill_step(p32, {"tokens": prompt, **front}, cfg=cfg,
                                       cache_len=cache_len)
    fed = [torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]]
    for i in range(gen):
        nxt, logits, cache = steps.serve_step(p32, cache, fed[-1], plen + i, cfg=cfg)
        fed.append(nxt)
    seq_all = torch.cat([prompt] + fed[:gen], 1)
    full, _ = steps.prefill_step(p32, {"tokens": seq_all, **front}, cfg=cfg,
                                 cache_len=cache_len)
    err = float((logits - full).abs().max())
    require(torch.allclose(logits, full, atol=2e-3, rtol=1e-3),
            f"{cfg.name} decode logits vs full forward at float32: max error {err}")
    return err


def phase16_attention_moe(seed: int, card: str, smoke: bool = False,
                          serve_prompts: int = 4, serve_len: int = 32,
                          serve_gen: int = 16, check_groups: int = 2,
                          train_groups: int = 4, train_steps: int = 10,
                          batch: int = 8, seq: int = 128, cadence: int = 5,
                          gemma_len: int = 8192, gemma_gen: int = 16):
    """Phase 16: attention, the dense FFN and MoE at full width through the
    port's entry points. (a) deepseek-moe-16b serves at full size (bf16,
    ``launch.serve.main``, timed on its second call); (b) at float32,
    full width, ``check_groups`` groups plus layer 0 and no-drop capacity,
    the last of ``serve_gen`` decode steps' logits against the full
    forward; (c) it trains ``train_steps`` steps at ``train_groups``
    groups plus layer 0 (``launch.train.main`` with ``config=``) with the
    in-situ analysis every ``cadence`` steps clustering its own routers;
    (d) gemma2-9b serves a ``gemma_len``-token prompt at full size, and
    its blockwise attention agrees with the full path on one local and
    one global layer. ``smoke``: the reduced configs, for a rehearsal."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models import attention as A
    from repro_torch.models import lm
    from repro_torch.models.spec import count_params
    from repro_torch.obs import SpanTracer

    t_all = time.perf_counter()
    summary = {"card": card}
    common = ["--seed", str(seed), "--device", DEV] + (["--smoke"] if smoke else [])
    pdt = "float32" if smoke else "bf16"

    # (a) deepseek-moe-16b serves at full size.
    cfg = get_config(MOE_ARCH)
    cfg = cfg.smoke() if smoke else cfg
    n_params = count_params(lm.model_spec(cfg))
    require(smoke or abs(n_params - 16.4e9) / 16.4e9 < 0.05,
            f"{MOE_ARCH} has {n_params} parameters")
    log(f"[16] {MOE_ARCH}: {n_params} parameters ({cfg.n_groups} MoE groups + "
        f"layer 0, d_model {cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k}, "
        f"{cfg.n_shared_experts} shared, vocab {cfg.padded_vocab}), {pdt}")
    argv = ["--arch", MOE_ARCH] + common + [
        "--requests", str(serve_prompts), "--prompt-len", str(serve_len),
        "--gen-tokens", str(serve_gen)]
    served, peak = serve_twice(serve, argv)
    require(served["tokens"].shape == (serve_prompts, serve_gen), "served tokens' shape")
    nbytes = decode_bytes(cfg, n_params, serve_prompts, serve_len + serve_gen,
                          4 if smoke else 2)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    pre_ms, dec_ms = served["prefill_ms"], served["decode_ms_per_step"]
    log(f"[16] (a) serve {MOE_ARCH} (launch.serve, {pdt}, second call): prefill "
        f"{serve_prompts} x {serve_len} tokens {pre_ms:.1f} ms, decode {dec_ms:.2f} ms "
        f"a step ({serve_gen - 1} steps of {serve_prompts}); bytes bound of a decode "
        f"step {nbytes / 1e9:.2f} GB / 3.35 TB/s = {bound_ms:.2f} ms "
        f"({bound_ms / dec_ms:.3f} of it); peak memory {peak / 2**30:.2f} GiB ({card})")
    summary.update(moe_params=n_params, moe_prefill_ms=round(pre_ms, 2),
                   moe_decode_ms_per_step=round(dec_ms, 3),
                   moe_decode_bound_ms=round(bound_ms, 3),
                   moe_serve_peak_gib=round(peak / 2**30, 2))
    del served

    # (b) float32, full width, fewer groups, no-drop capacity: decode ==
    # the full forward.
    c32 = cfg.scaled(n_layers=check_groups, dtype="float32", param_dtype="float32",
                     capacity_factor=float(cfg.n_experts))
    err = decode_vs_full(torch, c32, seed, serve_prompts, serve_len, serve_gen)
    log(f"[16] (b) {MOE_ARCH} at float32, {check_groups} groups + layer 0, capacity "
        f"factor {c32.capacity_factor:g} (no drops): the last of {serve_gen} decode "
        f"steps' logits == the full forward over {serve_len + serve_gen} tokens within "
        f"atol 2e-3, rtol 1e-3 (max error {err:.3g}; {card})")
    summary["moe_decode_vs_full_max_err"] = err

    # (c) training at full width with fewer groups, in-situ every cadence.
    kernels = kernel_wrappers(HACC_KERNELS)
    tcfg = get_config(MOE_ARCH).scaled(n_layers=train_groups)
    t_params = count_params(lm.model_spec(tcfg.smoke() if smoke else tcfg))
    tracer = SpanTracer()
    hook, launches = analysis_hook(kernels, cadence)

    (SRC.parent / "build").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(dir=str(SRC.parent / "build"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        out = train.main(["--arch", MOE_ARCH] + common + [
            "--steps", str(train_steps), "--batch", str(batch), "--seq", str(seq),
            "--ckpt-dir", ckpt, "--ckpt-every", str(train_steps + 1),
            "--insitu-every", str(cadence), "--log-every", "1"],
            fault_hook=hook, tracer=tracer, config=tcfg)
        secs = time.perf_counter() - t0
        hook(train_steps)
    finally:
        shutil.rmtree(ckpt)
    train_peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    step_s = [st.seconds for st in out["supervisor"].stats]
    med = float(np.median(step_s[1:]))
    aux = [st.metrics["aux_loss"] for st in out["supervisor"].stats]
    require(len(losses) == train_steps and losses[-1] < losses[0],
            f"{MOE_ARCH} training losses {losses}")
    require(all(np.isfinite(aux)), f"aux losses {aux}")
    routers = out["state"].params["layers"]["sub0_attn_moe"]["moe"]["router"]
    t_cfg = tcfg.smoke() if smoke else tcfg
    require(tuple(routers.shape) == (t_cfg.n_groups, t_cfg.d_model, t_cfg.n_experts),
            f"router leaf {tuple(routers.shape)}")
    spans = [e for e in tracer.events if e["name"] == "insitu"]
    require([j for j, _ in launches] == list(range(0, train_steps, cadence))
            and len(spans) == len(launches), f"analyses at {[j for j, _ in launches]}")
    hist = out["insitu"]
    for (j, got), (_, stats) in zip(launches, hist):
        require(all(v > 0 for v in got.values()), f"the analysis at step {j} launched {got}")
        require({"insitu/router_eps", "insitu/router_collapsed_experts"} <= set(stats)
                and all(np.isfinite(v) for v in stats.values()),
                f"the analysis at step {j}: {stats}")
    ana = [(j, round(e["dur"] / 1e3, 1), got) for e, (j, got) in zip(spans, launches)]
    for j, ms, got in ana:
        log(f"[16] (c) analysis at step {j}: {ms} ms, launches {got}; router stats "
            f"{ {k: v for k, v in dict(hist)[j].items() if 'router' in k} } ({card})")
    log(f"[16] (c) train {MOE_ARCH} (launch.train, {pdt}, float32 moments), "
        f"{t_cfg.n_groups} groups + layer 0 at full width, {t_params} parameters, batch "
        f"{batch} x {seq}: losses {[round(x, 4) for x in losses]}, aux "
        f"{[round(x, 4) for x in aux]}; median step {med * 1e3:.1f} ms "
        f"({batch * seq / med:.0f} tokens/s), first {step_s[0] * 1e3:.1f} ms; "
        f"{secs:.1f} s with the checkpoint at the end; peak memory "
        f"{train_peak / 2**30:.2f} GiB ({card}); the routers clustered: "
        f"{tuple(routers.shape)} averaged over groups to {t_cfg.n_experts} columns")
    summary.update(moe_train_params=t_params, moe_train_step_ms=round(med * 1e3, 2),
                   moe_train_tokens_per_s=round(batch * seq / med),
                   moe_analysis_ms=[a[1] for a in ana], moe_analysis_launches=ana[0][2],
                   moe_train_peak_gib=round(train_peak / 2**30, 2),
                   moe_train_s=round(secs, 1))
    del out, routers

    # (d) gemma2-9b serves a long prompt at full size.
    held = torch.cuda.memory_allocated()
    free_card(torch)
    log(f"[16] (d) device memory allocated before: {held / 2**30:.2f} GiB, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after a collection ({card})")
    gcfg = get_config(GEMMA_ARCH)
    gcfg = gcfg.smoke() if smoke else gcfg
    g_params = count_params(lm.model_spec(gcfg))
    require(smoke or abs(g_params - 9.24e9) / 9.24e9 < 0.05,
            f"{GEMMA_ARCH} has {g_params} parameters")
    require(gemma_len >= A.CHUNKED_THRESHOLD, "the prompt takes the blockwise path")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g_served = serve.main(["--arch", GEMMA_ARCH] + common + [
        "--requests", "1", "--prompt-len", str(gemma_len), "--gen-tokens", str(gemma_gen)])
    g_peak = torch.cuda.max_memory_allocated()
    require(g_served["tokens"].shape == (1, gemma_gen), "gemma2 tokens' shape")
    g_bytes = decode_bytes(gcfg, g_params, 1, gemma_len + gemma_gen, 4 if smoke else 2)
    g_bound = g_bytes / HBM_BYTES_PER_S * 1e3
    g_pre, g_dec = g_served["prefill_ms"], g_served["decode_ms_per_step"]
    log(f"[16] (d) serve {GEMMA_ARCH} (launch.serve, {pdt}, first call): {g_params} "
        f"parameters, {gcfg.n_layers} layers, window {gcfg.sliding_window}, 1 prompt of "
        f"{gemma_len} tokens (blockwise attention) {g_pre:.1f} ms, decode {g_dec:.2f} ms "
        f"a step ({gemma_gen - 1} steps into a {gemma_len + gemma_gen}-slot cache; bytes "
        f"bound {g_bytes / 1e9:.2f} GB, {g_bound:.2f} ms); peak memory "
        f"{g_peak / 2**30:.2f} GiB ({card})")
    del g_served
    torch.cuda.empty_cache()
    layers = chunked_vs_full(torch, gcfg, seed, gemma_len, DEV)
    for kind, r in layers.items():
        require(r["rel"] <= CHUNKED_REL_TOL,
                f"{GEMMA_ARCH} {kind}: blockwise vs full attention {r}")
    log(f"[16] (d) {GEMMA_ARCH} at {gemma_len} tokens, bf16: blockwise attention == "
        f"_sdpa with its full mask within {CHUNKED_REL_TOL:g} norm-relative: "
        f"{json.dumps(layers)} ({card})")
    summary.update(gemma_params=g_params, gemma_prefill_ms=round(g_pre, 2),
                   gemma_decode_ms_per_step=round(g_dec, 3),
                   gemma_decode_bound_ms=round(g_bound, 3),
                   gemma_serve_peak_gib=round(g_peak / 2**30, 2),
                   gemma_chunked_rel={k: r["rel"] for k, r in layers.items()},
                   s=round(time.perf_counter() - t_all, 1))
    log(f"[16] summary: {json.dumps(summary)}")
    return summary


JAMBA_ARCH, VISION_ARCH, SEAMLESS_ARCH = HYBRID_ARCHS


# Phase 17's shapes: requests of SERVE_LEN tokens decoded SERVE_GEN;
# jamba at one group (8 layers) of JAMBA_EXPERTS experts has JAMBA_PARAMS
# parameters (one group at its published 16 experts has 4.52e10, 90.5 GB
# in bf16: more than the card holds); seamless trains TRAIN_STEPS steps
# of TRAIN_BATCH x TRAIN_SEQ tokens with the analysis every CADENCE.
SERVE_PROMPTS, SERVE_LEN, SERVE_GEN, LONG_LEN = 4, 32, 16, 8192
JAMBA_EXPERTS, JAMBA_PARAMS = 8, 2.59e10
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, CADENCE = 10, 8, 128, 5


def phase17_hybrid(seed: int, card: str, smoke: bool = False):
    """Phase 17: Mamba, cross-attention and the encoder at full width
    through the port's entry points. (a) jamba-1.5-large serves one group
    (8 layers: attention, 7 Mamba, 4 MoE) at ``JAMBA_EXPERTS`` experts in
    bf16 (``launch.serve.main(config=)``, timed on its second call), then
    one ``LONG_LEN``-token prompt; (b) at float32, the last of
    ``SERVE_GEN`` decode steps' logits against the full forward for jamba
    (one group, 2 experts with no-drop capacity, ``ssm_chunk`` 16 so that
    the 48 tokens run as 3 chunks), llama-3.2-vision (one group of 5 layers with
    its cross layer) and seamless at full size; (c) llama-3.2-vision-11b
    serves at full size (bf16); (d) seamless trains ``TRAIN_STEPS`` steps
    at full size (bf16, float32 moments) with the in-situ analysis every
    ``CADENCE`` steps, then serves on the trained weights
    (``launch.serve.main(params=)``). ``smoke``: the reduced configs, for
    a rehearsal."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models import lm
    from repro_torch.models.spec import count_params
    from repro_torch.obs import SpanTracer
    from repro_torch.tree import leaves

    t_all = time.perf_counter()
    summary = {"card": card}
    common = ["--seed", str(seed), "--device", DEV] + (["--smoke"] if smoke else [])
    pdt = "float32" if smoke else "bf16"
    reduce = (lambda c: c.smoke()) if smoke else (lambda c: c)
    serve_argv = common + ["--requests", str(SERVE_PROMPTS), "--prompt-len",
                           str(SERVE_LEN), "--gen-tokens", str(SERVE_GEN)]

    def bound(cfg, n_params, requests, cache_len):
        nbytes = decode_bytes(cfg, n_params, requests, cache_len, 4 if smoke else 2)
        return nbytes, nbytes / HBM_BYTES_PER_S * 1e3

    # (a) jamba: one group at full width, fewer experts.
    jcfg = get_config(JAMBA_ARCH).scaled(n_layers=8, n_experts=JAMBA_EXPERTS)
    j_params = count_params(lm.model_spec(reduce(jcfg)))
    require(smoke or abs(j_params - JAMBA_PARAMS) / JAMBA_PARAMS < 0.01,
            f"{JAMBA_ARCH} at one group has {j_params} parameters")
    free_card(torch)
    served, peak = serve_twice(serve, ["--arch", JAMBA_ARCH] + serve_argv, jcfg)
    require(served["tokens"].shape == (SERVE_PROMPTS, SERVE_GEN), "jamba's tokens")
    nbytes, b_ms = bound(reduce(jcfg), j_params, SERVE_PROMPTS, SERVE_LEN + SERVE_GEN)
    pre_ms, dec_ms = served["prefill_ms"], served["decode_ms_per_step"]
    log(f"[17] (a) serve {JAMBA_ARCH} (launch.serve, {pdt}, second call): one group "
        f"({jcfg.n_layers} layers {list(jcfg.block_pattern)}), {jcfg.n_experts} experts "
        f"top-{jcfg.top_k}, {j_params} parameters; prefill {SERVE_PROMPTS} x {SERVE_LEN} "
        f"tokens {pre_ms:.1f} ms, decode {dec_ms:.2f} ms a step ({SERVE_GEN - 1} steps of "
        f"{SERVE_PROMPTS}); bytes bound of a decode step {nbytes / 1e9:.2f} GB / 3.35 TB/s "
        f"= {b_ms:.2f} ms ({b_ms / dec_ms:.3f} of it); peak memory {peak / 2**30:.2f} GiB "
        f"({card})")
    summary.update(jamba_params=j_params, jamba_prefill_ms=round(pre_ms, 2),
                   jamba_decode_ms_per_step=round(dec_ms, 3),
                   jamba_decode_bound_ms=round(b_ms, 3),
                   jamba_serve_peak_gib=round(peak / 2**30, 2))
    del served
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    long = serve.main(["--arch", JAMBA_ARCH] + common + [
        "--requests", "1", "--prompt-len", str(LONG_LEN), "--gen-tokens", str(SERVE_GEN)],
        config=jcfg)
    l_peak = torch.cuda.max_memory_allocated()
    require(long["tokens"].shape == (1, SERVE_GEN), "jamba's long prompt's tokens")
    _, l_bound = bound(reduce(jcfg), j_params, 1, LONG_LEN + SERVE_GEN)
    chunk = reduce(jcfg).ssm_chunk
    log(f"[17] (a) {JAMBA_ARCH}: 1 prompt of {LONG_LEN} tokens ({LONG_LEN // chunk} "
        f"chunks of {chunk} in each Mamba layer, blockwise attention) {long['prefill_ms']:.1f} "
        f"ms (first call), decode {long['decode_ms_per_step']:.2f} ms a step ({SERVE_GEN - 1} "
        f"steps; bytes bound {l_bound:.2f} ms); peak memory {l_peak / 2**30:.2f} GiB ({card})")
    summary.update(jamba_long_prefill_ms=round(long["prefill_ms"], 2),
                   jamba_long_decode_ms_per_step=round(long["decode_ms_per_step"], 3),
                   jamba_long_peak_gib=round(l_peak / 2**30, 2))
    del long
    free_card(torch)

    # (b) float32 against the full forward.
    f32 = dict(dtype="float32", param_dtype="float32")
    checks = {
        JAMBA_ARCH: get_config(JAMBA_ARCH).scaled(n_layers=8, n_experts=2, capacity_factor=2.0,
                                                  ssm_chunk=16, **f32),
        VISION_ARCH: get_config(VISION_ARCH).scaled(n_layers=5, **f32),
        SEAMLESS_ARCH: get_config(SEAMLESS_ARCH).scaled(**f32)}
    errs = {}
    for arch, c32 in checks.items():
        c32 = reduce(c32)
        errs[arch] = decode_vs_full(torch, c32, seed, SERVE_PROMPTS, SERVE_LEN, SERVE_GEN)
        log(f"[17] (b) {arch} at float32, {c32.n_layers} layers, "
            f"{count_params(lm.model_spec(c32))} parameters: the last of {SERVE_GEN} decode "
            f"steps' logits == the full forward over {SERVE_LEN + SERVE_GEN} tokens within "
            f"atol 2e-3, rtol 1e-3 (max error {errs[arch]:.3g}; {card})")
        free_card(torch)
    summary["decode_vs_full_max_err"] = errs

    # (c) llama-3.2-vision-11b at full size.
    vcfg = reduce(get_config(VISION_ARCH))
    v_params = count_params(lm.model_spec(vcfg))
    require(smoke or abs(v_params - 9.81e9) / 9.81e9 < 0.01,
            f"{VISION_ARCH} has {v_params} parameters")
    served, peak = serve_twice(serve, ["--arch", VISION_ARCH] + serve_argv)
    require(served["tokens"].shape == (SERVE_PROMPTS, SERVE_GEN), "llama's tokens")
    nbytes, b_ms = bound(vcfg, v_params, SERVE_PROMPTS, SERVE_LEN + SERVE_GEN)
    pre_ms, dec_ms = served["prefill_ms"], served["decode_ms_per_step"]
    log(f"[17] (c) serve {VISION_ARCH} (launch.serve, {pdt}, second call): {v_params} "
        f"parameters, {vcfg.frontend_tokens} x {vcfg.frontend_dim} vision embeddings a "
        f"request; prefill {SERVE_PROMPTS} x {SERVE_LEN} tokens {pre_ms:.1f} ms, decode "
        f"{dec_ms:.2f} ms a step; bytes bound {nbytes / 1e9:.2f} GB = {b_ms:.2f} ms "
        f"({b_ms / dec_ms:.3f} of it); peak memory {peak / 2**30:.2f} GiB ({card})")
    summary.update(vision_params=v_params, vision_prefill_ms=round(pre_ms, 2),
                   vision_decode_ms_per_step=round(dec_ms, 3),
                   vision_decode_bound_ms=round(b_ms, 3),
                   vision_serve_peak_gib=round(peak / 2**30, 2))
    del served
    free_card(torch)

    # (d) seamless trains at full size with the in-situ analysis.
    scfg = reduce(get_config(SEAMLESS_ARCH))
    s_params = count_params(lm.model_spec(scfg))
    require(smoke or abs(s_params - 1.67e9) / 1.67e9 < 0.01,
            f"{SEAMLESS_ARCH} has {s_params} parameters")
    kernels = kernel_wrappers(HACC_KERNELS)
    tracer = SpanTracer()
    hook, launches = analysis_hook(kernels, CADENCE)

    (SRC.parent / "build").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(dir=str(SRC.parent / "build"))
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        out = train.main(["--arch", SEAMLESS_ARCH] + common + [
            "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--ckpt-dir", ckpt, "--ckpt-every", str(TRAIN_STEPS + 1),
            "--insitu-every", str(CADENCE), "--log-every", "1"],
            fault_hook=hook, tracer=tracer)
        secs = time.perf_counter() - t0
        hook(TRAIN_STEPS)
    finally:
        shutil.rmtree(ckpt)
    train_peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    step_s = [st.seconds for st in out["supervisor"].stats]
    med = float(np.median(step_s[1:]))
    require(len(losses) == TRAIN_STEPS and losses[-1] < losses[0],
            f"{SEAMLESS_ARCH} training losses {losses}")
    spans = [e for e in tracer.events if e["name"] == "insitu"]
    require([j for j, _ in launches] == list(range(0, TRAIN_STEPS, CADENCE))
            and len(spans) == len(launches), f"analyses at {[j for j, _ in launches]}")
    for j, got in launches:
        require(all(v > 0 for v in got.values()), f"the analysis at step {j} launched {got}")
    ana = [(j, round(e["dur"] / 1e3, 1), got) for e, (j, got) in zip(spans, launches)]
    for j, ms, got in ana:
        log(f"[17] (d) analysis at step {j}: {ms} ms, launches {got}; "
            f"{ {k: round(float(v), 4) for k, v in dict(out['insitu'])[j].items()} } ({card})")
    frames = TRAIN_SEQ * TRAIN_BATCH + scfg.frontend_tokens * TRAIN_BATCH
    log(f"[17] (d) train {SEAMLESS_ARCH} (launch.train, {pdt}, float32 moments), full size, "
        f"{s_params} parameters, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens + "
        f"{scfg.frontend_tokens} frames of {scfg.frontend_dim}: losses "
        f"{[round(x, 4) for x in losses]}; median step {med * 1e3:.1f} ms "
        f"({TRAIN_BATCH * TRAIN_SEQ / med:.0f} decoder tokens/s, {frames / med:.0f} "
        f"with the frames), first {step_s[0] * 1e3:.1f} ms; {secs:.1f} s with the checkpoint "
        f"at the end; peak memory {train_peak / 2**30:.2f} GiB ({card})")
    summary.update(seamless_params=s_params, seamless_train_step_ms=round(med * 1e3, 2),
                   seamless_train_tokens_per_s=round(TRAIN_BATCH * TRAIN_SEQ / med),
                   seamless_analysis_ms=[a[1] for a in ana],
                   seamless_analysis_launches=ana[0][2],
                   seamless_train_peak_gib=round(train_peak / 2**30, 2),
                   seamless_train_s=round(secs, 1))

    # ... then serves 4 prompts on the trained weights (launch.serve.main,
    # timed on its second call).
    params = out["state"].params
    del out
    free_card(torch)
    require(all(bool(torch.isfinite(x).all()) for x in leaves(params)),
            f"{SEAMLESS_ARCH}'s trained weights are finite")
    served, s_peak = serve_twice(serve, ["--arch", SEAMLESS_ARCH] + serve_argv, params=params)
    require(served["tokens"].shape == (SERVE_PROMPTS, SERVE_GEN), "seamless's served tokens")
    nbytes, b_ms = bound(scfg, s_params, SERVE_PROMPTS, SERVE_LEN + SERVE_GEN)
    pre_ms, dec_ms = served["prefill_ms"], served["decode_ms_per_step"]
    log(f"[17] (d) serve {SEAMLESS_ARCH} on the trained weights (launch.serve, {pdt}, "
        f"second call): prefill {SERVE_PROMPTS} x {SERVE_LEN} tokens + "
        f"{scfg.frontend_tokens} frames (the encoder) {pre_ms:.1f} ms, decode {dec_ms:.2f} "
        f"ms a step; bytes bound {nbytes / 1e9:.2f} GB = {b_ms:.2f} ms; peak memory "
        f"{s_peak / 2**30:.2f} GiB ({card})")
    summary.update(seamless_prefill_ms=round(pre_ms, 2),
                   seamless_serve_peak_gib=round(s_peak / 2**30, 2),
                   seamless_decode_ms_per_step=round(dec_ms, 3),
                   seamless_decode_bound_ms=round(b_ms, 3),
                   s=round(time.perf_counter() - t_all, 1))
    del params, served
    free_card(torch)
    log(f"[17] summary: {json.dumps(summary)}")
    return summary


COUNT_SEQ = 32


def dict_leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order (a leaf may be a
    tuple, as a parameter's placements are)."""
    if not isinstance(tree, dict):
        return [tree]
    return [x for k in sorted(tree) for x in dict_leaves(tree[k])]


def phase18_plan(seed: int, card: str, records: dict, smoke: bool = False):
    """Phase 18: the sharding rules, the meshes and the dry run's plan,
    held against what the card measures. Checks: (1) ``make_host_mesh()``
    builds a (1, 1) NCCL ``DeviceMesh`` on the card; (2) every
    xlstm-350m parameter, placed by ``param_placements`` with
    ``distribute_tensor``, comes back bit-equal through ``to_local()``;
    (3) ``memory_model``'s ``params`` on that mesh at phase 15's training
    shape equals the bytes of the bf16 parameters phase 15 trained; (4)
    ``op_cost`` counts one xlstm-350m training step (the dry run's
    ``build_cell`` at batch 8 x ``COUNT_SEQ``) on ``meta`` and around the
    same step on the card, and the two counts are equal op by op
    (FLOPs, bytes and calls of every op and output shape); (5) every (arch x
    ``shapes_for`` x single/multi) cell of the plan computes at the
    card's memory, one line each with ``fits_hbm`` and GB a device. Reported beside them: the plan's
    total against phases 15-17's measured peaks, and the model FLOPs of
    phases 15 and 17's train steps as achieved TFLOP/s. ``records``
    holds phases 15, 16 and 17's summaries; without them (the phase run
    alone) (3) compares with the parameters of (2) and nothing is
    reported."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import ARCH_IDS, get_config, shapes_for
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import (AbstractMesh, make_host_mesh,
                                         make_production_mesh)
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.models import lm
    from repro_torch.models.spec import init_params
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import leaves, leaves_with_path, tree_map

    t_all = time.perf_counter()
    reduce = (lambda c: c.smoke()) if smoke else (lambda c: c)
    hbm = float(torch.cuda.get_device_properties(0).total_memory)
    summary = {"card": card, "hbm_bytes": hbm}
    try:
        # (1) the host mesh
        mesh = make_host_mesh(DEV)
        require(tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
                and mesh.device_type == torch.device(DEV).type
                and dist.get_backend() == ("nccl" if DEV == "cuda" else "gloo"),
                f"host mesh {mesh}, backend {dist.get_backend()}")
        log(f"[18] (1) make_host_mesh(): {mesh}, backend {dist.get_backend()}")

        # (2) placements round-trip
        cfg = reduce(get_config(LM_ARCH))
        spec = lm.model_spec(cfg)
        params = init_params(spec, seed, torch.bfloat16, DEV)
        places = shd.param_placements(spec, mesh)
        kinds: dict = {}
        for (path, x), pl in zip(leaves_with_path(params), dict_leaves(places)):
            back = distribute_tensor(x, mesh, list(pl)).to_local()
            require(back.dtype == x.dtype and bits_equal(torch, back, x),
                    f"placement {pl} of {path}")
            kinds[str(pl)] = kinds.get(str(pl), 0) + 1
        log(f"[18] (2) {len(leaves(params))} {LM_ARCH} parameters placed by "
            f"param_placements and back through to_local(), bit-equal; placements "
            f"{json.dumps(kinds)}")

        # (3) the params term
        train15 = ShapeConfig("phase15", "train", 128, 8)
        mm = dr.memory_model(cfg, train15, mesh, hbm)
        allocated = sum(x.numel() * x.element_size() for x in leaves(params))
        trained = records[15]["param_bytes"] if records else allocated
        require(mm["params"] == allocated == trained,
                f"memory_model params {mm['params']} vs allocated {allocated} "
                f"vs phase 15's {trained}")
        log(f"[18] (3) memory_model(...)['params'] on the host mesh at batch 8 x 128 = "
            f"{mm['params']:.0f} bytes == the bf16 parameters "
            + ("phase 15 trained" if records else "placed in (2)"))
        del params

        # (4) meta counts what the card runs
        cell = ShapeConfig("phase18", "train", COUNT_SEQ, 8)
        fn, meta_args = dr.build_cell(cfg, cell, mesh, hbm)
        t0 = time.perf_counter()
        with OpCounter() as meta_count:
            fn(*meta_args)
        meta_s = time.perf_counter() - t0
        real = tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype, device=DEV), meta_args)
        real = (real[0]._replace(params=init_params(spec, seed, torch.bfloat16, DEV)),
                real[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with OpCounter() as card_count:
            fn(*real)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        del real
        free_card(torch)
        on_meta, on_card = meta_count.result(), card_count.result()
        # The ops (name, output shape) whose FLOPs, bytes or calls differ.
        differ = {f"{op} {shape}": {"meta": meta_count.detail.get((op, shape)),
                                      DEV: card_count.detail.get((op, shape))}
                    for op, shape in set(meta_count.detail) | set(card_count.detail)
                    if meta_count.detail.get((op, shape)) != card_count.detail.get((op, shape))}
        require(on_meta == on_card and on_meta["flops"] > 0 and not differ,
                f"op_cost on meta {on_meta} vs on the card {on_card}; [op, output shape] "
                f"-> [FLOPs, bytes, calls] where the two differ: {json.dumps(differ)}")
        roof = dr.roofline(on_meta, 1, cfg, cell)
        log(f"[18] (4) op_cost of one {LM_ARCH} train step at batch 8 x {COUNT_SEQ}: "
            f"{on_meta['flops']:.12g} FLOPs, {on_meta['ops']} ops and "
            f"{on_meta['traffic']:.12g} bytes of traffic on meta ({meta_s:.1f} s), equal "
            f"on the card ({card_s:.1f} s), op by op; model FLOPs "
            f"{dr.model_flops(cfg, cell):.6g}; roofline of the count: dominant "
            f"{roof['dominant']} (compute {roof['t_compute_s'] * 1e3:.4g} ms, memory "
            f"{roof['t_memory_s'] * 1e3:.4g} ms)")
        summary.update(count_flops=on_meta["flops"], count_ops=on_meta["ops"],
                       count_traffic=on_meta["traffic"], count_dominant=roof["dominant"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    # (5) the sweep
    t0 = time.perf_counter()
    n_cells = 0
    for multi in (False, True):
        pmesh = make_production_mesh(multi_pod=multi)
        for arch in ARCH_IDS:
            acfg = get_config(arch)
            for shape in shapes_for(acfg):
                sp = acfg.prefer_sp and shape.kind == "train"
                dr._set_constraints(pmesh, shape, sp, acfg)
                m = dr.memory_model(acfg, shape, pmesh, hbm)
                plan = dr.train_plan(acfg, shape, pmesh, sp, hbm) if shape.kind == "train" else {}
                dr._set_constraints(pmesh, shape, False)
                require(m["total"] > 0 and dr.model_flops(acfg, shape) > 0,
                        f"{arch} {shape.name} {pmesh}: {m}")
                n_cells += 1
                log(f"[18] (5) {arch} x {shape.name} x {'multi' if multi else 'single'} "
                    f"({pmesh.size} H100s): fits_hbm {m['fits_hbm']}, "
                    f"{m['total'] / 1e9:.3f} GB/device of {hbm / 1e9:.1f}"
                    + (f", accum {plan['accum']}, {plan['grad_dtype']} grads" if plan else ""))
    summary["sweep_cells"] = n_cells
    log(f"[18] (5) {n_cells} cells planned in {time.perf_counter() - t0:.1f} s")
    if not records:
        summary["s"] = round(time.perf_counter() - t_all, 1)
        log(f"[18] summary: {json.dumps(summary)}")
        return summary

    # Reported: the plan against the measured peaks ...
    p15, p16, p17 = records[15], records[16], records[17]
    gib = 2**30
    rows = [  # (what, config, shape, measured peak GiB, phase)
        ("train", cfg, train15, p15["train_peak_gib"], 15),
        ("train", reduce(get_config(MOE_ARCH).scaled(n_layers=4)), train15,
         p16["moe_train_peak_gib"], 16),
        ("train", reduce(get_config(SEAMLESS_ARCH)),
         ShapeConfig("p17", "train", TRAIN_SEQ, TRAIN_BATCH), p17["seamless_train_peak_gib"], 17),
        ("serve", cfg, ShapeConfig("p15", "prefill", 32 + 16, 4), p15["serve_peak_gib"], 15),
        ("serve", reduce(get_config(MOE_ARCH)), ShapeConfig("p16", "prefill", 48, 4),
         p16["moe_serve_peak_gib"], 16),
        ("serve", reduce(get_config(GEMMA_ARCH)), ShapeConfig("p16", "prefill", 8192 + 16, 1),
         p16["gemma_serve_peak_gib"], 16),
        ("serve", reduce(get_config(JAMBA_ARCH).scaled(n_layers=8, n_experts=JAMBA_EXPERTS)),
         ShapeConfig("p17", "prefill", SERVE_LEN + SERVE_GEN, SERVE_PROMPTS),
         p17["jamba_serve_peak_gib"], 17),
        ("serve", reduce(get_config(VISION_ARCH)),
         ShapeConfig("p17", "prefill", SERVE_LEN + SERVE_GEN, SERVE_PROMPTS),
         p17["vision_serve_peak_gib"], 17),
        ("serve", reduce(get_config(SEAMLESS_ARCH)),
         ShapeConfig("p17", "prefill", SERVE_LEN + SERVE_GEN, SERVE_PROMPTS),
         p17["seamless_serve_peak_gib"], 17),
    ]
    one = AbstractMesh(("data", "model"), (1, 1))
    compared = []
    for what, c, shape, peak, phase in rows:
        m = dr.memory_model(c, shape, one, hbm)
        terms = {k: round(v / gib, 3) for k, v in m.items()
                 if isinstance(v, float) and k not in ("total", "hbm_bytes")}
        row = {"arch": c.name, "what": what, "phase": phase,
               "batch": shape.global_batch, "seq": shape.seq_len,
               "plan_gib": round(m["total"] / gib, 3), "peak_gib": peak,
               "peak_over_plan": round(peak * gib / m["total"], 3)}
        named = ""
        if what == "train":
            # The port's launcher against the plan: f32 moments (the plan
            # counts bf16), gradients in the parameters' bf16 (the plan
            # counts f32), and the functional AdamW's new parameters and
            # moments beside the old ones during the update.
            p = m["params"]
            gaps = {"f32_moments": 2 * p, "bf16_grads": -p, "second_state": p + 4 * p}
            port = m["total"] + sum(gaps.values())
            row.update({k: round(v / gib, 3) for k, v in gaps.items()},
                       port_state_gib=round(port / gib, 3),
                       unexplained_gib=round(peak - port / gib, 3))
            named = (f"; the port's launcher adds {json.dumps({k: round(v / gib, 2) for k, v in gaps.items()})}"
                     f" GiB = {port / gib:.2f} GiB, {peak - port / gib:+.2f} GiB left")
        compared.append(row)
        log(f"[18] plan vs measured: {c.name} {what} (phase {phase}) at "
            f"{shape.global_batch} x {shape.seq_len}: plan {m['total'] / gib:.2f} GiB "
            f"{json.dumps(terms)}, measured peak {peak:.2f} GiB{named} ({card})")
    summary["plan_vs_peak"] = compared

    # ... and the model FLOPs of the measured train steps.
    achieved = {}
    for name, c, shape, ms in (
            (LM_ARCH, cfg, train15, p15["train_step_ms"]),
            (SEAMLESS_ARCH, reduce(get_config(SEAMLESS_ARCH)),
             ShapeConfig("p17", "train", TRAIN_SEQ, TRAIN_BATCH), p17["seamless_train_step_ms"])):
        mf = dr.model_flops(c, shape)
        tflops = mf / (ms / 1e3) / 1e12
        achieved[name] = {"model_flops": mf, "step_ms": ms, "tflops": round(tflops, 3),
                          "share_of_989": round(tflops * 1e12 / dr.PEAK_FLOPS, 5)}
        log(f"[18] model FLOPs of a {name} train step at {shape.global_batch} x "
            f"{shape.seq_len}: {mf:.6g} in {ms} ms = {tflops:.3f} TFLOP/s, "
            f"{tflops * 1e12 / dr.PEAK_FLOPS:.4f} of 989 TFLOP/s ({card})")
    summary.update(achieved=achieved, s=round(time.perf_counter() - t_all, 1))
    log(f"[18] summary: {json.dumps(summary)}")
    return summary


# Where an in-situ step's host syncs come from, by source file.
SYNC_STAGES = (("build_bvh", ("core/bvh.py", "core/morton.py")),
               ("union rounds", ("core/dbscan.py", "core/union_find.py",
                                 "core/query.py")),
               ("catalog", ("halos/",)))


def sync_stage(where: str) -> str:
    for stage, files in SYNC_STAGES:
        if any(f in where for f in files):
            return stage
    return "other"


def held_to_card_warnings(name: str, fn, args) -> dict:
    """One call of ``fn(*args)`` under the op trace with the card's sync
    warnings on: the syncs the dispatch rule counts must equal the
    warnings, op by op and line by line."""
    from repro_torch.staticcheck import sync_warnings

    rep = sync_warnings(fn, *args)
    require(rep["counted"] == rep["warned"] and not rep["differ"],
            f"{name}: the rule counted {rep['counted']} syncs, the card warned "
            f"{rep['warned']}; differing ops {rep['differ']}")
    return rep


def phase19_static(cloud, card: str):
    """Phase 19: the static checks on the card. (a) every registered op
    audit of ``repro_torch.staticcheck`` at its full size must return no
    finding; (b) each audited call once more under the op trace with
    ``torch.cuda.set_sync_debug_mode("warn")``: the syncs the dispatch
    rule counts must equal the card's sync warnings, op by op, and stay
    within the call's allowance (printed beside them), and each
    call allowed no sync must run clean under
    ``set_sync_debug_mode("error")`` (``assert_no_host_transfers``,
    ``guard="all"``); (c) one in-situ step of phase 4's cloud (``cloud``:
    its host positions, velocities and sphere count; the same eps and
    ``InsituConfig``) under the trace:
    its host syncs by op and source line and by stage (``build_bvh``, the
    union rounds, the catalog), held to the card's warnings, its largest
    intermediate against n^2 and its seconds beside an untraced step's;
    (d) the three example twins' ``main`` on the card (galaxy finding,
    distributed halo finding on 8 shards, the quickstart with its grid
    section), and galaxy finding at full size on phase 4's cloud and eps
    (FOF at 1.5 eps, then ``min_pts = 10`` in the largest halo)."""
    import torch
    from repro_torch.analysis import insitu
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.staticcheck import (REGISTERED_AUDITS,
                                         assert_no_host_transfers,
                                         run_registered_audits)

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    findings, names = run_registered_audits(fast=False, device=DEV)
    require(not findings, "registered op audits on the card: "
            + "; ".join(str(f) for f in findings))
    log(f"[19] (a) {len(names)} registered op audits at full size, no "
        f"finding ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    dev = torch.device(DEV)
    for audit in REGISTERED_AUDITS:       # (a) built and loaded the kernels
        for c in audit.calls(False, dev):
            rep = held_to_card_warnings(c.name, c.fn, c.args)
            allowed = (c.allowed_syncs(rep["trace"].result)
                       if callable(c.allowed_syncs) else c.allowed_syncs)
            require(allowed is None or rep["counted"] <= allowed,
                    f"{c.name}: {rep['counted']} syncs over its allowance "
                    f"of {allowed}")
            clean = ""
            if c.allowed_syncs == 0:
                assert_no_host_transfers(c.fn, *c.args, guard="all",
                                         warmup=False)
                clean = ", clean under set_sync_debug_mode('error')"
            log(f"[19] (b) {audit.name} / {c.name}: {rep['counted']} syncs "
                f"counted = {rep['warned']} card warnings, allowance "
                f"{allowed}{clean}")
    log(f"[19] (b) done ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    pos_t = torch.from_numpy(cloud[0]).to(DEV)
    vel_t = torch.from_numpy(cloud[1]).to(DEV)
    n = pos_t.shape[0]
    eps = hacc_benchmark_epsilon(1.0, n)
    cfg = insitu.InsituConfig(mode="simulation", cadence=1, min_pts=2,
                              halo_min_count=10, halo_capacity=1 << 20)
    analyzer = insitu.InsituAnalyzer(cfg, device=DEV)
    step = {"positions": pos_t, "velocities": vel_t}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    analyzer.maybe_run(step, 0)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    rep = held_to_card_warnings("in-situ step",
                                lambda: analyzer.maybe_run(step, 1), ())
    torch.cuda.synchronize()
    traced_s = time.perf_counter() - t1
    trace = rep["trace"]
    by_line = trace.syncs_by_line()
    by_stage: dict = {}
    for (op, where), k in by_line.items():
        by_stage[sync_stage(where)] = by_stage.get(sync_stage(where), 0) + k
    log(f"[19] (c) in-situ step at {n} particles: {rep['counted']} host syncs "
        f"= {rep['warned']} card warnings, by op {dict(trace.syncs())}, by "
        f"stage {by_stage}; {trace.n_ops} ops, largest intermediate "
        f"{trace.max_elems} elements ({trace.max_op}) against n^2 = {n * n}; "
        f"{traced_s:.3f} s traced, {plain_s:.3f} s untraced ({card})")
    for (op, where), k in sorted(by_line.items(), key=lambda kv: kv[0][1]):
        log(f"[19] (c)   {k:5d} {op} at {where}")
    require(trace.max_elems < n * n, "the in-situ step staged an n^2 buffer")
    log(f"[19] (c) done ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    galaxy = importlib.import_module("galaxy_finding_torch")
    for name in ("galaxy_finding_torch", "distributed_halo_finding_torch",
                 "quickstart_torch"):
        t1 = time.perf_counter()
        argv = ["--device", DEV]
        if name == "quickstart_torch":
            argv += ["--trace", str(Path(__file__).resolve().parent / "build"
                                    / "trace_quickstart.json")]
        importlib.import_module(name).main(argv)
        log(f"[19] (d) examples/{name}.py main() on the card "
            f"({time.perf_counter() - t1:.1f} s)")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = galaxy.find_galaxies(pos_t, eps, device=DEV)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    hl = res.halos.labels
    n_halos = int(torch.unique(hl[hl >= 0]).numel())
    gl = res.galaxies.labels
    n_gal = int(torch.unique(gl[gl >= 0]).numel())
    require(n_gal >= 1, "galaxy finding at full size found no galaxy")
    log(f"[19] (d) galaxy finding at {n} particles: {n_halos} FOF halos at "
        f"1.5 eps, the largest {res.members.numel()} particles, {n_gal} "
        f"galaxies (min_pts 10), {int((gl < 0).sum())} stellar noise; "
        f"{secs:.3f} s ({card})")
    log(f"[19] (d) done ({time.perf_counter() - t0:.1f} s); phase 19 "
        f"{time.perf_counter() - t_all:.1f} s")


def phase20_absint(cloud, card: str):
    """Phase 20: the scale-safety interpreter on the card. (a) every
    registered absint audit and seeded fixture on the card and on the
    CPU: the same findings on both (rule, op and, for W1, the interval;
    ops, values and kernel outputs printed for both), the registered
    audits clean with no unknown op, each fixture firing exactly its rule
    (value rules at one op); (b) ``fdbscan`` on phase 4's cloud
    (``cloud``: its host positions) at its eps, analysed at N = 1e9
    (``bvh_scale(n, 10**9)``: ``scale_for``'s markers and n - 2): clean,
    no unknown op, its ops, values, seconds and peak memory printed beside
    the untraced call's; (c) the CLI's ``main`` with ``--absint`` on the
    card returns 0 with every audit clean in its report."""
    import torch
    from repro_torch.core.dbscan import fdbscan
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.staticcheck import __main__ as cli
    from repro_torch.staticcheck.absint import analyze
    from repro_torch.staticcheck.absint_registry import (
        REGISTERED_ABSINT_AUDITS, SEEDED_FIXTURES, bvh_scale)
    from repro_torch.staticcheck.lattice import Ival

    def counts(r):
        return (f"{r.ops_visited} ops, {r.values_analyzed} values, "
                f"{r.unknown_ops} unknown, {r.kernel_outputs} kernel outputs")

    t_all = time.perf_counter()
    dev, cpu = torch.device(DEV), torch.device("cpu")
    for audit in REGISTERED_ABSINT_AUDITS + SEEDED_FIXTURES:
        t0 = time.perf_counter()
        on_card = audit.run(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        on_cpu = audit.run(cpu)
        t2 = time.perf_counter()
        rules = sorted({f.rule for f in on_card.findings})
        require(on_card.keys == on_cpu.keys,
                f"{audit.name}: the card's findings {on_card.keys} differ from "
                f"the CPU's {on_cpu.keys}")
        require(rules == sorted(audit.expect_rules),
                f"{audit.name}: fired {rules}, expected "
                f"{sorted(audit.expect_rules)}: "
                + "; ".join(str(f) for f in on_card.findings))
        if not audit.expect_rules:
            require(on_card.unknown_ops == 0,
                    f"{audit.name}: unknown ops {on_card.unknown}")
        elif "W3-routes" not in audit.expect_rules:
            require(len(on_card.findings) == 1,
                    f"{audit.name}: {len(on_card.findings)} findings")
        log(f"[20] (a) {audit.name}: {on_card.keys or 'clean'}; card "
            f"{counts(on_card)} ({t1 - t0:.2f} s), CPU the same findings, "
            f"{counts(on_cpu)} ({t2 - t1:.2f} s) ({card})")
    log(f"[20] (a) done ({time.perf_counter() - t_all:.1f} s)")

    t0 = time.perf_counter()
    require(float(cloud[0].min()) >= 0.0 and float(cloud[0].max()) <= 1.0,
            "phase 4's cloud leaves the unit box")
    pos_t = torch.from_numpy(cloud[0]).to(DEV)
    n = pos_t.shape[0]
    eps = hacc_benchmark_epsilon(1.0, n)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fdbscan(pos_t, eps, 2, device=DEV)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    rep = analyze(lambda p: fdbscan(p, eps, 2, device=DEV), (pos_t,),
                  name=f"fdbscan@{n}", scale=bvh_scale(n, 10**9),
                  input_ivals=[Ival(0.0, 1.0)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    require(rep.findings == [] and rep.unknown_ops == 0,
            f"fdbscan at {n} points, N = 1e9: "
            + "; ".join(str(f) for f in rep.findings)
            + f" unknown {rep.unknown}")
    log(f"[20] (b) fdbscan at {n} points (phase 4's cloud, eps {eps:.4g}) "
        f"analysed at N = 1e9: clean; {counts(rep)}; {secs:.3f} s traced and "
        f"analysed against {plain_s:.3f} s untraced, peak {peak / 2**30:.3f} "
        f"GiB above the {base / 2**30:.3f} GiB held ({card})")
    del pos_t
    log(f"[20] (b) done ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    out = Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    rc = cli.main([str(SRC / "repro_torch"), "--absint", "--device", DEV,
                   "--json", str(out / "staticcheck_report.json"),
                   "--absint-json", str(out / "absint_report.json")])
    report = json.loads((out / "absint_report.json").read_text())
    require(rc == 0 and report["ok"]
            and len(report["entrypoints"]) == len(REGISTERED_ABSINT_AUDITS),
            f"python -m repro_torch.staticcheck --absint on the card: exit "
            f"{rc}, report {report}")
    log(f"[20] (c) python -m repro_torch.staticcheck --absint --device {DEV}: "
        f"exit 0, {len(report['entrypoints'])} audits clean, "
        f"{sum(e['values_analyzed'] for e in report['entrypoints'])} values "
        f"({time.perf_counter() - t0:.1f} s; {card})")
    log(f"[20] done: phase 20 {time.perf_counter() - t_all:.1f} s ({card})")


HACC_KERNELS = ("wavefront_count", "wavefront_min_label", "segment_sum_sorted",
                "segment_max_sorted")


def reset_counts(kernels: dict) -> None:
    """Every launch counter of ``kernels`` to 0, per instance too."""
    for fn in kernels.values():
        fn.launches = 0
        getattr(fn, "instances", {}).clear()


def instance_counts(kernels: dict) -> dict:
    """Launches since the last reset, by wrapper and, for the traversal,
    by "<predicate>/<leaf kind>"."""
    out = {}
    for k, fn in kernels.items():
        kinds = getattr(fn, "instances", None)
        if kinds:
            out.update({f"{k} {kind}": v for kind, v in kinds.items() if v})
        elif fn.launches:
            out[k] = fn.launches
    return out


def kernel_wrappers(names=None) -> dict:
    from repro_torch.kernels import nearest as kn
    from repro_torch.kernels import pairwise as kp
    from repro_torch.kernels import segment as ks
    from repro_torch.kernels import wavefront as kw
    every = {"wavefront_count": kw.wavefront_count,
             "wavefront_min_label": kw.wavefront_min_label,
             "wavefront_fill": kw.wavefront_fill,
             "wavefront_fixed": kw.wavefront_fixed,
             "wavefront_potential": kw.wavefront_potential,
             "wavefront_edge": kw.wavefront_edge,
             "wavefront_histogram": kw.wavefront_histogram,
             "histogram_edges": kw.histogram_edges,
             "wavefront_dense_count": kw.wavefront_dense_count,
             "wavefront_dense_min_label": kw.wavefront_dense_min_label,
             "wavefront_sphere_count": kw.wavefront_sphere_count,
             "segment_sum_sorted": ks.segment_sum_sorted,
             "segment_max_sorted": ks.segment_max_sorted,
             "stencil_count": kp.stencil_count,
             "stencil_min_label": kp.stencil_min_label,
             "pairwise_count": kp.pairwise_count,
             "pairwise_min_label": kp.pairwise_min_label,
             "nearest_knn": kn.nearest_knn,
             "nearest_other_component": kn.nearest_other_component,
             "nearest_ray": kn.nearest_ray}
    return every if names is None else {k: every[k] for k in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-log2", type=int, default=24,
                    help="log2 of the main path's particle count")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: the port is not at {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.analysis.insitu import InsituConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    card, tiles, wave, stencil, seg, near = phase1_build()
    cfg = InsituConfig(mode="simulation", cadence=1, min_pts=2,
                       halo_min_count=10, halo_capacity=1 << 20)
    t0 = time.perf_counter()
    small = phase2_kernels(args.seed)
    phase2_pairwise_kernels(args.seed)
    c7_kernel_checks(args.seed)
    log(f"[2] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase3_whole_path(args.seed, cfg)
    phase3_grid_and_pairwise(args.seed)
    phase3_pair_and_densebox(args.seed)
    phase3_sharded(args.seed)
    phase3_nearest(args.seed)
    phase3_lm(args.seed)
    phase3_attention_archs(args.seed)
    log(f"[3] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches_by_step, records, cloud = phase4_main_path(args.seed,
                                                        1 << args.n_log2, cfg)
    log(f"[4] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    nl_rows = phase5_neighbor_lists(args.seed, 1 << args.n_log2, card, wave)
    log(f"[5] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase6_graph_dbscan(args.seed, 1 << args.n_log2)
    log(f"[6] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    grid_rows = phase7_grid(args.seed, 1 << args.n_log2, card, stencil)
    log(f"[7] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pair_rows = phase8_all_pairs(args.seed, 1 << (args.n_log2 - 8), card, tiles)
    log(f"[8] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    halo_rows = phase10_halo_products(args.seed, 1 << args.n_log2, cfg, card,
                                      wave, small)
    log(f"[10] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pred_rows = phase11_predicates(args.seed, 1 << args.n_log2, card, wave)
    log(f"[11] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dbscan_rows = phase12_pair_and_densebox(args.seed, 1 << args.n_log2, card, wave)
    log(f"[12] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded_rows = phase13_sharded(args.seed, 1 << args.n_log2, cfg, card, wave)
    log(f"[13] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    nearest_rows = phase14_nearest(args.seed, 1 << args.n_log2, card, near)
    log(f"[14] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_records = {15: phase15_lm(args.seed, card)}
    log(f"[15] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_records[16] = phase16_attention_moe(args.seed, card)
    log(f"[16] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_records[17] = phase17_hybrid(args.seed, card)
    log(f"[17] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase18_plan(args.seed, card, lm_records)
    log(f"[18] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase19_static(cloud, card)
    log(f"[19] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase20_absint(cloud, card)
    del cloud
    log(f"[20] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase9_kernel_line(launches_by_step, records,
                       nl_rows + grid_rows + pair_rows + halo_rows + pred_rows
                       + dbscan_rows + sharded_rows + nearest_rows,
                       card, wave,
                       seg)
    log(f"[9] done in {time.perf_counter() - t0:.1f} s; "
        f"total {time.perf_counter() - t_all:.1f} s")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
