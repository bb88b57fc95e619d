// Stackless rope traversal of the LBVH with a fused epilogue, for sm_90a.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/wavefront.py:
//   * `wavefront_traverse` (:97) on the two passes of the FDBSCAN main path,
//     the core test (`query_count(within, stop_at=min_pts)`, epilogue COUNT)
//     and the min-core-label union and border passes (`min_core_label_on`,
//     epilogue MIN_LABEL), on the fixed-buffer protocol `query_fixed`
//     (epilogue FIXED), on the halo products' most-bound potentials
//     (`halo_potentials`, epilogue POTENTIAL) and SO counts
//     (`sphere_counts`, `sphere_count_kernel`: a warp per query, contained
//     subtrees counted from their span; below), on the sharded DBSCAN's
//     cross-shard rounds over int64 global labels (`dbscan_local_shard`,
//     epilogue MIN_LABEL64), on the pair traversal of
//     `fdbscan_pair`'s capture (epilogue EDGE) and `pair_count_histogram`
//     (epilogue HISTOGRAM), on DenseBox's tree of dense cells and loose
//     points (`fdbscan_densebox`, DENSE_COUNT and DENSE_MIN_LABEL in
//     `dense_kernel`, over scan records from `dense_records_kernel`;
//     below), with its start node per query (`start_nodes`, every instance
//     of `wavefront_kernel`) and its per-lane counters (`with_stats`, the
//     STATS instance of COUNT);
//   * `wavefront_fill_round` (:245), the fill pass of the count-then-fill
//     CSR protocol `query_csr_device` (epilogue FILL).
//
// The Pallas kernel builds its node and leaf tests in the kernel from
// `_pred_fns` (src/repro/core/query.py:566-624) for any predicate on any
// tree. Here the predicate and the leaf kind are template parameters:
//   * SPHERE (`Within`): a centre and r^2 per query; hit where the
//     point-box distance^2 is <= r^2;
//   * BOX (`IntersectsBox`): a box per query; hit where `aabb_aabb_dist2`
//     (the reference's own formula: gaps, squares, sum) is <= 0;
//   * RAY (the all-hits `Ray`): an origin and inv = `_safe_inv(direction)`
//     per query, computed once by the wrapper (an IEEE division), so that
//     no instance divides; hit by the slab test `_ray_box` (:834-841);
//   * POINT leaves (`build_bvh`, a leaf's box is its point) or BOX leaves
//     (`build_bvh_objects`, a leaf's lo and hi).
// COUNT (and its STATS instance), FILL and FIXED take every combination;
// MIN_LABEL, MIN_LABEL64, POTENTIAL, EDGE and HISTOGRAM take SPHERE on
// POINT leaves only; `dense_kernel` takes SPHERE on BOX leaves only.
//
// The TPU kernels advance a block of 128 queries in lockstep, one rope hop
// per iteration, because a TPU core runs one wide instruction stream. On
// Hopper each query is its own thread, and a warp of 32 threads walks 32
// neighbouring queries: threads take queries in `order` (the tree's
// `leaf_perm` for a self-join, i.e. Morton order), so lanes of a warp follow
// nearly the same path and their node reads coalesce in L1/L2. Results go to
// each query's own row, so outputs stay positionally identical to the
// reference.
//
// FILL is not the TPU's chunk round carried over: the rounds exist there
// only because XLA needs fixed shapes (src/repro/core/query.py:1041-1049).
// Here one traversal writes query qi's k-th hit straight to
// indices[offsets[qi] + k], drops it at or past `capacity`, and stops once
// the next position would be past it. One thread per query keeps each row
// in traversal order, the order the reference's rounds produce. Positions
// are int64 whatever the offsets' type: a total past 2^31 hits must not
// wrap. FIXED writes hit k to slot min(k, capacity - 1) of row qi of a
// (q, capacity) buffer, so surplus hits overwrite the last slot, and
// returns the true count.
//
// Node records. The kernel reads the tree as ArborX keeps it, one record
// per node with the box and the links together, packed from the `Bvh`
// fields by `pack_kernel` (a prologue the wrappers launch before a
// traversal, or once for all of `fdbscan`'s traversals of one tree):
//   * internal node i (0 .. n-2): 32 bytes, two float4,
//     {lo.x, lo.y, lo.z, bits(left_child)} {hi.x, hi.y, hi.z, bits(rope)};
//   * leaf k (node n-1+k) of a point tree: 16 bytes, one float4,
//     {x, y, z, bits(rope)}; a leaf's box is its point (`build_bvh`:
//     node_lo == node_hi at leaves);
//   * leaf k of a box-leaf tree: 32 bytes, {lo.xyz, bits(rope)}
//     {hi.xyz, bits(rope)}. The wrapper takes the layout from the tree
//     (`Bvh.box_leaves`), never packs a box-leaf tree as points, and
//     launches the instance that reads that layout.
// Indices travel as raw int32 bits in the w lanes: SENTINEL = -1 is a NaN
// pattern, and only bit copies (never a float operation) touch it.
// A hop is one dependent fetch: an internal hop issues both 16-byte loads
// of its record together, a leaf hop one (`LDG.E.128`, non-coherent path),
// and the next node comes from registers already loaded: left_child on a
// hit, rope on a miss (at a leaf both w lanes are the rope). A leaf hop
// also reads one int32 key in leaf order, issued with the record rather
// than after the test, so a hit costs no second round trip: MIN_LABEL's
// key is the object's label where it is core and `sentinel` elsewhere
// (built by the wrapper with one gather per launch; the carry starts at
// `sentinel` and only decreases, so a `sentinel` key changes nothing),
// FILL's and FIXED's the object index (`leaf_perm`); COUNT reads none.
// MIN_LABEL64 is MIN_LABEL over int64 labels (the sharded path's global
// ids, shard * n_local + slot, past 2^31 at scale; the Pallas kernel
// carries whatever label type its caller gives it): its key is one 8-byte
// load per leaf hop, fetched with the record, its carry a 64-bit integer;
// the node records and the hop are MIN_LABEL's.
//
// What bounds it (tools/wavefront_variants.py on an H100 80GB HBM3 at
// 700 W; COUNT and MIN_LABEL on the 2^24-point in-situ self-join): not
// the bytes or the float operations (MIN_LABEL takes 15x its bound), and
// at full occupancy not the latency of the dependent fetch alone. With
// 128-thread blocks and the L1/shared split fixed, capping the warps an
// SM holds leaves the time almost unchanged from 64 warps to 32 and
// doubles it with each halving below: under 32 warps latency bounds it,
// above, the memory hierarchy's throughput for the node records. Blocks
// of 512 threads are 8% (COUNT) and 13% (MIN_LABEL) faster than blocks of
// 128, and 1024 gains no more; only the early-exit COUNT of `fdbscan`
// (stop_at = 2, 3 ms) lost about 6%. The likely reason, not measured (no
// hardware counter was read), is L1 locality: threads take queries in
// Morton order, so the warps of one block walk neighbouring subtrees on
// one SM, while 16 small blocks on an SM come from far apart. Hence 512
// threads a block and `__launch_bounds__(512, 3)`: at least 3 blocks, 48
// of an SM's 64 warps, resident, each thread within 42 registers (ptxas
// uses 22-26, so 4 blocks fit; `chip_smoke.py` phase 1 checks that no
// instance spills); RAY instances, at least 2 blocks (64 registers). The work is data dependent: the hops each query
// needs. FILL and FIXED add one 4-byte store per hit; in a self-join a
// warp's 32 queries own 32 rows far apart in the output, so each store
// instruction touches up to 32 sectors (rows in thread order save 7%).
//
// The box and ray instances (`chip_smoke.py` phase 11, H100 80GB HBM3 at
// 700 W): IntersectsBox eps-cubes of 2^24 particles walk at 304 Ghops/s,
// the self-join's regime; 2^20 rays through the cloud on its tree of
// eps-boxes at 61 Ghops/s, 46x their operations bound. A warp's rays,
// sorted by origin, head in different directions, so their walks diverge
// and their record reads stop sharing lines (inferred, not measured).
//
// POTENTIAL adds -1/sqrt(d2 + soft2) per hit to a float carry, d2 the hit
// test's own squared distance, in rope order: the reference's callback
// `acc - rsqrt(r2 + soft2)` (src/repro/halos/centers.py:64-65). The
// reciprocal square root is __frcp_rn(__fsqrt_rn(x)), a correctly rounded
// square root and a correctly rounded reciprocal, because the plain version
// can compute the same bits with torch ops (`inv_sqrt_plain`: each step in
// float64, rounded to float32), where rsqrtf is an approximation that no
// torch op is bound to match. On an H100 80GB HBM3 the sequence equals
// `inv_sqrt_plain` on 2^24 random positive floats, normal and subnormal,
// and torch.rsqrt differs from it on 33% of them (`chip_smoke.py`
// phase 2). XLA's rsqrt on the CPU differs from it by up to 2 ulp, so the
// port agrees with the reference within a tolerance the tests state.
// These IEEE sequences contain FFMAs of their
// own; the epsilon test still has none (its products and sums are _rn
// intrinsics), and `chip_smoke.py` holds the instance's FFMA count to that
// of `rsqrt_probe_kernel`, which holds only the sequence (and whose entry
// `wavefront_rsqrt_probe` lets a test hold its bits against torch's).
//
// The SO masses' counts (`sphere_counts`, a radius per halo up to a few
// percent of the box) have a kernel of their own, `sphere_count_kernel`.
// With one thread per halo (COUNT above) a launch lasted as long as the
// walk of the heaviest halo, which visits every leaf inside its sphere:
// on an H100 80GB HBM3 at 700 W, 6.6e5-1.1e6 dependent hops, 204-447 ms
// a launch, while the other SMs sat idle. Two changes, with counts equal
// to COUNT's bit for bit:
//   * Contained subtrees are counted whole. At an internal node that the
//     sphere hits, the far gap of each axis, max(hi - c, c - lo, 0), is
//     squared and summed as the hit test sums its gaps (`point_box_far2`:
//     the same `gap`, flushed `sq` and ((x + y) + z) order). Where that is
//     <= r2 the node's leaves are all inside: the walk adds its span
//     (range_right - range_left + 1, built with the packed records) and
//     follows the rope. This is exact, not approximate: every leaf p of the
//     subtree lies in the node's box (min/max of its leaves, bit-exact),
//     and each step of the distance (round-to-nearest subtraction and
//     product, the flush, max, the sums) is monotone, so p's own d2 is at
//     most the far d2 and p is a hit under the leaf test's arithmetic. A
//     NaN coordinate makes the far d2 NaN, the compare fails and the walk
//     descends as COUNT's does.
//   * A warp takes one query and walks it as a team. The warp keeps the
//     roots of the subtrees still to walk on a stack in shared memory
//     (kSphereStack nodes a warp). Each step its lanes pop up to 32 of
//     them and test one each; a leaf hit or a contained node is counted by
//     its lane, a node hit but not contained pushes its two children
//     (left_child and right_child). Where the stack has no room left, that
//     lane walks the node's subtree alone instead, from its left child to
//     its rope (the sub-walk's stop node). The lanes' int32 counts are
//     summed with __reduce_add_sync: integer sums, so the order of the
//     additions changes nothing. No atomics, one launch, no host sync.
//     The stack keeps the lanes busy however unevenly the sphere's
//     surface cuts the tree: lanes that each walked a fixed share of the
//     subtrees cut at one level (the first design tried) left one lane
//     with most of a heavy halo's walk in a CPU rehearsal. On an H100
//     80GB HBM3 at 700 W (`chip_smoke.py` phase 10, 2^24 particles) the
//     heaviest halo's 29,443 hops take a chain of 936 dependent hops,
//     within 2% of 29,443 / 32, and a launch 0.9-4.8 ms against COUNT's
//     210-458 ms on the same inputs.
// A hop issues the two 16-byte loads of its record (a leaf hop one) and,
// in a warp step at an internal node, the node's right child with them,
// so no load waits on another; the span is read at a contained node
// only. The counter instance (STATS) reports per query the
// hops of all its lanes summed (each node it tests once, so equal to the
// one-lane walk's), the warp's longest chain of dependent hops (per step,
// the most hops one lane made: 1, or the length of a sub-walk) and the
// far tests (the internal nodes hit).
//
// The pair traversal (`_pair_query`, src/repro/core/query.py:733-765):
// query k is leaf k's point and starts at rope[leaf k], so it meets only
// the leaves after k in rope order, each unordered pair once. EDGE reads
// an int2 per leaf with its record, {object, root where core else -1}; a
// hit whose root is set and differs from the query's own goes to the
// next slot of the query's row, and the walk stops when the row is full,
// as the reference's callback does (src/repro/core/dbscan.py:239-252):
// the walk's order decides which edges a full row holds, so the kernel
// keeps the rope order exactly. A query that is not core walks nothing.
// HISTOGRAM bins each hit by floor(sqrt(max(d2, 1e-30)) / r_max * n_bins)
// (src/repro/core/correlation.py:35-36), `distance_bin` below: a correctly
// rounded square root and division, as `histogram_bins` computes them.
// Up to kPrivateBins bins it runs as HISTOGRAM_PRIVATE, which spends
// neither the IEEE sequence nor an atomic on a pair:
//   * Thresholds. distance_bin is monotone non-decreasing in d2 (max,
//     the rounded sqrt, the division by r_max > 0, the product, the
//     flushes, floor and the clip each are), so bin(d2) = #{k in
//     1..n_bins-1 : d2 >= t_k}, t_k the least float32 whose bin is >= k.
//     A prologue, `histogram_edges_kernel`, finds each t_k by bisection
//     over the bit patterns of the non-negative floats, calling
//     distance_bin itself, so the thresholds are exact by construction;
//     it runs on the card, with no host round trip. The walk holds them
//     in shared memory. A hit's bin is first floor(d2 * rsqrtf(d2) *
//     n_bins / r_max), from the approximate reciprocal square root (one
//     MUFU.RSQ) and two products; it is the bin wherever that x lies
//     farther from an integer than its error bound allows, and where it
//     does not the thresholds decide (`threshold_bin`). A count of the
//     thresholds at or below d2 (16 compares) and a binary search of them
//     (4 dependent loads), both exact for every d2, were slower than the
//     IEEE sequence on an H100 (PERF.md §6, `tools/compare_histogram.py
//     --variant`): each hit's dependent shared-memory loads cost more
//     than its ALU work. NaN never reaches the bin: the hit test d2 <= r2
//     rejects a NaN d2.
//   * Private bins. Each thread owns n_bins uint32 counters in shared
//     memory, bin-major and thread-minor (bins[b * kThreads + thread]), so
//     a lane reads and writes only its own bank: no conflict and no
//     atomic. A thread walks one query, so a counter stays below n < 2^31.
//     At the block's end each warp sums its share of the bins over the
//     block's threads in 64 bits and adds each to the global bin with one
//     integer atomic, so the totals do not depend on the order.
// Past kPrivateBins (23 bins: 512 threads' counters fill the 48 KiB of
// shared memory a block has without opting in) each hit's bin comes from
// distance_bin and is added with a 64-bit shared-memory atomic to the
// block's bins (HISTOGRAM), and past kSharedBins (48 KiB of 64-bit bins)
// straight to its global bin, an integer atomic too. Opting in to more
// shared memory would take it from L1, which holds the node records. The
// IEEE sequences' FFMAs are in HISTOGRAM and in the prologue
// (`chip_smoke.py` phase 1 holds both to `bin_probe_kernel`'s), none in
// HISTOGRAM_PRIVATE.
//
// EDGE 2.7 ms a round on an H100 80GB HBM3 at 700 W with 2^24 particles
// (HACC's linking length). HISTOGRAM at 4 eps took 212.67 ms there for
// 8.36e9 pairs (2.13e10 hops, 100 Ghops/s against COUNT's 356) with one
// shared-memory atomic and the IEEE sequence per pair; PERF.md §6 gives
// HISTOGRAM_PRIVATE's time and what each of its two changes bought
// (`tools/compare_histogram.py`).
//
// DenseBox (src/repro/core/dbscan.py:355-425), `dense_kernel`. The
// reference builds its tree over n fixed leaves, because XLA needs static
// shapes: a dense cell's box at its run's head, a leaf that its callback
// skips at each other point of a dense cell, and each loose point. Here
// the tree holds only the m leaves that do something, the dense cells'
// boxes and the loose points (`densebox_tree`); at 2^24 particles a skip
// leaf was 47% of the leaf hits, and the walk from a dense point lost 44%
// of its hops without them (a CPU count on `plummer_cloud`). The leaves a
// sphere hits do not depend on the tree's shape (an internal box is the
// exact min/max of its children, and the rounded point-box test is
// monotone in the box), so each query takes the reference's cells and
// points. A leaf reads an int4 word with its record, {run start, run
// length, label, kind} (a loose point's run is itself). A cell within r
// wholesale (its farthest corner, |centre - mid| + half a cell a side,
// within r) adds its run's length or takes its least label; so does a
// point leaf, whose run is 1 long. A cell that is partly within r is
// scanned by the thread itself over the grid-sorted points, each a 16-byte
// record {x, y, z, bits(label)} (one `LDG.E.128`; `dense_records_kernel`
// writes them before each launch). A scan by the whole warp (the lanes
// with a partial cell found by a ballot, their runs taken one after
// another, lane u testing point start + u) lost to this on an H100 80GB
// HBM3 at 700 W with 2^24 particles: a union launch 31.7 ms against 19.4,
// since a partial cell holds ~4 points and the warp then serializes ~15
// runs a query (`tools/compare_densebox.py --warp-scan`).
//
// STATS (a template flag, instantiated for COUNT) counts per lane what
// `_one_stackless_stats` counts (src/repro/core/query.py:274-309): every
// iteration, internal and leaf iterations, leaf hits, whether the epilogue
// ended the walk, and the deepest node visited from a depth table; the six
// go to rows of a (6, q) int32 array at column qi. The iteration that
// exits early is counted. A start node per query (null: the root) replaces
// the root; SENTINEL there means no walk, and the lane keeps its initial
// carry.
//
// Exactness: the hop rule is `_one_stackless` (src/repro/core/query.py:182):
// at a leaf, run the leaf test, the epilogue only on a hit, then follow the
// rope; at an internal node, descend to `left_child` on a hit, else follow
// the rope; stop when the epilogue says done. Each test equals its plain
// version (`kernels/wavefront.py`, `core/geometry.py`) bit for bit, and
// through it the reference on XLA:CPU:
//   * every product and sum is a round-to-nearest intrinsic, so no
//     multiply-add is contracted; distances sum as ((x*x + y*y) + z*z);
//   * min and max propagate NaN, as XLA's and torch's do (fminf/fmaxf
//     drop a NaN operand): a ray whose origin lies on a face it runs along
//     with a direction in (-1e-12, 0) gets inv = +inf and 0 * inf = NaN,
//     and the reference reports a miss;
//   * XLA:CPU flushes subnormal inputs and results to zero, so every
//     product flushes (`flush`), and the slab test also flushes the box,
//     the origin and its differences, which inv scales up; nothing else
//     changes, so POTENTIAL's 1/sqrt keeps its IEEE bits and the FFMA count
//     of the probe.

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kSentinel = -1;
constexpr int kThreads = 512;
constexpr int kMinBlocks = 3;
constexpr int kPackThreads = 256;
// The SO count: a warp per query, 8 warps a block, at least 6 blocks (42
// registers a thread) resident on an SM; a warp's stack of pending
// subtree roots holds kSphereStack nodes (2 KiB).
constexpr int kWarp = 32;
constexpr int kSphereWarps = 8;
constexpr int kSphereMinBlocks = 6;
constexpr int kSphereStack = 512;
constexpr unsigned kFullMask = 0xffffffffu;
// HISTOGRAM's bins a block holds in shared memory: 48 KiB of 64-bit bins.
constexpr int kSharedBins = 6144;
// HISTOGRAM_PRIVATE's bins: kThreads uint32 counters each, with the
// n_bins - 1 thresholds, within 48 KiB.
constexpr int kPrivateBins = 23;
// The bit pattern of +inf, the last non-negative float32, and the NaN
// that marks a threshold no float reaches.
constexpr unsigned kInfBits = 0x7f800000u;
constexpr int kNanBits = 0x7fc00000;

enum Epilogue {
  COUNT = 0, MIN_LABEL = 1, FILL = 2, FIXED = 3, POTENTIAL = 4,
  EDGE = 5, HISTOGRAM = 6, DENSE_COUNT = 7, DENSE_MIN_LABEL = 8, MIN_LABEL64 = 9,
  HISTOGRAM_PRIVATE = 10
};
enum Predicate { SPHERE = 0, BOX = 1, RAY = 2 };
// What a leaf of DenseBox's tree is (`DenseArgs::words`' w).
enum DenseLeaf { DENSE_POINT = 0, DENSE_CELL = 1 };

// Resident blocks an SM must hold: 3 caps a thread at 42 registers; the
// slab test's six t values and a ray's six floats take more, and so does
// the histogram's IEEE bin (HISTOGRAM), so those instances ask for 2 (64
// registers); HISTOGRAM_PRIVATE's bin needs no more than COUNT.
constexpr int min_blocks(int epi, int pred) {
  return (pred == RAY || epi == HISTOGRAM) ? 2 : kMinBlocks;
}

// max and min that propagate NaN (either operand), as XLA's and torch's:
// one instruction each on the card (PTX max.NaN/min.NaN, sm_80 and up),
// where fmaxf/fminf would drop a NaN operand.
__device__ __forceinline__ float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a > b || a != a) ? a : b;
#endif
}
__device__ __forceinline__ float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a < b || a != a) ? a : b;
#endif
}

// A subnormal value to a zero of its sign, as XLA:CPU flushes it; NaN and
// normals kept.
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x;
}

// d * d, flushed; a square is never negative, so no sign to keep.
__device__ __forceinline__ float sq(float d) {
  const float p = __fmul_rn(d, d);
  return p < FLT_MIN ? 0.0f : p;
}

// max(a - b, c - d, 0), the gap of one axis.
__device__ __forceinline__ float gap(float a, float b, float c, float d) {
  return max_nan(max_nan(__fsub_rn(a, b), __fsub_rn(c, d)), 0.0f);
}

__device__ __forceinline__ float sum_sq(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(sq(dx), sq(dy)), sq(dz));
}

// Squared distance from (px, py, pz) to the box [lo.xyz, hi.xyz].
__device__ __forceinline__ float point_box_dist2(float px, float py, float pz,
                                                 const float4& lo, const float4& hi) {
  return sum_sq(gap(lo.x, px, px, hi.x), gap(lo.y, py, py, hi.y), gap(lo.z, pz, pz, hi.z));
}

// Squared distance from (px, py, pz) to the box's farthest corner: the far
// gaps max(hi - p, p - lo, 0), squared and summed as point_box_dist2 does.
__device__ __forceinline__ float point_box_far2(float px, float py, float pz,
                                                const float4& lo, const float4& hi) {
  return sum_sq(gap(hi.x, px, px, lo.x), gap(hi.y, py, py, lo.y), gap(hi.z, pz, pz, lo.z));
}

// `aabb_aabb_dist2(qlo, qhi, lo, hi)`: gaps max(lo - qhi, qlo - hi, 0).
__device__ __forceinline__ float box_box_dist2(float ax, float ay, float az, float bx,
                                               float by, float bz, const float4& lo,
                                               const float4& hi) {
  return sum_sq(gap(lo.x, bx, ax, hi.x), gap(lo.y, by, ay, hi.y), gap(lo.z, bz, az, hi.z));
}

// Slab entry and exit of one axis: t0 = (lo - o) * inv, t1 = (hi - o) * inv.
__device__ __forceinline__ float slab(float lo, float o, float inv) {
  return flush(__fmul_rn(flush(__fsub_rn(flush(lo), o)), inv));
}

// `_ray_box(origin, inv, lo, hi)`'s hit: max(tmin, 0) <= tmax, with
// tmin = max over axes of min(t0, t1), tmax = min over axes of max(t0, t1).
// The origin and inv come flushed. A NaN anywhere makes it a miss.
__device__ __forceinline__ bool ray_hits(float ox, float oy, float oz, float ix, float iy,
                                         float iz, const float4& lo, const float4& hi) {
  const float ax = slab(lo.x, ox, ix), bx = slab(hi.x, ox, ix);
  const float ay = slab(lo.y, oy, iy), by = slab(hi.y, oy, iy);
  const float az = slab(lo.z, oz, iz), bz = slab(hi.z, oz, iz);
  const float tmin = max_nan(max_nan(min_nan(ax, bx), min_nan(ay, by)), min_nan(az, bz));
  const float tmax = min_nan(min_nan(max_nan(ax, bx), max_nan(ay, by)), max_nan(az, bz));
  return tmax >= max_nan(tmin, 0.0f);
}

// 1/sqrt(x), each step correctly rounded (torch: x.sqrt().reciprocal()).
__device__ __forceinline__ float inv_sqrt_rn(float x) {
  return __frcp_rn(__fsqrt_rn(x));
}

// The histogram's bin of a squared distance: floor(sqrt(max(d2, 1e-30)) /
// r_max * n_bins) clipped to [0, n_bins - 1], each step correctly rounded
// and flushed as XLA:CPU flushes (the plain version `histogram_bins`).
__device__ __forceinline__ int distance_bin(float d2, float r_max, int n_bins) {
  const float dist = __fsqrt_rn(max_nan(d2, 1e-30f));
  const float x = flush(__fmul_rn(flush(__fdiv_rn(dist, r_max)), static_cast<float>(n_bins)));
  return min(max(static_cast<int>(floorf(x)), 0), n_bins - 1);
}

// The same bin from the thresholds: edges[k - 1] = t_k, the least float32
// whose distance_bin is >= k (NaN where none is, so never at or below a
// d2), for k = 1 .. n_bins - 1, and scale = fl(n_bins / r_max). A first
// bin is floor(x), x = d2 * rsqrtf(d2) * scale: sqrt(d2) / r_max * n_bins
// from the approximate reciprocal square root (2 ulp) and two products,
// within 6e-7 x (2^-20.6 x) of distance_bin's quotient (three correctly
// rounded steps). So where x lies farther than x * 2^-18 from an integer
// the two floors agree, and the first bin is the bin; where it lies
// nearer (at most 2 x 2^-18 of the pairs at x, 1.2e-4 at x = 16), or is
// NaN, the thresholds decide: the bin moves up while d2 >= t_{b+1} and
// down while d2 < t_b, which is exact from any start. d2 is a hit's,
// never NaN or negative.
__device__ __forceinline__ int threshold_bin(float d2, const float* edges, int n_bins,
                                             float scale) {
  const float dd = max_nan(d2, 1e-30f);
  const float x = __fmul_rn(__fmul_rn(dd, rsqrtf(dd)), scale);
  const float whole = floorf(x);
  int b = min(max(static_cast<int>(whole), 0), n_bins - 1);
  const float frac = __fsub_rn(x, whole);
  const float band = __fmul_rn(x, 0x1p-18f);
  if (!(frac > band && frac < __fsub_rn(1.0f, band))) {
    while (b < n_bins - 1 && d2 >= edges[b]) ++b;
    while (b > 0 && !(d2 >= edges[b - 1])) --b;
  }
  return b;
}

struct Tree {
  const float4* inner;   // (n-1) x 2 records of the internal nodes
  const float4* leaves;  // (n,) records of the leaves, in leaf order
  const int* key;        // (n,) what a hit reads, in leaf order (COUNT: null)
  int n;
};

// What each epilogue reads besides the tree and the queries; an
// instantiation reads only its own fields.
template <typename Off>
struct Epi {
  int stop_at;              // COUNT: early exit at this count (INT_MAX: never)
  const bool* qmask;        // MIN_LABEL, POTENTIAL: queries to run (null: all)
  int sentinel;             // MIN_LABEL: result where no core object is hit
  const Off* offsets;       // FILL: row start per query
  long long capacity;       // FILL: length of `indices`; FIXED: row width
  int* indices;             // FILL: (capacity,); FIXED: (q, capacity)
  float soft2;              // POTENTIAL: squared softening length
  float* potential;         // POTENTIAL: (q,) output
  const int* depths;        // STATS: (2n-1,) depth of each node
  int* stats;               // STATS: (6, q) counters
  const int2* pair_key;     // EDGE: (n,) in leaf order {object, its root where
                            // core, else -1}
  float r_max;              // HISTOGRAM: the largest distance binned
  int n_bins;               // HISTOGRAM(_PRIVATE): bins over [0, r_max]
  unsigned long long* hist; // HISTOGRAM(_PRIVATE): (n_bins,) pair counts, added to
  const float* thresholds;  // HISTOGRAM_PRIVATE: (n_bins - 1,) t_1 .. t_{n_bins-1}
  float scale;              // HISTOGRAM_PRIVATE: fl(n_bins / r_max)
  const long long* key64;   // MIN_LABEL64: (n,) key in leaf order
  long long sentinel64;     // MIN_LABEL64: result where no core object is hit
  long long* out64;         // MIN_LABEL64: (q,) output
};

// COUNT: carry = hits so far; done when it reaches stop_at.
// MIN_LABEL: carry = min key over objects hit; never done.
// MIN_LABEL64: the same with int64 keys and carry, written to e.out64.
// FILL: writes hits at offsets[qi] + k below capacity; done at capacity.
// FIXED: carry = hits so far; hit k goes to slot min(k, capacity - 1).
// POTENTIAL: acc -= 1/sqrt(d2 + soft2) per hit; never done.
// EDGE: carry = edges taken; a hit object j is taken where it is core and
//   its root differs from the query's, into slot min(carry, capacity - 1)
//   of row qi; done when carry reaches capacity. Queries are the tree's
//   leaves in order (query qi is leaf qi's point, from the start node
//   rope[leaf qi]: the pair backend); one that is not core walks nothing.
// HISTOGRAM: each hit's distance bin, added to the block's bins (past
//   kSharedBins, to the global bins); no carry.
// HISTOGRAM_PRIVATE: each hit's bin from the thresholds, added to the
//   thread's own counter of it; no carry.
// `out[qi]` receives the int carry (FILL and the histograms have none and
// write no `out`; POTENTIAL writes `e.potential[qi]` instead).
// Per query: SPHERE reads its centre qa[qi] and r2 = qb[qi]; BOX its box
// qa[qi] (lo), qb[qi] (hi); RAY its origin qa[qi] and inv qb[qi]; each row
// of qa and of a 3-wide qb is 3 floats.
// What a histogram's block keeps in shared memory.
struct HistBlock {
  unsigned long long* bins;  // HISTOGRAM: the block's n_bins bins
  unsigned* own;             // HISTOGRAM_PRIVATE: this thread's bin 0 (bin b
                             // at own[b * kThreads])
  const float* edges;        // HISTOGRAM_PRIVATE: the n_bins - 1 thresholds
};

template <int EPI, int PRED, bool BOX_LEAF, typename Off, bool STATS>
__device__ __forceinline__ void walk(const Tree& t, int lane, const int* __restrict__ order,
                                     const float* __restrict__ qa,
                                     const float* __restrict__ qb, int q,
                                     const int* __restrict__ start, const Epi<Off>& e,
                                     int* __restrict__ out, const HistBlock& h) {
  const int qi = order ? __ldg(order + lane) : lane;
  int carry = EPI == MIN_LABEL ? e.sentinel : 0;
  long long carry64 = EPI == MIN_LABEL64 ? e.sentinel64 : 0;
  float acc = 0.0f;
  long long pos = 0;
  if constexpr (EPI == MIN_LABEL || EPI == MIN_LABEL64 || EPI == POTENTIAL) {
    if (e.qmask && !e.qmask[qi]) {
      if constexpr (EPI == POTENTIAL) e.potential[qi] = acc;
      else if constexpr (EPI == MIN_LABEL64) e.out64[qi] = carry64;
      else out[qi] = carry;
      return;
    }
  }
  if constexpr (EPI == FILL) {
    pos = static_cast<long long>(e.offsets[qi]);
    if (pos >= e.capacity) return;
  }
  int own = 0;
  if constexpr (EPI == EDGE) {
    own = __ldg(e.pair_key + qi).y;
    if (own < 0) {
      out[qi] = 0;
      return;
    }
  }
  float ax = qa[3 * qi], ay = qa[3 * qi + 1], az = qa[3 * qi + 2];
  float bx, by = 0.0f, bz = 0.0f;
  if constexpr (PRED == SPHERE) {
    bx = qb[qi];
  } else {
    bx = qb[3 * qi], by = qb[3 * qi + 1], bz = qb[3 * qi + 2];
  }
  if constexpr (PRED == RAY) ax = flush(ax), ay = flush(ay), az = flush(az);
  const int first_leaf = t.n - 1;
  int node = start ? __ldg(start + qi) : 0;
  int nodes = 0, aabb = 0, leaves = 0, hits = 0, max_depth = 0;
  bool done = false;
  while (node != kSentinel) {
    const bool leaf = node >= first_leaf;
    const int k = node - first_leaf;
    const float4* rec = leaf ? t.leaves + (BOX_LEAF ? 2 * k : k) : t.inner + 2 * node;
    const float4 lo = __ldg(rec);
    const float4 hi = (leaf && !BOX_LEAF) ? lo : __ldg(rec + 1);
    // A leaf's key is fetched with its record, not after the test.
    int key = 0;
    if constexpr (EPI == MIN_LABEL || EPI == FILL || EPI == FIXED) {
      key = leaf ? __ldg(t.key + k) : 0;
    }
    long long key64 = 0;
    if constexpr (EPI == MIN_LABEL64) key64 = leaf ? __ldg(e.key64 + k) : 0;
    int2 pkey = make_int2(0, -1);
    if constexpr (EPI == EDGE) pkey = leaf ? __ldg(e.pair_key + k) : pkey;
    float d2 = 0.0f;
    bool hit;
    if constexpr (PRED == SPHERE) {
      d2 = point_box_dist2(ax, ay, az, lo, hi);
      hit = d2 <= bx;
    } else if constexpr (PRED == BOX) {
      hit = box_box_dist2(ax, ay, az, bx, by, bz, lo, hi) <= 0.0f;
    } else {
      hit = ray_hits(ax, ay, az, bx, by, bz, lo, hi);
    }
    if constexpr (STATS) {
      ++nodes;
      leaves += leaf;
      aabb += !leaf;
      hits += leaf && hit;
      max_depth = max(max_depth, __ldg(e.depths + node));
    }
    if constexpr (EPI == MIN_LABEL) {
      carry = (leaf && hit) ? min(carry, key) : carry;
    } else if constexpr (EPI == MIN_LABEL64) {
      carry64 = (leaf && hit) ? min(carry64, key64) : carry64;
    } else if (leaf && hit) {
      if constexpr (EPI == COUNT) {
        ++carry;
        if (carry >= e.stop_at) {
          done = true;
          break;
        }
      } else if constexpr (EPI == FILL) {
        e.indices[pos] = key;
        if (++pos >= e.capacity) break;
      } else if constexpr (EPI == FIXED) {
        if (e.capacity > 0) {
          const long long slot = min(static_cast<long long>(carry), e.capacity - 1);
          e.indices[static_cast<long long>(qi) * e.capacity + slot] = key;
        }
        ++carry;
      } else if constexpr (EPI == POTENTIAL) {
        acc = __fsub_rn(acc, inv_sqrt_rn(__fadd_rn(d2, e.soft2)));
      } else if constexpr (EPI == EDGE) {
        if (pkey.y >= 0 && pkey.y != own) {
          const long long slot = min(static_cast<long long>(carry), e.capacity - 1);
          e.indices[static_cast<long long>(qi) * e.capacity + slot] = pkey.x;
          if (++carry >= e.capacity) break;
        }
      } else if constexpr (EPI == HISTOGRAM) {
        const int b = distance_bin(d2, e.r_max, e.n_bins);
        if (e.n_bins <= kSharedBins) atomicAdd(h.bins + b, 1ULL);
        else atomicAdd(e.hist + b, 1ULL);
      } else if constexpr (EPI == HISTOGRAM_PRIVATE) {
        const int b = threshold_bin(d2, h.edges, e.n_bins, e.scale);
        ++h.own[b * kThreads];
      }
    }
    // At a leaf both w lanes hold the rope.
    node = hit ? __float_as_int(lo.w) : __float_as_int(hi.w);
  }
  if constexpr (STATS) {
    int* s = e.stats + qi;
    s[0] = nodes;
    s[static_cast<long long>(q)] = aabb;
    s[2LL * q] = leaves;
    s[3LL * q] = hits;
    s[4LL * q] = done;
    s[5LL * q] = max_depth;
  }
  if constexpr (EPI == POTENTIAL) {
    e.potential[qi] = acc;
  } else if constexpr (EPI == MIN_LABEL64) {
    e.out64[qi] = carry64;
  } else if constexpr (EPI != FILL && EPI != HISTOGRAM && EPI != HISTOGRAM_PRIVATE) {
    out[qi] = carry;
  }
}

// The n_bins - 1 thresholds into shared memory; every thread of the block
// takes part.
__device__ __forceinline__ void load_edges(float* edges, const float* thresholds, int n_bins) {
  for (int i = threadIdx.x; i < n_bins - 1; i += blockDim.x) edges[i] = thresholds[i];
}

// One thread per query (blocks of kThreads). HISTOGRAM adds its hits to the
// block's bins in shared memory (n_bins 64-bit integers), which go to the
// global bins once a block: integer sums, so the order of the additions
// changes nothing. Past kSharedBins bins the block holds none and the hits
// go to the global bins themselves. HISTOGRAM_PRIVATE keeps n_bins uint32
// counters a thread and the thresholds in shared memory; at the
// end warp w sums bins w, w + 16, ... over the block's threads (a lane
// over threads lane, lane + 32, ..., then the warp's lanes) and adds each
// to its global bin.
template <int EPI, int PRED, bool BOX_LEAF, typename Off, bool STATS>
__global__ void __launch_bounds__(kThreads, min_blocks(EPI, PRED))
wavefront_kernel(Tree t, const int* __restrict__ order,
                 const float* __restrict__ qa, const float* __restrict__ qb,
                 int q, const int* __restrict__ start, Epi<Off> e,
                 int* __restrict__ out) {
  static_assert((EPI != MIN_LABEL && EPI != MIN_LABEL64 && EPI != POTENTIAL && EPI != EDGE &&
                 EPI != HISTOGRAM && EPI != HISTOGRAM_PRIVATE) ||
                    (PRED == SPHERE && !BOX_LEAF),
                "MIN_LABEL(64), POTENTIAL, EDGE and the histograms take spheres on point "
                "leaves");
  static_assert(EPI != DENSE_COUNT && EPI != DENSE_MIN_LABEL,
                "DenseBox's epilogues run in dense_kernel");
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (EPI == HISTOGRAM) {
    extern __shared__ unsigned long long bins[];
    // Uniform over the block, so every thread reaches both barriers or none.
    const bool shared = e.n_bins <= kSharedBins;
    if (shared) {
      for (int b = threadIdx.x; b < e.n_bins; b += blockDim.x) bins[b] = 0;
      __syncthreads();
    }
    if (lane < q) {
      walk<EPI, PRED, BOX_LEAF, Off, STATS>(t, lane, order, qa, qb, q, start, e, out,
                                            HistBlock{bins, nullptr, nullptr});
    }
    if (shared) {
      __syncthreads();
      for (int b = threadIdx.x; b < e.n_bins; b += blockDim.x) {
        if (bins[b]) atomicAdd(e.hist + b, bins[b]);
      }
    }
  } else if constexpr (EPI == HISTOGRAM_PRIVATE) {
    extern __shared__ unsigned long long block_smem[];
    unsigned* priv = reinterpret_cast<unsigned*>(block_smem);  // n_bins x kThreads
    float* edges = reinterpret_cast<float*>(priv + e.n_bins * kThreads);
    load_edges(edges, e.thresholds, e.n_bins);
    unsigned* own = priv + threadIdx.x;
    for (int b = 0; b < e.n_bins; ++b) own[b * kThreads] = 0;
    __syncthreads();
    if (lane < q) {
      walk<EPI, PRED, BOX_LEAF, Off, STATS>(t, lane, order, qa, qb, q, start, e, out,
                                            HistBlock{nullptr, own, edges});
    }
    __syncthreads();
    const int warp = threadIdx.x / kWarp, l = threadIdx.x % kWarp;
    for (int b = warp; b < e.n_bins; b += kThreads / kWarp) {  // uniform over the warp
      unsigned long long sum = 0;
      for (int j = l; j < kThreads; j += kWarp) sum += priv[b * kThreads + j];
      for (int d = kWarp / 2; d > 0; d >>= 1) sum += __shfl_down_sync(kFullMask, sum, d);
      if (l == 0 && sum) atomicAdd(e.hist + b, sum);
    }
  } else {
    if (lane >= q) return;
    walk<EPI, PRED, BOX_LEAF, Off, STATS>(t, lane, order, qa, qb, q, start, e, out,
                                          HistBlock{});
  }
}

// Nothing but the sequence POTENTIAL uses for 1/sqrt: its SASS (its FFMA
// count) is set beside that of the POTENTIAL instance, and its results
// beside torch's x.sqrt().reciprocal().
__global__ void __launch_bounds__(kPackThreads)
rsqrt_probe_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = inv_sqrt_rn(x[i]);
}

// Nothing but HISTOGRAM's bin sequence, as `rsqrt_probe_kernel` is for
// POTENTIAL: its FFMA count (the IEEE square root's and division's) is set
// beside HISTOGRAM's, and its bins beside `histogram_bins`.
__global__ void __launch_bounds__(kPackThreads)
bin_probe_kernel(const float* __restrict__ d2, int* __restrict__ bin, int n, float r_max,
                 int n_bins) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) bin[i] = distance_bin(d2[i], r_max, n_bins);
}

// HISTOGRAM_PRIVATE's prologue, one thread per k in 1 .. n_bins - 1: t[k-1]
// = t_k, the least non-negative float32 (by bit pattern, +0 to +inf, which
// orders them as their values) whose distance_bin is >= k, found by
// bisection with distance_bin itself; NaN where even +inf's bin is below
// k. About 31 steps a thread, each the IEEE sequence of `bin_probe_kernel`.
__global__ void __launch_bounds__(kPackThreads)
histogram_edges_kernel(float r_max, int n_bins, float* __restrict__ t) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x + 1;
  if (k >= n_bins) return;
  unsigned lo = 0u, hi = kInfBits + 1u;  // t_k's bits lie in [lo, hi]; hi: none
  while (lo < hi) {
    const unsigned mid = lo + (hi - lo) / 2u;
    if (distance_bin(__uint_as_float(mid), r_max, n_bins) >= k) {
      hi = mid;
    } else {
      lo = mid + 1u;
    }
  }
  t[k - 1] = lo > kInfBits ? __int_as_float(kNanBits) : __uint_as_float(lo);
}

// Nothing but HISTOGRAM_PRIVATE's bin from its thresholds, loaded into
// shared memory as the walk loads them: bin[i] = threshold_bin(d2[i]).
__global__ void __launch_bounds__(kPackThreads)
threshold_probe_kernel(const float* __restrict__ d2, int* __restrict__ bin, int n,
                       const float* __restrict__ thresholds, int n_bins, float scale) {
  extern __shared__ float probe_edges[];
  load_edges(probe_edges, thresholds, n_bins);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) bin[i] = threshold_bin(d2[i], probe_edges, n_bins, scale);
}

// One thread per node: node i's box and links into its record; a leaf's
// into one record (point leaves) or two (box leaves).
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const float* __restrict__ node_lo, const float* __restrict__ node_hi,
            const int* __restrict__ left_child, const int* __restrict__ rope, int n,
            int box_leaves, float4* __restrict__ inner, float4* __restrict__ leaves) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 2LL * n - 1) return;
  const float* lo = node_lo + 3 * i;
  const float* hi = node_hi + 3 * i;
  const float link = __int_as_float(rope[i]);
  if (i < n - 1) {
    inner[2 * i] = make_float4(lo[0], lo[1], lo[2], __int_as_float(left_child[i]));
    inner[2 * i + 1] = make_float4(hi[0], hi[1], hi[2], link);
  } else if (box_leaves) {
    const long long k = i - (n - 1);
    leaves[2 * k] = make_float4(lo[0], lo[1], lo[2], link);
    leaves[2 * k + 1] = make_float4(hi[0], hi[1], hi[2], link);
  } else {
    leaves[i - (n - 1)] = make_float4(lo[0], lo[1], lo[2], link);
  }
}

// What the SO count reads: the packed records of a point tree, and per
// internal node its span and right child.
struct SphereTree {
  const float4* inner;   // (n-1) x 2 records of the internal nodes
  const float4* leaves;  // (n,) records of the leaves, in leaf order
  const int* span;       // (n-1,) leaves under each internal node
  const int* right;      // (n-1,) right child of each internal node
  int n;
};

// One hop of the SO count at `node`: adds a leaf hit (1) or a contained
// node's span to `count`, one to `far` where it runs the far test, sets
// the node's left child and rope, and returns whether the node is hit but
// not contained (its subtree must be walked).
__device__ __forceinline__ bool sphere_visit(const SphereTree& t, int node, float cx, float cy,
                                             float cz, float r2, int& count, int& far,
                                             int& left, int& rope) {
  const int first_leaf = t.n - 1;
  if (node >= first_leaf) {
    const float4 p = __ldg(t.leaves + (node - first_leaf));
    count += point_box_dist2(cx, cy, cz, p, p) <= r2;
    rope = __float_as_int(p.w);
    return false;
  }
  const float4* rec = t.inner + 2 * node;
  const float4 lo = __ldg(rec);
  const float4 hi = __ldg(rec + 1);
  left = __float_as_int(lo.w);
  rope = __float_as_int(hi.w);
  if (!(point_box_dist2(cx, cy, cz, lo, hi) <= r2)) return false;
  ++far;
  if (point_box_far2(cx, cy, cz, lo, hi) <= r2) {
    count += __ldg(t.span + node);
    return false;
  }
  return true;
}

// The rest of a subtree, walked by one lane from `node` until it reaches
// `stop` (the subtree root's rope): a node hit but not contained descends
// to its left child, any other follows its rope. Returns the leaves within
// r2; adds the hops to `hops` and the far tests to `far`.
__device__ __forceinline__ int sphere_walk(const SphereTree& t, int node, int stop, float cx,
                                           float cy, float cz, float r2, int& hops, int& far) {
  int count = 0, left = 0, rope = 0;
  while (node != stop) {
    node = sphere_visit(t, node, cx, cy, cz, r2, count, far, left, rope) ? left : rope;
    ++hops;
  }
  return count;
}

// A warp per query qi, its pending subtree roots on a stack in shared
// memory (kSphereStack a warp). Each step the lanes pop up to 32 roots
// from the top and test one each: a leaf hit or a contained node is
// counted by its lane, a node hit but not contained pushes its two
// children; where the stack has no room for them, its lane walks the
// node's subtree to the node's rope instead. The lanes' counts are summed
// at the end. STATS: all lanes' hops, the warp's longest chain of
// dependent hops (per step, the most hops one lane made), and the far
// tests of all lanes.
template <bool STATS>
__global__ void __launch_bounds__(kSphereWarps * kWarp, kSphereMinBlocks)
sphere_count_kernel(SphereTree t, const float* __restrict__ centers,
                    const float* __restrict__ r2s, int q, int* __restrict__ stats,
                    int* __restrict__ out) {
  __shared__ int stacks[kSphereWarps][kSphereStack];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long query = static_cast<long long>(blockIdx.x) * kSphereWarps + warp;
  if (query >= q) return;  // the whole warp
  const int qi = static_cast<int>(query);
  const float cx = centers[3 * qi], cy = centers[3 * qi + 1], cz = centers[3 * qi + 2];
  const float r2 = r2s[qi];
  int* stack = stacks[warp];
  if (lane == 0) stack[0] = 0;  // the root
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  int size = 1, count = 0, hops = 0, chain = 0, far = 0;
  while (size > 0) {
    const int popped = min(size, kWarp);
    const bool have = lane < popped;
    const int node = have ? stack[size - 1 - lane] : 0;
    size -= popped;
    __syncwarp();  // every pop read before a push overwrites its slot
    bool keep = false;
    int left = 0, rope = 0, right = 0, step = 0;
    if (have) {
      // Issued with the record: the right child is pushed where it is kept.
      if (node < t.n - 1) right = __ldg(t.right + node);
      keep = sphere_visit(t, node, cx, cy, cz, r2, count, far, left, rope);
      step = 1;
    }
    const unsigned kept = __ballot_sync(kFullMask, keep);
    const int room = (kSphereStack - size) / 2;
    const int rank = __popc(kept & below);
    if (keep) {
      if (rank < room) {
        stack[size + 2 * rank] = right;
        stack[size + 2 * rank + 1] = left;
      } else {
        count += sphere_walk(t, left, rope, cx, cy, cz, r2, step, far);
      }
    }
    size += 2 * min(__popc(kept), room);
    if constexpr (STATS) {
      hops += step;
      chain += __reduce_max_sync(kFullMask, step);
    }
    __syncwarp();  // every push written before the next pops
  }
  const int total = __reduce_add_sync(kFullMask, count);
  if constexpr (STATS) {
    const int all = __reduce_add_sync(kFullMask, hops);
    const int tests = __reduce_add_sync(kFullMask, far);
    if (lane == 0) {
      stats[qi] = all;
      stats[static_cast<long long>(q) + qi] = chain;
      stats[2LL * q + qi] = tests;
    }
  }
  if (lane == 0) out[qi] = total;
}

// What DenseBox's epilogues read besides the tree and the queries.
struct DenseArgs {
  const int4* words;     // (m,) in leaf order {run start, run length, label,
                         // DenseLeaf}
  const float4* scan;    // (n,) grid-sorted points {x, y, z, bits(label)}
  float half;            // half the cell size
  int stop_at;           // DENSE_COUNT: early exit at this count (INT_MAX: never)
  const bool* qmask;     // queries to run (null: all)
  int sentinel;          // DENSE_MIN_LABEL: result where nothing is hit
};

// DenseBox's scan records: rec[u] = {x, y, z, bits(lab[u])} of the
// grid-sorted point u (label 0 where lab is null: DENSE_COUNT reads none).
__global__ void __launch_bounds__(kPackThreads)
dense_records_kernel(const float* __restrict__ pts, const int* __restrict__ lab, int n,
                     float4* __restrict__ rec) {
  const long long u = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= n) return;
  const float* p = pts + 3 * u;
  rec[u] = make_float4(p[0], p[1], p[2], __int_as_float(lab ? lab[u] : 0));
}

// DenseBox's walk, one thread per query qi = order[i] on its tree of cell
// boxes and loose points (box leaf records), the rope walk of
// `wavefront_kernel`. DENSE_COUNT: carry = points within r, a whole
// cell's or a point leaf's run length, a partial cell's points within r,
// scanned by the thread itself over their records; done once a leaf hit
// brings it to stop_at. DENSE_MIN_LABEL: carry = the least label of the
// same, from `sentinel`. out[qi] is the carry, 0 or `sentinel` outside
// qmask.
template <int EPI>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dense_kernel(Tree t, const int* __restrict__ order, const float* __restrict__ centers,
             const float* __restrict__ r2s, int q, DenseArgs e, int* __restrict__ out) {
  static_assert(EPI == DENSE_COUNT || EPI == DENSE_MIN_LABEL, "DenseBox's epilogues only");
  constexpr bool kCount = EPI == DENSE_COUNT;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const int qi = order ? __ldg(order + i) : static_cast<int>(i);
  const int init = kCount ? 0 : e.sentinel;
  if (e.qmask && !e.qmask[qi]) {
    out[qi] = init;
    return;
  }
  const float cx = centers[3 * qi], cy = centers[3 * qi + 1], cz = centers[3 * qi + 2];
  const float r2 = r2s[qi];
  const int first_leaf = t.n - 1;
  int node = 0;
  int carry = init;
  while (node != kSentinel) {
    const bool leaf = node >= first_leaf;
    const int k = node - first_leaf;
    const float4* rec = leaf ? t.leaves + 2 * k : t.inner + 2 * node;
    const float4 lo = __ldg(rec);
    const float4 hi = __ldg(rec + 1);
    // A leaf's word is fetched with its record, not after the test.
    const int4 w = leaf ? __ldg(e.words + k) : make_int4(0, 0, 0, DENSE_POINT);
    const bool hit = point_box_dist2(cx, cy, cz, lo, hi) <= r2;
    // At a leaf both w lanes hold the rope.
    const int next = hit ? __float_as_int(lo.w) : __float_as_int(hi.w);
    if (leaf && hit) {
      bool partial = false;
      if (w.w == DENSE_CELL) {
        // The cell's farthest corner: |centre - mid| + half the cell a side.
        const float fx = __fadd_rn(fabsf(__fsub_rn(cx, __fmul_rn(__fadd_rn(lo.x, hi.x), 0.5f))),
                                   e.half);
        const float fy = __fadd_rn(fabsf(__fsub_rn(cy, __fmul_rn(__fadd_rn(lo.y, hi.y), 0.5f))),
                                   e.half);
        const float fz = __fadd_rn(fabsf(__fsub_rn(cz, __fmul_rn(__fadd_rn(lo.z, hi.z), 0.5f))),
                                   e.half);
        partial = !(sum_sq(fx, fy, fz) <= r2);
      }
      if (partial) {
        for (int u = w.x; u < w.x + w.y; ++u) {
          const float4 p = __ldg(e.scan + u);
          if (sum_sq(__fsub_rn(p.x, cx), __fsub_rn(p.y, cy), __fsub_rn(p.z, cz)) <= r2) {
            carry = kCount ? carry + 1 : min(carry, __float_as_int(p.w));
          }
        }
      } else {
        carry = kCount ? carry + w.y : min(carry, w.z);
      }
      if (kCount && carry >= e.stop_at) break;
    }
    node = next;
  }
  out[qi] = carry;
}

template <int EPI, int PRED, bool BOX_LEAF, bool STATS, typename Off>
int launch(const Tree& t, const int* order, const float* qa, const float* qb, int q,
           const int* start, const Epi<Off>& e, int* out, cudaStream_t stream,
           size_t smem = 0) {
  const int blocks = (q + kThreads - 1) / kThreads;
  wavefront_kernel<EPI, PRED, BOX_LEAF, Off, STATS><<<blocks, kThreads, smem, stream>>>(
      t, order, qa, qb, q, start, e, out);
  return static_cast<int>(cudaGetLastError());
}

// The instance of EPI for the predicate `pred` and the tree's leaf kind.
template <int EPI, bool STATS = false, typename Off>
int dispatch(const Tree& t, int box_leaves, const int* order, const float* qa,
             const float* qb, int pred, int q, const int* start, const Epi<Off>& e,
             int* out, cudaStream_t s) {
  switch (2 * pred + (box_leaves ? 1 : 0)) {
    case 2 * SPHERE:
      return launch<EPI, SPHERE, false, STATS>(t, order, qa, qb, q, start, e, out, s);
    case 2 * SPHERE + 1:
      return launch<EPI, SPHERE, true, STATS>(t, order, qa, qb, q, start, e, out, s);
    case 2 * BOX:
      return launch<EPI, BOX, false, STATS>(t, order, qa, qb, q, start, e, out, s);
    case 2 * BOX + 1:
      return launch<EPI, BOX, true, STATS>(t, order, qa, qb, q, start, e, out, s);
    case 2 * RAY:
      return launch<EPI, RAY, false, STATS>(t, order, qa, qb, q, start, e, out, s);
    case 2 * RAY + 1:
      return launch<EPI, RAY, true, STATS>(t, order, qa, qb, q, start, e, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Tree tree(const float* inner, const float* leaves, const int* key, int n) {
  return Tree{reinterpret_cast<const float4*>(inner),
              reinterpret_cast<const float4*>(leaves), key, n};
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// node_lo, node_hi: (2n-1, 3) float32; left_child: (n-1,); rope: (2n-1,)
// int32. inner: (n-1, 8) and leaves: (n, 4), or (n, 8) with box_leaves,
// float32, 16-byte aligned.
int wavefront_pack(const float* node_lo, const float* node_hi, const int* left_child,
                   const int* rope, int n, int box_leaves, float* inner, float* leaves,
                   cudaStream_t stream) {
  const long long nodes = 2LL * n - 1;
  const int blocks = static_cast<int>((nodes + kPackThreads - 1) / kPackThreads);
  pack_kernel<<<blocks, kPackThreads, 0, stream>>>(
      node_lo, node_hi, left_child, rope, n, box_leaves, reinterpret_cast<float4*>(inner),
      reinterpret_cast<float4*>(leaves));
  return static_cast<int>(cudaGetLastError());
}

// In every traversal entry, inner and leaves are `wavefront_pack`'s
// records (box_leaves: the layout they were packed in), key is (n,) int32
// in leaf order (or null), order the thread order of the q queries (or
// null), qa and qb their geometry for the predicate `pred` (SPHERE: (q, 3)
// centres and (q,) r2; BOX: (q, 3) lo and hi; RAY: (q, 3) origins and
// inverse directions), and start their (q,) int32 start nodes (null: the
// root; SENTINEL: no walk). stop_at < 0 means no early exit; with depths
// (the (2n-1,) int32 node depth table) non-null the STATS instance also
// writes the (6, q) int32 counters `stats`.
int wavefront_count(const float* inner, const float* leaves, const int* key, int n,
                    int box_leaves, const int* order, const float* qa, const float* qb,
                    int pred, int q, const int* start, int stop_at, const int* depths,
                    int* stats, int* out, cudaStream_t stream) {
  Epi<int> e{};
  e.stop_at = stop_at < 0 ? INT_MAX : stop_at;
  const Tree t = tree(inner, leaves, key, n);
  if (depths) {
    e.depths = depths;
    e.stats = stats;
    return dispatch<COUNT, true>(t, box_leaves, order, qa, qb, pred, q, start, e, out,
                                 stream);
  }
  return dispatch<COUNT>(t, box_leaves, order, qa, qb, pred, q, start, e, out, stream);
}

// key[k]: the label of leaf k's object where it is core, else sentinel.
// SPHERE on point leaves only.
int wavefront_min_label(const float* inner, const float* leaves, const int* key, int n,
                        int box_leaves, const int* order, const float* qa,
                        const float* qb, int pred, int q, const int* start,
                        const bool* qmask, int sentinel, int* out, cudaStream_t stream) {
  if (pred != SPHERE || box_leaves) return static_cast<int>(cudaErrorInvalidValue);
  Epi<int> e{};
  e.qmask = qmask;
  e.sentinel = sentinel;
  return launch<MIN_LABEL, SPHERE, false, false>(tree(inner, leaves, key, n), order, qa,
                                                 qb, q, start, e, out, stream);
}

// MIN_LABEL over int64 labels. key64[k]: the label of leaf k's object
// where it is core, else sentinel; out: (q,) int64. SPHERE on point leaves
// only.
int wavefront_min_label64(const float* inner, const float* leaves, const long long* key64,
                          int n, int box_leaves, const int* order, const float* qa,
                          const float* qb, int pred, int q, const int* start,
                          const bool* qmask, long long sentinel, long long* out,
                          cudaStream_t stream) {
  if (pred != SPHERE || box_leaves) return static_cast<int>(cudaErrorInvalidValue);
  Epi<int> e{};
  e.qmask = qmask;
  e.key64 = key64;
  e.sentinel64 = sentinel;
  e.out64 = out;
  return launch<MIN_LABEL64, SPHERE, false, false>(tree(inner, leaves, nullptr, n), order, qa,
                                                   qb, q, start, e, nullptr, stream);
}

// key: leaf_perm. offsets: (q + 1,) int32 (offsets_64 == 0) or int64;
// indices: (capacity,) int32, set to -1 by the caller.
int wavefront_fill(const float* inner, const float* leaves, const int* key, int n,
                   int box_leaves, const int* order, const float* qa, const float* qb,
                   int pred, int q, const int* start, const void* offsets,
                   int offsets_64, long long capacity, int* indices, cudaStream_t stream) {
  const Tree t = tree(inner, leaves, key, n);
  if (offsets_64) {
    Epi<long long> e{};
    e.offsets = static_cast<const long long*>(offsets);
    e.capacity = capacity;
    e.indices = indices;
    return dispatch<FILL>(t, box_leaves, order, qa, qb, pred, q, start, e, nullptr,
                          stream);
  }
  Epi<int> e{};
  e.offsets = static_cast<const int*>(offsets);
  e.capacity = capacity;
  e.indices = indices;
  return dispatch<FILL>(t, box_leaves, order, qa, qb, pred, q, start, e, nullptr, stream);
}

// key: leaf_perm. buf: (q, capacity) int32, set to -1 by the caller;
// counts: (q,) int32.
int wavefront_fixed(const float* inner, const float* leaves, const int* key, int n,
                    int box_leaves, const int* order, const float* qa, const float* qb,
                    int pred, int q, const int* start, long long capacity, int* buf,
                    int* counts, cudaStream_t stream) {
  Epi<int> e{};
  e.capacity = capacity;
  e.indices = buf;
  return dispatch<FIXED>(tree(inner, leaves, key, n), box_leaves, order, qa, qb, pred, q,
                         start, e, counts, stream);
}

// active: (q,) bool queries to run (null: all); out: (q,) float32, 0 at
// inactive queries. SPHERE on point leaves only.
int wavefront_potential(const float* inner, const float* leaves, const int* key, int n,
                        int box_leaves, const int* order, const float* qa,
                        const float* qb, int pred, int q, const int* start,
                        const bool* active, float soft2, float* out,
                        cudaStream_t stream) {
  if (pred != SPHERE || box_leaves) return static_cast<int>(cudaErrorInvalidValue);
  Epi<int> e{};
  e.qmask = active;
  e.soft2 = soft2;
  e.potential = out;
  return launch<POTENTIAL, SPHERE, false, false>(tree(inner, leaves, key, n), order, qa,
                                                 qb, q, start, e, nullptr, stream);
}

// EDGE (fdbscan_pair's capture). pair_key: (n,) int2 in leaf order, the
// object index and its root where it is core, else -1; query qi is leaf
// qi's point (qa: the points in leaf order, qb: r2) from start[qi] =
// rope[leaf qi]. buf: (q, capacity) int32, set to -1 by the caller;
// counts: (q,) int32. SPHERE on point leaves only; capacity >= 1.
int wavefront_edge(const float* inner, const float* leaves, const int* key, int n,
                   int box_leaves, const int* order, const float* qa, const float* qb,
                   int pred, int q, const int* start, const int* pair_key,
                   long long capacity, int* buf, int* counts, cudaStream_t stream) {
  if (pred != SPHERE || box_leaves || capacity < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Epi<int> e{};
  e.pair_key = reinterpret_cast<const int2*>(pair_key);
  e.capacity = capacity;
  e.indices = buf;
  return launch<EDGE, SPHERE, false, false>(tree(inner, leaves, key, n), order, qa, qb, q,
                                            start, e, counts, stream);
}

// HISTOGRAM (pair_count_histogram). hist: (n_bins,) uint64, set to 0 by the
// caller, gets each hit's bin. SPHERE on point leaves only; n_bins >= 1.
// Up to kPrivateBins bins HISTOGRAM_PRIVATE counts per thread, its bins
// from thresholds: (n_bins - 1,) float32, `wavefront_histogram_edges`'s
// (null only for one bin); past it HISTOGRAM sums in shared memory up to
// kSharedBins and in global memory past that, thresholds unread.
int wavefront_histogram(const float* inner, const float* leaves, const int* key, int n,
                        int box_leaves, const int* order, const float* qa,
                        const float* qb, int pred, int q, const int* start, float r_max,
                        int n_bins, const float* thresholds, unsigned long long* hist,
                        cudaStream_t stream) {
  if (pred != SPHERE || box_leaves || n_bins < 1 ||
      (n_bins > 1 && n_bins <= kPrivateBins && !thresholds)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Epi<int> e{};
  e.r_max = r_max;
  e.n_bins = n_bins;
  e.hist = hist;
  const Tree t = tree(inner, leaves, key, n);
  if (n_bins <= kPrivateBins) {
    e.thresholds = thresholds;
    e.scale = static_cast<float>(n_bins) / r_max;
    const size_t smem = (static_cast<size_t>(n_bins) * (kThreads + 1) - 1) * 4;
    return launch<HISTOGRAM_PRIVATE, SPHERE, false, false>(t, order, qa, qb, q, start, e,
                                                           nullptr, stream, smem);
  }
  return launch<HISTOGRAM, SPHERE, false, false>(t, order, qa, qb, q, start, e, nullptr, stream,
                                                 n_bins <= kSharedBins
                                                     ? n_bins * sizeof(unsigned long long)
                                                     : 0);
}

// HISTOGRAM_PRIVATE's thresholds: t, (n_bins - 1,) float32, t[k-1] the
// least float32 whose bin (r_max, n_bins) is >= k, NaN where none is.
int wavefront_histogram_edges(float r_max, int n_bins, float* t, cudaStream_t stream) {
  if (n_bins < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_bins - 1 + kPackThreads - 1) / kPackThreads;
  histogram_edges_kernel<<<blocks, kPackThreads, 0, stream>>>(r_max, n_bins, t);
  return static_cast<int>(cudaGetLastError());
}

// DenseBox's scan records of the (n, 3) float32 grid-sorted points pts and
// their (n,) int32 labels lab (null: 0) into rec, (n, 4) float32,
// 16-byte aligned.
int wavefront_dense_records(const float* pts, const int* lab, int n, float* rec,
                            cudaStream_t stream) {
  const int blocks = (n + kPackThreads - 1) / kPackThreads;
  dense_records_kernel<<<blocks, kPackThreads, 0, stream>>>(pts, lab, n,
                                                            reinterpret_cast<float4*>(rec));
  return static_cast<int>(cudaGetLastError());
}

// DENSE_COUNT (min_label == 0) or DENSE_MIN_LABEL on DenseBox's tree of m
// leaves: inner and leaves are `wavefront_pack`'s box leaf records; words:
// (m,) int4 in leaf order {run start, run length, label, DenseLeaf}; scan:
// (n,) float4 grid-sorted points {x, y, z, bits(label)}, 16-byte aligned;
// order: (q,) the thread order of the queries (null: 0 .. q-1); centres
// (q, 3) and r2 (q,) float32; qmask: (q,) bool queries to run (null: all);
// out: (q,) int32, 0 (COUNT) or sentinel (MIN_LABEL) outside the mask.
int wavefront_dense(const float* inner, const float* leaves, int m, const int* order,
                    const float* centers, const float* r2, int q, int min_label,
                    const int* words, const float* scan, float half, int stop_at,
                    const bool* qmask, int sentinel, int* out, cudaStream_t stream) {
  DenseArgs e{reinterpret_cast<const int4*>(words), reinterpret_cast<const float4*>(scan),
              half, stop_at < 0 ? INT_MAX : stop_at, qmask, sentinel};
  const Tree t = tree(inner, leaves, nullptr, m);
  const int blocks = (q + kThreads - 1) / kThreads;
  if (min_label) {
    dense_kernel<DENSE_MIN_LABEL><<<blocks, kThreads, 0, stream>>>(t, order, centers, r2, q, e,
                                                                   out);
  } else {
    dense_kernel<DENSE_COUNT><<<blocks, kThreads, 0, stream>>>(t, order, centers, r2, q, e,
                                                               out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The SO count: out[qi] = the leaves of the point tree within sqrt(r2[qi])
// of centres[qi], COUNT's counts with no early exit. inner and leaves are
// `wavefront_pack`'s point records; span: (n-1,) int32 range_right -
// range_left + 1; right: (n-1,) int32 right_child; centres (q, 3) and r2
// (q,) float32; out (q,) int32. With stats non-null the STATS instance
// also writes the (3, q) int32 counters: every lane's hops summed, the
// warp's longest chain of dependent hops, and the far tests.
int wavefront_sphere_count(const float* inner, const float* leaves, const int* span,
                           const int* right, int n, const float* centers, const float* r2,
                           int q, int* stats, int* out, cudaStream_t stream) {
  const SphereTree t{reinterpret_cast<const float4*>(inner),
                     reinterpret_cast<const float4*>(leaves), span, right, n};
  const int blocks = (q + kSphereWarps - 1) / kSphereWarps;
  if (stats) {
    sphere_count_kernel<true><<<blocks, kSphereWarps * kWarp, 0, stream>>>(t, centers, r2, q,
                                                                            stats, out);
  } else {
    sphere_count_kernel<false><<<blocks, kSphereWarps * kWarp, 0, stream>>>(t, centers, r2, q,
                                                                             stats, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// bin[i] = HISTOGRAM's bin of the squared distance d2[i], for n values.
int wavefront_bin_probe(const float* d2, int* bin, int n, float r_max, int n_bins,
                        cudaStream_t stream) {
  bin_probe_kernel<<<(n + kPackThreads - 1) / kPackThreads, kPackThreads, 0, stream>>>(
      d2, bin, n, r_max, n_bins);
  return static_cast<int>(cudaGetLastError());
}

// bin[i] = HISTOGRAM_PRIVATE's bin of d2[i] from the (n_bins - 1,)
// thresholds of (r_max, n_bins), for n values.
int wavefront_threshold_probe(const float* d2, int* bin, int n, const float* thresholds,
                              float r_max, int n_bins, cudaStream_t stream) {
  const float scale = static_cast<float>(n_bins) / r_max;
  threshold_probe_kernel<<<(n + kPackThreads - 1) / kPackThreads, kPackThreads,
                           (n_bins - 1) * sizeof(float), stream>>>(d2, bin, n, thresholds,
                                                                   n_bins, scale);
  return static_cast<int>(cudaGetLastError());
}

// y[i] = 1/sqrt(x[i]) by POTENTIAL's sequence, for n float32 values.
int wavefront_rsqrt_probe(const float* x, float* y, int n, cudaStream_t stream) {
  rsqrt_probe_kernel<<<(n + kPackThreads - 1) / kPackThreads, kPackThreads, 0, stream>>>(
      x, y, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
