// Stackless rope traversal of the LBVH with a fused epilogue, for sm_90a.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/wavefront.py:
//   * `wavefront_traverse` (:97) on the two passes of the FDBSCAN main path,
//     the core test (`query_count(within, stop_at=min_pts)`, epilogue COUNT)
//     and the min-core-label union and border passes (`min_core_label_on`,
//     epilogue MIN_LABEL), and on the fixed-buffer protocol `query_fixed`
//     (epilogue FIXED);
//   * `wavefront_fill_round` (:245), the fill pass of the count-then-fill
//     CSR protocol `query_csr_device` (epilogue FILL).
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
// What bounds it: dependent loads. Every hop reads one node box (24 bytes)
// and one rope or child index, and the next address depends on them. The
// node arrays are read-only, so they go through the non-coherent cache
// (`__ldg`). The work is data dependent: the hops each query needs. FILL and
// FIXED add one 4-byte store per hit; in a self-join a warp's 32 queries
// own 32 rows far apart in the output, so each store instruction touches up
// to 32 sectors (left as it is, and measured).
//
// Exactness: the hop rule is `_one_stackless` (src/repro/core/query.py:182):
// at a leaf, run the leaf test, the epilogue only on a hit, then follow the
// rope; at an internal node, descend to `left_child` if the point-box
// distance is within r^2, else follow the rope; stop when the epilogue says
// done. The distance is summed as ((dx*dx + dy*dy) + dz*dz) with
// round-to-nearest intrinsics, so no multiply-add is contracted and the
// result rounds as the reference's left-to-right float32 sum.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kSentinel = -1;
constexpr int kThreads = 128;

enum Epilogue { COUNT = 0, MIN_LABEL = 1, FILL = 2, FIXED = 3 };

__device__ __forceinline__ float axis_gap(float p, float lo, float hi) {
  return fmaxf(fmaxf(__fsub_rn(lo, p), __fsub_rn(p, hi)), 0.0f);
}

__device__ __forceinline__ float point_box_dist2(float px, float py, float pz,
                                                 const float* __restrict__ lo,
                                                 const float* __restrict__ hi,
                                                 int node) {
  const float dx = axis_gap(px, __ldg(lo + 3 * node), __ldg(hi + 3 * node));
  const float dy = axis_gap(py, __ldg(lo + 3 * node + 1), __ldg(hi + 3 * node + 1));
  const float dz = axis_gap(pz, __ldg(lo + 3 * node + 2), __ldg(hi + 3 * node + 2));
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

struct Tree {
  const int* leaf_perm;
  const int* left_child;
  const int* rope;
  const float* node_lo;
  const float* node_hi;
  int n;
};

// What each epilogue reads besides the tree and the queries; an
// instantiation reads only its own fields.
template <typename Off>
struct Epi {
  int stop_at;              // COUNT: early exit at this count (INT_MAX: never)
  const int* obj_labels;    // MIN_LABEL: label per object
  const bool* obj_core;     // MIN_LABEL: core flag per object
  const bool* qmask;        // MIN_LABEL: queries to run (null: all)
  int sentinel;             // MIN_LABEL: result where no core object is hit
  const Off* offsets;       // FILL: row start per query
  long long capacity;       // FILL: length of `indices`; FIXED: row width
  int* indices;             // FILL: (capacity,); FIXED: (q, capacity)
};

// COUNT: carry = hits so far; done when it reaches stop_at.
// MIN_LABEL: carry = min label over core objects hit; never done.
// FILL: writes hits at offsets[qi] + k below capacity; done at capacity.
// FIXED: carry = hits so far; hit k goes to slot min(k, capacity - 1).
// `out[qi]` receives the carry (FILL has none and writes no `out`).
template <int EPI, typename Off>
__global__ void __launch_bounds__(kThreads)
wavefront_kernel(Tree t, const int* __restrict__ order,
                 const float* __restrict__ centers, const float* __restrict__ r2,
                 int q, Epi<Off> e, int* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= q) return;
  const int qi = order ? __ldg(order + lane) : lane;
  int carry = (EPI == MIN_LABEL) ? e.sentinel : 0;
  long long pos = 0;
  if constexpr (EPI == MIN_LABEL) {
    if (e.qmask && !e.qmask[qi]) {
      out[qi] = carry;
      return;
    }
  }
  if constexpr (EPI == FILL) {
    pos = static_cast<long long>(e.offsets[qi]);
    if (pos >= e.capacity) return;
  }
  const float px = centers[3 * qi], py = centers[3 * qi + 1], pz = centers[3 * qi + 2];
  const float rr = r2[qi];
  const int first_leaf = t.n - 1;
  int node = 0;
  while (node != kSentinel) {
    const bool hit = point_box_dist2(px, py, pz, t.node_lo, t.node_hi, node) <= rr;
    if (node >= first_leaf) {
      if (hit) {
        if constexpr (EPI == COUNT) {
          ++carry;
          if (carry >= e.stop_at) break;
        } else if constexpr (EPI == MIN_LABEL) {
          const int obj = __ldg(t.leaf_perm + (node - first_leaf));
          if (e.obj_core[obj]) carry = min(carry, __ldg(e.obj_labels + obj));
        } else if constexpr (EPI == FILL) {
          e.indices[pos] = __ldg(t.leaf_perm + (node - first_leaf));
          if (++pos >= e.capacity) break;
        } else {
          if (e.capacity > 0) {
            const long long slot = min(static_cast<long long>(carry), e.capacity - 1);
            e.indices[static_cast<long long>(qi) * e.capacity + slot] =
                __ldg(t.leaf_perm + (node - first_leaf));
          }
          ++carry;
        }
      }
      node = __ldg(t.rope + node);
    } else {
      node = hit ? __ldg(t.left_child + node) : __ldg(t.rope + node);
    }
  }
  if constexpr (EPI != FILL) out[qi] = carry;
}

template <int EPI, typename Off>
int launch(const Tree& t, const int* order, const float* centers, const float* r2,
           int q, const Epi<Off>& e, int* out, cudaStream_t stream) {
  const int blocks = (q + kThreads - 1) / kThreads;
  wavefront_kernel<EPI, Off><<<blocks, kThreads, 0, stream>>>(t, order, centers, r2,
                                                               q, e, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// stop_at < 0 means no early exit.
int wavefront_count(const int* leaf_perm, const int* left_child, const int* rope,
                    const float* node_lo, const float* node_hi, int n,
                    const int* order, const float* centers, const float* r2, int q,
                    int stop_at, int* out, cudaStream_t stream) {
  const Tree t{leaf_perm, left_child, rope, node_lo, node_hi, n};
  Epi<int> e{};
  e.stop_at = stop_at < 0 ? INT_MAX : stop_at;
  return launch<COUNT>(t, order, centers, r2, q, e, out, stream);
}

int wavefront_min_label(const int* leaf_perm, const int* left_child, const int* rope,
                        const float* node_lo, const float* node_hi, int n,
                        const int* order, const float* centers, const float* r2,
                        int q, const int* obj_labels, const bool* obj_core,
                        const bool* qmask, int sentinel, int* out,
                        cudaStream_t stream) {
  const Tree t{leaf_perm, left_child, rope, node_lo, node_hi, n};
  Epi<int> e{};
  e.obj_labels = obj_labels;
  e.obj_core = obj_core;
  e.qmask = qmask;
  e.sentinel = sentinel;
  return launch<MIN_LABEL>(t, order, centers, r2, q, e, out, stream);
}

// offsets: (q + 1,) int32 (offsets_64 == 0) or int64; indices: (capacity,)
// int32, set to -1 by the caller.
int wavefront_fill(const int* leaf_perm, const int* left_child, const int* rope,
                   const float* node_lo, const float* node_hi, int n,
                   const int* order, const float* centers, const float* r2, int q,
                   const void* offsets, int offsets_64, long long capacity,
                   int* indices, cudaStream_t stream) {
  const Tree t{leaf_perm, left_child, rope, node_lo, node_hi, n};
  if (offsets_64) {
    Epi<long long> e{};
    e.offsets = static_cast<const long long*>(offsets);
    e.capacity = capacity;
    e.indices = indices;
    return launch<FILL>(t, order, centers, r2, q, e, nullptr, stream);
  }
  Epi<int> e{};
  e.offsets = static_cast<const int*>(offsets);
  e.capacity = capacity;
  e.indices = indices;
  return launch<FILL>(t, order, centers, r2, q, e, nullptr, stream);
}

// buf: (q, capacity) int32, set to -1 by the caller; counts: (q,) int32.
int wavefront_fixed(const int* leaf_perm, const int* left_child, const int* rope,
                    const float* node_lo, const float* node_hi, int n,
                    const int* order, const float* centers, const float* r2, int q,
                    long long capacity, int* buf, int* counts, cudaStream_t stream) {
  const Tree t{leaf_perm, left_child, rope, node_lo, node_hi, n};
  Epi<int> e{};
  e.capacity = capacity;
  e.indices = buf;
  return launch<FIXED>(t, order, centers, r2, q, e, counts, stream);
}

}  // extern "C"
