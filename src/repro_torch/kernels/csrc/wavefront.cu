// Stackless rope traversal of the LBVH with a fused epilogue, for sm_90a.
//
// Replaces the Pallas TPU kernel `wavefront_traverse`
// (src/repro/kernels/wavefront.py:97) on the two passes of the FDBSCAN main
// path: the core test (`query_count(within, stop_at=min_pts)`) and the
// min-core-label union and border passes (`min_core_label_on`).
//
// The TPU kernel advances a block of 128 queries in lockstep, one rope hop
// per iteration, because a TPU core runs one wide instruction stream. On
// Hopper each query is its own thread, and a warp of 32 threads walks 32
// neighbouring queries: threads take queries in `order` (the tree's
// `leaf_perm` for a self-join, i.e. Morton order), so lanes of a warp follow
// nearly the same path and their node reads coalesce in L1/L2. Results go to
// each query's own row, so outputs stay positionally identical to the
// reference.
//
// What bounds it: dependent loads. Every hop reads one node box (24 bytes)
// and one rope or child index, and the next address depends on them. The
// node arrays are read-only, so they go through the non-coherent cache
// (`__ldg`). The work is data dependent: the hops each query needs.
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

enum Epilogue { COUNT = 0, MIN_LABEL = 1 };

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

// COUNT: carry = hits so far; done when it reaches stop_at (INT_MAX: never).
// MIN_LABEL: carry = min label over core objects hit; never done.
template <int EPI>
__global__ void __launch_bounds__(kThreads)
wavefront_kernel(Tree t, const int* __restrict__ order,
                 const float* __restrict__ centers, const float* __restrict__ r2,
                 int q, int stop_at, const int* __restrict__ obj_labels,
                 const bool* __restrict__ obj_core, const bool* __restrict__ qmask,
                 int sentinel, int* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= q) return;
  const int qi = order ? __ldg(order + lane) : lane;
  int carry = (EPI == COUNT) ? 0 : sentinel;
  if (EPI == MIN_LABEL && qmask && !qmask[qi]) {
    out[qi] = carry;
    return;
  }
  const float px = centers[3 * qi], py = centers[3 * qi + 1], pz = centers[3 * qi + 2];
  const float rr = r2[qi];
  const int first_leaf = t.n - 1;
  int node = 0;
  while (node != kSentinel) {
    const bool hit = point_box_dist2(px, py, pz, t.node_lo, t.node_hi, node) <= rr;
    if (node >= first_leaf) {
      if (hit) {
        if (EPI == COUNT) {
          ++carry;
          if (carry >= stop_at) break;
        } else {
          const int obj = __ldg(t.leaf_perm + (node - first_leaf));
          if (obj_core[obj]) carry = min(carry, __ldg(obj_labels + obj));
        }
      }
      node = __ldg(t.rope + node);
    } else {
      node = hit ? __ldg(t.left_child + node) : __ldg(t.rope + node);
    }
  }
  out[qi] = carry;
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
  const int blocks = (q + kThreads - 1) / kThreads;
  wavefront_kernel<COUNT><<<blocks, kThreads, 0, stream>>>(
      t, order, centers, r2, q, stop_at < 0 ? INT_MAX : stop_at, nullptr,
      nullptr, nullptr, 0, out);
  return static_cast<int>(cudaGetLastError());
}

int wavefront_min_label(const int* leaf_perm, const int* left_child, const int* rope,
                        const float* node_lo, const float* node_hi, int n,
                        const int* order, const float* centers, const float* r2,
                        int q, const int* obj_labels, const bool* obj_core,
                        const bool* qmask, int sentinel, int* out,
                        cudaStream_t stream) {
  const Tree t{leaf_perm, left_child, rope, node_lo, node_hi, n};
  const int blocks = (q + kThreads - 1) / kThreads;
  wavefront_kernel<MIN_LABEL><<<blocks, kThreads, 0, stream>>>(
      t, order, centers, r2, q, 0, obj_labels, obj_core, qmask, sentinel, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
