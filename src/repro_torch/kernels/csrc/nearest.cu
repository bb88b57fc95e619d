// Ordered-stack nearest walks of the LBVH, for sm_90a: k nearest
// neighbours (KNN), the nearest point of another component (EMST) and the
// nearest ray hit (RAY), one template `nearest_kernel<EPI>`.
//
// Replaces no Pallas TPU kernel: the reference runs these walks as vmapped
// `while_loop`s that XLA fuses into one loop on the device,
// `traverse_nearest_stack` (src/repro/core/query.py:429-484) under
// `_nearest_batched` (:767-791) and EMST's `_nearest_other_component`
// (src/repro/core/emst.py:57-78), and `_ray_batched` (query.py:844-886).
// In PyTorch the same lockstep walk costs a launch per op per hop and a
// host sync per hop to end the loop (the port's generic engine took
// 10.06 s for 64 rays on a tree of 2^24 boxes on an H100 80GB HBM3,
// `chip_smoke.py` phase 11), so a self-query of 2^24 points would not
// finish in any useful time. This kernel is that walk, one thread per
// query.
//
// The walk (`traverse_nearest_stack`): the thread pops a node from its
// stack of kStack int32 nodes in local memory. At a leaf it runs the
// epilogue's leaf update with the leaf box's squared distance; at an
// internal node it computes both children's d^2, takes near = left where
// dl <= dr, and pushes the far child, then the near one, each where the
// epilogue's gate passes on the carry as it stands at that node. A popped
// node is not tested again against the tightened bound (the reference's
// is not). The ray walk (`_ray_batched`) slab-tests the popped node: a
// leaf hit at a t below the best becomes the best; an internal node so hit
// pushes its right child, then its left, each where it is hit below the
// best t. A tree's height bounds the stack at height + 1 nodes, and the
// wrapper raises for a tree 96 levels deep or deeper.
//
// Epilogues:
//   * KNN: a k-slot buffer of (d^2, index), unsorted as the reference keeps
//     it: `worst` is the first slot holding the maximum; a leaf replaces it
//     where d2 < its d^2, and a child is pushed where d2 < the maximum. At
//     the end the slots are sorted by d^2, stably in slot order (insertion
//     sort, as `jnp.argsort`), and the distances are the correctly rounded
//     square roots. Up to kLocalK slots live in local memory; past that the
//     buffer is the query's output rows, so any k <= n works.
//   * EMST: per query its component; a child is pushed where d2 < best and
//     its component interval {min, max} is not {comp, comp}; a leaf is taken
//     where d2 < best and its object's component differs. (d^2, index),
//     (inf, -1) where no other component exists.
//   * RAY: on point and box leaves alike; (index, t), (-1, inf) on a miss.
//
// Node records (`nearest_records`, 32 bytes a node, two float4):
// {lo.xyz, bits(a)} {hi.xyz, bits(b)}, (a, b) the children of an internal
// node, leaf_perm[k] twice at leaf k. A pop reads its record with two
// 16-byte loads; an internal KNN/EMST pop then reads both children's
// records together (four loads), so each internal hop is two dependent
// fetches, a leaf hop one (EMST adds its object's component where d2 is
// below the best). The KNN buffer and the stack sit in local memory, which
// the L1 and L2 caches back.
//
// What bounds it: on an H100 80GB HBM3 at 700 W (`chip_smoke.py` phase
// 14, 2^24 Plummer particles) KNN at k = 16 pops 2.7e9 nodes in about
// 50 ms (55 Gpops/s) and EMST a round's 1.5e9 in about 16 ms (91
// Gpops/s), some 50x and 30x their bytes bounds, where the rope walk of
// csrc/wavefront.cu runs at about 300 Ghops/s. Likely (not measured: no
// hardware counter was read) the dependent fetches of the walk and the
// local-memory traffic of the stack and the buffer, with less coherence
// between the lanes of a warp, since ordered walks of neighbouring
// queries part ways sooner than rope walks. A simple, correct kernel
// first: a warp per heavy query, a stack in shared memory or an L2 window
// are later work. `pops` (optional) gets each query's popped nodes, the
// work the bound counts.
//
// Exactness: each distance and slab test equals its plain version
// (`kernels/nearest.py`, `core/geometry.py`) bit for bit: products and sums
// are round-to-nearest intrinsics summed ((x*x + y*y) + z*z), so no
// multiply-add is contracted and the SASS holds no FFMA; each product
// flushes a subnormal result to zero as XLA:CPU does (ROADMAP C7), and the
// slab test flushes its inputs and differences too; min and max propagate
// NaN, as torch's and XLA's. The square root is taken in double and
// rounded once to float, which gives the correctly rounded float root (the
// plain version's float64 step), with no FFMA.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cfloat>

namespace {

constexpr int kStack = 96;
constexpr int kThreads = 256;
constexpr int kLocalK = 32;

enum Epilogue { KNN = 0, EMST = 1, RAY = 2 };

// max and min that propagate NaN (either operand), as XLA's and torch's.
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

// A subnormal value to a zero of its sign, as XLA:CPU flushes it.
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x;
}

// d * d, flushed; a square is never negative.
__device__ __forceinline__ float sq(float d) {
  const float p = __fmul_rn(d, d);
  return p < FLT_MIN ? 0.0f : p;
}

// max(a - b, c - d, 0), the gap of one axis.
__device__ __forceinline__ float gap(float a, float b, float c, float d) {
  return max_nan(max_nan(__fsub_rn(a, b), __fsub_rn(c, d)), 0.0f);
}

// Squared distance from (px, py, pz) to the box [lo.xyz, hi.xyz].
__device__ __forceinline__ float dist2(float px, float py, float pz, const float4& lo,
                                       const float4& hi) {
  return __fadd_rn(__fadd_rn(sq(gap(lo.x, px, px, hi.x)), sq(gap(lo.y, py, py, hi.y))),
                   sq(gap(lo.z, pz, pz, hi.z)));
}

// Slab entry or exit of one axis: (lo - o) * inv.
__device__ __forceinline__ float slab(float lo, float o, float inv) {
  return flush(__fmul_rn(flush(__fsub_rn(flush(lo), o)), inv));
}

// `ray_box`: whether the ray hits the box, with t = tmin where tmin > 0 or
// is NaN, else +0 (the entry parameter). The origin comes flushed.
__device__ __forceinline__ bool ray_box(float ox, float oy, float oz, float ix, float iy,
                                        float iz, const float4& lo, const float4& hi,
                                        float& t) {
  const float ax = slab(lo.x, ox, ix), bx = slab(hi.x, ox, ix);
  const float ay = slab(lo.y, oy, iy), by = slab(hi.y, oy, iy);
  const float az = slab(lo.z, oz, iz), bz = slab(hi.z, oz, iz);
  const float tmin = max_nan(max_nan(min_nan(ax, bx), min_nan(ay, by)), min_nan(az, bz));
  const float tmax = min_nan(min_nan(max_nan(ax, bx), max_nan(ay, by)), max_nan(az, bz));
  t = (tmin > 0.0f || tmin != tmin) ? tmin : 0.0f;
  return tmax >= t;
}

struct Args {
  const float4* rec;     // (2n-1) x 2 node records
  int n;                 // leaves
  const int* order;      // (q,) the query each thread takes (null: its own)
  const float* qa;       // (q, 3) centres (KNN, EMST) or origins (RAY)
  const float* qb;       // RAY: (q, 3) inverse directions
  int q;
  int k;                 // KNN: slots per query
  int* idx;              // KNN: (q, k); EMST, RAY: (q,)
  float* val;            // KNN: (q, k) distances; EMST: (q,) d^2; RAY: (q,) t
  const int* qcomp;      // EMST: (q,) the query's component
  const int* comp;       // EMST: (n,) component by object
  const int2* interval;  // EMST: (2n-1,) {least, largest} component below
  int* pops;             // (q,) nodes popped, or null
};

template <int EPI>
__global__ void __launch_bounds__(kThreads) nearest_kernel(Args a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.q) return;
  const long long qi = a.order ? __ldg(a.order + lane) : lane;
  float px = a.qa[3 * qi], py = a.qa[3 * qi + 1], pz = a.qa[3 * qi + 2];
  float ix = 0.0f, iy = 0.0f, iz = 0.0f;
  if constexpr (EPI == RAY) {
    px = flush(px), py = flush(py), pz = flush(pz);
    ix = a.qb[3 * qi], iy = a.qb[3 * qi + 1], iz = a.qb[3 * qi + 2];
  }
  const int first_leaf = a.n - 1;
  int stack[kStack];
  int sp = 0;
  stack[sp++] = 0;
  int pops = 0;

  // KNN's buffer: in local memory up to kLocalK slots, else the output rows.
  float local_d[EPI == KNN ? kLocalK : 1];
  int local_i[EPI == KNN ? kLocalK : 1];
  float* D = nullptr;
  int* I = nullptr;
  int worst = 0;
  float worst_d = CUDART_INF_F;
  // EMST and RAY: the best d^2 or t and its object.
  float best = CUDART_INF_F;
  int best_i = -1;
  int my = 0;
  if constexpr (EPI == KNN) {
    const bool local = a.k <= kLocalK;
    D = local ? local_d : a.val + qi * a.k;
    I = local ? local_i : a.idx + qi * a.k;
    for (int s = 0; s < a.k; ++s) {
      D[s] = CUDART_INF_F;
      I[s] = -1;
    }
  }
  if constexpr (EPI == EMST) my = __ldg(a.qcomp + qi);

  while (sp > 0) {
    const int node = stack[--sp];
    ++pops;
    const float4 lo = __ldg(a.rec + 2LL * node);
    const float4 hi = __ldg(a.rec + 2LL * node + 1);
    const bool leaf = node >= first_leaf;
    if constexpr (EPI == RAY) {
      float t;
      if (!ray_box(px, py, pz, ix, iy, iz, lo, hi, t) || !(t < best)) continue;
      if (leaf) {
        best = t;
        best_i = __float_as_int(lo.w);
        continue;
      }
      const int l = __float_as_int(lo.w), r = __float_as_int(hi.w);
      const float4 rlo = __ldg(a.rec + 2LL * r), rhi = __ldg(a.rec + 2LL * r + 1);
      const float4 llo = __ldg(a.rec + 2LL * l), lhi = __ldg(a.rec + 2LL * l + 1);
      float tr, tl;
      if (ray_box(px, py, pz, ix, iy, iz, rlo, rhi, tr) && tr < best) stack[sp++] = r;
      if (ray_box(px, py, pz, ix, iy, iz, llo, lhi, tl) && tl < best) stack[sp++] = l;
    } else {
      if (leaf) {
        const float d2 = dist2(px, py, pz, lo, hi);
        const int obj = __float_as_int(lo.w);
        if constexpr (EPI == KNN) {
          if (d2 < worst_d) {
            D[worst] = d2;
            I[worst] = obj;
            worst = 0;
            worst_d = D[0];
            for (int s = 1; s < a.k; ++s) {
              if (D[s] > worst_d) {
                worst_d = D[s];
                worst = s;
              }
            }
          }
        } else if (d2 < best && __ldg(a.comp + obj) != my) {
          best = d2;
          best_i = obj;
        }
        continue;
      }
      const int l = __float_as_int(lo.w), r = __float_as_int(hi.w);
      const float4 llo = __ldg(a.rec + 2LL * l), lhi = __ldg(a.rec + 2LL * l + 1);
      const float4 rlo = __ldg(a.rec + 2LL * r), rhi = __ldg(a.rec + 2LL * r + 1);
      const float dl = dist2(px, py, pz, llo, lhi);
      const float dr = dist2(px, py, pz, rlo, rhi);
      const bool left_near = dl <= dr;
      const int near = left_near ? l : r, far = left_near ? r : l;
      const float d_near = min_nan(dl, dr), d_far = max_nan(dl, dr);
      if constexpr (EPI == KNN) {
        if (d_far < worst_d) stack[sp++] = far;
        if (d_near < worst_d) stack[sp++] = near;
      } else {
        if (d_far < best) {
          const int2 iv = __ldg(a.interval + far);
          if (!(iv.x == iv.y && iv.x == my)) stack[sp++] = far;
        }
        if (d_near < best) {
          const int2 iv = __ldg(a.interval + near);
          if (!(iv.x == iv.y && iv.x == my)) stack[sp++] = near;
        }
      }
    }
  }

  if (a.pops) a.pops[qi] = pops;
  if constexpr (EPI == KNN) {
    // Stable insertion sort by d^2: equal values keep their slot order.
    for (int s = 1; s < a.k; ++s) {
      const float d = D[s];
      const int i = I[s];
      int u = s;
      while (u > 0 && D[u - 1] > d) {
        D[u] = D[u - 1];
        I[u] = I[u - 1];
        --u;
      }
      D[u] = d;
      I[u] = i;
    }
    float* out_d = a.val + qi * a.k;
    int* out_i = a.idx + qi * a.k;
    for (int s = 0; s < a.k; ++s) {
      out_i[s] = I[s];
      out_d[s] = __double2float_rn(__dsqrt_rn(static_cast<double>(D[s])));
    }
  } else {
    a.idx[qi] = best_i;
    a.val[qi] = best;
  }
}

template <int EPI>
int launch(const Args& a, cudaStream_t stream) {
  const int blocks = (a.q + kThreads - 1) / kThreads;
  nearest_kernel<EPI><<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args args(const float* rec, int n, const int* order, const float* qa, int q) {
  Args a{};
  a.rec = reinterpret_cast<const float4*>(rec);
  a.n = n;
  a.order = order;
  a.qa = qa;
  a.q = q;
  return a;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// In every entry, rec is `nearest_records` ((2n-1, 8) float32, 16-byte
// aligned), order the thread order of the q queries (or null), qa their
// (q, 3) centres or origins, and pops (q,) int32 nodes popped (or null).

// KNN. idx: (q, k) int32; dist: (q, k) float32; k >= 1.
int nearest_knn(const float* rec, int n, const int* order, const float* qa, int q, int k,
                int* idx, float* dist, int* pops, cudaStream_t stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a = args(rec, n, order, qa, q);
  a.k = k;
  a.idx = idx;
  a.val = dist;
  a.pops = pops;
  return launch<KNN>(a, stream);
}

// EMST. qcomp: (q,) int32; comp: (n,) int32 by object; interval: (2n-1, 2)
// int32; idx: (q,) int32; d2: (q,) float32.
int nearest_emst(const float* rec, int n, const int* order, const float* qa, int q,
                 const int* qcomp, const int* comp, const int* interval, int* idx, float* d2,
                 int* pops, cudaStream_t stream) {
  Args a = args(rec, n, order, qa, q);
  a.qcomp = qcomp;
  a.comp = comp;
  a.interval = reinterpret_cast<const int2*>(interval);
  a.idx = idx;
  a.val = d2;
  a.pops = pops;
  return launch<EMST>(a, stream);
}

// RAY. inv: (q, 3) float32 inverse directions; idx: (q,) int32; t: (q,)
// float32.
int nearest_ray(const float* rec, int n, const int* order, const float* qa, const float* inv,
                int q, int* idx, float* t, int* pops, cudaStream_t stream) {
  Args a = args(rec, n, order, qa, q);
  a.qb = inv;
  a.idx = idx;
  a.val = t;
  a.pops = pops;
  return launch<RAY>(a, stream);
}

}  // extern "C"
