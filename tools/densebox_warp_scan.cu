// DenseBox's kernel with a partial cell's run scanned by the whole warp, the
// design that `csrc/wavefront.cu`'s one-thread scan was measured against.
// Not built with the port: `tools/compare_densebox.py --warp-scan ROOT`
// splices it into a copy of ROOT's `csrc/wavefront.cu` in place of
// `dense_kernel` (it reads the same `DenseArgs` and scan records).

// The warp scans the run of each lane's partial cell (`pending` on that
// lane: the run [start, start + len) of `scan`, its centre and r2), one
// run after another: lane u tests point start + u in 32-point chunks, and
// the owner lane adds the hits (COUNT) or takes their least label to its
// carry. Every lane of the warp calls it, with or without a run of its own.
template <bool COUNT>
__device__ __forceinline__ void scan_runs(const float4* __restrict__ scan, bool pending,
                                          int start, int len, float cx, float cy, float cz,
                                          float r2, int& carry) {
  const int lane = threadIdx.x % kWarp;
  for (unsigned owners = __ballot_sync(kFullMask, pending); owners; owners &= owners - 1) {
    const int owner = __ffs(owners) - 1;
    const int s = __shfl_sync(kFullMask, start, owner);
    const int l = __shfl_sync(kFullMask, len, owner);
    const float ox = __shfl_sync(kFullMask, cx, owner);
    const float oy = __shfl_sync(kFullMask, cy, owner);
    const float oz = __shfl_sync(kFullMask, cz, owner);
    const float orr = __shfl_sync(kFullMask, r2, owner);
    int got = COUNT ? 0 : INT_MAX;
    for (int b = 0; b < l; b += kWarp) {
      bool in = false;
      int lab = INT_MAX;
      if (b + lane < l) {
        const float4 p = __ldg(scan + s + b + lane);
        in = sum_sq(__fsub_rn(p.x, ox), __fsub_rn(p.y, oy), __fsub_rn(p.z, oz)) <= orr;
        lab = in ? __float_as_int(p.w) : INT_MAX;
      }
      if constexpr (COUNT) {
        got += __popc(__ballot_sync(kFullMask, in));
      } else {
        got = min(got, __reduce_min_sync(kFullMask, lab));
      }
    }
    if (lane == owner) carry = COUNT ? carry + got : min(carry, got);
  }
}

// DenseBox's walk, one thread per query qi = order[i] on its tree of cell
// boxes and loose points (box leaf records), the rope walk of
// `wavefront_kernel` run while any lane of the warp walks. DENSE_COUNT:
// carry = points within r, a whole cell's or a point leaf's run length, a
// partial cell's points within r; done once a leaf hit brings it to
// stop_at. DENSE_MIN_LABEL: carry = the least label of the same, from
// `sentinel`. out[qi] is the carry, 0 or `sentinel` outside qmask.
template <int EPI>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dense_kernel(Tree t, const int* __restrict__ order, const float* __restrict__ centers,
             const float* __restrict__ r2s, int q, DenseArgs e, int* __restrict__ out) {
  static_assert(EPI == DENSE_COUNT || EPI == DENSE_MIN_LABEL, "DenseBox's epilogues only");
  constexpr bool kCount = EPI == DENSE_COUNT;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int init = kCount ? 0 : e.sentinel;
  int qi = -1;
  if (i < q) {
    qi = order ? __ldg(order + i) : static_cast<int>(i);
    if (e.qmask && !e.qmask[qi]) {
      out[qi] = init;
      qi = -1;
    }
  }
  float cx = 0.0f, cy = 0.0f, cz = 0.0f, r2 = 0.0f;
  if (qi >= 0) {
    cx = centers[3 * qi];
    cy = centers[3 * qi + 1];
    cz = centers[3 * qi + 2];
    r2 = r2s[qi];
  }
  const int first_leaf = t.n - 1;
  int node = qi >= 0 ? 0 : kSentinel;
  int carry = init;
  while (__any_sync(kFullMask, node != kSentinel)) {
    int next = kSentinel, start = 0, len = 0;
    bool leaf_hit = false, partial = false;
    if (node != kSentinel) {
      const bool leaf = node >= first_leaf;
      const int k = node - first_leaf;
      const float4* rec = leaf ? t.leaves + 2 * k : t.inner + 2 * node;
      const float4 lo = __ldg(rec);
      const float4 hi = __ldg(rec + 1);
      // A leaf's word is fetched with its record, not after the test.
      const int4 w = leaf ? __ldg(e.words + k) : make_int4(0, 0, 0, DENSE_POINT);
      const bool hit = point_box_dist2(cx, cy, cz, lo, hi) <= r2;
      // At a leaf both w lanes hold the rope.
      next = hit ? __float_as_int(lo.w) : __float_as_int(hi.w);
      leaf_hit = leaf && hit;
      if (leaf_hit && w.w == DENSE_CELL) {
        // The cell's farthest corner: |centre - mid| + half the cell a side.
        const float fx = __fadd_rn(fabsf(__fsub_rn(cx, __fmul_rn(__fadd_rn(lo.x, hi.x), 0.5f))),
                                   e.half);
        const float fy = __fadd_rn(fabsf(__fsub_rn(cy, __fmul_rn(__fadd_rn(lo.y, hi.y), 0.5f))),
                                   e.half);
        const float fz = __fadd_rn(fabsf(__fsub_rn(cz, __fmul_rn(__fadd_rn(lo.z, hi.z), 0.5f))),
                                   e.half);
        partial = !(sum_sq(fx, fy, fz) <= r2);
        start = w.x;
        len = w.y;
      }
      if (leaf_hit && !partial) carry = kCount ? carry + w.y : min(carry, w.z);
    }
    scan_runs<kCount>(e.scan, partial, start, len, cx, cy, cz, r2, carry);
    if (kCount && leaf_hit && carry >= e.stop_at) next = kSentinel;
    node = next;
  }
  if (qi >= 0) out[qi] = carry;
}
