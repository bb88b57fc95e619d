// Segmented sum and max over sorted segment ids, for sm_90a.
//
// Replaces the Pallas TPU kernels `segment_sum_sorted` and
// `segment_max_sorted` (src/repro/kernels/segment.py:106 and :133), the
// halo catalog's per-halo reductions: out[s, :] = reduce of data[i, :] over
// rows i with clip(seg[i]) == s, ids clipped to [0, S) and sorted
// ascending. Rows of one segment are therefore contiguous: a segment is one
// run of rows. The output is filled by the caller (0 for sum, -1e30 for
// max), so empty segments are never written.
//
// What bounds it: bytes. The reduction reads each input byte once and does
// one add (or max) per element, about 0.5 operations a byte, far below the
// card's ratio of float32 operations to bytes. At the in-situ step's
// 2^24 x 8 sums the data is 512 MiB and the bound 0.19 ms at 3.35 TB/s.
//
// What the design does about it (the TPU kernel's one-hot MXU product has no
// place here):
//
// 1. A block owns kChunk = 256 x 8 consecutive rows, a thread 8 consecutive
//    rows of them. At D = 8 the block first copies its 64 KiB of rows into
//    shared memory with 16-byte loads, neighbouring threads on neighbouring
//    addresses (a thread's rows sit 17 float4 apart there, so the threads'
//    later 16-byte reads hit distinct banks); at D = 1 a thread's 8 rows are
//    two 16-byte loads. Ids come in 16-byte loads too. Other widths, or
//    inputs not 16-byte aligned, take the scalar instance (D = 0: the width
//    at run time, one column at a time, scalar loads), same logic.
// 2. A thread reduces its rows serially in registers as runs of equal id.
//    Run boundaries come from the ids once per row, not once per column. A
//    run that starts and ends inside the thread is complete: plain store.
// 3. The thread's first run (head) and last run (tail) may continue into
//    its neighbours. One segmented scan over the block's threads combines
//    the tails: a ballot of segment-start flags gives each lane the start
//    of its segment, so the 5 shuffle steps move only the values; warp
//    totals are combined across the 8 warps through shared memory in warp
//    order. A run that ends in the block is then stored by the thread where
//    it ends, with a plain store: no atomics.
// 4. Only the block's first run and last run can continue past the block.
//    Their partials go to two carry records a block (id, D values; id -1 for
//    none). The records of all blocks are, in block order, a sorted segmented
//    reduction of their own, which the same kernel reduces again (a second
//    launch of 2 n / kChunk rows, a third of a few rows at n = 2^24) until
//    one block holds a level. A run that crosses blocks is stored once, by
//    the level where it ends inside a block.
//
// Every output element is written by one thread, after a combination in an
// order fixed by n alone, so the same inputs give the same bits on every
// call. The sum is within float32 rounding of a serial sum; its count column
// (1.0 per row) is exact below 2^24 rows a segment. The max is exact.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                   // rows a thread reduces serially
constexpr int kChunk = kThreads * kRows;   // rows a block owns
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegBig = -1e30f;          // -SEG_NEG_BIG, the max's empty value
constexpr int kNone = INT_MIN;             // id of a thread without rows
static_assert(kRows % 4 == 0, "a thread's ids are whole 16-byte loads");

enum Op { SUM = 0, MAX = 1 };

template <int OP>
__device__ __forceinline__ float neutral() {
  return OP == SUM ? 0.0f : kNegBig;
}

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  return OP == SUM ? a + b : fmaxf(a, b);
}

// One level of the reduction: `n` rows of `d` floats and their ids.
struct Level {
  const float* data;
  const int* ids;
  int64_t n;
  int d;
  int clip;         // > 0: ids clipped to [0, clip) (the caller's rows); 0: as given
  float* out;       // (S, d), filled by the caller
  float* rec_vals;  // (2 blocks, d) carry records; null when one block holds the level
  int* rec_ids;     // (2 blocks,)
};

__device__ __forceinline__ int clip_id(int v, int clip) {
  return clip > 0 ? min(max(v, 0), clip - 1) : v;
}

template <typename T> struct Vec4;
template <> struct Vec4<int> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

// A thread's kRows consecutive values at p (nv of them valid), as 16-byte
// loads where VEC and all are valid.
template <bool VEC, typename T>
__device__ __forceinline__ void load_rows(const T* p, int nv, T (&v)[kRows]) {
  if (VEC && nv == kRows) {
    using V = typename Vec4<T>::type;
#pragma unroll
    for (int k = 0; k < kRows / 4; ++k) {
      const V q = __ldg(reinterpret_cast<const V*>(p) + k);
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = r < nv ? __ldg(p + r) : T(0);
  }
}

// Writes the W values of v to dst (16-byte stores for D = 8).
template <int D, int W>
__device__ __forceinline__ void put(float* dst, const float (&v)[W]) {
  if constexpr (D == 8) {
    float4* q = reinterpret_cast<float4*>(dst);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) dst[c] = v[c];
  }
}

// D = 8 and D = 1 with 16-byte aligned rows and ids (VEC), or any width at
// run time (D = 0, scalar). W columns are reduced at a time.
template <int OP, int D, bool VEC>
__global__ void __launch_bounds__(kThreads) segment_kernel(Level a) {
  constexpr int W = D == 0 ? 1 : D;
  constexpr bool kStaged = VEC && D > 1;     // rows copied to shared memory
  constexpr int kF = kRows * W / 4;          // float4s of a thread's rows (staged)
  extern __shared__ float4 stage[];          // kThreads x (kF + 1) float4
  __shared__ int warp_first[kWarps], warp_last[kWarps];
  __shared__ float warp_sum[kWarps][W];
  __shared__ bool warp_open[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = D ? D : a.d;
  const int64_t blk = blockIdx.x;
  const int64_t base = blk * kChunk;
  const int rows = static_cast<int>(min(static_cast<int64_t>(kChunk), a.n - base));
  const int64_t row0 = base + static_cast<int64_t>(tid) * kRows;
  const int nv = max(0, min(kRows, rows - tid * kRows));

  if constexpr (kStaged) {
    // The block's rows, contiguous in memory, copied with coalesced 16-byte
    // loads; float4 m belongs to thread m / kF and lands after one float4 of
    // padding per thread.
    const float4* src = reinterpret_cast<const float4*>(a.data + base * W);
    const int n4 = rows * W / 4;
    constexpr int kPer = kF;                 // float4s each thread copies
    constexpr int kBatch = kPer < 8 ? kPer : 8;
#pragma unroll
    for (int k0 = 0; k0 < kPer; k0 += kBatch) {
      float4 buf[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int m = tid + (k0 + j) * kThreads;
        if (m < n4) buf[j] = __ldg(src + m);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int m = tid + (k0 + j) * kThreads;
        if (m < n4) stage[m + m / kF] = buf[j];
      }
    }
  }
  float x[kRows];                            // D = 1 (VEC): the thread's values
  if (VEC && D == 1) load_rows<true>(a.data + row0, nv, x);

  int id[kRows];
  load_rows<VEC>(a.ids + row0, nv, id);
#pragma unroll
  for (int r = 0; r < kRows; ++r) id[r] = clip_id(id[r], a.clip);

  // The block's first and last run (same for every thread).
  const int f = clip_id(__ldg(a.ids + base), a.clip);
  const int z = clip_id(__ldg(a.ids + base + rows - 1), a.clip);
  const bool open_l = blk > 0 && clip_id(__ldg(a.ids + base - 1), a.clip) == f;
  const bool open_r = base + rows < a.n && clip_id(__ldg(a.ids + base + rows), a.clip) == z;
  const bool single = f == z;
  // A run that continues past the block goes to the carry records; runs of
  // a negative id (an empty record) are never stored.
  const bool pend_first = f >= 0 && (open_l || (single && open_r));
  const bool pend_last = z >= 0 && open_r && !single;

  unsigned bounds = 0;                       // bit r: row r starts a new run
  int lid = kNone;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < nv) {
      if (r > 0 && id[r] != id[r - 1]) bounds |= 1u << r;
      lid = id[r];
    }
  }
  const int fid = nv ? id[0] : kNone;
  int prev_lid = __shfl_up_sync(kFull, lid, 1);
  int next_fid = __shfl_down_sync(kFull, fid, 1);
  if (lane == 0) warp_first[warp] = fid;
  if (lane == 31) warp_last[warp] = lid;
  __syncthreads();
  if (lane == 0) prev_lid = warp > 0 ? warp_last[warp - 1] : kNone;
  if (lane == 31) next_fid = warp < kWarps - 1 ? warp_first[warp + 1] : kNone;
  const bool cont = fid != kNone && fid == prev_lid;   // head continues the previous thread
  const bool multi = bounds != 0;
  const bool ends = lid != kNone && lid != next_fid;    // tail ends at the thread's last row
  // A segment of the scan starts at a thread whose tail run starts in it.
  const unsigned starts = __ballot_sync(kFull, !cont || multi);
  const unsigned below = starts & (kFull >> (31 - lane));
  const int seg_lo = below ? 31 - __clz(below) : -1;  // -1: starts before the warp

  for (int col0 = 0; col0 < d; col0 += W) {
    // A run that ends here: to the records if it continues past the block,
    // else a plain store.
    auto finish = [&](int s, const float (&v)[W]) {
      if (s == f && pend_first) {
        put<D>(a.rec_vals + 2 * blk * d + col0, v);
        a.rec_ids[2 * blk] = f;
        if (single) {
          float e[W];
#pragma unroll
          for (int c = 0; c < W; ++c) e[c] = neutral<OP>();
          put<D>(a.rec_vals + (2 * blk + 1) * d + col0, e);
          a.rec_ids[2 * blk + 1] = f;
        }
      } else if (s == z && pend_last) {
        put<D>(a.rec_vals + (2 * blk + 1) * d + col0, v);
        a.rec_ids[2 * blk + 1] = z;
      } else if (s >= 0) {
        put<D>(a.out + static_cast<int64_t>(s) * d + col0, v);
      }
    };
    if (tid == 0 && a.rec_ids != nullptr) {  // record slots no run fills
      float e[W];
#pragma unroll
      for (int c = 0; c < W; ++c) e[c] = neutral<OP>();
      if (!pend_first) {
        put<D>(a.rec_vals + 2 * blk * d + col0, e);
        a.rec_ids[2 * blk] = -1;
      }
      if (!pend_last && !(single && pend_first)) {
        put<D>(a.rec_vals + (2 * blk + 1) * d + col0, e);
        a.rec_ids[2 * blk + 1] = -1;
      }
    }

    // Serial pass over the thread's rows: head holds the first run once a
    // boundary passed, runs between two boundaries are stored, acc ends as
    // the tail run.
    float acc[W], head[W];
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = head[c] = neutral<OP>();
    bool seen = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nv) {
        if (bounds >> r & 1u) {
          if (!seen) {
#pragma unroll
            for (int c = 0; c < W; ++c) head[c] = acc[c];
          } else {
            finish(id[r - 1], acc);
          }
          seen = true;
#pragma unroll
          for (int c = 0; c < W; ++c) acc[c] = neutral<OP>();
        }
        float v[W];
        if constexpr (kStaged) {
          const float4* p = stage + tid * (kF + 1) + r * (W / 4);
#pragma unroll
          for (int q = 0; q < W / 4; ++q) {
            const float4 t = p[q];
            v[4 * q] = t.x;
            v[4 * q + 1] = t.y;
            v[4 * q + 2] = t.z;
            v[4 * q + 3] = t.w;
          }
        } else if constexpr (VEC) {
          v[0] = x[r];
        } else {
          v[0] = __ldg(a.data + (row0 + r) * d + col0);
        }
#pragma unroll
        for (int c = 0; c < W; ++c) acc[c] = combine<OP>(acc[c], v[c]);
      }
    }

    // Segmented inclusive scan of the tails over the block's threads.
    float s[W];
#pragma unroll
    for (int c = 0; c < W; ++c) s[c] = acc[c];
    const int lo = seg_lo < 0 ? 0 : seg_lo;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int c = 0; c < W; ++c) {
        const float up = __shfl_up_sync(kFull, s[c], off);
        if (lane - off >= lo) s[c] = combine<OP>(up, s[c]);
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int c = 0; c < W; ++c) warp_sum[warp][c] = s[c];
      warp_open[warp] = starts == 0;
    }
    __syncthreads();
    // The block-inclusive value at the previous warp's last lane: warp sums
    // folded in warp order from the last warp with a segment start.
    float carry[W];
#pragma unroll
    for (int c = 0; c < W; ++c) carry[c] = neutral<OP>();
    if (warp > 0) {
      int w0 = warp - 1;
      while (w0 > 0 && warp_open[w0]) --w0;
#pragma unroll
      for (int c = 0; c < W; ++c) carry[c] = warp_sum[w0][c];
      for (int w = w0 + 1; w < warp; ++w) {
#pragma unroll
        for (int c = 0; c < W; ++c) carry[c] = combine<OP>(carry[c], warp_sum[w][c]);
      }
      if (seg_lo < 0) {
#pragma unroll
        for (int c = 0; c < W; ++c) s[c] = combine<OP>(carry[c], s[c]);
      }
    }
    // The previous thread's inclusive value carries into this head.
    float e[W];
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const float up = __shfl_up_sync(kFull, s[c], 1);
      e[c] = !cont ? neutral<OP>() : lane == 0 ? carry[c] : up;
    }
    if (multi) {
#pragma unroll
      for (int c = 0; c < W; ++c) head[c] = combine<OP>(e[c], head[c]);
      finish(fid, head);
    }
    if (ends) finish(lid, s);
    if (col0 + W < d) __syncthreads();     // warp_sum is reused
  }
}

template <int OP, int D, bool VEC>
int launch_instance(const Level& a, cudaStream_t stream) {
  constexpr bool kStaged = VEC && D > 1;
  constexpr size_t kSmem = kStaged ? sizeof(float4) * kThreads * (kRows * D / 4 + 1) : 0;
  static bool attr_set = false;
  if (kSmem > 48 * 1024 && !attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_kernel<OP, D, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int64_t blocks = (a.n + kChunk - 1) / kChunk;
  segment_kernel<OP, D, VEC><<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int OP>
int launch_level(const Level& a, bool vec, cudaStream_t stream) {
  if (vec && a.d == 8) return launch_instance<OP, 8, true>(a, stream);
  if (vec && a.d == 1) return launch_instance<OP, 1, true>(a, stream);
  return launch_instance<OP, 0, false>(a, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The caller's rows, then each level of carry records until one block holds
// a level. The records of level k + 1 start after those of level k, each
// level's count rounded up to 4 rows (`rec_cap` rows in all).
template <int OP>
int run(const float* data, const int* seg, int64_t n, int d, int num_segments,
        int vec, float* out, float* rec_vals, int* rec_ids, int64_t rec_cap,
        cudaStream_t stream) {
  if (n <= 0 || d <= 0 || num_segments <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Level a{data, seg, n, d, num_segments, out, nullptr, nullptr};
  bool vec_level = vec != 0;
  int64_t used = 0;
  for (;;) {
    const int64_t blocks = (a.n + kChunk - 1) / kChunk;
    int64_t recs = 0;
    if (blocks > 1) {
      recs = (2 * blocks + 3) / 4 * 4;
      if (used + recs > rec_cap) return static_cast<int>(cudaErrorInvalidValue);
      a.rec_vals = rec_vals + used * d;
      a.rec_ids = rec_ids + used;
    } else {
      a.rec_vals = nullptr;
      a.rec_ids = nullptr;
    }
    const int code = launch_level<OP>(a, vec_level, stream);
    if (code != 0 || blocks == 1) return code;
    a = Level{a.rec_vals, a.rec_ids, 2 * blocks, d, 0, out, nullptr, nullptr};
    vec_level = aligned16(a.data) && aligned16(a.ids);
    used += recs;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int segment_chunk_rows() { return kChunk; }

int segment_sum_sorted(const float* data, const int* seg, int64_t n, int d,
                       int num_segments, int vec, float* out, float* rec_vals,
                       int* rec_ids, int64_t rec_cap, cudaStream_t stream) {
  return run<SUM>(data, seg, n, d, num_segments, vec, out, rec_vals, rec_ids,
                  rec_cap, stream);
}

int segment_max_sorted(const float* data, const int* seg, int64_t n, int d,
                       int num_segments, int vec, float* out, float* rec_vals,
                       int* rec_ids, int64_t rec_cap, cudaStream_t stream) {
  return run<MAX>(data, seg, n, d, num_segments, vec, out, rec_vals, rec_ids,
                  rec_cap, stream);
}

}  // extern "C"
