// eps-neighbour counts and min core labels, for sm_90a. Two kernels, each
// with two epilogues: COUNT (candidates with d2 <= eps2) and MIN_LABEL (the
// min label over such candidates whose core flag is set, SENTINEL_LABEL
// when there is none).
//
// Exactness, shared by both and by the plain versions in
// kernels/pairwise.py: xx = ((x0*x0 + x1*x1) + x2*x2) + ..., yy and xy
// summed the same way from zero, d2 = (xx + yy) - (2*xy), hit = d2 <= eps2,
// every step rounded alone with __fmul_rn/__fadd_rn/__fsub_rn, so that
// nvcc contracts nothing into a fused multiply-add. Counts and labels are
// then the plain versions' bit for bit. No tensor cores: a TF32 or BF16
// product would move pairs across eps.
//
// 1. The stencil kernel, `eps_kernel` (`stencil_count`,
//    `stencil_min_label`). Replaces the Pallas TPU kernels `stencil_count`
//    (src/repro/kernels/pairwise.py:166) and `stencil_min_label` (:197),
//    the core test and the union/border passes of the grid DBSCAN
//    `fdbscan_grid`: each slot of an eps-cell against every slot of the 3^D
//    cells of its stencil, cells read through `nbr_map`.
//    Design: one block per cell, a thread per slot (C rounded up to a
//    warp), the count or label in a register across the stencil; the block
//    stages the stencil's cells with their squared norms, labels and core
//    flags in shared memory (all 27 at once when they fit in 48 KB), where
//    all threads read the same candidate at once (a broadcast).
//    What bounds it: bytes. Only pairs of occupied slots need arithmetic (a
//    padded slot sits at BIG): at the grid's one point per cell that is
//    about 28 tests, some 280 operations, per cell against some 370 bytes
//    per cell at C = 16 (12 a slot of points, 4 a slot of output, 108 of
//    map row). This kernel tests every slot pair, C^2 per stencil cell, so
//    at C = 16 over 99% of its tests are padding.
//
// 2. The all-pairs tile kernel, `pairwise_tile_kernel` (`pairwise_count`,
//    `pairwise_min_label`). Replaces the Pallas TPU kernels
//    `pairwise_count` (src/repro/kernels/pairwise.py:91) and
//    `pairwise_min_label` (:113): every row of x (m, D) against every row
//    of y (n, D) (`ops.eps_neighbor_counts`, `ops.eps_min_label`). The TPU
//    kernels form each tile's -2 x.y on the MXU and accumulate over a
//    sequential grid axis of y tiles.
//    What bounds it: operations, and with the exact order only CUDA-core
//    ones. A pair costs 2D + 4 float operations against 4D bytes or less
//    of input per row. Without FMA each is one FP32 instruction, and an SM
//    issues 128 FP32 lanes a clock: at D = 64 the issue floor is m * n *
//    132 / (132 SMs * 128 * clock), 16.9 ms at 2^16 x 2^16 and 1.98 GHz,
//    half of what the 67 TFLOP/s of the data sheet (which counts an FMA as
//    two) would allow.
//    Design: the classic register-tiled SGEMM shape, which changes the
//    order of no pair's sums. A block owns 128 rows of x and walks a range
//    of 128-row tiles of y; its 256 threads each own an 8 x 8 micro-tile
//    of x.y accumulators (rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
//    columns the same in tx, so that a warp's float4 loads of shared memory
//    hit no bank twice). Both operands come k-major, x as (D, mp) and y as
//    (D, np), zero-padded to whole tiles by the wrapper, so one feature of
//    a tile is one 512-byte run: chunks of 16 features of both are copied
//    into shared memory with 16-byte cp.async, double-buffered, so the next
//    chunk loads while this one is computed. Per feature a thread does 4
//    LDS.128 and 64 products plus 64 sums, 32 FP32 instructions a load.
//    The accumulators persist over a tile's chunks, so each x.y is summed
//    k = 0, 1, ..., D-1 from zero. A prologue kernel writes the squared
//    norms of x and y once into a scratch buffer (and, for MIN_LABEL, the
//    label where the core flag is set and SENTINEL_LABEL elsewhere); they
//    ride into shared memory with each tile's last chunk. The epilogue runs
//    in registers after a tile's last chunk, masking padded candidates by
//    index, and resets the accumulators. It takes a row at a time and folds
//    the hits into the thread's 8 per-row results, which wait between tiles
//    in a thread-private slot of shared memory: 64 accumulators and two
//    blocks a SM leave no room for them in the 128 registers a thread may
//    have (ptxas spilled with them and the rows' norms in registers).
//    After the last tile the 16 threads
//    that share a row reduce it with warp shuffles and one of them combines
//    it into the output with an integer atomic (the wrapper fills the
//    output with 0 or SENTINEL_LABEL). Where the row tiles would fill less
//    than two waves of resident blocks, the candidate tiles are split
//    across gridDim.y; integer atomics make the result independent of the
//    order in which the parts land.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kSentinel = INT_MAX;  // SENTINEL_LABEL
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;    // what a block may opt into on sm_90

enum Epi { COUNT = 0, MIN_LABEL = 1 };

__device__ __forceinline__ float madd(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// ---------------------------------------------------------------------------
// 1. The stencil kernel
// ---------------------------------------------------------------------------

struct StencilArgs {
  const float* pts;            // cell_pts (ncells+1, C, D)
  const int* nbr;              // nbr_map (ncells, S)
  const int* labels;           // MIN_LABEL: (ncells+1, C)
  const unsigned char* core;   // MIN_LABEL: (ncells+1, C) bool
  int ncells;
  int cap;                     // C
  int d;
  int s;                       // stencil entries S
  int tile_cells;              // stencil cells staged at once
  int tile_rows;               // candidate slots per staged tile
  float eps2;
  int* out;
};

template <int EPI>
__device__ __forceinline__ void take(int& acc, float xx, float yy, float xy,
                                     float eps2, const int* yl, const int* yc,
                                     int j) {
  const float d2 = __fsub_rn(__fadd_rn(xx, yy), __fmul_rn(2.0f, xy));
  if (EPI == COUNT) {
    acc += d2 <= eps2;
  } else if (d2 <= eps2 && yc[j]) {
    acc = min(acc, yl[j]);
  }
}

// Shared memory: [qs: D x C][ys: rows x D][yn: rows][yl][yc].
template <int EPI>
__global__ void eps_kernel(StencilArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int d = a.d;
  const int cap = a.cap;
  const int rows = a.tile_rows;
  float* qs = smem;
  float* ys = qs + d * cap;
  float* yn = ys + rows * d;
  int* yl = reinterpret_cast<int*>(yn + rows);
  int* yc = yl + rows;
  const int64_t blk = blockIdx.x;

  // The cell's own points, transposed, so that thread t reads qs[k*C + t].
  const float* q0 = a.pts + blk * cap * d;
  for (int i = tid; i < cap * d; i += nth) qs[(i % d) * cap + i / d] = q0[i];
  const int groups = (cap + nth - 1) / nth;
  const int tiles = (a.s + a.tile_cells - 1) / a.tile_cells;
  for (int g = 0; g < groups; ++g) {
    const int q = g * nth + tid;
    const bool active = q < cap;
    const float* qp = qs + min(q, cap - 1);
    __syncthreads();  // qs staged
    float xx = 0.0f;
    for (int k = 0; k < d; ++k) {
      const float v = qp[k * cap];
      xx = madd(xx, v, v);
    }
    int acc = EPI == COUNT ? 0 : kSentinel;
    for (int t = 0; t < tiles; ++t) {
      __syncthreads();  // the previous tile is consumed
      const int first = t * a.tile_cells;
      const int ncell = min(a.tile_cells, a.s - first);
      const int cnt = ncell * cap;
      const int* nb = a.nbr + blk * a.s + first;
      for (int i = tid; i < cnt * d; i += nth) {
        int cid = nb[i / (cap * d)];
        if (cid < 0 || cid > a.ncells) cid = a.ncells;  // bad ids read the sink
        ys[i] = a.pts[static_cast<int64_t>(cid) * cap * d + i % (cap * d)];
      }
      if (EPI == MIN_LABEL) {
        for (int j = tid; j < cnt; j += nth) {
          int cid = nb[j / cap];
          if (cid < 0 || cid > a.ncells) cid = a.ncells;
          const int64_t r = static_cast<int64_t>(cid) * cap + j % cap;
          yl[j] = a.labels[r];
          yc[j] = a.core[r];
        }
      }
      __syncthreads();
      for (int j = tid; j < cnt; j += nth) {
        float sq = 0.0f;
        for (int k = 0; k < d; ++k) sq = madd(sq, ys[j * d + k], ys[j * d + k]);
        yn[j] = sq;
      }
      __syncthreads();
      int j = 0;
      for (; j + 4 <= cnt; j += 4) {
        const float* y0 = ys + j * d;
        float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
        for (int k = 0; k < d; ++k) {
          const float xk = qp[k * cap];
          p0 = madd(p0, xk, y0[k]);
          p1 = madd(p1, xk, y0[d + k]);
          p2 = madd(p2, xk, y0[2 * d + k]);
          p3 = madd(p3, xk, y0[3 * d + k]);
        }
        take<EPI>(acc, xx, yn[j], p0, a.eps2, yl, yc, j);
        take<EPI>(acc, xx, yn[j + 1], p1, a.eps2, yl, yc, j + 1);
        take<EPI>(acc, xx, yn[j + 2], p2, a.eps2, yl, yc, j + 2);
        take<EPI>(acc, xx, yn[j + 3], p3, a.eps2, yl, yc, j + 3);
      }
      for (; j < cnt; ++j) {
        const float* y0 = ys + j * d;
        float p = 0.0f;
        for (int k = 0; k < d; ++k) p = madd(p, qp[k * cap], y0[k]);
        take<EPI>(acc, xx, yn[j], p, a.eps2, yl, yc, j);
      }
    }
    if (active) a.out[blk * cap + q] = acc;
  }
}

int64_t stencil_smem_bytes(int d, int cap, int rows) {
  return (static_cast<int64_t>(d) * cap + static_cast<int64_t>(rows) * (d + 3)) * 4;
}

template <int EPI>
int stencil(const float* cell_pts, const int* labels, const unsigned char* core,
            const int* nbr, int ncells, int cap, int d, int s, float eps2,
            int* out, cudaStream_t stream) {
  StencilArgs a{cell_pts, nbr, labels, core, ncells, cap, d, s, 1, cap, eps2, out};
  // Stage as many stencil cells at once as fit in 48 KB (all 27 at C = 16),
  // at least one.
  int cells = s;
  while (cells > 1 && stencil_smem_bytes(d, cap, cells * cap) > kDefaultSmem) --cells;
  a.tile_cells = cells;
  a.tile_rows = cells * cap;
  const int warps = (cap + 31) / 32;
  const int threads = warps < 32 ? 32 * warps : 1024;
  const int64_t bytes = stencil_smem_bytes(d, cap, a.tile_rows);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        eps_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  eps_kernel<EPI><<<static_cast<unsigned>(ncells), threads,
                    static_cast<size_t>(bytes), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 2. The all-pairs tile kernel
// ---------------------------------------------------------------------------

constexpr int kTile = 128;     // rows of x per block, candidates per y tile
constexpr int kChunk = 16;     // features per staged chunk
constexpr int kThreads = 256;  // 16 x 16 threads, an 8 x 8 micro-tile each
constexpr int kHalf = kTile / 2;

struct TileArgs {
  const float* xt;   // (d, mp): x transposed, zero-padded to mp rows
  const float* yt;   // (d, np): y transposed, zero-padded to np rows
  const float* xx;   // (mp) squared norms of x (scratch, from the prologue)
  const float* yy;   // (np) squared norms of y
  const int* lc;     // MIN_LABEL: (np) label where core, else SENTINEL
  int m;
  int n;
  int d;
  int64_t mp;        // multiples of kTile
  int64_t np;
  float eps2;
  int* out;          // (m), filled with 0 (COUNT) or SENTINEL (MIN_LABEL)
};

// Squared norms of the padded columns of xt (to xx[0, mp)) and yt (to
// xx[mp, mp + np)), from zero, left to right over the features; with
// `labels`, lc[j] = labels[j] where j < n and core[j], else SENTINEL.
__global__ void pairwise_norms_kernel(const float* xt, const float* yt,
                                      int64_t mp, int64_t np, int d,
                                      const int* labels,
                                      const unsigned char* core, int n,
                                      float* xx, int* lc) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= mp + np) return;
  const bool is_x = j < mp;
  const float* p = is_x ? xt : yt;
  const int64_t stride = is_x ? mp : np;
  const int64_t col = is_x ? j : j - mp;
  float acc = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float v = p[k * stride + col];
    acc = madd(acc, v, v);
  }
  xx[j] = acc;
  if (labels != nullptr && !is_x) {
    lc[col] = col < n && core[col] ? labels[col] : kSentinel;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Stage {
  float x[kChunk][kTile];   // features k0.. of the block's x rows
  float y[kChunk][kTile];   // the same features of the tile's y rows
  float yn[kTile];          // the tile's squared norms (its last chunk only)
  int yl[kTile];            // MIN_LABEL: the tile's labels or SENTINEL
};

// The 8 values at offsets o*4 + {0..3} and 64 + o*4 + {0..3} of a row.
__device__ __forceinline__ void load8(const float* row, int o, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(row + o * 4);
  const float4 hi = *reinterpret_cast<const float4*>(row + kHalf + o * 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void load8(const int* row, int o, int (&v)[8]) {
  const int4 lo = *reinterpret_cast<const int4*>(row + o * 4);
  const int4 hi = *reinterpret_cast<const int4*>(row + kHalf + o * 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// acc[i][j] += x[k][row i] * y[k][col j] for one feature k.
__device__ __forceinline__ void mac_feature(const Stage& st, int k, int ty, int tx,
                                            float (&acc)[8][8]) {
  float xv[8], yv[8];
  load8(st.x[k], ty, xv);
  load8(st.y[k], tx, yv);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = madd(acc[i][j], xv[i], yv[j]);
  }
}

// One tile's epilogue: the thread's 64 pairs against eps2, a row at a time,
// folded into its 8 rows' results, which wait between tiles in `part`, a
// thread-private slot of shared memory (so that neither they nor the rows'
// norms take registers beside the 64 accumulators); candidates at or past
// `lim` (the tile's real rows) are padding.
template <int EPI>
__device__ __forceinline__ void tile_epilogue(const Stage& st, const float* xn,
                                              int (*part)[kThreads], int tid,
                                              int ty, int tx, int lim, float eps2,
                                              float (&acc)[8][8]) {
  float yv[8];
  int lv[8];
  load8(st.yn, tx, yv);
  if (EPI == MIN_LABEL) load8(st.yl, tx, lv);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float xi = xn[i < 4 ? ty * 4 + i : kHalf + ty * 4 + i - 4];
    int best = part[i][tid];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d2 = __fsub_rn(__fadd_rn(xi, yv[j]), __fmul_rn(2.0f, acc[i][j]));
      const bool hit = (j < 4 ? tx * 4 + j : kHalf + tx * 4 + j - 4) < lim &&
                       d2 <= eps2;
      if (EPI == COUNT) {
        best += hit;
      } else if (hit) {
        best = min(best, lv[j]);
      }
      acc[i][j] = 0.0f;
    }
    part[i][tid] = best;
  }
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, 2) pairwise_tile_kernel(TileArgs a) {
  __shared__ __align__(16) Stage stage[2];
  __shared__ __align__(16) float xn[kTile];
  __shared__ __align__(16) int part[8][kThreads];   // `best` of each thread

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile;
  // This block's share of the candidate tiles, from row j_lo on.
  const int64_t ntiles = a.np / kTile;
  const int64_t t_lo = ntiles * blockIdx.y / gridDim.y;
  const int nt = static_cast<int>(ntiles * (blockIdx.y + 1) / gridDim.y - t_lo);
  const int64_t j_lo = t_lo * kTile;
  const int chunks = a.d > 0 ? (a.d + kChunk - 1) / kChunk : 1;

  if (tid < kTile) xn[tid] = a.xx[i0 + tid];
#pragma unroll
  for (int i = 0; i < 8; ++i) part[i][tid] = EPI == COUNT ? 0 : kSentinel;

  // Copy (tile t, chunk c) into stage[buf]: 16 features x 128 rows of x and
  // of y, a warp per 512-byte feature run (rows r and r + 8 of the chunk);
  // the tile's norms and labels with its last chunk.
  const int r0 = tid / 32;
  const int lane4 = (tid % 32) * 4;
  const float* xsrc = a.xt + r0 * a.mp + i0 + lane4;
  const float* ysrc = a.yt + r0 * a.np + j_lo + lane4;
  auto load = [&](int t, int c, int buf) {
    Stage& st = stage[buf];
    const int k0 = c * kChunk;
    const int64_t jt = static_cast<int64_t>(t) * kTile;
#pragma unroll
    for (int h = 0; h < kChunk; h += kThreads / 32) {
      if (k0 + r0 + h < a.d) {
        cp_async16(&st.x[r0 + h][lane4], xsrc + (k0 + h) * a.mp);
        cp_async16(&st.y[r0 + h][lane4], ysrc + (k0 + h) * a.np + jt);
      }
    }
    if (c == chunks - 1) {
      if (tid < 32) {
        cp_async16(&st.yn[lane4], a.yy + j_lo + jt + lane4);
      } else if (EPI == MIN_LABEL && tid < 64) {
        cp_async16(&st.yl[lane4], a.lc + j_lo + jt + lane4);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  if (nt > 0) load(0, 0, 0);
  cp_async_commit();
  int buf = 0;
  for (int t = 0; t < nt; ++t) {
    for (int c = 0; c < chunks; ++c) {
      const bool last = c == chunks - 1;
      if (!last) {
        load(t, c + 1, buf ^ 1);
      } else if (t + 1 < nt) {
        load(t + 1, 0, buf ^ 1);
      }
      cp_async_commit();
      cp_async_wait_one();   // every group but the newest: this step landed
      __syncthreads();
      const Stage& st = stage[buf];
      const int kc = min(kChunk, a.d - c * kChunk);
      // Unrolled by 2, not 16: fully unrolled, ptxas pipelines the operand
      // loads of later features deeper and spills 8-24 bytes of loop state.
      if (kc == kChunk) {
#pragma unroll 2
        for (int k = 0; k < kChunk; ++k) mac_feature(st, k, ty, tx, acc);
      } else {
#pragma unroll 1
        for (int k = 0; k < kc; ++k) mac_feature(st, k, ty, tx, acc);
      }
      if (last) {
        const int64_t left = a.n - (j_lo + static_cast<int64_t>(t) * kTile);
        const int lim = left < kTile ? static_cast<int>(left) : kTile;
        tile_epilogue<EPI>(st, xn, part, tid, ty, tx, lim, a.eps2, acc);
      }
      __syncthreads();       // stage[buf] is consumed before it is refilled
      buf ^= 1;
    }
  }

  // The 16 threads of a row (one ty) are one half of a warp.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int v = part[i][tid];
#pragma unroll
    for (int off = 8; off > 0; off /= 2) {
      const int o = __shfl_xor_sync(0xffffffffu, v, off);
      v = EPI == COUNT ? v + o : min(v, o);
    }
    const int64_t row = i0 + (i < 4 ? ty * 4 + i : kHalf + ty * 4 + i - 4);
    if (tx == 0 && row < a.m) {
      if (EPI == COUNT) {
        if (v != 0) atomicAdd(a.out + row, v);
      } else if (v != kSentinel) {
        atomicMin(a.out + row, v);
      }
    }
  }
}

template <int EPI>
int pairwise(const float* xt, const float* yt, const int* labels,
             const unsigned char* core, int m, int n, int64_t mp, int64_t np,
             int d, float eps2, float* norms, int* lc, int* out,
             cudaStream_t stream) {
  if (mp % kTile != 0 || np % kTile != 0 || mp < m || np < n || mp <= 0 || np <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t cols = mp + np;
  pairwise_norms_kernel<<<static_cast<unsigned>((cols + 255) / 256), 256, 0,
                          stream>>>(xt, yt, mp, np, d, labels, core, n, norms, lc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, pairwise_tile_kernel<EPI>, kThreads, 0)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // Two waves of resident blocks at least: split the candidate tiles across
  // gridDim.y where the row tiles alone would fill less.
  const int64_t row_tiles = mp / kTile;
  const int64_t col_tiles = np / kTile;
  const int64_t want = 2LL * sms * (per_sm > 0 ? per_sm : 1);
  int64_t splits = row_tiles >= want ? 1 : (want + row_tiles - 1) / row_tiles;
  if (splits > col_tiles) splits = col_tiles;
  if (row_tiles > INT_MAX || col_tiles > INT_MAX || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TileArgs a{xt, yt, norms, norms + mp, lc, m, n, d, mp, np, eps2, out};
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(splits));
  pairwise_tile_kernel<EPI><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int stencil_count(const float* cell_pts, const int* nbr, int ncells, int cap,
                  int d, int s, float eps2, int* out, cudaStream_t stream) {
  return stencil<COUNT>(cell_pts, nullptr, nullptr, nbr, ncells, cap, d, s, eps2,
                        out, stream);
}

int stencil_min_label(const float* cell_pts, const int* labels,
                      const unsigned char* core, const int* nbr, int ncells,
                      int cap, int d, int s, float eps2, int* out,
                      cudaStream_t stream) {
  return stencil<MIN_LABEL>(cell_pts, labels, core, nbr, ncells, cap, d, s, eps2,
                            out, stream);
}

// xt (d, mp) and yt (d, np): x and y transposed, zero-padded to multiples
// of 128 rows; norms: (mp + np) float scratch; out: (m) filled with 0.
int pairwise_count(const float* xt, const float* yt, int m, int n, int64_t mp,
                   int64_t np, int d, float eps2, float* norms, int* out,
                   cudaStream_t stream) {
  return pairwise<COUNT>(xt, yt, nullptr, nullptr, m, n, mp, np, d, eps2, norms,
                         nullptr, out, stream);
}

// As pairwise_count, with lc: (np) int scratch; out filled with SENTINEL.
int pairwise_min_label(const float* xt, const float* yt, const int* labels,
                       const unsigned char* core, int m, int n, int64_t mp,
                       int64_t np, int d, float eps2, float* norms, int* lc,
                       int* out, cudaStream_t stream) {
  return pairwise<MIN_LABEL>(xt, yt, labels, core, m, n, mp, np, d, eps2, norms,
                             lc, out, stream);
}

}  // extern "C"
