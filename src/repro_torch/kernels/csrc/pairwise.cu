// eps-neighbour counts and min core labels over candidate tiles, for sm_90a.
//
// Replaces four Pallas TPU kernels of src/repro/kernels/pairwise.py:
//   * `stencil_count` (:166) and `stencil_min_label` (:197), the core test
//     and the union/border passes of the grid DBSCAN `fdbscan_grid`: each
//     slot of an eps-cell against every slot of the 3^D cells of its
//     stencil, cells read through `nbr_map`;
//   * `pairwise_count` (:91) and `pairwise_min_label` (:113), the same two
//     epilogues for every row of x against every row of y
//     (`ops.eps_neighbor_counts`, `ops.eps_min_label`).
// One template covers all four: CAND picks the candidate set (the stencil
// cells, or all tiles of y), EPI the epilogue (COUNT, or MIN_LABEL over
// candidates whose core flag is set).
//
// The TPU kernels form each candidate tile's -2 x.y term as a matrix
// product on the MXU and walk the tiles as a sequential grid axis that
// accumulates into the output block. Here a thread owns one query (a slot
// of the block's cell, or one row of x) and keeps its count or label in a
// register across the tiles; the block stages each candidate tile, with its
// squared norms, labels and core flags, in shared memory, where all threads
// read the same candidate at once (a broadcast). The stencil kernel runs one
// block per cell with C threads rounded up to a warp and stages all its
// stencil cells at once when they fit in 48 KB; the all-pairs kernel runs
// blocks of 128 rows of x over tiles of 128 rows of y, reading x through
// its transpose (D, m) so that a warp's loads of one feature coalesce, and
// computes four candidates per pass over the features.
//
// What bounds it. All pairs: operations. Each pair costs 2D + 4 float
// operations (D products and D sums for x.y, the norm sum, 2 x.y, the
// difference, the compare) against 4D bytes or less of input per row, far
// above the H100's 20 float operations per byte. Stencil: bytes. Only pairs
// of occupied slots need arithmetic (a padded slot sits at BIG): at the
// grid's one point per cell that is about 28 tests, some 280 operations,
// per cell against some 370 bytes per cell at C = 16 (12 a slot of points,
// 4 a slot of output, 108 of map row). This kernel tests every slot pair,
// C^2 per stencil cell, so at C = 16 over 99% of its tests are padding.
// No tensor cores: a TF32 or BF16 product would change which pairs pass
// the eps test; an exact 3xTF32 `wgmma` version is later work.
//
// Exactness: the order of arithmetic is the contract shared with the plain
// versions in kernels/pairwise.py: xx = ((x0*x0 + x1*x1) + x2*x2) + ...,
// yy and xy summed the same way from zero, d2 = (xx + yy) - (2*xy), hit =
// d2 <= eps2, every step rounded with __fmul_rn/__fadd_rn/__fsub_rn so that
// nvcc contracts nothing into a fused multiply-add. Counts and labels are
// then the plain versions' bit for bit, at padded slots too.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kSentinel = INT_MAX;  // SENTINEL_LABEL
constexpr int kRows = 128;          // all pairs: rows of x per block and of y per tile
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;    // what a block may opt into on sm_90

enum Cand { STENCIL = 0, ALL = 1 };
enum Epi { COUNT = 0, MIN_LABEL = 1 };

struct Args {
  const float* pts;            // STENCIL: cell_pts (ncells+1, C, D); ALL: y (n, D)
  const float* xt;             // ALL: x transposed, (D, m)
  const int* nbr;              // STENCIL: nbr_map (ncells, S)
  const int* labels;           // MIN_LABEL: per candidate row
  const unsigned char* core;   // MIN_LABEL: per candidate row (bool)
  int nq;                      // STENCIL: ncells; ALL: m
  int ncand;                   // STENCIL: C; ALL: n
  int d;
  int s;                       // STENCIL: stencil entries S
  int tile_cells;              // STENCIL: stencil cells staged at once
  int tile_rows;               // candidate rows per staged tile
  float eps2;
  int* out;
};

__device__ __forceinline__ float madd(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

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

// Shared memory: [qs: D x C, STENCIL only][ys: rows x D][yn: rows][yl][yc].
template <int CAND, int EPI>
__global__ void eps_kernel(Args a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int d = a.d;
  const int cap = a.ncand;
  const int rows = a.tile_rows;
  float* qs = smem;
  float* ys = qs + (CAND == STENCIL ? d * cap : 0);
  float* yn = ys + rows * d;
  int* yl = reinterpret_cast<int*>(yn + rows);
  int* yc = yl + rows;
  const int64_t blk = blockIdx.x;

  if (CAND == STENCIL) {
    // The cell's own points, transposed, so that thread t reads qs[k*C + t].
    const float* q = a.pts + blk * cap * d;
    for (int i = tid; i < cap * d; i += nth) qs[(i % d) * cap + i / d] = q[i];
  }
  const int groups = CAND == STENCIL ? (cap + nth - 1) / nth : 1;
  const int tiles = static_cast<int>(
      CAND == STENCIL ? (a.s + a.tile_cells - 1) / a.tile_cells
                      : (static_cast<int64_t>(cap) + rows - 1) / rows);
  for (int g = 0; g < groups; ++g) {
    int q;
    bool active;
    const float* qp;
    int64_t qstride;
    if (CAND == STENCIL) {
      q = g * nth + tid;
      active = q < cap;
      qp = qs + min(q, cap - 1);
      qstride = cap;
    } else {
      q = static_cast<int>(blk * nth + tid);
      active = q < a.nq;
      qp = a.xt + min(q, a.nq - 1);
      qstride = a.nq;
    }
    __syncthreads();  // qs staged
    float xx = 0.0f;
    for (int k = 0; k < d; ++k) {
      const float v = qp[k * qstride];
      xx = madd(xx, v, v);
    }
    int acc = EPI == COUNT ? 0 : kSentinel;
    for (int t = 0; t < tiles; ++t) {
      int cnt;
      __syncthreads();  // the previous tile is consumed
      if (CAND == STENCIL) {
        const int first = t * a.tile_cells;
        const int ncell = min(a.tile_cells, a.s - first);
        cnt = ncell * cap;
        const int* nb = a.nbr + blk * a.s + first;
        for (int i = tid; i < cnt * d; i += nth) {
          int cid = nb[i / (cap * d)];
          if (cid < 0 || cid > a.nq) cid = a.nq;  // bad ids read the sink
          ys[i] = a.pts[static_cast<int64_t>(cid) * cap * d + i % (cap * d)];
        }
        if (EPI == MIN_LABEL) {
          for (int j = tid; j < cnt; j += nth) {
            int cid = nb[j / cap];
            if (cid < 0 || cid > a.nq) cid = a.nq;
            const int64_t r = static_cast<int64_t>(cid) * cap + j % cap;
            yl[j] = a.labels[r];
            yc[j] = a.core[r];
          }
        }
      } else {
        const int64_t j0 = static_cast<int64_t>(t) * rows;
        cnt = cap - j0 < rows ? static_cast<int>(cap - j0) : rows;
        for (int i = tid; i < cnt * d; i += nth) ys[i] = a.pts[j0 * d + i];
        if (EPI == MIN_LABEL) {
          for (int j = tid; j < cnt; j += nth) {
            yl[j] = a.labels[j0 + j];
            yc[j] = a.core[j0 + j];
          }
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
          const float xk = qp[k * qstride];
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
        for (int k = 0; k < d; ++k) p = madd(p, qp[k * qstride], y0[k]);
        take<EPI>(acc, xx, yn[j], p, a.eps2, yl, yc, j);
      }
    }
    if (active) a.out[CAND == STENCIL ? blk * cap + q : q] = acc;
  }
}

int64_t smem_bytes(int cand, int d, int cap, int rows) {
  const int64_t floats = (cand == STENCIL ? static_cast<int64_t>(d) * cap : 0) +
                         static_cast<int64_t>(rows) * (d + 3);
  return floats * 4;
}

template <int CAND, int EPI>
int launch(Args a, unsigned blocks, int threads, cudaStream_t stream) {
  const int64_t bytes = smem_bytes(CAND, a.d, a.ncand, a.tile_rows);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        eps_kernel<CAND, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  eps_kernel<CAND, EPI><<<blocks, threads, static_cast<size_t>(bytes), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int EPI>
int stencil(const float* cell_pts, const int* labels, const unsigned char* core,
            const int* nbr, int ncells, int cap, int d, int s, float eps2,
            int* out, cudaStream_t stream) {
  Args a{cell_pts, nullptr, nbr, labels, core, ncells, cap, d, s, 1, cap, eps2, out};
  // Stage as many stencil cells at once as fit in 48 KB (all 27 at C = 16),
  // at least one.
  int cells = s;
  while (cells > 1 && smem_bytes(STENCIL, d, cap, cells * cap) > kDefaultSmem) --cells;
  a.tile_cells = cells;
  a.tile_rows = cells * cap;
  const int warps = (cap + 31) / 32;
  const int threads = warps < 32 ? 32 * warps : 1024;
  return launch<STENCIL, EPI>(a, static_cast<unsigned>(ncells), threads, stream);
}

template <int EPI>
int pairwise(const float* xt, const float* y, const int* labels,
             const unsigned char* core, int m, int n, int d, float eps2,
             int* out, cudaStream_t stream) {
  // Tiles of 128 rows of y, fewer where D is so wide that they would not
  // fit in a block's shared memory.
  int rows = kRows;
  while (rows > 1 && smem_bytes(ALL, d, 0, rows) > kMaxSmem) rows /= 2;
  Args a{y, xt, nullptr, labels, core, m, n, d, 0, 1, rows, eps2, out};
  const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(m) + kRows - 1) / kRows);
  return launch<ALL, EPI>(a, blocks, kRows, stream);
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

int pairwise_count(const float* xt, const float* y, int m, int n, int d,
                   float eps2, int* out, cudaStream_t stream) {
  return pairwise<COUNT>(xt, y, nullptr, nullptr, m, n, d, eps2, out, stream);
}

int pairwise_min_label(const float* xt, const float* y, const int* labels,
                       const unsigned char* core, int m, int n, int d,
                       float eps2, int* out, cudaStream_t stream) {
  return pairwise<MIN_LABEL>(xt, y, labels, core, m, n, d, eps2, out, stream);
}

}  // extern "C"
