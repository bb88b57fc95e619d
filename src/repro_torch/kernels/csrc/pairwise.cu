// eps-neighbour counts and min core labels, for sm_90a. Two kernels, each
// with two epilogues: COUNT (candidates with d2 <= eps2) and MIN_LABEL (the
// min label over such candidates whose core flag is set, SENTINEL_LABEL
// when there is none).
//
// Exactness, shared by both and by the plain versions in
// kernels/pairwise.py: xx = ((x0*x0 + x1*x1) + x2*x2) + ..., yy and xy
// summed the same way from zero, d2 = (xx + yy) - (2*xy), hit = d2 <= eps2,
// every step rounded alone with __fmul_rn/__fadd_rn/__fsub_rn, so that
// nvcc contracts nothing into a fused multiply-add. XLA:CPU, where the
// reference runs, flushes subnormal inputs and results to zero (ROADMAP
// C7), so this file is built with `--ftz=true` (kernels/_build.py): every
// float operation here, the _rn intrinsics and the compare included, takes
// the .FTZ form, which reads a subnormal operand as a zero of its sign and
// writes a subnormal result as one (`chip_smoke.py` phase 1 requires every
// FMUL and FADD of this file's SASS to carry .FTZ). The plain versions
// flush the inputs, each product, each partial sum of x.y and d2. Counts
// and labels are then the plain versions' bit for bit. No tensor cores: a
// TF32 or BF16 product would move pairs across eps.
//
// 1. The stencil kernel, `eps_kernel` (`stencil_count`,
//    `stencil_min_label`). Replaces the Pallas TPU kernels `stencil_count`
//    (src/repro/kernels/pairwise.py:166) and `stencil_min_label` (:197),
//    the core test and the union/border passes of the grid DBSCAN
//    `fdbscan_grid`: each slot of an eps-cell against every slot of the
//    3^D cells of its stencil, cells read through `nbr_map`, the output
//    defined at every (cell, slot), padded slots included.
//
//    Slot classes, the exactness argument. For a cell c, R(c) are its real
//    slots (some coordinate differs bitwise from float32(BIG)) and P(c) its
//    padded ones (every coordinate is bitwise float32(BIG)); a real point
//    whose coordinates are all BIG is in P, which is exact, as its
//    coordinates are the padding's. The hit test reads nothing but the two
//    slots' coordinates, and the same bits through the same rounded
//    operations give the same bits, so every slot of P(c) gives one hit bit
//    against a given partner: the test of that partner against the padding
//    vector (BIG, ..., BIG). Per query slot q and stencil entry c, then:
//    - q real, candidates R(c): each pair tested, as the plain version
//      does. Only these tests grow with density.
//    - q real, candidates P(c): one test of q against the padding vector
//      (once per q: the vector is the same for every c). If it hits,
//      COUNT adds |P(c)| and MIN_LABEL takes minP(c), the min label over
//      the slots of P(c) with the core flag set (SENTINEL_LABEL if none).
//    - q padded: every padded query slot of a cell has the same answer,
//      computed once per cell from the padding vector against each real
//      candidate (a test each) and against itself. That last test is
//      computed, not assumed: (xx + xx) - 2*xx is 0 for any D the layout
//      holds (BIG^2 * D stays finite in float32), a hit for any eps2 >= 0.
//    Points a few ulps from BIG are real, and their test against the
//    padding vector is decided by the formula's rounding (d2 comes out 0,
//    negative or some 1e23), not by geometry, so it is computed, never
//    assumed to miss. Nothing here depends on how cells are filled: R and
//    P are read from the coordinates of every slot, padded slots may sit
//    anywhere in a cell and carry any label and core flag, and the sink
//    (and the ids outside [0, ncells], which read it) is classified like
//    any cell.
//
//    Work. The kernel's tests are sum_i |R(i)| * T(i) pairs plus
//    sum_i (T(i) + |R(i)| + 1) class tests, T(i) the real candidates of
//    cell i's stencil: at 2^24 uniform points in 256^3 cells (capacity 16)
//    about 4.7e8 + 4.9e8, against the 1.16e11 slot pairs, C^2 per stencil
//    cell, that testing every slot pair makes.
//
//    Design. A prologue (`real_mask_kernel`) reads every slot once and
//    writes each cell's R as C bits (32-bit words, W = ceil(C/32) a cell);
//    `fdbscan_grid` makes it once for all its launches (`shared_classes`
//    in kernels/pairwise.py). MIN_LABEL adds a per-launch prologue
//    (`pad_min_kernel`) for minP, which reads the labels and core flags of
//    the launch. Both map a cell to `group` lanes (C rounded up to a power
//    of two, at most 32) and build the bits with `__ballot_sync`. The main
//    kernel gives a warp to each query cell, two warps a block, blocks in
//    cell order, so that neighbouring cells' data is read from L2. Lane l
//    takes one 32-slot word of the stencil's cells (entry l / W, word
//    l % W; 32 words a round), an exclusive warp scan of their popcounts
//    places their real slots in a warp-private list in shared memory
//    (16-bit entries, word lane and bit), and the list is walked 32
//    candidates at a time, a candidate a lane: its coordinates (in
//    registers for D <= 4), squared norm, label and core flag are loaded
//    once. Each real query slot of the cell is then broadcast to the warp
//    and tested against the 32 candidates at once, COUNT folding the hits
//    with `__ballot_sync` and `__popc`, MIN_LABEL with
//    `__reduce_min_sync`, into a per-slot accumulator in shared memory;
//    the padding vector is tested against the same candidates. At the
//    grid's mean of one point a cell, a stencil's ~28 real candidates fill
//    a warp. A last pass writes every slot of the cell once: a real slot
//    its accumulator and its class terms, a padded slot the cell's padded
//    answer. Any C works (C = 1100 takes 35 words a cell and rounds of 32
//    words), any S, any D (past 4, coordinates are read from L1 at each
//    use).
//    What bounds it: by the count above, bytes (some 60 tests, about 600
//    operations, a cell against some 370 bytes at C = 16: 12 a slot of
//    points, 4 a slot of output, 108 of map row). On the card it is the
//    latency of a cell's chain of dependent loads (map row, class words,
//    candidates, query slots) at the warps an SM holds (40 registers: 50
//    warps in blocks of two): about 6x the bytes bound at 2^24 on an
//    H100. Variants that
//    shortened the chain (persistent warps fetching the next cells' map
//    rows and class words ahead, or the cell's own slots broadcast by
//    shuffle) took more registers and fewer warps and ran slower, and
//    capping the registers spilled (`tools/compare_stencil.py`).
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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStencilWarps = 2;   // query cells a block, a warp each
constexpr int kSmallD = 4;         // widths whose coordinates sit in registers

struct StencilArgs {
  const float* pts;            // cell_pts (ncells+1, C, D)
  const int* nbr;              // nbr_map (ncells, S)
  const unsigned* real;        // (ncells+1, W): bit j%32 of word j/32, slot j real
  const int* labels;           // MIN_LABEL: (ncells+1, C)
  const unsigned char* core;   // MIN_LABEL: (ncells+1, C) bool
  const int* pad_min;          // MIN_LABEL: (ncells+1) minP of each cell
  int ncells;
  int cap;                     // C
  int d;
  int s;                       // stencil entries S
  int words;                   // W
  int list_cap;                // entries of a warp's candidate list
  float pad;                   // float32(BIG)
  float eps2;
  int* out;
};

__device__ __forceinline__ bool hit(float xx, float yy, float xy, float eps2) {
  return __fsub_rn(__fadd_rn(xx, yy), __fmul_rn(2.0f, xy)) <= eps2;
}

// A slot's coordinates: in registers where D <= kSmallD (SMALL), else read
// where they lie at each use.
template <bool SMALL>
struct Point {
  float v[kSmallD];
  const float* p;
  __device__ __forceinline__ void load(const float* src, int d) {
    p = src;
#pragma unroll
    for (int k = 0; k < kSmallD; ++k) v[k] = SMALL && k < d ? __ldg(src + k) : 0.0f;
  }
  __device__ __forceinline__ float at(int k) const { return SMALL ? v[k] : __ldg(p + k); }
};

// x.y from zero, left to right over the D features; y == nullptr stands
// for the padding vector, every feature `pad`.
template <bool SMALL>
__device__ __forceinline__ float dot(const Point<SMALL>& x, const Point<SMALL>* y,
                                     float pad, int d) {
  float acc = 0.0f;
  if (SMALL) {
#pragma unroll
    for (int k = 0; k < kSmallD; ++k) {
      if (k < d) acc = madd(acc, x.v[k], y ? y->v[k] : pad);
    }
  } else {
    for (int k = 0; k < d; ++k) acc = madd(acc, x.at(k), y ? y->at(k) : pad);
  }
  return acc;
}

// The warp's 32 hit bits folded into one value, the same in every lane:
// COUNT their number, MIN_LABEL the least `label` of a hit (a candidate
// without the core flag carries SENTINEL_LABEL).
template <int EPI>
__device__ __forceinline__ int warp_fold(bool h, int label) {
  if (EPI == COUNT) return __popc(__ballot_sync(kFull, h));
  return __reduce_min_sync(kFull, h ? label : kSentinel);
}

template <int EPI>
__device__ __forceinline__ int fold(int acc, int v) {
  return EPI == COUNT ? acc + v : min(acc, v);
}

// Slots to lanes in the prologues: a cell takes `group` lanes (C rounded up
// to a power of two, at most 32), a warp 32 / group cells at a time and
// kGroups such groups of cells, whose loads it issues together; past 32
// slots a cell takes its W words one after another. `cells` = ncells + 1.
constexpr int kGroups = 4;

struct Lanes {
  int64_t first;  // the warp's first cell
  int per;        // cells a group
  int at;         // the lane's cell in a group
  int sub;        // the lane's slot in a word
  int shift;      // its cell's first lane
  __device__ __forceinline__ explicit Lanes(int group) {
    const int lane = threadIdx.x & 31;
    const int64_t w = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    per = 32 / group;
    first = w * kGroups * per;
    at = lane / group;
    sub = lane & (group - 1);
    shift = at * group;
  }
  // The lane's cell in group u.
  __device__ __forceinline__ int64_t cell(int u) const { return first + u * per + at; }
};

// Each cell's real slots as bits: a slot is real where some coordinate
// differs bitwise from `pad`.
__global__ void real_mask_kernel(const float* pts, int64_t cells, int cap, int d,
                                 int words, int group, float pad, unsigned* real) {
  const Lanes l(group);
  if (l.first >= cells) return;
  const unsigned low = group == 32 ? kFull : (1u << group) - 1;
  const unsigned pad_bits = __float_as_uint(pad);
  for (int w = 0; w < words; ++w) {
    const int slot = w * 32 + l.sub;
    bool is_real[kGroups];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int64_t cell = l.cell(u);
      is_real[u] = false;
      if (cell < cells && slot < cap) {
        const float* p = pts + (cell * cap + slot) * d;
#pragma unroll
        for (int k = 0; k < kSmallD; ++k) {
          if (k < d) is_real[u] |= __float_as_uint(__ldg(p + k)) != pad_bits;
        }
        for (int k = kSmallD; k < d; ++k) {
          is_real[u] |= __float_as_uint(__ldg(p + k)) != pad_bits;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int64_t cell = l.cell(u);
      const unsigned bits = __ballot_sync(kFull, is_real[u]);
      if (l.sub == 0 && cell < cells) real[cell * words + w] = (bits >> l.shift) & low;
    }
  }
}

// minP of each cell: the least label over its padded slots with the core
// flag set, SENTINEL_LABEL where there is none.
__global__ void pad_min_kernel(const unsigned* real, const int* labels,
                               const unsigned char* core, int64_t cells, int cap,
                               int words, int group, int* pad_min) {
  const Lanes l(group);
  if (l.first >= cells) return;
  int best[kGroups];
#pragma unroll
  for (int u = 0; u < kGroups; ++u) best[u] = kSentinel;
  for (int w = 0; w < words; ++w) {
    const int slot = w * 32 + l.sub;
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int64_t cell = l.cell(u);
      if (cell < cells && slot < cap) {
        const int64_t r = cell * cap + slot;
        const unsigned bits = __ldg(real + cell * words + w);
        const bool c = core[r];
        const int lab = __ldg(labels + r);
        if (!((bits >> (slot & 31)) & 1u) && c) best[u] = min(best[u], lab);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
    for (int off = group / 2; off > 0; off /= 2) {
      best[u] = min(best[u], __shfl_xor_sync(kFull, best[u], off));
    }
    const int64_t cell = l.cell(u);
    if (l.sub == 0 && cell < cells) pad_min[cell] = best[u];
  }
}

// A warp per query cell. Shared memory, per warp: [acc: C ints][list:
// list_cap 16-bit entries].
template <int EPI, bool SMALL>
__global__ void __launch_bounds__(kStencilWarps * 32) eps_kernel(StencilArgs a) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t cell = static_cast<int64_t>(blockIdx.x) * kStencilWarps + warp;
  if (cell >= a.ncells) return;
  const int cap = a.cap, d = a.d, words = a.words;
  int* acc = smem + warp * (cap + a.list_cap / 2);
  unsigned short* list = reinterpret_cast<unsigned short*>(acc + cap);
  const int init = EPI == COUNT ? 0 : kSentinel;
  for (int j = lane; j < cap; j += 32) acc[j] = init;   // lane j%32 owns slot j

  // The padding vector's squared norm; x.x of it is the same sum, so the
  // test of the padding vector against itself is hit(nn, nn, nn).
  float pad_nn = 0.0f;
  for (int k = 0; k < d; ++k) pad_nn = madd(pad_nn, a.pad, a.pad);
  const float* qpts = a.pts + cell * cap * d;
  const unsigned* qreal = a.real + cell * words;
  const int* row = a.nbr + cell * a.s;

  int np = 0;                // padded candidate slots of the stencil
  int pad_min = kSentinel;   // MIN_LABEL: this lane's min over its cells' minP
  int pad_acc = init;        // the padding vector against the real candidates
  const int chunks = a.s * words;
  for (int base = 0; base < chunks; base += 32) {
    // Lane l takes word w of stencil entry e, chunk base + l.
    const int j = base + lane;
    int c = 0, w = 0, slots = 0;
    unsigned bits = 0;
    if (j < chunks) {
      const int e = j / words;
      w = j - e * words;
      c = __ldg(row + e);
      if (c < 0 || c > a.ncells) c = a.ncells;   // bad ids read the sink
      bits = __ldg(a.real + static_cast<int64_t>(c) * words + w);
      slots = min(32, cap - 32 * w);
      if (EPI == MIN_LABEL && w == 0) pad_min = min(pad_min, __ldg(a.pad_min + c));
    }
    const int n = __popc(bits);
    np += __reduce_add_sync(kFull, slots - n);
    int end = n;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int v = __shfl_up_sync(kFull, end, off);
      if (lane >= off) end += v;
    }
    const int total = __shfl_sync(kFull, end, 31);
    for (int pos = end - n; bits; bits &= bits - 1) {
      list[pos++] = static_cast<unsigned short>(lane << 5 | (__ffs(bits) - 1));
    }
    __syncwarp();

    for (int t = 0; t < total; t += 32) {
      // A real candidate a lane: chunk lane (entry >> 5), bit (entry & 31).
      const bool valid = t + lane < total;
      const int entry = valid ? list[t + lane] : 0;
      const int yc = __shfl_sync(kFull, c, entry >> 5);
      const int yw = __shfl_sync(kFull, w, entry >> 5);
      Point<SMALL> y;
      y.load(a.pts, 0);
      float yy = 0.0f;
      int ylab = kSentinel;
      if (valid) {
        const int64_t r = static_cast<int64_t>(yc) * cap + yw * 32 + (entry & 31);
        y.load(a.pts + r * d, d);
        yy = dot<SMALL>(y, &y, a.pad, d);
        if (EPI == MIN_LABEL && a.core[r]) ylab = __ldg(a.labels + r);
      }
      pad_acc = fold<EPI>(pad_acc, warp_fold<EPI>(
          valid && hit(pad_nn, yy, dot<SMALL>(y, nullptr, a.pad, d), a.eps2), ylab));
      // Each real query slot of the cell, broadcast, against the 32.
      for (int qw = 0; qw < words; ++qw) {
        for (unsigned qb = __ldg(qreal + qw); qb; qb &= qb - 1) {
          const int b = __ffs(qb) - 1;
          const int qs = qw * 32 + b;
          Point<SMALL> q;
          q.load(qpts + qs * d, d);
          const float xx = dot<SMALL>(q, &q, a.pad, d);
          const int v = warp_fold<EPI>(
              valid && hit(xx, yy, dot<SMALL>(q, &y, a.pad, d), a.eps2), ylab);
          if (lane == b) acc[qs] = fold<EPI>(acc[qs], v);
        }
      }
    }
    __syncwarp();   // the list is read before the next round writes it
  }

  // The class terms, and every slot of the cell written once.
  if (EPI == MIN_LABEL) pad_min = __reduce_min_sync(kFull, pad_min);
  const int pad_class = EPI == COUNT ? np : pad_min;
  const int pad_answer = fold<EPI>(
      pad_acc, hit(pad_nn, pad_nn, pad_nn, a.eps2) ? pad_class : init);
  int* out = a.out + cell * cap;
  for (int j = lane; j < cap; j += 32) {
    int v = pad_answer;
    if ((__ldg(qreal + j / 32) >> (j & 31)) & 1u) {
      Point<SMALL> q;
      q.load(qpts + j * d, d);
      const bool hq = hit(dot<SMALL>(q, &q, a.pad, d), pad_nn,
                          dot<SMALL>(q, nullptr, a.pad, d), a.eps2);
      v = fold<EPI>(acc[j], hq ? pad_class : init);
    }
    out[j] = v;
  }
}

// Prologue blocks of 256 threads over `cells` cells, `group` lanes a cell.
unsigned prologue_blocks(int64_t cells, int group) {
  const int64_t per_warp = static_cast<int64_t>(32 / group) * kGroups;
  const int64_t warps = (cells + per_warp - 1) / per_warp;
  return static_cast<unsigned>((warps * 32 + 255) / 256);
}

int lanes_per_cell(int cap) {
  int g = 1;
  while (g < cap && g < 32) g *= 2;
  return g;
}

int real_mask(const float* cell_pts, int ncells, int cap, int d, float pad,
              unsigned* real, cudaStream_t stream) {
  const int64_t cells = static_cast<int64_t>(ncells) + 1;
  const int group = lanes_per_cell(cap);
  real_mask_kernel<<<prologue_blocks(cells, group), 256, 0, stream>>>(
      cell_pts, cells, cap, d, (cap + 31) / 32, group, pad, real);
  return static_cast<int>(cudaGetLastError());
}

template <int EPI, bool SMALL>
int launch_eps(const StencilArgs& a, cudaStream_t stream) {
  const int64_t bytes = static_cast<int64_t>(kStencilWarps) *
                        (a.cap + a.list_cap / 2) * 4;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        eps_kernel<EPI, SMALL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (static_cast<int64_t>(a.ncells) + kStencilWarps - 1) /
                         kStencilWarps;
  eps_kernel<EPI, SMALL><<<static_cast<unsigned>(blocks), kStencilWarps * 32,
                           static_cast<size_t>(bytes), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int EPI>
int stencil(const float* cell_pts, const int* labels, const unsigned char* core,
            const int* nbr, const unsigned* real, int ncells, int cap, int d, int s,
            float pad, float eps2, int* pad_min, int* out, cudaStream_t stream) {
  const int words = (cap + 31) / 32;
  StencilArgs a{cell_pts, nbr, real, labels, core, pad_min, ncells, cap, d, s,
                words, 32 * min(32, cap), pad, eps2, out};
  if (EPI == MIN_LABEL) {
    const int64_t cells = static_cast<int64_t>(ncells) + 1;
    const int group = lanes_per_cell(cap);
    pad_min_kernel<<<prologue_blocks(cells, group), 256, 0, stream>>>(
        real, labels, core, cells, cap, words, group, pad_min);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return d <= kSmallD ? launch_eps<EPI, true>(a, stream)
                      : launch_eps<EPI, false>(a, stream);
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
  load8(st.yn, tx, yv);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float xi = xn[i < 4 ? ty * 4 + i : kHalf + ty * 4 + i - 4];
    int best = part[i][tid];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j < 4 ? tx * 4 + j : kHalf + tx * 4 + j - 4;
      const float d2 = __fsub_rn(__fadd_rn(xi, yv[j]), __fmul_rn(2.0f, acc[i][j]));
      const bool hit = col < lim && d2 <= eps2;
      if (EPI == COUNT) {
        best += hit;
      } else if (hit) {
        // The label is read from shared memory at a hit, not held in
        // registers beside the accumulators: held, the 8 labels made
        // ptxas spill once the file took --ftz=true.
        best = min(best, st.yl[col]);
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

// real: (ncells+1, ceil(C/32)) words, written; pad: float32(BIG).
int stencil_classes(const float* cell_pts, int ncells, int cap, int d, float pad,
                    unsigned* real, cudaStream_t stream) {
  return real_mask(cell_pts, ncells, cap, d, pad, real, stream);
}

// real: stencil_classes' words for cell_pts; out: (ncells, C).
int stencil_count(const float* cell_pts, const int* nbr, const unsigned* real,
                  int ncells, int cap, int d, int s, float pad, float eps2, int* out,
                  cudaStream_t stream) {
  return stencil<COUNT>(cell_pts, nullptr, nullptr, nbr, real, ncells, cap, d, s,
                        pad, eps2, nullptr, out, stream);
}

// As stencil_count, with pad_min: (ncells+1) int scratch.
int stencil_min_label(const float* cell_pts, const int* labels,
                      const unsigned char* core, const int* nbr, const unsigned* real,
                      int ncells, int cap, int d, int s, float pad, float eps2,
                      int* pad_min, int* out, cudaStream_t stream) {
  return stencil<MIN_LABEL>(cell_pts, labels, core, nbr, real, ncells, cap, d, s,
                            pad, eps2, pad_min, out, stream);
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
