// Segmented sum and max over sorted segment ids, for sm_90a.
//
// Replaces the Pallas TPU kernels `segment_sum_sorted` and
// `segment_max_sorted` (src/repro/kernels/segment.py:106 and :133), the
// halo catalog's per-halo reductions: out[s, :] = reduce of data[i, :] over
// rows i with seg[i] == s, ids clipped to [0, S).
//
// The TPU kernels turn a tile of rows into a one-hot matrix product on the
// MXU. Hopper needs no such detour: the reduction moves each input byte once
// and does one add per element, so it is bound by memory bandwidth. Each
// thread takes one row; a warp reduces its 32 consecutive rows with a
// segmented shuffle scan (rows of one segment are contiguous because the ids
// are sorted), and the last lane of each run adds the run's total to the
// output with one atomic. A segment spanning several warps gets one atomic
// per warp. Requires ids sorted ascending; the output is initialised by the
// caller (0 for sum, -1e30 for max), so runs whose total is that neutral
// value issue no atomic.
//
// Float atomic max for mixed signs: a non-negative float orders like its
// bits as a signed int, a negative one in reverse like its bits as an
// unsigned int, so a non-negative value goes through a signed atomicMax and
// a value with the sign bit set through an unsigned atomicMin. The result is
// the exact maximum, whatever the order of the atomics.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegBig = -1e30f;  // -SEG_NEG_BIG, the max's empty value

enum Op { SUM = 0, MAX = 1 };

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  return OP == SUM ? a + b : fmaxf(a, b);
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const float* __restrict__ data, const int* __restrict__ seg,
               int64_t n, int d, int num_segments, float* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool valid = row < n;
  int s = valid ? min(max(__ldg(seg + row), 0), num_segments - 1) : -1;
  // Neighbour ids decide which lanes share a run; rows past n get id -1,
  // which no real row has, so they never join a run.
  int next = __shfl_down_sync(kFull, s, 1);
  const bool run_end = valid && (lane == 31 || next != s);
  for (int c = 0; c < d; ++c) {
    float v = valid ? __ldg(data + row * d + c) : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(kFull, v, off);
      const int s_up = __shfl_up_sync(kFull, s, off);
      if (lane >= off && s_up == s) v = combine<OP>(v, up);
    }
    // The output starts at the neutral value, so a run total equal to it
    // (0 for sum, <= -1e30 for max) needs no atomic. This matters: the
    // catalog's noise tail, a fifth of the rows, is one segment of neutral
    // rows, and its atomics would all hit one address.
    const bool neutral = OP == SUM ? v == 0.0f : v <= kNegBig;
    if (run_end && !neutral) {
      float* dst = out + static_cast<int64_t>(s) * d + c;
      if (OP == SUM) {
        atomicAdd(dst, v);
      } else {
        atomic_max_float(dst, v);
      }
    }
  }
}

template <int OP>
int launch(const float* data, const int* seg, int64_t n, int d, int num_segments,
           float* out, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  segment_kernel<OP><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      data, seg, n, d, num_segments, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int segment_sum_sorted(const float* data, const int* seg, int64_t n, int d,
                       int num_segments, float* out, cudaStream_t stream) {
  return launch<SUM>(data, seg, n, d, num_segments, out, stream);
}

int segment_max_sorted(const float* data, const int* seg, int64_t n, int d,
                       int num_segments, float* out, cudaStream_t stream) {
  return launch<MAX>(data, seg, n, d, num_segments, out, stream);
}

}  // extern "C"
