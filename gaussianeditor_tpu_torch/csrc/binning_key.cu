// Kernel B1: sort key and gathered payload for every tile-instance rank.
//
// Replaces: gaussianeditor_tpu/ops/binning_sorted.py::_make_key_kernel
// (the Pallas key kernel of the sorted binning). For rank q it finds the
// owning Gaussian g (the first g with b_incl[g] > q), the tile
// j = q - b_prev[g] steps into g's rect in y-major order
// ((ry + j / w) * grid_x + rx + j % w), and writes
//   key = tile << depth_bits | (float bits of depth[g]) >> (32 - depth_bits)
// as int64, or 2^32 - 1 for a dead rank (q >= total or j outside
// [0, tiles_touched[g])). It also gathers g's compositing payload
// (mean2d x y, conic a b c, opacity, depth, color[ch]) into the
// field-major [7 + ch, n] buffer that the caller reorders by the sort.
// Integer division replaces the Pallas kernel's floor((j + 0.5) / w),
// which exists only because integer division is slow on the TPU's
// vector unit; there is no f32-encoded [C + 1, 16] table either.
//
// Bound: device memory. Per rank it writes 8 key bytes and 4 * (7 + ch)
// payload bytes and reads one Gaussian's row (about 60 bytes); the
// binary search reads log2(C) words of b_incl.
// Design: one thread per rank. Neighbouring ranks mostly share a
// Gaussian, so a warp's gathers hit a few cache lines and repeat in L1;
// the key and the field-major payload stores are fully coalesced. The
// upper levels of the binary search are the same for every thread and
// stay in cache.

#include <cuda_runtime.h>

namespace {

constexpr long long kDeadKey = 0xFFFFFFFFLL;

__global__ void binning_key_kernel(
    const int* __restrict__ b_incl, const int* __restrict__ tiles_touched,
    const int* __restrict__ rect_min, const int* __restrict__ rect_max,
    const float* __restrict__ mean2d, const float* __restrict__ conic,
    const float* __restrict__ opacity, const float* __restrict__ depth,
    const float* __restrict__ color, int C, int ch, int n, int total,
    int grid_x, int depth_bits, long long* __restrict__ key,
    float* __restrict__ payload) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;

  // owner: first g with b_incl[g] > q (upper bound)
  int lo = 0, hi = C;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b_incl[mid] > q) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const int g = min(lo, C - 1);
  const int tt = tiles_touched[g];
  const int j = q - (b_incl[g] - tt);

  long long k = kDeadKey;
  if (q < total && j >= 0 && j < tt) {
    const int rx = rect_min[2 * g];
    const int ry = rect_min[2 * g + 1];
    const int w = max(rect_max[2 * g] - rx, 1);
    const int jy = j / w;
    const int jx = j - jy * w;
    const long long tile = (long long)(ry + jy) * grid_x + (rx + jx);
    const unsigned int dk = __float_as_uint(depth[g]) >> (32 - depth_bits);
    k = (tile << depth_bits) | (long long)dk;
  }
  key[q] = k;

  const size_t N = (size_t)n;
  const size_t gs = (size_t)g;
  payload[0 * N + q] = mean2d[2 * gs];
  payload[1 * N + q] = mean2d[2 * gs + 1];
  payload[2 * N + q] = conic[3 * gs];
  payload[3 * N + q] = conic[3 * gs + 1];
  payload[4 * N + q] = conic[3 * gs + 2];
  payload[5 * N + q] = opacity[gs];
  payload[6 * N + q] = depth[gs];
  for (int c = 0; c < ch; ++c) {
    payload[(size_t)(7 + c) * N + q] = color[gs * ch + c];
  }
}

}  // namespace

extern "C" int binning_key(const void* b_incl, const void* tiles_touched,
                           const void* rect_min, const void* rect_max,
                           const void* mean2d, const void* conic,
                           const void* opacity, const void* depth,
                           const void* color, int C, int ch, int n, int total,
                           int grid_x, int depth_bits, void* key,
                           void* payload, void* stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  binning_key_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)b_incl, (const int*)tiles_touched, (const int*)rect_min,
      (const int*)rect_max, (const float*)mean2d, (const float*)conic,
      (const float*)opacity, (const float*)depth, (const float*)color, C, ch,
      n, total, grid_x, depth_bits, (long long*)key, (float*)payload);
  return (int)cudaGetLastError();
}

extern "C" const char* binning_key_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
