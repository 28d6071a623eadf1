// Kernel B2: forward compositor, one 256-thread block per 16x16 tile.
//
// Replaces: gaussianeditor_tpu/ops/pallas_composite.py::make_forward_tile
// (the Pallas tile-grid forward of the sorted route). Block t walks the
// tile's depth-sorted rows [bounds[t], bounds[t+1]) of the field-major
// sorted payload [7 + ch, n] (mean2d x y, conic a b c, opacity, depth,
// color[ch]), 256 rows a batch; each thread owns one pixel, at integer
// coordinates, and runs the front-to-back recurrence of
// composite_forward.cuh, n_contrib being the row's tile-local position
// + 1. Outputs: color [T, 256, ch], depth, final_T [T, 256], n_contrib
// [T, 256] int32; an empty tile gives 0, 0, 1, 0. The Pallas kernel
// forms T as exp(prefix sum of log1p(-alpha)) over 128-row chunks; here
// it is multiplied row by row, as in the CUDA reference's renderCUDA, so
// the two agree up to f32 rounding.
//
// Bound: operations. Each evaluated (pixel, row) pair costs about 19
// f32 operations with one exp, and each contributing pair 2 ch + 3 more,
// while each row's 4 * (7 + ch) bytes are read once per tile, so at the
// main path's shapes the FP32 pipes, not memory, set the floor.
//
// Design: the walk of composite_forward.cuh (16-byte row records, the
// exact pre-test before expf, rows in groups). Groups of 8 cost 64
// registers (4 blocks a SM) and beat groups of 4 or 16, and 8 with fewer
// registers (spills), on the H100 (probe_b2_b4.py). The block stops as
// soon as every pixel is done (__syncthreads_count).

#include "composite_forward.cuh"

namespace {

using namespace composite_forward;

constexpr int kGroup = 8;  // rows whose power is formed together

template <int CH>
__global__ void __launch_bounds__(kPx) forward_tile_kernel(
    const int* __restrict__ bounds, const float* __restrict__ payload,
    long long n, int grid_x, float* __restrict__ out_color,
    float* __restrict__ out_depth, float* __restrict__ out_T,
    int* __restrict__ out_nc) {
  __shared__ Rows<CH> rows;

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = (float)((t % grid_x) * kTile + p % kTile);
  const float py = (float)((t / grid_x) * kTile + p / kTile);
  const int start = bounds[t];
  const int end = bounds[t + 1];
  Pixel<CH> q;

  for (int base = start; base < end; base += kPx) {
    // also the barrier that keeps the previous batch's rows alive until
    // every thread has read them
    if (__syncthreads_count(q.done) == kPx) break;
    // past the tile's rows: a row that every pixel skips
    if (base + p < end)
      stage_row(rows, p, payload + base + p, n, CH);
    else
      stage_dead(rows, p);
    __syncthreads();
    walk<CH, kGroup>(rows, min(kPx, end - base), px, py, q,
                     [&](int i) { return base - start + i + 1; });
  }
  q.store((size_t)t * kPx + p, CH, out_color, out_depth, out_T, out_nc);
}

}  // namespace

extern "C" int forward_tile(const void* bounds, const void* payload,
                            long long n, int num_tiles, int grid_x, int ch,
                            void* color, void* depth, void* final_T,
                            void* n_contrib, void* stream) {
  if (num_tiles <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(num_tiles), block(kPx);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(CH)                                                       \
  forward_tile_kernel<CH><<<grid, block, 0, s>>>(                        \
      (const int*)bounds, (const float*)payload, n, grid_x, (float*)color, \
      (float*)depth, (float*)final_T, (int*)n_contrib)
  switch (ch) {
    case 1:
      LAUNCH(1);
      break;
    case 2:
      LAUNCH(2);
      break;
    case 3:
      LAUNCH(3);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" const char* forward_tile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
