// Kernel B2: forward compositor, one 256-thread block per 16x16 tile.
//
// Replaces: gaussianeditor_tpu/ops/pallas_composite.py::make_forward_tile
// (the Pallas tile-grid forward of the sorted route). Block t walks the
// tile's depth-sorted rows [bounds[t], bounds[t+1]) of the field-major
// sorted payload [7 + ch, n] (mean2d x y, conic a b c, opacity, depth,
// color[ch]); each thread owns one pixel, at integer coordinates, and
// runs the front-to-back recurrence:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy, skipped if > 0;
//   alpha = min(0.99, opacity * exp(power)), skipped if < 1/255;
//   if T (1 - alpha) < 1e-4 the pixel is done, without contributing;
//   else color += alpha T color_i, depth += alpha T depth_i,
//        T *= 1 - alpha, n_contrib = tile-local position + 1.
// Outputs: color [T, 256, ch], depth, final_T [T, 256], n_contrib
// [T, 256] int32; an empty tile gives 0, 0, 1, 0. The Pallas kernel
// forms T as exp(prefix sum of log1p(-alpha)) over 128-row chunks; here
// it is multiplied row by row, as in the CUDA reference's renderCUDA, so
// the two agree up to f32 rounding.
//
// Bound: operations. Each evaluated (pixel, row) pair costs about 19
// f32 operations with one exp, and each contributing pair 2 ch + 3 more,
// while each row's 4 * (7 + ch) bytes are read once per tile, so at the
// main path's shapes the FP32 pipes, not memory, set the floor.
// Design: rows are staged through shared memory in batches of 256, one
// coalesced load per field, and read back as broadcasts (no bank
// conflicts); the block stops as soon as every pixel is done
// (__syncthreads_count). It uses the accurate expf, not __expf; the
// compiler's multiply-add contraction leaves it within f32 rounding of
// its plain torch version.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;  // threads per block: one per pixel
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTMin = 1e-4f;

template <int CH>
__global__ void __launch_bounds__(kPx) forward_tile_kernel(
    const int* __restrict__ bounds, const float* __restrict__ payload,
    long long n, int grid_x, float* __restrict__ out_color,
    float* __restrict__ out_depth, float* __restrict__ out_T,
    int* __restrict__ out_nc) {
  constexpr int P = 7 + CH;
  __shared__ float rows[P][kPx];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = (float)((t % grid_x) * kTile + p % kTile);
  const float py = (float)((t / grid_x) * kTile + p / kTile);
  const int start = bounds[t];
  const int end = bounds[t + 1];

  float T = 1.0f;
  float dsum = 0.0f;
  float acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = 0.0f;
  int last = 0;
  bool done = false;

  for (int base = start; base < end; base += kPx) {
    // also the barrier that keeps the previous batch's rows alive until
    // every thread has read them
    if (__syncthreads_count(done) == kPx) break;
    const int r = base + p;
    if (r < end) {
#pragma unroll
      for (int f = 0; f < P; ++f) rows[f][p] = payload[(size_t)f * n + r];
    }
    __syncthreads();
    const int m = min(kPx, end - base);
    for (int i = 0; i < m && !done; ++i) {
      const float dx = rows[0][i] - px;
      const float dy = rows[1][i] - py;
      const float power = -0.5f * (rows[2][i] * dx * dx + rows[4][i] * dy * dy)
                          - rows[3][i] * dx * dy;
      if (power > 0.0f) continue;
      const float alpha = fminf(kAlphaMax, rows[5][i] * expf(power));
      if (alpha < kAlphaMin) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < kTMin) {
        done = true;
        break;
      }
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[c] += w * rows[7 + c][i];
      dsum += w * rows[6][i];
      T = test_T;
      last = base - start + i + 1;
    }
  }

  const size_t o = (size_t)t * kPx + p;
#pragma unroll
  for (int c = 0; c < CH; ++c) out_color[o * CH + c] = acc[c];
  out_depth[o] = dsum;
  out_T[o] = T;
  out_nc[o] = last;
}

}  // namespace

extern "C" int forward_tile(const void* bounds, const void* payload,
                            long long n, int num_tiles, int grid_x, int ch,
                            void* color, void* depth, void* final_T,
                            void* n_contrib, void* stream) {
  if (num_tiles <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(num_tiles), block(kPx);
  cudaStream_t s = (cudaStream_t)stream;
  const int* b = (const int*)bounds;
  const float* pl = (const float*)payload;
  float* oc = (float*)color;
  float* od = (float*)depth;
  float* ot = (float*)final_T;
  int* on = (int*)n_contrib;
  switch (ch) {
    case 1:
      forward_tile_kernel<1><<<grid, block, 0, s>>>(b, pl, n, grid_x, oc, od,
                                                    ot, on);
      break;
    case 3:
      forward_tile_kernel<3><<<grid, block, 0, s>>>(b, pl, n, grid_x, oc, od,
                                                    ot, on);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* forward_tile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
