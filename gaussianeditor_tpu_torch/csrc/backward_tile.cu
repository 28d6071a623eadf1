// Kernel B3: backward of the tile compositor, one 256-thread block per
// 16x16 tile, one thread per pixel.
//
// Replaces: gaussianeditor_tpu/ops/pallas_composite.py::make_backward_tile
// (the Pallas tile-grid backward of the sorted route). Block t walks its
// tile's depth-sorted rows [bounds[t], bounds[t+1]) of the field-major
// payload [7 + ch, n] front to back, as kernel B2 does, and rebuilds each
// pixel's transmittance T with B2's own arithmetic (T *= 1 - alpha), so
// the gating agrees with the forward's n_contrib. For row i and pixel p,
// gated by pos < n_contrib[p], power <= 0 and alpha >= 1/255:
//   c_hat  = g_color . color_i + g_depth depth_i
//   prefix += alpha T c_hat                     (inclusive)
//   suffix  = S_total - prefix, S_total = g_acc . acc + g_T final_T
//   dpower  = amc (T c_hat - suffix / (1 - alpha)),
//             amc = alpha if alpha_raw < 0.99 else 0 (the alpha cap passes
//             no gradient to power or opacity; color still gets one)
// and the pixel's partials of the row's gradient are
//   d mean2d = -dpower (a dx + b dy, c dy + b dx)
//   d conic  = -dpower (dx^2 / 2, dx dy, dy^2 / 2)
//   d opacity: dpower (times 1 / opacity once summed)
//   d color  = g_color alpha T,  d depth = g_depth alpha T.
// The suffix is S_total minus the running prefix, S_total from the
// forward's saved acc and final_T (pallas_composite.py:681-683, :757).
//
// Each row's 7 + ch sums over the 256 pixels are taken in a fixed order:
// a warp shuffle tree, then the 8 warps in index order. No atomics, so
// the result repeats bitwise. The row goes to column rank[i] of the
// output [7 + ch, n] (rank is a permutation, so each column is written
// once), where kernel B4 sums each Gaussian's contiguous ranks. Rows at
// or past the tile's largest n_contrib are written as zeros; one extra
// block writes zeros for the sorted rows past the last tile.
//
// Bound: bytes at the main path's shapes, with the operations close
// behind. The payload read and the rows written are each 4 (7 + ch)
// bytes a row, the rank 8; each (pixel, row) pair before the pixel's
// n_contrib costs the forward's 19 flops to rebuild alpha, and each
// contributing pair about 50 more, the sum over the tile included. The
// TPU kernel forms the pixel moments with matrix-unit products in
// tile-local coordinates; here each pixel's partials are summed in the
// block, the same function, and a warp whose 32 pixels all skip a row
// skips its shuffles.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;  // threads per block: one per pixel
constexpr int kWarps = kPx / 32;
constexpr int kBatch = 32;          // rows staged through shared memory
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;

template <int CH>
__global__ void __launch_bounds__(kPx) backward_tile_kernel(
    const int* __restrict__ bounds, const float* __restrict__ payload,
    const long long* __restrict__ rank, long long n, int num_tiles,
    int grid_x, const float* __restrict__ g_color,
    const float* __restrict__ g_depth, const float* __restrict__ g_T,
    const float* __restrict__ color, const float* __restrict__ depth,
    const float* __restrict__ final_T, const int* __restrict__ n_contrib,
    float* __restrict__ out) {
  constexpr int P = 7 + CH;  // payload fields
  constexpr int G = 7 + CH;  // gradient fields: 2 + 3 + 1 + CH + 1
  __shared__ float rows[P][kBatch];
  __shared__ float part[kBatch][kWarps][G];
  __shared__ int warp_nc[kWarps];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;

  if (t == num_tiles) {
    // sorted rows past the last tile (dead ranks): zero rows
    for (long long i = bounds[num_tiles] + p; i < n; i += kPx) {
      const long long r = rank[i];
#pragma unroll
      for (int k = 0; k < G; ++k) out[(size_t)k * n + r] = 0.0f;
    }
    return;
  }

  const int start = bounds[t];
  const int end = bounds[t + 1];
  const size_t o = (size_t)t * kPx + p;
  const float px = (float)((t % grid_x) * kTile + p % kTile);
  const float py = (float)((t / grid_x) * kTile + p / kTile);

  float gc[CH];
  float S = g_T[o] * final_T[o];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    gc[c] = g_color[o * CH + c];
    S += gc[c] * color[o * CH + c];
  }
  const float gd = g_depth[o];
  S += gd * depth[o];
  const int nc = n_contrib[o];

  const int wmax = __reduce_max_sync(0xffffffffu, nc);
  if (lane == 0) warp_nc[warp] = wmax;
  __syncthreads();
  int max_nc = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) max_nc = max(max_nc, warp_nc[w]);
  const int active_end = start + max_nc;

  float T = 1.0f;
  float prefix = 0.0f;
  for (int base = start; base < end; base += kBatch) {
    const int cnt = min(kBatch, end - base);
    if (base < active_end) {  // uniform over the block
      if (p < cnt) {
#pragma unroll
        for (int f = 0; f < P; ++f)
          rows[f][p] = payload[(size_t)f * n + base + p];
      }
      __syncthreads();
      for (int i = 0; i < cnt; ++i) {
        float v[G];
#pragma unroll
        for (int k = 0; k < G; ++k) v[k] = 0.0f;
        bool on = false;
        if (base - start + i < nc) {
          // B2's arithmetic, so that the skips agree with the forward's
          const float dx = rows[0][i] - px;
          const float dy = rows[1][i] - py;
          const float power =
              -0.5f * (rows[2][i] * dx * dx + rows[4][i] * dy * dy) -
              rows[3][i] * dx * dy;
          if (!(power > 0.0f)) {
            const float alpha_raw = rows[5][i] * expf(power);
            const float alpha = fminf(kAlphaMax, alpha_raw);
            if (!(alpha < kAlphaMin)) {
              on = true;
              const float w = alpha * T;
              float c_hat = gd * rows[6][i];
#pragma unroll
              for (int c = 0; c < CH; ++c) c_hat += gc[c] * rows[7 + c][i];
              prefix += w * c_hat;
              const float f = 1.0f - alpha;
              const float amc = alpha_raw < kAlphaMax ? alpha : 0.0f;
              const float dpower = amc * (T * c_hat - (S - prefix) / f);
              v[0] = -dpower * (rows[2][i] * dx + rows[3][i] * dy);
              v[1] = -dpower * (rows[4][i] * dy + rows[3][i] * dx);
              v[2] = -0.5f * dpower * dx * dx;
              v[3] = -dpower * dx * dy;
              v[4] = -0.5f * dpower * dy * dy;
              v[5] = dpower;
#pragma unroll
              for (int c = 0; c < CH; ++c) v[6 + c] = gc[c] * w;
              v[6 + CH] = gd * w;
              T = T * (1.0f - alpha);
            }
          }
        }
        if (__any_sync(0xffffffffu, on)) {
#pragma unroll
          for (int k = 0; k < G; ++k) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < G; ++k) part[i][warp][k] = v[k];
        }
      }
      __syncthreads();
      for (int idx = p; idx < cnt * G; idx += kPx) {
        const int i = idx / G;
        const int k = idx - i * G;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += part[i][w][k];
        if (k == 5) {
          const float op = rows[5][i];
          s *= op > 0.0f ? 1.0f / op : 0.0f;
        }
        out[(size_t)k * n + rank[base + i]] = s;
      }
    } else {
      for (int idx = p; idx < cnt * G; idx += kPx) {
        const int i = idx / G;
        const int k = idx - i * G;
        out[(size_t)k * n + rank[base + i]] = 0.0f;
      }
    }
    // the next batch overwrites rows and part
    __syncthreads();
  }
}

}  // namespace

extern "C" int backward_tile(const void* bounds, const void* payload,
                             const void* rank, long long n, int num_tiles,
                             int grid_x, int ch, const void* g_color,
                             const void* g_depth, const void* g_T,
                             const void* color, const void* depth,
                             const void* final_T, const void* n_contrib,
                             void* out, void* stream) {
  if (num_tiles <= 0) return (int)cudaErrorInvalidValue;
  // one block per tile, and one for the rows past the last tile
  const dim3 grid(num_tiles + 1), block(kPx);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(CH)                                                          \
  backward_tile_kernel<CH><<<grid, block, 0, s>>>(                          \
      (const int*)bounds, (const float*)payload, (const long long*)rank, n, \
      num_tiles, grid_x, (const float*)g_color, (const float*)g_depth,      \
      (const float*)g_T, (const float*)color, (const float*)depth,          \
      (const float*)final_T, (const int*)n_contrib, (float*)out)
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

extern "C" const char* backward_tile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
