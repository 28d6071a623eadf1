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
//
// What set the time of one row at a time (measured on the H100 by
// probe_b2_b4.py): the issue rate of 54 instructions a pair over all
// pairs, and the longest tiles, which walk up to 2.8x the mean and end
// last, latency-bound on one dependent chain a row. The design does
// three things about it, none of which changes a result:
// - Rows are staged in shared memory as three 16-byte records, (x, y, a,
//   b), (c, opacity, thr, depth) and the colors, so a pair reads two or
//   three 128-bit broadcasts instead of ten 32-bit ones.
// - thr = logf(1 / (255 opacity)) - kMargin, computed once per row at
//   staging, is an exact pre-test: power < thr implies that the f32
//   alpha is below 1/255 (see thr_of), so such a pair is skipped without
//   its expf. Pairs within the margin take the exact test.
// - Rows are walked in groups of kGroup: the power and pre-test of the
//   group's rows (independent of T) come first, without a branch, so
//   their latencies overlap; only the rows that pass take the serial
//   T / acc / n_contrib update, in row order. Groups of 8 cost 64
//   registers (4 blocks a SM) and beat groups of 4 or 16, and 8 with
//   fewer registers (spills).
// Each pair that is not skipped runs the parent's arithmetic in the
// parent's order (the same expressions for power and alpha, the accurate
// expf), so color, depth, final_T and n_contrib are bitwise those of one
// row at a time. The block stops as soon as every pixel is done
// (__syncthreads_count).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;  // threads per block: one per pixel
constexpr int kGroup = 8;           // rows whose power is formed together
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTMin = 1e-4f;
constexpr float kMargin = 1e-3f;
static_assert(kPx % kGroup == 0, "a batch holds whole groups");

// The pre-test threshold of a row: if power < thr_of(op) then the f32
// alpha = fminf(0.99, op * expf(power)) < 1/255. With X = 1 / (255 op)
// (2 roundings) and logf within 1 ulp, thr <= ln X - kMargin + 2e-6 for
// every op, so op * exp(power) < exp(2e-6 - kMargin) / 255, and expf's
// 2 ulp and the product's rounding stay far inside the 1e-3 margin. An
// opacity of 0 (or so small that 255 op underflows) gives +inf: every
// pair is skipped, as its alpha is 0. A NaN thr skips nothing.
__device__ __forceinline__ float thr_of(float op) {
  return logf(1.0f / (255.0f * op)) - kMargin;
}

// The row's power at pixel (px, py), from its records (x, y, a, b) and
// (c, ...): the parent's expression, which the compiler contracts as it
// did the parent's
__device__ __forceinline__ float power_of(const float4& r0, const float4& r1,
                                          float px, float py) {
  const float dx = r0.x - px;
  const float dy = r0.y - py;
  return -0.5f * (r0.z * dx * dx + r1.x * dy * dy) - r0.w * dx * dy;
}

template <int CH>
__global__ void __launch_bounds__(kPx) forward_tile_kernel(
    const int* __restrict__ bounds, const float* __restrict__ payload,
    long long n, int grid_x, float* __restrict__ out_color,
    float* __restrict__ out_depth, float* __restrict__ out_T,
    int* __restrict__ out_nc) {
  // (x, y, a, b), (c, opacity, thr, depth), (color[0..CH), 0)
  __shared__ float4 rec0[kPx], rec1[kPx], rec2[kPx];

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
      const float* f = payload + r;
      const float op = f[5 * n];
      float col[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < CH; ++c) col[c] = f[(7 + c) * n];
      rec0[p] = make_float4(f[0], f[n], f[2 * n], f[3 * n]);
      rec1[p] = make_float4(f[4 * n], op, thr_of(op), f[6 * n]);
      rec2[p] = make_float4(col[0], col[1], col[2], 0.0f);
    } else {
      // past the tile's rows: a row that every pixel skips
      rec0[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      rec1[p] = make_float4(0.0f, 0.0f, __int_as_float(0x7f800000), 0.0f);
    }
    __syncthreads();
    const int m = min(kPx, end - base);
    for (int i = 0; i < m && !done; i += kGroup) {
      float power[kGroup];
      bool pass[kGroup];
      bool any = false;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        power[j] = power_of(rec0[i + j], rec1[i + j], px, py);
        pass[j] = !(power[j] > 0.0f) && !(power[j] < rec1[i + j].z);
        any |= pass[j];
      }
      if (!any) continue;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (!pass[j]) continue;
        const float4 r1 = rec1[i + j];
        const float alpha = fminf(kAlphaMax, r1.y * expf(power[j]));
        if (alpha < kAlphaMin) continue;
        const float test_T = T * (1.0f - alpha);
        if (test_T < kTMin) {
          done = true;
          break;
        }
        const float w = alpha * T;
        const float4 r2 = rec2[i + j];
        const float col[3] = {r2.x, r2.y, r2.z};
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[c] += w * col[c];
        dsum += w * r1.w;
        T = test_T;
        last = base - start + i + j + 1;
      }
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
    case 2:
      forward_tile_kernel<2><<<grid, block, 0, s>>>(b, pl, n, grid_x, oc, od,
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
