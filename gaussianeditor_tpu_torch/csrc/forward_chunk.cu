// Kernel B5: forward compositor over the chunk-aligned instance list (the
// dense route), one 256-thread block per 16x16 tile, one thread per pixel.
//
// Replaces: gaussianeditor_tpu/ops/pallas_composite.py::make_forward (the
// Pallas chunk-grid forward of the 'pallas4' route). Its input is the
// dense binning's instance matrix inst [NC, 7 + ch, 128] (per chunk:
// mean2d x y, conic a b c, opacity, depth, color[ch], each a row of 128
// lanes), in which no chunk straddles two tiles. The TPU grid walks the
// chunks in order and lets a tile's chunks add into one output block that
// stays in VMEM between grid steps. Blocks on Hopper run in no order, so
// here that sequential grid is a loop inside the tile's block: block t
// walks its chunks [bounds[t], bounds[t+1]) in order (the wrapper builds
// bounds from the chunk metadata; a tile's live chunks are contiguous and
// dead chunks trail every tile), carrying T, the accumulators and
// n_contrib in registers. For each chunk's live rows (lanes below
// n_valid) it runs kernel B2's per-row arithmetic:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy, skipped if > 0;
//   alpha = min(0.99, opacity * exp(power)), skipped if < 1/255;
//   if T (1 - alpha) < 1e-4 the pixel is done, without contributing;
//   else color += alpha T color_i, depth += alpha T depth_i,
//        T *= 1 - alpha, n_contrib = chunk offset + lane + 1.
// T is multiplied row by row, not formed as the TPU's exp(prefix sum of
// log1p(-alpha)), so n_contrib equals B2's on the same view. Outputs:
// color [T, 256, ch], depth, final_T [T, 256], n_contrib [T, 256] int32;
// a tile without chunks writes 0, 0, 1, 0.
//
// Bound: operations, as for B2: about 19 f32 operations with one exp for
// each evaluated (pixel, row) pair and 2 ch + 3 more for each
// contributing one, against 4 (7 + ch) bytes a row read once per tile.
// Design: each chunk's live rows are staged in shared memory with
// coalesced loads (neighbouring threads on neighbouring lanes) and read
// back as broadcasts; the block stops at the first chunk boundary at
// which every pixel is done (__syncthreads_count). ch 1 and 3 have their
// own instances, with the accumulators in registers; wider renders take
// an instance sized for 8 or for 32 channels, looping over the first ch.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;  // threads per block: one per pixel
constexpr int kChunk = 128;         // lanes of a chunk
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTMin = 1e-4f;

// CH: the channel count when it is 1 or 3, else the most channels the
// instance takes (ch <= CH at run time)
template <int CH>
__global__ void __launch_bounds__(kPx) forward_chunk_kernel(
    const int* __restrict__ bounds, const int* __restrict__ nvalid,
    const int* __restrict__ offset, const float* __restrict__ inst, int ch,
    int grid_x, float* __restrict__ out_color, float* __restrict__ out_depth,
    float* __restrict__ out_T, int* __restrict__ out_nc) {
  const int nch = CH <= 3 ? CH : ch;
  const int P = 7 + nch;
  __shared__ float rows[7 + CH][kChunk];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = (float)((t % grid_x) * kTile + p % kTile);
  const float py = (float)((t / grid_x) * kTile + p / kTile);

  float T = 1.0f;
  float dsum = 0.0f;
  float acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = 0.0f;
  int last = 0;
  bool done = false;

  const int c1 = bounds[t + 1];
  for (int c = bounds[t]; c < c1; ++c) {
    // also the barrier that keeps the previous chunk's rows alive until
    // every thread has read them
    if (__syncthreads_count(done) == kPx) break;
    const int nv = nvalid[c];
    const int off = offset[c];
    const float* src = inst + (size_t)c * P * kChunk;
    for (int idx = p; idx < P * kChunk; idx += kPx) {
      const int lane = idx % kChunk;
      if (lane < nv) rows[idx / kChunk][lane] = src[idx];
    }
    __syncthreads();
    for (int i = 0; i < nv && !done; ++i) {
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
      for (int k = 0; k < CH; ++k)
        if (k < nch) acc[k] += w * rows[7 + k][i];
      dsum += w * rows[6][i];
      T = test_T;
      last = off + i + 1;
    }
  }

  const size_t o = (size_t)t * kPx + p;
#pragma unroll
  for (int k = 0; k < CH; ++k)
    if (k < nch) out_color[o * nch + k] = acc[k];
  out_depth[o] = dsum;
  out_T[o] = T;
  out_nc[o] = last;
}

}  // namespace

extern "C" int forward_chunk(const void* bounds, const void* nvalid,
                             const void* offset, const void* inst,
                             int num_tiles, int grid_x, int ch, void* color,
                             void* depth, void* final_T, void* n_contrib,
                             void* stream) {
  if (num_tiles <= 0 || ch < 1 || ch > 32) return (int)cudaErrorInvalidValue;
  const dim3 grid(num_tiles), block(kPx);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(CH)                                                          \
  forward_chunk_kernel<CH><<<grid, block, 0, s>>>(                          \
      (const int*)bounds, (const int*)nvalid, (const int*)offset,           \
      (const float*)inst, ch, grid_x, (float*)color, (float*)depth,         \
      (float*)final_T, (int*)n_contrib)
  if (ch == 1)
    LAUNCH(1);
  else if (ch == 3)
    LAUNCH(3);
  else if (ch <= 8)
    LAUNCH(8);
  else
    LAUNCH(32);
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" const char* forward_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
