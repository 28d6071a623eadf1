// Kernel B6: backward of the chunk-grid compositor (the dense route), one
// 256-thread block per 16x16 tile, one thread per pixel.
//
// Replaces: gaussianeditor_tpu/ops/pallas_composite.py::make_backward (the
// Pallas chunk-grid backward of the 'pallas4' route). The TPU grid walks
// the chunks in order and carries each pixel's log T and running suffix
// term S across a tile's chunks in VMEM scratch (logt_sc, s_sc, stot_sc).
// Blocks on Hopper run in no order, so the sequential grid is a loop
// inside the tile's block: block t walks its chunks [bounds[t],
// bounds[t+1]) of inst [NC, 7 + ch, 128] in order, carrying T and the
// prefix in registers, and rebuilds T with kernel B5's arithmetic (T *= 1
// - alpha), so the gating agrees with the forward's n_contrib. For the
// row at tile position pos and pixel p, gated by pos < n_contrib[p],
// power <= 0 and alpha >= 1/255 (kernel B3's math):
//   c_hat  = g_color . color_i + g_depth depth_i
//   prefix += alpha T c_hat                     (inclusive)
//   dpower  = amc (T c_hat - (S_total - prefix) / (1 - alpha)),
//             S_total = g_color . color + g_depth depth + g_T final_T,
//             amc = alpha if alpha_raw < 0.99 else 0 (the alpha cap
//             passes no gradient to power or opacity; color gets one)
// and the pixel's partials of the row's gradient are
//   d mean2d = -dpower (a dx + b dy, c dy + b dx)
//   d conic  = -dpower (dx^2 / 2, dx dy, dy^2 / 2)
//   d opacity: dpower (times 1 / opacity once summed)
//   d color  = g_color alpha T,  d depth = g_depth alpha T.
// Each row's 7 + ch sums over the 256 pixels are taken in a fixed order:
// a warp shuffle tree, then the 8 warps in index order. No atomics, so
// the rows repeat bitwise. Output: the aligned rows [NC, 7 + ch, 128],
// the layout the TPU kernel emits; the caller gathers them into pre-sort
// rank order for kernel B4. Lanes at or past n_valid, rows past the
// tile's largest n_contrib (the TPU's `active` gate), and the dead chunks
// past the last tile (written by the blocks after the tiles') are zeros.
//
// Bound: bytes at the main path's shapes, with the operations close
// behind, as for B3: the instance rows read and the gradient rows written
// are each 4 (7 + ch) bytes a lane, and each (pixel, row) pair before the
// pixel's n_contrib costs the forward's 19 flops to rebuild alpha, each
// contributing pair about 50 more, the sum over the tile included.
// Design: a chunk's live rows are staged in shared memory with coalesced
// loads, then walked in batches of 32 (16 for the 32-channel instance) so
// that the warp partials fit in shared memory; a warp whose 32 pixels all
// skip a row skips its shuffles. ch 1 and 3 have their own instances;
// wider renders take an instance sized for 8 or for 32 channels.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;  // threads per block: one per pixel
constexpr int kWarps = kPx / 32;
constexpr int kChunk = 128;         // lanes of a chunk
constexpr int kZeroBlocks = 32;     // blocks that zero the dead chunks
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;

// CH: the channel count when it is 1 or 3, else the most channels the
// instance takes (ch <= CH at run time)
template <int CH>
__global__ void __launch_bounds__(kPx) backward_chunk_kernel(
    const int* __restrict__ bounds, const int* __restrict__ nvalid,
    const int* __restrict__ offset, const float* __restrict__ inst,
    int num_chunks, int num_tiles, int grid_x, int ch,
    const float* __restrict__ g_color, const float* __restrict__ g_depth,
    const float* __restrict__ g_T, const float* __restrict__ color,
    const float* __restrict__ depth, const float* __restrict__ final_T,
    const int* __restrict__ n_contrib, float* __restrict__ out) {
  constexpr int kBatch = CH <= 8 ? 32 : 16;  // rows summed per barrier
  constexpr int GM = 7 + CH;                 // most gradient fields
  const int nch = CH <= 3 ? CH : ch;
  const int P = 7 + nch;  // instance fields
  const int G = 7 + nch;  // gradient fields: 2 + 3 + 1 + ch + 1
  __shared__ float rows[7 + CH][kChunk];
  __shared__ float part[kBatch][kWarps][GM];
  __shared__ int warp_nc[kWarps];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;

  if (t >= num_tiles) {
    // the dead chunks [bounds[num_tiles], num_chunks): zero rows
    const size_t stride = (size_t)(gridDim.x - num_tiles) * kPx;
    const size_t end = (size_t)num_chunks * G * kChunk;
    for (size_t i = (size_t)bounds[num_tiles] * G * kChunk +
                    (size_t)(t - num_tiles) * kPx + p;
         i < end; i += stride)
      out[i] = 0.0f;
    return;
  }

  const size_t o = (size_t)t * kPx + p;
  const float px = (float)((t % grid_x) * kTile + p % kTile);
  const float py = (float)((t / grid_x) * kTile + p / kTile);

  float gc[CH];
  float S = g_T[o] * final_T[o];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    gc[c] = 0.0f;
    if (c < nch) {
      gc[c] = g_color[o * nch + c];
      S += gc[c] * color[o * nch + c];
    }
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

  float T = 1.0f;
  float prefix = 0.0f;
  const int c1 = bounds[t + 1];
  for (int c = bounds[t]; c < c1; ++c) {
    const int off = offset[c];
    // rows any pixel of the tile can take: uniform over the block
    const int lim = max(0, min(nvalid[c], max_nc - off));
    float* dst = out + (size_t)c * G * kChunk;
    if (lim > 0) {
      const float* src = inst + (size_t)c * P * kChunk;
      for (int idx = p; idx < P * kChunk; idx += kPx) {
        const int l = idx % kChunk;
        if (l < lim) rows[idx / kChunk][l] = src[idx];
      }
      __syncthreads();
      for (int base = 0; base < lim; base += kBatch) {
        const int cnt = min(kBatch, lim - base);
        for (int i = 0; i < cnt; ++i) {
          const int r = base + i;
          float v[GM];
#pragma unroll
          for (int k = 0; k < GM; ++k) v[k] = 0.0f;
          bool on = false;
          if (off + r < nc) {
            // B5's arithmetic, so that the skips agree with the forward's
            const float dx = rows[0][r] - px;
            const float dy = rows[1][r] - py;
            const float power =
                -0.5f * (rows[2][r] * dx * dx + rows[4][r] * dy * dy) -
                rows[3][r] * dx * dy;
            if (!(power > 0.0f)) {
              const float alpha_raw = rows[5][r] * expf(power);
              const float alpha = fminf(kAlphaMax, alpha_raw);
              if (!(alpha < kAlphaMin)) {
                on = true;
                const float w = alpha * T;
                float c_hat = gd * rows[6][r];
#pragma unroll
                for (int k = 0; k < CH; ++k)
                  if (k < nch) c_hat += gc[k] * rows[7 + k][r];
                prefix += w * c_hat;
                const float f = 1.0f - alpha;
                const float amc = alpha_raw < kAlphaMax ? alpha : 0.0f;
                const float dpower = amc * (T * c_hat - (S - prefix) / f);
                v[0] = -dpower * (rows[2][r] * dx + rows[3][r] * dy);
                v[1] = -dpower * (rows[4][r] * dy + rows[3][r] * dx);
                v[2] = -0.5f * dpower * dx * dx;
                v[3] = -dpower * dx * dy;
                v[4] = -0.5f * dpower * dy * dy;
                v[5] = dpower;
                // indices known at compile time keep v in registers
#pragma unroll
                for (int k = 0; k <= CH; ++k) {
                  if (k == nch)
                    v[6 + k] = gd * w;
                  else if (k < nch)
                    v[6 + k] = gc[k < CH ? k : 0] * w;
                }
                T = T * (1.0f - alpha);
              }
            }
          }
          if (__any_sync(0xffffffffu, on)) {
#pragma unroll
            for (int k = 0; k < GM; ++k) {
              if (k < G) {
#pragma unroll
                for (int s = 16; s > 0; s >>= 1)
                  v[k] += __shfl_down_sync(0xffffffffu, v[k], s);
              }
            }
          }
          if (lane == 0) {
#pragma unroll
            for (int k = 0; k < GM; ++k)
              if (k < G) part[i][warp][k] = v[k];
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
            const float op = rows[5][base + i];
            s *= op > 0.0f ? 1.0f / op : 0.0f;
          }
          dst[(size_t)k * kChunk + base + i] = s;
        }
        // the next batch overwrites part, the next chunk rows
        __syncthreads();
      }
    }
    // lanes past the live rows, or past every pixel's n_contrib
    for (int idx = p; idx < G * kChunk; idx += kPx)
      if (idx % kChunk >= lim) dst[idx] = 0.0f;
  }
}

}  // namespace

extern "C" int backward_chunk(const void* bounds, const void* nvalid,
                              const void* offset, const void* inst,
                              int num_chunks, int num_tiles, int grid_x,
                              int ch, const void* g_color, const void* g_depth,
                              const void* g_T, const void* color,
                              const void* depth, const void* final_T,
                              const void* n_contrib, void* out, void* stream) {
  if (num_tiles <= 0 || num_chunks <= 0 || ch < 1 || ch > 32)
    return (int)cudaErrorInvalidValue;
  // one block per tile, then the blocks that zero the dead chunks
  const dim3 grid(num_tiles + kZeroBlocks), block(kPx);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(CH)                                                           \
  backward_chunk_kernel<CH><<<grid, block, 0, s>>>(                          \
      (const int*)bounds, (const int*)nvalid, (const int*)offset,            \
      (const float*)inst, num_chunks, num_tiles, grid_x, ch,                 \
      (const float*)g_color, (const float*)g_depth, (const float*)g_T,       \
      (const float*)color, (const float*)depth, (const float*)final_T,       \
      (const int*)n_contrib, (float*)out)
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

extern "C" const char* backward_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
