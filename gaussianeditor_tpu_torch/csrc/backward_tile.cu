// Kernel B3: backward of the tile compositor, one 256-thread block per
// 16x16 tile, one thread per pixel.
//
// Replaces: gaussianeditor_tpu/ops/pallas_composite.py::make_backward_tile
// (the Pallas tile-grid backward of the sorted route). Block t walks its
// tile's depth-sorted rows [bounds[t], bounds[t+1]) of the field-major
// payload [7 + ch, n] front to back, as kernel B2 does, and rebuilds each
// pixel's transmittance T with B2's own arithmetic (T *= 1 - alpha), so
// the gating agrees with the forward's n_contrib. The suffix is S_total
// minus the running prefix, S_total from the forward's saved acc and
// final_T (pallas_composite.py:681-683, :757). The row math, the sums
// over the tile's pixels as TF32 tensor-core products of pixel moments,
// and the epilogue are those of composite_backward.cuh, shared with
// kernel B6.
//
// Each batch of kRows rows is staged in shared memory by cp.async (4
// bytes a copy: a tile's rows start anywhere, so 16-byte copies would
// not be aligned), double-buffered, so the next batch loads while this
// one is walked and multiplied. A row goes to column rank[i] of the
// output [7 + ch, n] (rank is a permutation, so each column is written
// once), where kernel B4 sums each Gaussian's contiguous ranks. `out`
// must hold zeros on entry (the wrapper fills it, in coalesced stores):
// the kernel writes only the rows of the batches it walks, so the rows
// past a tile's largest n_contrib and past the last tile stay zero
// without one scattered store each.
//
// Bound: bytes at the main path's shapes, with the operations close
// behind. The payload read and the rows written are each 4 (7 + ch)
// bytes a row, the rank 8; each (pixel, row) pair before the pixel's
// n_contrib costs the forward's 19 flops to rebuild alpha, and each
// contributing pair about 50 more. What the design does about it: the
// per-row sums over the tile's pixels cost two shared-memory stores per
// pair and tensor-core products, with two block barriers per batch of
// 32 rows, and the zero rows (1.26M of 2.07M at 512x512) cost one
// coalesced fill instead of a scattered store each.

#include "composite_backward.cuh"

namespace {

using namespace composite_backward;

template <int CH>
__global__ void __launch_bounds__(kPx, kMinBlocks) backward_tile_kernel(
    const int* __restrict__ bounds, const float* __restrict__ payload,
    const long long* __restrict__ rank, long long n, int num_tiles,
    int grid_x, const float* __restrict__ g_color,
    const float* __restrict__ g_depth, const float* __restrict__ g_T,
    const float* __restrict__ color, const float* __restrict__ depth,
    const float* __restrict__ final_T, const int* __restrict__ n_contrib,
    float* __restrict__ out) {
  constexpr int P = 7 + CH;  // payload fields
  constexpr int NF = feature_cols(CH);
  using L = Layout<NF>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int warp_nc[kWarps];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;

  const int start = bounds[t];
  const int end = bounds[t + 1];
  const size_t o = (size_t)t * kPx + p;
  const int tx = t % grid_x, ty = t / grid_x;
  const float px = (float)(tx * kTile + p % kTile);
  const float py = (float)(ty * kTile + p / kTile);

  PixelState<CH> px_state;
  px_state.load(o, CH, g_color, g_depth, g_T, color, depth, final_T,
                n_contrib);
  const int max_nc = block_max_nc(px_state.nc, warp_nc);
  const int active_end = start + max_nc;

  float* dw = smem + L::kDW + warp * L::kWarpDW;
  float* gw = smem + L::kG + warp * L::kWarpG;
  float* stage = smem + L::kStage;  // [2][P][kRows]
  store_features<CH, NF>(gw, lane, px_state.gc, px_state.gd, CH);

  auto stage_rows = [&](int base, int buf) {
    float* dst = stage + buf * P * kRows;
    const int cnt = min(kRows, end - base);
    for (int idx = p; idx < P * kRows; idx += kPx) {
      const int f = idx / kRows;
      const int r = idx - f * kRows;
      if (r < cnt) cp_async4(dst + idx, payload + (size_t)f * n + base + r);
    }
    cp_async_commit();
  };
  if (start < active_end) stage_rows(start, 0);
  cp_async_wait_all();
  __syncthreads();

  float T = 1.0f;
  float prefix = 0.0f;
  const int i_row = p / kJ;  // the row this thread finishes
  const int j_row = p - i_row * kJ;
  int buf = 0;
  for (int base = start; base < active_end; base += kRows, buf ^= 1) {
    const int cnt = min(kRows, end - base);
    if (base + kRows < active_end) stage_rows(base + kRows, buf ^ 1);
    const float* f = stage + buf * P * kRows;
    for (int i = 0; i < kRows; ++i) {
      float dpower, w;
      walk_row<CH>(f, kRows, i, i < cnt && base - start + i < px_state.nc,
                   CH, px_state.gc, px_state.gd, px_state.S, px, py, T,
                   prefix, dpower, w);
      dw[i * kLd + lane] = dpower;
      dw[(kRows + i) * kLd + lane] = w;
    }
    __syncwarp();
    warp_products<NF>(dw, gw, lane);
    __syncthreads();
    const int i = i_row;
    const long long r = i < cnt ? rank[base + i] : 0;
    finish_row<NF>(smem, i, j_row, CH, i < cnt, f[i], f[kRows + i],
                   f[2 * kRows + i], f[3 * kRows + i], f[4 * kRows + i],
                   f[5 * kRows + i], tx * kTile, ty * kTile,
                   [&](int k, float v) { out[(size_t)k * n + r] = v; });
    // the next batch's rows have landed; D, W, the partials and this
    // batch's staging buffer are free again
    cp_async_wait_all();
    __syncthreads();
  }
}

template <int CH>
size_t smem_bytes() {
  return Layout<feature_cols(CH)>::bytes((7 + CH) * kRows);
}

template <int CH>
cudaError_t launch(const dim3& grid, cudaStream_t s, const void* bounds,
                   const void* payload, const void* rank, long long n,
                   int num_tiles, int grid_x, const void* g_color,
                   const void* g_depth, const void* g_T, const void* color,
                   const void* depth, const void* final_T,
                   const void* n_contrib, void* out) {
  const size_t bytes = smem_bytes<CH>();
  cudaError_t e = set_smem(backward_tile_kernel<CH>, bytes);
  if (e != cudaSuccess) return e;
  backward_tile_kernel<CH><<<grid, kPx, bytes, s>>>(
      (const int*)bounds, (const float*)payload, (const long long*)rank, n,
      num_tiles, grid_x, (const float*)g_color, (const float*)g_depth,
      (const float*)g_T, (const float*)color, (const float*)depth,
      (const float*)final_T, (const int*)n_contrib, (float*)out);
  return cudaGetLastError();
}

template <int CH>
cudaError_t occupancy(int* smem, int* blocks) {
  *smem = (int)smem_bytes<CH>();
  cudaError_t e = set_smem(backward_tile_kernel<CH>, *smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, backward_tile_kernel<CH>, kPx, (size_t)*smem);
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
  const dim3 grid(num_tiles);  // one block per tile
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(CH)                                                         \
  launch<CH>(grid, s, bounds, payload, rank, n, num_tiles, grid_x, g_color, \
             g_depth, g_T, color, depth, final_T, n_contrib, out)
  switch (ch) {
    case 1:
      return (int)LAUNCH(1);
    case 2:
      return (int)LAUNCH(2);
    case 3:
      return (int)LAUNCH(3);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
}

// Dynamic shared memory of the ch-channel instance and the blocks of it
// that fit on one SM; returns a CUDA error code
extern "C" int backward_tile_occupancy(int ch, int* smem, int* blocks) {
  switch (ch) {
    case 1:
      return (int)occupancy<1>(smem, blocks);
    case 2:
      return (int)occupancy<2>(smem, blocks);
    case 3:
      return (int)occupancy<3>(smem, blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* backward_tile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
