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
// - alpha), so the gating agrees with the forward's n_contrib. The row
// math, the sums over the tile's pixels as TF32 tensor-core products of
// pixel moments, and the epilogue are those of composite_backward.cuh,
// shared with kernel B3; a row at tile position pos is live for pixel p
// while pos < n_contrib[p].
//
// Each chunk [7 + ch, 128] is one contiguous block of inst: one thread
// copies it to shared memory with a 1-D bulk copy (cp.async.bulk) that
// completes on an mbarrier, double-buffered, so the next chunk loads
// while this one is walked in batches of kRows rows. Output: the aligned
// rows [NC, 7 + ch, 128], the layout the TPU kernel emits; the caller
// gathers them into pre-sort rank order for kernel B4. Lanes at or past
// n_valid, rows past the tile's largest n_contrib (the TPU's `active`
// gate; zeros without the products) and the dead chunks past the last
// tile (written by the blocks after the tiles') are zeros.
//
// Bound: bytes at the main path's shapes, with the operations close
// behind, as for B3: the instance rows read and the gradient rows written
// are each 4 (7 + ch) bytes a lane, and each (pixel, row) pair before the
// pixel's n_contrib costs the forward's 19 flops to rebuild alpha, each
// contributing pair about 50 more. ch 1 and 3 have their own instances;
// wider renders take an instance sized for 8 or for 32 channels (the
// gfeat product is then 16 or 40 columns wide).

#include "composite_backward.cuh"

namespace {

using namespace composite_backward;

constexpr int kChunk = 128;      // lanes of a chunk
constexpr int kZeroBlocks = 32;  // blocks that zero the dead chunks

// CH: the channel count when it is 1 or 3, else the most channels the
// instance takes (ch <= CH at run time)
template <int CH>
__global__ void __launch_bounds__(kPx, CH <= 8 ? kMinBlocks : 1)
    backward_chunk_kernel(
    const int* __restrict__ bounds, const int* __restrict__ nvalid,
    const int* __restrict__ offset, const float* __restrict__ inst,
    int num_chunks, int num_tiles, int grid_x, int ch,
    const float* __restrict__ g_color, const float* __restrict__ g_depth,
    const float* __restrict__ g_T, const float* __restrict__ color,
    const float* __restrict__ depth, const float* __restrict__ final_T,
    const int* __restrict__ n_contrib, float* __restrict__ out) {
  constexpr int NF = feature_cols(CH);
  using L = Layout<NF>;
  const int nch = CH <= 3 ? CH : ch;
  const int P = 7 + nch;  // instance fields
  const int G = 7 + nch;  // gradient fields: 2 + 3 + 1 + ch + 1
  extern __shared__ __align__(16) float smem[];
  __shared__ int warp_nc[kWarps];
  __shared__ __align__(8) uint64_t bar[2];

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
  const int tx = t % grid_x, ty = t / grid_x;
  const float px = (float)(tx * kTile + p % kTile);
  const float py = (float)(ty * kTile + p / kTile);

  if (p == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    mbar_init_fence();
  }
  PixelState<CH> px_state;
  px_state.load(o, nch, g_color, g_depth, g_T, color, depth, final_T,
                n_contrib);
  // (its barrier also publishes the mbarriers' initialisation)
  const int max_nc = block_max_nc(px_state.nc, warp_nc);

  float* dw = smem + L::kDW + warp * L::kWarpDW;
  float* gw = smem + L::kG + warp * L::kWarpG;
  float* stage = smem + L::kStage;  // [2][7 + CH][kChunk]
  store_features<CH, NF>(gw, lane, px_state.gc, px_state.gd, nch);
  __syncwarp();

  // rows of chunk c that any pixel of the tile can take: uniform over
  // the block, and positive for a prefix of the tile's chunks
  auto live_rows = [&](int c) {
    return max(0, min(nvalid[c], max_nc - offset[c]));
  };
  const uint32_t chunk_bytes = (uint32_t)(P * kChunk * sizeof(float));
  auto load_chunk = [&](int c, int buf) {
    bulk_load(stage + buf * (7 + CH) * kChunk,
              inst + (size_t)c * P * kChunk, chunk_bytes, &bar[buf]);
  };

  const int c0 = bounds[t];
  const int c1 = bounds[t + 1];
  float T = 1.0f;
  float prefix = 0.0f;
  const int i_row = p / kJ;  // the row this thread finishes
  const int j_row = p - i_row * kJ;
  int loaded = 0;      // chunks staged so far
  int prefetched = -1; // the chunk already on its way to the next buffer
  for (int c = c0; c < c1; ++c) {
    const int lim = live_rows(c);
    float* dst = out + (size_t)c * G * kChunk;
    if (lim > 0) {
      // both buffers were last read before the previous barrier
      const int buf = loaded & 1;
      if (p == 0 && prefetched != c) load_chunk(c, buf);
      if (c + 1 < c1 && live_rows(c + 1) > 0) {
        if (p == 0) load_chunk(c + 1, buf ^ 1);
        prefetched = c + 1;
      }
      mbar_wait(&bar[buf], (loaded >> 1) & 1);
      ++loaded;
      const float* f = stage + buf * (7 + CH) * kChunk;
      const int off = offset[c];
      for (int base = 0; base < lim; base += kRows) {
        const int cnt = min(kRows, lim - base);
        for (int i = 0; i < kRows; ++i) {
          float dpower, w;
          walk_row<CH>(f, kChunk, base + i,
                       i < cnt && off + base + i < px_state.nc, nch,
                       px_state.gc, px_state.gd, px_state.S, px, py, T,
                       prefix, dpower, w);
          dw[i * kLd + lane] = dpower;
          dw[(kRows + i) * kLd + lane] = w;
        }
        __syncwarp();
        warp_products<NF>(dw, gw, lane);
        __syncthreads();
        const int r = base + i_row;
        finish_row<NF>(smem, i_row, j_row, nch, i_row < cnt, f[r],
                       f[kChunk + r], f[2 * kChunk + r], f[3 * kChunk + r],
                       f[4 * kChunk + r], f[5 * kChunk + r], tx * kTile,
                       ty * kTile, [&](int k, float v) {
                         dst[(size_t)k * kChunk + r] = v;
                       });
        // D, W, the partials and (after the chunk's last batch) its
        // staging buffer are free again
        __syncthreads();
      }
    }
    // lanes past the live rows, or past every pixel's n_contrib
    for (int idx = p; idx < G * kChunk; idx += kPx)
      if (idx % kChunk >= lim) dst[idx] = 0.0f;
  }
}

template <int CH>
size_t smem_bytes() {
  return Layout<feature_cols(CH)>::bytes((7 + CH) * kChunk);
}

template <int CH>
cudaError_t launch(const dim3& grid, cudaStream_t s, const void* bounds,
                   const void* nvalid, const void* offset, const void* inst,
                   int num_chunks, int num_tiles, int grid_x, int ch,
                   const void* g_color, const void* g_depth, const void* g_T,
                   const void* color, const void* depth, const void* final_T,
                   const void* n_contrib, void* out) {
  const size_t bytes = smem_bytes<CH>();
  cudaError_t e = set_smem(backward_chunk_kernel<CH>, bytes);
  if (e != cudaSuccess) return e;
  backward_chunk_kernel<CH><<<grid, kPx, bytes, s>>>(
      (const int*)bounds, (const int*)nvalid, (const int*)offset,
      (const float*)inst, num_chunks, num_tiles, grid_x, ch,
      (const float*)g_color, (const float*)g_depth, (const float*)g_T,
      (const float*)color, (const float*)depth, (const float*)final_T,
      (const int*)n_contrib, (float*)out);
  return cudaGetLastError();
}

template <int CH>
cudaError_t occupancy(int* smem, int* blocks) {
  *smem = (int)smem_bytes<CH>();
  cudaError_t e = set_smem(backward_chunk_kernel<CH>, *smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, backward_chunk_kernel<CH>, kPx, (size_t)*smem);
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
  const dim3 grid(num_tiles + kZeroBlocks);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(CH)                                                       \
  launch<CH>(grid, s, bounds, nvalid, offset, inst, num_chunks, num_tiles, \
             grid_x, ch, g_color, g_depth, g_T, color, depth, final_T,    \
             n_contrib, out)
  cudaError_t e;
  if (ch == 1)
    e = LAUNCH(1);
  else if (ch == 3)
    e = LAUNCH(3);
  else if (ch <= 8)
    e = LAUNCH(8);
  else
    e = LAUNCH(32);
#undef LAUNCH
  return (int)e;
}

// Dynamic shared memory of the instance that takes ch channels and the
// blocks of it that fit on one SM; returns a CUDA error code
extern "C" int backward_chunk_occupancy(int ch, int* smem, int* blocks) {
  if (ch < 1 || ch > 32) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (ch == 1)
    e = occupancy<1>(smem, blocks);
  else if (ch == 3)
    e = occupancy<3>(smem, blocks);
  else if (ch <= 8)
    e = occupancy<8>(smem, blocks);
  else
    e = occupancy<32>(smem, blocks);
  return (int)e;
}

extern "C" const char* backward_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
