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
// bounds from the chunk metadata; a tile's live chunks are contiguous,
// all full but the last, and dead chunks trail every tile), carrying the
// pixel's state in registers, and runs kernel B2's recurrence
// (composite_forward.cuh) on each chunk's live rows (lanes below
// n_valid), n_contrib being chunk offset + lane + 1. T is multiplied row
// by row, not formed as the TPU's exp(prefix sum of log1p(-alpha)), so
// the outputs equal B2's on the same rows. Outputs: color [T, 256, ch],
// depth, final_T [T, 256], n_contrib [T, 256] int32; a tile without
// chunks writes 0, 0, 1, 0.
//
// Bound: operations, as for B2: about 19 f32 operations with one exp for
// each evaluated (pixel, row) pair and 2 ch + 3 more for each
// contributing one, against 4 (7 + ch) bytes a row read once per tile.
// Design: B2's walk (16-byte row records, the exact pre-test before
// expf, rows in groups) over batches of two chunks: thread p stages lane
// p % 128 of the batch's chunk p / 128, so each field is one coalesced
// 512-byte run, and a lane past its chunk's n_valid, or a chunk past the
// tile's, is staged as a row every pixel skips, whatever the padding
// holds. Colors are staged four to a record, zero past ch, so the wide
// instances (8 and 32 channels, taking 2 and 4-8 and 9-32) update every
// channel without a guard. The block stops at the first batch at which
// every pixel is done (__syncthreads_count).

#include "composite_forward.cuh"

namespace {

using namespace composite_forward;

constexpr int kChunk = 128;  // lanes of a chunk
static_assert(kPx == 2 * kChunk, "a batch is two chunks");
// rows whose power is formed together, by instance (1 and 3 channels, 8,
// 32); measured on the H100 (probe_b2_b4.py --b5 --tune, which edits these
// lines): groups of 4 at 8 channels keep 64 registers (4 blocks a SM, where
// 8 take 80 and 3 blocks); at 32 channels groups of 4 spill and are slower
constexpr int kGroup = 8;
constexpr int kGroupMid = 4;
constexpr int kGroupWide = 8;

template <int CH>
struct GroupOf {
  static constexpr int value =
      CH <= 3 ? kGroup : (CH <= 8 ? kGroupMid : kGroupWide);
};

// CH: the channel count when it is 1 or 3, else the most channels the
// instance takes (ch <= CH at run time)
template <int CH>
__global__ void __launch_bounds__(kPx) forward_chunk_kernel(
    const int* __restrict__ bounds, const int* __restrict__ nvalid,
    const int* __restrict__ offset, const float* __restrict__ inst, int ch,
    int grid_x, float* __restrict__ out_color, float* __restrict__ out_depth,
    float* __restrict__ out_T, int* __restrict__ out_nc) {
  __shared__ Rows<CH> rows;

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = (float)((t % grid_x) * kTile + p % kTile);
  const float py = (float)((t / grid_x) * kTile + p / kTile);
  const int c0 = bounds[t];
  const int c1 = bounds[t + 1];
  const size_t chunk_floats = (size_t)(7 + ch) * kChunk;
  // live rows of chunk c: 0 past the tile's chunks
  auto live = [&](int c) { return c < c1 ? nvalid[c] : 0; };
  Pixel<CH> q;

  for (int c = c0; c < c1; c += 2) {
    // also the barrier that keeps the previous batch's rows alive until
    // every thread has read them
    if (__syncthreads_count(q.done) == kPx) break;
    const int cp = c + p / kChunk;
    const int lane = p % kChunk;
    if (lane < live(cp))
      stage_row(rows, p, inst + cp * chunk_floats + lane, kChunk, ch);
    else
      stage_dead(rows, p);
    __syncthreads();
    const int nv1 = live(c + 1);
    const int off0 = offset[c];
    const int off1 = nv1 > 0 ? offset[c + 1] : 0;
    walk<CH, GroupOf<CH>::value>(
        rows, nv1 > 0 ? kChunk + nv1 : live(c), px, py, q, [&](int i) {
          return (i < kChunk ? off0 : off1) + i % kChunk + 1;
        });
  }
  q.store((size_t)t * kPx + p, ch, out_color, out_depth, out_T, out_nc);
}

template <int CH>
cudaError_t occupancy(int* smem, int* blocks) {
  *smem = 0;  // all of its shared memory is static: sizeof(Rows<CH>)
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, forward_chunk_kernel<CH>, kPx, 0);
}

}  // namespace

extern "C" int forward_chunk(const void* bounds, const void* nvalid,
                             const void* offset, const void* inst,
                             int num_tiles, int grid_x, int ch, void* color,
                             void* depth, void* final_T, void* n_contrib,
                             void* stream) {
  if (num_tiles <= 0 || ch < 1 || ch > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(CH)                                                  \
  forward_chunk_kernel<CH><<<num_tiles, kPx, 0, s>>>(               \
      (const int*)bounds, (const int*)nvalid, (const int*)offset,   \
      (const float*)inst, ch, grid_x, (float*)color, (float*)depth, \
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

extern "C" int forward_chunk_occupancy(int ch, int* smem, int* blocks) {
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

extern "C" const char* forward_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
