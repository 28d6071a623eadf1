// Kernel B4: deterministic per-Gaussian sum of rank-ordered gradient rows.
//
// Replaces: gaussianeditor_tpu/ops/binning_sorted.py::_make_assembly_kernel
// (the Pallas restack of the rank-sorted gradient columns into [NB, 16,
// 128] blocks) together with the XLA reduction it feeds,
// ops/pallas_composite.py::rank_space_reduce_blocked (mean-centred
// two-level prefix sums differenced at the b_incl boundaries), and the
// rank-keyed stable sort before both. Kernel B3 writes each gradient row
// straight to its pre-sort rank, so Gaussian g's rows are the contiguous
// ranks [b_incl[g] - tiles_touched[g], b_incl[g]); this kernel sums them.
// Output [C, GF] row-major; dead and culled slots (tiles_touched 0) get
// zeros, and ranks at or past n are dropped.
//
// Rows are field-major [GF, n], contiguous: B3's rows, or B6's gathered
// into rank order (dense_composite.rows_by_rank).
//
// Design: one block owns kSlots consecutive slots, one thread each.
// b_incl must be the inclusive cumsum of tiles_touched (both binnings
// build it so): then the block's ranks are one contiguous range, from its
// first slot's first rank to its last slot's last; segments of any other
// shape would lose ranks. The block stages that range through shared
// memory kPiece ranks and up to kFields fields at a time (neighbouring
// threads load neighbouring ranks: coalesced over [GF, n]); then each
// thread adds its own segment's part of the piece, field by field, in
// double, in rank order, from the first rank to the last, and rounds
// once, so the sums are bitwise those of one thread per slot walking its
// segment. The block's [kSlots, GF] output is assembled in shared memory
// and written as one contiguous run of 16-byte stores; slots without
// ranks get their zeros in the same run. The sum is carried in double
// because a segment's rows cancel (gradients of either sign): a float sum
// of a long segment lost 1.2e-5 of a column's RMS at full width.
//
// Bound: bytes. It reads each rank's GF floats once, b_incl and
// tiles_touched once, and writes 4 GF bytes a slot; at the main path's
// shapes three quarters of the slots are dead capacity, so the output is
// most of the bytes. No prefix sums: the TPU needed them because it has
// no cheap segmented loop, and they cost precision.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlots = 256;   // slots a block, one thread each
constexpr int kPiece = 512;   // ranks staged at a time
constexpr int kFields = 10;   // fields staged at a time (GF <= 10: one pass)
constexpr int kPer = kPiece / kSlots;

size_t smem_bytes(int gf) {
  return sizeof(float) * ((size_t)kFields * kPiece + (size_t)kSlots * gf);
}

__global__ void __launch_bounds__(kSlots) rank_segment_sum_kernel(
    const float* __restrict__ rows, const int* __restrict__ b_incl,
    const int* __restrict__ tiles_touched, int gf, long long n, int C,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                      // [kFields][kPiece]
  float* tile = smem + kFields * kPiece;    // [kSlots][gf]
  __shared__ long long range[2];

  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * kSlots;
  const int ns = min(kSlots, C - g0);
  // this slot's ranks, cut to [0, n)
  long long lo = 0, hi = 0;
  if (tid < ns) {
    const long long b = b_incl[g0 + tid];
    hi = min(b, n);
    lo = min(b - tiles_touched[g0 + tid], n);
  }
  if (tid == 0) range[0] = lo;
  if (tid == ns - 1) range[1] = hi;
  __syncthreads();
  const long long blo = range[0], bhi = range[1];

  for (int f0 = 0; f0 < gf; f0 += kFields) {
    const int nf = min(kFields, gf - f0);
    double acc[kFields];
#pragma unroll
    for (int k = 0; k < kFields; ++k) acc[k] = 0.0;
    for (long long p0 = blo; p0 < bhi; p0 += kPiece) {
      const int m = (int)min((long long)kPiece, bhi - p0);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int r = tid + j * kSlots;
        if (r < m) {
          const float* src = rows + (size_t)f0 * n + p0 + r;
#pragma unroll
          for (int k = 0; k < kFields; ++k)
            if (k < nf) stage[k * kPiece + r] = src[(size_t)k * n];
        }
      }
      __syncthreads();
      const int a = (int)(max(lo, p0) - p0);
      const int e = (int)(min(hi, p0 + m) - p0);
      for (int r = a; r < e; ++r) {
#pragma unroll
        for (int k = 0; k < kFields; ++k)
          if (k < nf) acc[k] += (double)stage[k * kPiece + r];
      }
      // the next piece overwrites the stage
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kFields; ++k)
      if (k < nf) tile[tid * gf + f0 + k] = (float)acc[k];
  }
  __syncthreads();

  // rows [g0, g0 + ns) of out: one contiguous run of ns * gf floats
  float* dst = out + (size_t)g0 * gf;
  const int total = ns * gf;
  const int nvec = ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) ? total / 4
                                                                  : 0;
  for (int i = tid; i < nvec; i += kSlots)
    reinterpret_cast<float4*>(dst)[i] =
        reinterpret_cast<const float4*>(tile)[i];
  for (int i = 4 * nvec + tid; i < total; i += kSlots) dst[i] = tile[i];
}

cudaError_t set_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(rank_segment_sum_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int rank_segment_sum(const void* rows, const void* b_incl,
                                const void* tiles_touched, int gf, long long n,
                                int C, void* out, void* stream) {
  if (C <= 0 || gf <= 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(gf);
  cudaError_t e = set_smem(bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((C + kSlots - 1) / kSlots), block(kSlots);
  rank_segment_sum_kernel<<<grid, block, bytes, (cudaStream_t)stream>>>(
      (const float*)rows, (const int*)b_incl, (const int*)tiles_touched, gf, n,
      C, (float*)out);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a launch over the rows of a ch-channel render
// (GF = 7 + ch fields) and the blocks of it that fit on one SM; returns a
// CUDA error code
extern "C" int rank_segment_sum_occupancy(int ch, int* smem, int* blocks) {
  const size_t bytes = smem_bytes(7 + ch);
  *smem = (int)bytes;
  cudaError_t e = set_smem(bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rank_segment_sum_kernel, kSlots, bytes);
}

extern "C" const char* rank_segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
