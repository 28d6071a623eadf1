// Kernel B4: deterministic per-Gaussian sum of rank-ordered gradient rows.
//
// Replaces: gaussianeditor_tpu/ops/binning_sorted.py::_make_assembly_kernel
// (the Pallas restack of the rank-sorted gradient columns into [NB, 16,
// 128] blocks) together with the XLA reduction it feeds,
// ops/pallas_composite.py::rank_space_reduce_blocked (mean-centred
// two-level prefix sums differenced at the b_incl boundaries), and the
// rank-keyed stable sort before both. Kernel B3 writes each gradient row
// straight to its pre-sort rank, so Gaussian g's rows are the contiguous
// columns [b_incl[g] - tiles_touched[g], b_incl[g]) of rows [GF, n]; this
// kernel sums them.
//
// One thread per Gaussian (a slot of the capacity, dead ones included).
// It sums each field over its segment (cut to [0, n)) in rank order, a
// fixed order, so the result repeats bitwise; dead and culled slots
// (tiles_touched 0) get zeros. Output [C, GF] row-major. The sum is
// carried in double and rounded once: the rows of a segment cancel
// (gradients of either sign), and a float sum of a long segment lost
// 1.2e-5 of a column's RMS at full width; the adds cost nothing here.
//
// Bound: bytes. It reads each row once (4 GF bytes a rank), b_incl and
// tiles_touched once, and writes 4 GF bytes a slot. Neighbouring threads
// own neighbouring segments, so a warp's loads of one field fall on a
// few neighbouring 32-byte sectors. No prefix sums: the TPU needed them
// because it has no cheap segmented loop, and they cost precision.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) rank_segment_sum_kernel(
    const float* __restrict__ rows, const int* __restrict__ b_incl,
    const int* __restrict__ tiles_touched, int gf, long long n, int C,
    float* __restrict__ out) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= C) return;
  const long long hi = min((long long)b_incl[g], n);
  const long long lo = min((long long)b_incl[g] - tiles_touched[g], n);
  float* o = out + (size_t)g * gf;
  for (int f = 0; f < gf; ++f) {
    const float* col = rows + (size_t)f * n;
    double s = 0.0;
    for (long long r = lo; r < hi; ++r) s += (double)col[r];
    o[f] = (float)s;
  }
}

}  // namespace

extern "C" int rank_segment_sum(const void* rows, const void* b_incl,
                                const void* tiles_touched, int gf,
                                long long n, int C, void* out, void* stream) {
  if (C <= 0 || gf <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kThreads - 1) / kThreads), block(kThreads);
  rank_segment_sum_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const int*)b_incl, (const int*)tiles_touched, gf,
      n, C, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* rank_segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
