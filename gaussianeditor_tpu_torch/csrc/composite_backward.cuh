// The row math, the moment reduction and the epilogue shared by the
// compositor's backward kernels B3 (backward_tile.cu, the sorted route)
// and B6 (backward_chunk.cu, the dense route).
//
// Both run one 256-thread block per 16x16 tile, one thread per pixel,
// and walk the tile's depth-sorted rows front to back in batches of
// kRows. For row i and pixel p, gated by pos < n_contrib[p], power <= 0
// and alpha >= 1/255 (the forward's own arithmetic, so the gating agrees
// with n_contrib):
//   c_hat  = g_color . color_i + g_depth depth_i
//   prefix += alpha T c_hat                     (inclusive)
//   dpower  = amc (T c_hat - (S_total - prefix) / (1 - alpha)),
//             S_total = g_color . color + g_depth depth + g_T final_T,
//             amc = alpha if alpha_raw < 0.99 else 0 (the alpha cap
//             passes no gradient to power or opacity; color gets one)
//   w       = alpha T,  T *= 1 - alpha.
// Each thread writes D[i][p] = dpower and W[i][p] = w (zeros where the
// pair is off) to shared memory. The row's gradient is a set of sums
// over the 256 pixels, which the TPU kernel takes as matrix products of
// pixel moments (gaussianeditor_tpu/ops/pallas_composite.py:764-793).
// Here they are TF32 tensor-core products too, taken per segment of 8
// pixels (one k-step: 8 neighbours in a row of the tile):
//   M_s   = D_s [R x 8] . Q [8 x 8],  Q's columns 1, x', x'^2 (x' the
//           pixel's offset from the segment's centre, -3.5 .. 3.5) and
//           zeros: a segment's moments m0, m1, m2;
//   gfeat = W [R x 256] . Gacc [256 x NF], Gacc the pixel's g_color and
//           g_depth, padded with zero columns to a multiple of 8.
// Each row's segment moments are then expanded about the Gaussian's
// centre in float64: with X = x_i - x_s and Y = y_i - y_s the offsets of
// the centre from segment s's centre (every pixel of a segment has
// dy = Y),
//   sdx  = sum_s X m0 - m1,          sdy  = sum_s Y m0,
//   sdxx = sum_s X^2 m0 - 2 X m1 + m2, sdxy = sum_s Y (X m0 - m1),
//   sdyy = sum_s Y^2 m0,
// and the epilogue forms
//   d mean2d = -(a sdx + b sdy, c sdy + b sdx)
//   d conic  = (-sdxx / 2, -sdxy, -sdyy / 2)
//   d opacity = m0 (1 / opacity, or 0 if opacity <= 0)
//   d color, d depth = gfeat.
// Moments over the whole tile (the TPU kernel's) lose about a decimal
// digit to the expansion where a Gaussian's gradient gathers near its
// centre; over 8-pixel segments, expanded in float64, the rows keep the
// accuracy of a direct float32 sum.
//
// The products use mma.sync m16n8k8 in TF32 with the three-term split
// a = a_hi + a_lo (each rounded to TF32 as cvt.rna.tf32 rounds):
// a_lo b_hi + a_hi b_lo + a_hi b_hi,
// accumulated in float32 in that order, which keeps float32 accuracy
// (single-pass TF32 keeps about three digits). Q's entries are exact in
// TF32 (quarters below 13), so the D products take two terms. Each warp
// multiplies its own 32 pixels (four k-steps) right after writing them,
// with no block barrier in between, and keeps the results in registers;
// after one barrier the kJ threads that finish a row sum the 8 warps'
// partials in a fixed order. No atomics: the rows repeat bitwise.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace composite_backward {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;  // threads per block: one per pixel
constexpr int kWarps = kPx / 32;
// rows per batch (R), and the blocks per SM the register budget is set
// for (up to 8 channels): 16 rows at 3 or 4 blocks and 64 at 1 were
// slower on the H100 (probe_backward.py --tune, which edits these lines)
constexpr int kRows = 32;
constexpr int kMinBlocks = 2;
constexpr int kJ = kPx / kRows;     // threads that finish each row
constexpr int kLd = 36;  // row stride of a warp's D, W and Gacc slices:
                         // 32 pixels + 4, so fragment loads hit 32 banks
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
static_assert(kRows == 16 || kRows == 32 || kRows == 64,
              "kRows: 16, 32 or 64");

// feature columns of the Gacc product for CH channels (g_color, g_depth)
__host__ __device__ constexpr int feature_cols(int ch) {
  return (ch + 1 + 7) / 8 * 8;
}

// Dynamic shared memory, in floats: per warp (stride kWarpDW) D
// [kRows][kLd] then W [kRows][kLd], reused for the warp's partials once
// it has multiplied them (segment moments [4 steps x 3][kRows], gfeat
// [kRows][kSG], then finish_row's exchange); per warp Gacc^T [NF][kLd];
// then two staging buffers of `stage` floats each.
template <int NF>
struct Layout {
  // gfeat row stride: 8 modulo 32, so the 8 threads of each of a warp's
  // 4 rows read 32 banks
  static constexpr int kSG = NF + ((8 - NF) % 32 + 32) % 32;
  static constexpr int kMom = 12 * kRows;  // segment moments, row fastest
  // then finish_row's exchange: 6 doubles a thread of the warp
  static constexpr int kXch = (kMom + kRows * kSG + 1) / 2 * 2;
  static constexpr int kUsed = kXch + 12 * 32;
  static constexpr int kSlice =
      2 * kRows * kLd > kUsed ? 2 * kRows * kLd : kUsed;
  // 4 modulo 32: thread j of a row reads warp j's partials, so the 8
  // warps' slices start 4 banks apart
  static constexpr int kWarpDW = kSlice + ((4 - kSlice) % 32 + 32) % 32;
  static constexpr int kWarpG = NF * kLd;
  static constexpr int kDW = 0;
  static constexpr int kG = kDW + kWarps * kWarpDW;
  static constexpr int kStage = kG + kWarps * kWarpG;
  static_assert(kStage % 4 == 0, "staging buffers must be 16-byte aligned");
  static constexpr size_t bytes(int stage) {
    return sizeof(float) * ((size_t)kStage + 2 * (size_t)stage);
  }
};

// Host: let `kernel` take `bytes` of dynamic shared memory (above the
// default 48 KB), with the SM's carveout at its most shared memory
template <typename K>
cudaError_t set_smem(K* kernel, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- asynchronous copies ----

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one thread: copy `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory; completion is counted on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  // the buffer was last read through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// all threads: wait until `bar` completes the phase of this parity; a
// copy that never lands traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > (1ll << 36)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TF32 tensor-core products ----

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero as cvt.rna.tf32.f32 rounds, in two integer operations instead of
// a conversion
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
// c += a [16 x 8] . b [8 x 8], float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Q [k][n] for pixel k of a segment: 1, x', x'^2, then zeros
__device__ __forceinline__ float q_entry(int k, int n) {
  const float x = (float)k - 3.5f;
  return n == 0 ? 1.0f : n == 1 ? x : n == 2 ? x * x : 0.0f;
}

// this pixel's column of the warp's Gacc^T slice: g_color[c] for c < nch,
// g_depth at c = nch, zeros after
template <int CH, int NF>
__device__ __forceinline__ void store_features(float* gw, int lane,
                                               const float (&gc)[CH], float gd,
                                               int nch) {
#pragma unroll
  for (int c = 0; c < NF; ++c) {
    float v = 0.0f;
    if (c < CH && c < nch)
      v = gc[c < CH ? c : 0];
    else if (c == nch)
      v = gd;
    gw[c * kLd + lane] = v;
  }
}

// One row of the walk: row i of the staged fields f[k * ld + i] (mean2d
// x y, conic a b c, opacity, depth, color[nch]). Returns dpower and w
// (zeros when the pair is off) and carries T and the prefix.
template <int CH>
__device__ __forceinline__ void walk_row(const float* f, int ld, int i,
                                         bool live, int nch,
                                         const float (&gc)[CH], float gd,
                                         float S, float px, float py, float& T,
                                         float& prefix, float& dpower,
                                         float& w) {
  dpower = 0.0f;
  w = 0.0f;
  if (!live) return;
  // the forward's arithmetic, so that the skips agree with n_contrib
  const float dx = f[i] - px;
  const float dy = f[ld + i] - py;
  const float power =
      -0.5f * (f[2 * ld + i] * dx * dx + f[4 * ld + i] * dy * dy) -
      f[3 * ld + i] * dx * dy;
  if (power > 0.0f) return;
  const float alpha_raw = f[5 * ld + i] * expf(power);
  const float alpha = fminf(kAlphaMax, alpha_raw);
  if (alpha < kAlphaMin) return;
  const float wt = alpha * T;
  float c_hat = gd * f[6 * ld + i];
#pragma unroll
  for (int c = 0; c < CH; ++c)
    if (c < nch) c_hat += gc[c] * f[(7 + c) * ld + i];
  prefix += wt * c_hat;
  const float amc = alpha_raw < kAlphaMax ? alpha : 0.0f;
  dpower = amc * (T * c_hat - (S - prefix) / (1.0f - alpha));
  w = wt;
  T = T * (1.0f - alpha);
}

// The warp's products over its 32 pixels: reads its D and W slices
// (dw: [kRows][kLd] each) and Gacc^T slice, then overwrites dw with its
// partials: the moments of each of its 4 segments, [kk * 3 + c][row]
// (c: m0, m1, m2), and gfeat [row][kSG].
template <int NF>
__device__ __forceinline__ void warp_products(float* dw, const float* gw,
                                              int lane) {
  using L = Layout<NF>;
  constexpr int MT = kRows / 16;
  constexpr int NT = NF / 8;
  const int g = lane >> 2, q = lane & 3;
  const uint32_t bq0 = __float_as_uint(q_entry(q, g));
  const uint32_t bq1 = __float_as_uint(q_entry(q + 4, g));
  float cq[MT][4][4], cg[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) cq[m][kk][e] = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) cg[m][nt][e] = 0.0f;
    }
  const float* ww = dw + kRows * kLd;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t gh[NT][2], gl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* b = gw + (nt * 8 + g) * kLd + kk * 8 + q;
      split_tf32(b[0], gh[nt][0], gl[nt][0]);
      split_tf32(b[4], gh[nt][1], gl[nt][1]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int o = (m * 16 + g) * kLd + kk * 8 + q;
      uint32_t ah[4], al[4];
      split_tf32(dw[o], ah[0], al[0]);
      split_tf32(dw[o + 8 * kLd], ah[1], al[1]);
      split_tf32(dw[o + 4], ah[2], al[2]);
      split_tf32(dw[o + 8 * kLd + 4], ah[3], al[3]);
      mma_tf32(cq[m][kk], al, bq0, bq1);
      mma_tf32(cq[m][kk], ah, bq0, bq1);
      split_tf32(ww[o], ah[0], al[0]);
      split_tf32(ww[o + 8 * kLd], ah[1], al[1]);
      split_tf32(ww[o + 4], ah[2], al[2]);
      split_tf32(ww[o + 8 * kLd + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_tf32(cg[m][nt], al, gh[nt][0], gh[nt][1]);
        mma_tf32(cg[m][nt], ah, gl[nt][0], gl[nt][1]);
        mma_tf32(cg[m][nt], ah, gh[nt][0], gh[nt][1]);
      }
    }
  }
  __syncwarp();
  // C fragment: lane (g, q) holds rows g and g + 8, columns 2q and 2q + 1;
  // the moments are columns 0-2 (lanes q = 0 and 1)
  float* gf = dw + L::kMom;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = m * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (q == 0) {
        dw[(kk * 3 + 0) * kRows + r0] = cq[m][kk][0];
        dw[(kk * 3 + 1) * kRows + r0] = cq[m][kk][1];
        dw[(kk * 3 + 0) * kRows + r1] = cq[m][kk][2];
        dw[(kk * 3 + 1) * kRows + r1] = cq[m][kk][3];
      } else if (q == 1) {
        dw[(kk * 3 + 2) * kRows + r0] = cq[m][kk][0];
        dw[(kk * 3 + 2) * kRows + r1] = cq[m][kk][2];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * q;
      gf[r0 * L::kSG + c] = cg[m][nt][0];
      gf[r0 * L::kSG + c + 1] = cg[m][nt][1];
      gf[r1 * L::kSG + c] = cg[m][nt][2];
      gf[r1 * L::kSG + c + 1] = cg[m][nt][3];
    }
  }
}

// Row i's gradient, [7 + nch] fields, from the 8 warps' partials; called
// by every thread, thread j (0 .. kJ - 1) of row i, the row's threads in
// one warp. Thread j expands the segments of warps j, j + kJ, ... about
// the Gaussian's centre (xs, ys) in float64 into its six sums (m0, sdx,
// sdy, sdxx, sdxy, sdyy); the row's threads trade them through the free
// end of their warp's slice, and thread k < 6 adds the kJ shares in
// order and forms field k; thread j also sums gfeat columns j, j + kJ,
// ... over the warps in order. Only `live` rows are stored. (tx0, ty0)
// is the tile's pixel origin; store(k, value) writes field k.
template <int NF, typename Store>
__device__ __forceinline__ void finish_row(float* smem, int i, int j,
                                           int nch, bool live, float xs,
                                           float ys, float a, float b,
                                           float c, float op, int tx0,
                                           int ty0, Store store) {
  using L = Layout<NF>;
  double v[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const double x0 = (double)xs - (double)tx0;
  const double y0 = (double)ys - (double)ty0;
  for (int w = j; w < kWarps; w += kJ) {
    const float* mom = smem + L::kDW + w * L::kWarpDW + i;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const double m0 = mom[(kk * 3 + 0) * kRows];
      const double m1 = mom[(kk * 3 + 1) * kRows];
      const double m2 = mom[(kk * 3 + 2) * kRows];
      // the segment's centre: x (kk % 2) * 8 + 3.5, y the tile row
      const double X = x0 - ((kk & 1) * 8 + 3.5);
      const double Y = y0 - (2 * w + (kk >> 1));
      const double t = X * m0 - m1;
      v[0] += m0;
      v[1] += t;
      v[2] += Y * m0;
      v[3] += X * t - (X * m1 - m2);
      v[4] += Y * t;
      v[5] += Y * Y * m0;
    }
  }
  // [6][kJ] doubles a row, past the partials the other warps read
  const int lane = threadIdx.x & 31;
  double* xch = reinterpret_cast<double*>(
                    smem + L::kDW + (threadIdx.x >> 5) * L::kWarpDW +
                    L::kXch) +
                lane / kJ * 6 * kJ;
#pragma unroll
  for (int q = 0; q < 6; ++q) xch[q * kJ + j] = v[q];
  __syncwarp();
  if (!live) return;
  for (int k = j; k < 6; k += kJ) {
    // field k = c1 total(q1) + c2 total(q2), the same code on every lane
    int q1 = 1, q2 = 2;
    double c1 = -(double)a, c2 = -(double)b;  // k = 0: -(a sdx + b sdy)
    if (k == 1) {                             // -(c sdy + b sdx)
      q1 = 2;
      q2 = 1;
      c1 = -(double)c;
    } else if (k >= 2) {                      // -sdxx/2, -sdxy, -sdyy/2,
      q1 = q2 = k < 5 ? k + 1 : 0;            // m0 / opacity
      c1 = k == 3 ? -1.0 : k < 5 ? -0.5 : (op > 0.0f ? 1.0 / op : 0.0);
      c2 = 0.0;
    }
    double t1 = 0.0, t2 = 0.0;
    for (int t = 0; t < kJ; ++t) {
      t1 += xch[q1 * kJ + t];
      t2 += xch[q2 * kJ + t];
    }
    store(k, (float)(c1 * t1 + c2 * t2));
  }
  for (int k = j; k <= nch; k += kJ) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      s += smem[L::kDW + w * L::kWarpDW + L::kMom + i * L::kSG + k];
    store(6 + k, (float)s);
  }
}

// The per-pixel values of the walk, read once per block
template <int CH>
struct PixelState {
  float gc[CH];
  float gd, S;
  int nc;

  __device__ __forceinline__ void load(size_t o, int nch,
                                       const float* __restrict__ g_color,
                                       const float* __restrict__ g_depth,
                                       const float* __restrict__ g_T,
                                       const float* __restrict__ color,
                                       const float* __restrict__ depth,
                                       const float* __restrict__ final_T,
                                       const int* __restrict__ n_contrib) {
    S = g_T[o] * final_T[o];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      gc[c] = 0.0f;
      if (c < nch) {
        gc[c] = g_color[o * nch + c];
        S += gc[c] * color[o * nch + c];
      }
    }
    gd = g_depth[o];
    S += gd * depth[o];
    nc = n_contrib[o];
  }
};

// the tile's largest n_contrib (all threads; one barrier)
__device__ __forceinline__ int block_max_nc(int nc, int* warp_nc) {
  const int wmax = __reduce_max_sync(0xffffffffu, nc);
  if ((threadIdx.x & 31) == 0) warp_nc[threadIdx.x >> 5] = wmax;
  __syncthreads();
  int m = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = max(m, warp_nc[w]);
  return m;
}

}  // namespace composite_backward
