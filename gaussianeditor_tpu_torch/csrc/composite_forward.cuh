// The row records and the per-pixel walk shared by the compositor's
// forward kernels B2 (forward_tile.cu, the sorted route) and B5
// (forward_chunk.cu, the dense route).
//
// Both run one 256-thread block per 16x16 tile, one thread per pixel,
// stage a batch of up to 256 depth-sorted rows in shared memory, and walk
// it front to back with the recurrence
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy, skipped if > 0;
//   alpha = min(0.99, opacity * exp(power)), skipped if < 1/255;
//   if T (1 - alpha) < 1e-4 the pixel is done, without contributing;
//   else color += alpha T color_i, depth += alpha T depth_i,
//        T *= 1 - alpha, n_contrib = the row's position + 1,
// T multiplied row by row, as in the CUDA reference's renderCUDA. The
// kernels differ only in where a batch's rows come from and in how a
// row's position in the batch maps to n_contrib.
//
// What sets the time (measured on the H100 by probe_b2_b4.py): the issue
// rate over all evaluated (pixel, row) pairs, and the longest tiles,
// which walk up to 2.8x the mean and end last, latency-bound on one
// dependent chain a row. The walk does three things about it, none of
// which changes a result:
// - A row is staged as 16-byte records, (x, y, a, b), (c, opacity, thr,
//   depth) and its colors four to a record, so a pair reads two or three
//   128-bit broadcasts instead of ten 32-bit ones.
// - thr = logf(1 / (255 opacity)) - kMargin, computed once per row at
//   staging, is an exact pre-test: power < thr implies that the f32
//   alpha is below 1/255 (see thr_of), so such a pair is skipped without
//   its expf. Pairs within the margin take the exact test.
// - Rows are walked in groups of G: the power and pre-test of the
//   group's rows (independent of T) come first, without a branch, so
//   their latencies overlap; only the rows that pass take the serial
//   T / acc / n_contrib update, in row order.
// Each pair that is not skipped runs the arithmetic of one row at a time
// in the same order (the same expressions for power and alpha, the
// accurate expf), so color, depth, final_T and n_contrib are bitwise
// those of the one-row-at-a-time walk; keep the expressions as written,
// since the compiler's FMA contraction of them is part of the result.

#pragma once

#include <cuda_runtime.h>

namespace composite_forward {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;  // threads per block: one per pixel
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTMin = 1e-4f;
constexpr float kMargin = 1e-3f;

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
// (c, ...)
__device__ __forceinline__ float power_of(const float4& r0, const float4& r1,
                                          float px, float py) {
  const float dx = r0.x - px;
  const float dy = r0.y - py;
  return -0.5f * (r0.z * dx * dx + r1.x * dy * dy) - r0.w * dx * dy;
}

// A batch of kPx staged rows of a render of at most CH channels
template <int CH>
struct Rows {
  static constexpr int kColRecs = (CH + 3) / 4;
  float4 r0[kPx];             // (x, y, a, b)
  float4 r1[kPx];             // (c, opacity, thr, depth)
  float4 col[kColRecs][kPx];  // color[4 k .. 4 k + 3], zero past ch
};

// Stage slot p from a row whose field k (mean2d x y, conic a b c,
// opacity, depth, color[ch]) is at f[k * stride]; channels past ch are
// staged as zeros, so the walk needs no channel guard
template <int CH>
__device__ __forceinline__ void stage_row(Rows<CH>& s, int p, const float* f,
                                          long long stride, int ch) {
  const float op = f[5 * stride];
  s.r0[p] = make_float4(f[0], f[stride], f[2 * stride], f[3 * stride]);
  s.r1[p] = make_float4(f[4 * stride], op, thr_of(op), f[6 * stride]);
#pragma unroll
  for (int r = 0; r < Rows<CH>::kColRecs; ++r) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * r + k;
      v[k] = c < CH && c < ch ? f[(7 + c) * stride] : 0.0f;
    }
    s.col[r][p] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Stage slot p as a row that every pixel skips (thr = +inf); its colors
// are never read
template <int CH>
__device__ __forceinline__ void stage_dead(Rows<CH>& s, int p) {
  s.r0[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  s.r1[p] = make_float4(0.0f, 0.0f, __int_as_float(0x7f800000), 0.0f);
}

// One pixel's running state
template <int CH>
struct Pixel {
  float T = 1.0f;
  float dsum = 0.0f;
  float acc[CH] = {};
  int last = 0;
  bool done = false;

  __device__ __forceinline__ void store(size_t o, int ch, float* color,
                                        float* depth, float* final_T,
                                        int* n_contrib) const {
#pragma unroll
    for (int c = 0; c < CH; ++c)
      if (c < ch) color[o * ch + c] = acc[c];
    depth[o] = dsum;
    final_T[o] = T;
    n_contrib[o] = last;
  }
};

// Walk staged rows [0, m) for the pixel at (px, py), G rows at a time
// (rows past m up to the group's end must be staged, live or dead);
// n_contrib = nc_of(i) for the last row i that contributes. G divides
// kPx.
template <int CH, int G, class NcOf>
__device__ __forceinline__ void walk(const Rows<CH>& s, int m, float px,
                                     float py, Pixel<CH>& q, NcOf nc_of) {
  static_assert(kPx % G == 0, "a batch holds whole groups");
  for (int i = 0; i < m && !q.done; i += G) {
    float power[G];
    bool pass[G];
    bool any = false;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      power[j] = power_of(s.r0[i + j], s.r1[i + j], px, py);
      pass[j] = !(power[j] > 0.0f) && !(power[j] < s.r1[i + j].z);
      any |= pass[j];
    }
    if (!any) continue;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (!pass[j]) continue;
      const float4 r1 = s.r1[i + j];
      const float alpha = fminf(kAlphaMax, r1.y * expf(power[j]));
      if (alpha < kAlphaMin) continue;
      const float test_T = q.T * (1.0f - alpha);
      if (test_T < kTMin) {
        q.done = true;
        break;
      }
      const float w = alpha * q.T;
#pragma unroll
      for (int r = 0; r < Rows<CH>::kColRecs; ++r) {
        const float4 c4 = s.col[r][i + j];
        const float col[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * r + k < CH) q.acc[4 * r + k] += w * col[k];
      }
      q.dsum += w * r1.w;
      q.T = test_T;
      q.last = nc_of(i + j);
    }
  }
}

}  // namespace composite_forward
