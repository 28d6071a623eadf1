// The render's preprocess: one forward kernel and one backward kernel over
// the slots.
//
// Replaces: no TPU kernel. The JAX package writes this stage
// (gaussianeditor_tpu/ops/preprocess.py::preprocess) as plain jnp over [C]
// vectors, and XLA fuses it into a few passes. Eager PyTorch runs each line
// of the same code (ops/preprocess.py::preprocess_plain) as its own kernel
// over all C slots: about 420 passes forward, writing 2.2 kB a slot, and
// 675 for autograd's backward (its zero fills and the adds that sum them),
// writing 9.1 kB a slot. These two kernels read each input once and write
// each output once.
//
// preprocess_forward: one thread a slot computes what preprocess_plain
// returns but the opacity (passed through): the projection and near cull,
// the EWA splat with the frustum-clamped Jacobian, the conic, the detached
// radius, the per-axis rect (strip-local under a tile row range), the
// dead-opacity flag, tiles_touched, visibility, and the colour from SH
// degrees 0-4 (the degree a template parameter, `active_sh_degree` gating
// read on the device) unless the colour is overridden. Arithmetic is
// float32 in the plain version's order: every product, sum and quotient is
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, which
// the compiler never contracts into an FMA), the same library calls (expf,
// logf, sqrtf, rsqrtf, ceilf), constants rounded from double as PyTorch
// rounds a Python scalar, and PyTorch's NaN rules for maximum, minimum,
// clamp and nan_to_num. A PyTorch pass rounds each line once too, so the
// outputs are the plain version's on the card bit for bit.
//
// preprocess_backward: one thread a slot recomputes the forward's
// intermediates from the inputs and takes the reverse of each step in the
// order of ops/preprocess.py::preprocess_backward_plain, from d mean2d, d
// depth, d conic and d color (a null pointer is a zero gradient) to d xyz,
// d log_scales, d quats, d features_dc, d features_rest and d offset.
// autograd's rules hold: maximum and minimum split a tie in half,
// clamp_min passes the gradient at equality, and the rect, the radius and
// the dead flag carry none. A slot whose upstream gradients are all zero
// (every culled or dead one) reads no parameters and writes zeros, which
// is what the plain backward gives there: each of its terms is a product
// with one of those zeros. (Only where an intermediate overflows, a slot
// within about 1e-19 of the camera plane, does autograd's 0 * inf give
// NaN instead.) A block of such slots, as the dead capacity at the end of
// a scene is, reads no features_rest either.
//
// Layout: features_rest is [C, K-1, 3], 180 bytes a slot at degree 3; a
// warp of one-slot threads reading it 4 bytes at a time would touch 32
// lines per load. A block's slots are one contiguous range, so the block
// stages that range of rows through shared memory with 16-byte coalesced
// loads, each thread reads its own row there (a row of 45 floats is
// conflict-free), and the backward writes the rows' gradients in place
// and stores them back as one contiguous run of 16-byte stores.
//
// Bound: bytes. Forward at degree 3 with the densify offset: 245 bytes
// read and 61 written a slot; backward: 36 bytes of upstream gradients
// and 233 of parameters read, 240 of gradients written (a zero slot reads
// the 36 and writes the 240).

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kBlock = 128;   // slots a block, one thread each
constexpr int kTile = 16;     // pixels per tile side
constexpr int kCam = 37;      // world_view 16, full_proj 16, cam_pos 3, tan 2

// a Python float as PyTorch applies it to a float32 tensor
#define F(x) ((float)(x))

// core/sh.py's constants (scalars: a namespace-scope constexpr array
// cannot be read in device code)
constexpr double kC0 = 0.28209479177387814;
constexpr double kC1 = 0.4886025119029199;
constexpr double kC2_0 = 1.0925484305920792;
constexpr double kC2_1 = -1.0925484305920792;
constexpr double kC2_2 = 0.31539156525252005;
constexpr double kC2_3 = -1.0925484305920792;
constexpr double kC2_4 = 0.5462742152960396;
constexpr double kC3_0 = -0.5900435899266435;
constexpr double kC3_1 = 2.890611442640554;
constexpr double kC3_2 = -0.4570457994644658;
constexpr double kC3_3 = 0.3731763325901154;
constexpr double kC3_4 = -0.4570457994644658;
constexpr double kC3_5 = 1.445305721320277;
constexpr double kC3_6 = -0.5900435899266435;
constexpr double kC4_0 = 2.5033429417967046;
constexpr double kC4_1 = -1.7701307697799304;
constexpr double kC4_2 = 0.9461746957575601;
constexpr double kC4_3 = -0.6690465435572892;
constexpr double kC4_4 = 0.10578554691520431;
constexpr double kC4_5 = -0.6690465435572892;
constexpr double kC4_6 = 0.47308734787878004;
constexpr double kC4_7 = -1.7701307697799304;
constexpr double kC4_8 = 0.6258357354491761;

__host__ __device__ constexpr int rest_floats(int d) {
  return ((d + 1) * (d + 1) - 1) * 3;
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dv(float a, float b) {
  return __fdiv_rn(a, b);
}
// torch.maximum, torch.minimum and clamp_min: a NaN operand propagates
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a) ? a : (b != b) ? b : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a) ? a : (b != b) ? b : fminf(a, b);
}
__device__ __forceinline__ float clamp_min(float v, float m) {
  return (v != v) ? v : fmaxf(v, m);
}
// autograd's derivative of maximum(a, b) (minimum with lower_wins) in a
__device__ __forceinline__ float tie(float a, float b, bool lower_wins) {
  if (a == b) return 0.5f;
  return (lower_wins ? (a > b) : (a < b)) ? 0.f : 1.f;
}
// ops/preprocess.py::_clip_int: nan_to_num, clamp(0, hi), cast to int32
__device__ __forceinline__ int clip_int(float v, int hi) {
  if (v != v) v = 0.f;
  else if (isinf(v)) v = v > 0.f ? FLT_MAX : -FLT_MAX;
  return (int)fminf(fmaxf(v, 0.f), (float)hi);
}
__device__ __forceinline__ float ndc2pix(float v, int size) {
  return mul(sub(mul(add(v, 1.f), (float)size), 1.f), 0.5f);
}

struct Camera {
  const float* world_view;
  const float* full_proj;
  const float* cam_pos;
  const float* tan_fovx;
  const float* tan_fovy;
  int width, height;
};

// The forward's differentiable intermediates of one slot.
struct Geo {
  float hx, hy, pw, tz, tx, ty;
  float e[3], s[3];           // exp(log_scales), times scale_modifier
  float qn2, qinv, qn[4];     // |q|^2, rsqrt(max(|q|^2, 1e-24)), q * qinv
  float R[9], S[6];           // rotation; Sigma as S00 S01 S02 S11 S12 S22
  float u[2], cu[2], tc[2];   // t/tz, clamped, times tz (x, y)
  float lim[2], f[2];         // 1.3 tan_fov, focal length (x, y)
  float itz, itz2;
  float T[6];                 // rows T0, T1 of J W
  float A[3], B[3];           // T0 Sigma, T1 Sigma
  float cxx, cxy, cyy, det, dinv;
  bool det_valid;
};

__device__ __forceinline__ void load_camera(const Camera& c, float* cam) {
  const int t = threadIdx.x;
  if (t < 16) cam[t] = c.world_view[t];
  else if (t < 32) cam[t] = c.full_proj[t - 16];
  else if (t < 35) cam[t] = c.cam_pos[t - 32];
  else if (t == 35) cam[t] = *c.tan_fovx;
  else if (t == 36) cam[t] = *c.tan_fovy;
}

// ops/preprocess.py::_geometry, step for step
__device__ __forceinline__ void geometry(const float* cam, int W, int H,
                                         float smod, float x, float y,
                                         float z, const float* ls,
                                         const float* q, Geo& g) {
  const float* WV = cam;
  const float* P = cam + 16;
  g.hx = add(add(add(mul(P[0], x), mul(P[1], y)), mul(P[2], z)), P[3]);
  g.hy = add(add(add(mul(P[4], x), mul(P[5], y)), mul(P[6], z)), P[7]);
  const float hw =
      add(add(add(mul(P[12], x), mul(P[13], y)), mul(P[14], z)), P[15]);
  g.pw = dv(1.f, add(hw, F(1e-7)));
  g.tz = add(add(add(mul(WV[8], x), mul(WV[9], y)), mul(WV[10], z)), WV[11]);

#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g.e[j] = expf(ls[j]);
    g.s[j] = mul(g.e[j], smod);
  }
  g.qn2 = add(add(add(mul(q[0], q[0]), mul(q[1], q[1])), mul(q[2], q[2])),
              mul(q[3], q[3]));
  g.qinv = rsqrtf(clamp_min(g.qn2, F(1e-24)));
#pragma unroll
  for (int k = 0; k < 4; ++k) g.qn[k] = mul(q[k], g.qinv);
  const float qr = g.qn[0], qi = g.qn[1], qj = g.qn[2], qk = g.qn[3];
  float* R = g.R;
  R[0] = sub(1.f, mul(2.f, add(mul(qj, qj), mul(qk, qk))));
  R[1] = mul(2.f, sub(mul(qi, qj), mul(qr, qk)));
  R[2] = mul(2.f, add(mul(qi, qk), mul(qr, qj)));
  R[3] = mul(2.f, add(mul(qi, qj), mul(qr, qk)));
  R[4] = sub(1.f, mul(2.f, add(mul(qi, qi), mul(qk, qk))));
  R[5] = mul(2.f, sub(mul(qj, qk), mul(qr, qi)));
  R[6] = mul(2.f, sub(mul(qi, qk), mul(qr, qj)));
  R[7] = mul(2.f, add(mul(qj, qk), mul(qr, qi)));
  R[8] = sub(1.f, mul(2.f, add(mul(qi, qi), mul(qj, qj))));
  float L[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) L[3 * i + j] = mul(R[3 * i + j], g.s[j]);
  auto dot3 = [](const float* a, const float* b) {
    return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
  };
  g.S[0] = dot3(L, L);
  g.S[1] = dot3(L, L + 3);
  g.S[2] = dot3(L, L + 6);
  g.S[3] = dot3(L + 3, L + 3);
  g.S[4] = dot3(L + 3, L + 6);
  g.S[5] = dot3(L + 6, L + 6);

  g.tx = add(add(add(mul(WV[0], x), mul(WV[1], y)), mul(WV[2], z)), WV[3]);
  g.ty = add(add(add(mul(WV[4], x), mul(WV[5], y)), mul(WV[6], z)), WV[7]);
  const float t[2] = {g.tx, g.ty};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float tanfov = cam[35 + a];
    g.lim[a] = mul(F(1.3), tanfov);
    // focal = size / (2 tan): PyTorch's reciprocal, then times the size
    g.f[a] = mul(dv(1.f, mul(2.f, tanfov)), (float)(a == 0 ? W : H));
    g.u[a] = dv(t[a], g.tz);
    g.cu[a] = tmin(tmax(g.u[a], -g.lim[a]), g.lim[a]);
    g.tc[a] = mul(g.cu[a], g.tz);
  }
  g.itz = dv(1.f, g.tz);
  g.itz2 = mul(g.itz, g.itz);
  const float J00 = mul(g.f[0], g.itz);
  const float J02 = mul(mul(-g.f[0], g.tc[0]), g.itz2);
  const float J11 = mul(g.f[1], g.itz);
  const float J12 = mul(mul(-g.f[1], g.tc[1]), g.itz2);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g.T[j] = add(mul(J00, WV[j]), mul(J02, WV[8 + j]));
    g.T[3 + j] = add(mul(J11, WV[4 + j]), mul(J12, WV[8 + j]));
  }
  const float* S = g.S;
  const float Sm[9] = {S[0], S[1], S[2], S[1], S[3], S[4], S[2], S[4], S[5]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.A[k] = add(add(mul(g.T[0], Sm[k]), mul(g.T[1], Sm[3 + k])),
                 mul(g.T[2], Sm[6 + k]));
    g.B[k] = add(add(mul(g.T[3], Sm[k]), mul(g.T[4], Sm[3 + k])),
                 mul(g.T[5], Sm[6 + k]));
  }
  g.cxx = add(dot3(g.A, g.T), F(0.3));
  g.cxy = dot3(g.A, g.T + 3);
  g.cyy = add(dot3(g.B, g.T + 3), F(0.3));
  g.det = sub(mul(g.cxx, g.cyy), mul(g.cxy, g.cxy));
  g.det_valid = g.det != 0.f;
  g.dinv = dv(1.f, g.det_valid ? g.det : 1.f);
}

// ops/preprocess.py::_sh_bases: b[k] for k = 1 .. (D+1)^2 - 1
template <int D>
__device__ __forceinline__ void sh_bases(float x, float y, float z,
                                         float* b) {
  if constexpr (D >= 1) {
    b[1] = mul(F(-kC1), y);
    b[2] = mul(F(kC1), z);
    b[3] = mul(F(-kC1), x);
  }
  if constexpr (D >= 2) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    b[4] = mul(F(kC2_0), xy);
    b[5] = mul(F(kC2_1), yz);
    b[6] = mul(F(kC2_2), sub(sub(mul(2.f, zz), xx), yy));
    b[7] = mul(F(kC2_3), xz);
    b[8] = mul(F(kC2_4), sub(xx, yy));
    if constexpr (D >= 3) {
      b[9] = mul(mul(F(kC3_0), y), sub(mul(3.f, xx), yy));
      b[10] = mul(mul(F(kC3_1), xy), z);
      b[11] = mul(mul(F(kC3_2), y), sub(sub(mul(4.f, zz), xx), yy));
      b[12] = mul(mul(F(kC3_3), z),
                  sub(sub(mul(2.f, zz), mul(3.f, xx)), mul(3.f, yy)));
      b[13] = mul(mul(F(kC3_4), x), sub(sub(mul(4.f, zz), xx), yy));
      b[14] = mul(mul(F(kC3_5), z), sub(xx, yy));
      b[15] = mul(mul(F(kC3_6), x), sub(xx, mul(3.f, yy)));
    }
    if constexpr (D >= 4) {
      b[16] = mul(mul(F(kC4_0), xy), sub(xx, yy));
      b[17] = mul(mul(F(kC4_1), yz), sub(mul(3.f, xx), yy));
      b[18] = mul(mul(F(kC4_2), xy), sub(mul(7.f, zz), 1.f));
      b[19] = mul(mul(F(kC4_3), yz), sub(mul(7.f, zz), 3.f));
      b[20] = mul(F(kC4_4), add(mul(zz, sub(mul(35.f, zz), 30.f)), 3.f));
      b[21] = mul(mul(F(kC4_5), xz), sub(mul(7.f, zz), 3.f));
      b[22] = mul(mul(F(kC4_6), sub(xx, yy)), sub(mul(7.f, zz), 1.f));
      b[23] = mul(mul(F(kC4_7), xz), sub(xx, mul(3.f, yy)));
      b[24] = mul(F(kC4_8), sub(mul(xx, sub(xx, mul(3.f, yy))),
                                mul(yy, sub(mul(3.f, xx), yy))));
    }
  }
}

// ops/preprocess.py::_sh_bases_backward
template <int D>
__device__ __forceinline__ void sh_bases_backward(float x, float y, float z,
                                                  const float* g, float* gd) {
  float gx = 0.f, gy = 0.f, gz = 0.f;
  if constexpr (D >= 1) {
    gy -= (float)kC1 * g[1];
    gz += (float)kC1 * g[2];
    gx -= (float)kC1 * g[3];
  }
  if constexpr (D >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    float gxx = 0.f, gyy = 0.f, gzz = 0.f;
    float gxy = (float)kC2_0 * g[4];
    float gyz = (float)kC2_1 * g[5];
    gzz += 2.f * (float)kC2_2 * g[6];
    gxx -= (float)kC2_2 * g[6];
    gyy -= (float)kC2_2 * g[6];
    float gxz = (float)kC2_3 * g[7];
    gxx += (float)kC2_4 * g[8];
    gyy -= (float)kC2_4 * g[8];
    if constexpr (D >= 3) {
      float u = (float)kC3_0 * g[9];
      gy += u * (3.f * xx - yy);
      gxx += 3.f * y * u;
      gyy -= y * u;
      u = (float)kC3_1 * g[10];
      gxy += z * u;
      gz += xy * u;
      u = (float)kC3_2 * g[11];
      gy += u * (4.f * zz - xx - yy);
      gzz += 4.f * y * u;
      gxx -= y * u;
      gyy -= y * u;
      u = (float)kC3_3 * g[12];
      gz += u * (2.f * zz - 3.f * xx - 3.f * yy);
      gzz += 2.f * z * u;
      gxx -= 3.f * z * u;
      gyy -= 3.f * z * u;
      u = (float)kC3_4 * g[13];
      gx += u * (4.f * zz - xx - yy);
      gzz += 4.f * x * u;
      gxx -= x * u;
      gyy -= x * u;
      u = (float)kC3_5 * g[14];
      gz += u * (xx - yy);
      gxx += z * u;
      gyy -= z * u;
      u = (float)kC3_6 * g[15];
      gx += u * (xx - 3.f * yy);
      gxx += x * u;
      gyy -= 3.f * x * u;
    }
    if constexpr (D >= 4) {
      float u = (float)kC4_0 * g[16];
      gxy += u * (xx - yy);
      gxx += xy * u;
      gyy -= xy * u;
      u = (float)kC4_1 * g[17];
      gyz += u * (3.f * xx - yy);
      gxx += 3.f * yz * u;
      gyy -= yz * u;
      u = (float)kC4_2 * g[18];
      gxy += u * (7.f * zz - 1.f);
      gzz += 7.f * xy * u;
      u = (float)kC4_3 * g[19];
      gyz += u * (7.f * zz - 3.f);
      gzz += 7.f * yz * u;
      u = (float)kC4_4 * g[20];
      gzz += u * (70.f * zz - 30.f);
      u = (float)kC4_5 * g[21];
      gxz += u * (7.f * zz - 3.f);
      gzz += 7.f * xz * u;
      u = (float)kC4_6 * g[22];
      gxx += u * (7.f * zz - 1.f);
      gyy -= u * (7.f * zz - 1.f);
      gzz += 7.f * (xx - yy) * u;
      u = (float)kC4_7 * g[23];
      gxz += u * (xx - 3.f * yy);
      gxx += xz * u;
      gyy -= 3.f * xz * u;
      u = (float)kC4_8 * g[24];
      gxx += u * (2.f * xx - 6.f * yy);
      gyy += u * (2.f * yy - 6.f * xx);
    }
    gx += 2.f * x * gxx + y * gxy + z * gxz;
    gy += 2.f * y * gyy + x * gxy + z * gyz;
    gz += 2.f * z * gzz + y * gyz + x * gxz;
  }
  gd[0] = gx;
  gd[1] = gy;
  gd[2] = gz;
}

// Rows [g0, g0 + ns) of a [C, N] float array: one contiguous run, copied
// with 16-byte accesses where the run is 16-byte aligned (the shared
// buffer always is).
template <int N>
__device__ __forceinline__ void rows_in(float* dst, const float* base,
                                        int g0, int ns) {
  const float* src = base + (size_t)g0 * N;
  const int total = ns * N;
  const int nvec =
      ((reinterpret_cast<uintptr_t>(src) & 15) == 0) ? total / 4 : 0;
  for (int i = threadIdx.x; i < nvec; i += kBlock)
    reinterpret_cast<float4*>(dst)[i] =
        __ldg(reinterpret_cast<const float4*>(src) + i);
  for (int i = 4 * nvec + threadIdx.x; i < total; i += kBlock)
    dst[i] = __ldg(src + i);
}

template <int N>
__device__ __forceinline__ void rows_out(float* base, const float* src,
                                         int g0, int ns) {
  float* dst = base + (size_t)g0 * N;
  const int total = ns * N;
  const int nvec =
      ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) ? total / 4 : 0;
  for (int i = threadIdx.x; i < nvec; i += kBlock)
    reinterpret_cast<float4*>(dst)[i] =
        reinterpret_cast<const float4*>(src)[i];
  for (int i = 4 * nvec + threadIdx.x; i < total; i += kBlock)
    dst[i] = src[i];
}

struct FwdArgs {
  const float* xyz;
  const float* log_scales;
  const float* quats;
  const float* opacity;
  const bool* alive;          // null: every slot alive
  const float* offset;        // null: no densify probe
  const float* dc;            // null: colour overridden
  const float* rest;
  const int* active_ptr;      // null: the degree is `active`
  int active;
  Camera cam;
  float smod;
  int ty0, ty1;               // ty0 < 0: the whole image
  int C;
  float* mean2d;
  float* depth;
  float* conic;
  float* color;
  int* radius;
  bool* visible;
  int* rect_min;
  int* rect_max;
  int* tiles;
};

template <int D, bool kColor>
__global__ void __launch_bounds__(kBlock) preprocess_fwd_kernel(
    const FwdArgs a) {
  constexpr int NR = rest_floats(D);
  constexpr bool kStage = kColor && NR > 0;
  __shared__ float cam[kCam];
  __shared__ __align__(16) float stage[kStage ? kBlock * NR : 4];
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * kBlock;
  const int ns = min(kBlock, a.C - g0);
  load_camera(a.cam, cam);
  if constexpr (kStage) rows_in<NR>(stage, a.rest, g0, ns);
  __syncthreads();
  if (tid >= ns) return;
  const int g = g0 + tid;
  const int W = a.cam.width, H = a.cam.height;

  const float x = a.xyz[3 * g], y = a.xyz[3 * g + 1], z = a.xyz[3 * g + 2];
  const float ls[3] = {a.log_scales[3 * g], a.log_scales[3 * g + 1],
                       a.log_scales[3 * g + 2]};
  const float q[4] = {a.quats[4 * g], a.quats[4 * g + 1], a.quats[4 * g + 2],
                      a.quats[4 * g + 3]};
  Geo v;
  geometry(cam, W, H, a.smod, x, y, z, ls, q, v);

  float ndcx = mul(v.hx, v.pw), ndcy = mul(v.hy, v.pw);
  if (a.offset != nullptr) {
    ndcx = add(ndcx, a.offset[2 * g]);
    ndcy = add(ndcy, a.offset[2 * g + 1]);
  }
  const float mx = ndc2pix(ndcx, W), my = ndc2pix(ndcy, H);
  reinterpret_cast<float2*>(a.mean2d)[g] = make_float2(mx, my);
  a.depth[g] = v.tz;
  a.conic[3 * g] = mul(v.cyy, v.dinv);
  a.conic[3 * g + 1] = mul(-v.cxy, v.dinv);
  a.conic[3 * g + 2] = mul(v.cxx, v.dinv);

  // radius, rect and dead flag (no gradient)
  const float mid = mul(0.5f, add(v.cxx, v.cyy));
  const float disc = sqrtf(clamp_min(sub(mul(mid, mid), v.det), F(0.1)));
  const float lambda1 = add(mid, disc);
  const float radius_f = ceilf(mul(3.f, sqrtf(tmax(lambda1, sub(mid, disc)))));
  const float ln_op = logf(mul(256.f, clamp_min(a.opacity[g], F(1e-12))));
  const float two_ln = mul(2.f, clamp_min(ln_op, 0.f));
  const float rx_f = tmin(radius_f, ceilf(sqrtf(mul(two_ln, v.cxx))));
  const float ry_f = tmin(radius_f, ceilf(sqrtf(mul(two_ln, v.cyy))));
  const bool dead_op = ln_op <= 0.f;
  const int grid_x = (W + kTile - 1) / kTile;
  const int grid_y = (H + kTile - 1) / kTile;
  const float tile = (float)kTile;
  const int rminx = clip_int(dv(sub(mx, rx_f), tile), grid_x);
  int rminy = clip_int(dv(sub(my, ry_f), tile), grid_y);
  const int rmaxx =
      clip_int(tmin(dv(sub(add(add(mx, radius_f), tile), 1.f), tile),
                    dv(add(add(mx, rx_f), tile), tile)),
               grid_x);
  int rmaxy = clip_int(tmin(dv(sub(add(add(my, radius_f), tile), 1.f), tile),
                            dv(add(add(my, ry_f), tile), tile)),
                       grid_y);
  if (a.ty0 >= 0) {
    rminy = min(max(rminy, a.ty0), a.ty1) - a.ty0;
    rmaxy = min(max(rmaxy, a.ty0), a.ty1) - a.ty0;
  }
  const int tiles = dead_op ? 0 : (rmaxx - rminx) * (rmaxy - rminy);
  const bool visible = v.tz > F(0.2) && v.det_valid && tiles > 0 &&
                       (a.alive == nullptr || a.alive[g]);
  a.visible[g] = visible;
  a.tiles[g] = visible ? tiles : 0;
  a.radius[g] = clip_int(visible ? radius_f : 0.f, 1 << 30);
  reinterpret_cast<int2*>(a.rect_min)[g] = make_int2(rminx, rminy);
  reinterpret_cast<int2*>(a.rect_max)[g] = make_int2(rmaxx, rmaxy);

  if constexpr (kColor) {
    float dx = sub(x, cam[32]), dy = sub(y, cam[33]), dz = sub(z, cam[34]);
    const float dn = rsqrtf(
        clamp_min(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz)), F(1e-24)));
    dx = mul(dx, dn);
    dy = mul(dy, dn);
    dz = mul(dz, dn);
    float b[(D + 1) * (D + 1)];
    sh_bases<D>(dx, dy, dz, b);
    const int active = a.active_ptr != nullptr ? *a.active_ptr : a.active;
    const float* row = stage + tid * NR;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float res = mul(F(kC0), a.dc[3 * g + c]);
#pragma unroll
      for (int deg = 1; deg <= D; ++deg) {
        const int lo = deg * deg, hi = (deg + 1) * (deg + 1);
        float band = mul(b[lo], row[3 * (lo - 1) + c]);
#pragma unroll
        for (int k = lo + 1; k < hi; ++k)
          band = add(band, mul(b[k], row[3 * (k - 1) + c]));
        res = add(res, active >= deg ? band : 0.f);
      }
      a.color[3 * g + c] = tmax(add(res, 0.5f), 0.f);
    }
  }
}

struct BwdArgs {
  const float* xyz;
  const float* log_scales;
  const float* quats;
  const float* dc;            // null: colour overridden
  const float* rest;
  const int* active_ptr;
  int active;
  Camera cam;
  float smod;
  int C;
  const float* g_mean2d;      // each null: a zero gradient; slot g's
  const float* g_depth;       // entries start at g times the row stride
  const float* g_conic;       // (the compositor's backward hands over
  const float* g_color;       // column slices of one [C, 7 + ch] array)
  int s_mean2d, s_depth, s_conic, s_color;
  float* d_xyz;
  float* d_ls;
  float* d_q;
  float* d_dc;
  float* d_rest;
  float* d_off;               // null: no densify probe
};

template <int D, bool kColor>
__global__ void __launch_bounds__(kBlock) preprocess_bwd_kernel(
    const BwdArgs a) {
  constexpr int NR = rest_floats(D);
  constexpr int NB = (D + 1) * (D + 1);
  constexpr bool kStage = kColor && NR > 0;
  __shared__ float cam[kCam];
  // the block's features_rest rows in, their gradients out, in place
  __shared__ __align__(16) float stage[kStage ? kBlock * NR : 4];
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * kBlock;
  const int ns = min(kBlock, a.C - g0);
  load_camera(a.cam, cam);
  const int g = g0 + tid;
  float gm[2] = {0.f, 0.f}, gdep = 0.f, gcon[3] = {0.f, 0.f, 0.f};
  float gcol[3] = {0.f, 0.f, 0.f};
  if (tid < ns) {
    const size_t i = g;
    if (a.g_mean2d != nullptr) {
      gm[0] = a.g_mean2d[i * a.s_mean2d];
      gm[1] = a.g_mean2d[i * a.s_mean2d + 1];
    }
    if (a.g_depth != nullptr) gdep = a.g_depth[i * a.s_depth];
    if (a.g_conic != nullptr)
      for (int k = 0; k < 3; ++k) gcon[k] = a.g_conic[i * a.s_conic + k];
    if (kColor && a.g_color != nullptr)
      for (int c = 0; c < 3; ++c) gcol[c] = a.g_color[i * a.s_color + c];
  }
  const bool any = gm[0] != 0.f || gm[1] != 0.f || gdep != 0.f ||
                   gcon[0] != 0.f || gcon[1] != 0.f || gcon[2] != 0.f ||
                   gcol[0] != 0.f || gcol[1] != 0.f || gcol[2] != 0.f;
  // a block of zero slots (dead capacity) reads no features_rest
  const bool block_any = __syncthreads_or(any);
  if constexpr (kStage)
    if (block_any) rows_in<NR>(stage, a.rest, g0, ns);
  __syncthreads();

  if (tid < ns) {
    const int W = a.cam.width, H = a.cam.height;
    float* row = stage + tid * NR;
    float d_xyz[3] = {0.f, 0.f, 0.f}, d_ls[3] = {0.f, 0.f, 0.f};
    float d_q[4] = {0.f, 0.f, 0.f, 0.f}, d_dc[3] = {0.f, 0.f, 0.f};
    float g_ndc[2] = {0.f, 0.f};
    if (!any) {
      if constexpr (kStage)
        for (int i = 0; i < NR; ++i) row[i] = 0.f;
    } else {
      const float x = a.xyz[3 * g], y = a.xyz[3 * g + 1],
                  z = a.xyz[3 * g + 2];
      const float ls[3] = {a.log_scales[3 * g], a.log_scales[3 * g + 1],
                           a.log_scales[3 * g + 2]};
      const float q[4] = {a.quats[4 * g], a.quats[4 * g + 1],
                          a.quats[4 * g + 2], a.quats[4 * g + 3]};
      Geo v;
      geometry(cam, W, H, a.smod, x, y, z, ls, q, v);
      const float* WV = cam;
      const float* P = cam + 16;

      // conic = (c_yy, -c_xy, c_xx) / det
      const float dinv = v.dinv;
      float g_cyy = gcon[0] * dinv;
      float g_cxy = -(gcon[1] * dinv);
      float g_cxx = gcon[2] * dinv;
      const float g_dinv = gcon[0] * v.cyy - gcon[1] * v.cxy + gcon[2] * v.cxx;
      const float g_det = v.det_valid ? -g_dinv * dinv * dinv : 0.f;
      g_cxx += g_det * v.cyy;
      g_cyy += g_det * v.cxx;
      g_cxy -= 2.f * g_det * v.cxy;

      // cov2d = (T0 S T0^T + 0.3, T0 S T1^T, T1 S T1^T + 0.3)
      const float* T0 = v.T;
      const float* T1 = v.T + 3;
      const float* S = v.S;
      const float Sm[9] = {S[0], S[1], S[2], S[1], S[3], S[4],
                           S[2], S[4], S[5]};
      float gA[3], gB[3], gT0[3], gT1[3], G[9];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        gA[k] = g_cxx * T0[k] + g_cxy * T1[k];
        gB[k] = g_cyy * T1[k];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        gT0[j] = g_cxx * v.A[j] + gA[0] * Sm[3 * j] + gA[1] * Sm[3 * j + 1] +
                 gA[2] * Sm[3 * j + 2];
        gT1[j] = g_cxy * v.A[j] + g_cyy * v.B[j] + gB[0] * Sm[3 * j] +
                 gB[1] * Sm[3 * j + 1] + gB[2] * Sm[3 * j + 2];
#pragma unroll
        for (int k = 0; k < 3; ++k) G[3 * j + k] = gA[k] * T0[j] + gB[k] * T1[j];
      }
      const float gS00 = G[0], gS11 = G[4], gS22 = G[8];
      const float gS01 = G[1] + G[3], gS02 = G[2] + G[6], gS12 = G[5] + G[7];

      // S = L L^T, L = R diag(s)
      const float* R = v.R;
      float L[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) L[3 * i + j] = R[3 * i + j] * v.s[j];
      float gR[9], g_s[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float gL0 = 2.f * gS00 * L[j] + gS01 * L[3 + j] + gS02 * L[6 + j];
        const float gL1 = gS01 * L[j] + 2.f * gS11 * L[3 + j] + gS12 * L[6 + j];
        const float gL2 = gS02 * L[j] + gS12 * L[3 + j] + 2.f * gS22 * L[6 + j];
        gR[j] = gL0 * v.s[j];
        gR[3 + j] = gL1 * v.s[j];
        gR[6 + j] = gL2 * v.s[j];
        g_s[j] = gL0 * R[j] + gL1 * R[3 + j] + gL2 * R[6 + j];
        d_ls[j] = g_s[j] * a.smod * v.e[j];
      }

      // R of the normalised quaternion (r, i, j, k)
      const float qr = v.qn[0], qi = v.qn[1], qj = v.qn[2], qk = v.qn[3];
      float gqn[4];
      gqn[0] = 2.f * (-qk * gR[1] + qj * gR[2] + qk * gR[3] - qi * gR[5] -
                      qj * gR[6] + qi * gR[7]);
      gqn[1] = 2.f * (qj * gR[1] + qk * gR[2] + qj * gR[3] - qr * gR[5] +
                      qk * gR[6] + qr * gR[7]) -
               4.f * qi * (gR[4] + gR[8]);
      gqn[2] = 2.f * (qi * gR[1] + qr * gR[2] + qi * gR[3] + qk * gR[5] -
                      qr * gR[6] + qk * gR[7]) -
               4.f * qj * (gR[0] + gR[8]);
      gqn[3] = 2.f * (-qr * gR[1] + qi * gR[2] + qr * gR[3] + qj * gR[5] +
                      qi * gR[6] + qj * gR[7]) -
               4.f * qk * (gR[0] + gR[4]);
      // qn = q * rsqrt(max(|q|^2, 1e-24))
      const float g_qinv =
          gqn[0] * q[0] + gqn[1] * q[1] + gqn[2] * q[2] + gqn[3] * q[3];
      const float g_qn2 = v.qn2 >= F(1e-24)
                              ? g_qinv * (-0.5f * v.qinv * v.qinv * v.qinv)
                              : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) d_q[k] = gqn[k] * v.qinv + 2.f * q[k] * g_qn2;

      // T0 = J00 WV0 + J02 WV2, T1 = J11 WV1 + J12 WV2
      const float gJ00 = gT0[0] * WV[0] + gT0[1] * WV[1] + gT0[2] * WV[2];
      const float gJ02 = gT0[0] * WV[8] + gT0[1] * WV[9] + gT0[2] * WV[10];
      const float gJ11 = gT1[0] * WV[4] + gT1[1] * WV[5] + gT1[2] * WV[6];
      const float gJ12 = gT1[0] * WV[8] + gT1[1] * WV[9] + gT1[2] * WV[10];
      const float fx = v.f[0], fy = v.f[1];
      float g_itz = gJ00 * fx + gJ11 * fy;
      const float g_itz2 = gJ02 * (-fx * v.tc[0]) + gJ12 * (-fy * v.tc[1]);
      const float g_tc[2] = {gJ02 * v.itz2 * -fx, gJ12 * v.itz2 * -fy};
      g_itz += 2.f * v.itz * g_itz2;
      float g_tz = gdep - g_itz * v.itz * v.itz;
      // tc = min(max(t / tz, -lim), lim) * tz
      float g_t[2];
      const float t[2] = {v.tx, v.ty};
#pragma unroll
      for (int ax = 0; ax < 2; ++ax) {
        g_tz += g_tc[ax] * v.cu[ax];
        const float m = tmax(v.u[ax], -v.lim[ax]);
        const float g_u = g_tc[ax] * v.tz * tie(v.u[ax], -v.lim[ax], false) *
                          tie(m, v.lim[ax], true);
        g_t[ax] = g_u / v.tz;
        g_tz -= g_u * t[ax] / (v.tz * v.tz);
      }

      // mean2d = ndc2pix(h / w + offset)
      g_ndc[0] = gm[0] * 0.5f * (float)W;
      g_ndc[1] = gm[1] * 0.5f * (float)H;
      const float g_hx = g_ndc[0] * v.pw, g_hy = g_ndc[1] * v.pw;
      const float g_pw = g_ndc[0] * v.hx + g_ndc[1] * v.hy;
      const float g_hw = -g_pw * v.pw * v.pw;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        d_xyz[i] = P[i] * g_hx + P[4 + i] * g_hy + P[12 + i] * g_hw +
                   WV[i] * g_t[0] + WV[4 + i] * g_t[1] + WV[8 + i] * g_tz;

      if constexpr (kColor) {
        // color = max(SH(dir) + 0.5, 0), dir = d * rsqrt(max(|d|^2, 1e-24))
        const float d[3] = {sub(x, cam[32]), sub(y, cam[33]), sub(z, cam[34])};
        const float n2 =
            add(add(mul(d[0], d[0]), mul(d[1], d[1])), mul(d[2], d[2]));
        const float dn = rsqrtf(clamp_min(n2, F(1e-24)));
        const float dir[3] = {mul(d[0], dn), mul(d[1], dn), mul(d[2], dn)};
        float b[NB], g_b[NB];
        sh_bases<D>(dir[0], dir[1], dir[2], b);
        const int active = a.active_ptr != nullptr ? *a.active_ptr : a.active;
        float g_res[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float res = mul(F(kC0), a.dc[3 * g + c]);
#pragma unroll
          for (int deg = 1; deg <= D; ++deg) {
            const int lo = deg * deg, hi = (deg + 1) * (deg + 1);
            float band = mul(b[lo], row[3 * (lo - 1) + c]);
#pragma unroll
            for (int k = lo + 1; k < hi; ++k)
              band = add(band, mul(b[k], row[3 * (k - 1) + c]));
            res = add(res, active >= deg ? band : 0.f);
          }
          g_res[c] = gcol[c] * tie(add(res, 0.5f), 0.f, false);
          d_dc[c] = (float)kC0 * g_res[c];
        }
#pragma unroll
        for (int deg = 1; deg <= D; ++deg) {
          const bool on = active >= deg;
#pragma unroll
          for (int k = deg * deg; k < (deg + 1) * (deg + 1); ++k) {
            float acc = 0.f;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float gband = on ? g_res[c] : 0.f;
              float* cell = row + 3 * (k - 1) + c;
              acc += gband * *cell;
              *cell = gband * b[k];
            }
            g_b[k] = acc;
          }
        }
        float gdir[3];
        sh_bases_backward<D>(dir[0], dir[1], dir[2], g_b, gdir);
        const float g_dn = gdir[0] * d[0] + gdir[1] * d[1] + gdir[2] * d[2];
        const float g_n2 =
            n2 >= F(1e-24) ? g_dn * (-0.5f * dn * dn * dn) : 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          d_xyz[i] += gdir[i] * dn + 2.f * d[i] * g_n2;
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a.d_xyz[3 * g + i] = d_xyz[i];
      a.d_ls[3 * g + i] = d_ls[i];
    }
    reinterpret_cast<float4*>(a.d_q)[g] =
        make_float4(d_q[0], d_q[1], d_q[2], d_q[3]);
    if constexpr (kColor)
      for (int c = 0; c < 3; ++c) a.d_dc[3 * g + c] = d_dc[c];
    if (a.d_off != nullptr)
      reinterpret_cast<float2*>(a.d_off)[g] = make_float2(g_ndc[0], g_ndc[1]);
  }
  if constexpr (kStage) {
    __syncthreads();
    rows_out<NR>(a.d_rest, stage, g0, ns);
  }
}

// the instance of `Launch` for SH degree `d` (0-4) and colour mode `color`
template <template <int, bool> class Launch, typename Args>
cudaError_t dispatch(int d, bool color, const Args& a, cudaStream_t s) {
  if (!color) return Launch<0, false>::run(a, s);
  switch (d) {
    case 0: return Launch<0, true>::run(a, s);
    case 1: return Launch<1, true>::run(a, s);
    case 2: return Launch<2, true>::run(a, s);
    case 3: return Launch<3, true>::run(a, s);
    case 4: return Launch<4, true>::run(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int D, bool kColor>
struct Fwd {
  static cudaError_t run(const FwdArgs& a, cudaStream_t s) {
    preprocess_fwd_kernel<D, kColor>
        <<<(a.C + kBlock - 1) / kBlock, kBlock, 0, s>>>(a);
    return cudaGetLastError();
  }
};

template <int D, bool kColor>
struct Bwd {
  static cudaError_t run(const BwdArgs& a, cudaStream_t s) {
    preprocess_bwd_kernel<D, kColor>
        <<<(a.C + kBlock - 1) / kBlock, kBlock, 0, s>>>(a);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int preprocess_forward(
    const void* xyz, const void* log_scales, const void* quats,
    const void* opacity, const void* alive, const void* offset, const void* dc,
    const void* rest, const void* active_ptr, int active,
    const void* world_view, const void* full_proj, const void* cam_pos,
    const void* tan_fovx, const void* tan_fovy, int width, int height,
    float scale_modifier, int ty0, int ty1, int C, int sh_degree,
    void* mean2d, void* depth, void* conic, void* color, void* radius,
    void* visible, void* rect_min, void* rect_max, void* tiles,
    void* stream) {
  if (C <= 0) return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.xyz = (const float*)xyz;
  a.log_scales = (const float*)log_scales;
  a.quats = (const float*)quats;
  a.opacity = (const float*)opacity;
  a.alive = (const bool*)alive;
  a.offset = (const float*)offset;
  a.dc = (const float*)dc;
  a.rest = (const float*)rest;
  a.active_ptr = (const int*)active_ptr;
  a.active = active;
  a.cam = Camera{(const float*)world_view, (const float*)full_proj,
                 (const float*)cam_pos,    (const float*)tan_fovx,
                 (const float*)tan_fovy,   width, height};
  a.smod = scale_modifier;
  a.ty0 = ty0;
  a.ty1 = ty1;
  a.C = C;
  a.mean2d = (float*)mean2d;
  a.depth = (float*)depth;
  a.conic = (float*)conic;
  a.color = (float*)color;
  a.radius = (int*)radius;
  a.visible = (bool*)visible;
  a.rect_min = (int*)rect_min;
  a.rect_max = (int*)rect_max;
  a.tiles = (int*)tiles;
  return (int)dispatch<Fwd>(sh_degree, dc != nullptr, a,
                            (cudaStream_t)stream);
}

extern "C" int preprocess_backward(
    const void* xyz, const void* log_scales, const void* quats, const void* dc,
    const void* rest, const void* active_ptr, int active,
    const void* world_view, const void* full_proj, const void* cam_pos,
    const void* tan_fovx, const void* tan_fovy, int width, int height,
    float scale_modifier, int C, int sh_degree, const void* g_mean2d,
    const void* g_depth, const void* g_conic, const void* g_color,
    int s_mean2d, int s_depth, int s_conic, int s_color, void* d_xyz,
    void* d_ls, void* d_q, void* d_dc, void* d_rest, void* d_off,
    void* stream) {
  if (C <= 0) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.xyz = (const float*)xyz;
  a.log_scales = (const float*)log_scales;
  a.quats = (const float*)quats;
  a.dc = (const float*)dc;
  a.rest = (const float*)rest;
  a.active_ptr = (const int*)active_ptr;
  a.active = active;
  a.cam = Camera{(const float*)world_view, (const float*)full_proj,
                 (const float*)cam_pos,    (const float*)tan_fovx,
                 (const float*)tan_fovy,   width, height};
  a.smod = scale_modifier;
  a.C = C;
  a.g_mean2d = (const float*)g_mean2d;
  a.g_depth = (const float*)g_depth;
  a.g_conic = (const float*)g_conic;
  a.g_color = (const float*)g_color;
  a.s_mean2d = s_mean2d;
  a.s_depth = s_depth;
  a.s_conic = s_conic;
  a.s_color = s_color;
  a.d_xyz = (float*)d_xyz;
  a.d_ls = (float*)d_ls;
  a.d_q = (float*)d_q;
  a.d_dc = (float*)d_dc;
  a.d_rest = (float*)d_rest;
  a.d_off = (float*)d_off;
  return (int)dispatch<Bwd>(sh_degree, dc != nullptr, a,
                            (cudaStream_t)stream);
}

extern "C" const char* preprocess_forward_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* preprocess_backward_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
