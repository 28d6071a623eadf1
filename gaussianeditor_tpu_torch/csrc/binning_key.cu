// Kernel B1: sort key and gathered payload for every tile-instance rank.
//
// Replaces: gaussianeditor_tpu/ops/binning_sorted.py::_make_key_kernel
// (the Pallas key kernel of the sorted binning). Rank q belongs to the
// first Gaussian g with b_incl[g] > q (the last slot, C - 1, for q past
// b_incl[C - 1]); it is the tile j = q - (b_incl[g] - tiles_touched[g])
// steps into g's rect in y-major order, (ry + j / w) * grid_x + rx + j % w.
// The kernel writes
//   key = ((tile << depth_bits) | depth_bits of depth[g]'s float bits)
//         ^ 0x80000000
// as int32: the JAX kernel's uint32 key with its top bit flipped, so that
// signed order is the JAX key's unsigned order. A dead rank (q >= total,
// or j outside [0, tiles_touched[g])) gets 0xFFFFFFFF ^ 0x80000000 =
// INT32_MAX, which sorts after every live key. It also gathers g's
// compositing payload (mean2d x y, conic a b c, opacity, depth,
// color[ch]) into the field-major [7 + ch, n] buffer that the caller
// reorders by the sort. Integer division replaces the Pallas kernel's
// floor((j + 0.5) / w), which exists only because integer division is
// slow on the TPU's vector unit; there is no f32-encoded table either.
//
// Bound: bytes. It must read b_incl up to the owner of rank n - 1 (the
// slots after it own no rank: at 4x capacity, a dead tail of most of
// them), of each visible slot among those the fields it cannot derive
// (rect_min, rect_max.x, mean2d, conic, opacity, depth, color: 4 (10 + ch)
// bytes; tiles_touched is b_incl's difference and rect_max.y follows from
// it, though the kernel reads tiles_touched for brevity), and write 4 key
// bytes and 4 (7 + ch) payload bytes a rank (chip_smoke.py's b1_bytes).
// The 4-byte key (the parent wrote int64) also halves the passes of the
// radix sort that follows.
//
// Design. The parent ran one thread per rank, each with its own 20-22
// level binary search over b_incl in device memory: a chain of dependent
// loads per rank, the same chain for the ~20 neighbouring ranks of one
// Gaussian, so the kernel waited on latency, not bandwidth. Here a block
// of kThreads threads owns kRanks consecutive ranks:
//  1. The block finds the owner of its first rank by a kThreads-ary
//     search (a probe a thread, counted by __syncthreads_count: 4 levels
//     at 4M slots, against the parent's 22 for every rank).
//  2. The block walks the slots from there in pieces of kPiece (16-byte
//     loads of b_incl, coalesced) until b_incl passes its last rank, and
//     marks in shared memory the local rank where each slot's ranks start
//     (the JAX route's `mark`, inside one block). A window is as long as
//     the data makes it: runs of dead slots (tiles_touched 0) only add
//     pieces, and nothing bounds the slots a block walks.
//  3. A block scan of the marks numbers the block's owners (K <= kRanks)
//     and gives each rank its owner's number: the JAX route's `cummax`.
//  4. The owners' rows are staged once into shared memory, kGroup fields
//     at a time (the key's six ints, then the payload's fields), so a
//     Gaussian's row is read once a block and not once a rank. A thread
//     issues all its loads (kOwners owners x kGroup fields) before it
//     uses the first: one memory latency a group, not one a field.
//  5. Each thread writes 16-byte stores of four consecutive words of a
//     row, aligned on the row's own address, with the owner numbers of
//     its ranks held in registers: the payload keeps its row stride n
//     (B2, B3, tracing and the strips read it), and each row's ragged
//     ends take 4-byte stores.
// What is left: every block pays the search, the walk and a memory
// latency for each staged group before its stores, and the blocks of
// one wave do so together. Equal shares for a grid of resident blocks,
// each walking several chunks from one search, was slower (it needed
// more registers); PERF.md has the split (probe_b1.py --split).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 4;                      // ranks a thread
constexpr int kRanks = kThreads * kPer;      // ranks a block
constexpr int kPiece = kThreads * 4;         // slots a piece of the walk
constexpr int kGroup = 6;                    // fields staged at a time
constexpr int kOwners = 2;                   // owners a thread loads at once
static_assert(kPer == 4, "a thread stores one 16-byte quad of a row");
constexpr unsigned kBias = 0x80000000u;
constexpr unsigned kDeadKey = 0xFFFFFFFFu ^ kBias;   // INT32_MAX

// Row f of the payload (mean2d x y, conic a b c, opacity, depth, color)
// is src[g * stride] for slot g
__device__ __forceinline__ void field_src(int f, const float* mean2d,
                                          const float* conic,
                                          const float* opacity,
                                          const float* depth,
                                          const float* color, int ch,
                                          const float*& src, int& stride) {
  if (f < 2) {
    src = mean2d + f;
    stride = 2;
  } else if (f < 5) {
    src = conic + (f - 2);
    stride = 3;
  } else if (f < 7) {
    src = f == 5 ? opacity : depth;
    stride = 1;
  } else {
    src = color + (f - 7);
    stride = ch;
  }
}

// Words [0, cnt) of a row starting at dst, word(r, o) for rank r with
// index o (its owner's number, or slot): 16-byte stores of the quads
// aligned on dst's address, 4-byte stores at the ragged ends. Thread t
// stores quad t, ranks 4 t - a .. 4 t - a + 3 (a: dst's offset from 16
// bytes), whose indices it holds in ow (ranks 4 t - 4 .. 4 t + 3); the
// one quad past them (a > 0 and cnt = kRanks) takes index(r).
template <class Index, class Word>
__device__ __forceinline__ void store_words(unsigned* dst, int cnt,
                                            const int (&ow)[8], Index index,
                                            Word word) {
  const int a = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
  unsigned* base = dst - a;
  const int tid = threadIdx.x;
  int r = 4 * tid - a;
  int o[4];  // ow[4 + i - a], by selects: a is the same for every thread
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lo = a & 1 ? ow[3 + i] : ow[4 + i];
    const int hi = a & 1 ? ow[1 + i] : ow[2 + i];
    o[i] = a & 2 ? hi : lo;
  }
  if (r >= 0 && r + 4 <= cnt) {
    const unsigned w0 = word(r, o[0]), w1 = word(r + 1, o[1]);
    const unsigned w2 = word(r + 2, o[2]), w3 = word(r + 3, o[3]);
    reinterpret_cast<uint4*>(base)[tid] = make_uint4(w0, w1, w2, w3);
  } else if (r < cnt) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r + i >= 0 && r + i < cnt) base[4 * tid + i] = word(r + i, o[i]);
  }
  r += 4 * kThreads;
  if (r < cnt) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r + i < cnt) base[4 * (tid + kThreads) + i] = word(r + i, index(r + i));
  }
}

// #{g < C : b_incl[g] <= q}, by the whole block: kThreads probes a level
__device__ int count_le(const int* __restrict__ b_incl, int C, int q) {
  const int tid = threadIdx.x;
  int lo = 0, hi = C;  // b_incl[g] <= q for g < lo, > q for lo <= hi <= g
  while (hi - lo > kThreads) {
    const int step = (hi - lo + kThreads - 1) / kThreads;
    const int p = lo + (tid + 1) * step - 1;
    const int c = __syncthreads_count(p < hi && b_incl[p] <= q);
    const int nhi = c < kThreads ? min(hi, lo + (c + 1) * step - 1) : hi;
    lo += c * step;
    hi = nhi;
  }
  const int p = lo + tid;
  return lo + __syncthreads_count(p < hi && b_incl[p] <= q);
}

__global__ void __launch_bounds__(kThreads) binning_key_kernel(
    const int* __restrict__ b_incl, const int* __restrict__ tiles_touched,
    const int* __restrict__ rect_min, const int* __restrict__ rect_max,
    const float* __restrict__ mean2d, const float* __restrict__ conic,
    const float* __restrict__ opacity, const float* __restrict__ depth,
    const float* __restrict__ color, int C, int ch, int n, int total,
    int grid_x, int depth_bits, unsigned* __restrict__ key,
    unsigned* __restrict__ payload) {
  // own[r]: first the slot whose ranks start at local rank r (-1: none),
  // then the number of rank r's owner; slot[k]: owner k's slot
  __shared__ __align__(16) int own[kRanks];
  __shared__ int slot[kRanks];
  __shared__ __align__(16) unsigned stage[kGroup][kRanks];
  __shared__ int warp_sum[kThreads / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kRanks;
  const int cnt = min(kRanks, n - q0);
  const int btot = b_incl[C - 1];
  // ranks below `stop` have a slot of the walk as owner; the rest, C - 1
  const int stop = min(q0 + cnt, btot);

#pragma unroll
  for (int i = 0; i < kPer; ++i) own[tid + i * kThreads] = -1;
  // 1. the owner of the block's first rank (the search's last
  // __syncthreads_count also orders the stores above before the walk's)
  const int g_first = min(count_le(b_incl, C, q0), C - 1);
  if (tid == 0) own[0] = g_first;

  // 2. the walk: slot g starts its ranks at p = b_incl[g - 1] (0 for
  // g = 0) when b_incl[g] > p; mark each start inside (q0, stop)
  if (q0 < stop) {
    const bool vec = (reinterpret_cast<uintptr_t>(b_incl) & 15) == 0;
    for (int base = (g_first + 1) & ~3;; base += kPiece) {
      const int g4 = base + 4 * tid;
      int cur[4];
      if (vec && g4 + 3 < C) {
        const int4 v = *reinterpret_cast<const int4*>(b_incl + g4);
        cur[0] = v.x, cur[1] = v.y, cur[2] = v.z, cur[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) cur[i] = g4 + i < C ? b_incl[g4 + i] : btot;
      }
      int p = g4 == 0 ? 0 : (g4 - 1 < C ? b_incl[g4 - 1] : btot);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (cur[i] > p && p > q0 && p < stop) own[p - q0] = g4 + i;
        p = cur[i];
      }
      if (__syncthreads_or(cur[3] >= stop || g4 + 3 >= C - 1)) break;
    }
  }
  // ranks from b_incl[C - 1] on belong to the last slot
  if (tid == 0 && btot > q0 && btot < q0 + cnt) own[btot - q0] = C - 1;
  __syncthreads();

  // 3. number the owners in rank order: a block scan of the marks
  int mark[kPer], starts = 0;
  {
    const int4 m = reinterpret_cast<const int4*>(own)[tid];
    mark[0] = m.x, mark[1] = m.y, mark[2] = m.z, mark[3] = m.w;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (kPer * tid + i >= cnt) mark[i] = -1;
    starts += mark[i] >= 0;
  }
  int incl = starts;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = 0, K = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    K += warp_sum[w];
  }
  int k = before + incl - starts - 1;  // owner of the rank before ours
  int num[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (mark[i] >= 0) slot[++k] = mark[i];
    num[i] = k;
  }
  reinterpret_cast<int4*>(own)[tid] = make_int4(num[0], num[1], num[2], num[3]);
  __syncthreads();

  // 4. stage the owners' key fields, kOwners owners a thread at a time
  // with every load issued before the first is used
  for (int o0 = 0; o0 < K; o0 += kOwners * kThreads) {
    int g[kOwners], tt[kOwners], bi[kOwners], rx[kOwners], ry[kOwners];
    int mx[kOwners];
    float d[kOwners];
#pragma unroll
    for (int i = 0; i < kOwners; ++i) {
      const int o = o0 + i * kThreads + tid;
      g[i] = o < K ? slot[o] : -1;
    }
#pragma unroll
    for (int i = 0; i < kOwners; ++i) {
      if (g[i] >= 0) {
        const size_t gs = (size_t)g[i];
        tt[i] = tiles_touched[gs];
        bi[i] = b_incl[gs];
        rx[i] = rect_min[2 * gs];
        ry[i] = rect_min[2 * gs + 1];
        mx[i] = rect_max[2 * gs];
        d[i] = depth[gs];
      }
    }
#pragma unroll
    for (int i = 0; i < kOwners; ++i) {
      const int o = o0 + i * kThreads + tid;
      if (g[i] >= 0) {
        stage[0][o] = (unsigned)(bi[i] - tt[i]);
        stage[1][o] = (unsigned)tt[i];
        stage[2][o] = (unsigned)rx[i];
        stage[3][o] = (unsigned)ry[i];
        stage[4][o] = (unsigned)max(mx[i] - rx[i], 1);
        stage[5][o] = __float_as_uint(d[i]) >> (32 - depth_bits);
      }
    }
  }
  __syncthreads();

  // 5. store the keys
  // the owner numbers of ranks 4 tid - 4 .. 4 tid + 3, for store_words
  int ow[8];
  {
    const int4 lo = reinterpret_cast<const int4*>(own)[max(tid - 1, 0)];
    const int4 hi = reinterpret_cast<const int4*>(own)[tid];
    ow[0] = lo.x, ow[1] = lo.y, ow[2] = lo.z, ow[3] = lo.w;
    ow[4] = hi.x, ow[5] = hi.y, ow[6] = hi.z, ow[7] = hi.w;
  }
  const auto owner = [&](int r) { return own[r]; };
  store_words(key + q0, cnt, ow, owner, [&](int r, int o) -> unsigned {
    // every field read before any test, so that the loads overlap; in
    // unsigned arithmetic, the low 32 bits of the plain version's int64
    const unsigned bprev = stage[0][o], tt = stage[1][o], rx = stage[2][o];
    const unsigned ry = stage[3][o], w = stage[4][o], dk = stage[5][o];
    const int q = q0 + r;
    const unsigned j = (unsigned)q - bprev;
    const bool live = q < total && (int)j >= 0 && (int)j < (int)tt;
    const unsigned jy = j / w;  // w >= 1; j >= 0 where live
    const unsigned tile = (ry + jy) * (unsigned)grid_x + rx + (j - jy * w);
    return live ? ((tile << depth_bits) | dk) ^ kBias : kDeadKey;
  });

  const int P = 7 + ch;
  // 4 and 5 for the payload, kGroup fields at a time
  for (int f0 = 0; f0 < P; f0 += kGroup) {
    const int nf = min(kGroup, P - f0);
    const float* src[kGroup];
    int stride[kGroup];
#pragma unroll
    for (int f = 0; f < kGroup; ++f)
      field_src(min(f0 + f, P - 1), mean2d, conic, opacity, depth, color, ch,
                src[f], stride[f]);
    __syncthreads();  // the stage's last readers are done
    for (int o0 = 0; o0 < K; o0 += kOwners * kThreads) {
      int g[kOwners];
      float v[kOwners][kGroup];
#pragma unroll
      for (int i = 0; i < kOwners; ++i) {
        const int o = o0 + i * kThreads + tid;
        g[i] = o < K ? slot[o] : -1;
      }
#pragma unroll
      for (int i = 0; i < kOwners; ++i)
#pragma unroll
        for (int f = 0; f < kGroup; ++f)
          if (g[i] >= 0 && f < nf) v[i][f] = src[f][(size_t)g[i] * stride[f]];
#pragma unroll
      for (int i = 0; i < kOwners; ++i) {
        const int o = o0 + i * kThreads + tid;
#pragma unroll
        for (int f = 0; f < kGroup; ++f)
          if (g[i] >= 0 && f < nf) stage[f][o] = __float_as_uint(v[i][f]);
      }
    }
    __syncthreads();
    for (int f = 0; f < nf; ++f) {
      store_words(payload + (size_t)(f0 + f) * n + q0, cnt, ow, owner,
                  [&](int, int o) -> unsigned { return stage[f][o]; });
    }
  }
}

}  // namespace

extern "C" int binning_key(const void* b_incl, const void* tiles_touched,
                           const void* rect_min, const void* rect_max,
                           const void* mean2d, const void* conic,
                           const void* opacity, const void* depth,
                           const void* color, int C, int ch, int n, int total,
                           int grid_x, int depth_bits, void* key,
                           void* payload, void* stream) {
  if (n <= 0 || C <= 0 || ch <= 0 || n > INT_MAX - kRanks ||
      depth_bits < 1 || depth_bits > 31)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kRanks - 1) / kRanks;
  binning_key_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)b_incl, (const int*)tiles_touched, (const int*)rect_min,
      (const int*)rect_max, (const float*)mean2d, (const float*)conic,
      (const float*)opacity, (const float*)depth, (const float*)color, C, ch,
      n, total, grid_x, depth_bits, (unsigned*)key, (unsigned*)payload);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a launch (none: the block's 32 KB is static)
// and the blocks of it that fit on one SM; the same for every ch
extern "C" int binning_key_occupancy(int ch, int* smem, int* blocks) {
  (void)ch;
  *smem = 0;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, binning_key_kernel, kThreads, 0);
}

extern "C" const char* binning_key_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
