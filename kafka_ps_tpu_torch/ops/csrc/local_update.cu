// K1, K2 and K3: the fused k-step logistic-regression local update, for
// Hopper (sm_90a), for one worker (K1) or a gang of workers (K2) in one
// call, with x stored in f32 (K1, K2) or in bf16 or int8 (K3).
//
// Replaces kafka_ps_tpu/ops/fused_update.py:_kernel (the Pallas TPU kernel
// behind fused_update.local_update) and its grid over gang members,
// fused_update.local_update_batched; and _stream_kernel /
// _stream_kernel_q (K3, via _stream_core and _stream_update), the TPU's
// batch-tiled version for slabs too large for VMEM and for bf16 / int8
// slab storage.  Same function, not the same layout:
//
//   for s in 0..k-1:
//       logits = x @ W.T + b                      [B, R]
//       g      = (softmax(logits) - onehot(y)) * mask / denom
//       W     -= lr * g.T @ x ;  b -= lr * sum_rows(g)
//   loss  = sum(-log_softmax(x @ W.T + b)[y] * mask) / denom
//   delta = (W, b)_k - (W, b)_0                   flat [R*F + R]
//
// with R = C+1 classes (no padding to the TPU's 128 lanes), denom =
// max(sum(mask), 1), and a label outside [0, R) giving an all-zero one-hot
// row: it keeps its softmax term in g and adds zero NLL, as on the TPU.
//
// What bounds it.  At B=1024, F=1024, R=6, k=2 the work is (4k+2)*B*F*R
// ~ 63 MFLOP of f32 per member (scalar FMA; ~1 us spread over the card at
// 67 TFLOP/s), and x alone is 4 MiB in f32 (2 MiB bf16, 1 MiB int8) that
// must be read at least once: ~1.3 us at 3.35 TB/s.  So the bound is about
// a microsecond per member.  What the step structure costs on top is a
// chain of dependent reductions: every step needs all B rows' g before W
// can move, and the loss needs W_k.
//
// The design: one cooperative, persistent launch per call.
//
//   Tiles.  The batch is cut into tiles of kTileRows = 8 rows, for every
//   shape, form, member count and grid: 128 tiles per member at B=1024.  A
//   CTA owns a contiguous range of (member, tile) pairs, the grid is at
//   most what the card holds co-resident (occupancy at the CTA's dynamic
//   shared memory and 128 registers a thread: two CTAs of 256 threads per
//   SM), and the host picks the fewest tiles per CTA that let every tile
//   be resident at once (at the main shape one tile per CTA for K1, 128
//   CTAs; two for a gang of 4, 256 CTAs).  Only which CTA runs a tile
//   depends on the grid; no sum does.
//
//   x staged once, in its stored form.  Each owned tile is copied into
//   shared memory with 16-byte cp.async of the aligned-down chunks that
//   cover its rows (slab_x.cuh's stage_rows, shared with mlp_update.cu),
//   so any F, form and base address stage alike, and it stays there for
//   the call: x crosses HBM once, not 2k+1 times.  bf16 and int8 stay
//   2 and 1 bytes an element in shared memory and are decoded where they
//   are read (slab_x.cuh's `at`, bitwise decode_x).  The rows' labels,
//   masks and int8 scales are staged beside them.  Where the owned tiles
//   do not fit (a gang larger than one co-resident wave, or a slab larger
//   than the card's shared memory), a CTA re-stages each tile at each step
//   into one buffer, in column chunks of a multiple of kThreads where a
//   row is wider than the buffer (F=70000): the same arithmetic, more
//   bytes.
//
//   Per step, in the launch.  For each owned tile: the logits of its rows
//   (thread t takes columns t, t+256, ... in order, W read through L2 with
//   ld.global.cg, a fixed butterfly across the warp's lanes, then the
//   eight warps' sums in warp order), log-softmax and g (a thread per
//   row), and the tile's partial g.T @ x and sum(g) (a thread per column,
//   rows in order) into scratch, one partial per tile.  A grid barrier.
//   Then every parameter of every member is reduced by one thread over its
//   member's tiles in tile order, and W_out = W_in - lr * s with
//   __fsub_rn/__fmul_rn.  Another grid barrier.  After k steps the loss:
//   per-tile masked NLL on the same resident x, a barrier, and one thread
//   per member sums the tiles in order and divides by denom.  2k+1 grid
//   barriers (cooperative_groups' grid.sync), 1 launch.  denom is summed
//   once per CTA and member, in the one fixed order every CTA shares.
//
//   No atomics.  Every sum has one order, fixed by the tile and the thread
//   layout alone, so a K2 member is bitwise a K1 call, a gang split into
//   chunks of 32 members is bitwise the single calls, and two launches
//   are bitwise equal; atomics would make the bits depend on arrival
//   order.  A failed cooperative launch returns its CUDA error, which the
//   wrapper raises: there is no fallback and no spin barrier on a normal
//   launch.
//
//   Memory order.  Data written inside the launch (the partials, the
//   W scratch, the loss partials) is read after a grid barrier through
//   L2 only (__ldcg / cp.async.cg), never through the read-only path
//   (__ldg), which is not coherent with other CTAs' writes within one
//   kernel.  x, y, mask and theta, which nothing writes, are read with
//   __ldg or cp.async.
//
// Built by kafka_ps_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry points below (ctypes).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "slab_x.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace kps;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 8;     // batch rows of a tile, for every call
constexpr int kMaxRows = 16;     // classes + 1; the wrapper refuses more
// A tile's shared memory beyond its rows: per row its scale, label, mask
// and first element's offset.
constexpr int kSlotExtra = kTileRows * 13;
// The tile buffer of a CTA that re-stages its tiles at each step.
constexpr int kStreamSmem = 64 * 1024;
// Partials a thread of the apply loads before it adds them, in order.
constexpr int kSumBatch = 32;
// CTAs per SM the register budget allows (__launch_bounds__), and the most
// logits a thread keeps in registers at once.
constexpr int kMinCtas = 2;
constexpr int kRegLogits = 64;
static_assert(kRegLogits <= 64 && kTileRows <= kThreads, "shapes");

// Tile rows whose logits a thread accumulates together: the most, a power
// of two, that keep R of them per row within kRegLogits.
__host__ __device__ constexpr int rows_per_set(int R) {
  int g = kTileRows;
  while (g > 1 && g * R > kRegLogits) g /= 2;
  return g;
}

// The tiling of one call, chosen on the host (plan) and passed by value.
// A CTA owns tiles [blockIdx.x * per_cta, + per_cta) of the members'
// tiles laid end to end (member m's tile j is m * nt + j).
struct Geom {
  int B, F, P;
  int nt;        // tiles per member
  int total;     // members * nt
  int per_cta;   // tiles a CTA owns
  int resident;  // 1: owned tiles staged once and kept for the call
  int cw;        // columns per staged chunk: F, or a multiple of kThreads
  int nchunks;   // chunks per row
  int stride;    // bytes per staged row
  int slots;     // tile buffers: per_cta when resident, else 1
  int smem;      // dynamic shared memory per CTA, bytes
  int grid;
};

// Shared memory every CTA has: the warps' reduction rows, each tile row's
// logits (then g), the rows' NLL, and denom per member.
struct Shared {
  float red[kWarps][64];
  float rows[kTileRows][kMaxRows];
  float nll[kTileRows];
  float denom[kMaxMembers];
};

// max(sum(mask), 1), summed in the same fixed order by every CTA.
__device__ float block_denom(const float* __restrict__ mask, int B,
                             float* red) {
  float s = 0.f;
  for (int i = threadIdx.x; i < B; i += kThreads) s += __ldg(mask + i);
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  float d = red[0];
  __syncthreads();
  return fmaxf(d, 1.0f);
}

// The warp's sums of N values per lane.  A level of the xor butterfly
// that can halve the set does (the lane with bit O set keeps the upper
// half and sends the lower), else it adds all N; each lane ends with
// final_count(N) sums, of indices base.. (lanes that differ only in the
// bits of the full levels hold the same ones).  One fixed order: float
// addition is commutative, so the lane of a pair that adds a sum does not
// change its bits.  48 shuffles for R=6 where a butterfly per value takes
// 240.
__host__ __device__ constexpr int final_count(int n, int o = 16) {
  return o == 0 ? n : final_count(n % 2 == 0 ? n / 2 : n, o / 2);
}

__host__ __device__ constexpr int full_levels(int n, int o = 16) {
  return o == 0 ? 0
                : (n % 2 == 0 ? full_levels(n / 2, o / 2)
                              : o | full_levels(n, o / 2));
}

template <int N, int O>
__device__ __forceinline__ void lane_reduce(float* v, int lane, int& base) {
  if constexpr (O > 0) {
    if constexpr (N % 2 == 0) {
      constexpr int h = N / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int j = 0; j < h; ++j) {
        const float send = up ? v[j] : v[j + h];
        const float keep = up ? v[j + h] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (up) base += h;
      lane_reduce<h, O / 2>(v, lane, base);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        v[j] += __shfl_xor_sync(0xffffffffu, v[j], O);
      lane_reduce<N, O / 2>(v, lane, base);
    }
  }
}

// log_softmax as jax.nn.log_softmax computes it: shifted - log(sum(exp)).
template <int R>
__device__ __forceinline__ void log_softmax(float* l) {
  float m = l[0];
#pragma unroll
  for (int r = 1; r < R; ++r) m = fmaxf(m, l[r]);
  float se = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    l[r] = l[r] - m;
    se += expf(l[r]);
  }
  const float lse = logf(se);
#pragma unroll
  for (int r = 0; r < R; ++r) l[r] = l[r] - lse;
}

// Tile partials, [members][P/32 blocks][tiles][32]: a warp's 32
// neighbouring parameters of one tile are one 128-byte line, and a
// parameter's partials of successive tiles are 128 bytes apart, so the
// apply's loads take immediate offsets from one base.  Pp = P rounded up to
// 32.
__host__ __device__ constexpr long long padded(long long P) {
  return (P + 31) / 32 * 32;
}
__device__ __forceinline__ size_t part_at(int p, int nt) {
  return (size_t)(p >> 5) * nt * 32 + (p & 31);
}

// A tile buffer in dynamic shared memory: its rows (stored form, kTileRows
// at g.stride bytes), and per row its scale, label, mask and the offset of
// its first element.  The slots' rows come first, then the per-row arrays.
struct Slot {
  unsigned char* rows;
  float* scale;
  int* y;
  float* mask;
  unsigned char* mis;
};

__device__ __forceinline__ Slot slot_at(unsigned char* sm, const Geom& g,
                                        int j) {
  unsigned char* extra = sm + (size_t)g.slots * kTileRows * g.stride;
  const int n = g.slots * kTileRows, o = j * kTileRows;
  Slot s;
  s.rows = sm + (size_t)j * kTileRows * g.stride;
  s.scale = reinterpret_cast<float*>(extra) + o;
  s.y = reinterpret_cast<int*>(extra + 4 * n) + o;
  s.mask = reinterpret_cast<float*>(extra + 8 * n) + o;
  s.mis = extra + 12 * n + o;
  return s;
}

// Issue the copies of chunk c of tile t into slot j, with its rows' label,
// mask and (int8) scale, zero past B; the caller commits and waits.
template <class S>
__device__ __forceinline__ void stage_tile(const typename S::Mem& mem,
                                           const Geom& g, int t, int c,
                                           unsigned char* sm, int j) {
  constexpr int ES = sizeof(typename S::T);
  const int m = t / g.nt, r0 = (t - m * g.nt) * kTileRows;
  const Slot sl = slot_at(sm, g, j);
  stage_rows(sl.rows, sl.mis, mem.x[m], (size_t)g.F * ES, ES, g.stride,
             kTileRows, g.cw, r0, g.B, c * g.cw, g.F, threadIdx.x, kThreads);
  const int i = threadIdx.x;
  if (i < kTileRows) {
    const int row = min(r0 + i, g.B - 1), n = r0 + i < g.B ? 4 : 0;
    cp_async4(sl.y + i, mem.y[m] + row, n);
    cp_async4(sl.mask + i, mem.mask[m] + row, n);
    if constexpr (std::is_same<S, SlabQ>::value)
      cp_async4(sl.scale + i, S::scales(mem, m) + row, n);
    else
      sl.scale[i] = 1.f;
  }
}

template <class S>
__device__ __forceinline__ void restage(const typename S::Mem& mem,
                                        const Geom& g, int t, int c,
                                        unsigned char* sm) {
  __syncthreads();                 // every read of the buffer is done
  stage_tile<S>(mem, g, t, c, sm, 0);
  cp_commit();
  cp_wait_all();
  __syncthreads();
}

// Columns a thread loads W for at once in the logits loop.
constexpr int kColBatch = 4;

// One tile's work at the member's weights w ([R, F] then b [R]).  LOSS =
// false: g of its rows, then its partial g.T @ x | sum(g) into out [P].
// LOSS = true: its rows' masked NLL, summed in row order, into *out.
template <class S, int R, bool LOSS>
__device__ __forceinline__ void tile_pass(const typename S::Mem& mem,
                                          const Geom& g, int t, int slot,
                                          const float* w, float denom,
                                          unsigned char* sm, Shared& sh,
                                          float* out) {
  constexpr int ES = sizeof(typename S::T);
  constexpr int G = rows_per_set(R);        // rows per register set
  constexpr int N = G * R;                  // logits per register set
  constexpr int NF = final_count(N), DUP = full_levels(N);
  const int m = t / g.nt, r0 = (t - m * g.nt) * kTileRows;
  const int nrows = min(kTileRows, g.B - r0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool each_chunk = !g.resident && g.nchunks > 1;
  if (!g.resident && g.nchunks == 1) restage<S>(mem, g, t, 0, sm);
  const Slot sl = slot_at(sm, g, slot);

  // logits: columns tid, tid + kThreads, ... of each row, in order; W (and
  // b) for kColBatch columns loaded at once
  for (int i0 = 0; i0 < kTileRows; i0 += G) {
    const float bias = tid < N ? __ldcg(w + (size_t)R * g.F + tid % R) : 0.f;
    float v[N];
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = 0.f;
    for (int c = 0; c < g.nchunks; ++c) {
      if (each_chunk) restage<S>(mem, g, t, c, sm);
      const unsigned char* xr[G];
      float s[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        xr[i] = sl.rows + (size_t)(i0 + i) * g.stride + sl.mis[i0 + i];
        s[i] = sl.scale[i0 + i];
      }
      const int c0 = c * g.cw, c1 = min(c0 + g.cw, g.F);
      for (int f0 = c0 + tid; f0 < c1; f0 += kColBatch * kThreads) {
        float wv[kColBatch][R];
#pragma unroll
        for (int u = 0; u < kColBatch; ++u) {
          const int f = f0 + u * kThreads;
#pragma unroll
          for (int r = 0; r < R; ++r)
            wv[u][r] = f < c1 ? __ldcg(w + (size_t)r * g.F + f) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kColBatch; ++u) {
          const int f = f0 + u * kThreads;
          if (f >= c1) break;
          const int e = (f - c0) * ES;
#pragma unroll
          for (int i = 0; i < G; ++i) {
            const float xv = S::at(xr[i] + e, s[i]);
#pragma unroll
            for (int r = 0; r < R; ++r)
              v[i * R + r] = fmaf(xv, wv[u][r], v[i * R + r]);
          }
        }
      }
    }
    int base = 0;
    lane_reduce<N, 16>(v, lane, base);
    if ((lane & DUP) == 0) {
#pragma unroll
      for (int q = 0; q < NF; ++q) sh.red[warp][base + q] = v[q];
    }
    __syncthreads();
    if (tid < N) {
      float a = sh.red[0][tid];
#pragma unroll
      for (int p = 1; p < kWarps; ++p) a += sh.red[p][tid];
      sh.rows[i0 + tid / R][tid % R] = a + bias;
    }
    __syncthreads();
  }

  // a thread per row: log-softmax, then g or the masked NLL
  if (tid < kTileRows) {
    float l[R];
#pragma unroll
    for (int r = 0; r < R; ++r) l[r] = sh.rows[tid][r];
    float nll = 0.f;
    if (tid < nrows) {
      log_softmax<R>(l);
      const int yv = sl.y[tid];
      const float mk = sl.mask[tid];
      if (LOSS) {
        float dot = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) dot += l[r] * ((yv == r) ? 1.f : 0.f);
        nll = -dot * mk;
      } else {
        const float scale = mk / denom;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float onehot = (yv == r) ? 1.f : 0.f;
          l[r] = (expf(l[r]) - onehot) * scale;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) l[r] = 0.f;
    }
    if (LOSS) {
      sh.nll[tid] = nll;
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) sh.rows[tid][r] = l[r];
    }
  }
  __syncthreads();
  if (LOSS) {
    if (tid == 0) {
      float a = 0.f;
      for (int i = 0; i < nrows; ++i) a += sh.nll[i];
      *out = a;
    }
    __syncthreads();
    return;
  }

  // this tile's g.T @ x (a thread per column, rows in order) and sum(g)
  for (int c = 0; c < g.nchunks; ++c) {
    if (each_chunk) restage<S>(mem, g, t, c, sm);
    const int c0 = c * g.cw, c1 = min(c0 + g.cw, g.F);
    for (int f = c0 + tid; f < c1; f += kThreads) {
      const int e = (f - c0) * ES;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      for (int i = 0; i < nrows; ++i) {
        const float xv = S::at(sl.rows + (size_t)i * g.stride + sl.mis[i] + e,
                               sl.scale[i]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(sh.rows[i][r], xv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) out[part_at(r * g.F + f, g.nt)] = acc[r];
    }
  }
  if (tid < R) {
    float a = 0.f;
    for (int i = 0; i < nrows; ++i) a += sh.rows[i][tid];
    out[part_at(R * g.F + tid, g.nt)] = a;
  }
  __syncthreads();       // before the next tile reuses sh.rows
}

// sum of p[0], p[STRIDE], ..., p[(n-1) STRIDE] in that order, through L2,
// kSumBatch loads in flight
template <int STRIDE>
__device__ __forceinline__ float sum_tiles(const float* p, int n) {
  float s = 0.f;
  int t = 0;
  for (; t + kSumBatch <= n; t += kSumBatch, p += kSumBatch * STRIDE) {
    float v[kSumBatch];
#pragma unroll
    for (int j = 0; j < kSumBatch; ++j) v[j] = __ldcg(p + j * STRIDE);
#pragma unroll
    for (int j = 0; j < kSumBatch; ++j) s += v[j];
  }
  for (; t < n; ++t, p += STRIDE) s += __ldcg(p);
  return s;
}

template <class S, int R>
__global__ void __launch_bounds__(kThreads, kMinCtas)
logreg_update(typename S::Mem mem, Geom g, float* scratch,
              float* __restrict__ delta, float* __restrict__ loss, float lr,
              int k) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Shared sh;
  extern __shared__ __align__(16) unsigned char sm[];
  const int members = g.total / g.nt;
  const size_t n = (size_t)members * g.P;
  const size_t Pp = padded(g.P);
  float* w_s = scratch;                      // [members, P]
  float* partials = w_s + n;                 // [members, Pp / 32, nt, 32]
  float* loss_parts = partials + (size_t)g.total * Pp;    // [members, nt]
  const int t0 = blockIdx.x * g.per_cta;
  const int t1 = min(t0 + g.per_cta, g.total);

  // the owned tiles' copies fly while denom is summed
  if (g.resident) {
    for (int t = t0; t < t1; ++t) stage_tile<S>(mem, g, t, 0, sm, t - t0);
    cp_commit();
  }
  for (int m = t0 / g.nt; m <= (t1 - 1) / g.nt; ++m) {
    const float d = block_denom(mem.mask[m], g.B, &sh.red[0][0]);
    if (threadIdx.x == 0) sh.denom[m] = d;
  }
  cp_wait_all();
  __syncthreads();

  // this CTA's share of the parameters: a contiguous, warp-aligned range
  const size_t span = ((n + gridDim.x - 1) / gridDim.x + 31) / 32 * 32;
  const size_t q0 = (size_t)blockIdx.x * span;
  const size_t q1 = q0 + span < n ? q0 + span : n;

  for (int s = 0; s < k; ++s) {
    for (int t = t0; t < t1; ++t) {
      const int m = t / g.nt;
      const float* w = s == 0 ? mem.theta[m] : w_s + (size_t)m * g.P;
      tile_pass<S, R, false>(mem, g, t, g.resident ? t - t0 : 0, w,
                             sh.denom[m], sm, sh,
                             partials + m * g.nt * Pp + (t - m * g.nt) * 32);
    }
    grid.sync();
    // W_out = W_in - lr * (the member's tile partials, in tile order); W_in
    // is theta on the first step, else this element of the scratch (read
    // and written by this thread alone); the last step writes delta
    for (size_t q = q0 + threadIdx.x; q < q1; q += kThreads) {
      const int m = (int)(q / g.P), p = (int)(q - (size_t)m * g.P);
      const float sum = sum_tiles<32>(
          partials + m * g.nt * Pp + part_at(p, g.nt), g.nt);
      const float* theta = mem.theta[m];
      const float w_in = s == 0 ? __ldg(theta + p) : __ldcg(w_s + q);
      // no contraction into an FMA: the same two roundings as w - lr * g
      const float wn = __fsub_rn(w_in, __fmul_rn(lr, sum));
      w_s[q] = wn;
      if (s == k - 1) delta[q] = __fsub_rn(wn, __ldg(theta + p));
    }
    grid.sync();
  }

  for (int t = t0; t < t1; ++t) {
    const int m = t / g.nt;
    const float* w = k == 0 ? mem.theta[m] : w_s + (size_t)m * g.P;
    tile_pass<S, R, true>(mem, g, t, g.resident ? t - t0 : 0, w, 1.f, sm,
                          sh, loss_parts + t);
  }
  if (k == 0)
    for (size_t q = q0 + threadIdx.x; q < q1; q += kThreads) delta[q] = 0.f;
  grid.sync();
  // the CTA that owns a member's first tile: its loss, tiles in order
  if (threadIdx.x == 0) {
    for (int m = (t0 + g.nt - 1) / g.nt; m * g.nt < t1; ++m)
      loss[m] = sum_tiles<1>(loss_parts + (size_t)m * g.nt, g.nt) /
                sh.denom[m];
  }
}

// -- the host side: the plan and the launch ----------------------------------

std::mutex plan_mu;
std::map<std::tuple<const void*, int, int, int, int>, Geom> plans;

// The tiling of a call on `members` members: the fewest tiles per CTA that
// keep every tile resident in one co-resident wave, else one re-staged
// buffer per CTA and as many CTAs as the card holds.  Cached per kernel
// instance, device and shape.
template <class S, int R>
int plan(int B, int F, int members, Geom& g) {
  const void* fn = reinterpret_cast<const void*>(logreg_update<S, R>);
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  const auto key = std::make_tuple(fn, dev, B, F, members);
  {
    std::lock_guard<std::mutex> lock(plan_mu);
    const auto it = plans.find(key);
    if (it != plans.end()) {
      g = it->second;
      return 0;
    }
  }
  int sms = 0, optin = 0;
  cudaFuncAttributes attr;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == 0) err = (int)cudaFuncGetAttributes(&attr, fn);
  const int max_dyn = optin - (int)attr.sharedSizeBytes;
  if (err == 0)
    err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, max_dyn);
  if (err != 0) return err;
  constexpr int ES = sizeof(typename S::T);
  auto bytes = [](int slots, int stride) {
    return slots * (kTileRows * stride + kSlotExtra);
  };
  auto occupancy = [&](int smem, int& blocks) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, kThreads, smem);
  };
  g.B = B;
  g.F = F;
  g.P = R * F + R;
  g.nt = (B + kTileRows - 1) / kTileRows;
  g.total = members * g.nt;
  g.resident = 0;
  // the stride of a whole staged row, where one fits shared memory at all
  const bool whole = (long long)F * ES <= max_dyn;
  const int full = whole ? 16 * stage_chunks(F * ES) : 0;
  for (int n = 1; whole && bytes(n, full) <= max_dyn; ++n) {
    int blocks = 0;
    if ((err = occupancy(bytes(n, full), blocks)) != 0) return err;
    if ((long long)blocks * sms * n >= g.total) {
      g.resident = 1;
      g.per_cta = g.slots = n;
      g.cw = F;
      g.stride = full;
      break;
    }
    if (n >= g.total) break;
  }
  if (!g.resident) {
    g.slots = 1;
    if (whole && bytes(1, full) <= kStreamSmem) {
      g.cw = F;
      g.stride = full;
    } else {
      g.cw = ((kStreamSmem - kSlotExtra) / kTileRows - 32) / ES / kThreads *
             kThreads;
      g.stride = 16 * stage_chunks(g.cw * ES);
    }
    int blocks = 0;
    if ((err = occupancy(bytes(1, g.stride), blocks)) != 0) return err;
    if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
    const long long wave = (long long)blocks * sms;
    g.per_cta = (int)((g.total + wave - 1) / wave);
  }
  g.nchunks = (F + g.cw - 1) / g.cw;
  g.grid = (g.total + g.per_cta - 1) / g.per_cta;
  g.smem = bytes(g.slots, g.stride);
  std::lock_guard<std::mutex> lock(plan_mu);
  plans[key] = g;
  return 0;
}

template <class S, int R>
int run(const typename S::Mem& mem, int members, float* delta, float* loss,
        float* scratch, int B, int F, int k, float lr, void* stream) {
  Geom g;
  int err = plan<S, R>(B, F, members, g);
  if (err != 0) return err;
  typename S::Mem m = mem;
  void* args[] = {&m, &g, &scratch, &delta, &loss, &lr, &k};
  err = (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(logreg_update<S, R>), dim3(g.grid),
      dim3(kThreads), args, (size_t)g.smem,
      static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// fn(std::integral_constant<int, R>) for the R = C+1 instances
template <class Fn>
int with_rows(int R, Fn&& fn) {
#define KPS_CASE(n) \
  case n:           \
    return fn(std::integral_constant<int, n>{});
  switch (R) {
    KPS_CASE(2) KPS_CASE(3) KPS_CASE(4) KPS_CASE(5) KPS_CASE(6) KPS_CASE(7)
    KPS_CASE(8) KPS_CASE(9) KPS_CASE(10) KPS_CASE(11) KPS_CASE(12)
    KPS_CASE(13) KPS_CASE(14) KPS_CASE(15) KPS_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KPS_CASE
}

template <class S>
int dispatch(const typename S::Mem& mem, int members, float* delta,
             float* loss, float* scratch, int B, int F, int R, int k,
             float lr, void* stream) {
  return with_rows(R, [&](auto r) {
    return run<S, decltype(r)::value>(mem, members, delta, loss, scratch, B,
                                      F, k, lr, stream);
  });
}

bool bad_shape(int B, int F, int k, int members) {
  return B < 1 || F < 1 || k < 0 || members < 1 || members > kMaxMembers;
}

}  // namespace

extern "C" {

// One call runs `members` independent updates (1 for K1) in one
// cooperative launch.  thetas, xs, ys and masks are host arrays of
// `members` device pointers ([P], [B, F], [B], [B] each).  Outputs: delta
// [members, P], loss [members].  scratch: the floats kps_logreg_scratch
// gives, in one allocation.  Returns the launch's CUDA error (0 if none).
int kps_local_update(const void* const* thetas, const void* const* xs,
                     const void* const* ys, const void* const* masks,
                     int members, float* delta, float* loss, float* scratch,
                     int B, int F, int R, int k, float lr, void* stream) {
  if (bad_shape(B, F, k, members)) return (int)cudaErrorInvalidValue;
  Members mem;
  fill_members(mem, thetas, xs, ys, masks, members);
  return dispatch<SlabF32>(mem, members, delta, loss, scratch, B, F, R, k,
                           lr, stream);
}

// K3, bf16 slab: as kps_local_update, with xs pointing at bf16 [B, F].
int kps_local_update_bf16(const void* const* thetas, const void* const* xs,
                          const void* const* ys, const void* const* masks,
                          int members, float* delta, float* loss,
                          float* scratch, int B, int F, int R, int k,
                          float lr, void* stream) {
  if (bad_shape(B, F, k, members)) return (int)cudaErrorInvalidValue;
  MembersBf16 mem;
  fill_members(mem, thetas, xs, ys, masks, members);
  return dispatch<SlabBf16>(mem, members, delta, loss, scratch, B, F, R, k,
                            lr, stream);
}

// K3, int8 slab: xs point at int8 q [B, F] and scales at f32 [B] (one
// scale per row).
int kps_local_update_q(const void* const* thetas, const void* const* xs,
                       const void* const* ys, const void* const* masks,
                       const void* const* scales, int members, float* delta,
                       float* loss, float* scratch, int B, int F, int R,
                       int k, float lr, void* stream) {
  if (bad_shape(B, F, k, members)) return (int)cudaErrorInvalidValue;
  MembersQ mem;
  fill_members(mem, thetas, xs, ys, masks, members);
  for (int i = 0; i < kMaxMembers; ++i)
    mem.scale[i] = i < members ? static_cast<const float*>(scales[i])
                               : nullptr;
  return dispatch<SlabQ>(mem, members, delta, loss, scratch, B, F, R, k, lr,
                         stream);
}

// The float counts of a call's scratch on `members` members, in the order
// it is laid out: W [members, P], tile partials [members, tiles, Pp] (P
// rounded up to 32), loss partials [members, tiles], with tiles =
// ceil(B / 8); into sizes[0..2].
void kps_logreg_scratch(int B, int F, int R, int members, long long* sizes) {
  const long long nt = (B + kTileRows - 1) / kTileRows;
  const long long P = (long long)R * F + R;
  sizes[0] = members * P;
  sizes[1] = members * nt * padded(P);
  sizes[2] = members * nt;
}

// The launch a call on the current device would make, for storage form
// `form` (0 f32, 1 bf16, 2 int8): out = {grid, tiles per CTA, dynamic
// shared memory per CTA in bytes, x resident (1) or re-staged (0),
// columns per staged chunk, chunks per row, static shared memory}.
// Returns a CUDA error, 0 if none.
int kps_logreg_plan(int B, int F, int R, int members, int form, int* out) {
  if (bad_shape(B, F, 0, members) || form < 0 || form > 2)
    return (int)cudaErrorInvalidValue;
  Geom g;
  auto one = [&](auto s, auto r) {
    using S = decltype(s);
    constexpr int RR = decltype(r)::value;
    int err = plan<S, RR>(B, F, members, g);
    cudaFuncAttributes attr;
    if (err == 0)
      err = (int)cudaFuncGetAttributes(
          &attr, reinterpret_cast<const void*>(logreg_update<S, RR>));
    if (err == 0) out[6] = (int)attr.sharedSizeBytes;
    return err;
  };
  const int err = with_rows(R, [&](auto r) {
    return form == 0   ? one(SlabF32{}, r)
           : form == 1 ? one(SlabBf16{}, r)
                       : one(SlabQ{}, r);
  });
  if (err != 0) return err;
  out[0] = g.grid;
  out[1] = g.per_cta;
  out[2] = g.smem;
  out[3] = g.resident;
  out[4] = g.cw;
  out[5] = g.nchunks;
  return 0;
}

int kps_max_rows() { return kMaxRows; }
int kps_max_members() { return kMaxMembers; }

}  // extern "C"
