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
// Gang members.  Every pass has the member on blockIdx.y and finds the
// member's theta, x, y and mask through a table of base pointers passed by
// value (Members), so a gang needs no stacked copy of its slabs, and one
// theta shared by every member (sequential consistency) is the same pointer
// k times.  Outputs and scratch are [members, ...] arrays.  A member's
// blocks run exactly the code, in exactly the order, of a one-member call:
// K1 is this kernel with one member, so a K2 member is bitwise equal to a
// K1 call on its inputs by construction.
//
// What bounds it.  At B=1024, F=1024, R=6, k=2 the work is (4k+2)*B*F*R
// ~ 63 MFLOP of f32 per member, ~0.94 us at the H100 SXM's 67 TFLOP/s (no
// tensor cores: scalar f32 FMA, so TF32 never arises).  x alone is 4 MiB
// and must be read at least once: ~1.3 us at 3.35 TB/s.  So the bound is
// about a microsecond per member, set by bytes.
//
// The design is the simple one, far from that bound: 4 MiB of x does not
// fit one SM's 227 KB, so the batch is tiled across CTAs, and since CTAs
// run in no order, the TPU's sequential fori_loop becomes a sequence of
// launches:
//
//   per step s:  row_pass   (one CTA per 32 rows: each warp takes a row,
//                            R dot products over F with a fixed-order
//                            shuffle reduction, log-softmax, g; the CTA
//                            writes its partial g.T@x and sum(g))
//                apply_pass (one thread per parameter: sums the CTA
//                            partials in index order, W -= lr * sum)
//   then:        loss_pass  (per-CTA partial masked NLL at W_k)
//                loss_reduce (one CTA: fixed-order sum / denom)
//
// = 2k+2 launches, and x is read 2k+1 times (mostly from L2).  At the
// reference shape row_pass dominates (PERF.md, chip_smoke.py's profile):
// 32 rows per CTA leave 32 CTAs per member for 132 SMs, and each warp walks
// its rows and each thread its columns serially, so the pass is
// latency-bound on a quarter of the card for one member; a gang of four
// fills the card.  Each CTA recomputes denom from the mask in a fixed order
// (B floats), which saves a launch.  No atomics anywhere: every sum has a
// fixed order, so equal inputs give bitwise-equal outputs from run to run.
//
// K3.  The passes are templated on the slab's storage form (slab_x.cuh):
// every load of x decodes there, bf16 -> f32 or int8 q * (row scale), and
// the rest of the pass is the f32 code.  The TPU's (k+1, tiles) grid with
// its revisited accumulators is not needed: these passes already tile
// the batch across CTAs and reduce the per-CTA partials in a fixed order,
// and an f32 batch of any size is K1's.  The decode is the plain
// version's (decode_x) bit for bit, so K3 on a stored slab equals K1's
// arithmetic on the decoded slab.  At the reference shape x is 2 MiB
// (bf16) or 1 MiB plus 4 KiB of scales (int8); the work is K1's
// (4k+2)*B*F*R FLOP, so the bound moves from bytes to operations
// (~0.94 us).  The simple design stays: one 2- or 1-byte load per lane,
// no vector loads, so the int8 instance is expected no faster than f32.
//
// Loads of data a kernel only reads (x, y, mask, the weights a row pass
// reads, the partials) are written as __ldg.  With the member's pointers
// taken from the Members table, plain loads compiled to the same
// read-only LDG.E.CONSTANT instructions as __ldg (cuobjdump) but to a
// slower schedule: at the reference shape on an H100 the two row_pass
// launches of a call took 0.0653 ms, against 0.0568 ms for a one-member
// version with __restrict__ pointer parameters; with __ldg they take
// 0.0506 ms (scripts/torch_kernel_ab.py, PERF.md).
//
// Built by kafka_ps_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry point below (ctypes).

#include <cuda_runtime.h>
#include <math.h>

#include "slab_x.cuh"

namespace {

using namespace kps;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerCta = 32;
constexpr int kMaxRows = 16;     // classes + 1; the wrapper refuses more

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: float addition is commutative, so every lane ends with
  // the same bits, and the order is fixed
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// Logits of one row (stored form S, row scale s), reduced across the warp;
// every lane gets all R.
template <class S, int R>
__device__ __forceinline__ void row_logits(const typename S::T* __restrict__ xr,
                                           float s,
                                           const float* __restrict__ w,
                                           int F, int lane, float* out) {
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int f = lane; f < F; f += 32) {
    const float xv = S::ldg(xr + f, s);
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r] = fmaf(xv, __ldg(w + r * F + f), acc[r]);
  }
  const float* b = w + (size_t)R * F;
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = warp_sum(acc[r]) + __ldg(b + r);
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

// The member's current weights: theta on the first step, else its scratch.
template <class Mem>
__device__ __forceinline__ const float* member_w(const Mem& mem,
                                                 const float* w_scratch,
                                                 int first, int m, int P) {
  return first ? mem.theta[m] : w_scratch + (size_t)m * P;
}

template <class S, int R>
__global__ void __launch_bounds__(kThreads)
row_pass(typename S::Mem mem, const float* w_scratch, int first,
         float* __restrict__ partials, int B, int F) {
  __shared__ float red[kThreads];
  __shared__ float g_s[kRowsPerCta][R];
  const int m = blockIdx.y;
  const int P = R * F + R;
  const typename S::T* __restrict__ x = mem.x[m];
  const float* __restrict__ sc = S::scales(mem, m);
  const int* __restrict__ y = mem.y[m];
  const float* __restrict__ mask = mem.mask[m];
  const float* __restrict__ w = member_w(mem, w_scratch, first, m, P);
  const float denom = block_denom(mask, B, red);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerCta;
  const int nrows = min(kRowsPerCta, B - row0);

  for (int i = warp; i < kRowsPerCta; i += kWarps) {
    float g[R];
    if (i < nrows) {
      const int row = row0 + i;
      float l[R];
      row_logits<S, R>(x + (size_t)row * F, S::scale(sc, row), w, F, lane,
                       l);
      log_softmax<R>(l);
      const int yv = __ldg(y + row);
      const float scale = __ldg(mask + row) / denom;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float onehot = (yv == r) ? 1.f : 0.f;
        g[r] = (expf(l[r]) - onehot) * scale;
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) g[r] = 0.f;
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) g_s[i][r] = g[r];
    }
  }
  __syncthreads();

  // this CTA's g.T @ x and sum(g), rows in index order
  float* out = partials + ((size_t)m * gridDim.x + blockIdx.x) * P;
  for (int f = threadIdx.x; f < F; f += kThreads) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int i = 0; i < nrows; ++i) {
      const float xv = S::ldg(x + (size_t)(row0 + i) * F + f,
                              S::scale(sc, row0 + i));
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(g_s[i][r], xv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) out[(size_t)r * F + f] = acc[r];
  }
  if (threadIdx.x < R) {
    float s = 0.f;
    for (int i = 0; i < nrows; ++i) s += g_s[i][threadIdx.x];
    out[(size_t)R * F + threadIdx.x] = s;
  }
}

// W_out = W_in - lr * (sum of the member's CTA partials, in CTA order).
// W_in is theta on the first step and the member's scratch (the same
// element W_out writes, read and written by one thread) after it.  On the
// last step it also writes delta = W_k - theta.
template <class Mem>
__global__ void __launch_bounds__(kThreads)
apply_pass(Mem mem, float* w_scratch, int first, int last,
           const float* __restrict__ partials, int nparts, int P, float lr,
           float* __restrict__ delta) {
  const int m = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const float* pm = partials + (size_t)m * nparts * P;
  float s = 0.f;
  for (int c = 0; c < nparts; ++c) s += __ldg(pm + (size_t)c * P + p);
  const float* theta = mem.theta[m];
  const float* w_in = member_w(mem, w_scratch, first, m, P);
  // no contraction into an FMA: the same two roundings as w - lr * g
  const float wn = __fsub_rn(w_in[p], __fmul_rn(lr, s));
  w_scratch[(size_t)m * P + p] = wn;
  if (last) delta[(size_t)m * P + p] = __fsub_rn(wn, theta[p]);
}

template <class S, int R>
__global__ void __launch_bounds__(kThreads)
loss_pass(typename S::Mem mem, const float* w_scratch, int from_theta,
          float* __restrict__ loss_partials, int B, int F) {
  __shared__ float nll_s[kRowsPerCta];
  const int m = blockIdx.y;
  const int P = R * F + R;
  const typename S::T* __restrict__ x = mem.x[m];
  const float* __restrict__ sc = S::scales(mem, m);
  const int* __restrict__ y = mem.y[m];
  const float* __restrict__ mask = mem.mask[m];
  const float* __restrict__ w = member_w(mem, w_scratch, from_theta, m, P);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerCta;
  const int nrows = min(kRowsPerCta, B - row0);
  for (int i = warp; i < kRowsPerCta; i += kWarps) {
    float v = 0.f;
    if (i < nrows) {
      const int row = row0 + i;
      float l[R];
      row_logits<S, R>(x + (size_t)row * F, S::scale(sc, row), w, F, lane,
                       l);
      log_softmax<R>(l);
      const int yv = __ldg(y + row);
      float dot = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) dot += l[r] * ((yv == r) ? 1.f : 0.f);
      v = -dot * __ldg(mask + row);
    }
    if (lane == 0) nll_s[i] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < nrows; ++i) s += nll_s[i];
    loss_partials[(size_t)m * gridDim.x + blockIdx.x] = s;
  }
}

template <class Mem>
__global__ void __launch_bounds__(kThreads)
loss_reduce(Mem mem, int B, const float* __restrict__ loss_partials,
            int nparts, float* __restrict__ loss) {
  __shared__ float red[kThreads];
  const int m = blockIdx.y;
  const float denom = block_denom(mem.mask[m], B, red);
  if (threadIdx.x == 0) {
    const float* lp = loss_partials + (size_t)m * nparts;
    float s = 0.f;
    for (int c = 0; c < nparts; ++c) s += lp[c];
    loss[m] = s / denom;
  }
}

template <class S, int R>
int run(const typename S::Mem& mem, int members, float* delta, float* loss,
        float* w, float* partials, float* loss_partials, int B, int F, int k,
        float lr, cudaStream_t st) {
  const int nblk = (B + kRowsPerCta - 1) / kRowsPerCta;
  const int P = R * F + R;
  const dim3 rows(nblk, members);
  const dim3 params((P + kThreads - 1) / kThreads, members);
  if (k == 0)
    cudaMemsetAsync(delta, 0, sizeof(float) * (size_t)members * P, st);
  for (int s = 0; s < k; ++s) {
    row_pass<S, R><<<rows, kThreads, 0, st>>>(mem, w, s == 0, partials, B,
                                              F);
    apply_pass<typename S::Mem><<<params, kThreads, 0, st>>>(
        mem, w, s == 0, s == k - 1, partials, nblk, P, lr, delta);
  }
  loss_pass<S, R><<<rows, kThreads, 0, st>>>(mem, w, k == 0, loss_partials,
                                             B, F);
  loss_reduce<typename S::Mem><<<dim3(1, members), kThreads, 0, st>>>(
      mem, B, loss_partials, nblk, loss);
  return (int)cudaGetLastError();
}

// The R = C+1 instance of a storage form's passes.
template <class S>
int dispatch(const typename S::Mem& mem, int members, float* delta,
             float* loss, float* w, float* partials, float* loss_partials,
             int B, int F, int R, int k, float lr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KPS_CASE(n)                                                        \
  case n:                                                                  \
    return run<S, n>(mem, members, delta, loss, w, partials,               \
                     loss_partials, B, F, k, lr, st);
  switch (R) {
    KPS_CASE(2) KPS_CASE(3) KPS_CASE(4) KPS_CASE(5) KPS_CASE(6) KPS_CASE(7)
    KPS_CASE(8) KPS_CASE(9) KPS_CASE(10) KPS_CASE(11) KPS_CASE(12)
    KPS_CASE(13) KPS_CASE(14) KPS_CASE(15) KPS_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KPS_CASE
}

bool bad_shape(int B, int F, int k, int members) {
  return B < 1 || F < 1 || k < 0 || members < 1 || members > kMaxMembers;
}

}  // namespace

extern "C" {

// One call runs `members` independent updates (1 for K1).  thetas, xs, ys
// and masks are host arrays of `members` device pointers ([P], [B, F],
// [B], [B] each).  Outputs: delta [members, P], loss [members].  Scratch
// the caller allocates: w [members, P], partials [members, ceil(B/32), P],
// loss_partials [members, ceil(B/32)], with P = R*F + R.  Returns
// cudaGetLastError() after the launches.
int kps_local_update(const void* const* thetas, const void* const* xs,
                     const void* const* ys, const void* const* masks,
                     int members, float* delta, float* loss, float* w,
                     float* partials, float* loss_partials, int B, int F,
                     int R, int k, float lr, void* stream) {
  if (bad_shape(B, F, k, members)) return (int)cudaErrorInvalidValue;
  Members mem;
  fill_members(mem, thetas, xs, ys, masks, members);
  return dispatch<SlabF32>(mem, members, delta, loss, w, partials,
                           loss_partials, B, F, R, k, lr, stream);
}

// K3, bf16 slab: as kps_local_update, with xs pointing at bf16 [B, F].
int kps_local_update_bf16(const void* const* thetas, const void* const* xs,
                          const void* const* ys, const void* const* masks,
                          int members, float* delta, float* loss, float* w,
                          float* partials, float* loss_partials, int B,
                          int F, int R, int k, float lr, void* stream) {
  if (bad_shape(B, F, k, members)) return (int)cudaErrorInvalidValue;
  MembersBf16 mem;
  fill_members(mem, thetas, xs, ys, masks, members);
  return dispatch<SlabBf16>(mem, members, delta, loss, w, partials,
                            loss_partials, B, F, R, k, lr, stream);
}

// K3, int8 slab: xs point at int8 q [B, F] and scales at f32 [B] (one
// scale per row).
int kps_local_update_q(const void* const* thetas, const void* const* xs,
                       const void* const* ys, const void* const* masks,
                       const void* const* scales, int members, float* delta,
                       float* loss, float* w, float* partials,
                       float* loss_partials, int B, int F, int R, int k,
                       float lr, void* stream) {
  if (bad_shape(B, F, k, members)) return (int)cudaErrorInvalidValue;
  MembersQ mem;
  fill_members(mem, thetas, xs, ys, masks, members);
  for (int i = 0; i < kMaxMembers; ++i)
    mem.scale[i] = i < members ? static_cast<const float*>(scales[i])
                               : nullptr;
  return dispatch<SlabQ>(mem, members, delta, loss, w, partials,
                         loss_partials, B, F, R, k, lr, stream);
}

int kps_rows_per_cta() { return kRowsPerCta; }
int kps_max_rows() { return kMaxRows; }
int kps_max_members() { return kMaxMembers; }

}  // extern "C"
