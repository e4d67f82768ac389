// K4, K6 and K5: the fused k-step local update of the one-hidden-layer MLP,
// for Hopper (sm_90a), for one worker (K4) or a gang of workers (K6) in one
// call, with x stored in f32 (K4, K6) or in bf16 or int8 (K5).
//
// Replaces kafka_ps_tpu/ops/fused_update.py:_mlp_kernel (the Pallas TPU
// kernel behind fused_update.mlp_local_update) and its grid over gang
// members, fused_update.mlp_local_update_batched; and _mlp_stream_kernel /
// _mlp_stream_kernel_q (K5, via _mlp_stream_core and _mlp_stream_update),
// the TPU's batch-tiled version for oversize and bf16 / int8 slabs.  The
// function:
//
//   for s in 0..k-1:
//       pre   = x @ W1.T + b1 ;  hid = relu(pre)       [B, H]
//       logit = hid @ W2.T + b2                        [B, R]
//       g     = (softmax(logit) - onehot(y)) * mask * row_valid / denom
//       dW2   = g.T @ hid ;  db2 = sum_rows(g)
//       dh    = (g @ W2) * (pre > 0)                   relu'(0) = 0
//       dW1   = dh.T @ x  ;  db1 = sum_rows(dh)
//       (W1, b1, W2, b2) -= lr * (dW1, db1, dW2, db2)
//   loss  = sum(-log_softmax(logit at W_k)[y] * mask) / denom
//   delta = W_k - W_0, flat W1[H,F] | b1[H] | W2[R,H] | b2[R]
//
// with R = C+1 classes exactly (no lane padding and no -1e30 mask on padded
// classes: there are none), any H and any B, denom = max(sum(mask), 1), and
// row_valid = 1 for a label in [0, R), else 0: a row with an out-of-range
// label gets zero gradient (jax.grad of the one-hot cross-entropy, unlike
// the logreg kernel) and adds zero NLL.
//
// Gang members: as in local_update.cu, the member is a grid axis (y, or z
// for the dW1 pass) and Members holds per-member base pointers, so K4 is
// this kernel with one member and a K6 member is bitwise equal to a K4 call
// by construction.
//
// What bounds it.  At B=1024, F=1024, H=128, R=6, k=2 the work is
// (4k+2)*B*F*H + (6k+2)*B*H*R = 1.35 GFLOP of f32 per member: 20 us at the
// H100 SXM's 67 TFLOP/s outside the tensor cores (IEEE f32 FMA, no TF32),
// against 5.3 MB of inputs and outputs (1.6 us at 3.35 TB/s).  So the bound
// is set by operations, and almost all of them are in the two B*F*H
// products: pre (x @ W1.T) and dW1 (dh.T @ x).
//
// The design is the simple, deterministic one, without atomics:
//
//   per step s:  row_pass   (one CTA per 32 rows: pre/hid for its rows by a
//                            shared-memory tiled product over F in a fixed
//                            order, then one warp per row: logits, log-
//                            softmax, g, dh (to global); then the CTA's
//                            partials of db1 | dW2 | db2, rows in order)
//                dw1_pass   (one CTA per 32x32 tile of W1: dh.T @ x over
//                            all B rows in a fixed order, then
//                            W1 -= lr * dW1 in place)
//                tail_apply (one thread per b1/W2/b2 parameter: sums the
//                            CTA partials in index order and applies)
//   then:        loss_pass  (pre/hid/logits at W_k, per-CTA masked NLL)
//                loss_reduce (one CTA per member: fixed-order sum / denom)
//
// = 3k+2 launches.  hid and dh live in global scratch [B, H] (L2-resident
// at these sizes), so H has no shared-memory cap.  The row pass gives 32
// CTAs per member for 132 SMs and re-reads x once per 64 hidden units; the
// dW1 pass gives (F/32)*(H/32) = 128 CTAs.  Every sum has a fixed order,
// so equal inputs give bitwise-equal outputs from run to run.
//
// K5 is these passes templated on the slab's storage form (slab_x.cuh), as
// K3 is K1's: x is read only where a tile of it is loaded into shared
// memory (the hidden product of the row and loss passes, and the dW1
// pass), and it is decoded there, exactly as decode_x does, so every
// product runs on the f32 values the plain version sees.  The bound stays
// K4's, set by operations.
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
constexpr int kTile = 32;        // depth of a product tile, edge of a W1 tile
constexpr int kHidChunk = 64;    // hidden units per sweep of the row product

// Shapes of one call: T = H + R*H + R is the length of the b1|W2|b2 tail,
// P = H*F + T the length of the flat parameter vector.
struct Dims {
  int B, F, H, T, P, nblk;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max(sum(mask), 1), summed in the same fixed order by every CTA.
__device__ float block_denom(const float* __restrict__ mask, int B,
                             float* red) {
  float s = 0.f;
  for (int i = threadIdx.x; i < B; i += kThreads) s += mask[i];
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

template <class Mem>
__device__ __forceinline__ const float* member_w(const Mem& mem,
                                                 const float* w_scratch,
                                                 int first, int m, int P) {
  return first ? mem.theta[m] : w_scratch + (size_t)m * P;
}

// hid[row, h] = relu(x[row] . W1[h] + b1[h]) for the CTA's rows, written to
// global.  A 32 x 64 output tile per sweep, 2 x 4 outputs per thread, each
// a sequential sum over f in index order.  x is stored in form S (row
// scales sc) and decoded as its tile is loaded.  Ends with __syncthreads,
// so the block sees every hid it wrote.
template <class S>
__device__ void hidden_rows(const typename S::T* __restrict__ x,
                            const float* __restrict__ sc,
                            const float* __restrict__ w1,
                            const float* __restrict__ b1,
                            float* __restrict__ hid, int row0, int nrows,
                            int F, int H) {
  __shared__ float xs[kRowsPerCta][kTile + 1];
  __shared__ float ws[kHidChunk][kTile + 1];
  const int t = threadIdx.x;
  const int tr = t / 16, tc = t % 16;   // rows 2tr, 2tr+1; units tc + 16j
  for (int hc = 0; hc < H; hc += kHidChunk) {
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int f0 = 0; f0 < F; f0 += kTile) {
      for (int e = t; e < kRowsPerCta * kTile; e += kThreads) {
        const int r = e / kTile, c = e % kTile, f = f0 + c;
        xs[r][c] = (r < nrows && f < F)
                       ? S::get(x + (size_t)(row0 + r) * F + f,
                                S::scale(sc, row0 + r))
                       : 0.f;
      }
      for (int e = t; e < kHidChunk * kTile; e += kThreads) {
        const int hh = e / kTile, c = e % kTile, h = hc + hh, f = f0 + c;
        ws[hh][c] = (h < H && f < F) ? w1[(size_t)h * F + f] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kTile; ++kk) {
        const float a0 = xs[2 * tr][kk], a1 = xs[2 * tr + 1][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = ws[tc + 16 * j][kk];
          acc[0][j] = fmaf(a0, b, acc[0][j]);
          acc[1][j] = fmaf(a1, b, acc[1][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * tr + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = hc + tc + 16 * j;
        if (r < nrows && h < H)
          hid[(size_t)(row0 + r) * H + h] = fmaxf(acc[i][j] + b1[h], 0.f);
      }
    }
  }
  __syncthreads();
}

// Logits of one hidden row, reduced across the warp; every lane gets all R.
template <int R>
__device__ __forceinline__ void hidden_logits(const float* __restrict__ hr,
                                              const float* __restrict__ w2,
                                              const float* __restrict__ b2,
                                              int H, int lane, float* out) {
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int h = lane; h < H; h += 32) {
    const float hv = hr[h];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(hv, w2[r * H + h], acc[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = warp_sum(acc[r]) + b2[r];
}

template <class S, int R>
__global__ void __launch_bounds__(kThreads)
row_pass(typename S::Mem mem, const float* w_scratch, int first, Dims d,
         float* __restrict__ hid_all, float* __restrict__ dh_all,
         float* __restrict__ partials) {
  __shared__ float red[kThreads];
  __shared__ float g_s[kRowsPerCta][R];
  const int m = blockIdx.y;
  const int H = d.H;
  const typename S::T* __restrict__ x = mem.x[m];
  const int* __restrict__ y = mem.y[m];
  const float* __restrict__ mask = mem.mask[m];
  const float* w1 = member_w(mem, w_scratch, first, m, d.P);
  const float* b1 = w1 + (size_t)H * d.F;
  const float* w2 = b1 + H;
  const float* b2 = w2 + R * H;
  float* hid = hid_all + (size_t)m * d.B * H;
  float* dh = dh_all + (size_t)m * d.B * H;
  const float denom = block_denom(mask, d.B, red);
  const int row0 = blockIdx.x * kRowsPerCta;
  const int nrows = min(kRowsPerCta, d.B - row0);
  hidden_rows<S>(x, S::scales(mem, m), w1, b1, hid, row0, nrows, d.F, H);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < kRowsPerCta; i += kWarps) {
    float g[R];
    if (i < nrows) {
      const int row = row0 + i;
      const float* hr = hid + (size_t)row * H;
      float l[R];
      hidden_logits<R>(hr, w2, b2, H, lane, l);
      log_softmax<R>(l);
      const int yv = y[row];
      const float valid = (yv >= 0 && yv < R) ? 1.f : 0.f;
      const float scale = mask[row] * valid / denom;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float onehot = (yv == r) ? 1.f : 0.f;
        g[r] = (expf(l[r]) - onehot) * scale;
      }
      for (int h = lane; h < H; h += 32) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) s = fmaf(g[r], w2[r * H + h], s);
        dh[(size_t)row * H + h] = hr[h] > 0.f ? s : 0.f;
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

  // this CTA's db1 | dW2 | db2, rows in index order
  float* out = partials + ((size_t)m * d.nblk + blockIdx.x) * d.T;
  for (int p = threadIdx.x; p < d.T; p += kThreads) {
    float s = 0.f;
    if (p < H) {
      for (int i = 0; i < nrows; ++i) s += dh[(size_t)(row0 + i) * H + p];
    } else if (p < H + R * H) {
      const int q = p - H, r = q / H, h = q % H;
      for (int i = 0; i < nrows; ++i)
        s = fmaf(g_s[i][r], hid[(size_t)(row0 + i) * H + h], s);
    } else {
      const int r = p - H - R * H;
      for (int i = 0; i < nrows; ++i) s += g_s[i][r];
    }
    out[p] = s;
  }
}

// dW1 tile = dh.T @ x over all B rows in index order, then W1 -= lr * dW1
// (each element read and written by one thread); on the last step also
// delta = W1_k - W1_0.
template <class S>
__global__ void __launch_bounds__(kThreads)
dw1_pass(typename S::Mem mem, float* w_scratch, int first, int last, Dims d,
         const float* __restrict__ dh_all, float lr,
         float* __restrict__ delta) {
  __shared__ float ds[kTile][kTile + 1];
  __shared__ float xs[kTile][kTile + 1];
  const int m = blockIdx.z;
  const typename S::T* __restrict__ x = mem.x[m];
  const float* __restrict__ sc = S::scales(mem, m);
  const float* __restrict__ dh = dh_all + (size_t)m * d.B * d.H;
  const int f0 = blockIdx.x * kTile, h0 = blockIdx.y * kTile;
  const int t = threadIdx.x, th = t / kTile, tf = t % kTile;  // th 0..7
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b0 = 0; b0 < d.B; b0 += kTile) {
    for (int e = t; e < kTile * kTile; e += kThreads) {
      const int bb = e / kTile, c = e % kTile, b = b0 + bb;
      ds[bb][c] = (b < d.B && h0 + c < d.H) ? dh[(size_t)b * d.H + h0 + c]
                                            : 0.f;
      xs[bb][c] = (b < d.B && f0 + c < d.F)
                      ? S::get(x + (size_t)b * d.F + f0 + c, S::scale(sc, b))
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int bb = 0; bb < kTile; ++bb) {
      const float xv = xs[bb][tf];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] = fmaf(ds[bb][th + 8 * j], xv, acc[j]);
    }
    __syncthreads();
  }
  const float* theta = mem.theta[m];
  const float* w_in = member_w(mem, w_scratch, first, m, d.P);
  float* w_out = w_scratch + (size_t)m * d.P;
  const int f = f0 + tf;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int h = h0 + th + 8 * j;
    if (h < d.H && f < d.F) {
      const size_t p = (size_t)h * d.F + f;
      // no contraction into an FMA: the same two roundings as w - lr * g
      const float wn = __fsub_rn(w_in[p], __fmul_rn(lr, acc[j]));
      w_out[p] = wn;
      if (last) delta[(size_t)m * d.P + p] = __fsub_rn(wn, theta[p]);
    }
  }
}

// b1 | W2 | b2 -= lr * (sum of the CTA partials, in CTA order).
template <class Mem>
__global__ void __launch_bounds__(kThreads)
tail_apply(Mem mem, float* w_scratch, int first, int last, Dims d,
           const float* __restrict__ partials, float lr,
           float* __restrict__ delta) {
  const int m = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= d.T) return;
  const float* pm = partials + (size_t)m * d.nblk * d.T;
  float s = 0.f;
  for (int c = 0; c < d.nblk; ++c) s += pm[(size_t)c * d.T + p];
  const size_t off = (size_t)d.H * d.F + p;
  const float* theta = mem.theta[m];
  const float* w_in = member_w(mem, w_scratch, first, m, d.P);
  const float wn = __fsub_rn(w_in[off], __fmul_rn(lr, s));
  w_scratch[(size_t)m * d.P + off] = wn;
  if (last) delta[(size_t)m * d.P + off] = __fsub_rn(wn, theta[off]);
}

template <class S, int R>
__global__ void __launch_bounds__(kThreads)
loss_pass(typename S::Mem mem, const float* w_scratch, int from_theta,
          Dims d, float* __restrict__ hid_all,
          float* __restrict__ loss_partials) {
  __shared__ float nll_s[kRowsPerCta];
  const int m = blockIdx.y;
  const int H = d.H;
  const typename S::T* __restrict__ x = mem.x[m];
  const int* __restrict__ y = mem.y[m];
  const float* __restrict__ mask = mem.mask[m];
  const float* w1 = member_w(mem, w_scratch, from_theta, m, d.P);
  const float* b1 = w1 + (size_t)H * d.F;
  const float* w2 = b1 + H;
  const float* b2 = w2 + R * H;
  float* hid = hid_all + (size_t)m * d.B * H;
  const int row0 = blockIdx.x * kRowsPerCta;
  const int nrows = min(kRowsPerCta, d.B - row0);
  hidden_rows<S>(x, S::scales(mem, m), w1, b1, hid, row0, nrows, d.F, H);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < kRowsPerCta; i += kWarps) {
    float v = 0.f;
    if (i < nrows) {
      const int row = row0 + i;
      float l[R];
      hidden_logits<R>(hid + (size_t)row * H, w2, b2, H, lane, l);
      log_softmax<R>(l);
      const int yv = y[row];
      float dot = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) dot += l[r] * ((yv == r) ? 1.f : 0.f);
      v = -dot * mask[row];
    }
    if (lane == 0) nll_s[i] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < nrows; ++i) s += nll_s[i];
    loss_partials[(size_t)m * d.nblk + blockIdx.x] = s;
  }
}

template <class Mem>
__global__ void __launch_bounds__(kThreads)
loss_reduce(Mem mem, Dims d, const float* __restrict__ loss_partials,
            float* __restrict__ loss) {
  __shared__ float red[kThreads];
  const int m = blockIdx.y;
  const float denom = block_denom(mem.mask[m], d.B, red);
  if (threadIdx.x == 0) {
    const float* lp = loss_partials + (size_t)m * d.nblk;
    float s = 0.f;
    for (int c = 0; c < d.nblk; ++c) s += lp[c];
    loss[m] = s / denom;
  }
}

template <class S, int R>
int run(const typename S::Mem& mem, int members, float* delta, float* loss,
        float* w, float* hid, float* dh, float* partials,
        float* loss_partials, int B, int F, int H, int k, float lr,
        cudaStream_t st) {
  Dims d;
  d.B = B;
  d.F = F;
  d.H = H;
  d.T = H + R * H + R;
  d.P = H * F + d.T;
  d.nblk = (B + kRowsPerCta - 1) / kRowsPerCta;
  const dim3 rows(d.nblk, members);
  const dim3 w1_tiles((F + kTile - 1) / kTile, (H + kTile - 1) / kTile,
                      members);
  const dim3 tail((d.T + kThreads - 1) / kThreads, members);
  if (k == 0)
    cudaMemsetAsync(delta, 0, sizeof(float) * (size_t)members * d.P, st);
  for (int s = 0; s < k; ++s) {
    row_pass<S, R><<<rows, kThreads, 0, st>>>(mem, w, s == 0, d, hid, dh,
                                              partials);
    dw1_pass<S><<<w1_tiles, kThreads, 0, st>>>(mem, w, s == 0, s == k - 1,
                                               d, dh, lr, delta);
    tail_apply<typename S::Mem><<<tail, kThreads, 0, st>>>(
        mem, w, s == 0, s == k - 1, d, partials, lr, delta);
  }
  loss_pass<S, R><<<rows, kThreads, 0, st>>>(mem, w, k == 0, d, hid,
                                             loss_partials);
  loss_reduce<typename S::Mem><<<dim3(1, members), kThreads, 0, st>>>(
      mem, d, loss_partials, loss);
  return (int)cudaGetLastError();
}

// The R = C+1 instance of a storage form's passes.
template <class S>
int dispatch(const typename S::Mem& mem, int members, float* delta,
             float* loss, float* w, float* hid, float* dh, float* partials,
             float* loss_partials, int B, int F, int H, int R, int k,
             float lr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KPS_CASE(n)                                                        \
  case n:                                                                  \
    return run<S, n>(mem, members, delta, loss, w, hid, dh, partials,      \
                     loss_partials, B, F, H, k, lr, st);
  switch (R) {
    KPS_CASE(2) KPS_CASE(3) KPS_CASE(4) KPS_CASE(5) KPS_CASE(6) KPS_CASE(7)
    KPS_CASE(8) KPS_CASE(9) KPS_CASE(10) KPS_CASE(11) KPS_CASE(12)
    KPS_CASE(13) KPS_CASE(14) KPS_CASE(15) KPS_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KPS_CASE
}

bool bad_shape(int B, int F, int H, int k, int members) {
  return B < 1 || F < 1 || H < 1 || k < 0 || members < 1 ||
         members > kMaxMembers;
}

}  // namespace

extern "C" {

// One call runs `members` independent updates (1 for K4).  thetas, xs, ys
// and masks are host arrays of `members` device pointers ([P], [B, F],
// [B], [B] each).  Outputs: delta [members, P], loss [members].  Scratch
// the caller allocates: w [members, P], hid and dh [members, B, H],
// partials [members, ceil(B/32), T], loss_partials [members, ceil(B/32)],
// with T = H + R*H + R and P = H*F + T.  Returns cudaGetLastError() after
// the launches.
int kps_mlp_local_update(const void* const* thetas, const void* const* xs,
                         const void* const* ys, const void* const* masks,
                         int members, float* delta, float* loss, float* w,
                         float* hid, float* dh, float* partials,
                         float* loss_partials, int B, int F, int H, int R,
                         int k, float lr, void* stream) {
  if (bad_shape(B, F, H, k, members)) return (int)cudaErrorInvalidValue;
  Members mem;
  fill_members(mem, thetas, xs, ys, masks, members);
  return dispatch<SlabF32>(mem, members, delta, loss, w, hid, dh, partials,
                           loss_partials, B, F, H, R, k, lr, stream);
}

// K5, bf16 slab: as kps_mlp_local_update, with xs pointing at bf16 [B, F].
int kps_mlp_local_update_bf16(const void* const* thetas,
                              const void* const* xs, const void* const* ys,
                              const void* const* masks, int members,
                              float* delta, float* loss, float* w,
                              float* hid, float* dh, float* partials,
                              float* loss_partials, int B, int F, int H,
                              int R, int k, float lr, void* stream) {
  if (bad_shape(B, F, H, k, members)) return (int)cudaErrorInvalidValue;
  MembersBf16 mem;
  fill_members(mem, thetas, xs, ys, masks, members);
  return dispatch<SlabBf16>(mem, members, delta, loss, w, hid, dh,
                            partials, loss_partials, B, F, H, R, k, lr,
                            stream);
}

// K5, int8 slab: xs point at int8 q [B, F] and scales at f32 [B] (one
// scale per row).
int kps_mlp_local_update_q(const void* const* thetas, const void* const* xs,
                           const void* const* ys, const void* const* masks,
                           const void* const* scales, int members,
                           float* delta, float* loss, float* w, float* hid,
                           float* dh, float* partials, float* loss_partials,
                           int B, int F, int H, int R, int k, float lr,
                           void* stream) {
  if (bad_shape(B, F, H, k, members)) return (int)cudaErrorInvalidValue;
  MembersQ mem;
  fill_members(mem, thetas, xs, ys, masks, members);
  for (int i = 0; i < kMaxMembers; ++i)
    mem.scale[i] = i < members ? static_cast<const float*>(scales[i])
                               : nullptr;
  return dispatch<SlabQ>(mem, members, delta, loss, w, hid, dh, partials,
                         loss_partials, B, F, H, R, k, lr, stream);
}

int kps_mlp_rows_per_cta() { return kRowsPerCta; }
int kps_mlp_max_rows() { return kMaxRows; }
int kps_mlp_max_members() { return kMaxMembers; }

}  // extern "C"
