// K1: the fused k-step logistic-regression local update, for Hopper (sm_90a).
//
// Replaces kafka_ps_tpu/ops/fused_update.py:_kernel (the Pallas TPU kernel
// behind fused_update.local_update).  Same function, not the same layout:
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
// ~ 63 MFLOP of f32, ~0.94 us at the H100 SXM's 67 TFLOP/s (no tensor
// cores: scalar f32 FMA, so TF32 never arises).  x alone is 4 MiB and must
// be read at least once: ~1.3 us at 3.35 TB/s.  So the bound is about a
// microsecond, set by bytes.
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
// 32 rows per CTA leave 32 CTAs for 132 SMs, and each warp walks its rows
// and each thread its columns serially, so the pass is latency-bound on a
// quarter of the card rather than bound by launches or bytes.  Each CTA
// recomputes denom from the mask in a fixed order (B floats), which saves
// a launch.  No atomics anywhere: every sum has a fixed order, so equal
// inputs give bitwise-equal outputs from run to run (the gang kernel K2 will
// rely on that).  A later change keeps x resident in the SMs' shared memory
// (32 KiB per CTA over 128 CTAs) and runs the k steps in one cooperative
// persistent launch with a fixed-order cross-CTA reduction.
//
// Built by kafka_ps_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry point below (ctypes).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerCta = 32;
constexpr int kMaxRows = 16;   // classes + 1; the wrapper refuses more

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

// Logits of one row, reduced across the warp; every lane gets all R.
template <int R>
__device__ __forceinline__ void row_logits(const float* __restrict__ xr,
                                           const float* __restrict__ w,
                                           int F, int lane, float* out) {
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int f = lane; f < F; f += 32) {
    const float xv = xr[f];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(xv, w[r * F + f], acc[r]);
  }
  const float* b = w + (size_t)R * F;
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = warp_sum(acc[r]) + b[r];
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

template <int R>
__global__ void __launch_bounds__(kThreads)
row_pass(const float* __restrict__ x, const int* __restrict__ y,
         const float* __restrict__ mask, const float* __restrict__ w,
         float* __restrict__ partials, int B, int F) {
  __shared__ float red[kThreads];
  __shared__ float g_s[kRowsPerCta][R];
  const float denom = block_denom(mask, B, red);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerCta;
  const int nrows = min(kRowsPerCta, B - row0);

  for (int i = warp; i < kRowsPerCta; i += kWarps) {
    float g[R];
    if (i < nrows) {
      const int row = row0 + i;
      float l[R];
      row_logits<R>(x + (size_t)row * F, w, F, lane, l);
      log_softmax<R>(l);
      const int yv = y[row];
      const float scale = mask[row] / denom;
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
  float* out = partials + (size_t)blockIdx.x * ((size_t)R * F + R);
  for (int f = threadIdx.x; f < F; f += kThreads) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int i = 0; i < nrows; ++i) {
      const float xv = x[(size_t)(row0 + i) * F + f];
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

// W_out = W_in - lr * (sum of the CTA partials, in CTA order).  W_in and
// W_out may alias: each element is read and written by one thread.  On the
// last step it also writes delta = W_k - theta.
__global__ void __launch_bounds__(kThreads)
apply_pass(const float* w_in, float* w_out,
           const float* __restrict__ partials, int nparts, int P, float lr,
           const float* __restrict__ theta, float* __restrict__ delta) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  float s = 0.f;
  for (int c = 0; c < nparts; ++c) s += partials[(size_t)c * P + p];
  // no contraction into an FMA: the same two roundings as w - lr * g
  const float wn = __fsub_rn(w_in[p], __fmul_rn(lr, s));
  w_out[p] = wn;
  if (delta != nullptr) delta[p] = __fsub_rn(wn, theta[p]);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
loss_pass(const float* __restrict__ x, const int* __restrict__ y,
          const float* __restrict__ mask, const float* __restrict__ w,
          float* __restrict__ loss_partials, int B, int F) {
  __shared__ float nll_s[kRowsPerCta];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerCta;
  const int nrows = min(kRowsPerCta, B - row0);
  for (int i = warp; i < kRowsPerCta; i += kWarps) {
    float v = 0.f;
    if (i < nrows) {
      const int row = row0 + i;
      float l[R];
      row_logits<R>(x + (size_t)row * F, w, F, lane, l);
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
    loss_partials[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
loss_reduce(const float* __restrict__ mask, int B,
            const float* __restrict__ loss_partials, int nparts,
            float* __restrict__ loss) {
  __shared__ float red[kThreads];
  const float denom = block_denom(mask, B, red);
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int c = 0; c < nparts; ++c) s += loss_partials[c];
    loss[0] = s / denom;
  }
}

template <int R>
int run(const float* theta, const float* x, const int* y, const float* mask,
        float* delta, float* loss, float* w, float* partials,
        float* loss_partials, int B, int F, int k, float lr,
        cudaStream_t st) {
  const int nblk = (B + kRowsPerCta - 1) / kRowsPerCta;
  const int P = R * F + R;
  const int ablk = (P + kThreads - 1) / kThreads;
  const float* w_cur = theta;
  if (k == 0) cudaMemsetAsync(delta, 0, sizeof(float) * (size_t)P, st);
  for (int s = 0; s < k; ++s) {
    row_pass<R><<<nblk, kThreads, 0, st>>>(x, y, mask, w_cur, partials, B, F);
    apply_pass<<<ablk, kThreads, 0, st>>>(w_cur, w, partials, nblk, P, lr,
                                          theta,
                                          s == k - 1 ? delta : nullptr);
    w_cur = w;
  }
  loss_pass<R><<<nblk, kThreads, 0, st>>>(x, y, mask, w_cur, loss_partials,
                                          B, F);
  loss_reduce<<<1, kThreads, 0, st>>>(mask, B, loss_partials, nblk, loss);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch the caller allocates: w [R*F + R], partials [ceil(B/32), R*F + R],
// loss_partials [ceil(B/32)].  Returns cudaGetLastError() after the launches.
int kps_local_update(const float* theta, const float* x, const int* y,
                     const float* mask, float* delta, float* loss, float* w,
                     float* partials, float* loss_partials, int B, int F,
                     int R, int k, float lr, void* stream) {
  if (B < 1 || F < 1 || k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KPS_CASE(n)                                                        \
  case n:                                                                  \
    return run<n>(theta, x, y, mask, delta, loss, w, partials,             \
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

int kps_rows_per_cta() { return kRowsPerCta; }
int kps_max_rows() { return kMaxRows; }

}  // extern "C"
