// K4, K6 and K5: the fused k-step local update of the one-hidden-layer MLP,
// for Hopper (sm_90a), for one worker (K4) or a gang of workers (K6) in one
// call, with x stored in f32 (K4, K6) or in bf16 or int8 (K5).
//
// Replaces, in kafka_ps_tpu/ops/fused_update.py: _mlp_kernel (:248, the
// Pallas TPU kernel behind mlp_local_update) and its grid over gang members,
// mlp_local_update_batched (:939); and _mlp_stream_kernel (:719, bf16) and
// _mlp_stream_kernel_q (:725, int8), both bodies of _mlp_stream_core
// (:637), the TPU's batch-tiled version for oversize and bf16 / int8 slabs.
// The function:
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
// with R = C+1 classes exactly, any H and any B, denom = max(sum(mask), 1),
// and row_valid = 1 for a label in [0, R), else 0: a row with an
// out-of-range label gets zero gradient (jax.grad of the one-hot
// cross-entropy) and adds zero NLL.
//
// What bounds it.  At B=1024, F=1024, H=128, R=6, k=2 the work is
// (4k+2)*B*F*H + (6k+2)*B*H*R = 1.353 GFLOP per member, 1.342 of it in the
// five B*F*H products (pre at each step and at the end, dW1 at each step).
// At the TF32 tensor-core peak (495 TFLOP/s dense) that is 2.7 us, against
// 5.3 MB of inputs and outputs (1.6 us at 3.35 TB/s): the bound is set by
// operations.  The split below runs each product as three tensor-core
// products (f32) or two (bf16, int8), so a call reaches at most a third (a
// half) of that bound.  As built the passes are held by neither, but by
// what the small output tiles cost.  At 32 x 32 output tiles (so that one
// member fills 128 SMs) every CTA stages its rows of both operands, so a
// tensor pass moves ~35 MB from L2 into the SMs for 4-5 MB of distinct
// data, and runs one CTA of 8 warps per SM, whose chunk barriers and
// copy instructions are exposed.  On the H100 a gang of 4 members (4x the
// bytes, two CTAs per SM) takes ~3x a single member's time per pass, and
// int8 x (fewer bytes than bf16, the same terms) is no faster than bf16:
// neither the L2 traffic nor the latency alone accounts for the time.
// More work per CTA (larger tiles with split-K partials, or clusters
// sharing tiles) is the next step; PERF.md holds the times.
//
// The products: mma.sync m16n8k8 TF32 at f32 accuracy.  TF32 keeps 11
// significant bits, so an f32 operand a is split into hi = tf32(a)
// (rounded as cvt.rna) and lo = tf32(a - hi) (a - hi is exact):
// |a - hi| <= 2^-11 |a| and |a - hi - lo| <= 2^-22 |a|.  A product is
// hi*hi + (lo*hi + hi*lo), the lo*lo term (at most 2^-22 of the product)
// dropped.  The tensor cores' f32 accumulation truncates, so each k8
// step's hi*hi sums start from zero and are added to the running sum with
// round-to-nearest f32 adds (one accumulator over all of K flipped a relu
// gate at |pre| = 8e-8 on the card); the small terms accumulate in a
// register set of their own, added at the end.  A stored slab needs fewer
// terms: a bf16 value (8 significant bits) and an int8 q (7 bits) are
// exact in TF32, so x enters with one term and each product is two:
// x*W_hi + x*W_lo for pre, dh_hi*x + dh_lo*x for dW1.  For int8 the
// kernel multiplies q itself and applies the row scale s_b to the row
// of pre (pre = s_b * (q . W1) + b1) and to the row of dh before dW1
// (sum_b (dh[b] * s_b) q[b]), where the plain version decodes fl(q * s)
// first: a relative difference of at most 2^-24 per element.  On the H100
// every form (K4, K5, K6) is within 4e-7 (max abs) of the plain version at
// the main path's shape, inside the f32 kernels' tolerance (rtol 1e-4,
// atol 1e-5); one TF32 term alone is not (tests/test_torch_mlp_split.py
// models both).
//
// The passes, 3k+3 launches, no atomics, every sum in a fixed order:
//
//   per step s:  hidden_pass (pre, hid = relu(pre) for a 32 x 32 tile of
//                             [B, H] per CTA: 128 CTAs at B=1024, H=128)
//                row_pass    (8 rows per CTA, a warp per row: logits,
//                             log-softmax, g, dh; then the CTA's partials
//                             of db1 | dW2 | db2, rows in order)
//                update_pass (dW1 for a 32 x 32 tile of [H, F] per CTA over
//                             all B rows, W1 -= lr * dW1 in place; one more
//                             row of CTAs sums the row passes' partials in
//                             CTA order and applies b1 | W2 | b2)
//   then:        hidden_pass at W_k, row_pass (per-CTA masked NLL),
//                loss_reduce (one CTA per member: fixed-order sum / denom)
//
// The tensor passes stage their two operand tiles through shared memory
// with cp.async, double-buffered, in chunks 128 deep along K (F for
// hidden_pass, B for update_pass).  A tile row is copied as the 16-byte
// chunks that cover it, aligned down, with the row's offset in its first
// chunk kept beside the tile (slab_x.cuh's stage_rows, which
// local_update.cu shares): so any F (F=33 f32, bf16 and int8 rows are
// not 16-byte aligned), any storage form and any base address load the
// same way, and a chunk past the end of a row or the matrix is zero-filled
// or masked where a fragment is read.  Eight warps per CTA, in groups of
// two that each cover the 32 x 32 tile with 32 x 16 warp tiles (2 x 2 mma
// tiles of 16 x 8) and take every fourth k8 step of a chunk; the groups'
// sums are added in a fixed order at the end.  The depth, the groups and
// the two stages were chosen on the card among 32-256 deep, 2-8 stages and
// warp tiles of 1-8 mma tiles: deeper chunks cut the per-chunk barriers
// and copy instructions, and 256 threads leave room for several CTAs per
// SM when a gang's members fill more than one wave.
// hid and dh live in global scratch [B, Hp] (Hp = H rounded up to 4, L2-
// resident at these sizes), so H has no shared-memory cap.
//
// Gang members: the member is the last grid axis of every pass and Members
// holds per-member base pointers (slab_x.cuh), so K4 is this kernel with
// one member and a K6 member is bitwise equal to a K4 call by
// construction; no CTA's work depends on another member, and two launches
// on equal inputs give equal bits.
//
// Built by kafka_ps_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry points below (ctypes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slab_x.cuh"

namespace {

using namespace kps;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kWarps;    // rows of a row_pass CTA, a warp per row
constexpr int kMaxRows = 16;     // classes + 1; the wrapper refuses more
constexpr int kTile = 32;        // edge of a tensor pass's output tile
// A tensor pass's CTA: kTcThreads threads, chunks kDepth deep along the
// product's K, kStages chunks in shared memory (cp.async double
// buffering).
constexpr int kTcThreads = 256;
constexpr int kDepth = 128;
constexpr int kStages = 2;

// The warp tiles of a tensor pass.  A CTA's 32 x 32 output tile is cut
// into warp tiles of kMT x kNT mma tiles (16 x 8 each); the kWG warps that
// cover it form a k-group, and the kGroups groups take interleaved k8
// steps of every chunk.  A warp's split operands feed kMT * kNT mma per
// term, so larger warp tiles split fewer elements per product.
constexpr int kMT = 2, kNT = 2;
constexpr int kWN = kTile / (8 * kNT);          // warp tiles across
constexpr int kWG = (kTile / (16 * kMT)) * kWN; // warps per k-group
constexpr int kGroups = kTcThreads / 32 / kWG;
constexpr int kSteps = kDepth / 8 / kGroups;
constexpr int kFrag = kMT * kNT * 4;            // accumulators per lane
static_assert(kSteps >= 1 && kDepth % (8 * kGroups) == 0, "k split");

// Shapes of one call: T = H + R*H + R is the length of the b1|W2|b2 tail,
// P = H*F + T the length of the flat parameter vector, Hp the row stride
// of the hid and dh scratch, nblk the row_pass CTAs per member.
struct Dims {
  int B, F, H, Hp, T, P, nblk;
};

// -- the tensor-core arithmetic ---------------------------------------------

// tf32(a) as cvt.rna.tf32.f32 rounds it (the 13 low bits off, ties away
// from zero), in two full-rate integer operations instead of a conversion
__device__ __forceinline__ uint32_t tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// a = hi + lo to 22 bits, both TF32
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32(a);
  lo = tf32(a - __uint_as_float(hi));
}

// c += a * b, one m16n8k8 TF32 tile with f32 accumulation
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// -- cp.async ---------------------------------------------------------------

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 2) : "memory");
}

// A ROWS x COLS tile at STRIDE bytes per row, staged by slab_x.cuh's
// stage_rows (the aligned-down 16-byte chunks of each row, its offset in
// mis).
template <int ES, int STRIDE, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          unsigned char* mis,
                                          const void* src, size_t ld,
                                          int r0, int nrows, int c0,
                                          int ncols) {
  static_assert(stage_chunks(COLS * ES) * 16 <= STRIDE && STRIDE % 16 == 0,
                "tile stride");
  stage_rows(dst, mis, src, ld, ES, STRIDE, ROWS, COLS, r0, nrows, c0,
             ncols, threadIdx.x, kTcThreads);
}

__device__ __forceinline__ float f32_at(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}

// How a storage form enters the products: the value of one stored element,
// whether it is exact in TF32 (one term), and whether rows carry a scale.
template <class S>
struct Tc;

template <>
struct Tc<SlabF32> {
  static constexpr bool kExact = false, kScaled = false;
  static __device__ __forceinline__ float val(const unsigned char* p) {
    return f32_at(p);
  }
};

template <>
struct Tc<SlabBf16> {
  static constexpr bool kExact = true, kScaled = false;
  static __device__ __forceinline__ float val(const unsigned char* p) {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  }
};

template <>
struct Tc<SlabQ> {
  static constexpr bool kExact = true, kScaled = true;
  static __device__ __forceinline__ float val(const unsigned char* p) {
    // float(q) exactly: q added to the bits of 1.5 * 2^23, whose ulp is 1
    const int q = *reinterpret_cast<const signed char*>(p);
    return __int_as_float(0x4B400000 + q) - 12582912.f;
  }
};

// Tile strides (bytes per tile row): a tile read along its rows (the
// hidden pass's, kDepth columns) takes its row length plus the 16 bytes of
// the aligned-down chunk; a tile read down its columns (the update pass's,
// 32 columns) is padded so that a warp's fragment reads of f32 rows fall
// in distinct shared-memory banks (8 words apart).
__host__ __device__ constexpr int row_stride(int es) {
  return kDepth * es + 16;
}
__host__ __device__ constexpr int col_stride(int es) {
  return es == 4 ? 160 : kTile * es + 16;
}

// Dynamic shared memory of the two tensor passes for a storage form: the
// kStages tile stages (the tiles, then the tiles' row offsets, and for
// update_pass the chunk's int8 row scales), then the k-groups' sums.
// Above the 48 KiB default, so run() raises each kernel's limit.
template <class S>
struct Geo {
  static constexpr int ES = sizeof(typename S::T);
  static constexpr int kA = kTile * row_stride(ES), kW = kTile * row_stride(4);
  static constexpr int kHidStage = kA + kW + 2 * kTile;
  static constexpr int kD = kDepth * col_stride(4);
  static constexpr int kX = kDepth * col_stride(ES);
  static constexpr int kUpdStage = kD + kX + kDepth * 4 + 2 * kDepth;
  static constexpr int kRed = (kGroups - 1) * 32 * kWG * kFrag * 4;
  static constexpr int kHidSmem = kStages * kHidStage + kRed;
  static constexpr int kUpdSmem = kStages * kUpdStage + kRed;
  static_assert(kHidStage % 16 == 0 && kUpdStage % 16 == 0, "stage align");
};

// The warp's place in a tensor pass: k-group, the warp tile's first row
// and column in the CTA's tile, and the lane's fragment coordinates
// (g = lane / 4, t = lane % 4).
struct Lane {
  int kg, m0, n0, g, t;
  __device__ Lane() {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    kg = w / kWG;
    m0 = (w % kWG) / kWN * 16 * kMT;
    n0 = (w % kWG) % kWN * 8 * kNT;
    g = lane / 4;
    t = lane % 4;
  }
};

using Acc = float[kMT][kNT][4];

// big += one k8 step's hi*hi sums: each step's mma accumulate into zeroed
// registers and reach the running sum through round-to-nearest f32 adds,
// so the tensor cores' truncating accumulation spans 8 products, not all
// of K.  (The small terms, 2^-11 of the big ones, accumulate in place.)
__device__ __forceinline__ void promote(Acc& big, Acc& cb) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        big[i][j][c] = __fadd_rn(big[i][j][c], cb[i][j][c]);
        cb[i][j][c] = 0.f;
      }
}

// The k-groups' sums of the CTA's tile, added in a fixed order (group 0's
// + group 1's + ...) into group 0's `big`; big and small terms first.
// Returns true on the threads (group 0) that hold the tile.
__device__ __forceinline__ bool reduce_groups(const Lane& L, Acc& big,
                                              const Acc& small, float* red) {
  float acc[kFrag];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[(i * kNT + j) * 4 + c] = big[i][j][c] + small[i][j][c];
  const int me = threadIdx.x % (32 * kWG);
  if (L.kg > 0) {
    float* mine = red + ((L.kg - 1) * 32 * kWG + me) * kFrag;
#pragma unroll
    for (int q = 0; q < kFrag; ++q) mine[q] = acc[q];
  }
  __syncthreads();
  if (L.kg > 0) return false;
  for (int p = 1; p < kGroups; ++p) {
    const float* theirs = red + ((p - 1) * 32 * kWG + me) * kFrag;
#pragma unroll
    for (int q = 0; q < kFrag; ++q) acc[q] += theirs[q];
  }
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) big[i][j][c] = acc[(i * kNT + j) * 4 + c];
  return true;
}

template <class Mem>
__device__ __forceinline__ const float* member_w(const Mem& mem,
                                                 const float* w_scratch,
                                                 int first, int m, int P) {
  return first ? mem.theta[m] : w_scratch + (size_t)m * P;
}

// -- hidden_pass: hid = relu(x @ W1.T + b1), a 32 x 32 tile of [B, H] -------

template <class S>
__global__ void __launch_bounds__(kTcThreads)
hidden_pass(typename S::Mem mem, const float* w_scratch, int from_theta,
            Dims d, float* __restrict__ hid_all) {
  using X = Tc<S>;
  using G = Geo<S>;
  constexpr int ES = G::ES, kSA = row_stride(ES), kSW = row_stride(4);
  extern __shared__ __align__(16) unsigned char sm[];
  float* red = reinterpret_cast<float*>(sm + kStages * G::kHidStage);
  const int m = blockIdx.z;
  const int b0 = blockIdx.x * kTile, h0 = blockIdx.y * kTile;
  const void* x = mem.x[m];
  const float* w1 = member_w(mem, w_scratch, from_theta, m, d.P);
  const int nk = (d.F + kDepth - 1) / kDepth;
  auto load = [&](int kc) {
    unsigned char* st = sm + (kc % kStages) * G::kHidStage;
    unsigned char* mis = st + G::kA + G::kW;
    load_tile<ES, kSA, kTile, kDepth>(st, mis, x, (size_t)d.F * ES, b0, d.B,
                                      kc * kDepth, d.F);
    load_tile<4, kSW, kTile, kDepth>(st + G::kA, mis + kTile, w1,
                                     (size_t)d.F * 4, h0, d.H, kc * kDepth,
                                     d.F);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
  const Lane L;
  Acc big = {}, small = {}, cb = {};
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait();
    __syncthreads();
    if (kc + kStages - 1 < nk) load(kc + kStages - 1);
    cp_commit();
    const unsigned char* st = sm + (kc % kStages) * G::kHidStage;
    const unsigned char* ma = st + G::kA + G::kW;
    const unsigned char* pa[kMT][2];        // A rows (batch), +0 and +8
    const unsigned char* pb[kNT];           // B rows (hidden units)
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = L.m0 + i * 16 + h * 8 + L.g;
        pa[i][h] = st + r * kSA + ma[r];
      }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int r = L.n0 + j * 8 + L.g;
      pb[j] = st + G::kA + r * kSW + ma[kTile + r];
    }
    const int lim = d.F - kc * kDepth;     // valid columns of the chunk
    // a full chunk reads no column mask
    auto chunk = [&](auto full) {
#pragma unroll
      for (int s2 = 0; s2 < kSteps; ++s2) {
        const int c0 = (s2 * kGroups + L.kg) * 8 + L.t, c1 = c0 + 4;
        const bool v0 = decltype(full)::value || c0 < lim;
        const bool v1 = decltype(full)::value || c1 < lim;
        uint32_t ahi[kMT][4], alo[kMT][4];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const float a[4] = {v0 ? X::val(pa[i][0] + c0 * ES) : 0.f,
                              v0 ? X::val(pa[i][1] + c0 * ES) : 0.f,
                              v1 ? X::val(pa[i][0] + c1 * ES) : 0.f,
                              v1 ? X::val(pa[i][1] + c1 * ES) : 0.f};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (X::kExact)
              ahi[i][q] = __float_as_uint(a[q]);
            else
              split(a[q], ahi[i][q], alo[i][q]);
          }
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t bhi[2], blo[2];
          split(v0 ? f32_at(pb[j] + c0 * 4) : 0.f, bhi[0], blo[0]);
          split(v1 ? f32_at(pb[j] + c1 * 4) : 0.f, bhi[1], blo[1]);
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            if (!X::kExact) mma(small[i][j], alo[i], bhi);
            mma(small[i][j], ahi[i], blo);
            mma(cb[i][j], ahi[i], bhi);
          }
        }
        promote(big, cb);
      }
    };
    if (lim >= kDepth)
      chunk(std::true_type{});
    else
      chunk(std::false_type{});
  }
  if (!reduce_groups(L, big, small, red)) return;
  const float* b1 = w1 + (size_t)d.H * d.F;
  const float* sc = S::scales(mem, m);
  float* hid = hid_all + (size_t)m * d.B * d.Hp;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int b = b0 + L.m0 + i * 16 + h2 * 8 + L.g;
      if (b >= d.B) continue;
      const float s = X::kScaled ? S::scale(sc, b) : 1.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int h = h0 + L.n0 + j * 8 + 2 * L.t + c;
          if (h >= d.H) continue;
          float pre = big[i][j][2 * h2 + c];
          if (X::kScaled) pre = __fmul_rn(pre, s);
          hid[(size_t)b * d.Hp + h] = fmaxf(__fadd_rn(pre, b1[h]), 0.f);
        }
    }
}

// -- row_pass: the per-row softmax and backward, or the per-row NLL ----------

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
  const float d = red[0];
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

// kRows rows per CTA, a warp per row.  LOSS = false: g and dh (to global)
// and the CTA's partials of db1 | dW2 | db2, rows in index order.  LOSS =
// true: the CTA's sum of masked NLL, rows in order.
template <class Mem, int R, bool LOSS>
__global__ void __launch_bounds__(kThreads)
row_pass(Mem mem, const float* w_scratch, int from_theta, Dims d,
         const float* __restrict__ hid_all, float* __restrict__ dh_all,
         float* __restrict__ partials, float* __restrict__ loss_partials) {
  __shared__ float red[kThreads];
  __shared__ float g_s[kRows][R];
  __shared__ float nll_s[kRows];
  const int m = blockIdx.y;
  const int H = d.H;
  const int* __restrict__ y = mem.y[m];
  const float* __restrict__ mask = mem.mask[m];
  const float* w1 = member_w(mem, w_scratch, from_theta, m, d.P);
  const float* w2 = w1 + (size_t)H * d.F + H;
  const float* b2 = w2 + R * H;
  const float* hid = hid_all + (size_t)m * d.B * d.Hp;
  const float denom = LOSS ? 1.f : block_denom(mask, d.B, red);
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, d.B - row0);
  const int i = threadIdx.x / 32, lane = threadIdx.x % 32;
  float g[R];
#pragma unroll
  for (int r = 0; r < R; ++r) g[r] = 0.f;
  float nll = 0.f;
  if (i < nrows) {
    const int row = row0 + i;
    const float* hr = hid + (size_t)row * d.Hp;
    float l[R];
    hidden_logits<R>(hr, w2, b2, H, lane, l);
    log_softmax<R>(l);
    const int yv = y[row];
    if (LOSS) {
      float dot = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) dot += l[r] * ((yv == r) ? 1.f : 0.f);
      nll = -dot * mask[row];
    } else {
      const float valid = (yv >= 0 && yv < R) ? 1.f : 0.f;
      const float scale = mask[row] * valid / denom;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float onehot = (yv == r) ? 1.f : 0.f;
        g[r] = (expf(l[r]) - onehot) * scale;
      }
      float* dh = dh_all + (size_t)m * d.B * d.Hp + (size_t)row * d.Hp;
      for (int h = lane; h < H; h += 32) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) s = fmaf(g[r], w2[r * H + h], s);
        dh[h] = hr[h] > 0.f ? s : 0.f;
      }
    }
  }
  if (lane == 0) {
    nll_s[i] = nll;
#pragma unroll
    for (int r = 0; r < R; ++r) g_s[i][r] = g[r];
  }
  __syncthreads();
  if (LOSS) {
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int r = 0; r < nrows; ++r) s += nll_s[r];
      loss_partials[(size_t)m * d.nblk + blockIdx.x] = s;
    }
    return;
  }
  const float* dh = dh_all + (size_t)m * d.B * d.Hp;
  float* out = partials + ((size_t)m * d.nblk + blockIdx.x) * d.T;
  for (int p = threadIdx.x; p < d.T; p += kThreads) {
    float s = 0.f;
    if (p < H) {
      for (int r = 0; r < nrows; ++r) s += dh[(size_t)(row0 + r) * d.Hp + p];
    } else if (p < H + R * H) {
      const int q = p - H, c = q / H, h = q % H;
      for (int r = 0; r < nrows; ++r)
        s = fmaf(g_s[r][c], hid[(size_t)(row0 + r) * d.Hp + h], s);
    } else {
      const int c = p - H - R * H;
      for (int r = 0; r < nrows; ++r) s += g_s[r][c];
    }
    out[p] = s;
  }
}

// -- update_pass: W1 -= lr * dh.T @ x per 32 x 32 tile; b1|W2|b2 -------------

// blockIdx.y < ceil(H/32): the dW1 tile (h0, f0) over all B rows in
// index order, then W1 -= lr * dW1 (each element read and written by one
// thread), and on the last step delta = W1_k - W1_0.  blockIdx.y =
// ceil(H/32): b1 | W2 | b2 -= lr * (sum of the row passes' partials, in
// CTA order).
template <class S>
__global__ void __launch_bounds__(kTcThreads)
update_pass(typename S::Mem mem, float* w_scratch, int first, int last,
            Dims d, const float* __restrict__ dh_all,
            const float* __restrict__ partials, float lr,
            float* __restrict__ delta) {
  using X = Tc<S>;
  using G = Geo<S>;
  constexpr int ES = G::ES, kD = G::kD, kX = G::kX, kStage = G::kUpdStage;
  constexpr int kSD = col_stride(4), kSX = col_stride(ES);
  extern __shared__ __align__(16) unsigned char sm[];
  float* red = reinterpret_cast<float*>(sm + kStages * kStage);
  const int m = blockIdx.z;
  const float* theta = mem.theta[m];
  const float* w_in = member_w(mem, w_scratch, first, m, d.P);
  float* w_out = w_scratch + (size_t)m * d.P;
  if (blockIdx.y == (d.H + kTile - 1) / kTile) {
    const float* pm = partials + (size_t)m * d.nblk * d.T;
    for (int p = blockIdx.x * kTcThreads + threadIdx.x; p < d.T;
         p += gridDim.x * kTcThreads) {
      float s = 0.f;
      for (int c = 0; c < d.nblk; ++c) s += pm[(size_t)c * d.T + p];
      const size_t off = (size_t)d.H * d.F + p;
      const float wn = __fsub_rn(w_in[off], __fmul_rn(lr, s));
      w_out[off] = wn;
      if (last) delta[(size_t)m * d.P + off] = __fsub_rn(wn, theta[off]);
    }
    return;
  }
  const int f0 = blockIdx.x * kTile, h0 = blockIdx.y * kTile;
  const void* x = mem.x[m];
  const float* sc = S::scales(mem, m);
  const float* dh = dh_all + (size_t)m * d.B * d.Hp;
  const int nk = (d.B + kDepth - 1) / kDepth;
  auto load = [&](int kc) {
    unsigned char* st = sm + (kc % kStages) * kStage;
    unsigned char* mis = st + kD + kX + kDepth * 4;
    load_tile<4, kSD, kDepth, kTile>(st, mis, dh, (size_t)d.Hp * 4,
                                     kc * kDepth, d.B, h0, d.H);
    load_tile<ES, kSX, kDepth, kTile>(st + kD, mis + kDepth, x,
                                      (size_t)d.F * ES, kc * kDepth, d.B, f0,
                                      d.F);
    if (X::kScaled && threadIdx.x < kDepth) {
      const int b = kc * kDepth + threadIdx.x;
      cp_async4(st + kD + kX + threadIdx.x * 4, b < d.B ? sc + b : sc,
                b < d.B ? 4 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
  const Lane L;
  int ma[kMT][2];                          // A rows (h) of the warp tile
  bool hv[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ma[i][h] = L.m0 + i * 16 + h * 8 + L.g;
      hv[i][h] = h0 + ma[i][h] < d.H;
    }
  int nb[kNT];                             // B columns (f) of the n-tiles
  bool fv[kNT];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    nb[j] = L.n0 + j * 8 + L.g;
    fv[j] = f0 + nb[j] < d.F;
  }
  Acc big = {}, small = {}, cb = {};
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait();
    __syncthreads();
    if (kc + kStages - 1 < nk) load(kc + kStages - 1);
    cp_commit();
    const unsigned char* st = sm + (kc % kStages) * kStage;
    const float* ss = reinterpret_cast<const float*>(st + kD + kX);
    const unsigned char* mis = st + kD + kX + kDepth * 4;
#pragma unroll
    for (int s2 = 0; s2 < kSteps; ++s2) {
      const int r0 = (s2 * kGroups + L.kg) * 8 + L.t, r1 = r0 + 4;  // b
      const unsigned char* q0 = st + r0 * kSD + mis[r0];
      const unsigned char* q1 = st + r1 * kSD + mis[r1];
      uint32_t ahi[kMT][4], alo[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        float a[4] = {hv[i][0] ? f32_at(q0 + ma[i][0] * 4) : 0.f,
                      hv[i][1] ? f32_at(q0 + ma[i][1] * 4) : 0.f,
                      hv[i][0] ? f32_at(q1 + ma[i][0] * 4) : 0.f,
                      hv[i][1] ? f32_at(q1 + ma[i][1] * 4) : 0.f};
        if (X::kScaled) {
          a[0] = __fmul_rn(a[0], ss[r0]);
          a[1] = __fmul_rn(a[1], ss[r0]);
          a[2] = __fmul_rn(a[2], ss[r1]);
          a[3] = __fmul_rn(a[3], ss[r1]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) split(a[q], ahi[i][q], alo[i][q]);
      }
      const unsigned char* x0 = st + kD + r0 * kSX + mis[kDepth + r0];
      const unsigned char* x1 = st + kD + r1 * kSX + mis[kDepth + r1];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float b[2] = {fv[j] ? X::val(x0 + nb[j] * ES) : 0.f,
                            fv[j] ? X::val(x1 + nb[j] * ES) : 0.f};
        uint32_t bhi[2], blo[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (X::kExact)
            bhi[q] = __float_as_uint(b[q]);
          else
            split(b[q], bhi[q], blo[q]);
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          mma(small[i][j], alo[i], bhi);
          if (!X::kExact) mma(small[i][j], ahi[i], blo);
          mma(cb[i][j], ahi[i], bhi);
        }
      }
      promote(big, cb);
    }
  }
  if (!reduce_groups(L, big, small, red)) return;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int h = h0 + ma[i][h2];
      if (h >= d.H) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int f = f0 + L.n0 + j * 8 + 2 * L.t + c;
          if (f >= d.F) continue;
          const size_t p = (size_t)h * d.F + f;
          // no contraction into an FMA: the same two roundings as w - lr * g
          const float wn =
              __fsub_rn(w_in[p], __fmul_rn(lr, big[i][j][2 * h2 + c]));
          w_out[p] = wn;
          if (last) delta[(size_t)m * d.P + p] = __fsub_rn(wn, theta[p]);
        }
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

Dims dims(int B, int F, int H, int R) {
  Dims d;
  d.B = B;
  d.F = F;
  d.H = H;
  d.Hp = (H + 3) / 4 * 4;
  d.T = H + R * H + R;
  d.P = H * F + d.T;
  d.nblk = (B + kRows - 1) / kRows;
  return d;
}

template <class S, int R>
int run(const typename S::Mem& mem, int members, float* delta, float* loss,
        float* w, float* hid, float* dh, float* partials,
        float* loss_partials, int B, int F, int H, int k, float lr,
        cudaStream_t st) {
  using Mem = typename S::Mem;
  const Dims d = dims(B, F, H, R);
  const int th = (H + kTile - 1) / kTile;
  const dim3 hidden((B + kTile - 1) / kTile, th, members);
  const dim3 rows(d.nblk, members);
  const dim3 update((F + kTile - 1) / kTile, th + 1, members);
  int err = (int)cudaFuncSetAttribute(
      hidden_pass<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Geo<S>::kHidSmem);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(
        update_pass<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Geo<S>::kUpdSmem);
  if (err != 0) return err;
  if (k == 0)
    cudaMemsetAsync(delta, 0, sizeof(float) * (size_t)members * d.P, st);
  constexpr int kHid = Geo<S>::kHidSmem, kUpd = Geo<S>::kUpdSmem;
  for (int s = 0; s < k; ++s) {
    hidden_pass<S><<<hidden, kTcThreads, kHid, st>>>(mem, w, s == 0, d, hid);
    row_pass<Mem, R, false><<<rows, kThreads, 0, st>>>(
        mem, w, s == 0, d, hid, dh, partials, nullptr);
    update_pass<S><<<update, kTcThreads, kUpd, st>>>(
        mem, w, s == 0, s == k - 1, d, dh, partials, lr, delta);
  }
  hidden_pass<S><<<hidden, kTcThreads, kHid, st>>>(mem, w, k == 0, d, hid);
  row_pass<Mem, R, true><<<rows, kThreads, 0, st>>>(
      mem, w, k == 0, d, hid, nullptr, nullptr, loss_partials);
  loss_reduce<Mem><<<dim3(1, members), kThreads, 0, st>>>(mem, d,
                                                          loss_partials, loss);
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
// the caller allocates, of the sizes kps_mlp_scratch gives: w, hid, dh,
// partials, loss_partials.  Returns cudaGetLastError() after the launches.
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

// The float counts of the five scratch buffers of a call on `members`
// members: w, hid, dh, partials, loss_partials, into sizes[0..4].
void kps_mlp_scratch(int B, int F, int H, int R, int members,
                     long long* sizes) {
  const Dims d = dims(B, F, H, R);
  const long long n = members;
  sizes[0] = n * d.P;
  sizes[1] = n * d.B * d.Hp;
  sizes[2] = n * d.B * d.Hp;
  sizes[3] = n * d.nblk * d.T;
  sizes[4] = n * d.nblk;
}

// The dynamic shared memory per CTA of the two tensor passes, in bytes
// (ptxas reports only the static part): hidden_pass and update_pass for
// f32, bf16 and int8 x, into bytes[0..5].
void kps_mlp_smem(int* bytes) {
  bytes[0] = Geo<SlabF32>::kHidSmem;
  bytes[1] = Geo<SlabF32>::kUpdSmem;
  bytes[2] = Geo<SlabBf16>::kHidSmem;
  bytes[3] = Geo<SlabBf16>::kUpdSmem;
  bytes[4] = Geo<SlabQ>::kHidSmem;
  bytes[5] = Geo<SlabQ>::kUpdSmem;
}

int kps_mlp_max_rows() { return kMaxRows; }
int kps_mlp_max_members() { return kMaxMembers; }

}  // extern "C"
