// K4, K6 and K5: the fused k-step local update of the one-hidden-layer MLP,
// for Hopper (sm_90a), for one worker (K4) or a gang of workers (K6) in one
// call, with x stored in f32 (K4, K6) or in bf16 or int8 (K5).
//
// Replaces, in kafka_ps_tpu/ops/fused_update.py: _mlp_kernel (:248, the
// Pallas TPU kernel behind mlp_local_update) and its grid over gang members,
// mlp_local_update_batched (:939); and _mlp_stream_kernel (:719, bf16) and
// _mlp_stream_kernel_q (:725, int8), both bodies of _mlp_stream_core
// (:637), the TPU's batch-tiled version for oversize and bf16 / int8 slabs.
// At a hidden layer too wide for VMEM (mlp_fits_in_vmem, :235, false at
// H=4096) a single TPU call streams batch tiles past a VMEM-resident weight
// set (_mlp_stream_update :732 -> _mlp_stream_kernel :719, pallas_call
// :784) and the gang falls back to XLA's vmapped update; here both take
// the wide passes below.
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
// The wide path (f32 x, H >= kWideMinH, F a multiple of 4).  At B=F=1024,
// H=4096, k=2 the work is 43.3 GFLOP per member, 42.9 of it in the five B*F*H
// products: 87 us at the TF32 peak against 38 MB of inputs and outputs (11
// us), so operations bound it, and the three-term split puts the floor at
// ~0.26 ms.  A product there is 1024 x 4096 x 1024, the shape wgmma is built
// for, while W1 alone (16.8 MB) is far beyond shared memory and fits in L2.
// So the five products run as wide_hidden_pass (pre) and wide_update_pass
// (dW1): a persistent grid (one CTA per SM, each walking its tiles of every
// member in order) of 128 x 128 output tiles, a producer warp issuing TMA
// loads of 32-deep chunks (128-byte swizzle) into a ring of stages with
// mbarriers, two consumer warpgroups each issuing wgmma m64n128k8 TF32 on 64
// rows.  wide_hidden_pass's consumers write hid themselves, behind a ring of
// three stages.  wide_update_pass's epilogue reads W1 and writes W1, its two
// split planes and (last step) delta, 16-20 bytes an element, which on the
// consumers left the tensor cores idle for about as long as the tile's
// products took.  So there each consumer warpgroup hands its finished 64 x 128
// half of dW1 to a 32 KiB slot of its own in shared memory and goes on to its
// next tile, while the producer warpgroup's other three warps (the store
// warps, idle before) finish the epilogue from the slot with the same
// roundings; the two slots leave room for a ring of two stages.  The store
// warps keep 72 registers and the consumers 216 (40 and 232 in
// wide_hidden_pass): at 40 the store warps spilled and the pass took 1.4-2x as
// long (PERF.md).  TF32 wgmma reads its operands K-major only and truncates an
// f32 operand to TF32, and no thread touches a tile on its way in, so the
// split operands live in scratch, each a hi and a lo plane, rounded where they
// are written: x (split_pass) and x.T (transpose_pass) once per call, theta's
// W1 before step 0 (split_pass) and each step's W1 by wide_update_pass's
// epilogue, dh.T by grad_cols.  Each 32-deep chunk's hi*hi sum starts from
// zero and reaches the running sum through a round-to-nearest add; the small
// terms accumulate over all of K in a register set of their own, added at the
// end (the order of the narrow passes with chunks of 32 for 8; putting the
// small terms into the chunk's sum moved a relu gate off the plain version on
// the card).  The small passes: grad_rows (4 warps a row: logits, g; or the
// NLL), grad_cols (32 columns of [B, H] per CTA over all rows: dh, dh.T, db1,
// dW2, db2 summed in a fixed order and applied in place, no per-CTA partials)
// and loss_reduce.  The tensor maps are encoded on the host at every call from
// the call's scratch and passed by value (__grid_constant__), so a CUDA graph
// that captures a call replays it on its own buffers.
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
// The narrow passes, 3k+3 launches, no atomics, every sum in a fixed
// order (the wide path's are above):
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

#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time
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
// of the hid and dh scratch, nblk the row_pass CTAs per member, Bp the row
// stride of the wide path's transposed scratch (B rounded up to 4, so that
// a row starts on 16 bytes, as TMA needs).
struct Dims {
  int B, F, H, Hp, T, P, nblk, Bp;
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

// -- the wide path: K4 and K6 at H >= kWideMinH, wgmma fed by TMA ----------

// The path of a call is a function of (F, H) and the storage form alone,
// never of the member count, so that a K6 member and a K4 call always
// take the same passes.  fused_update.py mirrors it (mlp_wide_path).
constexpr int kWideMinH = 1024;

bool wide_path(int F, int H) { return H >= kWideMinH && F % 4 == 0; }

// A wide pass's CTA: one producer warpgroup (its first thread issues the
// TMA loads) and two consumer warpgroups, each computing 64 rows of the
// CTA's kGM x kGN output tile with wgmma m64n128k8.  A chunk is kGK = 32
// f32 deep, one 128-byte row of the 128-byte swizzle per tile row; a stage
// holds the chunk's four operand tiles (A hi, A lo, B hi, B lo).
constexpr int kGM = 128, kGN = 128, kGK = 32;
constexpr int kGStages = 3;
constexpr int kGThreads = 384;
constexpr int kGOp = kGM * kGK * 4;                // one term's tile, 16 KiB
constexpr int kGStage = 4 * kGOp;
constexpr int kGSmem = kGStages * kGStage + 1024;  // + alignment slack
constexpr long long kWaitCycles = 20000000000LL;   // ~10 s: a lost barrier
static_assert(kGM == kGN, "the A and B tiles share one TMA box");
// wide_update_pass hands each consumer warpgroup's finished 64 x kGN half
// of dW1 to the producer warpgroup's other three warps (the store warps)
// through a slot of its own after a ring of kUStages chunks; they write
// W1, its split and delta while the consumers run the next tile.
constexpr int kUStages = 2;
constexpr int kHalf = (kGM / 2) * kGN;             // floats of a half tile
constexpr int kStoreWarps = 3;
constexpr int kGUSmem = kUStages * kGStage + 2 * kHalf * 4 + 1024;
// setmaxnreg: registers a thread of the producer warpgroup and of a
// consumer warpgroup keep, within the 168 x 384 the launch gives the CTA
constexpr int kGRegsP = 40, kGRegsC = 232;      // wide_hidden_pass
constexpr int kURegsP = 72, kURegsC = 216;      // wide_update_pass
static_assert(128 * kGRegsP + 256 * kGRegsC <= 168 * kGThreads &&
                  128 * kURegsP + 256 * kURegsC <= 168 * kGThreads,
              "register budget");

__device__ __forceinline__ uint32_t sh_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(sh_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          sh_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(sh_addr(bar))
               : "memory");
}

// Wait for the phase of parity `parity` to complete.  A barrier that never
// completes (a lost TMA transfer) traps after ~10 s instead of hanging the
// card: the launch then fails and the wrapper raises.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = sh_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// One box (kGK x kGM, f32) of a 4-d tensor map [members][2][rows][cols] at
// (column c0, row r0, plane, member) into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int r0, int plane, int m,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(sh_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(plane),
      "r"(m), "r"(sh_addr(bar))
      : "memory");
}

// The wgmma descriptor of a K-major operand tile in the 128-byte swizzle
// (rows of 128 bytes, groups of 8 rows 1024 bytes apart); p is a 1024-byte
// aligned tile or a k8 step (32 bytes) into it.
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  return (uint64_t)((sh_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= a * b, m64n128k8 TF32 with f32 accumulation; acc = 0 starts d
// from zero.
__device__ __forceinline__ void gmma(float (&d)[64], uint64_t a, uint64_t b,
                                     int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// Keeps the compiler from moving reads or writes of d across a wgmma
// fence, commit or wait (the tensor cores write d asynchronously).
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wide pass over the output tiles of every member.  kPre: pre = x @ W1.T
// for [B, H] (A = x split, B = W1 split, K = F), epilogue hid = relu(pre +
// b1).  kDw1: dW1 = dh.T @ x for [H, F] (A = dh.T split, B = x.T split,
// K = B), epilogue W1 -= lr * dW1 and W1's split for the next kPre (and
// delta on the last step), run by the store warps (store_tiles).
enum { kPre = 0, kDw1 = 1 };

struct Wide {
  Dims d;
  int tm, tn, total;  // tiles along M and N per member; of all members
  int nk;             // chunks along K
  int first, last;    // step 0 (W from theta); the last step (delta)
  float lr;
  float* w;           // the members' W scratch [members, P]
  float* out;         // kPre: hid [members, B, Hp]; kDw1: W1 split
  float* delta;
};

// A half tile in its slot: row r's 128 floats with the 8-float groups
// permuted by r % 8 (column c at c ^ 8 (r % 8)), so that the consumers'
// 8-byte writes of their accumulator rows and the store warps' 8-byte
// reads along a row are both free of bank conflicts.
__device__ __forceinline__ int half_at(int r, int c) {
  return r * kGN + (c ^ ((r & 7) << 3));
}

// Two floats at p, as one 8-byte access where p is 8-byte aligned (vec)
// and as two 4-byte ones where it is not; the stores are streaming.
__device__ __forceinline__ float2 ld2(const float* p, bool vec) {
  return vec ? *reinterpret_cast<const float2*>(p) : make_float2(p[0], p[1]);
}

__device__ __forceinline__ void st2(float* p, float2 v, bool vec) {
  if (vec) {
    __stcs(reinterpret_cast<float2*>(p), v);
  } else {
    __stcs(p, v.x);
    __stcs(p + 1, v.y);
  }
}

__device__ __forceinline__ bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

// One row's [p, p + n) floats into L2 ahead of its reads, widened to
// 16-byte bounds as a bulk prefetch needs: a row of W1 is followed by the
// rest of the parameter vector, so the range stays inside it.
__device__ __forceinline__ void prefetch_row(const float* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15);
  const uintptr_t e =
      (reinterpret_cast<uintptr_t>(p + n) + 15) & ~uintptr_t(15);
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(a),
               "r"(static_cast<uint32_t>(e - a))
               : "memory");
}

// Tile t's rows of W1 (and, on the last step, theta) into L2, by the
// store warps a tile ahead of their reads.
__device__ __forceinline__ void prefetch_tile(const Members& mem,
                                              const Wide& a, int t) {
  if (t >= a.total) return;
  const Dims& d = a.d;
  const int per = a.tm * a.tn, m = t / per, r = t % per;
  const int r0 = (r % a.tm) * kGM, c0 = (r / a.tm) * kGN;
  const float* theta = mem.theta[m];
  const float* w_in = member_w(mem, a.w, a.first, m, d.P);
  const int cols = min(kGN, d.F - c0);
  for (int i = threadIdx.x - 32; i < kGM && r0 + i < d.H;
       i += kStoreWarps * 32) {
    const size_t p = (size_t)(r0 + i) * d.F + c0;
    prefetch_row(w_in + p, cols);
    if (a.last && !a.first) prefetch_row(theta + p, cols);
  }
}

// The update pass's epilogue, on the store warps: each half tile in the
// order the consumers hand them over (a CTA's tiles in turn, rows 0-63
// then 64-127), per element wn = W1 - lr * dW1 (the two roundings of w -
// lr * g), W1 := wn, wn's hi/lo split, and delta = wn - theta on the last
// step.  A tile's rows of W1 (and theta) are prefetched into L2 a tile
// ahead; the outputs are streaming stores (evict first: nothing reads them
// before they would leave L2).  A lane takes columns 2 lane and 64 + 2
// lane, so a warp reads and writes 256 contiguous bytes of a row: 8-byte
// accesses where a member's rows allow them (an odd member's rows of the w
// scratch and of delta [members, P] are only 8-byte aligned at an even P,
// as at the cell's shape, and only 4-byte aligned at an odd P, which an
// even num_classes or an odd H gives), else 4-byte ones; each of theta,
// the w scratch and delta is tested apart, a member at a time (F is a
// multiple of 4 and a lane's columns are even, so a row's offset keeps the
// member's alignment).  The split planes [members][2][H][F] are always
// 8-byte aligned.  W1 is read and written in place, so a batch of
// kStoreRows rows' loads is issued before their stores.
constexpr int kStoreRows = 2;

__device__ __forceinline__ void store_tiles(const Members& mem,
                                            const Wide& a, const float* buf,
                                            uint64_t* ready,
                                            uint64_t* freed) {
  const int sw = threadIdx.x / 32 - 1, lane = threadIdx.x % 32;
  const Dims& d = a.d;
  const int per = a.tm * a.tn;
  int n = 0;  // this CTA's tiles taken so far
  for (int t = blockIdx.x; t < a.total; t += gridDim.x, ++n) {
    const int m = t / per, r = t % per;
    const int r0 = (r % a.tm) * kGM, c0 = (r / a.tm) * kGN;
    const float* theta = mem.theta[m];
    const float* w_in = member_w(mem, a.w, a.first, m, d.P);
    const size_t mp = (size_t)m * d.P, ms = (size_t)m * 2 * d.H * d.F;
    const bool tv = aligned8(theta), sv = aligned8(a.w + mp),
               dv = a.last && aligned8(a.delta + mp);
    const bool wv = a.first ? tv : sv;
    if (n == 0) prefetch_tile(mem, a, t);
    prefetch_tile(mem, a, t + gridDim.x);
    for (int half = 0; half < 2; ++half) {
      mbar_wait(&ready[half], n & 1);
      const float* src = buf + half * kHalf;
      const int h0 = r0 + half * (kGM / 2), f0 = c0 + 2 * lane;
      // batch b: item b % 2 of row hr = q + (b / 2) kStoreWarps of the half
      for (int q = sw; q < kGM / 2; q += kStoreWarps * kStoreRows) {
        float2 w[2 * kStoreRows], th[2 * kStoreRows];
#pragma unroll
        for (int b = 0; b < 2 * kStoreRows; ++b) {
          const int hr = q + (b / 2) * kStoreWarps, f = f0 + 64 * (b % 2);
          if (hr < kGM / 2 && h0 + hr < d.H && f < d.F) {
            const size_t p = (size_t)(h0 + hr) * d.F + f;
            w[b] = ld2(w_in + p, wv);
            if (a.last) th[b] = ld2(theta + p, tv);
          }
        }
#pragma unroll
        for (int b = 0; b < 2 * kStoreRows; ++b) {
          const int hr = q + (b / 2) * kStoreWarps, f = f0 + 64 * (b % 2);
          if (hr < kGM / 2 && h0 + hr < d.H && f < d.F) {
            const size_t p = (size_t)(h0 + hr) * d.F + f;
            const float2 g = *reinterpret_cast<const float2*>(
                src + half_at(hr, 64 * (b % 2) + 2 * lane));
            const float2 wn =
                make_float2(__fsub_rn(w[b].x, __fmul_rn(a.lr, g.x)),
                            __fsub_rn(w[b].y, __fmul_rn(a.lr, g.y)));
            st2(a.w + mp + p, wn, sv);
            uint2 wh, wl;
            split(wn.x, wh.x, wl.x);
            split(wn.y, wh.y, wl.y);
            __stcs(reinterpret_cast<uint2*>(a.out + ms + p), wh);
            __stcs(reinterpret_cast<uint2*>(a.out + ms + (size_t)d.H * d.F +
                                            p),
                   wl);
            if (a.last)
              st2(a.delta + mp + p,
                  make_float2(__fsub_rn(wn.x, th[b].x),
                              __fsub_rn(wn.y, th[b].y)),
                  dv);
          }
        }
      }
      mbar_arrive(&freed[half]);
    }
  }
}

template <int OP>
__device__ __forceinline__ void wide_body(const CUtensorMap* ta,
                                          const CUtensorMap* tb,
                                          const Members& mem, const Wide& a) {
  constexpr int S = OP == kDw1 ? kUStages : kGStages;
  __shared__ __align__(8) uint64_t full[S], empty[S];
  // kDw1: a consumer warpgroup's half tile handed over to the store warps
  // in its slot (ready) and taken (freed)
  __shared__ __align__(8) uint64_t ready[2], freed[2];
  extern __shared__ __align__(16) unsigned char wsm[];
  unsigned char* sm = wsm + ((1024 - (sh_addr(wsm) & 1023)) & 1023);
  float* buf = reinterpret_cast<float*>(sm + S * kGStage);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    if constexpr (OP == kDw1)
      for (int s = 0; s < 2; ++s) {
        mbar_init(&ready[s], 128);               // a consumer warpgroup
        mbar_init(&freed[s], kStoreWarps * 32);  // the store warps
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int per = a.tm * a.tn;
  if (wg == 0) {
    // the producer: every chunk of every tile of this CTA, in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        OP == kDw1 ? kURegsP : kGRegsP));
    if (threadIdx.x >= 32) {
      if constexpr (OP == kDw1) store_tiles(mem, a, buf, ready, freed);
      return;
    }
    if (threadIdx.x != 0) return;
    int stage = 0, phase = 0;
    for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
      const int m = t / per, r = t % per;
      const int r0 = (r % a.tm) * kGM, c0 = (r / a.tm) * kGN;
      for (int kc = 0; kc < a.nk; ++kc) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = sm + stage * kGStage;
        mbar_expect(&full[stage], kGStage);
        const int k0 = kc * kGK;
        tma_load(st, ta, k0, r0, 0, m, &full[stage]);
        tma_load(st + kGOp, ta, k0, r0, 1, m, &full[stage]);
        tma_load(st + 2 * kGOp, tb, k0, c0, 0, m, &full[stage]);
        tma_load(st + 3 * kGOp, tb, k0, c0, 1, m, &full[stage]);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
      OP == kDw1 ? kURegsC : kGRegsC));
  const int cw = wg - 1;  // rows cw*64.. of the tile
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const Dims& d = a.d;
  int stage = 0, phase = 0;
  int n = 0;  // kDw1: this CTA's tiles handed over
  float cb[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) cb[i] = 0.f;
  for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
    const int m = t / per, r = t % per;
    const int r0 = (r % a.tm) * kGM, c0 = (r / a.tm) * kGN;
    // big: the hi*hi sums; small: the lo*hi + hi*lo terms (2^-11 of the
    // big ones), accumulated over all of K in the tensor cores
    float big[64], small[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) big[i] = small[i] = 0.f;
    for (int kc = 0; kc < a.nk; ++kc) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = sm + stage * kGStage;
      const unsigned char* ahi = st + cw * 64 * kGK * 4;
      const unsigned char* alo = ahi + kGOp;
      const unsigned char* bhi = st + 2 * kGOp;
      const unsigned char* blo = st + 3 * kGOp;
      pin(cb);
      pin(small);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      // the chunk's hi*hi sum starts from zero (cb)
#pragma unroll
      for (int s = 0; s < kGK / 8; ++s) {
        gmma(small, gmma_desc(alo + 32 * s), gmma_desc(bhi + 32 * s), 1);
        gmma(small, gmma_desc(ahi + 32 * s), gmma_desc(blo + 32 * s), 1);
        gmma(cb, gmma_desc(ahi + 32 * s), gmma_desc(bhi + 32 * s), s > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      pin(cb);
      pin(small);
      if (lane == 0) mbar_arrive(&empty[stage]);
      // and reaches the running sum through round-to-nearest adds
#pragma unroll
      for (int i = 0; i < 64; ++i) big[i] = __fadd_rn(big[i], cb[i]);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) big[i] = __fadd_rn(big[i], small[i]);
    // the accumulator layout of m64nN: register 4j + 2h + c holds row
    // 16 warp + lane/4 + 8h, column 8j + 2 (lane%4) + c
    const int row = r0 + cw * 64 + warp * 16 + lane / 4;
    const int col = c0 + 2 * (lane % 4);
    if constexpr (OP == kPre) {
      const float* b1 =
          member_w(mem, a.w, a.first, m, d.P) + (size_t)d.H * d.F;
      float* hid = a.out + (size_t)m * d.B * d.Hp;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int h = col + 8 * j + c;
          if (h >= d.H) continue;
          const float bias = b1[h];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int b = row + 8 * h2;
            if (b < d.B)
              hid[(size_t)b * d.Hp + h] =
                  fmaxf(__fadd_rn(big[4 * j + 2 * h2 + c], bias), 0.f);
          }
        }
    } else {
      // hand this warpgroup's half of dW1 to the store warps and go on to
      // the next tile, once they took its half of the last tile
      mbar_wait(&freed[cw], (n - 1) & 1);
      float* dst = buf + cw * kHalf;
      const int hr = warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          *reinterpret_cast<float2*>(
              dst + half_at(hr + 8 * h2, 8 * j + 2 * (lane % 4))) =
              make_float2(big[4 * j + 2 * h2], big[4 * j + 2 * h2 + 1]);
      mbar_arrive(&ready[cw]);
      ++n;
    }
  }
}

__global__ void __launch_bounds__(kGThreads, 1)
wide_hidden_pass(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb, const Members mem,
                 const Wide a) {
  wide_body<kPre>(&ta, &tb, mem, a);
}

__global__ void __launch_bounds__(kGThreads, 1)
wide_update_pass(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb, const Members mem,
                 const Wide a) {
  wide_body<kDw1>(&ta, &tb, mem, a);
}

// The operands' split, once per call: x into xs [2][B][F] and theta's W1
// into w1s [2][H][F] per member (blockIdx.z 0 and 1), element by element.
__global__ void __launch_bounds__(kThreads)
split_pass(Members mem, Dims d, float* __restrict__ xs,
           float* __restrict__ w1s) {
  const int m = blockIdx.y;
  const bool is_x = blockIdx.z == 0;
  const float* src = is_x ? mem.x[m] : mem.theta[m];
  const size_t n = (size_t)(is_x ? d.B : d.H) * d.F;
  float* hi = (is_x ? xs : w1s) + 2 * n * m;
  const size_t first = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * kThreads;
  // n is a multiple of 4 (F is), the planes 16-byte aligned: 16-byte
  // accesses where the source is aligned too
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    uint4* h4 = reinterpret_cast<uint4*>(hi);
    uint4* l4 = reinterpret_cast<uint4*>(hi + n);
    for (size_t i = first; i < n / 4; i += stride) {
      const float4 v = s4[i];
      uint4 h, l;
      split(v.x, h.x, l.x);
      split(v.y, h.y, l.y);
      split(v.z, h.z, l.z);
      split(v.w, h.w, l.w);
      h4[i] = h;
      l4[i] = l;
    }
    return;
  }
  for (size_t i = first; i < n; i += stride) {
    uint32_t h, l;
    split(src[i], h, l);
    hi[i] = __uint_as_float(h);
    hi[n + i] = __uint_as_float(l);
  }
}

// x.T split, once per call: xt [2][F][Bp] per member, through 32 x 32
// tiles in shared memory.
__global__ void __launch_bounds__(kThreads)
transpose_pass(Members mem, Dims d, float* __restrict__ xt) {
  __shared__ float tile[32][33];
  const int m = blockIdx.z;
  const float* x = mem.x[m];
  const int f0 = blockIdx.x * 32, b0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += kThreads / 32) {
    const int b = b0 + i, f = f0 + tx;
    tile[i][tx] = (b < d.B && f < d.F) ? x[(size_t)b * d.F + f] : 0.f;
  }
  __syncthreads();
  const size_t plane = (size_t)d.F * d.Bp;
  float* hi = xt + 2 * plane * m;
  for (int i = ty; i < 32; i += kThreads / 32) {
    const int f = f0 + i, b = b0 + tx;
    if (f >= d.F || b >= d.B) continue;
    uint32_t h, l;
    split(tile[tx][i], h, l);
    hi[(size_t)f * d.Bp + b] = __uint_as_float(h);
    hi[plane + (size_t)f * d.Bp + b] = __uint_as_float(l);
  }
}

// The wide step's small passes, in place of row_pass and update_pass's
// tail: grad_rows takes each row's logits to g (4 warps a row), grad_cols
// takes 32 columns of [B, H] per CTA over all B rows to dh, dh.T split
// (the operand of wide_update_pass), and b1 | W2 | b2 -= lr * their sums
// over the rows, each in a fixed order: no per-CTA partials.
constexpr int kGradRows = 2;                  // rows per grad_rows CTA
constexpr int kGradSplit = kWarps / kGradRows;  // warps per row
constexpr int kColW = 32;                     // columns per grad_cols CTA
constexpr int kColThreads = 512;
constexpr int kColGroups = kColThreads / 32;  // row groups of grad_cols
constexpr int kColTile = 32;                  // rows per staged tile
static_assert(kColTile % kColGroups == 0 && kColGroups >= kMaxRows,
              "grad_cols tiling");

// A row's logits as 4 warps' partial sums over interleaved columns, added
// in warp order.  LOSS = false: g = (softmax(logit) - onehot(y)) * mask *
// row_valid / denom into out [B, R] per member.  LOSS = true: the CTA's
// sum of masked NLL, rows in order, into out [gridDim.x] per member.
template <int R, bool LOSS>
__global__ void __launch_bounds__(kThreads)
grad_rows(Members mem, const float* w_scratch, int from_theta, Dims d,
          const float* __restrict__ hid_all, float* __restrict__ out) {
  __shared__ float red[kThreads];
  __shared__ float part[kGradRows][kGradSplit][R];
  __shared__ float nll_s[kGradRows];
  const int m = blockIdx.y;
  const int H = d.H;
  const float* w2 =
      member_w(mem, w_scratch, from_theta, m, d.P) + (size_t)H * d.F + H;
  const float* b2 = w2 + R * H;
  const float denom = LOSS ? 1.f : block_denom(mem.mask[m], d.B, red);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = w / kGradSplit, q = w % kGradSplit;
  const int row = blockIdx.x * kGradRows + i;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  if (row < d.B) {
    const float* hr = hid_all + ((size_t)m * d.B + row) * d.Hp;
    for (int h = q * 32 + lane; h < H; h += 32 * kGradSplit) {
      const float hv = hr[h];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(hv, w2[r * H + h], acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = warp_sum(acc[r]);
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) part[i][q][r] = acc[r];
  __syncthreads();
  float nll = 0.f;
  if (q == 0 && lane == 0 && row < d.B) {
    float l[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = part[i][0][r];
      for (int k = 1; k < kGradSplit; ++k) s += part[i][k][r];
      l[r] = s + b2[r];
    }
    log_softmax<R>(l);
    const int yv = mem.y[m][row];
    if (LOSS) {
      float dot = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) dot += l[r] * ((yv == r) ? 1.f : 0.f);
      nll = -dot * mem.mask[m][row];
    } else {
      const float valid = (yv >= 0 && yv < R) ? 1.f : 0.f;
      const float scale = mem.mask[m][row] * valid / denom;
      float* g = out + ((size_t)m * d.B + row) * R;
#pragma unroll
      for (int r = 0; r < R; ++r)
        g[r] = (expf(l[r]) - ((yv == r) ? 1.f : 0.f)) * scale;
    }
  }
  if (!LOSS) return;
  if (q == 0 && lane == 0) nll_s[i] = nll;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < kGradRows; ++r) s += nll_s[r];
    out[(size_t)m * gridDim.x + blockIdx.x] = s;
  }
}

// dh = (g @ W2) * (pre > 0) for columns h0..h0+31 and every row, in
// tiles of 32 rows staged in shared memory so that dh.T's rows are
// written whole; each thread sums db1 and dW2 = g.T @ hid over its rows
// (b = its group, + kColGroups, ...), the groups' sums are added in group
// order, and the CTA applies b1 | W2 (and CTA 0 b2, a warp a class, lanes
// over rows, then the warp's fixed tree) in place: each element read and
// written by one thread.
template <int R>
__global__ void __launch_bounds__(kColThreads)
grad_cols(Members mem, float* w_scratch, int first, int last, Dims d,
          const float* __restrict__ hid_all, const float* __restrict__ g_all,
          float* __restrict__ dht_all, float lr, float* __restrict__ delta) {
  __shared__ float tile[kColTile][kColW + 1];
  __shared__ float sums[kColGroups][R + 1][kColW];
  const int m = blockIdx.y;
  const int H = d.H;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int h0 = blockIdx.x * kColW, h = h0 + tx;
  const float* theta = mem.theta[m];
  const float* w_in = member_w(mem, w_scratch, first, m, d.P);
  float* w_out = w_scratch + (size_t)m * d.P;
  const size_t tail = (size_t)H * d.F;     // b1 | W2 | b2 start here
  const float* w2 = w_in + tail + H;
  float w2h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) w2h[r] = h < H ? w2[r * H + h] : 0.f;
  const float* hid = hid_all + (size_t)m * d.B * d.Hp;
  const float* g = g_all + (size_t)m * d.B * R;
  const size_t plane = (size_t)H * d.Bp;
  float* dht = dht_all + 2 * plane * m;
  float sdb1 = 0.f, sdw2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) sdw2[r] = 0.f;
  for (int b0 = 0; b0 < d.B; b0 += kColTile) {
#pragma unroll
    for (int k = 0; k < kColTile / kColGroups; ++k) {
      const int rr = ty + k * kColGroups, b = b0 + rr;
      float dh = 0.f;
      if (b < d.B && h < H) {
        const float hv = hid[(size_t)b * d.Hp + h];
        const float* gb = g + (size_t)b * R;
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) s = fmaf(gb[r], w2h[r], s);
        dh = hv > 0.f ? s : 0.f;
        sdb1 += dh;
#pragma unroll
        for (int r = 0; r < R; ++r) sdw2[r] = fmaf(gb[r], hv, sdw2[r]);
      }
      tile[rr][tx] = dh;
    }
    __syncthreads();
    for (int j = ty; j < kColW; j += kColGroups) {
      const int hh = h0 + j, b = b0 + tx;
      if (hh < H && b < d.B) {
        uint32_t hi, lo;
        split(tile[tx][j], hi, lo);
        dht[(size_t)hh * d.Bp + b] = __uint_as_float(hi);
        dht[plane + (size_t)hh * d.Bp + b] = __uint_as_float(lo);
      }
    }
    __syncthreads();
  }
  sums[ty][0][tx] = sdb1;
#pragma unroll
  for (int r = 0; r < R; ++r) sums[ty][1 + r][tx] = sdw2[r];
  __syncthreads();
  // quantity qn: 0 is b1[h], 1 + r is W2[r][h]
  for (int qn = ty; qn <= R && h < H; qn += kColGroups) {
    float s = 0.f;
    for (int k = 0; k < kColGroups; ++k) s += sums[k][qn][tx];
    const size_t off = tail + (qn == 0 ? h : H + (size_t)(qn - 1) * H + h);
    const float wn = __fsub_rn(w_in[off], __fmul_rn(lr, s));
    w_out[off] = wn;
    if (last) delta[(size_t)m * d.P + off] = __fsub_rn(wn, theta[off]);
  }
  if (blockIdx.x == 0 && ty < R) {
    float s = 0.f;
    for (int b = tx; b < d.B; b += 32) s += g[(size_t)b * R + ty];
    s = warp_sum(s);
    if (tx == 0) {
      const size_t off = tail + H + (size_t)R * H + ty;
      const float wn = __fsub_rn(w_in[off], __fmul_rn(lr, s));
      w_out[off] = wn;
      if (last) delta[(size_t)m * d.P + off] = __fsub_rn(wn, theta[off]);
    }
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
  d.Bp = (B + 3) / 4 * 4;
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

// cuTensorMapEncodeTiled, looked up in libcuda once (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a split operand [members][2][rows][cols] at `ld` floats
// per row, in boxes of kGK columns x kGM rows of one plane of one member,
// 128-byte swizzled; a box past the edge is filled with zeros.  Encoded on
// the host at every call from the call's scratch (under CUDA graph capture,
// the graph's own buffers) and passed by value.
int tensor_map(CUtensorMap* map, float* base, int cols, int rows, int ld,
               int members) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)ld * 4;
  const cuuint64_t dim[4] = {(cuuint64_t)cols, (cuuint64_t)rows, 2,
                             (cuuint64_t)members};
  const cuuint64_t stride[3] = {row, row * rows, row * rows * 2};
  const cuuint32_t box[4] = {kGK, kGM, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, dim,
                        stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The wide path's passes, 4k + 5 launches: the operands' split, then per
// step wide_hidden_pass, grad_rows, grad_cols and wide_update_pass, then
// wide_hidden_pass at W_k, grad_rows for the NLL and loss_reduce.  ws: the
// split scratch xs, xt, w1s, dht; g [members, B, R] is the scratch that
// holds the narrow passes' partials.
template <int R>
int run_wide(const Members& mem, int members, float* delta, float* loss,
             float* w, float* hid, float* g, float* loss_partials,
             float* const* ws, int B, int F, int H, int k, float lr,
             cudaStream_t st) {
  const Dims d = dims(B, F, H, R);
  float *xs = ws[0], *xt = ws[1], *w1s = ws[2], *dht = ws[3];
  if (!xs || !xt || !w1s || !dht) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw, mdh, mxt;
  int err = tensor_map(&mx, xs, F, B, F, members);
  if (err == 0) err = tensor_map(&mw, w1s, F, H, F, members);
  if (err == 0) err = tensor_map(&mdh, dht, B, H, d.Bp, members);
  if (err == 0) err = tensor_map(&mxt, xt, B, F, d.Bp, members);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(
        wide_hidden_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kGSmem);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(
        wide_update_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kGUSmem);
  int dev = 0, sms = 0;
  if (err == 0) err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err != 0) return err;
  Wide pre{}, upd{};
  pre.d = upd.d = d;
  pre.lr = upd.lr = lr;
  pre.w = upd.w = w;
  pre.delta = upd.delta = delta;
  pre.tm = ceil_div(B, kGM);
  pre.tn = ceil_div(H, kGN);
  pre.nk = ceil_div(F, kGK);
  pre.out = hid;
  upd.tm = ceil_div(H, kGM);
  upd.tn = ceil_div(F, kGN);
  upd.nk = ceil_div(B, kGK);
  upd.out = w1s;
  pre.total = members * pre.tm * pre.tn;
  upd.total = members * upd.tm * upd.tn;
  // persistent: at most one CTA per SM, each walking its tiles in order
  const int gp = pre.total < sms ? pre.total : sms;
  const int gu = upd.total < sms ? upd.total : sms;
  const dim3 grad(ceil_div(B, kGradRows), members);
  const dim3 cols(ceil_div(H, kColW), members);
  if (k == 0)
    cudaMemsetAsync(delta, 0, sizeof(float) * (size_t)members * d.P, st);
  split_pass<<<dim3(2 * sms, members, 2), kThreads, 0, st>>>(mem, d, xs,
                                                            w1s);
  transpose_pass<<<dim3(ceil_div(F, 32), ceil_div(B, 32), members), kThreads,
                   0, st>>>(mem, d, xt);
  for (int s = 0; s < k; ++s) {
    pre.first = upd.first = s == 0;
    upd.last = s == k - 1;
    wide_hidden_pass<<<gp, kGThreads, kGSmem, st>>>(mx, mw, mem, pre);
    grad_rows<R, false><<<grad, kThreads, 0, st>>>(mem, w, s == 0, d, hid,
                                                   g);
    grad_cols<R><<<cols, kColThreads, 0, st>>>(mem, w, s == 0, s == k - 1,
                                               d, hid, g, dht, lr, delta);
    wide_update_pass<<<gu, kGThreads, kGUSmem, st>>>(mdh, mxt, mem, upd);
  }
  pre.first = k == 0;
  wide_hidden_pass<<<gp, kGThreads, kGSmem, st>>>(mx, mw, mem, pre);
  grad_rows<R, true><<<grad, kThreads, 0, st>>>(mem, w, k == 0, d, hid,
                                                loss_partials);
  Dims dl = d;                   // loss_reduce: a partial per grad_rows CTA
  dl.nblk = grad.x;
  loss_reduce<Members><<<dim3(1, members), kThreads, 0, st>>>(
      mem, dl, loss_partials, loss);
  return (int)cudaGetLastError();
}

// f32 at a wide shape takes the wide passes, everything else the narrow.
template <class S, int R>
int run_any(const typename S::Mem& mem, int members, float* delta,
            float* loss, float* w, float* hid, float* dh, float* partials,
            float* loss_partials, float* const* ws, int B, int F, int H,
            int k, float lr, cudaStream_t st) {
  if constexpr (std::is_same<S, SlabF32>::value) {
    if (wide_path(F, H))
      return run_wide<R>(mem, members, delta, loss, w, hid, partials,
                         loss_partials, ws, B, F, H, k, lr, st);
  }
  return run<S, R>(mem, members, delta, loss, w, hid, dh, partials,
                   loss_partials, B, F, H, k, lr, st);
}

// The R = C+1 instance of a storage form's passes.
template <class S>
int dispatch(const typename S::Mem& mem, int members, float* delta,
             float* loss, float* w, float* hid, float* dh, float* partials,
             float* loss_partials, float* const* ws, int B, int F, int H,
             int R, int k, float lr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KPS_CASE(n)                                                        \
  case n:                                                                  \
    return run_any<S, n>(mem, members, delta, loss, w, hid, dh, partials,  \
                         loss_partials, ws, B, F, H, k, lr, st);
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
// partials, loss_partials, and for the wide path (kps_mlp_wide) the split
// operands xs, xt, w1s, dht (null otherwise).  Returns cudaGetLastError()
// after the launches, or the error that kept them from starting.
int kps_mlp_local_update(const void* const* thetas, const void* const* xs,
                         const void* const* ys, const void* const* masks,
                         int members, float* delta, float* loss, float* w,
                         float* hid, float* dh, float* partials,
                         float* loss_partials, float* xs_split,
                         float* xt_split, float* w1_split, float* dht_split,
                         int B, int F, int H, int R, int k, float lr,
                         void* stream) {
  if (bad_shape(B, F, H, k, members)) return (int)cudaErrorInvalidValue;
  Members mem;
  fill_members(mem, thetas, xs, ys, masks, members);
  float* const ws[4] = {xs_split, xt_split, w1_split, dht_split};
  return dispatch<SlabF32>(mem, members, delta, loss, w, hid, dh, partials,
                           loss_partials, ws, B, F, H, R, k, lr, stream);
}

// K5, bf16 slab: as kps_mlp_local_update, with xs pointing at bf16 [B, F]
// (always the narrow passes: no split scratch).
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
                            partials, loss_partials, nullptr, B, F, H, R, k,
                            lr, stream);
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
                         loss_partials, nullptr, B, F, H, R, k, lr, stream);
}

// Whether a call on x of storage form `form` (0 f32, 1 bf16, 2 int8) at
// (B, F, H) takes the wide passes: the rule run_any applies.
int kps_mlp_wide(int B, int F, int H, int form) {
  (void)B;
  return form == 0 && wide_path(F, H);
}

// The float counts of the scratch buffers of a call on `members` members
// of storage form `form`, into sizes[0..8]: w, hid, dh, partials,
// loss_partials, and for the wide path the split operands xs [2][B][F],
// xt [2][F][Bp], w1s [2][H][F], dht [2][H][Bp] per member (0 otherwise).
// The wide path keeps no dh [B, Hp] (0), holds g [B, R] where the narrow
// one holds the row passes' partials, and a loss partial per grad_rows CTA.
void kps_mlp_scratch(int B, int F, int H, int R, int members, int form,
                     long long* sizes) {
  const Dims d = dims(B, F, H, R);
  const long long n = members;
  const bool wide = kps_mlp_wide(B, F, H, form);
  sizes[0] = n * d.P;
  sizes[1] = n * d.B * d.Hp;
  sizes[2] = wide ? 0 : n * d.B * d.Hp;
  sizes[3] = wide ? n * d.B * R : n * d.nblk * d.T;
  sizes[4] = n * (wide ? (B + kGradRows - 1) / kGradRows : d.nblk);
  sizes[5] = wide ? n * 2 * d.B * d.F : 0;
  sizes[6] = wide ? n * 2 * d.F * d.Bp : 0;
  sizes[7] = wide ? n * 2 * d.H * d.F : 0;
  sizes[8] = wide ? n * 2 * d.H * d.Bp : 0;
}

// The dynamic shared memory per CTA of the tensor passes, in bytes (ptxas
// reports only the static part): hidden_pass and update_pass for f32,
// bf16 and int8 x, into bytes[0..5], wide_hidden_pass's into bytes[6] and
// wide_update_pass's into bytes[7].
void kps_mlp_smem(int* bytes) {
  bytes[0] = Geo<SlabF32>::kHidSmem;
  bytes[1] = Geo<SlabF32>::kUpdSmem;
  bytes[2] = Geo<SlabBf16>::kHidSmem;
  bytes[3] = Geo<SlabBf16>::kUpdSmem;
  bytes[4] = Geo<SlabQ>::kHidSmem;
  bytes[5] = Geo<SlabQ>::kUpdSmem;
  bytes[6] = kGSmem;
  bytes[7] = kGUSmem;
}

int kps_mlp_max_rows() { return kMaxRows; }
int kps_mlp_max_members() { return kMaxMembers; }

}  // extern "C"
