// The storage forms of a gang member's training slab x, shared by the
// local-update kernels (local_update.cu: K1/K2 and K3, mlp_update.cu:
// K4/K6 and K5).
//
// A worker keeps x on the device in f32, bf16, or int8 with one f32 scale
// per row (kafka_ps_tpu_torch/compress/slab.py, --slab-dtype).  The
// kernels are templated on one of the Slab* types below.  Both stage x in
// its stored form into shared memory (stage_rows, below).  local_update.cu
// decodes each element where it reads it from there (`at`), exactly as
// compress/slab.decode_x does: bf16 widens exactly, int8 is one rounded
// f32 multiply q * scale (__fmul_rn, so that nvcc cannot contract it into
// the product that reads it).  Every product after the read is then the
// f32 kernel's, and a kernel's decoded value equals the plain version's bit
// for bit.  mlp_update.cu's tensor-core products take the stored values as
// they are (bf16 and int8 q are exact in TF32) and apply int8's row scales
// to the products' rows (see its header).
//
// Each form has its own table of per-member base pointers, passed by
// value: the f32 table is the one K1/K2/K4/K6 have always taken, and the
// int8 table carries the scale pointers in a fifth array instead of
// widening it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace kps {

constexpr int kMaxMembers = 32;  // per launch; the wrapper splits larger gangs

// f32: 4 * 32 * 8 = 1 KiB of the 4 KiB kernel-parameter space.
struct Members {
  const float* theta[kMaxMembers];
  const float* x[kMaxMembers];
  const int* y[kMaxMembers];
  const float* mask[kMaxMembers];
};

struct MembersBf16 {
  const float* theta[kMaxMembers];
  const __nv_bfloat16* x[kMaxMembers];
  const int* y[kMaxMembers];
  const float* mask[kMaxMembers];
};

// int8: 5 * 32 * 8 = 1.25 KiB.
struct MembersQ {
  const float* theta[kMaxMembers];
  const signed char* x[kMaxMembers];
  const int* y[kMaxMembers];
  const float* mask[kMaxMembers];
  const float* scale[kMaxMembers];
};

// A storage form: its member table, its element type, the member's row
// scales (none but int8's), and `at`, which decodes one stored element
// that a kernel has staged in shared memory.  `s` is the element's row
// scale; the f32 and bf16 forms ignore it.
struct SlabF32 {
  using Mem = Members;
  using T = float;
  static __device__ __forceinline__ const float* scales(const Mem&, int) {
    return nullptr;
  }
  static __device__ __forceinline__ float scale(const float*, int) {
    return 1.f;
  }
  static __device__ __forceinline__ float at(const unsigned char* p, float) {
    return *reinterpret_cast<const float*>(p);
  }
};

struct SlabBf16 {
  using Mem = MembersBf16;
  using T = __nv_bfloat16;
  static __device__ __forceinline__ const float* scales(const Mem&, int) {
    return nullptr;
  }
  static __device__ __forceinline__ float scale(const float*, int) {
    return 1.f;
  }
  static __device__ __forceinline__ float at(const unsigned char* p, float) {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  }
};

struct SlabQ {
  using Mem = MembersQ;
  using T = signed char;
  static __device__ __forceinline__ const float* scales(const Mem& mem,
                                                       int m) {
    return mem.scale[m];
  }
  static __device__ __forceinline__ float scale(const float* s, int row) {
    return __ldg(s + row);
  }
  static __device__ __forceinline__ float at(const unsigned char* p,
                                             float s) {
    return __fmul_rn(
        static_cast<float>(*reinterpret_cast<const signed char*>(p)), s);
  }
};

// -- staging rows into shared memory with cp.async ---------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The 16-byte chunks that cover `bytes` contiguous bytes starting at any
// offset 0..15 of an aligned chunk; a staged row's stride is 16 times this.
__host__ __device__ constexpr int stage_chunks(int bytes) {
  return (bytes + 30) / 16;
}

// Rows r0..r0+rows-1, columns c0..c0+cols-1 (elements of es bytes) of a
// row-major matrix of nrows x ncols with a row pitch of `ld` bytes, into
// `dst` at `stride` bytes per row: each row as the 16-byte chunks that
// cover it, aligned down, its first element at byte mis[r] of its row in
// `dst`.  So any row length, storage form and base address stage the same
// way.  A chunk is copied whole if it starts before the end of its row and
// of the window (it lies in the allocation, which is 16-byte aligned), and
// zero-filled without a read otherwise, as are rows past nrows; columns
// past ncols hold whatever followed the row and are masked by the reader.
// Threads tid, tid + nthreads, ... of the block issue the copies; the
// caller commits and waits.
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           unsigned char* mis,
                                           const void* src, size_t ld,
                                           int es, int stride, int rows,
                                           int cols, int r0, int nrows,
                                           int c0, int ncols, int tid,
                                           int nthreads) {
  const int chunks = stage_chunks(cols * es);
  const unsigned char* base = static_cast<const unsigned char*>(src);
  for (int e = tid; e < rows * chunks; e += nthreads) {
    const int r = e / chunks, j = e - r * chunks;
    const uintptr_t row =
        reinterpret_cast<uintptr_t>(base) + (size_t)(r0 + r) * ld;
    const uintptr_t start = row + (size_t)c0 * es;
    const uintptr_t end = row + (size_t)ncols * es;
    const uintptr_t s = (start & ~uintptr_t(15)) + 16 * j;
    const bool ok = r0 + r < nrows && s < end && s < start + (size_t)cols * es;
    cp_async16(dst + (size_t)r * stride + 16 * j,
               reinterpret_cast<const void*>(s), ok ? 16 : 0);
    if (j == 0) mis[r] = static_cast<unsigned char>(start & 15);
  }
}

// Host side: the four tables every form has, from the C entry's arrays
// of device pointers (unused entries null).
template <class Mem>
void fill_members(Mem& mem, const void* const* thetas, const void* const* xs,
                  const void* const* ys, const void* const* masks,
                  int members) {
  using X = std::remove_reference_t<decltype(mem.x[0])>;
  for (int i = 0; i < kMaxMembers; ++i) {
    const bool used = i < members;
    mem.theta[i] = used ? static_cast<const float*>(thetas[i]) : nullptr;
    mem.x[i] = used ? static_cast<X>(xs[i]) : nullptr;
    mem.y[i] = used ? static_cast<const int*>(ys[i]) : nullptr;
    mem.mask[i] = used ? static_cast<const float*>(masks[i]) : nullptr;
  }
}

}  // namespace kps
