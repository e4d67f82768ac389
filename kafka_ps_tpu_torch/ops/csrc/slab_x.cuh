// The storage forms of a gang member's training slab x, shared by the
// local-update kernels (local_update.cu: K1/K2 and K3, mlp_update.cu:
// K4/K6 and K5).
//
// A worker keeps x on the device in f32, bf16, or int8 with one f32 scale
// per row (kafka_ps_tpu_torch/compress/slab.py, --slab-dtype).  The
// kernels are templated on one of the Slab* types below.  local_update.cu
// decodes each element where it loads it, exactly as compress/slab.decode_x
// does: bf16 widens exactly, int8 is one rounded f32 multiply q * scale
// (__fmul_rn, so that nvcc cannot contract it into the product that reads
// it).  Every product after the load is then the f32 kernel's, and a
// kernel's decoded value equals the plain version's bit for bit.
// mlp_update.cu's tensor-core products take the stored values as they are
// (bf16 and int8 q are exact in TF32) and apply int8's row scales to the
// products' rows (see its header).
//
// Each form has its own table of per-member base pointers, passed by
// value: the f32 table is the one K1/K2/K4/K6 have always taken, and the
// int8 table carries the scale pointers in a fifth array instead of
// widening it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// scales (none but int8's), and a load that decodes one element through
// the read-only path (__ldg).  `s` is the element's row scale; the f32 and
// bf16 forms ignore it.
struct SlabF32 {
  using Mem = Members;
  using T = float;
  static __device__ __forceinline__ const float* scales(const Mem&, int) {
    return nullptr;
  }
  static __device__ __forceinline__ float scale(const float*, int) {
    return 1.f;
  }
  static __device__ __forceinline__ float ldg(const T* p, float) {
    return __ldg(p);
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
  static __device__ __forceinline__ float ldg(const T* p, float) {
    return __bfloat162float(__ldg(p));
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
  static __device__ __forceinline__ float ldg(const T* p, float s) {
    return __fmul_rn(static_cast<float>(__ldg(p)), s);
  }
};

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
