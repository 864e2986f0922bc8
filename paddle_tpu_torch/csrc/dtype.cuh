// The dtype conversions every kernel of csrc/ shares: a load widens a
// float32 or bfloat16 element to fp32, and a store rounds fp32 to the
// output dtype to nearest even, as torch's cast does.  The kernels that
// agree with their plain PyTorch versions bit for bit (RoPE, RMSNorm in
// float32) rest on this one rounding rule.

#pragma once

#include <cuda_bf16.h>

namespace ptt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

}  // namespace ptt
