// Device helpers shared by the port's CUDA kernels.
//
// log2_decode: one nibble of a packed 4-bit signed log2 weight code
// (quant/log2.py; even index in the low nibble) -> fp32 value:
//   q = sign-extended nibble, value = 0 for q == 0,
//   else sign(q) * 2^(1 - |q|) * scale.
// 2^(1-|q|) is built from its exponent bits, so the product with the scale
// is the exact value dequantize_log2 gives.  tcn_block.cu and log2_matmul.cu
// both decode with it.
#pragma once

#include <cstdint>

__device__ __forceinline__ float log2_decode(uint8_t byte, int hi, float scale) {
  int c = hi ? (byte >> 4) & 0xF : byte & 0xF;
  c = (c ^ 8) - 8;  // sign-extend the nibble
  if (c == 0) return 0.0f;
  int a = c < 0 ? -c : c;
  float mag = __int_as_float((128 - a) << 23);  // 2^(1 - a), a in 1..8
  float v = __fmul_rn(mag, scale);
  return c < 0 ? -v : v;
}

// ReLU that keeps NaN, as max(x, 0) does in the reference.
__device__ __forceinline__ float relu_f(float x) { return x < 0.0f ? 0.0f : x; }

// Value form of the u4 activation fake-quant: x + (q*s - x) with
// q = clip(round_half_even(x / s), 0, 15) — the reference's expression,
// operation for operation.
__device__ __forceinline__ float fake_quant_u4(float x, float s) {
  float q = fminf(fmaxf(rintf(__fdiv_rn(x, s)), 0.0f), 15.0f);
  return __fadd_rn(x, __fsub_rn(__fmul_rn(q, s), x));
}
