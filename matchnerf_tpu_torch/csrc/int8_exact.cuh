// int8 to f32 on the integer pipe, exact, with no int-to-float conversion
// instruction: the byte with its sign bit flipped (b + 128 as an unsigned
// byte) goes into the low byte of 0x4B000000 (8388608.0f, whose last
// mantissa bit is worth 1.0) by one byte permute, which makes the float
// 8388608 + 128 + b; subtracting 8388736.0f leaves b, for all 256 values.
// Kernel B (cosine_prior.cu) converts every tap this way, Kernel D
// (block_cosine_prior.cu) every staged table element once.
// tests/test_torch_cosine_prior.py emulates it in numpy over all 256 values.
#pragma once

// the four int8 of the little-endian word w, in order
__device__ __forceinline__ void int8x4_to_f32(unsigned int w, float* f) {
  const unsigned int x = w ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650u + b)) - 8388736.f;
}

// the same four values as bf16 bits, two to a word (low half first): an
// integer of at most 8 significant bits is exact in bf16, so the f32's upper
// half is the bf16
__device__ __forceinline__ uint2 int8x4_to_bf16x4(unsigned int w) {
  float f[4];
  int8x4_to_f32(w, f);
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u));
}
