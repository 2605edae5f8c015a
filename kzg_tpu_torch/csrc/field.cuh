// Montgomery arithmetic over N little-endian 32-bit words, one field
// element per thread (shared by fr_kernels.cu and g1_kernels.cu).
//
// Fr: N = 8, R = 2^256.  Fp: N = 12, R = 2^384.  The same R as the JAX
// package's 16-bit limbs, so a value here is the same integer.
//
// Every operation returns a canonical value (< m): the port keeps no lazy
// bounds, so the final conditional subtract is always done. Products use
// CIOS (coarsely integrated operand scanning) with 64-bit accumulators:
// (2^32-1)^2 + 2(2^32-1) = 2^64-1, so no step overflows.
#pragma once
#include <cstdint>

namespace kzg {

template <int N>
struct Field;

// Moduli and n0 = -m^-1 mod 2^32 (the CIOS digit constant; not the
// full-width n' of the 16-bit engine).
template <>
struct Field<8> {
  static constexpr uint32_t n0 = 0xffffffffu;
  __device__ __forceinline__ static uint32_t m(int i) {
    constexpr uint32_t M[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu,
                               0x53bda402u, 0x09a1d805u, 0x3339d808u,
                               0x299d7d48u, 0x73eda753u};
    return M[i];
  }
};

template <>
struct Field<12> {
  static constexpr uint32_t n0 = 0xfffcfffdu;
  __device__ __forceinline__ static uint32_t m(int i) {
    constexpr uint32_t M[12] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu,
                                0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
                                0xf38512bfu, 0x64774b84u, 0x434bacd7u,
                                0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
    return M[i];
  }
};

// r = t - m if t >= m (or if a carry `hi` says t >= R), else t.
template <int N>
__device__ __forceinline__ void cond_sub(uint32_t r[N], const uint32_t t[N],
                                         uint32_t hi) {
  uint32_t d[N];
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    int64_t x = (int64_t)t[i] - Field<N>::m(i) + borrow;
    d[i] = (uint32_t)x;
    borrow = x >> 32;  // 0 or -1
  }
  const bool take = hi != 0 || borrow == 0;
#pragma unroll
  for (int i = 0; i < N; i++) r[i] = take ? d[i] : t[i];
}

template <int N>
__device__ __forceinline__ void add(uint32_t r[N], const uint32_t a[N],
                                    const uint32_t b[N]) {
  uint32_t s[N];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    c += (uint64_t)a[i] + b[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  cond_sub<N>(r, s, (uint32_t)c);
}

template <int N>
__device__ __forceinline__ void sub(uint32_t r[N], const uint32_t a[N],
                                    const uint32_t b[N]) {
  uint32_t d[N];
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    int64_t x = (int64_t)a[i] - b[i] + borrow;
    d[i] = (uint32_t)x;
    borrow = x >> 32;
  }
  const uint32_t mask = borrow ? 0xffffffffu : 0u;  // a < b: add m back
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    c += (uint64_t)d[i] + (Field<N>::m(i) & mask);
    r[i] = (uint32_t)c;
    c >>= 32;
  }
}

template <int N>
__device__ __forceinline__ void neg(uint32_t r[N], const uint32_t a[N]) {
  uint32_t z[N];
#pragma unroll
  for (int i = 0; i < N; i++) z[i] = 0;
  sub<N>(r, z, a);
}

// REDC(a*b) = a*b*R^-1 mod m, canonical. r may alias a or b.
template <int N>
__device__ __forceinline__ void mul(uint32_t r[N], const uint32_t a[N],
                                    const uint32_t b[N]) {
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      c = (uint64_t)a[j] * b[i] + t[j] + (c >> 32);
      t[j] = (uint32_t)c;
    }
    c = (uint64_t)t[N] + (c >> 32);
    t[N] = (uint32_t)c;
    t[N + 1] = (uint32_t)(c >> 32);
    const uint32_t q = t[0] * Field<N>::n0;
    c = (uint64_t)q * Field<N>::m(0) + t[0];
#pragma unroll
    for (int j = 1; j < N; j++) {
      c = (uint64_t)q * Field<N>::m(j) + t[j] + (c >> 32);
      t[j - 1] = (uint32_t)c;
    }
    c = (uint64_t)t[N] + (c >> 32);
    t[N - 1] = (uint32_t)c;
    t[N] = t[N + 1] + (uint32_t)(c >> 32);
  }
  cond_sub<N>(r, t, t[N]);
}

template <int N>
__device__ __forceinline__ bool is_zero(const uint32_t a[N]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < N; i++) acc |= a[i];
  return acc == 0;
}

template <int N>
__device__ __forceinline__ void copy(uint32_t r[N], const uint32_t a[N]) {
#pragma unroll
  for (int i = 0; i < N; i++) r[i] = a[i];
}

template <int N>
__device__ __forceinline__ void load(uint32_t r[N], const int32_t* p) {
#pragma unroll
  for (int i = 0; i < N; i++) r[i] = (uint32_t)p[i];
}

template <int N>
__device__ __forceinline__ void store(int32_t* p, const uint32_t a[N]) {
#pragma unroll
  for (int i = 0; i < N; i++) p[i] = (int32_t)a[i];
}

}  // namespace kzg
