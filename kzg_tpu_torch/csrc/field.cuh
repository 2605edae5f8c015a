// Montgomery arithmetic over N little-endian 32-bit words, one field
// element per thread (shared by fr_kernels.cu and the G1 kernels).
//
// Fr: N = 8, R = 2^256.  Fp: N = 12, R = 2^384.  The same R as the JAX
// package's 16-bit limbs, so a value here is the same integer.
//
// Every operation returns a canonical value (< m): the port keeps no lazy
// bounds, so the final conditional subtract is always done. The canonical
// Montgomery product is unique, so any correct schedule gives the same
// words. Products use CIOS (coarsely integrated operand scanning) on PTX
// carry chains, with the accumulator split in two (the even and the odd
// words' partial products, as in supranational's sppark): each row runs
// two independent chains of N multiply-adds for a * b_i, then two for
// q * m, so a product's dependent path is about half that of one
// accumulator. The shift by a word is folded into the next row. The
// running value t stays below (2^33 + 2) m < 2^(32N+32) for both moduli,
// which is why the odd half may drop its top carry (it is always 0).
// Add and sub are add.cc/sub.cc chains. Each PTX instruction is its own
// volatile asm statement: the compiler keeps their order, and nothing it
// emits between them touches the carry flag.
#pragma once
#include <cstdint>

namespace kzg {

template <int N>
struct Field;

// Moduli, n0 = -m^-1 mod 2^32 (the CIOS digit constant; not the
// full-width n' of the 16-bit engine) and one = R mod m.
template <>
struct Field<8> {
  static constexpr uint32_t n0 = 0xffffffffu;
  __device__ __forceinline__ static uint32_t m(int i) {
    constexpr uint32_t M[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu,
                               0x53bda402u, 0x09a1d805u, 0x3339d808u,
                               0x299d7d48u, 0x73eda753u};
    return M[i];
  }
  // R mod m: one in Montgomery form
  __device__ __forceinline__ static uint32_t one(int i) {
    constexpr uint32_t O[8] = {0xfffffffeu, 0x00000001u, 0x00034802u,
                               0x5884b7fau, 0xecbc4ff5u, 0x998c4fefu,
                               0xacc5056fu, 0x1824b159u};
    return O[i];
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
  __device__ __forceinline__ static uint32_t one(int i) {
    constexpr uint32_t O[12] = {0x0002fffdu, 0x76090000u, 0xc40c0002u,
                                0xebf4000bu, 0x53c758bau, 0x5f489857u,
                                0x70525745u, 0x77ce5853u, 0xa256ec6du,
                                0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
    return O[i];
  }
};

namespace ptx {

#define KZG_PTX2(name, op)                                              \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {    \
    uint32_t r;                                                         \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));         \
    return r;                                                           \
  }
#define KZG_PTX3(name, op)                                              \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,      \
                                           uint32_t c) {                \
    uint32_t r;                                                         \
    asm volatile(op " %0, %1, %2, %3;"                                  \
                 : "=r"(r) : "r"(a), "r"(b), "r"(c));                   \
    return r;                                                           \
  }
KZG_PTX2(add_cc, "add.cc.u32")
KZG_PTX2(addc_cc, "addc.cc.u32")
KZG_PTX2(addc, "addc.u32")
KZG_PTX2(sub_cc, "sub.cc.u32")
KZG_PTX2(subc_cc, "subc.cc.u32")
KZG_PTX2(subc, "subc.u32")
KZG_PTX3(mad_lo_cc, "mad.lo.cc.u32")
KZG_PTX3(madc_lo_cc, "madc.lo.cc.u32")
KZG_PTX3(mad_hi_cc, "mad.hi.cc.u32")
KZG_PTX3(madc_hi_cc, "madc.hi.cc.u32")
KZG_PTX3(madc_hi, "madc.hi.u32")
#undef KZG_PTX2
#undef KZG_PTX3

}  // namespace ptx

// r = t - m if t >= m (or if a carry `hi` says t >= R), else t.
template <int N>
__device__ __forceinline__ void cond_sub(uint32_t r[N], const uint32_t t[N],
                                         uint32_t hi) {
  uint32_t d[N];
  d[0] = ptx::sub_cc(t[0], Field<N>::m(0));
#pragma unroll
  for (int i = 1; i < N; i++) d[i] = ptx::subc_cc(t[i], Field<N>::m(i));
  const uint32_t borrow = ptx::subc(0, 0);  // 0, or ~0 if t < m
  const bool take = hi != 0 || borrow == 0;
#pragma unroll
  for (int i = 0; i < N; i++) r[i] = take ? d[i] : t[i];
}

template <int N>
__device__ __forceinline__ void add(uint32_t r[N], const uint32_t a[N],
                                    const uint32_t b[N]) {
  uint32_t s[N];
  s[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < N; i++) s[i] = ptx::addc_cc(a[i], b[i]);
  const uint32_t carry = ptx::addc(0, 0);
  cond_sub<N>(r, s, carry);
}

template <int N>
__device__ __forceinline__ void sub(uint32_t r[N], const uint32_t a[N],
                                    const uint32_t b[N]) {
  uint32_t d[N];
  d[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < N; i++) d[i] = ptx::subc_cc(a[i], b[i]);
  const uint32_t mask = ptx::subc(0, 0);  // a < b: add m back
  r[0] = ptx::add_cc(d[0], Field<N>::m(0) & mask);
#pragma unroll
  for (int i = 1; i < N - 1; i++)
    r[i] = ptx::addc_cc(d[i], Field<N>::m(i) & mask);
  r[N - 1] = ptx::addc(d[N - 1], Field<N>::m(N - 1) & mask);
}

template <int N>
__device__ __forceinline__ void neg(uint32_t r[N], const uint32_t a[N]) {
  uint32_t z[N];
#pragma unroll
  for (int i = 0; i < N; i++) z[i] = 0;
  sub<N>(r, z, a);
}

// acc[j], acc[j+1] += lo, hi of y[j + off] * x for even j < N: one fresh
// carry chain over acc; its carry-out is left in the flag.
template <int N>
__device__ __forceinline__ void cmad(uint32_t acc[N], const uint32_t y[N],
                                     int off, uint32_t x) {
  acc[0] = ptx::mad_lo_cc(y[off], x, acc[0]);
  acc[1] = ptx::madc_hi_cc(y[off], x, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = ptx::madc_lo_cc(y[j + off], x, acc[j]);
    acc[j + 1] = ptx::madc_hi_cc(y[j + off], x, acc[j + 1]);
  }
}

template <int N>
__device__ __forceinline__ void cmad_mod(uint32_t acc[N], int off,
                                         uint32_t q) {
  acc[0] = ptx::mad_lo_cc(Field<N>::m(off), q, acc[0]);
  acc[1] = ptx::madc_hi_cc(Field<N>::m(off), q, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = ptx::madc_lo_cc(Field<N>::m(j + off), q, acc[j]);
    acc[j + 1] = ptx::madc_hi_cc(Field<N>::m(j + off), q, acc[j + 1]);
  }
}

// One CIOS row on the split accumulator t = P + Q 2^32 (P holds the even
// words' partial products, Q the odd ones', one word up): t += a x, then
// t += q m with q = t[0] n0, so that P[0] = 0. The two chains of each
// step are independent. The shift by one word is left to the next row,
// which swaps the roles: there the old Q is the new P (P[0] += old P[1])
// and the old P, two words down, the new Q.
template <int N>
__device__ __forceinline__ void mul_row(uint32_t P[N], uint32_t Q[N],
                                        const uint32_t a[N], uint32_t x,
                                        bool first) {
  if (first) {
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      P[j] = a[j] * x;
      P[j + 1] = __umulhi(a[j], x);
      Q[j] = a[j + 1] * x;
      Q[j + 1] = __umulhi(a[j + 1], x);
    }
  } else {
    P[0] = ptx::add_cc(P[0], Q[1]);
#pragma unroll
    for (int j = 0; j < N - 2; j += 2) {
      Q[j] = ptx::madc_lo_cc(a[j + 1], x, Q[j + 2]);
      Q[j + 1] = ptx::madc_hi_cc(a[j + 1], x, Q[j + 3]);
    }
    Q[N - 2] = ptx::madc_lo_cc(a[N - 1], x, 0);
    Q[N - 1] = ptx::madc_hi(a[N - 1], x, 0);
    cmad<N>(P, a, 0, x);
    Q[N - 1] = ptx::addc(Q[N - 1], 0);
  }
  const uint32_t q = P[0] * Field<N>::n0;
  cmad_mod<N>(Q, 1, q);   // no carry-out: t stays below 2^(32N+32)
  cmad_mod<N>(P, 0, q);
  Q[N - 1] = ptx::addc(Q[N - 1], 0);
}

// REDC(a*b) = a*b*R^-1 mod m, canonical. r may alias a or b.
template <int N>
__device__ __forceinline__ void mul(uint32_t r[N], const uint32_t a[N],
                                    const uint32_t b[N]) {
  uint32_t E[N], O[N];
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    mul_row<N>(E, O, a, b[i], i == 0);
    mul_row<N>(O, E, a, b[i + 1], false);
  }
  // t = O / 2^32 + E (O[0] = 0): add the two halves
  uint32_t t[N];
  t[0] = ptx::add_cc(E[0], O[1]);
#pragma unroll
  for (int k = 1; k < N - 1; k++) t[k] = ptx::addc_cc(E[k], O[k + 1]);
  t[N - 1] = ptx::addc_cc(E[N - 1], 0);
  cond_sub<N>(r, t, ptx::addc(0, 0));
}

// REDC(t) = t R^-1 mod m for t < R, canonical: the product by the
// integer 1 without the N rows of a * b_i. N rows of t = (t + q m) / 2^32
// with q = t[0] n0, then one conditional subtract. t stays below R
// (t + q m < R + 2^32 m < 2^32 R), so each row's sum fits N + 1 words and
// the shift drops the zero low word.
template <int N>
__device__ __forceinline__ void from_mont(uint32_t t[N]) {
#pragma unroll
  for (int i = 0; i < N; i++) {
    const uint32_t q = t[0] * Field<N>::n0;
    uint32_t u[N + 1];
    u[0] = ptx::mad_lo_cc(q, Field<N>::m(0), t[0]);
#pragma unroll
    for (int j = 1; j < N; j++)
      u[j] = ptx::madc_lo_cc(q, Field<N>::m(j), t[j]);
    u[N] = ptx::addc(0, 0);
    u[1] = ptx::mad_hi_cc(q, Field<N>::m(0), u[1]);
#pragma unroll
    for (int j = 1; j < N - 1; j++)
      u[j + 1] = ptx::madc_hi_cc(q, Field<N>::m(j), u[j + 1]);
    u[N] = ptx::madc_hi(q, Field<N>::m(N - 1), u[N]);
#pragma unroll
    for (int j = 0; j < N; j++) t[j] = u[j + 1];
  }
  cond_sub<N>(t, t, 0);
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
