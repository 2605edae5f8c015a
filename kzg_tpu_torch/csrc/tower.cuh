// The Fp2/Fp6/Fp12 tower on field.cuh's Fp (mul<12>, add<12>, sub<12>),
// and the per-lane bodies of the pairing kernels (pairing_kernels.cu):
// the G2 ladder (K-a), the lines of the Miller loop on the twist and
// their evaluation (K-b), and the final exponentiation (K-c).
//
// Tower (curve/pairing.py): Fp2 = Fp[u]/(u^2 + 1), Fp6 = Fp2[v]/(v^3 - xi)
// with xi = 1 + u, Fp12 = Fp6[w]/(w^2 - v). Every value is canonical after
// every operation, so any correct formula gives the words of the plain
// versions (curve/pairing_kernels.py), which compute the same field
// elements on the redundant engine.
//
// Two layers. One thread a value: the Fp2 product and square, the Fp6
// product and inverse, the Fp12 inverse, the curve steps and the Fp
// inverse, out of line (__noinline__), one copy each, on values passed by
// pointer (they live in local memory): K-a, the lines and K-c's one
// inverse. A warp a value (below: f12_mul_g, f12_sqr_g, f12_mul_014_g,
// cyc_sqr_g, frob_g): K-b's evaluation and K-c, whose Fp12 values live in
// shared memory and whose Fp products, independent within each operation,
// are spread over the warp.
// Every one-thread operation computes into locals before it writes its
// result, so the result may alias an operand.
#pragma once
#include "field.cuh"

namespace kzg {

constexpr int NF = 12;  // Fp words

struct Fp2 {
  uint32_t c0[NF], c1[NF];
};
struct Fp6 {
  Fp2 c[3];
};
struct Fp12 {
  Fp6 c[2];
};

// ---- Fp ----
__device__ __forceinline__ void fp_set_one(uint32_t r[NF]) {
#pragma unroll
  for (int i = 0; i < NF; i++) r[i] = Field<NF>::one(i);
}

__device__ __forceinline__ void fp_set_zero(uint32_t r[NF]) {
#pragma unroll
  for (int i = 0; i < NF; i++) r[i] = 0;
}

// The inverse by the binary extended Euclid algorithm, then one product:
// for a = x R (Montgomery), u = a, v = p, x1 = 1, x2 = 0 keep x1 a = u
// and x2 a = v (mod p) while u and v shrink by halvings and subtractions
// (some 760 steps of 12-word shifts, compares and subtractions, no
// product; variable time, which a verifier of public data may take), so
// that x1 or x2 ends as a^-1 = x^-1 R^-1; its product by R^3 is x^-1 R.
// 0 -> 0. Replaces a^(p-2) (a chain of 484 products at 4-bit windows, 608
// bit by bit); the result is the same canonical words.
__device__ __forceinline__ bool raw_is_one(const uint32_t a[NF]) {
  uint32_t acc = a[0] ^ 1u;
#pragma unroll
  for (int i = 1; i < NF; i++) acc |= a[i];
  return acc == 0;
}

__device__ __forceinline__ void raw_shr1(uint32_t a[NF]) {
#pragma unroll
  for (int i = 0; i < NF - 1; i++) a[i] = (a[i] >> 1) | (a[i + 1] << 31);
  a[NF - 1] >>= 1;
}

// a >= b as integers
__device__ __forceinline__ bool raw_geq(const uint32_t a[NF],
                                        const uint32_t b[NF]) {
#pragma unroll 1
  for (int i = NF - 1; i >= 0; i--)
    if (a[i] != b[i]) return a[i] > b[i];
  return true;
}

// a -= b (a >= b)
__device__ __forceinline__ void raw_sub(uint32_t a[NF], const uint32_t b[NF]) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NF; i++) {
    const uint64_t d = (uint64_t)a[i] - b[i] - borrow;
    a[i] = (uint32_t)d;
    borrow = (d >> 32) & 1;
  }
}

// x / 2 mod p for x < p: (x + p) / 2 when x is odd (x + p < 2^382)
__device__ __forceinline__ void half_mod(uint32_t x[NF]) {
  if (x[0] & 1) {
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < NF; i++) {
      const uint64_t s = (uint64_t)x[i] + Field<NF>::m(i) + carry;
      x[i] = (uint32_t)s;
      carry = s >> 32;
    }
  }
  raw_shr1(x);
}

__device__ __noinline__ void fp_inv(uint32_t* r, const uint32_t* a) {
  // R^3 mod p, little-endian words
  constexpr uint32_t kR3[NF] = {0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u,
                                0x315f831eu, 0x615e29ddu, 0x9a53352au,
                                0x921e1761u, 0x34c04e5eu, 0x65724728u,
                                0x2512d435u, 0x91755d4du, 0x0aa63460u};
  uint32_t u[NF], v[NF], x1[NF], x2[NF];
  copy<NF>(u, a);
  if (is_zero<NF>(u)) {
    fp_set_zero(r);
    return;
  }
#pragma unroll
  for (int i = 0; i < NF; i++) {
    v[i] = Field<NF>::m(i);
    x1[i] = i == 0;
    x2[i] = 0;
  }
#pragma unroll 1
  while (!raw_is_one(u) && !raw_is_one(v)) {
#pragma unroll 1
    while (!(u[0] & 1)) {
      raw_shr1(u);
      half_mod(x1);
    }
#pragma unroll 1
    while (!(v[0] & 1)) {
      raw_shr1(v);
      half_mod(x2);
    }
    if (raw_geq(u, v)) {
      raw_sub(u, v);
      sub<NF>(x1, x1, x2);
    } else {
      raw_sub(v, u);
      sub<NF>(x2, x2, x1);
    }
  }
  uint32_t c[NF];
  copy<NF>(c, kR3);
  mul<NF>(r, raw_is_one(u) ? x1 : x2, c);
}

// ---- Fp2 (inline) ----
__device__ __forceinline__ void f2_add(Fp2& r, const Fp2& a, const Fp2& b) {
  add<NF>(r.c0, a.c0, b.c0);
  add<NF>(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void f2_sub(Fp2& r, const Fp2& a, const Fp2& b) {
  sub<NF>(r.c0, a.c0, b.c0);
  sub<NF>(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void f2_neg(Fp2& r, const Fp2& a) {
  neg<NF>(r.c0, a.c0);
  neg<NF>(r.c1, a.c1);
}

__device__ __forceinline__ void f2_dbl(Fp2& r, const Fp2& a) {
  f2_add(r, a, a);
}

// Karatsuba: 3 products. r may alias a or b.
__device__ __noinline__ void f2_mul(Fp2& r, const Fp2& a, const Fp2& b) {
  uint32_t t0[NF], t1[NF], s[NF], u[NF];
  mul<NF>(t0, a.c0, b.c0);
  mul<NF>(t1, a.c1, b.c1);
  add<NF>(s, a.c0, a.c1);
  add<NF>(u, b.c0, b.c1);
  mul<NF>(s, s, u);
  sub<NF>(s, s, t0);
  sub<NF>(r.c1, s, t1);
  sub<NF>(r.c0, t0, t1);
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 u: 2 products. r may alias a.
__device__ __noinline__ void f2_sqr(Fp2& r, const Fp2& a) {
  uint32_t s[NF], d[NF], t[NF];
  add<NF>(s, a.c0, a.c1);
  sub<NF>(d, a.c0, a.c1);
  mul<NF>(t, a.c0, a.c1);
  mul<NF>(r.c0, s, d);
  add<NF>(r.c1, t, t);
}

// a * xi = (a0 - a1) + (a0 + a1) u
__device__ __forceinline__ void f2_mul_xi(Fp2& r, const Fp2& a) {
  uint32_t t[NF];
  sub<NF>(t, a.c0, a.c1);
  add<NF>(r.c1, a.c0, a.c1);
  copy<NF>(r.c0, t);
}

__device__ __forceinline__ void f2_conj(Fp2& r, const Fp2& a) {
  copy<NF>(r.c0, a.c0);
  neg<NF>(r.c1, a.c1);
}

__device__ __forceinline__ void f2_mul_fp(Fp2& r, const Fp2& a,
                                          const uint32_t x[NF]) {
  mul<NF>(r.c0, a.c0, x);
  mul<NF>(r.c1, a.c1, x);
}

__device__ __forceinline__ void f2_set_zero(Fp2& r) {
  fp_set_zero(r.c0);
  fp_set_zero(r.c1);
}

__device__ __forceinline__ void f2_set_one(Fp2& r) {
  fp_set_one(r.c0);
  fp_set_zero(r.c1);
}

__device__ __forceinline__ bool f2_is_zero(const Fp2& a) {
  return is_zero<NF>(a.c0) && is_zero<NF>(a.c1);
}

// (a0 - a1 u) / (a0^2 + a1^2): one Fp inverse; 0 -> 0.
__device__ __noinline__ void f2_inv(Fp2* r, const Fp2* a) {
  uint32_t n[NF], t[NF];
  mul<NF>(n, a->c0, a->c0);
  mul<NF>(t, a->c1, a->c1);
  add<NF>(n, n, t);
  fp_inv(n, n);
  Fp2 c;
  f2_conj(c, *a);
  f2_mul_fp(*r, c, n);
}

// ---- Fp6 ----
__device__ __forceinline__ void f6_sub(Fp6& r, const Fp6& a, const Fp6& b) {
#pragma unroll
  for (int i = 0; i < 3; i++) f2_sub(r.c[i], a.c[i], b.c[i]);
}

__device__ __forceinline__ void f6_neg(Fp6& r, const Fp6& a) {
#pragma unroll
  for (int i = 0; i < 3; i++) f2_neg(r.c[i], a.c[i]);
}

// (c0, c1, c2) v = (xi c2, c0, c1). r may alias a.
__device__ __forceinline__ void f6_mul_v(Fp6& r, const Fp6& a) {
  Fp2 t;
  f2_mul_xi(t, a.c[2]);
  r.c[2] = a.c[1];
  r.c[1] = a.c[0];
  r.c[0] = t;
}

// pairing.F6.__mul__: 6 Fp2 products.
__device__ __noinline__ void f6_mul(Fp6* r, const Fp6* a, const Fp6* b) {
  Fp2 t0, t1, t2, s, u, c0, c1, c2;
  f2_mul(t0, a->c[0], b->c[0]);
  f2_mul(t1, a->c[1], b->c[1]);
  f2_mul(t2, a->c[2], b->c[2]);
  f2_add(s, a->c[1], a->c[2]);
  f2_add(u, b->c[1], b->c[2]);
  f2_mul(s, s, u);
  f2_sub(s, s, t1);
  f2_sub(s, s, t2);
  f2_mul_xi(s, s);
  f2_add(c0, s, t0);  // xi ((a1 + a2)(b1 + b2) - t1 - t2) + t0
  f2_add(s, a->c[0], a->c[1]);
  f2_add(u, b->c[0], b->c[1]);
  f2_mul(s, s, u);
  f2_sub(s, s, t0);
  f2_sub(s, s, t1);
  f2_mul_xi(u, t2);
  f2_add(c1, s, u);   // (a0 + a1)(b0 + b1) - t0 - t1 + xi t2
  f2_add(s, a->c[0], a->c[2]);
  f2_add(u, b->c[0], b->c[2]);
  f2_mul(s, s, u);
  f2_sub(s, s, t0);
  f2_sub(s, s, t2);
  f2_add(c2, s, t1);  // (a0 + a2)(b0 + b2) - t0 - t2 + t1
  r->c[0] = c0;
  r->c[1] = c1;
  r->c[2] = c2;
}

// pairing.F6.inv: one Fp2 inverse.
__device__ __noinline__ void f6_inv(Fp6* r, const Fp6* a) {
  const Fp2 &x = a->c[0], &y = a->c[1], &z = a->c[2];
  Fp2 t0, t1, t2, s, d;
  f2_sqr(t0, x);
  f2_mul(s, y, z);
  f2_mul_xi(s, s);
  f2_sub(t0, t0, s);   // x^2 - xi yz
  f2_sqr(t1, z);
  f2_mul_xi(t1, t1);
  f2_mul(s, x, y);
  f2_sub(t1, t1, s);   // xi z^2 - xy
  f2_sqr(t2, y);
  f2_mul(s, x, z);
  f2_sub(t2, t2, s);   // y^2 - xz
  f2_mul(d, z, t1);
  f2_mul(s, y, t2);
  f2_add(d, d, s);
  f2_mul_xi(d, d);
  f2_mul(s, x, t0);
  f2_add(d, d, s);     // x t0 + xi (z t1 + y t2)
  f2_inv(&d, &d);
  f2_mul(r->c[0], t0, d);
  f2_mul(r->c[1], t1, d);
  f2_mul(r->c[2], t2, d);
}

// ---- Fp12 ----
// pairing.F12.inv: (c0 - c1 w) / (c0^2 - v c1^2).
__device__ __noinline__ void f12_inv(Fp12* r, const Fp12* a) {
  Fp6 s, t;
  f6_mul(&s, &a->c[0], &a->c[0]);
  f6_mul(&t, &a->c[1], &a->c[1]);
  f6_mul_v(t, t);
  f6_sub(s, s, t);
  f6_inv(&s, &s);
  f6_mul(&t, &a->c[1], &s);
  f6_mul(&r->c[0], &a->c[0], &s);
  f6_neg(r->c[1], t);
}

// ---- the Miller loop on the twist E'(Fp2) ----
struct Jac2 {
  Fp2 x, y, z;
};

// 2T (dbl-2009-l) and the tangent line at T scaled by 2 Y Z^3:
// l0 = 3 X^3 - 2 Y^2, l1 = -3 X^2 Z^2, l4 = 2 Y Z^3; the line is
// l0 + (l1 xP) v + (l4 yP) v w.
__device__ __noinline__ void miller_dbl(Jac2* t, Fp2* l0, Fp2* l1, Fp2* l4) {
  Fp2 a, b, c, d, e, f, z2, yz, s;
  f2_sqr(a, t->x);
  f2_sqr(b, t->y);
  f2_sqr(z2, t->z);
  f2_mul(yz, t->y, t->z);
  f2_add(e, a, a);
  f2_add(e, e, a);           // E = 3A
  f2_sqr(c, b);              // C = B^2
  f2_add(s, t->x, b);
  f2_sqr(s, s);
  f2_sub(s, s, a);
  f2_sub(s, s, c);
  f2_dbl(d, s);              // D = 2((X + B)^2 - A - C)
  f2_sqr(f, e);              // F = E^2
  f2_mul(*l0, e, t->x);
  f2_dbl(s, b);
  f2_sub(*l0, *l0, s);       // l0 = E X - 2B
  f2_mul(*l1, e, z2);
  f2_neg(*l1, *l1);          // l1 = -E Z^2
  Fp2 x3, y3, z3;
  f2_dbl(z3, yz);            // Z3 = 2 Y Z
  f2_mul(*l4, z3, z2);       // l4 = Z3 Z^2
  f2_dbl(s, d);
  f2_sub(x3, f, s);          // X3 = F - 2D
  f2_sub(s, d, x3);
  f2_mul(y3, e, s);
  f2_dbl(c, c);
  f2_dbl(c, c);
  f2_dbl(c, c);
  f2_sub(y3, y3, c);         // Y3 = E (D - X3) - 8C
  t->x = x3;
  t->y = y3;
  t->z = z3;
}

// T + Q for affine Q (madd-2007-bl) and the chord line scaled by 2 Z1 H:
// l0 = r xq - yq Z3, l1 = -r, l4 = Z3 (r = 2 (S2 - Y1), Z3 = 2 Z1 H).
__device__ __noinline__ void miller_add(Jac2* t, const Fp2* xq,
                                        const Fp2* yq, Fp2* l0, Fp2* l1,
                                        Fp2* l4) {
  Fp2 z1z1, u2, z1c, h, s2, hh, i, r, j, v, s, x3, y3, z3;
  f2_sqr(z1z1, t->z);
  f2_mul(u2, *xq, z1z1);
  f2_mul(z1c, t->z, z1z1);
  f2_sub(h, u2, t->x);       // H = U2 - X1
  f2_mul(s2, *yq, z1c);
  f2_sqr(hh, h);
  f2_add(s, t->z, h);
  f2_sqr(s, s);
  f2_sub(s, s, z1z1);
  f2_sub(z3, s, hh);         // Z3 = (Z1 + H)^2 - Z1Z1 - HH
  f2_dbl(i, hh);
  f2_dbl(i, i);              // I = 4 HH
  f2_sub(r, s2, t->y);
  f2_dbl(r, r);              // r = 2 (S2 - Y1)
  f2_mul(j, h, i);
  f2_mul(v, t->x, i);
  f2_sqr(x3, r);
  f2_sub(x3, x3, j);
  f2_sub(x3, x3, v);
  f2_sub(x3, x3, v);         // X3 = r^2 - J - 2V
  f2_sub(s, v, x3);
  f2_mul(y3, r, s);
  f2_mul(s, t->y, j);
  f2_dbl(s, s);
  f2_sub(y3, y3, s);         // Y3 = r (V - X3) - 2 Y1 J
  f2_mul(*l0, r, *xq);
  f2_mul(s, *yq, z3);
  f2_sub(*l0, *l0, s);
  f2_neg(*l1, r);
  *l4 = z3;
  t->x = x3;
  t->y = y3;
  t->z = z3;
}

// |x| = 0xd201000000010000 below its leading bit, MSB first: the Miller
// loop's doublings (63) and additions (5), and the hard part's
// exponentiations by |x|
constexpr unsigned long long kMillerBits = 0xd201000000010000ull;
constexpr int kMillerTop = 63;
constexpr int kLines = 68;      // lines a G2 point: 63 doublings, 5 additions
constexpr int kLineWords = 6 * NF;   // (l0, l1, l4): 3 Fp2
// |c| = (|x| + 1)/3 (c = (x - 1)/3; x is negative), below its leading bit
constexpr unsigned long long kHardCBits = 0x460055555555aaabull;
constexpr int kHardCTop = 62;

// ---- the lines part of K-b: one thread a G2 point ----
// out: the point's kLines lines (l0, l1, l4) in the loop's order, the
// tangent at each doubling, then the chord at each addition.
__device__ __forceinline__ void lines_lane(int32_t* out, const Fp2& xq,
                                           const Fp2& yq) {
  Jac2 t;
  t.x = xq;
  t.y = yq;
  f2_set_one(t.z);
  Fp2 l[3];
#pragma unroll 1
  for (int b = kMillerTop - 1; b >= 0; b--) {
#pragma unroll 1
    for (int step = 0; step < 1 + ((kMillerBits >> b) & 1); step++) {
      if (step == 0) miller_dbl(&t, &l[0], &l[1], &l[2]);
      else miller_add(&t, &xq, &yq, &l[0], &l[1], &l[2]);
#pragma unroll 1
      for (int q = 0; q < 3; q++) {
        store<NF>(out + q * 2 * NF, l[q].c0);
        store<NF>(out + q * 2 * NF + NF, l[q].c1);
      }
      out += kLineWords;
    }
  }
}

// ---- a lane's Fp12 arithmetic on a group of threads ----
// A group is the kGroup = 32 threads of one warp, which hold one lane's
// Fp12 values in shared memory: slot s = 3 j + i (the coefficient of
// w^j v^i) at words 24 s (c0) and 24 s + 12 (c1), as in device memory.
// Every operation below is a few tiers; a tier hands its outputs out
// round-robin (output o to rank o mod kGroup) and ends in __syncwarp, so
// each thread reads only what an earlier tier wrote. The Fp products of
// an operation are independent once its operand sums are formed
// (Karatsuba tiers): f12_mul's 54, f12_sqr's 36, the sparse line
// product's 39 and the cyclotomic square's 18 each take
// ceil(count / kGroup) product latencies a thread (a full warp was
// faster than 8 or 16 threads a lane, PERF.md). The sums between are
// done in the tiers and repeated where that saves one. Any output may
// alias an input: inputs are read only in an operation's first tier.
// Branches on a lane's data are uniform across its warp. Values sit at
// 48-byte offsets, so each loads as three 128-bit shared loads without
// bank conflicts (a 13-word stride, tried, loaded word by word and was
// slower).
constexpr int kGroup = 32;
struct Grp {
  int rank;       // threadIdx.x % kGroup
  uint32_t* op;   // operand pairs, then Fp2 products: 18 x 48 words
  uint32_t* pr;   // Fp products: 54 x 12 words
  uint32_t* tt;   // tier values: 9 Fp2
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};
constexpr int kF12 = 12 * NF;                      // words of an Fp12
constexpr int kGrpWords = 18 * 48 + 54 * NF + 9 * 2 * NF;

// word offset of component c of Fp2 slot s
__device__ __forceinline__ int fw(int s, int c) { return 2 * NF * s + NF * c; }

// r = z.c of xi z = (z0 - z1) + (z0 + z1) u, for the Fp2 at z
__device__ __forceinline__ void xi_at(uint32_t r[NF], const uint32_t* z,
                                      int c) {
  uint32_t a[NF], b[NF];
  copy<NF>(a, z);
  copy<NF>(b, z + NF);
  if (c) add<NF>(r, a, b); else sub<NF>(r, a, b);
}

__device__ __forceinline__ void add_at(uint32_t r[NF], const uint32_t* p) {
  uint32_t t[NF];
  copy<NF>(t, p);
  add<NF>(r, r, t);
}

__device__ __forceinline__ void sub_at(uint32_t r[NF], const uint32_t* p) {
  uint32_t t[NF];
  copy<NF>(t, p);
  sub<NF>(r, r, t);
}

// The Fp2 products of n operand pairs: pair i's factors at g.op + 48 i
// and + 24 (sq: the square of the first); product i to res + 24 i (res
// may be g.op). Karatsuba's 3 Fp products a pair, a square's 2
// ((a0 + a1)(a0 - a1) and a0 a1), spread over the group.
__device__ __noinline__ void f2_mul_batch(uint32_t* res, int n, bool sq,
                                          Grp g) {
  const int per = sq ? 2 : 3;
  // operands without a branch on k: every thread forms both sums and
  // selects (1-4 % faster than branching, PERF.md)
#pragma unroll 1
  for (int p = g.rank; p < per * n; p += kGroup) {
    const int i = p / per, k = p - i * per;
    const uint32_t* L = g.op + 48 * i;
    const uint32_t* R = sq ? L : L + 2 * NF;
    uint32_t x[NF], y[NF], u[NF], v[NF];
    const int hi = k == 1 && !sq ? NF : 0;
    copy<NF>(x, L + hi);
    copy<NF>(u, L + NF);
    copy<NF>(y, R + hi);
    copy<NF>(v, R + NF);
    // sq: (a0 + a1)(a0 - a1) for k = 0, a0 a1 for k = 1;
    // else a0 b0, a1 b1, (a0 + a1)(b0 + b1)
    const bool sum = sq ? k == 0 : k == 2;
    uint32_t s[NF], d[NF];
    add<NF>(s, x, u);
    if (sq) sub<NF>(d, x, u); else add<NF>(d, y, v);
#pragma unroll
    for (int w = 0; w < NF; w++) {
      x[w] = sum ? s[w] : x[w];
      y[w] = sum ? d[w] : (sq ? u[w] : y[w]);
    }
    mul<NF>(x, x, y);
    copy<NF>(g.pr + NF * p, x);
  }
  g.sync();
#pragma unroll 1
  for (int o = g.rank; o < 2 * n; o += kGroup) {
    const int i = o >> 1, c = o & 1;
    const uint32_t* t = g.pr + NF * per * i;
    uint32_t v[NF], w[NF];
    if (sq) {                            // (a0^2 - a1^2, 2 a0 a1)
      copy<NF>(v, t + c * NF);
      add<NF>(w, v, v);
    } else {                             // (t0 - t1, t2 - t0 - t1)
      copy<NF>(v, t + (c ? 2 : 0) * NF);
      sub_at(v, t + NF);
      copy<NF>(w, v);
      sub_at(w, t);
    }
#pragma unroll
    for (int k = 0; k < NF; k++) v[k] = c ? w[k] : v[k];
    copy<NF>(res + 2 * NF * i + NF * c, v);
  }
  g.sync();
}

// The Fp6 products x[k] y[k] (k < K <= 3) to t + 72 k (not g.op):
// pairing.F6.__mul__'s 6 Fp2 products each (Karatsuba).
__device__ __noinline__ void f6_mul_batch(uint32_t* t, const uint32_t* x0,
                                          const uint32_t* y0,
                                          const uint32_t* x1,
                                          const uint32_t* y1,
                                          const uint32_t* x2,
                                          const uint32_t* y2, int K, Grp g) {
  // pair 6 k + j: (a_j, b_j) for j < 3, then (a1 + a2, ..), (a0 + a1, ..),
  // (a0 + a2, ..)
#pragma unroll 1
  for (int v = g.rank; v < 24 * K; v += kGroup) {
    const int pair = v >> 2, side = (v >> 1) & 1, c = v & 1;
    const int k = pair / 6, j = pair - 6 * (pair / 6);
    const uint32_t* src = side ? (k == 0 ? y0 : k == 1 ? y1 : y2)
                               : (k == 0 ? x0 : k == 1 ? x1 : x2);
    const int i0 = j < 3 ? j : (j == 3 ? 1 : 0);
    uint32_t a[NF];
    copy<NF>(a, src + fw(i0, c));
    if (j >= 3) add_at(a, src + fw(j == 4 ? 1 : 2, c));
    copy<NF>(g.op + 48 * pair + 2 * NF * side + NF * c, a);
  }
  g.sync();
  f2_mul_batch(g.op, 6 * K, false, g);
  // T0 = xi (m3 - m1 - m2) + m0, T1 = m4 - m0 - m1 + xi m2,
  // T2 = m5 - m0 - m2 + m1
#pragma unroll 1
  for (int v = g.rank; v < 6 * K; v += kGroup) {
    const int k = v / 6, q = (v >> 1) % 3, c = v & 1;
    const uint32_t* m = g.op + 6 * 2 * NF * k;
    uint32_t r[NF];
    if (q == 0) {
      uint32_t s1[NF];
      copy<NF>(r, m + fw(3, 0));
      sub_at(r, m + fw(1, 0));
      sub_at(r, m + fw(2, 0));
      copy<NF>(s1, m + fw(3, 1));
      sub_at(s1, m + fw(1, 1));
      sub_at(s1, m + fw(2, 1));
      if (c) add<NF>(r, r, s1); else sub<NF>(r, r, s1);
      add_at(r, m + fw(0, c));
    } else if (q == 1) {
      xi_at(r, m + fw(2, 0), c);
      add_at(r, m + fw(4, c));
      sub_at(r, m + fw(0, c));
      sub_at(r, m + fw(1, c));
    } else {
      copy<NF>(r, m + fw(5, c));
      sub_at(r, m + fw(0, c));
      sub_at(r, m + fw(2, c));
      add_at(r, m + fw(1, c));
    }
    copy<NF>(t + 3 * 2 * NF * k + fw(q, c), r);
  }
  g.sync();
}

// out = a b (Karatsuba over Fp6: a0 b0, a1 b1, (a0 + a1)(b0 + b1)).
__device__ __noinline__ void f12_mul_g(uint32_t* out, const uint32_t* a,
                                       const uint32_t* b, Grp g) {
#pragma unroll 1
  for (int v = g.rank; v < 12; v += kGroup) {
    const uint32_t* src = v < 6 ? a : b;
    const int w = (v % 6) * NF;
    uint32_t r[NF];
    copy<NF>(r, src + w);
    add_at(r, src + 6 * NF + w);
    copy<NF>(g.tt + (v < 6 ? 0 : 6 * NF) + w, r);
  }
  g.sync();
  f6_mul_batch(g.tt, a, b, a + 6 * NF, b + 6 * NF, g.tt, g.tt + 6 * NF, 3,
               g);
  // out0 = t0 + v t1 = (t0_0 + xi t1_2, t0_1 + t1_0, t0_2 + t1_1),
  // out1 = tm - t0 - t1
  const uint32_t *t0 = g.tt, *t1 = g.tt + 6 * NF, *tm = g.tt + 12 * NF;
#pragma unroll 1
  for (int v = g.rank; v < 12; v += kGroup) {
    const int s = v >> 1, c = v & 1, i = s % 3;
    uint32_t r[NF];
    if (s < 3) {
      if (i == 0) xi_at(r, t1 + fw(2, 0), c);
      else copy<NF>(r, t1 + fw(i - 1, c));
      add_at(r, t0 + fw(i, c));
    } else {
      copy<NF>(r, tm + fw(i, c));
      sub_at(r, t0 + fw(i, c));
      sub_at(r, t1 + fw(i, c));
    }
    copy<NF>(out + fw(s, c), r);
  }
  g.sync();
}

// out = a^2 = (a0^2 + v a1^2) + 2 a0 a1 w from the Fp6 products a0 a1 and
// (a0 + a1)(a0 + v a1) (the Miller loop's squaring).
__device__ __noinline__ void f12_sqr_g(uint32_t* out, const uint32_t* a,
                                       Grp g) {
  // g.tt: s = a0 + a1 at 0, u = a0 + v a1 at 72 (v a1 = (xi a1_2, a1_0,
  // a1_1))
#pragma unroll 1
  for (int v = g.rank; v < 12; v += kGroup) {
    const int s = (v % 6) >> 1, c = v & 1;
    uint32_t r[NF];
    if (v < 6) copy<NF>(r, a + fw(3 + s, c));
    else if (s == 0) xi_at(r, a + fw(5, 0), c);
    else copy<NF>(r, a + fw(2 + s, c));
    add_at(r, a + fw(s, c));
    copy<NF>(g.tt + (v < 6 ? 0 : 6 * NF) + fw(s, c), r);
  }
  g.sync();
  f6_mul_batch(g.tt, a, a + 6 * NF, g.tt, g.tt + 6 * NF, nullptr, nullptr,
               2, g);
  // out0 = q - ab - v ab, out1 = 2 ab
  const uint32_t *ab = g.tt, *q = g.tt + 6 * NF;
#pragma unroll 1
  for (int v = g.rank; v < 12; v += kGroup) {
    const int s = v >> 1, c = v & 1, i = s % 3;
    uint32_t r[NF];
    if (s < 3) {
      uint32_t t[NF];
      copy<NF>(r, q + fw(i, c));
      sub_at(r, ab + fw(i, c));
      if (i == 0) xi_at(t, ab + fw(2, 0), c);
      else copy<NF>(t, ab + fw(i - 1, c));
      sub<NF>(r, r, t);
    } else {
      copy<NF>(r, ab + fw(i, c));
      add<NF>(r, r, r);
    }
    copy<NF>(out + fw(s, c), r);
  }
  g.sync();
}

// out = f (l0 + l1 v + l4 v w), the line (l0, l1, l4) at l: with
// A = l0 + l1 v, B = l4 v, aa = f0 A (5 Fp2 products), bb = f1 B (3), and
// s = (f0 + f1)(l0 + (l1 + l4) v) (5): out = (aa + v bb) + (s - aa - bb) w.
__device__ __noinline__ void f12_mul_014_g(uint32_t* out, const uint32_t* f,
                                           const uint32_t* l, Grp g) {
  // the 13 pairs: left as a mask of f's slots, right of the line's
  constexpr unsigned char kLeft[13] = {0x01, 0x02, 0x03, 0x04, 0x04,
                                       0x20, 0x08, 0x10, 0x09, 0x12,
                                       0x1b, 0x24, 0x24};
  constexpr unsigned char kRight[13] = {1, 2, 3, 2, 1, 4, 4, 4,
                                        1, 6, 7, 6, 1};
#pragma unroll 1
  for (int v = g.rank; v < 52; v += kGroup) {
    const int pair = v >> 2, side = (v >> 1) & 1, c = v & 1;
    const int mask = side ? kRight[pair] : kLeft[pair];
    const uint32_t* src = side ? l : f;
    uint32_t r[NF];
    bool first = true;
#pragma unroll 1
    for (int b = 0; b < 6; b++) {
      if (!((mask >> b) & 1)) continue;
      if (first) copy<NF>(r, src + fw(b, c)); else add_at(r, src + fw(b, c));
      first = false;
    }
    copy<NF>(g.op + 48 * pair + 2 * NF * side + NF * c, r);
  }
  g.sync();
  f2_mul_batch(g.op, 13, false, g);
  // g.tt: aa (slots 0-2), bb (3-5), s (6-8)
  //   aa = (m0 + xi m3, m2 - m0 - m1, m1 + m4), bb = (xi m5, m6, m7),
  //   s = (m8 + xi m11, m10 - m8 - m9, m9 + m12)
  const uint32_t* m = g.op;
#pragma unroll 1
  for (int v = g.rank; v < 18; v += kGroup) {
    const int s = v >> 1, c = v & 1, q = s % 3;
    const int base = s < 3 ? 0 : 8;      // aa from m0, s from m8
    uint32_t r[NF];
    if (s >= 3 && s < 6) {
      if (q == 0) xi_at(r, m + fw(5, 0), c);
      else copy<NF>(r, m + fw(5 + q, c));
    } else if (q == 0) {
      xi_at(r, m + fw(base + 3, 0), c);
      add_at(r, m + fw(base, c));
    } else if (q == 1) {
      copy<NF>(r, m + fw(base + 2, c));
      sub_at(r, m + fw(base, c));
      sub_at(r, m + fw(base + 1, c));
    } else {
      copy<NF>(r, m + fw(base + 1, c));
      add_at(r, m + fw(base + 4, c));
    }
    copy<NF>(g.tt + fw(s, c), r);
  }
  g.sync();
  const uint32_t *aa = g.tt, *bb = g.tt + 6 * NF, *ss = g.tt + 12 * NF;
#pragma unroll 1
  for (int v = g.rank; v < 12; v += kGroup) {
    const int s = v >> 1, c = v & 1, i = s % 3;
    uint32_t r[NF];
    if (s < 3) {
      if (i == 0) xi_at(r, bb + fw(2, 0), c);
      else copy<NF>(r, bb + fw(i - 1, c));
      add_at(r, aa + fw(i, c));
    } else {
      copy<NF>(r, ss + fw(i, c));
      sub_at(r, aa + fw(i, c));
      sub_at(r, bb + fw(i, c));
    }
    copy<NF>(out + fw(s, c), r);
  }
  g.sync();
}

// out = a^2 for a in the cyclotomic subgroup (Granger-Scott): three Fp4
// squarings of (z0, z1) = slots (0, 4), (z2, z3) = (3, 2),
// (z4, z5) = (1, 5), each from the Fp2 squares of its two halves and
// their sum: 9 Fp2 squares, 18 Fp products. With (c0, c1) the Fp4 square
// of a pair, (xi t1 + t0, t2 - t0 - t1): slot 0 = 3 A.c0 - 2 z0,
// 4 = 3 A.c1 + 2 z1, 1 = 3 B.c0 - 2 z4, 5 = 3 B.c1 + 2 z5,
// 3 = 3 xi C.c1 + 2 z2, 2 = 3 C.c0 - 2 z3 (A, B, C the three pairs).
__device__ __noinline__ void cyc_sqr_g(uint32_t* out, const uint32_t* a,
                                       Grp g) {
  constexpr unsigned char kHalf[6] = {0, 4, 3, 2, 1, 5};
#pragma unroll 1
  for (int v = g.rank; v < 18; v += kGroup) {
    const int i = v >> 1, c = v & 1, p = i / 3, w = i % 3;
    uint32_t r[NF];
    copy<NF>(r, a + fw(kHalf[2 * p + (w == 1)], c));
    if (w == 2) add_at(r, a + fw(kHalf[2 * p + 1], c));
    copy<NF>(g.op + 48 * i + NF * c, r);
  }
  g.sync();
  f2_mul_batch(g.op, 9, true, g);
  // slot s: its pair, which half of the Fp4 square, its sign
  constexpr unsigned char kPair[6] = {0, 1, 2, 2, 0, 1};
  constexpr unsigned char kHi[6] = {0, 0, 0, 1, 1, 1};
#pragma unroll 1
  for (int v = g.rank; v < 12; v += kGroup) {
    const int s = v >> 1, c = v & 1;
    const uint32_t* t = g.op + 3 * 2 * NF * kPair[s];
    uint32_t r[NF];
#pragma unroll 1
    for (int h = 0; h < (s == 3 ? 2 : 1); h++) {
      const int cc = s == 3 ? h : c;     // slot 3 needs both of C.c1
      uint32_t e[NF];
      if (kHi[s]) {                       // t2 - t0 - t1
        copy<NF>(e, t + fw(2, cc));
        sub_at(e, t + fw(0, cc));
        sub_at(e, t + fw(1, cc));
      } else {                            // xi t1 + t0
        xi_at(e, t + fw(1, 0), cc);
        add_at(e, t + fw(0, cc));
      }
      if (h == 0) copy<NF>(r, e);
      else if (c) add<NF>(r, r, e);      // xi (r + e u)
      else sub<NF>(r, r, e);
    }
    uint32_t z[NF], u[NF];
    copy<NF>(u, r);
    add<NF>(r, r, r);
    add<NF>(r, r, u);                     // 3 c
    copy<NF>(z, a + fw(s, c));
    add<NF>(z, z, z);
    if (s >= 3) add<NF>(r, r, z); else sub<NF>(r, r, z);
    copy<NF>(out + fw(s, c), r);
  }
  g.sync();
}

// out = a^(p^k): each slot conjugated for odd k, then times its gamma
// (gam: the 6 gammas of this k as Montgomery words, slot s at 24 s).
__device__ __noinline__ void frob_g(uint32_t* out, const uint32_t* a,
                                    const int32_t* gam, bool odd, Grp g) {
#pragma unroll 1
  for (int v = g.rank; v < 24; v += kGroup) {
    const int s = v >> 2, side = (v >> 1) & 1, c = v & 1;
    uint32_t r[NF];
    if (side) {
      load<NF>(r, gam + fw(s, c));
    } else {
      copy<NF>(r, a + fw(s, c));
      if (odd && c) neg<NF>(r, r);
    }
    copy<NF>(g.op + 48 * s + 2 * NF * side + NF * c, r);
  }
  g.sync();
  f2_mul_batch(out, 6, false, g);
}

// out = conj(a) (the p^6 Frobenius: c1 negated)
__device__ __noinline__ void conj_g(uint32_t* out, const uint32_t* a, Grp g) {
#pragma unroll 1
  for (int v = g.rank; v < 12; v += kGroup) {
    uint32_t r[NF];
    copy<NF>(r, a + NF * v);
    if (v >= 6) neg<NF>(r, r);
    copy<NF>(out + NF * v, r);
  }
  g.sync();
}

__device__ __noinline__ void copy_g(uint32_t* out, const uint32_t* a, Grp g) {
#pragma unroll 1
  for (int w = g.rank; w < kF12; w += kGroup) out[w] = a[w];
  g.sync();
}

// out = m^e for m in the cyclotomic subgroup, e's bits below its leading
// one MSB first (out not m)
__device__ __noinline__ void cyc_pow_g(uint32_t* out, const uint32_t* m,
                                       unsigned long long bits, int top,
                                       Grp g) {
  copy_g(out, m, g);
#pragma unroll 1
  for (int b = top - 1; b >= 0; b--) {
    cyc_sqr_g(out, out, g);
    if ((bits >> b) & 1) f12_mul_g(out, out, m, g);
  }
}

// One lane of K-b's evaluation: pairs k = 0, 1 of a Jacobian G1 point
// P = (X, Y, Z) and the lines of its G2 point (kLines x kLineWords words
// each). The line is evaluated at P scaled by Z^3, an Fp factor that the
// final exponentiation removes: l0 Z^3 + (l1 X Z) v + (l4 Y) v w, so no
// inverse is taken. skip[k]: a pair with a point at infinity contributes
// 1. f = conj(prod_k f_{|x|,Qk}(Pk)) (x < 0) in s[0, 144); s holds
// 144 + 144 + 72 words (f, the evaluated lines, Z^3, X Z, Y of each pair).
__device__ __forceinline__ void miller_eval_lane(
    uint32_t* s, const int32_t* const* X, const int32_t* const* Y,
    const int32_t* const* Z, const int32_t* const* lines, const bool* skip,
    Grp g) {
  uint32_t *f = s, *L = s + kF12, *E = s + 2 * kF12;
  // E[k] = (Z^2 -> Z^3, X Z, Y)
#pragma unroll 1
  for (int v = g.rank; v < 6; v += kGroup) {
    const int k = v / 3, q = v % 3;
    uint32_t a[NF], b[NF];
    load<NF>(a, (q == 2 ? Y : q == 1 ? X : Z)[k]);
    if (q < 2) {
      load<NF>(b, Z[k]);
      mul<NF>(a, a, b);
    }
    copy<NF>(E + 3 * NF * k + NF * q, a);
  }
  g.sync();
#pragma unroll 1
  for (int k = g.rank; k < 2; k += kGroup) {
    uint32_t a[NF], b[NF];
    copy<NF>(a, E + 3 * NF * k);
    load<NF>(b, Z[k]);
    mul<NF>(a, a, b);
    copy<NF>(E + 3 * NF * k, a);
  }
#pragma unroll 1
  for (int w = g.rank; w < kF12; w += kGroup)
    f[w] = w < NF ? Field<NF>::one(w) : 0;
  g.sync();
  int idx = 0;
#pragma unroll 1
  for (int b = kMillerTop - 1; b >= 0; b--) {
    f12_sqr_g(f, f, g);
#pragma unroll 1
    for (int step = 0; step < 1 + ((kMillerBits >> b) & 1); step++) {
      // both pairs' lines at P: 12 Fp products
#pragma unroll 1
      for (int v = g.rank; v < 12; v += kGroup) {
        const int k = v / 6, w = v % 6;   // w = 2 q + c
        uint32_t a[NF], e[NF];
        load<NF>(a, lines[k] + idx * kLineWords + NF * w);
        copy<NF>(e, E + 3 * NF * k + NF * (w >> 1));
        mul<NF>(a, a, e);
        copy<NF>(L + 6 * NF * k + NF * w, a);
      }
      g.sync();
#pragma unroll 1
      for (int k = 0; k < 2; k++)
        if (!skip[k]) f12_mul_014_g(f, f, L + 6 * NF * k, g);
      idx++;
    }
  }
  conj_g(f, f, g);
}

// One lane of K-c: out = f^((p^12 - 1)/r) in s[0, 144) (s holds 4 Fp12).
// gam: the gammas of p^1, p^2, p^3 (6 Fp2 each). The easy part
// conj(f) f^-1, then ^(p^2 + 1); the hard part (p^4 - p^2 + 1)/r
// = c (x - 1)(x + p)(x^2 + p^2 - 1) + 1 with c = (x - 1)/3 (exactly the
// reference's exponent): a = m^c, b = a^(x-1), e = b^(x+p),
// out = e^(x^2 + p^2 - 1) m, every power of x by |x| and a conjugation.
// The one inverse (f12_inv, its Fp inverse by the binary extended Euclid
// algorithm) runs in every thread of the group (the same instructions;
// rank 0 stores it).
__device__ __forceinline__ void final_exp_lane(uint32_t* s, const int32_t* f,
                                               const int32_t* gam, Grp g) {
  constexpr int G = 6 * 2 * NF;  // words of one k's gammas
  uint32_t *R = s, *M = s + kF12, *A = s + 2 * kF12, *B = s + 3 * kF12;
#pragma unroll 1
  for (int w = g.rank; w < kF12; w += kGroup) A[w] = (uint32_t)f[w];
  {
    Fp12 x, t;
    uint32_t* xw = &x.c[0].c[0].c0[0];
#pragma unroll 1
    for (int w = 0; w < kF12; w++) xw[w] = (uint32_t)f[w];
    f12_inv(&t, &x);
    const uint32_t* tw = &t.c[0].c[0].c0[0];
    if (g.rank == 0) {
#pragma unroll 1
      for (int w = 0; w < kF12; w++) B[w] = tw[w];
    }
  }
  g.sync();
  conj_g(A, A, g);
  f12_mul_g(A, A, B, g);                     // t = f^(p^6 - 1)
  frob_g(B, A, gam + G, false, g);
  f12_mul_g(M, B, A, g);                     // m = t^(p^2 + 1)
  cyc_pow_g(A, M, kHardCBits, kHardCTop, g);
  conj_g(A, A, g);                           // a = m^c
  cyc_pow_g(B, A, kMillerBits, kMillerTop, g);
  conj_g(B, B, g);
  conj_g(R, A, g);
  f12_mul_g(B, B, R, g);                     // b = a^x a^-1
  cyc_pow_g(A, B, kMillerBits, kMillerTop, g);
  conj_g(A, A, g);
  frob_g(R, B, gam, true, g);
  f12_mul_g(A, A, R, g);                     // e = b^x b^p
  cyc_pow_g(B, A, kMillerBits, kMillerTop, g);
  cyc_pow_g(R, B, kMillerBits, kMillerTop, g);  // e^(x^2)
  frob_g(B, A, gam + G, false, g);
  f12_mul_g(R, R, B, g);
  conj_g(B, A, g);
  f12_mul_g(R, R, B, g);                     // e^(x^2 + p^2 - 1)
  f12_mul_g(R, R, M, g);
}

// ---- K-a: the G2 ladder (K3's, csrc/g1.cuh, over Fp2) ----
struct Proj2 {
  Fp2 x, y, z;
};
constexpr int P2W = 6 * NF;     // words of one projective G2 point
constexpr int T2W = 8 * P2W;    // words of one [1..8]Q table (2,304 bytes)

// 3 b' x = 12 (1 + u) x
__device__ __forceinline__ void g2_b3(Fp2& r, const Fp2& x) {
  Fp2 t, t4;
  f2_mul_xi(t, x);
  f2_dbl(t, t);
  f2_dbl(t4, t);    // 4 xi x
  f2_dbl(t, t4);    // 8 xi x
  f2_add(r, t, t4);
}

// RCB15 Algorithm 7 (a = 0). out may alias p or q.
__device__ __noinline__ void proj2_add(Proj2* out, const Proj2* p,
                                       const Proj2* q) {
  Fp2 t0, t1, t2, t3, t4, x3, y3, z3, s;
  f2_mul(t0, p->x, q->x);
  f2_mul(t1, p->y, q->y);
  f2_mul(t2, p->z, q->z);
  f2_add(t3, p->x, p->y);
  f2_add(s, q->x, q->y);
  f2_mul(t3, t3, s);
  f2_add(s, t0, t1);
  f2_sub(t3, t3, s);
  f2_add(t4, p->y, p->z);
  f2_add(s, q->y, q->z);
  f2_mul(t4, t4, s);
  f2_add(s, t1, t2);
  f2_sub(t4, t4, s);
  f2_add(y3, p->x, p->z);
  f2_add(s, q->x, q->z);
  f2_mul(y3, y3, s);
  f2_add(s, t0, t2);
  f2_sub(y3, y3, s);
  f2_dbl(s, t0);
  f2_add(t0, s, t0);
  g2_b3(t2, t2);
  f2_add(z3, t1, t2);
  f2_sub(t1, t1, t2);
  g2_b3(y3, y3);
  f2_mul(x3, t4, y3);
  f2_mul(s, t3, t1);
  f2_sub(x3, s, x3);
  f2_mul(y3, y3, t0);
  f2_mul(t1, t1, z3);
  f2_add(y3, t1, y3);
  f2_mul(t0, t0, t3);
  f2_mul(z3, z3, t4);
  f2_add(z3, z3, t0);
  out->x = x3;
  out->y = y3;
  out->z = z3;
}

// RCB15 Algorithm 9 (a = 0). out may alias p.
__device__ __noinline__ void proj2_double(Proj2* out, const Proj2* p) {
  Fp2 t0, t1, t2, x3, y3, z3, s;
  f2_sqr(t0, p->y);
  f2_dbl(z3, t0);
  f2_dbl(z3, z3);
  f2_dbl(z3, z3);
  f2_mul(t1, p->y, p->z);
  f2_sqr(t2, p->z);
  g2_b3(t2, t2);
  f2_mul(x3, t2, z3);
  f2_add(y3, t0, t2);
  f2_mul(z3, t1, z3);
  f2_dbl(t1, t2);
  f2_add(t2, t1, t2);
  f2_sub(t0, t0, t2);
  f2_mul(y3, t0, y3);
  f2_add(y3, x3, y3);
  f2_mul(t1, p->x, p->y);
  f2_mul(x3, t0, t1);
  f2_dbl(x3, x3);
  out->x = x3;
  out->y = y3;
  out->z = z3;
}

// Point words at base[i * stride], i < P2W: x (c0, c1), y, z.
__device__ __forceinline__ void load_proj2(Proj2& r, const uint32_t* base,
                                           int stride) {
  uint32_t* w = &r.x.c0[0];
#pragma unroll 1
  for (int i = 0; i < P2W; i++) w[i] = base[i * stride];
}

__device__ __forceinline__ void store_proj2(uint32_t* base, int stride,
                                            const Proj2& p) {
  const uint32_t* w = &p.x.c0[0];
#pragma unroll 1
  for (int i = 0; i < P2W; i++) base[i * stride] = w[i];
}

// A lane's [1..8]Q table: word w of entry k at base[(k * P2W + w) stride].
struct Table2 {
  uint32_t* base;
  int stride;
  __device__ __forceinline__ uint32_t* entry(int k) const {
    return base + k * P2W * stride;
  }
};

// Jacobian (X, Y, Z) -> projective (XZ : Y : Z^3); Z = 0 -> (0 : 1 : 0).
__device__ __forceinline__ void jac2_to_proj(Proj2& r, const Fp2& x,
                                             const Fp2& y, const Fp2& z) {
  Fp2 zz;
  f2_mul(r.x, x, z);
  f2_sqr(zz, z);
  f2_mul(r.z, zz, z);
  if (f2_is_zero(z)) f2_set_one(r.y); else r.y = y;
}

// One lane of K-a: acc = sum_j d_j 16^j Q (d LSB first, in [-8, 8]),
// K3's Horner ladder: windows above the top nonzero digit are skipped
// (acc is the identity there, whose doubles are its own words).
__device__ __forceinline__ void g2_ladder_lane(Proj2& acc, const Table2& tbl,
                                               const Proj2& q,
                                               const int32_t* d,
                                               int n_windows) {
  Proj2 s = q;
  store_proj2(tbl.entry(0), tbl.stride, q);
#pragma unroll 1
  for (int k = 1; k < 8; k++) {
    proj2_add(&s, &s, &q);
    store_proj2(tbl.entry(k), tbl.stride, s);
  }
  f2_set_zero(acc.x);
  f2_set_one(acc.y);
  f2_set_zero(acc.z);
  int top = n_windows - 1;
  while (top >= 0 && d[top] == 0) top--;
#pragma unroll 1
  for (int w = top; w >= 0; w--) {
    if (w != top) {
#pragma unroll 1
      for (int k = 0; k < 4; k++) proj2_double(&acc, &acc);
    }
    const int dw = d[w];
    if (dw == 0) continue;
    load_proj2(s, tbl.entry((dw < 0 ? -dw : dw) - 1), tbl.stride);
    if (dw < 0) f2_neg(s.y, s.y);
    proj2_add(&acc, &acc, &s);
  }
}

}  // namespace kzg
