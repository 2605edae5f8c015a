// The Fp2/Fp6/Fp12 tower on field.cuh's Fp (mul<12>, add<12>, sub<12>),
// and the per-lane bodies of the pairing kernels (pairing_kernels.cu):
// the G2 ladder (K-a), the two-pair Miller loop on the twist (K-b) and the
// final exponentiation (K-c).
//
// Tower (curve/pairing.py): Fp2 = Fp[u]/(u^2 + 1), Fp6 = Fp2[v]/(v^3 - xi)
// with xi = 1 + u, Fp12 = Fp6[w]/(w^2 - v). Every value is canonical after
// every operation, so any correct formula gives the words of the plain
// versions (curve/pairing_kernels.py), which compute the same field
// elements on the redundant engine.
//
// Code size: the Fp2 sums are inline; the Fp2 product and square, the
// Fp6/Fp12 products, the curve steps and the Fermat inverse are
// out-of-line (__noinline__), one copy each, on values passed by pointer
// (they live in local memory): one copy of the 12-word product's code
// per caller kept the first build of this file near three minutes.
// Every out-of-line operation computes into locals before it writes its
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

// a^(p-2) MSB first (square always, multiply on a 1 bit); 0 -> 0.
__device__ __noinline__ void fp_inv(uint32_t* r, const uint32_t* a) {
  // p - 2, little-endian words
  constexpr uint32_t E[NF] = {0xffffaaa9u, 0xb9feffffu, 0xb153ffffu,
                              0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
                              0xf38512bfu, 0x64774b84u, 0x434bacd7u,
                              0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
  uint32_t x[NF], acc[NF];
  copy<NF>(x, a);
  copy<NF>(acc, a);
#pragma unroll 1
  for (int i = 379; i >= 0; i--) {  // bit 380 is the leading one
    mul<NF>(acc, acc, acc);
    if ((E[i >> 5] >> (i & 31)) & 1) mul<NF>(acc, acc, x);
  }
  copy<NF>(r, acc);
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

// (a0 - a1 u) / (a0^2 + a1^2): one Fermat inverse; 0 -> 0.
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
__device__ __forceinline__ void f6_add(Fp6& r, const Fp6& a, const Fp6& b) {
#pragma unroll
  for (int i = 0; i < 3; i++) f2_add(r.c[i], a.c[i], b.c[i]);
}

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

// (c0 + c1 v + c2 v^2)(d0 + d1 v): 5 Fp2 products.
__device__ __noinline__ void f6_mul_01(Fp6* r, const Fp6* a, const Fp2* d0,
                                       const Fp2* d1) {
  Fp2 t0, t1, s, u, c0, c1, c2;
  f2_mul(t0, a->c[0], *d0);
  f2_mul(t1, a->c[1], *d1);
  f2_add(s, a->c[0], a->c[1]);
  f2_add(u, *d0, *d1);
  f2_mul(s, s, u);
  f2_sub(s, s, t0);
  f2_sub(c1, s, t1);        // c0 d1 + c1 d0
  f2_mul(s, a->c[2], *d1);
  f2_mul_xi(s, s);
  f2_add(c0, t0, s);        // c0 d0 + xi c2 d1
  f2_mul(s, a->c[2], *d0);
  f2_add(c2, t1, s);        // c1 d1 + c2 d0
  r->c[0] = c0;
  r->c[1] = c1;
  r->c[2] = c2;
}

// (c0 + c1 v + c2 v^2) d1 v = xi c2 d1 + c0 d1 v + c1 d1 v^2
__device__ __forceinline__ void f6_mul_1(Fp6& r, const Fp6& a,
                                         const Fp2& d1) {
  Fp2 c0, c1, c2;
  f2_mul(c0, a.c[2], d1);
  f2_mul_xi(c0, c0);
  f2_mul(c1, a.c[0], d1);
  f2_mul(c2, a.c[1], d1);
  r.c[0] = c0;
  r.c[1] = c1;
  r.c[2] = c2;
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
__device__ __forceinline__ void f12_set_one(Fp12& r) {
#pragma unroll
  for (int j = 0; j < 2; j++)
#pragma unroll
    for (int i = 0; i < 3; i++) f2_set_zero(r.c[j].c[i]);
  fp_set_one(r.c[0].c[0].c0);
}

__device__ __forceinline__ bool f12_is_one(const Fp12& a) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < NF; k++)
    ok &= a.c[0].c[0].c0[k] == Field<NF>::one(k);
  ok &= is_zero<NF>(a.c[0].c[0].c1);
#pragma unroll
  for (int i = 1; i < 3; i++) ok &= f2_is_zero(a.c[0].c[i]);
#pragma unroll
  for (int i = 0; i < 3; i++) ok &= f2_is_zero(a.c[1].c[i]);
  return ok;
}

// Karatsuba over Fp6: 3 Fp6 products.
__device__ __noinline__ void f12_mul(Fp12* r, const Fp12* a, const Fp12* b) {
  Fp6 t0, t1, s, u;
  f6_mul(&t0, &a->c[0], &b->c[0]);
  f6_mul(&t1, &a->c[1], &b->c[1]);
  f6_add(s, a->c[0], a->c[1]);
  f6_add(u, b->c[0], b->c[1]);
  f6_mul(&s, &s, &u);
  f6_sub(s, s, t0);
  f6_sub(r->c[1], s, t1);
  f6_mul_v(t1, t1);
  f6_add(r->c[0], t0, t1);
}

// (a0 + a1 w)^2 = (a0^2 + v a1^2) + 2 a0 a1 w from a0 a1 and
// (a0 + a1)(a0 + v a1): 2 Fp6 products.
__device__ __noinline__ void f12_sqr(Fp12* r, const Fp12* a) {
  Fp6 ab, s, u;
  f6_mul(&ab, &a->c[0], &a->c[1]);
  f6_add(s, a->c[0], a->c[1]);
  f6_mul_v(u, a->c[1]);
  f6_add(u, a->c[0], u);
  f6_mul(&s, &s, &u);
  f6_sub(s, s, ab);
  f6_mul_v(u, ab);
  f6_sub(r->c[0], s, u);
  f6_add(r->c[1], ab, ab);
}

__device__ __forceinline__ void f12_conj(Fp12& r, const Fp12& a) {
  r.c[0] = a.c[0];
  f6_neg(r.c[1], a.c[1]);
}

// f (l0 + l1 v + l4 v w): with A = l0 + l1 v and B = l4 v,
// (a + b w)(A + B w) = (aA + v bB) + ((a + b)(A + B) - aA - bB) w.
__device__ __noinline__ void f12_mul_014(Fp12* r, const Fp12* f,
                                         const Fp2* l0, const Fp2* l1,
                                         const Fp2* l4) {
  Fp6 aa, bb, s;
  Fp2 o;
  f6_mul_01(&aa, &f->c[0], l0, l1);
  f6_mul_1(bb, f->c[1], *l4);
  f2_add(o, *l1, *l4);
  f6_add(s, f->c[0], f->c[1]);
  f6_mul_01(&s, &s, l0, &o);
  f6_sub(s, s, aa);
  f6_sub(r->c[1], s, bb);
  f6_mul_v(bb, bb);
  f6_add(r->c[0], aa, bb);
}

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

// a^(p^k): each Fp2 slot conjugated for odd k, then times its gamma;
// gam holds the 6 gammas of this k as Montgomery words, slot (j, i) at
// ((j * 3 + i) * 2 + component) * 12.
__device__ __noinline__ void f12_frobenius(Fp12* r, const Fp12* a,
                                           const int32_t* gam, bool odd) {
#pragma unroll 1
  for (int s = 0; s < 6; s++) {
    const int j = s / 3, i = s % 3;
    Fp2 x, g;
    if (odd) f2_conj(x, a->c[j].c[i]); else x = a->c[j].c[i];
    load<NF>(g.c0, gam + (2 * s) * NF);
    load<NF>(g.c1, gam + (2 * s + 1) * NF);
    f2_mul(r->c[j].c[i], x, g);
  }
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

// f *= l0 + (l1 xP) v + (l4 yP) v w
__device__ __forceinline__ void miller_line(Fp12& f, const Fp2& l0,
                                            const Fp2& l1, const Fp2& l4,
                                            const uint32_t xp[NF],
                                            const uint32_t yp[NF]) {
  Fp2 a, b;
  f2_mul_fp(a, l1, xp);
  f2_mul_fp(b, l4, yp);
  f12_mul_014(&f, &f, &l0, &a, &b);
}

// The affine (x, y) of a Jacobian G1 point: one Fermat inverse of Z
// (Z = 0 gives (0, 0)).
__device__ __noinline__ void g1_affine(uint32_t* x, uint32_t* y,
                                       const int32_t* X, const int32_t* Y,
                                       const int32_t* Z) {
  uint32_t zi[NF], zi2[NF], t[NF];
  load<NF>(t, Z);
  fp_inv(zi, t);
  mul<NF>(zi2, zi, zi);
  load<NF>(t, X);
  mul<NF>(x, t, zi2);
  mul<NF>(zi2, zi2, zi);
  load<NF>(t, Y);
  mul<NF>(y, t, zi2);
}

// |x| = 0xd201000000010000 below its leading bit, MSB first
constexpr unsigned long long kMillerBits = 0xd201000000010000ull;
constexpr int kMillerTop = 63;

// One lane of K-b: pairs k = 0, 1 of affine P (xp, yp) and Q (xq, yq),
// skip[k] for a pair with a point at infinity (it contributes 1).
// f = conj(prod_k f_{|x|,Qk}(Pk)).
__device__ __forceinline__ void miller_lane(Fp12& f, const uint32_t (*xp)[NF],
                                            const uint32_t (*yp)[NF],
                                            const Fp2* xq, const Fp2* yq,
                                            const bool* skip) {
  Jac2 t[2];
#pragma unroll
  for (int k = 0; k < 2; k++) {
    t[k].x = xq[k];
    t[k].y = yq[k];
    f2_set_one(t[k].z);
  }
  f12_set_one(f);
#pragma unroll 1
  for (int b = kMillerTop - 1; b >= 0; b--) {
    f12_sqr(&f, &f);
    const bool add_bit = (kMillerBits >> b) & 1;
#pragma unroll 1
    for (int step = 0; step < (add_bit ? 4 : 2); step++) {
      const int k = step & 1;
      if (skip[k]) continue;
      Fp2 l0, l1, l4;
      if (step < 2) miller_dbl(&t[k], &l0, &l1, &l4);
      else miller_add(&t[k], &xq[k], &yq[k], &l0, &l1, &l4);
      miller_line(f, l0, l1, l4, xp[k], yp[k]);
    }
  }
  f12_conj(f, f);
}

// One lane of K-c: out = f^((p^12 - 1) / r). gam: the gammas of p^1,
// p^2, p^3 (6 Fp2 each), sel: the hard part's joint-ladder selectors.
// The 16-entry table lives in local memory.
__device__ __forceinline__ void final_exp_lane(Fp12& out, const Fp12& f,
                                               const int32_t* gam,
                                               const int32_t* sel,
                                               int n_sel) {
  constexpr int G = 6 * 2 * NF;  // words of one k's gammas
  Fp12 t, m;
  f12_inv(&t, &f);
  f12_conj(m, f);
  f12_mul(&t, &m, &t);                     // f^(p^6 - 1)
  f12_frobenius(&m, &t, gam + G, false);
  f12_mul(&m, &m, &t);                     // ^(p^2 + 1)
  Fp12 g[4];
  g[0] = m;
#pragma unroll 1
  for (int k = 1; k < 4; k++) f12_frobenius(&g[k], &m, gam + (k - 1) * G,
                                            k & 1);
  Fp12 table[16];
  f12_set_one(table[0]);
#pragma unroll 1
  for (int s = 1; s < 16; s++) {
    const int low = s & -s;
    int i = 0;
    while (!((low >> i) & 1)) i++;
    f12_mul(&table[s], &table[s ^ low], &g[i]);
  }
  f12_set_one(out);
#pragma unroll 1
  for (int j = 0; j < n_sel; j++) {
    f12_sqr(&out, &out);
    const int s = sel[j];
    if (s) f12_mul(&out, &out, &table[s]);
  }
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
