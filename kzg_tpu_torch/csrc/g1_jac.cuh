// Complete Jacobian point formulas on canonical Fp words, one point per
// thread: dbl-2009-l (a = 0) and add-2007-bl with the selects of
// kzg_tpu/curve/pallas_g1.py's point_add_tile, in its operation order.
// Shared by g1_point_kernels.cu (g1_add, g1_double) and
// exp_point_kernels.cu (the Jacobian chains of the point-op experiments).
//
// Where the Pallas kernel computes both branches and selects lane by lane,
// a thread here branches: the selects' priority order is kept (P at
// infinity -> Q, then Q at infinity -> P, then the double or zero when
// h = 0), and only the branch a lane takes is computed.
#pragma once
#include "g1.cuh"

namespace kzg {

struct Jac {
  uint32_t x[NP], y[NP], z[NP];
};

__device__ __forceinline__ void load_jac(Jac* r, const int32_t* X,
                                         const int32_t* Y, const int32_t* Z) {
  kzg::load<NP>(r->x, X);
  kzg::load<NP>(r->y, Y);
  kzg::load<NP>(r->z, Z);
}

__device__ __forceinline__ void store_jac(int32_t* X, int32_t* Y, int32_t* Z,
                                          const Jac* p) {
  kzg::store<NP>(X, p->x);
  kzg::store<NP>(Y, p->y);
  kzg::store<NP>(Z, p->z);
}

// dbl-2009-l (a = 0), point_double_tile's order. r may alias p.
__device__ __noinline__ void jac_double(Jac* r, const Jac* p) {
  uint32_t a[NP], b[NP], c[NP], d[NP], e[NP], t[NP], x3[NP], y3[NP], z3[NP];
  kzg::mul<NP>(a, p->x, p->x);
  kzg::mul<NP>(b, p->y, p->y);
  kzg::mul<NP>(c, b, b);
  kzg::add<NP>(t, p->x, b);
  kzg::mul<NP>(t, t, t);
  kzg::add<NP>(d, a, c);
  kzg::sub<NP>(d, t, d);
  kzg::add<NP>(d, d, d);      // d = 2((x + b)^2 - a - c)
  kzg::add<NP>(e, a, a);
  kzg::add<NP>(e, e, a);      // e = 3a
  kzg::mul<NP>(t, e, e);      // f = e^2
  kzg::add<NP>(x3, d, d);
  kzg::sub<NP>(x3, t, x3);    // x3 = f - 2d
  kzg::add<NP>(c, c, c);
  kzg::add<NP>(c, c, c);
  kzg::add<NP>(c, c, c);      // 8c
  kzg::sub<NP>(t, d, x3);
  kzg::mul<NP>(t, e, t);
  kzg::sub<NP>(y3, t, c);     // y3 = e(d - x3) - 8c
  kzg::mul<NP>(t, p->y, p->z);
  kzg::add<NP>(z3, t, t);     // z3 = 2yz
  kzg::copy<NP>(r->x, x3);
  kzg::copy<NP>(r->y, y3);
  kzg::copy<NP>(r->z, z3);
}

// add-2007-bl with the selects of point_add_tile. r must not alias p or q.
__device__ __forceinline__ void jac_add(Jac* r, const Jac* p, const Jac* q) {
  if (kzg::is_zero<NP>(p->z)) {
    *r = *q;
    return;
  }
  if (kzg::is_zero<NP>(q->z)) {
    *r = *p;
    return;
  }
  uint32_t z1z1[NP], z2z2[NP], u1[NP], u2[NP], s1[NP], s2[NP], h[NP],
      rr[NP];
  kzg::mul<NP>(z1z1, p->z, p->z);
  kzg::mul<NP>(z2z2, q->z, q->z);
  kzg::mul<NP>(u1, p->x, z2z2);
  kzg::mul<NP>(u2, q->x, z1z1);
  kzg::mul<NP>(s1, p->y, q->z);
  kzg::mul<NP>(s1, s1, z2z2);
  kzg::mul<NP>(s2, q->y, p->z);
  kzg::mul<NP>(s2, s2, z1z1);
  kzg::sub<NP>(h, u2, u1);
  kzg::sub<NP>(rr, s2, s1);
  if (kzg::is_zero<NP>(h)) {
    if (kzg::is_zero<NP>(rr)) {
      jac_double(r, p);  // P == Q
    } else {             // P == -Q: all-zero words, as the Pallas kernel
#pragma unroll
      for (int i = 0; i < NP; i++) r->x[i] = r->y[i] = r->z[i] = 0;
    }
    return;
  }
  uint32_t i2[NP], j[NP], v[NP], t[NP];
  kzg::add<NP>(t, h, h);
  kzg::mul<NP>(i2, t, t);          // i = (2h)^2
  kzg::mul<NP>(j, h, i2);
  kzg::add<NP>(rr, rr, rr);        // rr2 = 2r
  kzg::mul<NP>(v, u1, i2);
  kzg::mul<NP>(t, rr, rr);
  kzg::add<NP>(u2, v, v);
  kzg::add<NP>(u2, j, u2);
  kzg::sub<NP>(r->x, t, u2);       // x3 = rr2^2 - (j + 2v)
  kzg::mul<NP>(s1, s1, j);
  kzg::sub<NP>(t, v, r->x);
  kzg::mul<NP>(t, rr, t);
  kzg::add<NP>(s1, s1, s1);
  kzg::sub<NP>(r->y, t, s1);       // y3 = rr2 (v - x3) - 2 s1 j
  kzg::add<NP>(t, p->z, q->z);
  kzg::mul<NP>(t, t, t);
  kzg::add<NP>(u2, z1z1, z2z2);
  kzg::sub<NP>(t, t, u2);
  kzg::mul<NP>(r->z, t, h);        // z3 = ((z1 + z2)^2 - z1z1 - z2z2) h
}

}  // namespace kzg
