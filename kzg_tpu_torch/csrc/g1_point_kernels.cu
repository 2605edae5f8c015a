// G1 point kernels g1_add and g1_double, built by nvcc for sm_90a into a
// shared library with a plain C interface (kzg_tpu_torch/build.py).
//
// g1_add replaces kzg_tpu/curve/pallas_g1.py::_add_fn (add_pallas): the
// complete Jacobian add of point_add_tile, add-2007-bl with selects for
// P == Q (the double), P == -Q (all-zero words) and either operand at
// infinity (Z = 0, whatever X and Y hold). g1_double replaces ::_double_fn
// (double_pallas): dbl-2009-l for a = 0 (point_double_tile); infinity
// stays infinity (Z3 = 2YZ = 0). Every Fp value is canonical after every
// operation (field.cuh), so the output words equal the plain versions'
// (curve/kernels.py) and the Pallas kernels', which compute the same field
// values with the same formulas.
//
// Where the Pallas kernel computes both branches and selects lane by lane,
// a thread here branches: the selects' priority order is kept (P at
// infinity -> Q, then Q at infinity -> P, then the double or zero when
// h = 0), and only the branch a lane takes is computed.
//
// Bound on this card: a generic add is 16 Fp products (300 32x32->64
// multiply-adds each) against 9 x 48 bytes moved, a double 7 products
// against 6 x 48 bytes, so both are bound by integer multiplies at wide
// batches. At the MSM's tree and Horner widths (down to one lane) they are
// bound by launch latency instead. Design: one thread per point, values
// in registers; the double is one out-of-line function shared by both
// kernels (one copy of its code).
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

constexpr int kThreads = 128;
using kzg::NP;

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

__global__ void __launch_bounds__(kThreads)
    g1_add_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                  int32_t* __restrict__ oz, const int32_t* __restrict__ px,
                  const int32_t* __restrict__ py,
                  const int32_t* __restrict__ pz,
                  const int32_t* __restrict__ qx,
                  const int32_t* __restrict__ qy,
                  const int32_t* __restrict__ qz, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)i * NP;
  Jac p, q, r;
  load_jac(&p, px + o, py + o, pz + o);
  load_jac(&q, qx + o, qy + o, qz + o);
  jac_add(&r, &p, &q);
  store_jac(ox + o, oy + o, oz + o, &r);
}

__global__ void __launch_bounds__(kThreads)
    g1_double_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                     int32_t* __restrict__ oz,
                     const int32_t* __restrict__ px,
                     const int32_t* __restrict__ py,
                     const int32_t* __restrict__ pz, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)i * NP;
  Jac p;
  load_jac(&p, px + o, py + o, pz + o);
  jac_double(&p, &p);
  store_jac(ox + o, oy + o, oz + o, &p);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int kzg_g1_add(void* ox, void* oy, void* oz, const void* px,
                          const void* py, const void* pz, const void* qx,
                          const void* qy, const void* qz, int n,
                          void* stream) {
  g1_add_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)px,
      (const int32_t*)py, (const int32_t*)pz, (const int32_t*)qx,
      (const int32_t*)qy, (const int32_t*)qz, n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_g1_double(void* ox, void* oy, void* oz, const void* px,
                             const void* py, const void* pz, int n,
                             void* stream) {
  g1_double_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)px,
      (const int32_t*)py, (const int32_t*)pz, n);
  return (int)cudaGetLastError();
}
