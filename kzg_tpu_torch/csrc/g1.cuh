// G1 point arithmetic for the ladder kernels, one point per thread.
//
// The ladders run in homogeneous projective coordinates with the complete
// Renes-Costello-Batina formulas (eprint 2015/1060, Algorithms 7 and 9 for
// a = 0, b3 = 3b = 12): straight-line, no selects, complete on all of
// E(Fp) because BLS12-381's group order is odd. The identity is (0:1:0).
// The operation order is exactly that of kzg_tpu/curve/pallas_g1.py
// (proj_add, proj_double), so with every Fp value kept canonical the
// output words equal the plain version's (curve/kernels.py).
//
// The formulas are inline functions on references: a ladder keeps its
// points in registers. Code size stays bounded by keeping one call site
// of each formula per loop (`#pragma unroll 1` around it). The [1..8]P
// tables live in shared memory (`Table`), never in local memory: a digit
// indexes them at run time.
#pragma once
#include "field.cuh"

namespace kzg {

constexpr int NP = 12;        // Fp words
constexpr int PW = 3 * NP;    // words of one projective point
constexpr int TW = 8 * PW;    // words of one [1..8]P table (1,152 bytes)

struct Proj {
  uint32_t x[NP], y[NP], z[NP];
};

// R mod p (Montgomery one) and beta*R mod p (GLV cube root of unity).
__device__ __forceinline__ void fp_one(uint32_t r[NP]) {
  constexpr uint32_t V[NP] = {0x0002fffdu, 0x76090000u, 0xc40c0002u,
                              0xebf4000bu, 0x53c758bau, 0x5f489857u,
                              0x70525745u, 0x77ce5853u, 0xa256ec6du,
                              0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
#pragma unroll
  for (int i = 0; i < NP; i++) r[i] = V[i];
}

__device__ __forceinline__ void fp_beta(uint32_t r[NP]) {
  constexpr uint32_t V[NP] = {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u,
                              0x5dab2246u, 0xd3851b95u, 0x587042afu,
                              0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u,
                              0x03f97d6eu, 0x54638741u, 0x18f02065u};
#pragma unroll
  for (int i = 0; i < NP; i++) r[i] = V[i];
}

__device__ __forceinline__ void b3_mul(uint32_t r[NP], const uint32_t x[NP]) {
  uint32_t x2[NP], x4[NP], x8[NP];
  add<NP>(x2, x, x);
  add<NP>(x4, x2, x2);
  add<NP>(x8, x4, x4);
  add<NP>(r, x8, x4);
}

// RCB Algorithm 7 (a = 0): 12M. out may alias p or q.
__device__ __forceinline__ void proj_add(Proj& out, const Proj& p,
                                         const Proj& q) {
  uint32_t t0[NP], t1[NP], t2[NP], t3[NP], t4[NP], x3[NP], y3[NP], z3[NP];
  mul<NP>(t0, p.x, q.x);
  mul<NP>(t1, p.y, q.y);
  mul<NP>(t2, p.z, q.z);
  add<NP>(t3, p.x, p.y);
  add<NP>(t4, q.x, q.y);
  mul<NP>(t3, t3, t4);
  add<NP>(t4, t0, t1);
  sub<NP>(t3, t3, t4);
  add<NP>(t4, p.y, p.z);
  add<NP>(x3, q.y, q.z);
  mul<NP>(t4, t4, x3);
  add<NP>(x3, t1, t2);
  sub<NP>(t4, t4, x3);
  add<NP>(x3, p.x, p.z);
  add<NP>(y3, q.x, q.z);
  mul<NP>(x3, x3, y3);
  add<NP>(y3, t0, t2);
  sub<NP>(y3, x3, y3);
  add<NP>(x3, t0, t0);
  add<NP>(t0, x3, t0);
  b3_mul(t2, t2);
  add<NP>(z3, t1, t2);
  sub<NP>(t1, t1, t2);
  b3_mul(y3, y3);
  mul<NP>(x3, t4, y3);
  mul<NP>(t2, t3, t1);
  sub<NP>(x3, t2, x3);
  mul<NP>(y3, y3, t0);
  mul<NP>(t1, t1, z3);
  add<NP>(y3, t1, y3);
  mul<NP>(t0, t0, t3);
  mul<NP>(z3, z3, t4);
  add<NP>(z3, z3, t0);
  copy<NP>(out.x, x3);
  copy<NP>(out.y, y3);
  copy<NP>(out.z, z3);
}

// RCB Algorithm 9 (a = 0): 8M. out may alias p.
__device__ __forceinline__ void proj_double(Proj& out, const Proj& p) {
  uint32_t t0[NP], t1[NP], t2[NP], x3[NP], y3[NP], z3[NP];
  mul<NP>(t0, p.y, p.y);
  add<NP>(z3, t0, t0);
  add<NP>(z3, z3, z3);
  add<NP>(z3, z3, z3);
  mul<NP>(t1, p.y, p.z);
  mul<NP>(t2, p.z, p.z);
  b3_mul(t2, t2);
  mul<NP>(x3, t2, z3);
  add<NP>(y3, t0, t2);
  mul<NP>(z3, t1, z3);
  add<NP>(t1, t2, t2);
  add<NP>(t2, t1, t2);
  sub<NP>(t0, t0, t2);
  mul<NP>(y3, t0, y3);
  add<NP>(y3, x3, y3);
  mul<NP>(t1, p.x, p.y);
  mul<NP>(x3, t0, t1);
  add<NP>(x3, x3, x3);
  copy<NP>(out.x, x3);
  copy<NP>(out.y, y3);
  copy<NP>(out.z, z3);
}

__device__ __forceinline__ void proj_identity(Proj& r) {
#pragma unroll
  for (int i = 0; i < NP; i++) r.x[i] = r.z[i] = 0;
  fp_one(r.y);
}

// Jacobian (X, Y, Z) [x = X/Z^2, y = Y/Z^3] -> projective (XZ : Y : Z^3).
// Z = 0 is infinity whatever X and Y hold (both the (1, 1, 0) and the
// all-zero encodings), and maps to the identity (0 : 1 : 0).
__device__ __forceinline__ void jac_to_proj(Proj& r, const int32_t* X,
                                            const int32_t* Y,
                                            const int32_t* Z) {
  uint32_t x[NP], y[NP], z[NP], zz[NP];
  load<NP>(x, X);
  load<NP>(y, Y);
  load<NP>(z, Z);
  const bool inf = is_zero<NP>(z);
  mul<NP>(r.x, x, z);
  mul<NP>(zz, z, z);
  mul<NP>(r.z, zz, z);
  if (inf) fp_one(r.y); else copy<NP>(r.y, y);
}

// Projective (X : Y : Z) -> Jacobian (XZ, YZ^2, Z); the identity leaves
// as all-zero words (Z = 0).
__device__ __forceinline__ void store_jac(int32_t* X, int32_t* Y, int32_t* Z,
                                          const Proj& p) {
  uint32_t t[NP], zz[NP];
  mul<NP>(t, p.x, p.z);
  store<NP>(X, t);
  mul<NP>(zz, p.z, p.z);
  mul<NP>(t, p.y, zz);
  store<NP>(Y, t);
  store<NP>(Z, p.z);
}

// Point words at base[i * stride], i < PW (x, then y, then z).
__device__ __forceinline__ void load_point(Proj& r, const uint32_t* base,
                                           int stride) {
#pragma unroll
  for (int i = 0; i < NP; i++) {
    r.x[i] = base[i * stride];
    r.y[i] = base[(NP + i) * stride];
    r.z[i] = base[(2 * NP + i) * stride];
  }
}

__device__ __forceinline__ void store_point(uint32_t* base, int stride,
                                            const Proj& p) {
#pragma unroll
  for (int i = 0; i < NP; i++) {
    base[i * stride] = p.x[i];
    base[(NP + i) * stride] = p.y[i];
    base[(2 * NP + i) * stride] = p.z[i];
  }
}

// A [1..8]P table in shared memory: word w of entry k at
// base[(k * PW + w) * stride]. A thread's own table is interleaved with
// its neighbours' (stride = block size, conflict-free); a table staged
// from device memory is contiguous (stride 1).
struct Table {
  uint32_t* base;
  int stride;
  __device__ __forceinline__ uint32_t* entry(int k) const {
    return base + k * PW * stride;
  }
};

// tbl[k] = (k+1) P for k = 0..7, from P.
__device__ __forceinline__ void build_table(const Table& tbl, const Proj& p) {
  Proj acc = p;
  store_point(tbl.entry(0), tbl.stride, p);
#pragma unroll 1
  for (int k = 1; k < 8; k++) {
    proj_add(acc, acc, p);
    store_point(tbl.entry(k), tbl.stride, acc);
  }
}

// Horner ladder, MSB-first over signed 4-bit digits in [-8, 8]:
// acc = sum_j d1_j 16^j P + sum_j d2_j 16^j phi(P), phi(X:Y:Z) =
// (beta X : Y : Z) (d2 may be null: no phi row). Windows above the top
// nonzero digit are skipped: there acc is the identity, whose doubles are
// the identity's own words, so the result is the full ladder's.
template <typename D>
__device__ __forceinline__ void ladder(Proj& acc, const Table& tbl,
                                       const D* d1, const D* d2,
                                       int n_windows) {
  proj_identity(acc);
  int top = n_windows - 1;
  while (top >= 0 && d1[top] == 0 && (d2 == nullptr || d2[top] == 0)) top--;
  const int rows = d2 == nullptr ? 1 : 2;
#pragma unroll 1
  for (int w = top; w >= 0; w--) {
    if (w != top) {
#pragma unroll 1
      for (int k = 0; k < 4; k++) proj_double(acc, acc);
    }
#pragma unroll 1
    for (int h = 0; h < rows; h++) {
      const int d = h ? (int)d2[w] : (int)d1[w];
      if (d == 0) continue;
      Proj s;
      load_point(s, tbl.entry((d < 0 ? -d : d) - 1), tbl.stride);
      if (d < 0) neg<NP>(s.y, s.y);
      if (h) {
        uint32_t beta[NP];
        fp_beta(beta);
        mul<NP>(s.x, s.x, beta);
      }
      proj_add(acc, acc, s);
    }
  }
}

}  // namespace kzg
