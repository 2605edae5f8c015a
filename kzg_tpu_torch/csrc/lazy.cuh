// The 13-word lazy Fp domain (R_ext = 2^416), one value per thread in 14
// registers (word 13 is 0), and the complete Renes-Costello-Batina
// projective formulas on it in kzg_tpu/curve/pallas_g1.py's operation
// order (proj_add, proj_double, _b3_mul, jac_to_proj): the counterpart of
// the TPU's LL = 25-limb lazy domain (R_ext = 2^400), with one headroom
// word where the TPU has one 16-bit limb. Shared by exp_field_kernels.cu
// (exp_tuple_chain's lazy products, exp_ext_chain) and
// exp_point_kernels.cu (the lazy point chains).
//
// A product is REDC over R_ext with no final conditional subtraction
// (lazy_mul: field.cuh's split rows, 13 rows on a 14-word accumulator);
// its output is below a b / 2^416 + p, so below 1.01p for operands below
// 2^35 p. An add is a 13-word add.cc chain, nothing reduced; a sub is
// a + (K m - b) with K = 64 (the TPU's _lazy_ctx), exact only while
// b <= K m. to_ext multiplies canonical Montgomery words (R = 2^384) by
// C_IN = 2^448 mod p, from_ext by C_OUT = 2^384 mod p and reduces once.
//
// Audit of the formulas' subs (no assumption that a point lies on the
// curve: the chains run them on any coordinates). Every product output is
// below 1.01p as long as its operands stay below 2^35 p, which holds for
// every value below: in proj_double, the one sub t0 - t2 takes
// t2 = 3 b3 M(z, z) = 36 M(z, z) < 37p; in proj_add the subtrahends are
// a sum of two products (t0 + t1, t1 + t2, t0 + t2; below 3p), b3 M(z, z)
// (12 M < 13p) and one product (below 2p): every one below 13p < K m.
// Outputs: proj_double's x3 = 2 M below 3p, y3 = M + M below 3p, z3 = M
// below 2p; proj_add's x3 = M + K m - M below 66p, y3 and z3 below 3p. A
// chain's inputs therefore stay below 66p and every operand of a product
// below (66 + 66) p, far inside 2^35 p: the lazy arithmetic is exact field
// arithmetic, and from_ext gives the same canonical words as any exact
// computation of the same formulas (g1.cuh's canonical ones included).
#pragma once
#include "field.cuh"

namespace kzg {

// Fp's modulus padded with a zero word to 14 words, for the lazy
// products' rows (mul_row reads Field<N>::m and n0); n0 depends on the
// lowest word alone.
template <>
struct Field<14> {
  static constexpr uint32_t n0 = Field<12>::n0;
  __device__ __forceinline__ static uint32_t m(int i) {
    return i < 12 ? Field<12>::m(i) : 0u;
  }
};

// r = lo + hi / 2^32 (hi[0] = 0): the last row's pending shift of a split
// accumulator; the carry out of word NA-1 is dropped (the value fits).
template <int NA>
__device__ __forceinline__ void halves(uint32_t r[NA], const uint32_t lo[NA],
                                       const uint32_t hi[NA]) {
  r[0] = ptx::add_cc(lo[0], hi[1]);
#pragma unroll
  for (int k = 1; k < NA - 1; k++) r[k] = ptx::addc_cc(lo[k], hi[k + 1]);
  r[NA - 1] = ptx::addc(lo[NA - 1], 0);
}

// r = REDC(a*b) over R = 2^(32 ROWS) with no final conditional
// subtraction, mod R: ROWS of field.cuh's split-accumulator rows on NA
// words (NA even, NA >= ROWS; a and the modulus zero-padded to NA words,
// b's low ROWS words scanned). After an odd number of rows the halves'
// roles are swapped. Words ROWS..NA-1 of r are set to 0. r may alias a
// or b.
template <int NA, int ROWS>
__device__ __forceinline__ void lazy_mul(uint32_t r[NA], const uint32_t a[NA],
                                         const uint32_t b[NA]) {
  uint32_t E[NA], O[NA];
#pragma unroll
  for (int i = 0; i + 1 < ROWS; i += 2) {
    kzg::mul_row<NA>(E, O, a, b[i], i == 0);
    kzg::mul_row<NA>(O, E, a, b[i + 1], false);
  }
  if constexpr (ROWS % 2 == 1) {
    kzg::mul_row<NA>(E, O, a, b[ROWS - 1], ROWS == 1);
    halves<NA>(r, O, E);   // E[0] = 0: t / 2^32 = O + E / 2^32
  } else {
    halves<NA>(r, E, O);   // O[0] = 0: t / 2^32 = E + O / 2^32
  }
#pragma unroll
  for (int k = ROWS; k < NA; k++) r[k] = 0;
}

// the 13-word lazy domain (R_ext = 2^416) of exp_ext_chain, its values in
// 14-word registers (word 13 is 0)
constexpr int kExtWords = 13;
constexpr int kExtNA = 14;

struct Ext {
  // C_IN = 2^(2*416-384) mod p
  __device__ __forceinline__ static uint32_t c_in(int i) {
    constexpr uint32_t W[13] = {0x7dba9366u, 0x42b7fde3u, 0x27525bc3u,
                                0x7784894eu, 0xc1f5b1e9u, 0xb2b91b9du,
                                0xfcafb872u, 0x206f497du, 0x89a9b0bbu,
                                0x594137ccu, 0x20d7e399u, 0x0411cd9du,
                                0x00000000u};
    return W[i];
  }
  // C_OUT = 2^384 mod p
  __device__ __forceinline__ static uint32_t c_out(int i) {
    constexpr uint32_t W[13] = {0x0002fffdu, 0x76090000u, 0xc40c0002u,
                                0xebf4000bu, 0x53c758bau, 0x5f489857u,
                                0x70525745u, 0x77ce5853u, 0xa256ec6du,
                                0x5c071a97u, 0xfa80e493u, 0x15f65ec3u,
                                0x00000000u};
    return W[i];
  }
  // K m with K = 64, the lazy sub's offset
  __device__ __forceinline__ static uint32_t km(int i) {
    constexpr uint32_t W[13] = {0xffeaaac0u, 0x7fbfffffu, 0x54ffffeeu,
                                0xaaffffacu, 0xac3d8907u, 0xcc34a83du,
                                0xe144afd9u, 0x1dd2e13cu, 0xd2eb35d9u,
                                0xc6e9ed90u, 0x5ff9a692u, 0x80447a8eu,
                                0x00000006u};
    return W[i];
  }
  // one_ext = R_ext mod p = 2^416 mod p, the lazy domain's 1
  __device__ __forceinline__ static uint32_t one(int i) {
    constexpr uint32_t W[13] = {0xa8e9b9afu, 0x44f6480eu, 0x766c8fe4u,
                                0xa96f7d65u, 0x28b540feu, 0xe82efd42u,
                                0xade53b2eu, 0x6723e5f0u, 0xfdd4230au,
                                0x25ff6eb6u, 0xef23c24au, 0x14c8ee06u,
                                0x00000000u};
    return W[i];
  }
};

__device__ __forceinline__ void ext_mul(uint32_t r[kExtNA],
                                        const uint32_t a[kExtNA],
                                        const uint32_t b[kExtNA]) {
  lazy_mul<kExtNA, kExtWords>(r, a, b);
}

enum ExtOp { kLazyAdd = 0, kLazySub, kRawAdd };

// r = E(a, b) on 13 words, mod 2^416; r may alias a or b
template <int OP>
__device__ __forceinline__ void ext_op(uint32_t r[kExtNA],
                                       const uint32_t a[kExtNA],
                                       const uint32_t b[kExtNA]) {
  constexpr int W = kExtWords;
  if constexpr (OP == kLazyAdd) {
    r[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
    for (int k = 1; k < W - 1; k++) r[k] = ptx::addc_cc(a[k], b[k]);
    r[W - 1] = ptx::addc(a[W - 1], b[W - 1]);
  } else if constexpr (OP == kLazySub) {
    uint32_t t[W];   // K m - b
    t[0] = ptx::sub_cc(Ext::km(0), b[0]);
#pragma unroll
    for (int k = 1; k < W - 1; k++) t[k] = ptx::subc_cc(Ext::km(k), b[k]);
    t[W - 1] = ptx::subc(Ext::km(W - 1), b[W - 1]);
    r[0] = ptx::add_cc(a[0], t[0]);
#pragma unroll
    for (int k = 1; k < W - 1; k++) r[k] = ptx::addc_cc(a[k], t[k]);
    r[W - 1] = ptx::addc(a[W - 1], t[W - 1]);
  } else {
#pragma unroll
    for (int k = 0; k < W; k++) r[k] = a[k] + b[k];
  }
}

// (n, 12) canonical Montgomery words (R = 2^384) -> the lazy domain
__device__ __forceinline__ void to_ext(uint32_t v[kExtNA],
                                       const int32_t* __restrict__ p) {
  uint32_t c[kExtNA];
#pragma unroll
  for (int k = 0; k < kExtNA; k++) {
    v[k] = k < 12 ? (uint32_t)p[k] : 0;
    c[k] = k < kExtWords ? Ext::c_in(k) : 0;
  }
  ext_mul(v, v, c);
}

// the lazy domain -> canonical words: REDC by C_OUT (below 2p), cond_sub
__device__ __forceinline__ void from_ext(int32_t* __restrict__ p,
                                         const uint32_t v[kExtNA]) {
  uint32_t c[kExtNA], t[kExtNA], r[12];
#pragma unroll
  for (int k = 0; k < kExtNA; k++) c[k] = k < kExtWords ? Ext::c_out(k) : 0;
  ext_mul(t, v, c);
  kzg::cond_sub<12>(r, t, t[12]);
  kzg::store<12>(p, r);
}

// r = a + b (lazy add) and r = a + (K m - b) (lazy sub) on 13 words, the
// headroom word set to 0 for the products that read it
__device__ __forceinline__ void ext_add(uint32_t r[kExtNA],
                                        const uint32_t a[kExtNA],
                                        const uint32_t b[kExtNA]) {
  ext_op<kLazyAdd>(r, a, b);
  r[kExtWords] = 0;
}

__device__ __forceinline__ void ext_sub(uint32_t r[kExtNA],
                                        const uint32_t a[kExtNA],
                                        const uint32_t b[kExtNA]) {
  ext_op<kLazySub>(r, a, b);
  r[kExtWords] = 0;
}

// a projective point (X : Y : Z) in the lazy domain
struct LazyPoint {
  uint32_t x[kExtNA], y[kExtNA], z[kExtNA];
};

// 12 x = b3 x (b3 = 3b = 12): three doublings and an add, no reduction
__device__ __forceinline__ void ext_b3_mul(uint32_t r[kExtNA],
                                           const uint32_t x[kExtNA]) {
  uint32_t x2[kExtNA], x4[kExtNA], x8[kExtNA];
  ext_add(x2, x, x);
  ext_add(x4, x2, x2);
  ext_add(x8, x4, x4);
  ext_add(r, x8, x4);
}

// RCB Algorithm 7 (a = 0): 12 products. out may alias p or q.
__device__ __forceinline__ void ext_proj_add(LazyPoint& out,
                                             const LazyPoint& p,
                                             const LazyPoint& q) {
  uint32_t t0[kExtNA], t1[kExtNA], t2[kExtNA], t3[kExtNA], t4[kExtNA],
      x3[kExtNA], y3[kExtNA], z3[kExtNA];
  ext_mul(t0, p.x, q.x);
  ext_mul(t1, p.y, q.y);
  ext_mul(t2, p.z, q.z);
  ext_add(t3, p.x, p.y);
  ext_add(t4, q.x, q.y);
  ext_mul(t3, t3, t4);
  ext_add(t4, t0, t1);
  ext_sub(t3, t3, t4);      // X1Y2 + X2Y1
  ext_add(t4, p.y, p.z);
  ext_add(x3, q.y, q.z);
  ext_mul(t4, t4, x3);
  ext_add(x3, t1, t2);
  ext_sub(t4, t4, x3);      // Y1Z2 + Y2Z1
  ext_add(x3, p.x, p.z);
  ext_add(y3, q.x, q.z);
  ext_mul(x3, x3, y3);
  ext_add(y3, t0, t2);
  ext_sub(y3, x3, y3);      // X1Z2 + X2Z1
  ext_add(x3, t0, t0);
  ext_add(t0, x3, t0);      // 3 X1X2
  ext_b3_mul(t2, t2);
  ext_add(z3, t1, t2);
  ext_sub(t1, t1, t2);
  ext_b3_mul(y3, y3);
  ext_mul(x3, t4, y3);
  ext_mul(t2, t3, t1);
  ext_sub(x3, t2, x3);
  ext_mul(y3, y3, t0);
  ext_mul(t1, t1, z3);
  ext_add(y3, t1, y3);
  ext_mul(t0, t0, t3);
  ext_mul(z3, z3, t4);
  ext_add(z3, z3, t0);
  copy<kExtNA>(out.x, x3);
  copy<kExtNA>(out.y, y3);
  copy<kExtNA>(out.z, z3);
}

// RCB Algorithm 9 (a = 0): 8 products. out may alias p.
__device__ __forceinline__ void ext_proj_double(LazyPoint& out,
                                                const LazyPoint& p) {
  uint32_t t0[kExtNA], t1[kExtNA], t2[kExtNA], x3[kExtNA], y3[kExtNA],
      z3[kExtNA];
  ext_mul(t0, p.y, p.y);
  ext_add(z3, t0, t0);
  ext_add(z3, z3, z3);
  ext_add(z3, z3, z3);      // 8 Y^2
  ext_mul(t1, p.y, p.z);
  ext_mul(t2, p.z, p.z);
  ext_b3_mul(t2, t2);       // b3 Z^2
  ext_mul(x3, t2, z3);
  ext_add(y3, t0, t2);
  ext_mul(z3, t1, z3);
  ext_add(t1, t2, t2);
  ext_add(t2, t1, t2);
  ext_sub(t0, t0, t2);
  ext_mul(y3, t0, y3);
  ext_add(y3, x3, y3);
  ext_mul(t1, p.x, p.y);
  ext_mul(x3, t0, t1);
  ext_add(x3, x3, x3);
  copy<kExtNA>(out.x, x3);
  copy<kExtNA>(out.y, y3);
  copy<kExtNA>(out.z, z3);
}

// Jacobian (X, Y, Z) -> projective (XZ : Y : Z^3) in the lazy domain;
// Z = 0 (infinity, whatever X and Y hold) -> (0 : 1 : 0), 1 = one_ext.
__device__ __forceinline__ void ext_jac_to_proj(LazyPoint& r,
                                                const LazyPoint& p) {
  uint32_t zz[kExtNA];
  bool inf = true;
#pragma unroll
  for (int k = 0; k < kExtWords; k++) inf = inf && p.z[k] == 0;
  ext_mul(r.x, p.x, p.z);
  ext_mul(zz, p.z, p.z);
  ext_mul(r.z, zz, p.z);
#pragma unroll
  for (int k = 0; k < kExtNA; k++)
    r.y[k] = inf ? (k < kExtWords ? Ext::one(k) : 0u) : p.y[k];
}

}  // namespace kzg
