// The pairing kernels K-a (g2_scalar_mul), K-b (pairing_miller) and K-c
// (pairing_final_exp), built by nvcc for sm_90a into a shared library
// with a plain C interface (kzg_tpu_torch/build.py). Their lane bodies
// and the Fp2/Fp6/Fp12 tower are in tower.cuh.
//
// None replaces a Pallas kernel: the JAX package's device pairing is
// plain jnp (kzg_tpu/curve/tower.py, pairing_device.py), where every
// Fp12 step would be dozens of launches in plain torch. K-a replaces
// g2.ops.scalar_mul in kzg_tpu/kzg/settings.py:60-66, K-b the Miller loops
// of kzg_tpu/curve/pairing_device.py:97-205, K-c its final exponentiation
// (:252-312).
//
// Bound on this card: a lane is one dependent chain of Fp products, some
// 12,000 (K-b: 63 squarings of f, 126 doublings and 10 additions on the
// twist with their sparse line products, and two Fermat inverses), some
// 36,000 (K-c: the hard part's 381 squarings and ~360 products of Fp12)
// and some 4,000 (K-a: 63 x 4 doublings and up to 64 additions over Fp2);
// at the verification path's 128 lanes each launch is bound by that
// chain's latency, not by the multiply rate. Design: one thread a lane
// (a warp a block); K-a keeps its [1..8]Q table in dynamic shared memory
// interleaved across the block, as K3 does; the tower's products and the
// curve steps are out-of-line functions on values in local memory, which
// bounds code size and compile time.
#include <cuda_runtime.h>

#include "tower.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kSmem = kThreads * kzg::T2W * 4;  // 73,728 bytes
using kzg::Fp12;
using kzg::Fp2;
using kzg::NF;

constexpr int kF12Words = 12 * NF;

__device__ __forceinline__ void load_f2(Fp2& r, const int32_t* p) {
  kzg::load<NF>(r.c0, p);
  kzg::load<NF>(r.c1, p + NF);
}

__device__ __forceinline__ void store_f2(int32_t* p, const Fp2& a) {
  kzg::store<NF>(p, a.c0);
  kzg::store<NF>(p + NF, a.c1);
}

__device__ __forceinline__ void load_f12(Fp12& r, const int32_t* p) {
#pragma unroll 1
  for (int s = 0; s < 6; s++) load_f2(r.c[s / 3].c[s % 3], p + 2 * NF * s);
}

__device__ __forceinline__ void store_f12(int32_t* p, const Fp12& a) {
#pragma unroll 1
  for (int s = 0; s < 6; s++) store_f2(p + 2 * NF * s, a.c[s / 3].c[s % 3]);
}

__global__ void __launch_bounds__(kThreads)
    g2_scalar_mul_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                         int32_t* __restrict__ oz,
                         const int32_t* __restrict__ px,
                         const int32_t* __restrict__ py,
                         const int32_t* __restrict__ pz,
                         const int32_t* __restrict__ digits, int n_windows,
                         int n) {
  extern __shared__ uint32_t smem[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)i * 2 * NF;
  Fp2 x, y, z, t, zz;
  load_f2(x, px + o);
  load_f2(y, py + o);
  load_f2(z, pz + o);
  kzg::Proj2 q, acc;
  kzg::jac2_to_proj(q, x, y, z);
  const kzg::Table2 tbl{smem + threadIdx.x, kThreads};
  kzg::g2_ladder_lane(acc, tbl, q, digits + (size_t)i * n_windows,
                      n_windows);
  // projective (X : Y : Z) -> Jacobian (XZ, YZ^2, Z)
  kzg::f2_mul(t, acc.x, acc.z);
  store_f2(ox + o, t);
  kzg::f2_sqr(zz, acc.z);
  kzg::f2_mul(t, acc.y, zz);
  store_f2(oy + o, t);
  store_f2(oz + o, acc.z);
}

__global__ void __launch_bounds__(kThreads)
    pairing_miller_kernel(int32_t* __restrict__ out,
                          const int32_t* __restrict__ a1x,
                          const int32_t* __restrict__ a1y,
                          const int32_t* __restrict__ a1z,
                          const int32_t* __restrict__ a2x,
                          const int32_t* __restrict__ a2y,
                          const int32_t* __restrict__ a2inf,
                          const int32_t* __restrict__ b1x,
                          const int32_t* __restrict__ b1y,
                          const int32_t* __restrict__ b1z,
                          const int32_t* __restrict__ b2x,
                          const int32_t* __restrict__ b2y,
                          const int32_t* __restrict__ b2inf, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* g1[2][3] = {{a1x, a1y, a1z}, {b1x, b1y, b1z}};
  const int32_t* g2[2][2] = {{a2x, a2y}, {b2x, b2y}};
  const int32_t* inf[2] = {a2inf, b2inf};
  uint32_t xp[2][NF], yp[2][NF], z[NF];
  Fp2 xq[2], yq[2];
  bool skip[2];
#pragma unroll 1
  for (int k = 0; k < 2; k++) {
    const size_t o1 = (size_t)i * NF, o2 = (size_t)i * 2 * NF;
    kzg::load<NF>(z, g1[k][2] + o1);
    skip[k] = kzg::is_zero<NF>(z) || inf[k][i] != 0;
    kzg::g1_affine(xp[k], yp[k], g1[k][0] + o1, g1[k][1] + o1,
                   g1[k][2] + o1);
    load_f2(xq[k], g2[k][0] + o2);
    load_f2(yq[k], g2[k][1] + o2);
  }
  Fp12 f;
  kzg::miller_lane(f, xp, yp, xq, yq, skip);
  store_f12(out + (size_t)i * kF12Words, f);
}

__global__ void __launch_bounds__(kThreads)
    pairing_final_exp_kernel(int32_t* __restrict__ out,
                             int32_t* __restrict__ ok,
                             const int32_t* __restrict__ f,
                             const int32_t* __restrict__ gammas,
                             const int32_t* __restrict__ sel, int n_sel,
                             int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp12 a, r;
  load_f12(a, f + (size_t)i * kF12Words);
  kzg::final_exp_lane(r, a, gammas, sel, n_sel);
  store_f12(out + (size_t)i * kF12Words, r);
  ok[i] = kzg::f12_is_one(r) ? 1 : 0;
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int kzg_g2_scalar_mul(void* ox, void* oy, void* oz, const void* px,
                                 const void* py, const void* pz,
                                 const void* digits, int n_windows, int n,
                                 void* stream) {
  if (int err = (int)cudaFuncSetAttribute(
          g2_scalar_mul_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem))
    return err;
  g2_scalar_mul_kernel<<<blocks(n), kThreads, kSmem,
                         (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)px,
      (const int32_t*)py, (const int32_t*)pz, (const int32_t*)digits,
      n_windows, n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_pairing_miller(void* out, const void* a1x, const void* a1y,
                                  const void* a1z, const void* a2x,
                                  const void* a2y, const void* a2inf,
                                  const void* b1x, const void* b1y,
                                  const void* b1z, const void* b2x,
                                  const void* b2y, const void* b2inf, int n,
                                  void* stream) {
  pairing_miller_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)a1x, (const int32_t*)a1y,
      (const int32_t*)a1z, (const int32_t*)a2x, (const int32_t*)a2y,
      (const int32_t*)a2inf, (const int32_t*)b1x, (const int32_t*)b1y,
      (const int32_t*)b1z, (const int32_t*)b2x, (const int32_t*)b2y,
      (const int32_t*)b2inf, n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_pairing_final_exp(void* out, void* ok, const void* f,
                                     const void* gammas, const void* sel,
                                     int n_sel, int n, void* stream) {
  pairing_final_exp_kernel<<<blocks(n), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (int32_t*)out, (int32_t*)ok, (const int32_t*)f,
      (const int32_t*)gammas, (const int32_t*)sel, n_sel, n);
  return (int)cudaGetLastError();
}
