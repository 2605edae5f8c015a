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
// values with the same formulas (g1_jac.cuh, where a thread branches on
// the Pallas kernel's selects in their priority order).
//
// Bound on this card: a generic add is 16 Fp products (300 32x32->64
// multiply-adds each) against 9 x 48 bytes moved, a double 7 products
// against 6 x 48 bytes, so both are bound by integer multiplies at wide
// batches. At the MSM's tree and Horner widths (down to one lane) they are
// bound by launch latency instead. Design: one thread per point, values
// in registers; the double is one out-of-line function shared by both
// kernels (one copy of its code).
#include <cuda_runtime.h>

#include "g1_jac.cuh"

namespace {

constexpr int kThreads = 128;
using kzg::Jac;
using kzg::NP;
using kzg::jac_add;
using kzg::jac_double;
using kzg::load_jac;
using kzg::store_jac;

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
