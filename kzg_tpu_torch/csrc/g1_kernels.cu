// G1 ladder kernels K3 (g1_scalar_mul) and K4 (g1_glv_butterfly), built by
// nvcc for sm_90a into a shared library with a plain C interface.
//
// K3 replaces kzg_tpu/curve/pallas_g1.py::_scalar_mul_fn
// (scalar_mul_pallas): per lane, P * sum_j d_j 16^j from 64 signed digits,
// MSB-first Horner (4 doublings, then add d_j * P from a [1..8]P table).
// K4 replaces ::_scalar_mul_glv_fn (butterfly_glv_pallas): per lane,
// t = sum_j d1_j 16^j B + sum_j d2_j 16^j phi(B), then lo = A + t and
// hi = A - t. B must lie in the r-torsion subgroup (phi = lambda there).
//
// Bound on this card: integer multiply throughput. A K3 lane is about
// 7 + 64*4 + 64 point operations of 8-12 Fp products, each 288 32x32->64
// multiply-adds; bytes moved are a few hundred per lane. Design: one
// thread per lane with every Fp value canonical in registers; the point
// formulas are out-of-line functions (one copy each) to bound code size
// and build time. The [1..8]P table (8 x 36 words = 288 words) is indexed
// by a runtime digit and lives in local memory; that spill is accepted in
// this simple version. At the G1 FFT's widths (64 butterflies per stage
// at 128 points) a launch fills one block: those launches are bound by
// latency, not throughput.
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

constexpr int kThreads = 64;
using kzg::NP;
using kzg::Proj;

__global__ void __launch_bounds__(kThreads)
    scalar_mul_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                      int32_t* __restrict__ oz, const int32_t* __restrict__ px,
                      const int32_t* __restrict__ py,
                      const int32_t* __restrict__ pz,
                      const int32_t* __restrict__ digits, int n_windows,
                      int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)i * NP;
  Proj tbl[8];
  kzg::jac_to_proj(&tbl[0], px + o, py + o, pz + o);
  kzg::build_table(tbl);
  Proj acc;
  kzg::proj_identity(&acc);
  const int32_t* dig = digits + (size_t)i * n_windows;
  for (int w = n_windows - 1; w >= 0; w--) {
    for (int k = 0; k < 4; k++) kzg::proj_double(&acc, &acc);
    kzg::apply_digit(&acc, tbl, dig[w], false);
  }
  kzg::store_jac(ox + o, oy + o, oz + o, &acc);
}

__global__ void __launch_bounds__(kThreads)
    glv_butterfly_kernel(int32_t* __restrict__ lox, int32_t* __restrict__ loy,
                         int32_t* __restrict__ loz, int32_t* __restrict__ hix,
                         int32_t* __restrict__ hiy, int32_t* __restrict__ hiz,
                         const int32_t* __restrict__ ax,
                         const int32_t* __restrict__ ay,
                         const int32_t* __restrict__ az,
                         const int32_t* __restrict__ bx,
                         const int32_t* __restrict__ by,
                         const int32_t* __restrict__ bz,
                         const int32_t* __restrict__ d1,
                         const int32_t* __restrict__ d2, int n_windows,
                         int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)i * NP;
  Proj tbl[8];
  kzg::jac_to_proj(&tbl[0], bx + o, by + o, bz + o);
  kzg::build_table(tbl);
  // t, lo and hi are one stack object: written as three separate Proj
  // locals (each address passed to the out-of-line point functions), the
  // card returned hi = A, against hi = A - t from the plain version, with
  // CUDA 12.8. Kept in one array, the outputs match bit for bit.
  Proj st[3];
  Proj* t = &st[0];
  Proj* lo = &st[1];
  Proj* hi = &st[2];
  kzg::proj_identity(t);
  const int32_t* e1 = d1 + (size_t)i * n_windows;
  const int32_t* e2 = d2 + (size_t)i * n_windows;
  for (int w = n_windows - 1; w >= 0; w--) {
    for (int k = 0; k < 4; k++) kzg::proj_double(t, t);
    kzg::apply_digit(t, tbl, e1[w], false);
    kzg::apply_digit(t, tbl, e2[w], true);
  }
  kzg::jac_to_proj(lo, ax + o, ay + o, az + o);
  *hi = *lo;
  kzg::proj_add(lo, lo, t);
  kzg::neg<NP>(t->y, t->y);
  kzg::proj_add(hi, hi, t);
  kzg::store_jac(lox + o, loy + o, loz + o, lo);
  kzg::store_jac(hix + o, hiy + o, hiz + o, hi);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int kzg_g1_scalar_mul(void* ox, void* oy, void* oz, const void* px,
                                 const void* py, const void* pz,
                                 const void* digits, int n_windows, int n,
                                 void* stream) {
  scalar_mul_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)px,
      (const int32_t*)py, (const int32_t*)pz, (const int32_t*)digits,
      n_windows, n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_g1_glv_butterfly(void* lox, void* loy, void* loz,
                                    void* hix, void* hiy, void* hiz,
                                    const void* ax, const void* ay,
                                    const void* az, const void* bx,
                                    const void* by, const void* bz,
                                    const void* d1, const void* d2,
                                    int n_windows, int n, void* stream) {
  glv_butterfly_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)lox, (int32_t*)loy, (int32_t*)loz, (int32_t*)hix,
      (int32_t*)hiy, (int32_t*)hiz, (const int32_t*)ax, (const int32_t*)ay,
      (const int32_t*)az, (const int32_t*)bx, (const int32_t*)by,
      (const int32_t*)bz, (const int32_t*)d1, (const int32_t*)d2, n_windows,
      n);
  return (int)cudaGetLastError();
}
