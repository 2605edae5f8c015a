// Variable-base G1 ladder kernels K3 (g1_scalar_mul) and K4
// (g1_glv_butterfly), built by nvcc for sm_90a into a shared library with
// a plain C interface.
//
// K3 replaces kzg_tpu/curve/pallas_g1.py::_scalar_mul_fn
// (scalar_mul_pallas): per lane, P * sum_j d_j 16^j from 64 signed digits,
// MSB-first Horner (4 doublings, then add d_j * P from a [1..8]P table).
// It stays for g1.mul (the CRS, tests); the FK20 Toeplitz product runs on
// the fixed-base kernel (g1_table_kernels.cu). K4 replaces
// ::_scalar_mul_glv_fn (butterfly_glv_pallas): per lane,
// t = sum_j d1_j 16^j B + sum_j d2_j 16^j phi(B), then lo = A + t and
// hi = A - t. B must lie in the r-torsion subgroup (phi = lambda there).
// The G1 FFT runs its radix-2 stages on K4 and its wider ones on
// g1_fft_stage (g1_fft_kernels.cu).
//
// Bound on this card: a lane is one dependent chain of about 64 * 4 + 64
// (K3) or 33 * 4 + 66 (K4) point operations of 8-12 Fp products, so at a
// few thousand lanes the launch is bound by that chain's latency, not by
// the multiply rate. Design: one thread per lane, every point in
// registers (g1.cuh), the lane's [1..8]P table in dynamic shared memory
// interleaved across the block's threads.
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kSmem = kThreads * kzg::TW * 4;  // 73,728 bytes
using kzg::NP;
using kzg::Proj;

__global__ void __launch_bounds__(kThreads)
    scalar_mul_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                      int32_t* __restrict__ oz, const int32_t* __restrict__ px,
                      const int32_t* __restrict__ py,
                      const int32_t* __restrict__ pz,
                      const int32_t* __restrict__ digits, int n_windows,
                      int n) {
  extern __shared__ uint32_t smem[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)i * NP;
  const kzg::Table tbl{smem + threadIdx.x, kThreads};
  Proj p, acc;
  kzg::jac_to_proj(p, px + o, py + o, pz + o);
  kzg::build_table(tbl, p);
  kzg::ladder<int32_t>(acc, tbl, digits + (size_t)i * n_windows, nullptr,
                       n_windows);
  kzg::store_jac(ox + o, oy + o, oz + o, acc);
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
  extern __shared__ uint32_t smem[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)i * NP;
  const kzg::Table tbl{smem + threadIdx.x, kThreads};
  // An earlier version kept t, lo and hi in one stack array: as three
  // separate locals whose addresses went to out-of-line point functions,
  // the card returned hi = A. The points are register values now, passed
  // to inline functions, and plain locals give the plain version's words.
  Proj b, t, a;
  kzg::jac_to_proj(b, bx + o, by + o, bz + o);
  kzg::build_table(tbl, b);
  kzg::ladder<int32_t>(t, tbl, d1 + (size_t)i * n_windows,
                       d2 + (size_t)i * n_windows, n_windows);
  kzg::jac_to_proj(a, ax + o, ay + o, az + o);
#pragma unroll 1
  for (int h = 0; h < 2; h++) {  // lo = A + t, then hi = A - t
    Proj out;
    if (h) kzg::neg<NP>(t.y, t.y);
    kzg::proj_add(out, a, t);
    if (h) kzg::store_jac(hix + o, hiy + o, hiz + o, out);
    else kzg::store_jac(lox + o, loy + o, loz + o, out);
  }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

template <typename K>
int allow_smem(K kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
}

}  // namespace

extern "C" int kzg_g1_scalar_mul(void* ox, void* oy, void* oz, const void* px,
                                 const void* py, const void* pz,
                                 const void* digits, int n_windows, int n,
                                 void* stream) {
  if (int err = allow_smem(scalar_mul_kernel)) return err;
  scalar_mul_kernel<<<blocks(n), kThreads, kSmem, (cudaStream_t)stream>>>(
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
  if (int err = allow_smem(glv_butterfly_kernel)) return err;
  glv_butterfly_kernel<<<blocks(n), kThreads, kSmem, (cudaStream_t)stream>>>(
      (int32_t*)lox, (int32_t*)loy, (int32_t*)loz, (int32_t*)hix,
      (int32_t*)hiy, (int32_t*)hiz, (const int32_t*)ax, (const int32_t*)ay,
      (const int32_t*)az, (const int32_t*)bx, (const int32_t*)by,
      (const int32_t*)bz, (const int32_t*)d1, (const int32_t*)d2, n_windows,
      n);
  return (int)cudaGetLastError();
}
