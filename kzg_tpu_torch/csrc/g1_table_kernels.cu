// G1 window tables and the fixed-base product of the FK20 Toeplitz step,
// built by nvcc for sm_90a into a shared library with a plain C interface.
//
// g1_window_table: per point B (gathered through an optional index), for
// each window w < W, the entries (m+1) 16^w B, m < 8, as projective words
// (144 bytes a point): 16^w B by four doublings a window, the entries by
// seven additions. W = 1 gives the [1..8]B tables that each G1 FFT stage
// stages into shared memory (g1_fft_kernels.cu); W = 64 gives the
// fixed-base tables T[b][w][m] that the FK20 settings build once for
// their part-1 points.
//
// g1_fixed_base_mul replaces, on the FK20 path, the route of
// kzg_tpu/curve/pallas_g1.py::_scalar_mul_fn (scalar_mul_pallas) in
// toeplitz_part2: per lane, sum_w sign(d_w) T[b][w][|d_w| - 1] over the 64
// signed digits of fr.scalar_windows_signed: 64 additions and no
// doubling, since the bases are fixed when the settings are built. Lane i
// takes base i % n_bases: FK20 gives every lane its own base, a batch of
// commitments shares the CRS tables (kzg/settings.py).
//
// Bound on this card: the 64 additions of a lane are 768 Fp products; its
// table reads 64 x 144 bytes. At 8192 lanes the multiply rate bounds it,
// and the chain of one thread its latency. Design: eight threads a lane,
// each adding eight consecutive windows from the table in device memory
// (L2 holds a call's 75 MB only in part), then three rounds of warp
// shuffles sum the eight partial points in a fixed tree order.
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kParts = 8;         // threads (window groups) per lane
constexpr int kWindows = 64;      // signed 4-bit windows of an Fr scalar
using kzg::NP;
using kzg::Proj;
using kzg::PW;
using kzg::TW;

__global__ void __launch_bounds__(kThreads)
    window_table_kernel(int32_t* __restrict__ tables,
                        const int32_t* __restrict__ px,
                        const int32_t* __restrict__ py,
                        const int32_t* __restrict__ pz,
                        const int32_t* __restrict__ src, int src_n,
                        int n_windows, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t in =
      src ? (size_t)(i / src_n) * src_n + src[i % src_n] : (size_t)i;
  Proj p;
  kzg::jac_to_proj(p, px + in * NP, py + in * NP, pz + in * NP);
  uint32_t* out = (uint32_t*)tables + (size_t)i * n_windows * TW;
#pragma unroll 1
  for (int w = 0; w < n_windows; w++) {
    kzg::build_table(kzg::Table{out + (size_t)w * TW, 1}, p);
    if (w + 1 < n_windows) {
#pragma unroll 1
      for (int k = 0; k < 4; k++) kzg::proj_double(p, p);
    }
  }
}

__device__ __forceinline__ void load_global_point(Proj& r, const uint4* src) {
  uint32_t w[PW];
#pragma unroll
  for (int c = 0; c < PW / 4; c++) {
    const uint4 v = __ldg(src + c);
    w[4 * c] = v.x;
    w[4 * c + 1] = v.y;
    w[4 * c + 2] = v.z;
    w[4 * c + 3] = v.w;
  }
  kzg::load_point(r, w, 1);
}

__global__ void __launch_bounds__(kThreads)
    fixed_base_mul_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                          int32_t* __restrict__ oz,
                          const int32_t* __restrict__ tables,
                          const int32_t* __restrict__ digits, int n,
                          int n_bases) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = t / kParts;
  const int part = t % kParts;
  const bool valid = lane < n;
  Proj acc;
  kzg::proj_identity(acc);
  if (valid) {
    const int w0 = part * (kWindows / kParts);
    const int32_t* dig = digits + (size_t)lane * kWindows + w0;
    const uint4* tab = (const uint4*)tables +
                       ((size_t)(lane % n_bases) * kWindows + w0) * (TW / 4);
#pragma unroll 1
    for (int w = 0; w < kWindows / kParts; w++) {
      const int d = dig[w];
      if (d == 0) continue;
      Proj s;
      load_global_point(s, tab + (w * 8 + (d < 0 ? -d : d) - 1) * (PW / 4));
      if (d < 0) kzg::neg<NP>(s.y, s.y);
      kzg::proj_add(acc, acc, s);
    }
  }
  // partial[p] += partial[p + s] for p < s, s = 4, 2, 1: the tree order
  // of the plain version. Every thread of the warp shuffles.
#pragma unroll 1
  for (int s = kParts / 2; s >= 1; s >>= 1) {
    Proj o;
#pragma unroll
    for (int k = 0; k < NP; k++) {
      o.x[k] = __shfl_down_sync(0xffffffffu, acc.x[k], s);
      o.y[k] = __shfl_down_sync(0xffffffffu, acc.y[k], s);
      o.z[k] = __shfl_down_sync(0xffffffffu, acc.z[k], s);
    }
    if (valid && part < s) kzg::proj_add(acc, acc, o);
  }
  if (valid && part == 0) {
    const size_t o = (size_t)lane * NP;
    kzg::store_jac(ox + o, oy + o, oz + o, acc);
  }
}

}  // namespace

extern "C" int kzg_g1_window_table(void* tables, const void* px,
                                   const void* py, const void* pz,
                                   const void* src, int src_n, int n_windows,
                                   int n, void* stream) {
  window_table_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (int32_t*)tables, (const int32_t*)px, (const int32_t*)py,
      (const int32_t*)pz, (const int32_t*)src, src_n, n_windows, n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_g1_fixed_base_mul(void* ox, void* oy, void* oz,
                                     const void* tables, const void* digits,
                                     int n, int n_bases, void* stream) {
  const long threads = (long)n * kParts;
  fixed_base_mul_kernel<<<(int)((threads + kThreads - 1) / kThreads),
                          kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)tables,
      (const int32_t*)digits, n, n_bases);
  return (int)cudaGetLastError();
}
