// The G1 FFT stage kernel g1_fft_stage, built by nvcc for sm_90a into a
// shared library with a plain C interface.
//
// It replaces, for the G1 FFT, the route of
// kzg_tpu/curve/pallas_g1.py::_scalar_mul_glv_fn (butterfly_glv_pallas),
// which runs one radix-2 butterfly stage a launch. Here one launch is a
// whole radix-r stage (curve/fft_g1.py): for each group g of r inputs,
//     out[g, k] = sum_{j < r} s[g, k, j] in[g, j],    k < r,
// with s the DFT root times the inter-stage twiddle (and 1/n on the
// inverse's last stage), given as host GLV digit rows (curve/glv.py).
// r = n does a whole 128-point transform in one launch.
//
// Bound on this card: each term is one GLV ladder of 33 windows (about
// 1,900 Fp products); at the PeerDAS shape's 128 points the dense stage's
// 16,384 terms fill the card with one dependent ladder a thread, so its
// time is about one ladder's latency plus the log2(r) additions of the sum.
// Design: one thread per term, every point in registers (g1.cuh). The
// [1..8] table of each input is built once per launch by
// g1_window_table (g1_table_kernels.cu) and staged into shared memory
// with cp.async (16-byte copies, a 16-byte pad per table against bank
// conflicts): at r = 128 a block holds 128 tables, 146 KB. A block holds
// 128 terms, one output or several; its outputs' r partial points are
// summed in shared memory in a fixed tree order (partial j += partial
// j + s for j < s, s = r/2, ..., 1): deterministic, no atomics.
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTabStride = kzg::TW + 4;   // 292 words, 1,168 bytes
constexpr int kDigits = 33;               // GLV windows per half-scalar
using kzg::NP;
using kzg::Proj;

__global__ void __launch_bounds__(kThreads)
    fft_stage_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                     int32_t* __restrict__ oz,
                     const int32_t* __restrict__ tables,
                     const int8_t* __restrict__ digits,
                     const int32_t* __restrict__ dst, int n, int log_r,
                     int n_sets, long n_terms) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int r = 1 << log_r;
  const int tid = threadIdx.x;
  const long i0 = (long)blockIdx.x * kThreads;
  const long i = i0 + tid;
  const bool valid = i < n_terms;

  // stage the tables of the block's groups: group g's inputs are tables
  // g r .. g r + r - 1
  const long g0 = i0 >> (2 * log_r);
  const long i_end = i0 + kThreads < n_terms ? i0 + kThreads : n_terms;
  const long g_last = (i_end - 1) >> (2 * log_r);
  const int n_tab = (int)(g_last - g0 + 1) << log_r;
  constexpr int kChunks = kzg::TW / 4;    // 16-byte chunks of a table
  const char* src = (const char*)tables + (size_t)(g0 << log_r) * kzg::TW * 4;
  for (int c = tid; c < n_tab * kChunks; c += kThreads) {
    const int tab = c / kChunks, off = c % kChunks;
    const uint32_t saddr = (uint32_t)__cvta_generic_to_shared(
        smem + tab * kTabStride + off * 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(saddr), "l"(src + ((size_t)tab * kChunks + off) * 16));
  }
  asm volatile("cp.async.commit_group;");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  const long g = i >> (2 * log_r);
  const int k = (int)((i >> log_r) & (r - 1));
  const int j = (int)(i & (r - 1));
  const long per = n >> log_r;           // groups per transform
  const long gl = g % per;
  Proj acc;
  if (valid) {
    const int q = (int)(gl % n_sets);
    const int8_t* d =
        digits + ((((size_t)q << log_r) + k) << log_r | j) * (2 * kDigits);
    const kzg::Table tbl{smem + (((g - g0) << log_r) | j) * kTabStride, 1};
    kzg::ladder<int8_t>(acc, tbl, d, d + kDigits, kDigits);
  }
  __syncthreads();  // every table read: the partials reuse the space
  if (valid) kzg::store_point(smem + tid, kThreads, acc);
#pragma unroll 1
  for (int s = r >> 1; s >= 1; s >>= 1) {
    __syncthreads();
    if (valid && j < s) {
      Proj o;
      kzg::load_point(o, smem + tid + s, kThreads);
      kzg::proj_add(acc, acc, o);
      kzg::store_point(smem + tid, kThreads, acc);
    }
  }
  if (valid && j == 0) {
    const size_t o = ((size_t)(g / per) * n + dst[gl * r + k]) * NP;
    kzg::store_jac(ox + o, oy + o, oz + o, acc);
  }
}

}  // namespace

// smem_bytes: max(tables a block stages, 128 partial points), from the
// wrapper (curve/kernels.py).
extern "C" int kzg_g1_fft_stage(void* ox, void* oy, void* oz,
                                const void* tables, const void* digits,
                                const void* dst, int n, int log_r,
                                int n_sets, int n_groups, int smem_bytes,
                                void* stream) {
  if (int err = (int)cudaFuncSetAttribute(
          fft_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes))
    return err;
  const long n_terms = (long)n_groups << (2 * log_r);
  fft_stage_kernel<<<(int)((n_terms + kThreads - 1) / kThreads), kThreads,
                     smem_bytes, (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)tables,
      (const int8_t*)digits, (const int32_t*)dst, n, log_r, n_sets, n_terms);
  return (int)cudaGetLastError();
}
