// Field kernels K1 (mont_mul), K2 (fr_butterfly_stage), fr_dif_stage,
// butterfly and fr_signed_windows,
// built by nvcc for sm_90a into a shared library with a plain C interface
// (loaded by kzg_tpu_torch/build.py through ctypes).
//
// K1 replaces kzg_tpu/field/pallas_kernels.py::_mul_fn (mont_mul_pallas)
// and, as the fr_scale wrapper, ::_canon_scale_fn (canon_scale): the
// port's FFT never leaves the canonical domain, so the exit kernel reduces
// to a multiply by the broadcast constant 2^-k.
// K2 replaces ::_butterfly_lazy_fn (butterfly_lazy): one radix-2 DIT
// stage, hi = a + b*tw, lo = a - b*tw, here in place on canonical words.
// fr_dif_stage replaces ::_butterfly_lazy_dif_fn (butterfly_lazy_dif): one
// DIF stage of the DAS extension's down-sweep, hi = a + b, lo = (a - b)*tw.
// The Pallas kernel works on lazy 17-limb values in the R_ext domain, so
// it subtracts with a 256m offset and re-reduces the unmultiplied hi chain
// every few levels (reduce_hi). Here every value is canonical after every
// operation, so none of that is needed: the stage is one add, one sub and
// one product per butterfly.
// butterfly replaces ::_butterfly_fn (butterfly_pallas): the canonical
// fused butterfly (a + b*tw, a - b*tw) over separate a, b and tw arrays,
// for Fr or Fp, tw one per lane or one broadcast element. No path runs it
// (in the JAX package too, only a test does); the FFT stays on K2.
// fr_signed_windows is the digit recoding in front of the G1 scalar
// products (fr.scalar_windows_signed, plain tensor code in
// kzg_tpu/field/fr.py:109-130): canonical Fr words -> 64 signed 4-bit
// windows, a + 0x0888...8 (63 eights) then each nibble less 8 (the top one
// as it is). One thread a scalar runs the 8-word carry chain; its plain
// version took some 40 tensor operations a call.
//
// Bound on this card: a canonical product moves 3 x 4N bytes (a, b, out)
// and does 2N^2 + N 32x32->64 multiply-adds (300 for Fp, 136 for Fr).
// Against the published rates (3.35 TB/s; 67 TFLOP/s float32, taken as
// the rate of 32-bit multiply-adds) both kernels are bound by bytes, and
// the two bounds are within a few times of each other, since the card
// issues integer multiplies at no more than half its float32 rate. At the
// main path's widths (at most 20480 lanes) a launch is bound by latency
// instead: each thread runs one long dependent carry chain. Design: one
// thread per lane, words in registers, no shared memory, loops fully
// unrolled (wgmma/TMA-based limb products are later work).
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b, int n, int b_bcast) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[N], y[N];
  kzg::load<N>(x, a + (size_t)i * N);
  kzg::load<N>(y, b + (b_bcast ? 0 : (size_t)i * N));
  kzg::mul<N>(x, x, y);
  kzg::store<N>(out + (size_t)i * N, x);
}

// The 64 signed windows of each canonical Fr scalar, LSB first.
__global__ void __launch_bounds__(kThreads)
    signed_windows_kernel(int32_t* __restrict__ out,
                          const int32_t* __restrict__ a, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int4* o = (int4*)(out + (size_t)i * 64);
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const uint64_t s = (uint64_t)(uint32_t)a[(size_t)i * 8 + k] +
                       (k < 7 ? 0x88888888u : 0x08888888u) + carry;
    const uint32_t w = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
    int d[8];
#pragma unroll
    for (int q = 0; q < 8; q++)
      d[q] = (int)((w >> (4 * q)) & 0xFu) - (8 * k + q < 63 ? 8 : 0);
    o[2 * k] = make_int4(d[0], d[1], d[2], d[3]);
    o[2 * k + 1] = make_int4(d[4], d[5], d[6], d[7]);
  }
}

// hi = a + b*tw, lo = a - b*tw per lane; tw is one element when tw_bcast.
// Bound as K1: it moves 5 x 4N bytes (a, b, tw, hi, lo) for one product.
template <int N>
__global__ void __launch_bounds__(kThreads)
    butterfly_kernel(int32_t* __restrict__ hi, int32_t* __restrict__ lo,
                     const int32_t* __restrict__ a,
                     const int32_t* __restrict__ b,
                     const int32_t* __restrict__ tw, int n, int tw_bcast) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[N], y[N], w[N], s[N];
  kzg::load<N>(x, a + (size_t)i * N);
  kzg::load<N>(y, b + (size_t)i * N);
  kzg::load<N>(w, tw + (tw_bcast ? 0 : (size_t)i * N));
  kzg::mul<N>(y, y, w);
  kzg::add<N>(s, x, y);
  kzg::sub<N>(x, x, y);
  kzg::store<N>(hi + (size_t)i * N, s);
  kzg::store<N>(lo + (size_t)i * N, x);
}

// Thread t of a stage of width m = 2^(log_half+1) over `batch` rows of
// 2^log_n Fr values owns butterfly (row, group, j): positions ia and
// ib = ia + m/2, with twiddle index j.
struct Butterfly {
  size_t ia, ib;
  int j;
};

__device__ __forceinline__ Butterfly butterfly_of(int t, int log_n,
                                                  int log_half) {
  const int row = t >> (log_n - 1);
  const int r = t & ((1 << (log_n - 1)) - 1);
  const int g = r >> log_half;
  const int j = r & ((1 << log_half) - 1);
  const size_t ia = ((size_t)row << log_n) + ((size_t)g << (log_half + 1)) + j;
  return {ia, ia + ((size_t)1 << log_half), j};
}

// One DIT stage: hi = a + b*tw, lo = a - b*tw with tw the table entry
// roots[offset + j * stride].
__global__ void __launch_bounds__(kThreads)
    butterfly_stage_kernel(int32_t* __restrict__ x,
                           const int32_t* __restrict__ roots, int log_n,
                           int log_half, int stride, int offset, int total) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const Butterfly f = butterfly_of(t, log_n, log_half);
  uint32_t a[8], b[8], hi[8], lo[8];
  kzg::load<8>(a, x + f.ia * 8);
  kzg::load<8>(b, x + f.ib * 8);
  // an FFT's first stage (log_half 0, offset 0) has twiddle roots[0] = 1:
  // no multiply. The DAS up-sweep's last level is also 2 wide, but its
  // twiddle roots[offset] is not 1, so a nonzero offset always multiplies.
  if (log_half > 0 || offset != 0) {
    uint32_t w[8];
    kzg::load<8>(w, roots + ((size_t)offset + (size_t)f.j * stride) * 8);
    kzg::mul<8>(b, b, w);
  }
  kzg::add<8>(hi, a, b);
  kzg::sub<8>(lo, a, b);
  kzg::store<8>(x + f.ia * 8, hi);
  kzg::store<8>(x + f.ib * 8, lo);
}

// One DIF stage: hi = a + b, lo = (a - b) * roots[j * stride]; the
// twiddle always multiplies.
__global__ void __launch_bounds__(kThreads)
    dif_stage_kernel(int32_t* __restrict__ x,
                     const int32_t* __restrict__ roots, int log_n,
                     int log_half, int stride, int total) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const Butterfly f = butterfly_of(t, log_n, log_half);
  uint32_t a[8], b[8], w[8], hi[8], lo[8];
  kzg::load<8>(a, x + f.ia * 8);
  kzg::load<8>(b, x + f.ib * 8);
  kzg::load<8>(w, roots + (size_t)f.j * stride * 8);
  kzg::add<8>(hi, a, b);
  kzg::sub<8>(lo, a, b);
  kzg::mul<8>(lo, lo, w);
  kzg::store<8>(x + f.ia * 8, hi);
  kzg::store<8>(x + f.ib * 8, lo);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int kzg_mont_mul(int n_words, void* out, const void* a,
                            const void* b, int n, int b_bcast, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_words == 8) {
    mont_mul_kernel<8><<<blocks(n), kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, n, b_bcast);
  } else if (n_words == 12) {
    mont_mul_kernel<12><<<blocks(n), kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, n, b_bcast);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int kzg_butterfly(int n_words, void* hi, void* lo, const void* a,
                             const void* b, const void* tw, int n,
                             int tw_bcast, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_words == 8) {
    butterfly_kernel<8><<<blocks(n), kThreads, 0, s>>>(
        (int32_t*)hi, (int32_t*)lo, (const int32_t*)a, (const int32_t*)b,
        (const int32_t*)tw, n, tw_bcast);
  } else if (n_words == 12) {
    butterfly_kernel<12><<<blocks(n), kThreads, 0, s>>>(
        (int32_t*)hi, (int32_t*)lo, (const int32_t*)a, (const int32_t*)b,
        (const int32_t*)tw, n, tw_bcast);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int kzg_fr_butterfly_stage(void* x, const void* roots, int log_n,
                                      int log_half, int stride, int offset,
                                      int total, void* stream) {
  butterfly_stage_kernel<<<blocks(total), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (int32_t*)x, (const int32_t*)roots, log_n, log_half, stride, offset,
      total);
  return (int)cudaGetLastError();
}

extern "C" int kzg_fr_dif_stage(void* x, const void* roots, int log_n,
                                int log_half, int stride, int total,
                                void* stream) {
  dif_stage_kernel<<<blocks(total), kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)x, (const int32_t*)roots, log_n, log_half, stride, total);
  return (int)cudaGetLastError();
}

extern "C" int kzg_fr_signed_windows(void* out, const void* a, int n,
                                     void* stream) {
  signed_windows_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)a, n);
  return (int)cudaGetLastError();
}
