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
// for Fr or Fp, tw one per lane or one broadcast element, as a streaming
// kernel bound by bytes (butterfly_stream_kernel). No path runs it (in
// the JAX package too, only a test does).
// fr_signed_windows is the digit recoding in front of the G1 scalar
// products (fr.scalar_windows_signed, plain tensor code in
// kzg_tpu/field/fr.py:109-130): Montgomery Fr words -> 64 signed 4-bit
// windows; the reduction (REDC by 1, kzg::from_mont) runs in the same
// launch, then a + 0x0888...8 (63 eights) and each nibble less 8 (the top
// one as it is). Four threads a scalar; bound by the 256 bytes of digits
// a scalar written.
//
// Bound on this card: a canonical product moves 3 x 4N bytes (a, b, out)
// and does 2N^2 + N 32x32->64 multiply-adds (300 for Fp, 136 for Fr).
// Against the published rates (3.35 TB/s; 67 TFLOP/s float32, taken as
// the rate of 32-bit multiply-adds) K1 and K2 are bound by bytes, and
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

// Threads a scalar in fr_signed_windows. A warp runs the reduction once
// for all its lanes, so its cost goes with the warps, i.e. with the
// threads a scalar; two threads a scalar still store whole 32-byte
// sectors (eight 16-byte stores a thread). Four and eight were slower.
constexpr int kWinThreads = 2;

// The 64 signed windows of each Fr scalar in Montgomery form, LSB first.
// The threads of a scalar each read its 32 bytes (one broadcast from L1),
// run the reduction (REDC by 1) and the bias add's carry chain over all
// eight words (the same work on every thread, no shuffle), and thread k
// stores the 16-byte parts k, k + kWinThreads, ... (4 digits, one 16-bit
// half of a biased word, each): a warp's store instruction writes
// 16 kWinThreads contiguous bytes of each of its 32 / kWinThreads
// scalars, whole sectors, and the warp writes its scalars' digits as one
// run.
__global__ void __launch_bounds__(kThreads)
    signed_windows_kernel(int32_t* __restrict__ out,
                          const int32_t* __restrict__ a, int n) {
  const size_t g = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t i = g / kWinThreads;
  const int k = (int)(g % kWinThreads);
  if (i >= (size_t)n) return;
  const uint4* src = (const uint4*)a + i * 2;
  const uint4 lo4 = __ldg(src), hi4 = __ldg(src + 1);
  uint32_t t[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
  kzg::from_mont<8>(t);
  // + 0x0888...8 (63 eights): every digit but the top one gains 8
  uint32_t s[8];
  s[0] = kzg::ptx::add_cc(t[0], 0x88888888u);
#pragma unroll
  for (int j = 1; j < 7; j++) s[j] = kzg::ptx::addc_cc(t[j], 0x88888888u);
  s[7] = kzg::ptx::addc(t[7], 0x08888888u);
  int4* o = (int4*)out + i * 16;
#pragma unroll
  for (int p = 0; p < 16 / kWinThreads; p++) {
    const int part = k + kWinThreads * p;
    // s[part / 2] by selects: an index into s not known at compile time
    // would put s in local memory
    uint32_t w = s[0];
#pragma unroll
    for (int j = 1; j < 8; j++)
      if (part / 2 == j) w = s[j];
    const uint32_t h = w >> (16 * (part & 1));
    o[part] = make_int4((int)(h & 0xFu) - 8, (int)((h >> 4) & 0xFu) - 8,
                        (int)((h >> 8) & 0xFu) - 8,
                        (int)((h >> 12) & 0xFu) - (part == 15 ? 0 : 8));
  }
}

// A lane of N words as N / 4 16-byte loads through the read-only path,
// and its streaming stores (the butterfly's outputs are not read again).
template <int N>
__device__ __forceinline__ void load_lane(uint32_t r[N],
                                          const int32_t* __restrict__ p,
                                          size_t i) {
  const uint4* v = (const uint4*)p + i * (N / 4);
#pragma unroll
  for (int q = 0; q < N / 4; q++) {
    const uint4 u = __ldg(v + q);
    r[4 * q] = u.x;
    r[4 * q + 1] = u.y;
    r[4 * q + 2] = u.z;
    r[4 * q + 3] = u.w;
  }
}

template <int N>
__device__ __forceinline__ void store_lane(int32_t* __restrict__ p, size_t i,
                                           const uint32_t a[N]) {
  uint4* v = (uint4*)p + i * (N / 4);
#pragma unroll
  for (int q = 0; q < N / 4; q++)
    __stcs(v + q, make_uint4(a[4 * q], a[4 * q + 1], a[4 * q + 2],
                             a[4 * q + 3]));
}

// hi = a + b*tw, lo = a - b*tw per lane; tw is one element when tw_bcast.
// It moves 5 x 4N bytes a lane (a, b, tw, hi, lo) for one product, so
// bytes bound it at any width (2^20 Fr lanes: 168 MB, 0.050 ms at 3.35
// TB/s; the products 0.0044 ms at the float32 rate). A grid of the
// blocks the SMs hold at once walks the lanes, one a thread, neighbouring
// threads on neighbouring lanes; each lane's 16-byte loads are all issued
// before its product; a broadcast twiddle is read once a thread. Two
// lanes a thread (more bytes in flight a thread) and a TMA form (tiles
// staged in shared memory by bulk copies on an mbarrier) were both slower
// or no faster at 2^16 and 2^20, Fr and Fp: with one lane a thread more
// warps are resident to overlap the Fp products with the loads.
template <int N>
__global__ void __launch_bounds__(kThreads)
    butterfly_stream_kernel(int32_t* __restrict__ hi,
                            int32_t* __restrict__ lo,
                            const int32_t* __restrict__ a,
                            const int32_t* __restrict__ b,
                            const int32_t* __restrict__ tw, int n,
                            int tw_bcast) {
  uint32_t w[N];
  if (tw_bcast) load_lane<N>(w, tw, 0);
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
       i < (size_t)n; i += (size_t)gridDim.x * kThreads) {
    uint32_t x[N], y[N], s[N];
    load_lane<N>(x, a, i);
    load_lane<N>(y, b, i);
    if (!tw_bcast) load_lane<N>(w, tw, i);
    kzg::mul<N>(y, y, w);
    kzg::add<N>(s, x, y);
    kzg::sub<N>(x, x, y);
    store_lane<N>(hi, i, s);
    store_lane<N>(lo, i, x);
  }
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

// A grid for a kernel that walks `lanes` lanes, kThreads a block in one
// step: no more blocks than the SMs hold at once.
template <typename Kernel>
int stream_grid(Kernel kernel, int lanes) {
  int dev = 0, sms = 0, resident = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads,
                                                0);
  const int need = (lanes + kThreads - 1) / kThreads;
  return need < sms * resident ? need : sms * resident;
}

extern "C" int kzg_butterfly(int n_words, void* hi, void* lo, const void* a,
                             const void* b, const void* tw, int n,
                             int tw_bcast, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_words == 8) {
    const int g = stream_grid(butterfly_stream_kernel<8>, n);
    butterfly_stream_kernel<8><<<g, kThreads, 0, s>>>(
        (int32_t*)hi, (int32_t*)lo, (const int32_t*)a, (const int32_t*)b,
        (const int32_t*)tw, n, tw_bcast);
  } else if (n_words == 12) {
    const int g = stream_grid(butterfly_stream_kernel<12>, n);
    butterfly_stream_kernel<12><<<g, kThreads, 0, s>>>(
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
  const int grid = (int)(((size_t)n * kWinThreads + kThreads - 1) / kThreads);
  signed_windows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)a, n);
  return (int)cudaGetLastError();
}
