// The Hopper routes of K1 (mont_mul) and K2 (fr_butterfly_stage): the
// chains of field operations that the recovery and the Fr FFT ran as one
// small launch per operation, each now one kernel. Built by nvcc for
// sm_90a into a shared library with a plain C interface (loaded by
// kzg_tpu_torch/build.py through ctypes).
//
// fr_add_sub: add, sub or neg for Fr or Fp words, b one element or one a
//   lane. It replaces plain tensor code (kzg_tpu/field/fr.py, fp.py: add,
//   sub, neg), no Pallas site. Bound by bytes (3 x 4N a lane).
// fr_pow: a^e for a static exponent, one thread a lane, the ladder in
//   registers (K1's route for the Fermat ladder,
//   kzg_tpu/field/limbs.py:353-376 on ::_mul_fn). A one-lane call is one
//   dependent chain of products: bound by the product's latency.
// fr_batch_inv: the Montgomery trick (kzg_tpu/field/limbs.py:389-422 on
//   ::_mul_fn) in one launch for n <= kInvBlockLanes, three above: a
//   thread multiplies a chunk of lanes, the block scans the chunk
//   products both ways in shared memory, one thread inverts the total
//   with the fr_pow ladder, and a back pass writes every inverse. Zero
//   lanes count as one and map to 0. Bound by latency: the chunk, the
//   scan's 2 log2(threads) levels and the ladder's ~417 products are one
//   chain.
// fr_fft_block: kk consecutive DIT stages of a batch of Fr transforms in
//   shared memory (K2's route, kzg_tpu/field/pallas_kernels.py::
//   _butterfly_lazy_fn, one launch a stage there and in K2). A pass with
//   `lo` stages done before it takes the 2^kk values of a tile at stride
//   2^lo: tile (hi, o) holds positions hi 2^(lo+kk) + i 2^lo + o, and its
//   stage s = lo + 1 + st pairs i with i + 2^st under the twiddle
//   roots[(o + (i mod 2^st) 2^lo) << (log_max - s)]. The first pass may
//   read its input in bit-reversed order (the DIT input permutation) and
//   the last may scale by an inverse's 2^-k in its store. The tile is
//   word-major in shared memory (word w of value i at w (tile + 4) + i),
//   so a warp's loads and stores of 4 values x 8 words, and its
//   butterflies' reads, hit 32 different banks. An 8192-point transform
//   takes 2 passes, 2^20 takes 2: bound by bytes (2 x 2 x 32 B a value
//   and the twiddles) and the products (n/2 log2 n), both far below the
//   per-stage route's 20 passes over the values.
// fr_zero_poly_leaves: the zero polynomial's leaves, prod (x - r) over
//   up to 64 factors each (plain tensor code,
//   kzg_tpu/das/zero_poly.py:34-51), one block a leaf and one thread a
//   coefficient: step c_i <- c_(i-1) + c_i (-r) with the neighbour's
//   value from shared memory, one barrier a step. Bound by latency: 64
//   dependent products.
#include <cuda_runtime.h>

#include <algorithm>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInvThreads = 256;
constexpr int kInvBlockLanes = 8192;
constexpr int kFftTileLog = 11;
constexpr int kFftThreads = 256;
constexpr int kFftPad = 4;
constexpr int kLeafWidth = 128;
constexpr int kLeafFactors = 64;

enum { kAdd = 0, kSub = 1, kNeg = 2 };
enum { kInvFull = 0, kInvUp = 1, kInvDown = 2 };

// A static exponent by value: its words, LSB first, and its bit length.
struct Exponent {
  uint32_t w[12];
  int bits;
};

// An Fr constant by value (Montgomery words).
struct FrConst {
  uint32_t w[8];
};

template <int N>
__device__ __forceinline__ void set_one(uint32_t r[N]) {
#pragma unroll
  for (int i = 0; i < N; i++) r[i] = kzg::Field<N>::one(i);
}

template <int N>
__device__ __forceinline__ void set_zero(uint32_t r[N]) {
#pragma unroll
  for (int i = 0; i < N; i++) r[i] = 0;
}

// r = a^e: square and multiply from the bit below the top one; e = 0
// gives one, 0^e (e > 0) gives 0. r may alias a.
template <int N>
__device__ __forceinline__ void pow_static(uint32_t r[N],
                                           const uint32_t a[N],
                                           const Exponent& e) {
  if (e.bits == 0) {
    set_one<N>(r);
    return;
  }
  uint32_t base[N], acc[N];
  kzg::copy<N>(base, a);
  kzg::copy<N>(acc, a);
  for (int k = e.bits - 2; k >= 0; k--) {
    kzg::mul<N>(acc, acc, acc);
    if ((e.w[k >> 5] >> (k & 31)) & 1u) kzg::mul<N>(acc, acc, base);
  }
  kzg::copy<N>(r, acc);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    add_sub_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                   const int32_t* __restrict__ b, int n, int op,
                   int b_bcast) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[N], y[N];
  kzg::load<N>(x, a + (size_t)i * N);
  if (op == kNeg) {
    kzg::neg<N>(x, x);
  } else {
    kzg::load<N>(y, b + (b_bcast ? 0 : (size_t)i * N));
    if (op == kAdd)
      kzg::add<N>(x, x, y);
    else
      kzg::sub<N>(x, x, y);
  }
  kzg::store<N>(out + (size_t)i * N, x);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    pow_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
               int n, Exponent e) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[N];
  kzg::load<N>(x, a + (size_t)i * N);
  pow_static<N>(x, x, e);
  kzg::store<N>(out + (size_t)i * N, x);
}

// Block b, thread t owns lanes [start, end) of `in`, start = (b T + t)
// chunk. Phase kInvFull (one block) does everything; kInvUp writes the
// lanes' running products in the chunk to `out` and the block's total to
// totals[b]; kInvDown takes the chunk products back from `out` and the
// inverse of the block's total from totals[b] (inverted in between by a
// kInvFull launch on the totals), then runs the back pass.
__global__ void __launch_bounds__(kInvThreads)
    batch_inv_kernel(int32_t* __restrict__ out,
                     const int32_t* __restrict__ in, int n, int chunk,
                     int32_t* __restrict__ totals, int phase, Exponent e) {
  __shared__ uint32_t P[8][kInvThreads], Q[8][kInvThreads];
  __shared__ uint32_t total_inv[8];
  const int t = threadIdx.x;
  const size_t start = ((size_t)blockIdx.x * kInvThreads + t) * chunk;
  const size_t end =
      start + chunk < (size_t)n ? start + chunk : (size_t)n;
  uint32_t acc[8], x[8];
  set_one<8>(acc);
  if (phase == kInvDown) {
    if (end > start) kzg::load<8>(acc, out + (end - 1) * 8);
  } else {
    for (size_t i = start; i < end; i++) {
      kzg::load<8>(x, in + i * 8);
      if (!kzg::is_zero<8>(x)) kzg::mul<8>(acc, acc, x);
      kzg::store<8>(out + i * 8, acc);
    }
  }
  // inclusive prefix (P) and suffix (Q) products of the chunk products
  uint32_t p[8], q[8];
  kzg::copy<8>(p, acc);
  kzg::copy<8>(q, acc);
#pragma unroll
  for (int w = 0; w < 8; w++) P[w][t] = Q[w][t] = acc[w];
  __syncthreads();
  for (int d = 1; d < kInvThreads; d <<= 1) {
    uint32_t pa[8], qa[8];
    const bool hp = t >= d, hq = t + d < kInvThreads;
#pragma unroll
    for (int w = 0; w < 8; w++) {
      pa[w] = hp ? P[w][t - d] : 0;
      qa[w] = hq ? Q[w][t + d] : 0;
    }
    __syncthreads();
    if (hp) kzg::mul<8>(p, pa, p);
    if (hq) kzg::mul<8>(q, qa, q);
#pragma unroll
    for (int w = 0; w < 8; w++) {
      P[w][t] = p[w];
      Q[w][t] = q[w];
    }
    __syncthreads();
  }
  if (phase == kInvUp) {
    if (t == 0) {
#pragma unroll
      for (int w = 0; w < 8; w++)
        totals[(size_t)blockIdx.x * 8 + w] = (int32_t)P[w][kInvThreads - 1];
    }
    return;
  }
  if (t == 0) {
    uint32_t tot[8];
    if (phase == kInvDown) {
      kzg::load<8>(tot, totals + (size_t)blockIdx.x * 8);
    } else {
#pragma unroll
      for (int w = 0; w < 8; w++) tot[w] = P[w][kInvThreads - 1];
      pow_static<8>(tot, tot, e);
    }
#pragma unroll
    for (int w = 0; w < 8; w++) total_inv[w] = tot[w];
  }
  __syncthreads();
  // the inverse of this chunk's product: total^-1 x (chunks before) x
  // (chunks after)
  uint32_t c[8], y[8], r[8];
#pragma unroll
  for (int w = 0; w < 8; w++) {
    c[w] = total_inv[w];
    x[w] = t > 0 ? P[w][t - 1] : kzg::Field<8>::one(w);
    y[w] = t + 1 < kInvThreads ? Q[w][t + 1] : kzg::Field<8>::one(w);
  }
  kzg::mul<8>(c, c, x);
  kzg::mul<8>(c, c, y);
  for (size_t i = end; i-- > start;) {
    uint32_t prev[8];
    kzg::load<8>(x, in + i * 8);
    if (i > start)
      kzg::load<8>(prev, out + (i - 1) * 8);
    else
      set_one<8>(prev);
    const bool zero = kzg::is_zero<8>(x);
    kzg::mul<8>(r, c, prev);
    if (!zero) kzg::mul<8>(c, c, x);
    if (zero) set_zero<8>(r);
    kzg::store<8>(out + i * 8, r);
  }
}

__device__ __forceinline__ size_t bit_reverse(size_t p, int bits) {
  return bits ? (size_t)(__brev((unsigned)p) >> (32 - bits)) : 0;
}

// One pass of kk DIT stages over tiles of 2^kk values; see the head of
// the file. Block = (row, tile), tile = (hi, o). src may equal dst
// unless brev: each block reads its whole tile before it writes.
__global__ void __launch_bounds__(kFftThreads)
    fft_block_kernel(const int32_t* src, int32_t* dst,
                     const int32_t* __restrict__ roots, int log_n, int lo,
                     int kk, int log_max, int brev, int scale_on,
                     FrConst scale) {
  extern __shared__ uint32_t sm[];
  const int tile = 1 << kk;
  const int ld = tile + kFftPad;
  const size_t blk = blockIdx.x;
  const size_t row0 = (blk >> (log_n - kk)) << log_n;
  const size_t tid = blk & (((size_t)1 << (log_n - kk)) - 1);
  const size_t o = tid & (((size_t)1 << lo) - 1);
  const size_t base = ((tid >> lo) << (lo + kk)) + o;
  for (int k = threadIdx.x; k < 8 * tile; k += blockDim.x) {
    const int i = k >> 3, w = k & 7;
    size_t p = base + ((size_t)i << lo);
    if (brev) p = bit_reverse(p, log_n);
    sm[w * ld + i] = (uint32_t)src[(row0 + p) * 8 + w];
  }
  __syncthreads();
  for (int st = 0; st < kk; st++) {
    const int s = lo + 1 + st;
    const int half = 1 << st;
    for (int b = threadIdx.x; b < tile / 2; b += blockDim.x) {
      const int jl = b & (half - 1);
      const int i = ((b >> st) << (st + 1)) | jl;
      uint32_t x[8], y[8], u[8];
#pragma unroll
      for (int w = 0; w < 8; w++) {
        x[w] = sm[w * ld + i];
        y[w] = sm[w * ld + i + half];
      }
      // the first stage's twiddle is roots[0] = 1: no multiply
      if (s > 1) {
        uint32_t tw[8];
        const size_t j = o + ((size_t)jl << lo);
        kzg::load<8>(tw, roots + (j << (log_max - s)) * 8);
        kzg::mul<8>(y, y, tw);
      }
      kzg::add<8>(u, x, y);
      kzg::sub<8>(x, x, y);
#pragma unroll
      for (int w = 0; w < 8; w++) {
        sm[w * ld + i] = u[w];
        sm[w * ld + i + half] = x[w];
      }
    }
    __syncthreads();
  }
  if (scale_on) {
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      uint32_t x[8];
#pragma unroll
      for (int w = 0; w < 8; w++) x[w] = sm[w * ld + i];
      kzg::mul<8>(x, x, scale.w);
#pragma unroll
      for (int w = 0; w < 8; w++) sm[w * ld + i] = x[w];
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < 8 * tile; k += blockDim.x) {
    const int i = k >> 3, w = k & 7;
    dst[(row0 + base + ((size_t)i << lo)) * 8 + w] = (int32_t)sm[w * ld + i];
  }
}

// Leaf g: factor s is roots[factors[g][s]], or none where that is < 0.
__global__ void __launch_bounds__(kLeafWidth)
    zero_poly_leaves_kernel(int32_t* __restrict__ out,
                            const int32_t* __restrict__ roots,
                            const int32_t* __restrict__ factors) {
  __shared__ uint32_t buf[2][8][kLeafWidth];
  const int g = blockIdx.x, i = threadIdx.x;
  uint32_t c[8];
  if (i == 0)
    set_one<8>(c);
  else
    set_zero<8>(c);
  int p = 0;
  for (int s = 0; s < kLeafFactors; s++) {
    const int idx = factors[g * kLeafFactors + s];
    if (idx < 0) continue;  // the same for the whole block
    uint32_t nr[8], prev[8];
    kzg::load<8>(nr, roots + (size_t)idx * 8);
    kzg::neg<8>(nr, nr);
#pragma unroll
    for (int w = 0; w < 8; w++) buf[p][w][i] = c[w];
    // two buffers: a step's writes never meet the last step's reads
    __syncthreads();
#pragma unroll
    for (int w = 0; w < 8; w++) prev[w] = i > 0 ? buf[p][w][i - 1] : 0;
    kzg::mul<8>(c, c, nr);
    kzg::add<8>(c, prev, c);
    p ^= 1;
  }
  kzg::store<8>(out + ((size_t)g * kLeafWidth + i) * 8, c);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

Exponent exponent(const void* words, int bits) {
  Exponent e = {};
  const uint32_t* w = (const uint32_t*)words;
  for (int i = 0; i < (bits + 31) / 32; i++) e.w[i] = w[i];
  e.bits = bits;
  return e;
}

}  // namespace

extern "C" int kzg_fr_add_sub(int n_words, int op, void* out, const void* a,
                              const void* b, int n, int b_bcast,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (op < kAdd || op > kNeg) return (int)cudaErrorInvalidValue;
  if (n_words == 8) {
    add_sub_kernel<8><<<blocks(n), kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, n, op, b_bcast);
  } else if (n_words == 12) {
    add_sub_kernel<12><<<blocks(n), kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, n, op, b_bcast);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// exp_words: host memory, the exponent's words LSB first (bits <= 32
// n_words).
extern "C" int kzg_fr_pow(int n_words, void* out, const void* a, int n,
                          const void* exp_words, int bits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bits < 0 || bits > 32 * n_words) return (int)cudaErrorInvalidValue;
  const Exponent e = exponent(exp_words, bits);
  if (n_words == 8) {
    pow_kernel<8><<<blocks(n), kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, n, e);
  } else if (n_words == 12) {
    pow_kernel<12><<<blocks(n), kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, n, e);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One launch of `n_blocks` blocks in `phase` (kInvFull needs one block);
// exp_words (host) is r - 2.
extern "C" int kzg_fr_batch_inv(void* out, const void* in, int n, int chunk,
                                int n_blocks, void* totals, int phase,
                                const void* exp_words, int bits,
                                void* stream) {
  if (phase < kInvFull || phase > kInvDown || bits > 256 ||
      (phase == kInvFull && n_blocks != 1))
    return (int)cudaErrorInvalidValue;
  batch_inv_kernel<<<n_blocks, kInvThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)in, n, chunk, (int32_t*)totals, phase,
      exponent(exp_words, bits));
  return (int)cudaGetLastError();
}

// One pass over `rows` transforms of 2^log_n values; scale_words (host,
// Montgomery words) or null.
extern "C" int kzg_fr_fft_block(const void* src, void* dst,
                                const void* roots, int log_n, int lo, int kk,
                                int log_max, int brev, int rows,
                                const void* scale_words, void* stream) {
  if (kk < 0 || kk > kFftTileLog || lo + kk > log_n || log_n > log_max ||
      log_max > 31 || (brev && lo != 0))
    return (int)cudaErrorInvalidValue;
  const int tile = 1 << kk;
  const int smem = 8 * (tile + kFftPad) * (int)sizeof(uint32_t);
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        fft_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        8 * ((1 << kFftTileLog) + kFftPad) * (int)sizeof(uint32_t));
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  FrConst scale = {};
  if (scale_words)
    for (int w = 0; w < 8; w++) scale.w[w] = ((const uint32_t*)scale_words)[w];
  const int threads = std::min(std::max(tile / 2, 32), kFftThreads);
  const unsigned grid = (unsigned)rows << (log_n - kk);
  fft_block_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)src, (int32_t*)dst, (const int32_t*)roots, log_n, lo,
      kk, log_max, brev, scale_words != nullptr, scale);
  return (int)cudaGetLastError();
}

extern "C" int kzg_fr_zero_poly_leaves(void* out, const void* roots,
                                       const void* factors, int leaves,
                                       void* stream) {
  zero_poly_leaves_kernel<<<leaves, kLeafWidth, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)roots, (const int32_t*)factors);
  return (int)cudaGetLastError();
}
