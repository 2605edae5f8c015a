// The Hopper routes of K1 (mont_mul), K2 (fr_butterfly_stage) and
// fr_dif_stage: the chains of field operations that the recovery, the Fr
// FFT and the DAS extension ran as one small launch per operation, each
// now one kernel or a few passes. Built by nvcc for
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
// fr_das_block: the DAS extension (kzg_tpu/ntt/das.py::_das_core_pallas:
//   K = log2 n DIF levels on ::_butterfly_lazy_dif_fn, K DIT levels on
//   ::_butterfly_lazy_fn, the exit scale 1/n on ::_canon_scale_fn; one
//   launch a level there and in fr_dif_stage, K2 and fr_scale) in passes
//   of fr_fft_block's tiles. The level of half-width 2^L pairs p with
//   p + 2^L, j = p mod 2^L: down hi = a + b, lo = (a - b)
//   rev[j << (log_max - 1 - L)]; up hi = a + b w, lo = a - b w with
//   w = roots[(2j + 1) << (log_max - 2 - L)]. The down-sweep visits
//   L = K-1 ... 0, the up-sweep 0 ... K-1, so a pass over the tiles of
//   levels lo..lo+kk-1 runs the down levels, the up levels, or (lo = 0)
//   both, the two middle sweeps meeting in shared memory: one pass up to
//   fr_fft_block's widest tile (2^11 values), three above (down top, both
//   bottom, up top). The same tile helpers run both kernels. The last
//   pass scales by 1/n in its store and may interleave: odds at 2p + 1
//   and the evens copied to 2p. Bound by latency at the PeerDAS width
//   (n = 4096, a few blobs): one butterfly a thread a level, so a
//   thread's chain is 2K + 1 products; three passes spread a blob over
//   n / 64 blocks (one block a blob would run its 53,248 products on one
//   SM).
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
enum { kDasDown = 1, kDasUp = 2 };

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

// A pass's tile: block = (row, tile), tile = (hi, o); the tile's value i
// is position base + (i << lo) of the row that starts at row0. Its values
// lie word-major in shared memory, ld words a word's row (a pad of
// kFftPad against bank conflicts).
struct Tile {
  size_t row0, o, base;
  int lo, size, ld;
};

__device__ __forceinline__ Tile tile_of(int log_n, int lo, int kk) {
  const size_t blk = blockIdx.x;
  const size_t tid = blk & (((size_t)1 << (log_n - kk)) - 1);
  Tile t;
  t.row0 = (blk >> (log_n - kk)) << log_n;
  t.o = tid & (((size_t)1 << lo) - 1);
  t.base = ((tid >> lo) << (lo + kk)) + t.o;
  t.lo = lo;
  t.size = 1 << kk;
  t.ld = t.size + kFftPad;
  return t;
}

// The tile from src into sm, from the bit-reversed positions over
// brev_bits bits where brev_bits > 0.
__device__ __forceinline__ void tile_load(uint32_t* sm, const Tile& t,
                                          const int32_t* src, int brev_bits) {
  for (int k = threadIdx.x; k < 8 * t.size; k += blockDim.x) {
    const int i = k >> 3, w = k & 7;
    size_t p = t.base + ((size_t)i << t.lo);
    if (brev_bits) p = bit_reverse(p, brev_bits);
    sm[w * t.ld + i] = (uint32_t)src[(t.row0 + p) * 8 + w];
  }
  __syncthreads();
}

// One butterfly stage of half-width 2^st over the tile in sm: value i
// (bit st clear) pairs with i + 2^st, j = o + ((i mod 2^st) << lo), and
// takes w = tws[j << shift], or tws[(2j + 1) << shift] (kOdd), or w = 1
// where tws is null (the plain DIT form only: the FFT's first stage).
// DIT: hi = a + b w, lo = a - b w; DIF: hi = a + b, lo = (a - b) w.
template <bool kDif, bool kOdd>
__device__ __forceinline__ void tile_stage(uint32_t* sm, const Tile& t,
                                           int st,
                                           const int32_t* __restrict__ tws,
                                           int shift) {
  const int half = 1 << st;
  for (int b = threadIdx.x; b < t.size / 2; b += blockDim.x) {
    const int jl = b & (half - 1);
    const int i = ((b >> st) << (st + 1)) | jl;
    uint32_t x[8], y[8], u[8], tw[8];
#pragma unroll
    for (int w = 0; w < 8; w++) {
      x[w] = sm[w * t.ld + i];
      y[w] = sm[w * t.ld + i + half];
    }
    // no run-time test of tws in the DAS forms: it made them 7 % slower
    // on an H100
    const bool has_tw = kDif || kOdd || tws;
    if (has_tw) {
      const size_t j = t.o + ((size_t)jl << t.lo);
      kzg::load<8>(tw, tws + ((kOdd ? 2 * j + 1 : j) << shift) * 8);
    }
    if (!kDif && has_tw) kzg::mul<8>(y, y, tw);
    kzg::add<8>(u, x, y);
    kzg::sub<8>(x, x, y);
    if (kDif && has_tw) kzg::mul<8>(x, x, tw);
#pragma unroll
    for (int w = 0; w < 8; w++) {
      sm[w * t.ld + i] = u[w];
      sm[w * t.ld + i + half] = x[w];
    }
  }
  __syncthreads();
}

// Every value of the tile in sm times scale.
__device__ __forceinline__ void tile_scale(uint32_t* sm, const Tile& t,
                                           const FrConst& scale) {
  for (int i = threadIdx.x; i < t.size; i += blockDim.x) {
    uint32_t x[8];
#pragma unroll
    for (int w = 0; w < 8; w++) x[w] = sm[w * t.ld + i];
    kzg::mul<8>(x, x, scale.w);
#pragma unroll
    for (int w = 0; w < 8; w++) sm[w * t.ld + i] = x[w];
  }
  __syncthreads();
}

// The tile from sm into dst; with evens, the interleave: value p to
// 2p + 1 and evens' value p to 2p.
__device__ __forceinline__ void tile_store(const uint32_t* sm, const Tile& t,
                                           int32_t* dst,
                                           const int32_t* __restrict__ evens) {
  for (int k = threadIdx.x; k < 8 * t.size; k += blockDim.x) {
    const int i = k >> 3, w = k & 7;
    const size_t p = t.row0 + t.base + ((size_t)i << t.lo);
    if (evens) {
      dst[(2 * p + 1) * 8 + w] = (int32_t)sm[w * t.ld + i];
      dst[2 * p * 8 + w] = evens[p * 8 + w];
    } else {
      dst[p * 8 + w] = (int32_t)sm[w * t.ld + i];
    }
  }
}

// One pass of kk DIT stages over tiles of 2^kk values; see the head of
// the file. src may equal dst unless brev: each block reads its whole
// tile before it writes.
__global__ void __launch_bounds__(kFftThreads)
    fft_block_kernel(const int32_t* src, int32_t* dst,
                     const int32_t* __restrict__ roots, int log_n, int lo,
                     int kk, int log_max, int brev, int scale_on,
                     FrConst scale) {
  extern __shared__ uint32_t sm[];
  const Tile t = tile_of(log_n, lo, kk);
  tile_load(sm, t, src, brev ? log_n : 0);
  for (int st = 0; st < kk; st++) {
    // stage s of the transform; the first one's twiddle is roots[0] = 1
    const int s = lo + 1 + st;
    tile_stage<false, false>(sm, t, st, s > 1 ? roots : nullptr,
                             log_max - s);
  }
  if (scale_on) tile_scale(sm, t, scale);
  tile_store(sm, t, dst, nullptr);
}

// One pass of the DAS extension over tiles of 2^kk values; see the head
// of the file. src may equal dst unless evens is given: dst is then the
// interleaved output, 2n values a row.
__global__ void __launch_bounds__(kFftThreads)
    das_block_kernel(const int32_t* src, int32_t* dst,
                     const int32_t* __restrict__ evens,
                     const int32_t* __restrict__ rev_roots,
                     const int32_t* __restrict__ roots, int log_n, int lo,
                     int kk, int log_max, int sweeps, int scale_on,
                     FrConst scale) {
  extern __shared__ uint32_t sm[];
  const Tile t = tile_of(log_n, lo, kk);
  tile_load(sm, t, src, 0);
  if (sweeps & kDasDown)
    for (int st = kk - 1; st >= 0; st--)
      tile_stage<true, false>(sm, t, st, rev_roots, log_max - 1 - lo - st);
  if (sweeps & kDasUp)
    for (int st = 0; st < kk; st++)
      tile_stage<false, true>(sm, t, st, roots, log_max - 2 - lo - st);
  if (scale_on) tile_scale(sm, t, scale);
  tile_store(sm, t, dst, evens);
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

// The launch of a pass over `rows` vectors of 2^log_n values in tiles of
// 2^kk: one block a tile, the tile's words in dynamic shared memory (the
// kernel's limit raised to the widest tile at its first launch) and
// scale_words (host, Montgomery words) or null.
struct TilePass {
  unsigned grid;
  int threads, smem;
  FrConst scale;
};

static cudaError_t tile_pass(const void* kernel, bool* raised, int log_n,
                             int kk, int rows, const void* scale_words,
                             TilePass* pass) {
  if (!*raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        8 * ((1 << kFftTileLog) + kFftPad) * (int)sizeof(uint32_t));
    if (err != cudaSuccess) return err;
    *raised = true;
  }
  const int tile = 1 << kk;
  pass->grid = (unsigned)rows << (log_n - kk);
  pass->threads = std::min(std::max(tile / 2, 32), kFftThreads);
  pass->smem = 8 * (tile + kFftPad) * (int)sizeof(uint32_t);
  pass->scale = {};
  if (scale_words)
    for (int w = 0; w < 8; w++)
      pass->scale.w[w] = ((const uint32_t*)scale_words)[w];
  return cudaSuccess;
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
  static bool raised = false;
  TilePass pass;
  const cudaError_t err = tile_pass((const void*)fft_block_kernel, &raised,
                                    log_n, kk, rows, scale_words, &pass);
  if (err != cudaSuccess) return (int)err;
  fft_block_kernel<<<pass.grid, pass.threads, pass.smem,
                     (cudaStream_t)stream>>>(
      (const int32_t*)src, (int32_t*)dst, (const int32_t*)roots, log_n, lo,
      kk, log_max, brev, scale_words != nullptr, pass.scale);
  return (int)cudaGetLastError();
}

// One pass of the DAS extension over `rows` vectors of 2^log_n values
// on the 2^log_max domain (rev_roots and roots its inverse and forward
// roots tables). evens: the extension's input, for the last pass to
// interleave with (dst then holds 2n values a row), or null; scale_words
// (host, Montgomery words) or null.
extern "C" int kzg_fr_das_block(const void* src, void* dst, const void* evens,
                                const void* rev_roots, const void* roots,
                                int log_n, int lo, int kk, int log_max,
                                int sweeps, int rows, const void* scale_words,
                                void* stream) {
  if (kk < 0 || kk > kFftTileLog || lo < 0 || lo + kk > log_n ||
      log_n + 1 > log_max || log_max > 31 || sweeps < kDasDown ||
      sweeps > (kDasDown | kDasUp) || (evens && src == dst))
    return (int)cudaErrorInvalidValue;
  static bool raised = false;
  TilePass pass;
  const cudaError_t err = tile_pass((const void*)das_block_kernel, &raised,
                                    log_n, kk, rows, scale_words, &pass);
  if (err != cudaSuccess) return (int)err;
  das_block_kernel<<<pass.grid, pass.threads, pass.smem,
                     (cudaStream_t)stream>>>(
      (const int32_t*)src, (int32_t*)dst, (const int32_t*)evens,
      (const int32_t*)rev_roots, (const int32_t*)roots, log_n, lo, kk,
      log_max, sweeps, scale_words != nullptr, pass.scale);
  return (int)cudaGetLastError();
}

extern "C" int kzg_fr_zero_poly_leaves(void* out, const void* roots,
                                       const void* factors, int leaves,
                                       void* stream) {
  zero_poly_leaves_kernel<<<leaves, kLeafWidth, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)roots, (const int32_t*)factors);
  return (int)cudaGetLastError();
}
