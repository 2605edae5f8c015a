// The field-chain experiments on Hopper: three kernels that time one Fr or
// Fp Montgomery product, and the small Fp ops around it, when chained,
// built by nvcc for sm_90a into a shared library with a plain C interface
// (loaded by kzg_tpu_torch/build.py through ctypes; the entry points live
// in kzg_tpu_torch/experiments/). No path of the library runs them.
//
// exp_mont_chain replaces scripts/exp_montmul.py::run_variant (its kernel
// body chain_kernel_factory): x <- REDC(x*b) `depth` times a lane, in one
// of three variants that give the same canonical words.
//   A: field.cuh's mul<N> (CIOS with a split accumulator), one thread a
//      lane: the counterpart of the TPU's production tile mont_mul_tile.
//   B: the accumulator in memory, the counterpart of the TPU's VMEM
//      scratch `+=`: separated operand scanning, the 2N-word a*b summed
//      into the thread's own slice of shared memory (volatile, so every
//      step is a load and a store), then N reduction rows over that
//      slice, then cond_sub.
//   C: REDC's two by-constant passes on the tensor cores (tc_redc): a
//      warp's 32 lanes are the M rows of mma.m16n8k32 u8 x u8 -> s32, the
//      lane's byte digits its K columns, the constant's byte-Toeplitz
//      matrix the B operand. t = a*b stays on the CUDA cores (the data x
//      data pass, which stayed on the VPU on the TPU too).
// exp_tc_mont_mul replaces scripts/exp_mxu_mul.py::pallas_hybrid_mul_fn:
// one Fp REDC(a*b) a lane on tc_redc (mode 0), or the by-constant pass
// alone, x <- x*n' mod R, on the tensor cores (mode 1) or on the CUDA
// cores (mode 2): the counterparts of that script's XLA-level passes 3
// and 2.
// exp_op_chain replaces scripts/exp_addsub.py::timed: `depth` applications
// a lane of one small Fp op (mont_mul(x, c) with c the n' words, add(x, x),
// sub(m, x), the carry chain x + 0 that stands in for the TPU's
// carry_fold, x >= m ? x : m, cond_sub).
//
// exp_tuple_chain replaces scripts/exp_ab_mul.py::run and
// scripts/exp_carry.py::make (X4, X5): `depth` iterations a lane of
// a=M(x,y) b=M(y,z) c=M(z,x) d=M(a,b) e=M(b,c) f=M(d,e) g=M(e,a) with the
// carry (f, g, c), from x = y = z = the input; it returns f. Its bodies:
// tuple3 (the carry in registers), single (the carry written to one
// 36-word volatile slice of shared memory and read back each iteration,
// the counterpart of the TPU's one (72, W) array) and serial (x <- M(x, x)
// seven times); and for X7, X8 and X9 (scripts/exp_bisect.py::variant,
// exp_width.py::serial8, exp_pointops.py::mul_chain and ::sqr_chain):
// transp (tuple3 from three different coordinates, read from a word-major
// stack as the TPU's pts.x.T), serial8 (x <- M(x, x) eight times, 256
// threads a block as the script's block) and serial1 (once). Its
// products M:
//   mont12: field.cuh's mul<12>, canonical (mont_mul_tile at 24 limbs);
//   lazy12, lazy13, lazy16: REDC over R = 2^384, 2^416, 2^512 with no
//      final conditional subtraction (lazy_mul_tile at 24, 25, 32 rows;
//      one headroom word stands where the TPU had one 16-bit limb);
//   sqr12: REDC(x*x) by a symmetric product (sym_sqr: each off-diagonal
//      word product once, doubled), canonical: mul<12>(x, x)'s words.
// Schedules: every product runs field.cuh's split-accumulator rows
// (mul_row: CIOS, the even and odd words' partial products on two
// independent carry chains). lazy12 is mul<12> without its cond_sub, so
// lazy12 against mont12 is the conditional subtraction alone. lazy16 runs
// the rows at 16 words on the modulus padded with zeros (width alone
// against lazy12). lazy13 has an odd width: it runs 13 rows on a 14-word
// accumulator, its operands and modulus padded with a zero word, so each
// of its rows costs a 14-word row (width and padding against lazy12).
// Bounds of the rows (field.cuh's audit for any operand): a row's sum is
// t + a b_i + q m < 2^32 (a + m) while t < a + m, so no word leaves the
// accumulator's NA + 1 words if a + m <= 2^(32 NA); both halves' dropped
// top carries are then 0, and REDC's output (a b + q m) / R is below
// a b / R + m. lazy12 takes operands below 2p: 3p < 2^384, and
// a b < 4p^2 < p 2^384 since 4p < 2^384, so its output stays below 2p
// (below 1.41p) and the chain never leaves [0, 2p). lazy13 and lazy16
// have 2^35 and 2^131 of headroom over p. The REDC value is unique, so
// every lazy case equals a Python-int model word for word.
// exp_ext_chain replaces scripts/exp_truth.py::build and
// scripts/exp_addcost.py::variant (X6, X11): to_ext of the three
// Jacobian coordinates (lazy13 by C_IN = 2^448 mod p: aR -> aR_ext with
// R_ext = 2^416), `depth` iterations of a=M(x,y) b=M(y,z) c=M(z,x), then
// NEXTRA extra ops c = E((a, b, c)[j % 3], c), then d=M(a,b) e=M(b,c)
// f=M(d,e) g=M(e,a) h=M(f,g) with the carry (f, g, h) and M = lazy13,
// then from_ext (lazy13 by C_OUT = 2^384 mod p, one cond_sub) of each.
// E is the lazy add (a 13-word add.cc chain, nothing reduced: adds and
// fold, whose carry_fold lives inside the add.cc chain on 32-bit words),
// the lazy sub a + (K m - b) on two 13-word chains, or the raw add (per
// 32-bit word, every carry dropped: not field arithmetic).
// Audit of the 13-word domain: a lazy13 output is below
// a b / 2^416 + p, so below 1.01p for operands below 2^35 p. adds12
// doubles c on every third extra and reaches below 100p; the products
// that take it stay below 2^416 p. subs12 runs c = src + K m - c: step 0
// needs K m > c (K = 64, as the TPU's _kernel_ctx), but the K m of
// steps 0 and 1 cancel, c_2 = b - a + c_0, so step 1 wraps below zero
// where a > b + c_0 whatever K is; step 2 is c + (K m - c) = K m exactly
// mod 2^416, which erases the wrap before any product reads c, so the
// output is exact field arithmetic (and 0: c = K m from then on, so every
// output of subs12 is 0). subs1, a case the scripts lack, takes one lazy
// sub, c = a + (K m - c) with c < 1.01p < K m: no wrap, and its outputs
// are not 0, so the sub chain's words reach what is compared. A raw
// sum is any 13-word value: the product that takes it stays below
// 2^416 * 2p, its output below 3p. Every case but raw12 is exact field
// arithmetic, and from_ext's canonical words are the same field elements
// whatever R_ext is. The 13-word domain lives in lazy.cuh.
// exp_ext_body replaces the rest of scripts/exp_bisect.py::variant (X7)
// and scripts/exp_lazyops.py::mulref (X10): seven, the 7-product body in
// the 13-word domain, with to_ext and from_ext (conv) or on the
// zero-padded words, stored as their low 12 words, with the modulus and
// n0 read from a device-memory context into registers where every other
// case has immediates, and K m built by six lazy doublings as the TPU's
// _lazy_ctx (ctx); indep8, 8 products of x, y, z of which the carry reads
// three (the script's five others feed nothing), and dblshape, 8 products
// in proj_double's dependency shape.
//
// Exactness of the tensor-core passes: digits are bytes, so each u8 x u8
// product is below 2^16, and a column of the Toeplitz product sums at most
// 4N <= 48 of them (the padded digits of Fp are 0): every column sum is
// below 48 * 2^16 < 2^22, far inside the s32 accumulator. The column sums
// are then recombined into words on 64-bit carries.
//
// Bound on this card: A and B do 2N^2 + N 32-bit multiply-adds a product,
// C N^2 on the CUDA cores and the byte products its two passes need,
// 4N(4N+1)/2 for q and (4N)^2 for q*m, on the tensor cores (the mma tiles
// also multiply Fp's padding digits and each block's zero triangle); at
// 2048 lanes (64 warps on 132 SMs) a chain is bound by the latency of one
// thread's (one warp's) dependent products instead: X4 and X5's tuple3 by
// 3 dependent products of its 7 an iteration (X7's transp, conv and ctx
// too), serial by 7 of 7 (serial8 8, serial1 1), X6 and X11's body by 4
// of 8 plus the extras' chain on c, X10's indep8 by 1 and dblshape by 5
// of 8. Design: the simplest form of each variant, one thread a lane;
// blocks of 2 warps spread the lanes over the SMs.
#include <cuda_runtime.h>

#include "field.cuh"
#include "lazy.cuh"

namespace kzg {

// Fp's modulus padded with zero words to 16 words (14: lazy.cuh), for the
// lazy products' rows (mul_row reads Field<N>::m and n0). n0 = -m^-1 mod
// 2^32 depends on the lowest word alone, so it is Fp's at every width.
template <>
struct Field<16> {
  static constexpr uint32_t n0 = Field<12>::n0;
  __device__ __forceinline__ static uint32_t m(int i) {
    return i < 12 ? Field<12>::m(i) : 0u;
  }
};

}  // namespace kzg

namespace {

using kzg::Field;
namespace ptx = kzg::ptx;

// n' = -m^-1 mod R, the full-width Montgomery constant (little-endian
// words): field.cuh keeps only its low word n0
template <int N>
struct NPrime;

template <>
struct NPrime<8> {
  __device__ __forceinline__ static uint32_t w(int i) {
    constexpr uint32_t W[8] = {0xffffffffu, 0xfffffffeu, 0xfffe5bfdu,
                               0x53ba5bffu, 0x0004ec06u, 0x181b2c17u,
                               0xd7bf2839u, 0x3d443ab0u};
    return W[i];
  }
};

template <>
struct NPrime<12> {
  __device__ __forceinline__ static uint32_t w(int i) {
    constexpr uint32_t W[12] = {0xfffcfffdu, 0x89f3fffcu, 0xd9d113e8u,
                                0x286adb92u, 0xc8e30b48u, 0x16ef2ef0u,
                                0x8eb2db4cu, 0x19ecca0eu, 0xe268cf58u,
                                0x68b316feu, 0xfeaafc94u, 0xceb06106u};
    return W[i];
  }
};

constexpr int kThreads = 64;   // a block: 2 warps
constexpr int kWarps = kThreads / 32;

// t = a*b, all 2N words: row i adds the low halves of a * b_i into
// t[i..i+N-1] (its carry into the still-zero t[i+N]), then the high
// halves into t[i+1..i+N] (no carry out: a*b's first i+1 rows fit
// N+i+1 words).
template <int N>
__device__ __forceinline__ void wide_mul(uint32_t t[2 * N],
                                         const uint32_t a[N],
                                         const uint32_t b[N]) {
#pragma unroll
  for (int k = 0; k < 2 * N; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    t[i] = ptx::mad_lo_cc(a[0], b[i], t[i]);
#pragma unroll
    for (int j = 1; j < N; j++)
      t[i + j] = ptx::madc_lo_cc(a[j], b[i], t[i + j]);
    t[i + N] = ptx::addc(0, 0);
    t[i + 1] = ptx::mad_hi_cc(a[0], b[i], t[i + 1]);
#pragma unroll
    for (int j = 1; j < N - 1; j++)
      t[i + j + 1] = ptx::madc_hi_cc(a[j], b[i], t[i + j + 1]);
    t[i + N] = ptx::madc_hi(a[N - 1], b[i], t[i + N]);
  }
}

// r = x * n' mod R on the CUDA cores: the low N words of the product,
// carries out of word N-1 dropped.
template <int N>
__device__ __forceinline__ void low_mul_nprime(uint32_t r[N],
                                               const uint32_t x[N]) {
#pragma unroll
  for (int k = 0; k < N; k++) r[k] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    const uint32_t c = NPrime<N>::w(i);
    r[i] = ptx::mad_lo_cc(x[0], c, r[i]);
#pragma unroll
    for (int j = 1; j < N - i; j++)
      r[i + j] = ptx::madc_lo_cc(x[j], c, r[i + j]);
    if (i + 1 < N) {
      r[i + 1] = ptx::mad_hi_cc(x[0], c, r[i + 1]);
#pragma unroll
      for (int j = 1; j < N - 1 - i; j++)
        r[i + j + 1] = ptx::madc_hi_cc(x[j], c, r[i + j + 1]);
    }
  }
}

// ---- variant B: separated operand scanning on a shared-memory slice ----

// REDC(a*b), canonical, through acc: the thread's 2N words of shared
// memory, one every kThreads words (acc points at its first).
template <int N>
__device__ __forceinline__ void sos_mul(uint32_t r[N], const uint32_t a[N],
                                        const uint32_t b[N],
                                        volatile uint32_t* acc) {
#pragma unroll
  for (int k = 0; k < 2 * N; k++) acc[k * kThreads] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      const uint64_t p =
          (uint64_t)a[j] * b[i] + acc[(i + j) * kThreads] + carry;
      acc[(i + j) * kThreads] = (uint32_t)p;
      carry = (uint32_t)(p >> 32);
    }
    acc[(i + N) * kThreads] = carry;   // that word was 0 before this row
  }
  uint32_t top = 0;   // the carry out of word 2N-1: 0 or 1
#pragma unroll
  for (int i = 0; i < N; i++) {
    const uint32_t q = acc[i * kThreads] * Field<N>::n0;
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      const uint64_t p =
          (uint64_t)q * Field<N>::m(j) + acc[(i + j) * kThreads] + carry;
      acc[(i + j) * kThreads] = (uint32_t)p;
      carry = (uint32_t)(p >> 32);
    }
    const uint64_t s = (uint64_t)acc[(i + N) * kThreads] + carry + top;
    acc[(i + N) * kThreads] = (uint32_t)s;
    top = (uint32_t)(s >> 32);
  }
  uint32_t hi[N];
#pragma unroll
  for (int j = 0; j < N; j++) hi[j] = acc[(N + j) * kThreads];
  kzg::cond_sub<N>(r, hi, top);
}

// ---- variant C: the by-constant passes on the tensor cores ----

// Shapes of the passes for N words: K byte digits padded to whole k32
// steps, the n8 tiles of q's 4N and q*m's 8N output columns, and the row
// strides (in 32-bit words) of a warp's digit and column buffers, chosen
// so that the fragment loads and the row reads hit distinct banks.
template <int N>
struct Tc {
  static constexpr int K = N == 8 ? 32 : 64;
  static constexpr int KS = K / 32;
  static constexpr int QT = 4 * N / 8;
  static constexpr int MT = 8 * N / 8;
  static constexpr int DS = K / 4 + 4;
  static constexpr int CS = 8 * N + 1;
};

// Whether the Toeplitz block of k-step ks (digits 32ks..32ks+31) and n
// tile nt (columns 8nt..8nt+7) holds a nonzero entry: column k takes
// digit i times the constant's digit k - i, for 0 <= k - i < 4N.
template <int N>
__host__ __device__ constexpr bool live_block(int ks, int nt) {
  return 8 * nt + 7 >= 32 * ks && 8 * nt - (32 * ks + 31) < 4 * N;
}

__device__ __forceinline__ void mma_u8(int32_t c[4], const uint32_t a[4],
                                       uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The block's copy of a (4N, cols) row-major u8 Toeplitz matrix in B
// fragment order: entry ((ks * tiles + nt) * 32 + lane) holds the lane's
// two registers of block (ks, nt), rows 32ks + 4t + (0..3) and
// 32ks + 16 + 4t + (0..3) of column 8nt + g (g = lane / 4, t = lane % 4),
// a byte each, the lowest row in the lowest byte; rows past 4N are 0.
template <int N>
__device__ void load_fragments(uint2* frag, const uint8_t* __restrict__ T,
                               int tiles) {
  const int cols = 8 * tiles;
  for (int e = threadIdx.x; e < Tc<N>::KS * tiles * 32; e += blockDim.x) {
    const int lane = e & 31, nt = (e >> 5) % tiles, ks = (e >> 5) / tiles;
    const int col = 8 * nt + (lane >> 2);
    uint32_t reg[2];
#pragma unroll
    for (int h = 0; h < 2; h++) {
      uint32_t v = 0;
#pragma unroll
      for (int i = 0; i < 4; i++) {
        const int row = 32 * ks + 16 * h + 4 * (lane & 3) + i;
        if (row < 4 * N) v |= (uint32_t)T[row * cols + col] << (8 * i);
      }
      reg[h] = v;
    }
    frag[e] = make_uint2(reg[0], reg[1]);
  }
}

// Column sums of the warp's 32 digit rows (dig: row = lane, K bytes,
// stride DS words) times a Toeplitz matrix with `TILES` n8 tiles (frag, in
// B fragment order), into cols (row = lane, stride CS words).
template <int N, int TILES>
__device__ __forceinline__ void tc_columns(int32_t* cols, const uint32_t* dig,
                                           const uint2* frag, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; mt++) {
    uint32_t a[Tc<N>::KS][4];
#pragma unroll
    for (int ks = 0; ks < Tc<N>::KS; ks++) {
      const uint32_t* r0 = dig + (16 * mt + g) * Tc<N>::DS + 8 * ks + t;
      const uint32_t* r1 = r0 + 8 * Tc<N>::DS;
      a[ks][0] = r0[0];
      a[ks][1] = r1[0];
      a[ks][2] = r0[4];
      a[ks][3] = r1[4];
    }
#pragma unroll
    for (int nt = 0; nt < TILES; nt++) {
      int32_t c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < Tc<N>::KS; ks++)
        if (live_block<N>(ks, nt))
          mma_u8(c, a[ks], frag[(ks * TILES + nt) * 32 + lane]);
      int32_t* o = cols + (16 * mt + g) * Tc<N>::CS + 8 * nt + 2 * t;
      o[0] = c[0];
      o[1] = c[1];
      o[8 * Tc<N>::CS] = c[2];
      o[8 * Tc<N>::CS + 1] = c[3];
    }
  }
}

// The lane's `words` words from its row of column sums (each < 2^22):
// word w = the columns 4w..4w+3 at 8-bit steps plus the carry.
template <int W>
__device__ __forceinline__ void recombine(uint32_t r[W], const int32_t* row) {
  uint64_t acc = 0;
#pragma unroll
  for (int w = 0; w < W; w++) {
    acc += (uint64_t)(uint32_t)row[4 * w] +
           ((uint64_t)(uint32_t)row[4 * w + 1] << 8) +
           ((uint64_t)(uint32_t)row[4 * w + 2] << 16) +
           ((uint64_t)(uint32_t)row[4 * w + 3] << 24);
    r[w] = (uint32_t)acc;
    acc >>= 32;
  }
}

// The warp's shared buffers: its 32 lanes' digit rows and column sums.
template <int N>
struct WarpBufs {
  uint32_t dig[32 * Tc<N>::DS];
  int32_t cols[32 * Tc<N>::CS];
};

// The lane's N words as its digit row (a word is 4 byte digits, lowest
// first); the padding words are 0.
template <int N>
__device__ __forceinline__ void put_digits(uint32_t* dig, const uint32_t x[N],
                                           int lane) {
  uint32_t* row = dig + lane * Tc<N>::DS;
#pragma unroll
  for (int w = 0; w < Tc<N>::K / 4; w++) row[w] = w < N ? x[w] : 0;
}

// r = x * n' mod R for the warp's 32 lanes on the tensor cores. Every
// thread of the warp calls it.
template <int N>
__device__ __forceinline__ void tc_mul_nprime(uint32_t r[N],
                                              const uint32_t x[N],
                                              WarpBufs<N>& wb,
                                              const uint2* fq, int lane) {
  __syncwarp();   // the warp's last reads of its buffers are done
  put_digits<N>(wb.dig, x, lane);
  __syncwarp();
  tc_columns<N, Tc<N>::QT>(wb.cols, wb.dig, fq, lane);
  __syncwarp();
  recombine<N>(r, wb.cols + lane * Tc<N>::CS);
}

// REDC(t) for t = a*b < m R (2N words), canonical: q = (t mod R) n' mod R
// and q*m on the tensor cores, then s = (t + q m) / R and cond_sub.
template <int N>
__device__ __forceinline__ void tc_redc(uint32_t r[N], const uint32_t t[2 * N],
                                        WarpBufs<N>& wb, const uint2* fq,
                                        const uint2* fm, int lane) {
  uint32_t q[N];
  tc_mul_nprime<N>(q, t, wb, fq, lane);
  __syncwarp();
  put_digits<N>(wb.dig, q, lane);
  __syncwarp();
  tc_columns<N, Tc<N>::MT>(wb.cols, wb.dig, fm, lane);
  __syncwarp();
  uint32_t qm[2 * N];
  recombine<2 * N>(qm, wb.cols + lane * Tc<N>::CS);
  uint32_t s[2 * N];
  s[0] = ptx::add_cc(t[0], qm[0]);
#pragma unroll
  for (int k = 1; k < 2 * N; k++) s[k] = ptx::addc_cc(t[k], qm[k]);
  const uint32_t top = ptx::addc(0, 0);
  kzg::cond_sub<N>(r, s + N, top);
}

// ---- the chain kernel (X1) ----

template <int N, int VARIANT>
__global__ void __launch_bounds__(kThreads)
    mont_chain_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                      const int32_t* __restrict__ b,
                      const uint8_t* __restrict__ tq,
                      const uint8_t* __restrict__ tqm, int n, int depth) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if constexpr (VARIANT == 2) {
    __shared__ uint2 fq[Tc<N>::KS * Tc<N>::QT * 32];
    __shared__ uint2 fm[Tc<N>::KS * Tc<N>::MT * 32];
    __shared__ WarpBufs<N> bufs[kWarps];
    load_fragments<N>(fq, tq, Tc<N>::QT);
    load_fragments<N>(fm, tqm, Tc<N>::MT);
    __syncthreads();
    // a lane past n runs on zeros (its warp's mma needs every thread)
    const bool live = i < n;
    uint32_t x[N], y[N];
#pragma unroll
    for (int k = 0; k < N; k++) {
      x[k] = live ? (uint32_t)a[(size_t)i * N + k] : 0;
      y[k] = live ? (uint32_t)b[(size_t)i * N + k] : 0;
    }
    WarpBufs<N>& wb = bufs[threadIdx.x >> 5];
    const int lane = threadIdx.x & 31;
#pragma unroll 1
    for (int d = 0; d < depth; d++) {
      uint32_t t[2 * N];
      wide_mul<N>(t, x, y);
      tc_redc<N>(x, t, wb, fq, fm, lane);
    }
    if (live) kzg::store<N>(out + (size_t)i * N, x);
  } else {
    if (i >= n) return;
    uint32_t x[N], y[N];
    kzg::load<N>(x, a + (size_t)i * N);
    kzg::load<N>(y, b + (size_t)i * N);
    if constexpr (VARIANT == 0) {
#pragma unroll 1
      for (int d = 0; d < depth; d++) kzg::mul<N>(x, x, y);
    } else {
      __shared__ uint32_t acc[2 * N * kThreads];
#pragma unroll 1
      for (int d = 0; d < depth; d++)
        sos_mul<N>(x, x, y, acc + threadIdx.x);
    }
    kzg::store<N>(out + (size_t)i * N, x);
  }
}

// ---- the single product and its passes (X2), Fp ----

// MODE 0: REDC(a*b); MODE 1: a * n' mod R on the tensor cores. Each
// block loads the Toeplitz fragments once and walks 32-lane tiles, a warp
// a tile.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
    tc_mont_mul_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                       const int32_t* __restrict__ b,
                       const uint8_t* __restrict__ tq,
                       const uint8_t* __restrict__ tqm, int n) {
  constexpr int N = 12;
  __shared__ uint2 fq[Tc<N>::KS * Tc<N>::QT * 32];
  __shared__ uint2 fm[MODE == 0 ? Tc<N>::KS * Tc<N>::MT * 32 : 1];
  __shared__ WarpBufs<N> bufs[kWarps];
  load_fragments<N>(fq, tq, Tc<N>::QT);
  if (MODE == 0) load_fragments<N>(fm, tqm, Tc<N>::MT);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  WarpBufs<N>& wb = bufs[warp];
  const int tiles = (n + 31) / 32;
  for (int tile = blockIdx.x * kWarps + warp; tile < tiles;
       tile += gridDim.x * kWarps) {
    const int i = tile * 32 + lane;
    const bool live = i < n;
    uint32_t x[N], r[N];
#pragma unroll
    for (int k = 0; k < N; k++)
      x[k] = live ? (uint32_t)a[(size_t)i * N + k] : 0;
    if (MODE == 0) {
      uint32_t y[N], t[2 * N];
#pragma unroll
      for (int k = 0; k < N; k++)
        y[k] = live ? (uint32_t)b[(size_t)i * N + k] : 0;
      wide_mul<N>(t, x, y);
      tc_redc<N>(r, t, wb, fq, fm, lane);
    } else {
      tc_mul_nprime<N>(r, x, wb, fq, lane);
    }
    if (live) kzg::store<N>(out + (size_t)i * N, r);
  }
}

// A grid of tc_mont_mul_kernel<MODE> for `warps_needed` warp tiles: no
// more blocks than the SMs hold at once; each block then walks its tiles.
// The most is queried once, on the device current at the first launch, so
// that a launch costs the host no device queries.
template <int MODE>
int tile_grid(int warps_needed) {
  static const int most = [] {
    int dev = 0, sms = 0, resident = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, tc_mont_mul_kernel<MODE>, kThreads, 0);
    return sms * (resident > 0 ? resident : 1);
  }();
  const int need = (warps_needed + kWarps - 1) / kWarps;
  return need < most ? need : most;
}

// a * n' mod R on the CUDA cores, one thread a lane
__global__ void __launch_bounds__(kThreads)
    cc_mul_nprime_kernel(int32_t* __restrict__ out,
                         const int32_t* __restrict__ a, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t x[12], r[12];
  kzg::load<12>(x, a + (size_t)i * 12);
  low_mul_nprime<12>(r, x);
  kzg::store<12>(out + (size_t)i * 12, r);
}

// ---- the small-op chains (X12), Fp ----

enum Op { kMulC = 0, kAdd, kSubFromM, kCarryChain, kGeqWhere, kCondSub };

template <int OP>
__global__ void __launch_bounds__(kThreads)
    op_chain_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                    int n, int depth) {
  constexpr int N = 12;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t x[N], m[N], c[N];
  kzg::load<N>(x, a + (size_t)i * N);
#pragma unroll
  for (int k = 0; k < N; k++) {
    m[k] = Field<N>::m(k);
    c[k] = NPrime<N>::w(k);
  }
#pragma unroll 1
  for (int d = 0; d < depth; d++) {
    if (OP == kMulC) {
      kzg::mul<N>(x, x, c);   // c < R, not < m: CIOS needs only x < m
    } else if (OP == kAdd) {
      kzg::add<N>(x, x, x);
    } else if (OP == kSubFromM) {
      kzg::sub<N>(x, m, x);   // m - x, as the TPU's mod_sub(m, x)
    } else if (OP == kCarryChain) {
      uint32_t s[N];
      s[0] = ptx::add_cc(x[0], 0);
#pragma unroll
      for (int k = 1; k < N - 1; k++) s[k] = ptx::addc_cc(x[k], 0);
      s[N - 1] = ptx::addc(x[N - 1], 0);
      kzg::copy<N>(x, s);
    } else if (OP == kGeqWhere) {
      uint32_t dd[N];
      dd[0] = ptx::sub_cc(x[0], m[0]);
#pragma unroll
      for (int k = 1; k < N; k++) dd[k] = ptx::subc_cc(x[k], m[k]);
      const uint32_t borrow = ptx::subc(0, 0);   // ~0 if x < m
#pragma unroll
      for (int k = 0; k < N; k++) x[k] = borrow == 0 ? x[k] : m[k];
      (void)dd;
    } else {
      kzg::cond_sub<N>(x, x, 0);
    }
  }
  kzg::store<N>(out + (size_t)i * N, x);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

template <int N>
int launch_chain(int variant, void* out, const void* a, const void* b,
                 const void* tq, const void* tqm, int n, int depth,
                 cudaStream_t s) {
  const int g = blocks(n);
  const auto* tq8 = (const uint8_t*)tq;
  const auto* tm8 = (const uint8_t*)tqm;
  if (variant == 0)
    mont_chain_kernel<N, 0><<<g, kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, tq8, tm8, n,
        depth);
  else if (variant == 1)
    mont_chain_kernel<N, 1><<<g, kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, tq8, tm8, n,
        depth);
  else if (variant == 2)
    mont_chain_kernel<N, 2><<<g, kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, tq8, tm8, n,
        depth);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// variant 0, 1, 2 = A, B, C; tq (4N x 4N) and tqm (4N x 8N) are the
// byte-Toeplitz matrices of n' and m, read by variant C only.
extern "C" int kzg_exp_mont_chain(int n_words, int variant, void* out,
                                  const void* a, const void* b,
                                  const void* tq, const void* tqm, int n,
                                  int depth, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || depth < 0) return (int)cudaErrorInvalidValue;
  if (n_words == 8)
    return launch_chain<8>(variant, out, a, b, tq, tqm, n, depth, s);
  if (n_words == 12)
    return launch_chain<12>(variant, out, a, b, tq, tqm, n, depth, s);
  return (int)cudaErrorInvalidValue;
}

// mode 0: REDC(a*b); 1: a * n' mod R on the tensor cores; 2: the same on
// the CUDA cores (b, tqm unused in 1 and 2)
extern "C" int kzg_exp_tc_mont_mul(int mode, void* out, const void* a,
                                   const void* b, const void* tq,
                                   const void* tqm, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int warps = (n + 31) / 32;
  if (mode == 0)
    tc_mont_mul_kernel<0><<<tile_grid<0>(warps),
                            kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b,
        (const uint8_t*)tq, (const uint8_t*)tqm, n);
  else if (mode == 1)
    tc_mont_mul_kernel<1><<<tile_grid<1>(warps),
                            kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b,
        (const uint8_t*)tq, (const uint8_t*)tqm, n);
  else if (mode == 2)
    cc_mul_nprime_kernel<<<blocks(n), kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// op 0-5: mont_mul(x, n'), add(x, x), sub(m, x), x + 0 on a carry chain,
// x >= m ? x : m, cond_sub
extern "C" int kzg_exp_op_chain(int op, void* out, const void* a, int n,
                                int depth, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || depth < 0) return (int)cudaErrorInvalidValue;
  int32_t* o = (int32_t*)out;
  const int32_t* x = (const int32_t*)a;
  const int g = blocks(n);
  switch (op) {
    case kMulC:
      op_chain_kernel<kMulC><<<g, kThreads, 0, s>>>(o, x, n, depth);
      break;
    case kAdd:
      op_chain_kernel<kAdd><<<g, kThreads, 0, s>>>(o, x, n, depth);
      break;
    case kSubFromM:
      op_chain_kernel<kSubFromM><<<g, kThreads, 0, s>>>(o, x, n, depth);
      break;
    case kCarryChain:
      op_chain_kernel<kCarryChain><<<g, kThreads, 0, s>>>(o, x, n, depth);
      break;
    case kGeqWhere:
      op_chain_kernel<kGeqWhere><<<g, kThreads, 0, s>>>(o, x, n, depth);
      break;
    case kCondSub:
      op_chain_kernel<kCondSub><<<g, kThreads, 0, s>>>(o, x, n, depth);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---- the product bodies (X4, X5, X6, X7, X8, X9, X10, X11) ----

namespace {

using kzg::Ext;
using kzg::ext_mul;
using kzg::ext_op;
using kzg::from_ext;
using kzg::kExtNA;
using kzg::kExtWords;
using kzg::kLazyAdd;
using kzg::kLazySub;
using kzg::kRawAdd;
using kzg::lazy_mul;
using kzg::to_ext;

// r = REDC(a*a) over R = 2^(32N), canonical, by a symmetric product: each
// a_i a_j with i < j once (row i: the low halves on one carry chain, the
// high halves on another, as wide_mul), the sum doubled on one add chain,
// the squares a_i^2 added on one more, then N reduction rows on the 2N
// words, t += q m 2^(32i) with q = t_i n0, each row's carry out of word
// i+N held for the next row, then cond_sub. The off-diagonal sum is below
// a^2 < 2^(64N), so neither the rows nor the doubling carry out; t + Q m
// < m^2 + R m < 2 R m, so the output is below 2m and the top carry 0 or
// 1. Its words equal mul<N>(a, a)'s: both are the canonical product.
template <int N>
__device__ __forceinline__ void sym_sqr(uint32_t r[N], const uint32_t a[N]) {
  uint32_t t[2 * N];
#pragma unroll
  for (int k = 0; k < 2 * N; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < N - 1; i++) {
    t[2 * i + 1] = ptx::mad_lo_cc(a[i], a[i + 1], t[2 * i + 1]);
#pragma unroll
    for (int j = i + 2; j < N; j++)
      t[i + j] = ptx::madc_lo_cc(a[i], a[j], t[i + j]);
    t[i + N] = ptx::addc(0, 0);   // that word was 0 before this row
    if (i == N - 2) {
      t[i + N] += __umulhi(a[i], a[N - 1]);   // below 2^32 - 1 + 1
    } else {
      t[2 * i + 2] = ptx::mad_hi_cc(a[i], a[i + 1], t[2 * i + 2]);
#pragma unroll
      for (int j = i + 2; j < N - 1; j++)
        t[i + j + 1] = ptx::madc_hi_cc(a[i], a[j], t[i + j + 1]);
      t[i + N] = ptx::madc_hi(a[i], a[N - 1], t[i + N]);
    }
  }
  t[0] = ptx::add_cc(t[0], t[0]);
#pragma unroll
  for (int k = 1; k < 2 * N - 1; k++) t[k] = ptx::addc_cc(t[k], t[k]);
  t[2 * N - 1] = ptx::addc(t[2 * N - 1], t[2 * N - 1]);
  t[0] = ptx::mad_lo_cc(a[0], a[0], t[0]);
  t[1] = ptx::madc_hi_cc(a[0], a[0], t[1]);
#pragma unroll
  for (int i = 1; i < N - 1; i++) {
    t[2 * i] = ptx::madc_lo_cc(a[i], a[i], t[2 * i]);
    t[2 * i + 1] = ptx::madc_hi_cc(a[i], a[i], t[2 * i + 1]);
  }
  t[2 * N - 2] = ptx::madc_lo_cc(a[N - 1], a[N - 1], t[2 * N - 2]);
  t[2 * N - 1] = ptx::madc_hi(a[N - 1], a[N - 1], t[2 * N - 1]);
  uint32_t carry = 0;   // the last row's carry out, pending at word i+N
#pragma unroll
  for (int i = 0; i < N; i++) {
    const uint32_t q = t[i] * Field<N>::n0;
    t[i] = ptx::mad_lo_cc(q, Field<N>::m(0), t[i]);
#pragma unroll
    for (int j = 1; j < N; j++)
      t[i + j] = ptx::madc_lo_cc(q, Field<N>::m(j), t[i + j]);
    const uint32_t lo_carry = ptx::addc(0, 0);
    t[i + 1] = ptx::mad_hi_cc(q, Field<N>::m(0), t[i + 1]);
#pragma unroll
    for (int j = 1; j < N; j++)
      t[i + j + 1] = ptx::madc_hi_cc(q, Field<N>::m(j), t[i + j + 1]);
    uint32_t c = ptx::addc(0, 0);
    t[i + N] = ptx::add_cc(t[i + N], lo_carry);
    c = ptx::addc(c, 0);
    t[i + N] = ptx::add_cc(t[i + N], carry);
    carry = ptx::addc(c, 0);
  }
  kzg::cond_sub<N>(r, t + N, carry);
}

// the products, by the C entry point's number, and a value's register
// width under each (sqr12 squares its first operand)
enum Product { kMont12 = 0, kLazy12, kLazy13, kLazy16, kSqr12 };

template <int P>
constexpr int kWidth = P == kLazy13 ? 14 : P == kLazy16 ? 16 : 12;

template <int P>
__device__ __forceinline__ void product(uint32_t r[kWidth<P>],
                                        const uint32_t a[kWidth<P>],
                                        const uint32_t b[kWidth<P>]) {
  if constexpr (P == kMont12)
    kzg::mul<12>(r, a, b);
  else if constexpr (P == kLazy12)
    lazy_mul<12, 12>(r, a, b);
  else if constexpr (P == kLazy13)
    lazy_mul<14, 13>(r, a, b);
  else if constexpr (P == kLazy16)
    lazy_mul<16, 16>(r, a, b);
  else
    sym_sqr<12>(r, a);
}

enum Body { kTuple3 = 0, kSingle, kSerial, kSerial8, kSerial1, kTransp };

// a body's block: 256 threads for serial8 (the script's block), else
// kThreads; and the serial bodies' products a step
template <int BODY>
constexpr int kBodyThreads = BODY == kSerial8 ? 256 : kThreads;
template <int BODY>
constexpr int kSerialSteps = BODY == kSerial ? 7 : BODY == kSerial8 ? 8
                             : BODY == kSerial1 ? 1 : 0;

// In and out: (n, 12) Fp words a lane; a value is zero-padded to its
// product's width NA and stored as its low 12 words (every value of the
// chain is below 2p < 2^384). transp reads x, y and z from a (3, 12, n)
// word-major stack (word k of coordinate c of lane i at (12c + k) n + i,
// the layout of the TPU's pts.x.T) and writes f word-major, (12, n).
template <int BODY, int PROD>
__global__ void __launch_bounds__(kBodyThreads<BODY>)
    tuple_chain_kernel(int32_t* __restrict__ out,
                       const int32_t* __restrict__ in, int n, int depth) {
  constexpr int NA = kWidth<PROD>;
  const int i = blockIdx.x * kBodyThreads<BODY> + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NA];
#pragma unroll
  for (int k = 0; k < NA; k++) {
    if constexpr (BODY == kTransp)
      x[k] = k < 12 ? (uint32_t)in[(size_t)k * n + i] : 0;
    else
      x[k] = k < 12 ? (uint32_t)in[(size_t)i * 12 + k] : 0;
  }
  if constexpr (kSerialSteps<BODY> > 0) {
#pragma unroll 1
    for (int d = 0; d < depth; d++) {
#pragma unroll
      for (int s = 0; s < kSerialSteps<BODY>; s++) product<PROD>(x, x, x);
    }
  } else {
    uint32_t y[NA], z[NA];
    if constexpr (BODY == kTransp) {
#pragma unroll
      for (int k = 0; k < NA; k++) {
        y[k] = k < 12 ? (uint32_t)in[(size_t)(12 + k) * n + i] : 0;
        z[k] = k < 12 ? (uint32_t)in[(size_t)(24 + k) * n + i] : 0;
      }
    } else {
      kzg::copy<NA>(y, x);
      kzg::copy<NA>(z, x);
    }
    // single: the thread's 3 * NA words, one every kThreads words
    __shared__ uint32_t carry[BODY == kSingle ? 3 * NA * kThreads : 1];
    volatile uint32_t* w = carry + threadIdx.x;
#pragma unroll 1
    for (int d = 0; d < depth; d++) {
      uint32_t a[NA], b[NA], c[NA], dd[NA], e[NA];
      product<PROD>(a, x, y);
      product<PROD>(b, y, z);
      product<PROD>(c, z, x);
      product<PROD>(dd, a, b);
      product<PROD>(e, b, c);
      product<PROD>(x, dd, e);   // f
      product<PROD>(y, e, a);    // g
      kzg::copy<NA>(z, c);
      if constexpr (BODY == kSingle) {
#pragma unroll
        for (int k = 0; k < NA; k++) {
          w[k * kThreads] = x[k];
          w[(NA + k) * kThreads] = y[k];
          w[(2 * NA + k) * kThreads] = z[k];
        }
#pragma unroll
        for (int k = 0; k < NA; k++) {
          x[k] = w[k * kThreads];
          y[k] = w[(NA + k) * kThreads];
          z[k] = w[(2 * NA + k) * kThreads];
        }
      }
    }
  }
  if constexpr (BODY == kTransp) {
#pragma unroll
    for (int k = 0; k < 12; k++) out[(size_t)k * n + i] = (int32_t)x[k];
  } else {
    kzg::store<12>(out + (size_t)i * 12, x);
  }
}

template <int OP, int NEXTRA>
__global__ void __launch_bounds__(kThreads)
    ext_chain_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                     int32_t* __restrict__ oz, const int32_t* __restrict__ px,
                     const int32_t* __restrict__ py,
                     const int32_t* __restrict__ pz, int n, int depth) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)i * 12;
  uint32_t x[kExtNA], y[kExtNA], z[kExtNA];
  to_ext(x, px + o);
  to_ext(y, py + o);
  to_ext(z, pz + o);
#pragma unroll 1
  for (int d = 0; d < depth; d++) {
    uint32_t a[kExtNA], b[kExtNA], c[kExtNA], dd[kExtNA], e[kExtNA];
    ext_mul(a, x, y);
    ext_mul(b, y, z);
    ext_mul(c, z, x);
#pragma unroll
    for (int j = 0; j < NEXTRA; j++) {
      if (j % 3 == 0)
        ext_op<OP>(c, a, c);
      else if (j % 3 == 1)
        ext_op<OP>(c, b, c);
      else
        ext_op<OP>(c, c, c);
    }
    ext_mul(dd, a, b);
    ext_mul(e, b, c);
    ext_mul(x, dd, e);   // f
    ext_mul(y, e, a);    // g
    ext_mul(z, x, y);    // h = M(f, g)
  }
  from_ext(ox + o, x);
  from_ext(oy + o, y);
  from_ext(oz + o, z);
}

// ---- X7's ctx: REDC over 2^416 on a modulus held in registers ----

// field.cuh's cmad_mod and mul_row with the modulus words m[] and n0 read
// from registers in place of Field<N>::m(i) and n0 immediates
template <int N>
__device__ __forceinline__ void cmad_mod_reg(uint32_t acc[N],
                                             const uint32_t m[N], int off,
                                             uint32_t q) {
  acc[0] = ptx::mad_lo_cc(m[off], q, acc[0]);
  acc[1] = ptx::madc_hi_cc(m[off], q, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = ptx::madc_lo_cc(m[j + off], q, acc[j]);
    acc[j + 1] = ptx::madc_hi_cc(m[j + off], q, acc[j + 1]);
  }
}

template <int N>
__device__ __forceinline__ void mul_row_reg(uint32_t P[N], uint32_t Q[N],
                                            const uint32_t a[N], uint32_t x,
                                            bool first, const uint32_t m[N],
                                            uint32_t n0) {
  if (first) {
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      P[j] = a[j] * x;
      P[j + 1] = __umulhi(a[j], x);
      Q[j] = a[j + 1] * x;
      Q[j + 1] = __umulhi(a[j + 1], x);
    }
  } else {
    P[0] = ptx::add_cc(P[0], Q[1]);
#pragma unroll
    for (int j = 0; j < N - 2; j += 2) {
      Q[j] = ptx::madc_lo_cc(a[j + 1], x, Q[j + 2]);
      Q[j + 1] = ptx::madc_hi_cc(a[j + 1], x, Q[j + 3]);
    }
    Q[N - 2] = ptx::madc_lo_cc(a[N - 1], x, 0);
    Q[N - 1] = ptx::madc_hi(a[N - 1], x, 0);
    kzg::cmad<N>(P, a, 0, x);
    Q[N - 1] = ptx::addc(Q[N - 1], 0);
  }
  const uint32_t q = P[0] * n0;
  cmad_mod_reg<N>(Q, m, 1, q);
  cmad_mod_reg<N>(P, m, 0, q);
  Q[N - 1] = ptx::addc(Q[N - 1], 0);
}

// ext_mul (lazy_mul<14, 13>) on the modulus in registers: the same words
__device__ __forceinline__ void ext_mul_reg(uint32_t r[kExtNA],
                                            const uint32_t a[kExtNA],
                                            const uint32_t b[kExtNA],
                                            const uint32_t m[kExtNA],
                                            uint32_t n0) {
  uint32_t E[kExtNA], O[kExtNA];
#pragma unroll
  for (int i = 0; i + 1 < kExtWords; i += 2) {
    mul_row_reg<kExtNA>(E, O, a, b[i], i == 0, m, n0);
    mul_row_reg<kExtNA>(O, E, a, b[i + 1], false, m, n0);
  }
  mul_row_reg<kExtNA>(E, O, a, b[kExtWords - 1], false, m, n0);
  kzg::halves<kExtNA>(r, O, E);
  r[kExtWords] = 0;
}

// the lazy-domain bodies of X7 and X10: seven (X7's 7-product body, with
// to_ext / from_ext: conv; on the zero-padded words, stored as their low
// 12 words, the modulus from `ctx`: ctx), indep8 and dblshape (X10's raw
// product chains: 8 products of x, y, z, of which the carry reads three,
// and 8 in proj_double's dependency shape)
enum ExtBody { kSevenConv = 0, kSevenCtx, kIndep8, kDblShape };

template <int BODY>
__global__ void __launch_bounds__(kThreads)
    ext_body_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                    int32_t* __restrict__ oz, const int32_t* __restrict__ px,
                    const int32_t* __restrict__ py,
                    const int32_t* __restrict__ pz,
                    const int32_t* __restrict__ ctx, int n, int depth) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)i * 12;
  uint32_t x[kExtNA], y[kExtNA], z[kExtNA];
  if constexpr (BODY == kSevenCtx) {
    // the kernel context: the padded modulus and n0 from device memory
    // into registers, and K m by six lazy doublings, as _lazy_ctx builds
    // it (no op of this body reads it)
    uint32_t m[kExtNA], km[kExtNA];
#pragma unroll
    for (int k = 0; k < kExtNA; k++) m[k] = km[k] = (uint32_t)ctx[k];
    const uint32_t n0 = (uint32_t)ctx[kExtNA];
#pragma unroll
    for (int s = 0; s < 6; s++) ext_op<kLazyAdd>(km, km, km);
#pragma unroll
    for (int k = 0; k < kExtNA; k++) {
      x[k] = k < 12 ? (uint32_t)px[o + k] : 0;
      y[k] = k < 12 ? (uint32_t)py[o + k] : 0;
      z[k] = k < 12 ? (uint32_t)pz[o + k] : 0;
    }
#pragma unroll 1
    for (int d = 0; d < depth; d++) {
      uint32_t a[kExtNA], b[kExtNA], c[kExtNA], dd[kExtNA], e[kExtNA];
      ext_mul_reg(a, x, y, m, n0);
      ext_mul_reg(b, y, z, m, n0);
      ext_mul_reg(c, z, x, m, n0);
      ext_mul_reg(dd, a, b, m, n0);
      ext_mul_reg(e, b, c, m, n0);
      ext_mul_reg(x, dd, e, m, n0);   // f
      ext_mul_reg(y, e, a, m, n0);    // g
      kzg::copy<kExtNA>(z, c);
    }
    kzg::store<12>(ox + o, x);
    kzg::store<12>(oy + o, y);
    kzg::store<12>(oz + o, z);
  } else {
    to_ext(x, px + o);
    to_ext(y, py + o);
    to_ext(z, pz + o);
#pragma unroll 1
    for (int d = 0; d < depth; d++) {
      if constexpr (BODY == kSevenConv) {
        uint32_t a[kExtNA], b[kExtNA], c[kExtNA], dd[kExtNA], e[kExtNA];
        ext_mul(a, x, y);
        ext_mul(b, y, z);
        ext_mul(c, z, x);
        ext_mul(dd, a, b);
        ext_mul(e, b, c);
        ext_mul(x, dd, e);   // f
        ext_mul(y, e, a);    // g
        kzg::copy<kExtNA>(z, c);
      } else if constexpr (BODY == kIndep8) {
        uint32_t a[kExtNA], b[kExtNA], c[kExtNA], u[5][kExtNA];
        ext_mul(a, x, y);
        ext_mul(b, y, z);
        ext_mul(c, z, x);
        ext_mul(u[0], x, x);
        ext_mul(u[1], y, y);
        ext_mul(u[2], z, z);
        ext_mul(u[3], x, z);
        ext_mul(u[4], y, x);
        kzg::copy<kExtNA>(x, a);
        kzg::copy<kExtNA>(y, b);
        kzg::copy<kExtNA>(z, c);
      } else {
        uint32_t t0[kExtNA], t1[kExtNA], t2[kExtNA], a[kExtNA], b[kExtNA],
            c[kExtNA], dd[kExtNA];
        ext_mul(t0, y, y);
        ext_mul(t1, y, z);
        ext_mul(t2, z, z);
        ext_mul(a, t2, t0);
        ext_mul(b, t1, t2);
        ext_mul(c, a, b);
        ext_mul(dd, c, t0);
        ext_mul(z, dd, x);
        kzg::copy<kExtNA>(x, c);
        kzg::copy<kExtNA>(y, dd);
      }
    }
    from_ext(ox + o, x);
    from_ext(oy + o, y);
    from_ext(oz + o, z);
  }
}

template <int BODY, int PROD>
void launch_tuple(void* out, const void* a, int n, int depth, cudaStream_t s) {
  constexpr int T = kBodyThreads<BODY>;
  tuple_chain_kernel<BODY, PROD><<<(n + T - 1) / T, T, 0, s>>>(
      (int32_t*)out, (const int32_t*)a, n, depth);
}

template <int OP, int NEXTRA>
void launch_ext(void** o, const void** p, int n, int depth, cudaStream_t s) {
  ext_chain_kernel<OP, NEXTRA><<<blocks(n), kThreads, 0, s>>>(
      (int32_t*)o[0], (int32_t*)o[1], (int32_t*)o[2], (const int32_t*)p[0],
      (const int32_t*)p[1], (const int32_t*)p[2], n, depth);
}

template <int BODY>
void launch_ext_body(void** o, const void** p, const void* ctx, int n,
                     int depth, cudaStream_t s) {
  ext_body_kernel<BODY><<<blocks(n), kThreads, 0, s>>>(
      (int32_t*)o[0], (int32_t*)o[1], (int32_t*)o[2], (const int32_t*)p[0],
      (const int32_t*)p[1], (const int32_t*)p[2], (const int32_t*)ctx, n,
      depth);
}

}  // namespace

// body 0-5 = tuple3, single, serial, serial8, serial1, transp; product
// 0-4 = mont12, lazy12, lazy13, lazy16, sqr12 (single, serial8: mont12
// only; serial1: mont12, sqr12; transp: lazy13 only, `a` a (3, 12, n)
// word-major stack and `out` (12, n))
extern "C" int kzg_exp_tuple_chain(int body, int product, void* out,
                                   const void* a, int n, int depth,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || depth < 0) return (int)cudaErrorInvalidValue;
  switch (body * 8 + product) {
    case kTuple3 * 8 + kMont12:
      launch_tuple<kTuple3, kMont12>(out, a, n, depth, s);
      break;
    case kTuple3 * 8 + kLazy12:
      launch_tuple<kTuple3, kLazy12>(out, a, n, depth, s);
      break;
    case kTuple3 * 8 + kLazy13:
      launch_tuple<kTuple3, kLazy13>(out, a, n, depth, s);
      break;
    case kTuple3 * 8 + kLazy16:
      launch_tuple<kTuple3, kLazy16>(out, a, n, depth, s);
      break;
    case kSingle * 8 + kMont12:
      launch_tuple<kSingle, kMont12>(out, a, n, depth, s);
      break;
    case kSerial * 8 + kMont12:
      launch_tuple<kSerial, kMont12>(out, a, n, depth, s);
      break;
    case kSerial * 8 + kLazy12:
      launch_tuple<kSerial, kLazy12>(out, a, n, depth, s);
      break;
    case kSerial * 8 + kLazy13:
      launch_tuple<kSerial, kLazy13>(out, a, n, depth, s);
      break;
    case kSerial * 8 + kLazy16:
      launch_tuple<kSerial, kLazy16>(out, a, n, depth, s);
      break;
    case kSerial8 * 8 + kMont12:
      launch_tuple<kSerial8, kMont12>(out, a, n, depth, s);
      break;
    case kSerial1 * 8 + kMont12:
      launch_tuple<kSerial1, kMont12>(out, a, n, depth, s);
      break;
    case kSerial1 * 8 + kSqr12:
      launch_tuple<kSerial1, kSqr12>(out, a, n, depth, s);
      break;
    case kTransp * 8 + kLazy13:
      launch_tuple<kTransp, kLazy13>(out, a, n, depth, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// op 0, 1, 2 = lazy add, lazy sub, raw add; nextra 0, 4, 12 (0 and 4:
// the lazy add only) and 1 (the lazy sub only)
extern "C" int kzg_exp_ext_chain(int op, int nextra, void* ox, void* oy,
                                 void* oz, const void* px, const void* py,
                                 const void* pz, int n, int depth,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || depth < 0) return (int)cudaErrorInvalidValue;
  void* o[3] = {ox, oy, oz};
  const void* p[3] = {px, py, pz};
  if (op == kLazyAdd && nextra == 0)
    launch_ext<kLazyAdd, 0>(o, p, n, depth, s);
  else if (op == kLazyAdd && nextra == 4)
    launch_ext<kLazyAdd, 4>(o, p, n, depth, s);
  else if (op == kLazyAdd && nextra == 12)
    launch_ext<kLazyAdd, 12>(o, p, n, depth, s);
  else if (op == kLazySub && nextra == 1)
    launch_ext<kLazySub, 1>(o, p, n, depth, s);
  else if (op == kLazySub && nextra == 12)
    launch_ext<kLazySub, 12>(o, p, n, depth, s);
  else if (op == kRawAdd && nextra == 12)
    launch_ext<kRawAdd, 12>(o, p, n, depth, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// body 0-3 = seven with to_ext / from_ext (conv), seven on the padded
// words with the modulus from ctx (ctx: 14 modulus words, then n0), indep8,
// dblshape
extern "C" int kzg_exp_ext_body(int body, void* ox, void* oy, void* oz,
                                const void* px, const void* py,
                                const void* pz, const void* ctx, int n,
                                int depth, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || depth < 0) return (int)cudaErrorInvalidValue;
  void* o[3] = {ox, oy, oz};
  const void* p[3] = {px, py, pz};
  switch (body) {
    case kSevenConv:
      launch_ext_body<kSevenConv>(o, p, ctx, n, depth, s);
      break;
    case kSevenCtx:
      launch_ext_body<kSevenCtx>(o, p, ctx, n, depth, s);
      break;
    case kIndep8:
      launch_ext_body<kIndep8>(o, p, ctx, n, depth, s);
      break;
    case kDblShape:
      launch_ext_body<kDblShape>(o, p, ctx, n, depth, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
