// The point-op experiments on Hopper: chains of G1 point operations, one
// lane a thread, built by nvcc for sm_90a into a shared library with a
// plain C interface (loaded by kzg_tpu_torch/build.py through ctypes; the
// entry points live in kzg_tpu_torch/experiments/). No path of the library
// runs them.
//
// exp_point_chain<DOMAIN, OP, THREADS> replaces the point chains of
// scripts/exp_calib.py::projdbl (X3), exp_width.py::projdbl (X8),
// exp_pointops.py::chain_kernel and ::wstep_kernel_build (X9) and
// exp_lazyops.py::chain_kernel and ::wstep_with_table (X10): `depth`
// operations a lane on (x, y, z), the input's Jacobian words taken as the
// formula's coordinates, as the scripts take them. DOMAIN:
//   jac     canonical Fp, g1_jac.cuh's dbl-2009-l and add-2007-bl with
//           point_add_tile's selects (X9);
//   lazy    to_ext on entry, lazy.cuh's RCB formulas in the 13-word lazy
//           domain, from_ext on exit (X3, X8, X10);
//   ladder  g1.cuh's canonical RCB formulas, the ones K3 and g1_fft_stage
//           run (a case of the port only: exact field arithmetic in the
//           lazy formulas' order, so its words equal lazy's; it times the
//           ladder's own formulas).
// OP:
//   double  p <- 2p;
//   add     p <- p + (p.y, p.x, p.z);
//   wstep   the window step: before the loop, [1..8]P0 of the input point
//           P0 in shared memory (g1.cuh's interleaved Table layout; jac:
//           (k+1)P0 = kP0 + P0 on jac_add, as exp_pointops.py:112-125
//           meant; lazy and ladder: from jac_to_proj(P0), as
//           exp_lazyops.py:118-119), then each step 4 doubles and an add
//           of one entry (jac: entry 3 = 4P0; lazy and ladder: digit 5,
//           entry 4 = 5P0).
// THREADS: 64, the experiments' block, or 256, 512, 1024 (X8's sweep of
// the double, lazy and ladder).
//
// Bound on this card: at 2048 lanes a launch fills at most 32 SMs (64
// threads a block) and every lane is one chain of dependent point
// operations, so it is bound by one thread's chain: its products (a
// lazy double 8, an add 12, a Jacobian double 7, an add 16 with its
// double branch untaken) issue one after another (exp_tuple_chain's
// bodies: a thread's independent products do not overlap), about 1.1 us
// each, beside 48 bytes a coordinate moved. Design: the simplest form,
// one thread a lane, the point in registers; each formula's call site in
// a `#pragma unroll 1` loop keeps one copy of its code; the window table
// in dynamic shared memory, a thread's entries interleaved with its
// block's.
#include <cuda_runtime.h>

#include "g1_jac.cuh"
#include "lazy.cuh"

namespace {

using kzg::Jac;
using kzg::LazyPoint;
using kzg::NP;
using kzg::Proj;
using kzg::kExtNA;
using kzg::kExtWords;

enum Domain { kJac = 0, kLazy, kLadder };
enum Op { kDouble = 0, kAdd, kWstep };

// words of one table entry: 3 coordinates of NP (jac, ladder) or 13
// (lazy) words
template <int DOMAIN>
constexpr int kEntryWords = DOMAIN == kLazy ? 3 * kExtWords : kzg::PW;

template <int DOMAIN, int THREADS>
constexpr int kTableBytes = 8 * kEntryWords<DOMAIN> * THREADS * 4;

// entry k's W-word coordinates at base[(k E + c W + i) * stride], E the
// entry's words: g1.cuh's Table layout at any coordinate width
template <int W, typename P>
__device__ __forceinline__ void put_entry(uint32_t* base, int stride, int k,
                                          const P& p) {
  uint32_t* e = base + k * 3 * W * stride;
#pragma unroll
  for (int i = 0; i < W; i++) {
    e[i * stride] = p.x[i];
    e[(W + i) * stride] = p.y[i];
    e[(2 * W + i) * stride] = p.z[i];
  }
}

template <int W, typename P>
__device__ __forceinline__ void get_entry(P& p, const uint32_t* base,
                                          int stride, int k) {
  const uint32_t* e = base + k * 3 * W * stride;
#pragma unroll
  for (int i = 0; i < W; i++) {
    p.x[i] = e[i * stride];
    p.y[i] = e[(W + i) * stride];
    p.z[i] = e[(2 * W + i) * stride];
  }
}

template <typename P, int W>
__device__ __forceinline__ void swap_xy(P& q, const P& p) {
  kzg::copy<W>(q.x, p.y);
  kzg::copy<W>(q.y, p.x);
  kzg::copy<W>(q.z, p.z);
}

template <int OP>
__device__ __forceinline__ void jac_chain(Jac& p, uint32_t* tbl, int stride,
                                          int depth) {
  if constexpr (OP == kDouble) {
#pragma unroll 1
    for (int d = 0; d < depth; d++) kzg::jac_double(&p, &p);
  } else if constexpr (OP == kAdd) {
#pragma unroll 1
    for (int d = 0; d < depth; d++) {
      Jac q, r;
      swap_xy<Jac, NP>(q, p);
      kzg::jac_add(&r, &p, &q);
      p = r;
    }
  } else {
    Jac acc = p;
    put_entry<NP>(tbl, stride, 0, p);
#pragma unroll 1
    for (int k = 1; k < 8; k++) {
      Jac r;
      kzg::jac_add(&r, &acc, &p);
      acc = r;
      put_entry<NP>(tbl, stride, k, acc);
    }
#pragma unroll 1
    for (int d = 0; d < depth; d++) {
#pragma unroll 1
      for (int s = 0; s < 4; s++) kzg::jac_double(&p, &p);
      Jac sel, r;
      get_entry<NP>(sel, tbl, stride, 3);
      kzg::jac_add(&r, &p, &sel);
      p = r;
    }
  }
}

template <int OP>
__device__ __forceinline__ void lazy_chain(LazyPoint& p, uint32_t* tbl,
                                           int stride, int depth) {
  if constexpr (OP == kDouble) {
#pragma unroll 1
    for (int d = 0; d < depth; d++) kzg::ext_proj_double(p, p);
  } else if constexpr (OP == kAdd) {
#pragma unroll 1
    for (int d = 0; d < depth; d++) {
      LazyPoint q;
      swap_xy<LazyPoint, kExtNA>(q, p);
      kzg::ext_proj_add(p, p, q);
    }
  } else {
    LazyPoint base, acc;
    kzg::ext_jac_to_proj(base, p);
    acc = base;
    put_entry<kExtWords>(tbl, stride, 0, base);
#pragma unroll 1
    for (int k = 1; k < 8; k++) {
      kzg::ext_proj_add(acc, acc, base);
      put_entry<kExtWords>(tbl, stride, k, acc);
    }
#pragma unroll 1
    for (int d = 0; d < depth; d++) {
#pragma unroll 1
      for (int s = 0; s < 4; s++) kzg::ext_proj_double(p, p);
      LazyPoint sel;
      get_entry<kExtWords>(sel, tbl, stride, 4);
      sel.x[kExtWords] = sel.y[kExtWords] = sel.z[kExtWords] = 0;
      kzg::ext_proj_add(p, p, sel);
    }
  }
}

template <int OP>
__device__ __forceinline__ void ladder_chain(Proj& p, const int32_t* px,
                                             const int32_t* py,
                                             const int32_t* pz,
                                             uint32_t* tbl, int stride,
                                             int depth) {
  if constexpr (OP == kDouble) {
#pragma unroll 1
    for (int d = 0; d < depth; d++) kzg::proj_double(p, p);
  } else if constexpr (OP == kAdd) {
#pragma unroll 1
    for (int d = 0; d < depth; d++) {
      Proj q;
      swap_xy<Proj, NP>(q, p);
      kzg::proj_add(p, p, q);
    }
  } else {
    const kzg::Table t{tbl, stride};
    Proj base;
    kzg::jac_to_proj(base, px, py, pz);
    kzg::build_table(t, base);
#pragma unroll 1
    for (int d = 0; d < depth; d++) {
#pragma unroll 1
      for (int s = 0; s < 4; s++) kzg::proj_double(p, p);
      Proj sel;
      kzg::load_point(sel, t.entry(4), t.stride);
      kzg::proj_add(p, p, sel);
    }
  }
}

// In and out: (n, 12) Fp words a coordinate and lane.
template <int DOMAIN, int OP, int THREADS>
__global__ void __launch_bounds__(THREADS)
    point_chain_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                       int32_t* __restrict__ oz,
                       const int32_t* __restrict__ px,
                       const int32_t* __restrict__ py,
                       const int32_t* __restrict__ pz, int n, int depth) {
  extern __shared__ uint32_t smem[];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)i * NP;
  uint32_t* tbl = smem + threadIdx.x;
  if constexpr (DOMAIN == kJac) {
    Jac p;
    kzg::load_jac(&p, px + o, py + o, pz + o);
    jac_chain<OP>(p, tbl, THREADS, depth);
    kzg::store_jac(ox + o, oy + o, oz + o, &p);
  } else if constexpr (DOMAIN == kLazy) {
    LazyPoint p;
    kzg::to_ext(p.x, px + o);
    kzg::to_ext(p.y, py + o);
    kzg::to_ext(p.z, pz + o);
    lazy_chain<OP>(p, tbl, THREADS, depth);
    kzg::from_ext(ox + o, p.x);
    kzg::from_ext(oy + o, p.y);
    kzg::from_ext(oz + o, p.z);
  } else {
    Proj p;
    kzg::load<NP>(p.x, px + o);
    kzg::load<NP>(p.y, py + o);
    kzg::load<NP>(p.z, pz + o);
    ladder_chain<OP>(p, px + o, py + o, pz + o, tbl, THREADS, depth);
    kzg::store<NP>(ox + o, p.x);
    kzg::store<NP>(oy + o, p.y);
    kzg::store<NP>(oz + o, p.z);
  }
}

template <int DOMAIN, int OP, int THREADS>
int launch(void* const* o, const void* const* p, int n, int depth,
           cudaStream_t s) {
  constexpr int smem = OP == kWstep ? kTableBytes<DOMAIN, THREADS> : 0;
  auto* kernel = point_chain_kernel<DOMAIN, OP, THREADS>;
  if (smem > 48 * 1024) {
    if (int err = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
      return err;
  }
  kernel<<<(n + THREADS - 1) / THREADS, THREADS, smem, s>>>(
      (int32_t*)o[0], (int32_t*)o[1], (int32_t*)o[2], (const int32_t*)p[0],
      (const int32_t*)p[1], (const int32_t*)p[2], n, depth);
  return (int)cudaGetLastError();
}

constexpr int key(int domain, int op, int threads) {
  return (domain * 4 + op) * 2048 + threads;
}

}  // namespace

// domain 0, 1, 2 = jac, lazy, ladder; op 0, 1, 2 = double, add, wstep;
// threads a block: 64 for every case, also 256, 512 and 1024 for the lazy
// and ladder doubles
extern "C" int kzg_exp_point_chain(int domain, int op, int threads, void* ox,
                                   void* oy, void* oz, const void* px,
                                   const void* py, const void* pz, int n,
                                   int depth, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || depth < 0) return (int)cudaErrorInvalidValue;
  void* const o[3] = {ox, oy, oz};
  const void* const p[3] = {px, py, pz};
  switch (key(domain, op, threads)) {
    case key(kJac, kDouble, 64):
      return launch<kJac, kDouble, 64>(o, p, n, depth, s);
    case key(kJac, kAdd, 64):
      return launch<kJac, kAdd, 64>(o, p, n, depth, s);
    case key(kJac, kWstep, 64):
      return launch<kJac, kWstep, 64>(o, p, n, depth, s);
    case key(kLazy, kDouble, 64):
      return launch<kLazy, kDouble, 64>(o, p, n, depth, s);
    case key(kLazy, kDouble, 256):
      return launch<kLazy, kDouble, 256>(o, p, n, depth, s);
    case key(kLazy, kDouble, 512):
      return launch<kLazy, kDouble, 512>(o, p, n, depth, s);
    case key(kLazy, kDouble, 1024):
      return launch<kLazy, kDouble, 1024>(o, p, n, depth, s);
    case key(kLazy, kAdd, 64):
      return launch<kLazy, kAdd, 64>(o, p, n, depth, s);
    case key(kLazy, kWstep, 64):
      return launch<kLazy, kWstep, 64>(o, p, n, depth, s);
    case key(kLadder, kDouble, 64):
      return launch<kLadder, kDouble, 64>(o, p, n, depth, s);
    case key(kLadder, kDouble, 256):
      return launch<kLadder, kDouble, 256>(o, p, n, depth, s);
    case key(kLadder, kDouble, 512):
      return launch<kLadder, kDouble, 512>(o, p, n, depth, s);
    case key(kLadder, kDouble, 1024):
      return launch<kLadder, kDouble, 1024>(o, p, n, depth, s);
    case key(kLadder, kAdd, 64):
      return launch<kLadder, kAdd, 64>(o, p, n, depth, s);
    case key(kLadder, kWstep, 64):
      return launch<kLadder, kWstep, 64>(o, p, n, depth, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
