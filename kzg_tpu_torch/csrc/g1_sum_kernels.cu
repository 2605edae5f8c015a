// G1 row sums for the MSM and FK20, built by nvcc for sm_90a into a shared
// library with a plain C interface (kzg_tpu_torch/build.py).
//
// g1_sum replaces, in every tree sum of the port (FK20's l-way sum, the
// commitment's sum over the CRS lanes, the MSM's window sums), the route
// of kzg_tpu/curve/pallas_g1.py::_add_fn (add_pallas, one launch a tree
// level): the sum of each row of G1 points in one launch. g1_horner
// replaces, in the variable-base MSM, the route of ::_double_fn
// (double_pallas) and ::_add_fn in the Horner combine
// acc = sum_j 16^j S_j (63 x (4 doublings + 1 add), one launch a point
// operation): the whole chain of one MSM in one thread.
//
// Both run the complete RCB projective formulas of g1.cuh: straight-line,
// so the lanes of a warp never diverge on P == Q, P == -Q or infinity.
// Points enter as Jacobian words (infinity as any Z == 0), are converted
// with jac_to_proj on load and leave through store_jac (infinity as
// all-zero words). The plain versions (curve/kernels.py) follow the same
// partition and order, so the output words are equal.
//
// g1_sum, design: a block sums kRun x kThreads consecutive points of a row.
// Thread t adds its run of kRun points in a register chain; the warps sum
// their 32 partials by shuffles (lane j += lane j + s, s = 16 .. 1), then
// warp 0 sums the kThreads / 32 warp partials, from shared memory, in the
// same tree order. No atomics: the order is fixed. A partial whose first
// point lies beyond the row's end is the identity and is never added, so
// short rows (FK20's 64 points) cost only the levels they fill. A row of
// more than kRun x kThreads points gives one partial a block, which the
// wrapper sums with a second launch. Bound on this card: R (N - 1)
// additions of 12 Fp products against R N x 144 bytes read, so the
// multiply rate bounds wide batches; the latency bound of a perfect tree
// is ceil(log2 N) dependent additions, and this kernel's chain is
// (kRun - 1) + log2(kThreads) additions a pass.
//
// g1_horner, design: one thread an MSM, the 63 x (4 proj_double +
// 1 proj_add) chain in registers with one call site of each formula
// (`#pragma unroll 1`). Its dependent chain is 2,772 products (8 an RCB
// doubling, 12 an addition) plus the conversions, about 3 ms at the
// product's latency, one MSM alone; the function itself needs 2,520
// (7 a Jacobian doubling).
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

constexpr int kThreads = 128;   // threads of a g1_sum block
constexpr int kRun = 4;         // consecutive points a thread adds
constexpr int kWarps = kThreads / 32;
constexpr int kWarpLevels = 2;  // log2(kWarps)
static_assert(kWarps == 1 << kWarpLevels, "kWarpLevels");
constexpr int kWindows = 64;    // window sums of an MSM (g1_horner)
constexpr int kHornerThreads = 64;
using kzg::NP;
using kzg::Proj;
using kzg::PW;

// Lanes j < s add lane j + s's point when its first item lies in the row.
__device__ __forceinline__ void shuffle_tree(Proj& acc, int lane, int levels,
                                             long first, long step, long n) {
#pragma unroll 1
  for (int s = 1 << (levels - 1); s >= 1; s >>= 1) {
    Proj o;
#pragma unroll
    for (int k = 0; k < NP; k++) {
      o.x[k] = __shfl_down_sync(0xffffffffu, acc.x[k], s);
      o.y[k] = __shfl_down_sync(0xffffffffu, acc.y[k], s);
      o.z[k] = __shfl_down_sync(0xffffffffu, acc.z[k], s);
    }
    if (lane < s && first + s * step < n) kzg::proj_add(acc, acc, o);
  }
}

__global__ void __launch_bounds__(kThreads)
    g1_sum_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                  int32_t* __restrict__ oz, const int32_t* __restrict__ px,
                  const int32_t* __restrict__ py,
                  const int32_t* __restrict__ pz, int n, int inner,
                  int blocks_per_row) {
  __shared__ uint32_t partials[kWarps * PW];
  const int row = blockIdx.x / blocks_per_row;
  const long chunk = (long)(blockIdx.x % blocks_per_row) * kRun * kThreads;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  // item i of this row is point ((row / inner) n + i) inner + row % inner
  const size_t base = (size_t)(row / inner) * n * inner + row % inner;
  const long first = chunk + (long)t * kRun;
  Proj acc;
  kzg::proj_identity(acc);
#pragma unroll 1
  for (int k = 0; k < kRun && first + k < n; k++) {
    const size_t o = (base + (size_t)(first + k) * inner) * NP;
    Proj p;
    kzg::jac_to_proj(p, px + o, py + o, pz + o);
    if (k == 0) {
      acc = p;
    } else {
      kzg::proj_add(acc, acc, p);
    }
  }
  shuffle_tree(acc, lane, 5, first, kRun, n);
  if (lane == 0) kzg::store_point(partials + warp * PW, 1, acc);
  __syncthreads();
  if (warp != 0) return;
  if (lane < kWarps) kzg::load_point(acc, partials + lane * PW, 1);
  shuffle_tree(acc, lane, kWarpLevels, chunk + (long)lane * 32 * kRun,
               32 * kRun, n);
  if (lane == 0) {
    const size_t o = (size_t)blockIdx.x * NP;
    kzg::store_jac(ox + o, oy + o, oz + o, acc);
  }
}

__global__ void __launch_bounds__(kHornerThreads)
    g1_horner_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                     int32_t* __restrict__ oz,
                     const int32_t* __restrict__ px,
                     const int32_t* __restrict__ py,
                     const int32_t* __restrict__ pz, int b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const size_t row = (size_t)i * kWindows;
  Proj acc, s;
  size_t o = (row + kWindows - 1) * NP;
  kzg::jac_to_proj(acc, px + o, py + o, pz + o);
#pragma unroll 1
  for (int j = kWindows - 2; j >= 0; j--) {
#pragma unroll 1
    for (int k = 0; k < 4; k++) kzg::proj_double(acc, acc);
    o = (row + j) * NP;
    kzg::jac_to_proj(s, px + o, py + o, pz + o);
    kzg::proj_add(acc, acc, s);
  }
  o = (size_t)i * NP;
  kzg::store_jac(ox + o, oy + o, oz + o, acc);
}

}  // namespace

// Sums of rows of n Jacobian points into (rows, blocks_per_row) points:
// point i of row r at index ((r / inner) n + i) inner + r % inner, so a
// batch (A, n, inner) sums over its middle axis.
extern "C" int kzg_g1_sum(void* ox, void* oy, void* oz, const void* px,
                          const void* py, const void* pz, int rows, int n,
                          int inner, int blocks_per_row, void* stream) {
  g1_sum_kernel<<<rows * blocks_per_row, kThreads, 0,
                  (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)px,
      (const int32_t*)py, (const int32_t*)pz, n, inner, blocks_per_row);
  return (int)cudaGetLastError();
}

extern "C" int kzg_g1_horner(void* ox, void* oy, void* oz, const void* px,
                             const void* py, const void* pz, int b,
                             void* stream) {
  g1_horner_kernel<<<(b + kHornerThreads - 1) / kHornerThreads,
                     kHornerThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)px,
      (const int32_t*)py, (const int32_t*)pz, b);
  return (int)cudaGetLastError();
}
