// The pairing kernels K-a (g2_scalar_mul), K-b (pairing_lines, then
// pairing_miller_eval, the lines' evaluation) and K-c (pairing_final_exp),
// built by nvcc for sm_90a into a shared library with a plain C interface
// (kzg_tpu_torch/build.py). Their lane bodies and the Fp2/Fp6/Fp12 tower
// are in tower.cuh.
//
// None replaces a Pallas kernel: the JAX package's device pairing is
// plain jnp (kzg_tpu/curve/tower.py, pairing_device.py), where every
// Fp12 step would be dozens of launches in plain torch. K-a replaces
// g2.ops.scalar_mul in kzg_tpu/kzg/settings.py:60-66, K-b the Miller loops
// of kzg_tpu/curve/pairing_device.py:97-205, K-c its final exponentiation
// (:252-312).
//
// Bound on this card: each lane is a dependent chain of Fp products (a
// product's latency is about 1.1 us); at the verification path's 128
// lanes the multiply rate plays no part. Design:
// - K-a and the lines: one thread a lane (a warp a block); K-a keeps its
//   [1..8]Q table in dynamic shared memory interleaved across the block,
//   as K3 does. The lines of a G2 point depend on nothing else, so the
//   batched check computes those of its two fixed G2 points once and
//   every lane of the evaluation reads them (stride 0).
// - K-b's evaluation and K-c: a warp a lane (kBlock / kGroup lanes a
//   block), its Fp12 values in shared memory, each Fp12 operation's
//   independent Fp products spread over the warp (tower.cuh's group
//   layer): an Fp12 product is 2 product latencies, a cyclotomic square
//   one (a warp was faster than 8 or 16 threads a lane, PERF.md). K-c's
//   hard part is the x-chain: 314 cyclotomic squares and 52 products of
//   Fp12, no table; its one inverse (the easy part's) takes the Fp
//   inverse by the binary extended Euclid algorithm, not a 608-product
//   Fermat chain.
//   The lines are evaluated at P scaled by Z^3 (an Fp factor the final
//   exponentiation removes), so K-b takes no inverse.
#include <cuda_runtime.h>

#include "tower.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kSmem = kThreads * kzg::T2W * 4;  // 73,728 bytes
constexpr int kBlock = 64;                     // K-b's evaluation and K-c
using kzg::Fp2;
using kzg::NF;

constexpr int kF12Words = 12 * NF;
// a lane's shared words besides its warp's scratch: f, the two evaluated
// lines and Z^3, X Z, Y of both pairs (K-b); four Fp12 (K-c)
constexpr int kMillerLane = 2 * kF12Words + 6 * NF;
constexpr int kFexpLane = 4 * kF12Words;

__device__ __forceinline__ void load_f2(Fp2& r, const int32_t* p) {
  kzg::load<NF>(r.c0, p);
  kzg::load<NF>(r.c1, p + NF);
}

__device__ __forceinline__ void store_f2(int32_t* p, const Fp2& a) {
  kzg::store<NF>(p, a.c0);
  kzg::store<NF>(p + NF, a.c1);
}

constexpr int kLanesABlock = kBlock / kzg::kGroup;

// Lane (blockIdx.x * lanes a block + warp) and its warp; the lane's
// `words` of dynamic shared memory, then the warp's scratch.
__device__ __forceinline__ kzg::Grp make_group(uint32_t* smem, int words,
                                               uint32_t** own, int* lane) {
  const int local = threadIdx.x / kzg::kGroup;
  *lane = blockIdx.x * kLanesABlock + local;
  kzg::Grp g;
  g.rank = threadIdx.x % kzg::kGroup;
  *own = smem + local * (words + kzg::kGrpWords);
  g.op = *own + words;
  g.pr = g.op + 18 * 48;
  g.tt = g.pr + 54 * NF;
  return g;
}

__global__ void __launch_bounds__(kThreads)
    g2_scalar_mul_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                         int32_t* __restrict__ oz,
                         const int32_t* __restrict__ px,
                         const int32_t* __restrict__ py,
                         const int32_t* __restrict__ pz,
                         const int32_t* __restrict__ digits, int n_windows,
                         int n) {
  extern __shared__ uint32_t smem[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)i * 2 * NF;
  Fp2 x, y, z, t, zz;
  load_f2(x, px + o);
  load_f2(y, py + o);
  load_f2(z, pz + o);
  kzg::Proj2 q, acc;
  kzg::jac2_to_proj(q, x, y, z);
  const kzg::Table2 tbl{smem + threadIdx.x, kThreads};
  kzg::g2_ladder_lane(acc, tbl, q, digits + (size_t)i * n_windows,
                      n_windows);
  // projective (X : Y : Z) -> Jacobian (XZ, YZ^2, Z)
  kzg::f2_mul(t, acc.x, acc.z);
  store_f2(ox + o, t);
  kzg::f2_sqr(zz, acc.z);
  kzg::f2_mul(t, acc.y, zz);
  store_f2(oy + o, t);
  store_f2(oz + o, acc.z);
}

__global__ void __launch_bounds__(kThreads)
    pairing_lines_kernel(int32_t* __restrict__ out,
                         const int32_t* __restrict__ qx,
                         const int32_t* __restrict__ qy, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp2 x, y;
  load_f2(x, qx + (size_t)i * 2 * NF);
  load_f2(y, qy + (size_t)i * 2 * NF);
  kzg::lines_lane(out + (size_t)i * kzg::kLines * kzg::kLineWords, x, y);
}

__global__ void __launch_bounds__(kBlock)
    pairing_miller_eval_kernel(int32_t* __restrict__ out,
                               const int32_t* __restrict__ a1x,
                               const int32_t* __restrict__ a1y,
                               const int32_t* __restrict__ a1z,
                               const int32_t* __restrict__ a_lines,
                               const int32_t* __restrict__ a2inf,
                               const int32_t* __restrict__ b1x,
                               const int32_t* __restrict__ b1y,
                               const int32_t* __restrict__ b1z,
                               const int32_t* __restrict__ b_lines,
                               const int32_t* __restrict__ b2inf, int bcast,
                               int n) {
  extern __shared__ uint32_t smem[];
  uint32_t* s;
  int i;
  const kzg::Grp g = make_group(smem, kMillerLane, &s, &i);
  if (i >= n) return;
  const size_t o = (size_t)i * NF;
  const size_t lw = (size_t)kzg::kLines * kzg::kLineWords;
  const int32_t* X[2] = {a1x + o, b1x + o};
  const int32_t* Y[2] = {a1y + o, b1y + o};
  const int32_t* Z[2] = {a1z + o, b1z + o};
  const int32_t* lines[2] = {a_lines + ((bcast & 1) ? 0 : i * lw),
                             b_lines + ((bcast & 2) ? 0 : i * lw)};
  const int32_t* inf[2] = {a2inf, b2inf};
  bool skip[2];
#pragma unroll 1
  for (int k = 0; k < 2; k++) {
    uint32_t z[NF];
    kzg::load<NF>(z, Z[k]);
    skip[k] = kzg::is_zero<NF>(z) || inf[k][i] != 0;
  }
  kzg::miller_eval_lane(s, X, Y, Z, lines, skip, g);
#pragma unroll 1
  for (int w = g.rank; w < kF12Words; w += kzg::kGroup)
    out[(size_t)i * kF12Words + w] = (int32_t)s[w];
}

__global__ void __launch_bounds__(kBlock)
    pairing_final_exp_kernel(int32_t* __restrict__ out,
                             int32_t* __restrict__ ok,
                             const int32_t* __restrict__ f,
                             const int32_t* __restrict__ gammas, int n) {
  extern __shared__ uint32_t smem[];
  uint32_t* s;
  int i;
  const kzg::Grp g = make_group(smem, kFexpLane, &s, &i);
  if (i >= n) return;
  kzg::final_exp_lane(s, f + (size_t)i * kF12Words, gammas, g);
#pragma unroll 1
  for (int w = g.rank; w < kF12Words; w += kzg::kGroup)
    out[(size_t)i * kF12Words + w] = (int32_t)s[w];
  if (g.rank == 0) {
    bool one = true;
#pragma unroll 1
    for (int w = 0; w < kF12Words; w++)
      one &= s[w] == (w < NF ? kzg::Field<NF>::one(w) : 0u);
    ok[i] = one ? 1 : 0;
  }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

int lane_blocks(int n) { return (n + kLanesABlock - 1) / kLanesABlock; }

// the dynamic shared memory of a block of kLanesABlock lanes of `words`
// each, allowed to the kernel
int group_smem(const void* kernel, int words, int* bytes) {
  *bytes = kLanesABlock * (words + kzg::kGrpWords) * 4;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
}

}  // namespace

extern "C" int kzg_g2_scalar_mul(void* ox, void* oy, void* oz, const void* px,
                                 const void* py, const void* pz,
                                 const void* digits, int n_windows, int n,
                                 void* stream) {
  if (int err = (int)cudaFuncSetAttribute(
          g2_scalar_mul_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem))
    return err;
  g2_scalar_mul_kernel<<<blocks(n), kThreads, kSmem,
                         (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)px,
      (const int32_t*)py, (const int32_t*)pz, (const int32_t*)digits,
      n_windows, n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_pairing_lines(void* out, const void* qx, const void* qy,
                                 int n, void* stream) {
  pairing_lines_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)qx, (const int32_t*)qy, n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_pairing_miller_eval(void* out, const void* a1x,
                                       const void* a1y, const void* a1z,
                                       const void* a_lines, const void* a2inf,
                                       const void* b1x, const void* b1y,
                                       const void* b1z, const void* b_lines,
                                       const void* b2inf, int bcast, int n,
                                       void* stream) {
  int smem;
  if (int err = group_smem((const void*)pairing_miller_eval_kernel,
                           kMillerLane, &smem))
    return err;
  pairing_miller_eval_kernel<<<lane_blocks(n), kBlock, smem,
                               (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)a1x, (const int32_t*)a1y,
      (const int32_t*)a1z, (const int32_t*)a_lines, (const int32_t*)a2inf,
      (const int32_t*)b1x, (const int32_t*)b1y, (const int32_t*)b1z,
      (const int32_t*)b_lines, (const int32_t*)b2inf, bcast, n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_pairing_final_exp(void* out, void* ok, const void* f,
                                     const void* gammas, int n,
                                     void* stream) {
  int smem;
  if (int err = group_smem((const void*)pairing_final_exp_kernel, kFexpLane,
                           &smem))
    return err;
  pairing_final_exp_kernel<<<lane_blocks(n), kBlock, smem,
                             (cudaStream_t)stream>>>(
      (int32_t*)out, (int32_t*)ok, (const int32_t*)f,
      (const int32_t*)gammas, n);
  return (int)cudaGetLastError();
}
