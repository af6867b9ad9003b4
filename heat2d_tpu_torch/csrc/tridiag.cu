// Hand-written Hopper (sm_90a) kernels for batched constant-coefficient
// tridiagonal solves: the Crank-Nicolson half-step systems of the ADI
// method, (I - (c/2) d2) x = rhs with identity rows 0 and n-1, one
// diffusion number c per member.
//
// Two kernels, the port of kernel TD of heat2d_tpu/ops/tridiag.py; the
// Python wrappers, their plain PyTorch versions and the launch counters
// live in heat2d_tpu_torch/ops/tridiag.py.
//
//   H10 k_td_rows  <- _tridiag_rows_kernel (TD, tridiag.py:324): solve
//                     along axis 1 of a (B, n, m) batch: one thread per
//                     system, that is one column j of member b.  The
//                     forward sweep and the back substitution walk the
//                     rows, and neighbouring threads read neighbouring
//                     addresses (coalesced).
//   H11 k_td_lanes <- _tridiag_lanes_kernel (TD, tridiag.py:349): solve
//                     along axis 2 of a (B, rows, n) batch: one thread per
//                     row, eliminating along the columns.  Neighbouring
//                     threads read addresses a whole row apart (strided,
//                     uncoalesced): the simple first version.
//
// Both first run k_td_coeffs, one thread per member: the elimination
// scalars of the member's matrix, in the order of the JAX package's
// _coeff_loops (tridiag.py:219): m = b - a*cp[i-1], mi = 1/m, cp = a/m,
// with a = -c/2 and b = 1 + c on interior rows, (0, 1) on rows 0 and
// n-1.  The solve is then out[i] = (rhs[i] - a*out[i-1]) * mi[i] forward
// and out[i] -= cp[i] * out[i+1] back.  Every operation rounds on its
// own (__f*_rn), as the plain version does.
//
// A system is a sequential recurrence: each thread does O(n) dependent
// steps, and with one thread per system a 4096 x 4096 member gives only
// 4096 threads (about one warp per SM).  The kernels are bound by that
// latency, far below the card's byte bound; the forward loop is unrolled
// so that each thread keeps several independent rhs loads in flight.
//
// Every entry point returns a cudaError_t (0 on success); the Python
// wrapper raises on anything else.

#include <cuda_runtime.h>

namespace {

constexpr int COEF_THREADS = 32;
constexpr int SOLVE_THREADS = 32;

// coef: (nb, 2, n) -- cp then mi of each member.
__global__ void k_td_coeffs(const float* __restrict__ c,
                            float* __restrict__ coef, int nb, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const float a = __fmul_rn(-0.5f, c[b]);
  const float d = __fadd_rn(1.0f, c[b]);
  float* cp = coef + (size_t)b * 2 * n;
  float* mi = cp + n;
  cp[0] = 0.0f;
  mi[0] = 1.0f;
  float cprev = 0.0f;
  for (int i = 1; i < n; ++i) {
    const bool interior = i <= n - 2;
    const float ai = interior ? a : 0.0f;
    const float m = __fsub_rn(interior ? d : 1.0f, __fmul_rn(ai, cprev));
    mi[i] = __fdiv_rn(1.0f, m);
    cprev = __fdiv_rn(ai, m);
    cp[i] = cprev;
  }
}

// One system of n unknowns at `x + k*stride`, k = 0..n-1.
__device__ __forceinline__ void solve_system(const float* __restrict__ rhs,
                                             float* __restrict__ out,
                                             size_t stride, int n, float a,
                                             const float* __restrict__ cp,
                                             const float* __restrict__ mi) {
  float prev = rhs[0];
  out[0] = prev;
#pragma unroll 8
  for (int i = 1; i < n; ++i) {
    const float ai = i <= n - 2 ? a : 0.0f;
    prev = __fmul_rn(__fsub_rn(rhs[i * stride], __fmul_rn(ai, prev)),
                     mi[i]);
    out[i * stride] = prev;
  }
  float next = prev;
  for (int i = n - 2; i >= 0; --i) {
    next = __fsub_rn(out[i * stride], __fmul_rn(cp[i], next));
    out[i * stride] = next;
  }
}

// H10: thread (blockIdx.x * 32 + threadIdx.x) solves column j of member
// blockIdx.y of a (nb, n, m) batch.
__global__ void k_td_rows(const float* __restrict__ rhs,
                          float* __restrict__ out,
                          const float* __restrict__ c,
                          const float* __restrict__ coef, int n, int m) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (j >= m) return;
  const size_t base = (size_t)b * n * m + j;
  const float* cp = coef + (size_t)b * 2 * n;
  solve_system(rhs + base, out + base, (size_t)m, n,
               __fmul_rn(-0.5f, c[b]), cp, cp + n);
}

// H11: thread (blockIdx.x * 32 + threadIdx.x) solves row i of member
// blockIdx.y of a (nb, rows, n) batch.
__global__ void k_td_lanes(const float* __restrict__ rhs,
                           float* __restrict__ out,
                           const float* __restrict__ c,
                           const float* __restrict__ coef, int rows, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= rows) return;
  const size_t base = ((size_t)b * rows + i) * n;
  const float* cp = coef + (size_t)b * 2 * n;
  solve_system(rhs + base, out + base, 1, n, __fmul_rn(-0.5f, c[b]), cp,
               cp + n);
}

cudaError_t coeffs(const float* c, float* coef, int nb, int n,
                   cudaStream_t s) {
  k_td_coeffs<<<(nb + COEF_THREADS - 1) / COEF_THREADS, COEF_THREADS, 0,
                s>>>(c, coef, nb, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* heat_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Solve along axis 1 of the (nb, n, m) batch; coef is (nb, 2, n) scratch.
int heat_td_rows(const float* rhs, float* out, const float* c, float* coef,
                 int nb, int n, int m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = coeffs(c, coef, nb, n, s);
  if (e != cudaSuccess) return e;
  const dim3 grid((m + SOLVE_THREADS - 1) / SOLVE_THREADS, nb);
  k_td_rows<<<grid, SOLVE_THREADS, 0, s>>>(rhs, out, c, coef, n, m);
  return cudaGetLastError();
}

// Solve along axis 2 of the (nb, rows, n) batch; coef is (nb, 2, n).
int heat_td_lanes(const float* rhs, float* out, const float* c, float* coef,
                  int nb, int rows, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = coeffs(c, coef, nb, n, s);
  if (e != cudaSuccess) return e;
  const dim3 grid((rows + SOLVE_THREADS - 1) / SOLVE_THREADS, nb);
  k_td_lanes<<<grid, SOLVE_THREADS, 0, s>>>(rhs, out, c, coef, rows, n);
  return cudaGetLastError();
}

}  // extern "C"
