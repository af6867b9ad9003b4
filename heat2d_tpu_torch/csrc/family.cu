// Hand-written Hopper (sm_90a) kernels for batched ensembles of the
// problem families heat9, advdiff and reactdiff: B members of one
// nx x ny shape, one contiguous (B, nx, ny) f32 batch, each member with
// its S scalar operands in row b of a (B, S) f32 device array (the order
// of problems/kernels.<fam>_scalars).
//
// Two kernels, the port of the Pallas kernels of
// heat2d_tpu/problems/runners.py; the Python wrappers, their plain
// PyTorch versions and the launch counters live in
// heat2d_tpu_torch/ops/cuda_family.py.
//
//   H8 k_fam_resident <- _family_ensemble_kernel (B9, runners.py:124):
//                     every member advances `steps` steps in one
//                     cooperative launch, as B9 keeps a member in VMEM
//                     for all steps.  The on-chip resident sweep of
//                     csrc/resident.cuh (H5's) with a family operator:
//                     tiles stay in shared memory, one ring exchange of
//                     depth W * K per K steps.  Its step loop (tile_steps)
//                     moves 4 * (2 + 4W) bytes of shared memory per
//                     cell-step and is bound by the instructions of the
//                     families' rounded update sequences (window_steps is
//                     built beside it and timed by chip_smoke.py).  The wrapper
//                     sends members too large to stay on the chip to
//                     H9 sweeps.
//   H9 k_fam_tile     <- _family_band_kernel (B10, runners.py:181): nsub
//                     steps per sweep of shared-memory tiles with a ring
//                     of depth H = W * nsub, blockIdx.z = member (the
//                     strip sweep of csrc/tile.cuh).  The TPU kernel
//                     holds only global rows, because its band spans the
//                     whole width and its value form holds the column
//                     ring; a tile splits both axes, so the sweep holds
//                     the W-deep global ring on all four sides and every
//                     cell outside the domain.
//
// What bounds H9, and what its design does about it.  Bytes: one read and
// one write of the batch per sweep (0.16 ms for 4 x 4096^2 at 3.35 TB/s),
// 8/T sweeps per 8 steps.  Operations: 22 (heat9), 14 (advdiff), 12
// (reactdiff) rounded operations a cell update that cannot be contracted
// into FMAs, times the recomputed ring (heat9 at T = 8: 1.36 updates per
// centre cell-step, at T = 4: 1.15).  The first version (tile_steps) ran
// one 122,880-byte block of 8 warps per SM at heat9's T = 8, one cell a
// thread, 9 shared-memory loads and the held rule per update: latency-
// bound at ~1 of the 4 instructions an SM can issue per clock.  The
// strip sweep (csrc/tile.cuh, shared with H12/H13) keeps two blocks per
// SM (the plan's depth, ops/cuda_family.py), so one block's global load
// overlaps the other's steps; gives each thread a strip of 4 independent
// updates with its x neighbours in registers (6 shared-memory loads an
// update for heat9, 3.5 for W = 1); tests the held rule once per block
// for tiles inside the domain; shrinks each step's region to what the
// centre needs; and writes the centre from registers.
//
// Each operator repeats its plain update's operations in the JAX
// package's order, one rounding per operation (__f*_rn: no contraction
// into FMAs, IEEE division), so kernel and plain version agree to the
// last bit where the plain version rounds the same way; the checks allow
// a stated tolerance all the same.
//
// Every entry point returns a cudaError_t (0 on success); the Python
// wrapper raises on anything else.

#include <cuda_runtime.h>

#include "resident.cuh"
#include "tile.cuh"

namespace {

using heat::BLOCK_X;

constexpr int FAM_HEAT9 = 0;
constexpr int FAM_ADVDIFF = 1;
constexpr int FAM_REACTDIFF = 2;

// (-a + 16 b - 30 c + 16 d - e) * (1/12): a 4th-order second difference
// with a = u[+2], b = u[+1], c = u[0], d = u[-1], e = u[-2], in the order
// of problems/kernels._heat9_interior.
__device__ __forceinline__ float d2_4th(float a, float b, float c, float d,
                                        float e) {
  constexpr float twelfth = (float)(1.0 / 12.0);
  float t = __fadd_rn(-a, __fmul_rn(16.0f, b));
  t = __fsub_rn(t, __fmul_rn(30.0f, c));
  t = __fadd_rn(t, __fmul_rn(16.0f, d));
  t = __fsub_rn(t, e);
  return __fmul_rn(t, twelfth);
}

// c + cx*((s + n) - 2c) + cy*((e + w) - 2c): the diffusion part the
// W = 1 families share, in the order of their plain updates.
__device__ __forceinline__ float diffuse(float c, float n, float s, float w,
                                         float e, float cx, float cy) {
  const float two_c = __fmul_rn(2.0f, c);
  const float x = __fmul_rn(cx, __fsub_rn(__fadd_rn(s, n), two_c));
  const float y = __fmul_rn(cy, __fsub_rn(__fadd_rn(e, w), two_c));
  return __fadd_rn(__fadd_rn(c, x), y);
}

struct Heat9 {
  static constexpr int W = 2;
  static constexpr int S = 2;
  struct Params {
    float cx, cy;
  };
  __device__ __forceinline__ static Params load(const float* s) {
    return Params{s[0], s[1]};
  }
  template <class Ld>
  __device__ __forceinline__ static float apply(Ld ld, int row,
                                                const Params& k) {
    const float c = ld(0);
    const float dxx = d2_4th(ld(2 * row), ld(row), c, ld(-row), ld(-2 * row));
    const float dyy = d2_4th(ld(2), ld(1), c, ld(-1), ld(-2));
    return __fadd_rn(__fadd_rn(c, __fmul_rn(k.cx, dxx)),
                     __fmul_rn(k.cy, dyy));
  }
};

struct AdvDiff {
  static constexpr int W = 1;
  static constexpr int S = 4;
  struct Params {
    float cx, cy, vx, vy;
  };
  __device__ __forceinline__ static Params load(const float* s) {
    return Params{s[0], s[1], s[2], s[3]};
  }
  // ... - (0.5 vx) (u[i+1] - u[i-1]) - (0.5 vy) (u[j+1] - u[j-1])
  template <class Ld>
  __device__ __forceinline__ static float apply(Ld ld, int row,
                                                const Params& k) {
    const float c = ld(0), n = ld(-row), s = ld(row), w = ld(-1), e = ld(1);
    float t = diffuse(c, n, s, w, e, k.cx, k.cy);
    t = __fsub_rn(t, __fmul_rn(__fmul_rn(0.5f, k.vx), __fsub_rn(s, n)));
    return __fsub_rn(t, __fmul_rn(__fmul_rn(0.5f, k.vy), __fsub_rn(e, w)));
  }
};

struct ReactDiff {
  static constexpr int W = 1;
  static constexpr int S = 3;
  struct Params {
    float cx, cy, r;
  };
  __device__ __forceinline__ static Params load(const float* s) {
    return Params{s[0], s[1], s[2]};
  }
  // ... + (r c) / (1 + c)
  template <class Ld>
  __device__ __forceinline__ static float apply(Ld ld, int row,
                                                const Params& k) {
    const float c = ld(0);
    const float t = diffuse(c, ld(-row), ld(row), ld(-1), ld(1), k.cx, k.cy);
    return __fadd_rn(t, __fdiv_rn(__fmul_rn(k.r, c), __fadd_rn(1.0f, c)));
  }
};

// ---------------------------------------------------------------- H8 --
// scratch: ops/resident.launch_scratch, zeroed.  src is only read, dst
// only written.  WINDOW picks the step loop (csrc/resident.cuh).
template <class Op, bool WINDOW>
__global__ void __launch_bounds__(BLOCK_X * heat::resident_warps(WINDOW), 1)
    k_fam_resident(const float* __restrict__ src, float* __restrict__ dst,
                   heat::Word* scratch, const float* __restrict__ scal,
                   heat::ResidentPlan P, int steps) {
  extern __shared__ __align__(16) float smem[];
  heat::resident_sweep<Op, WINDOW>(
      src, dst, scratch, P, steps,
      [=](int m) { return Op::load(scal + m * Op::S); }, smem);
}

template <class Op>
cudaError_t launch_fam_resident(const float* src, float* dst,
                                heat::Word* scratch, const float* scal,
                                const int* plan, int steps, int window,
                                cudaStream_t stream) {
  heat::ResidentPlan P = heat::resident_plan(plan);
  void* args[] = {(void*)&src,  (void*)&dst, (void*)&scratch,
                  (void*)&scal, (void*)&P,   (void*)&steps};
  return window ? heat::launch_resident<Op, true>(k_fam_resident<Op, true>,
                                                  args, P, stream)
                : heat::launch_resident<Op, false>(k_fam_resident<Op, false>,
                                                   args, P, stream);
}

// ---------------------------------------------------------------- H9 --
// The strip sweep of csrc/tile.cuh on member blockIdx.z, the whole grid
// its placement; (blockIdx.y, blockIdx.x) = the tile.  A tile whose ext
// lies inside the grid takes the fast path.
constexpr int FAM_BY = heat::STRIP_BY;

template <class Op>
__global__ void __launch_bounds__(32 * FAM_BY, 2)
    k_fam_tile(const float* __restrict__ src, float* __restrict__ dst,
               const float* __restrict__ scal, int nx, int ny, int H,
               int nsub, int TY, int TX) {
  extern __shared__ __align__(16) float smem[];
  const int m = blockIdx.z;
  const size_t off = (size_t)m * nx * ny;
  const typename Op::Params k = Op::load(scal + m * Op::S);
  const heat::GridLoad ld{src + off, nx, ny};
  const heat::Placement pl{0, 0, nx, ny};
  if (heat::ext_inside(pl, H, TY, TX, pl))
    heat::strip_sweep_at<Op, FAM_BY, false, false>(ld, dst + off, pl, nx, ny,
                                                   k, H, nsub, TY, TX, smem);
  else
    heat::strip_sweep_at<Op, FAM_BY, true, false>(ld, dst + off, pl, nx, ny,
                                                  k, H, nsub, TY, TX, smem);
}

template <class Op>
cudaError_t launch_tile(const float* src, float* dst, const float* scal,
                        int nb, int nx, int ny, int H, int nsub, int TY,
                        int TX, cudaStream_t stream) {
  const size_t smem = heat::tile_smem_bytes(H, TY, TX);
  cudaError_t e = cudaFuncSetAttribute(
      k_fam_tile<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 block(32, FAM_BY);
  const dim3 grid((ny + TX - 1) / TX, (nx + TY - 1) / TY, nb);
  k_fam_tile<Op><<<grid, block, smem, stream>>>(src, dst, scal, nx, ny, H,
                                                 nsub, TY, TX);
  return cudaGetLastError();
}

// out: registers a thread, local bytes a thread (spills), blocks an SM at
// `smem` bytes of dynamic shared memory, max threads a block.
template <class Op>
cudaError_t tile_info(int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, k_fam_tile<Op>);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(k_fam_tile<Op>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k_fam_tile<Op>, 32 * FAM_BY, (size_t)smem);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  out[3] = a.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* heat_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// plan: the host int array of ops/resident.ResidentPlan.as_ctypes;
// window != 0 steps by window_steps, 0 by tile_steps.
int heat_fam_resident(int fam, const float* src, float* dst,
                      heat::Word* scratch, const float* scal,
                      const int* plan, int steps, int window, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (fam) {
    case FAM_HEAT9:
      return launch_fam_resident<Heat9>(src, dst, scratch, scal, plan, steps,
                                        window, s);
    case FAM_ADVDIFF:
      return launch_fam_resident<AdvDiff>(src, dst, scratch, scal, plan,
                                          steps, window, s);
    case FAM_REACTDIFF:
      return launch_fam_resident<ReactDiff>(src, dst, scratch, scal, plan,
                                            steps, window, s);
  }
  return cudaErrorInvalidValue;
}

// nsub steps of family `fam` in one sweep of tiles with an H >= W*nsub
// deep ring, blocks of 32 x FAM_BY threads.
int heat_fam_tile(int fam, const float* src, float* dst, const float* scal,
                  int nb, int nx, int ny, int H, int nsub, int TY, int TX,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (fam) {
    case FAM_HEAT9:
      return launch_tile<Heat9>(src, dst, scal, nb, nx, ny, H, nsub, TY, TX,
                                s);
    case FAM_ADVDIFF:
      return launch_tile<AdvDiff>(src, dst, scal, nb, nx, ny, H, nsub, TY,
                                  TX, s);
    case FAM_REACTDIFF:
      return launch_tile<ReactDiff>(src, dst, scal, nb, nx, ny, H, nsub, TY,
                                    TX, s);
  }
  return cudaErrorInvalidValue;
}

// H9's build and occupancy at `smem` bytes a block: out[0..3] = registers
// a thread, local (spill) bytes a thread, blocks an SM, threads a block.
int heat_fam_tile_info(int fam, int smem, int* out) {
  switch (fam) {
    case FAM_HEAT9: return tile_info<Heat9>(smem, out);
    case FAM_ADVDIFF: return tile_info<AdvDiff>(smem, out);
    case FAM_REACTDIFF: return tile_info<ReactDiff>(smem, out);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
