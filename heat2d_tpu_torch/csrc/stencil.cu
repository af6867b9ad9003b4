// Hand-written Hopper (sm_90a) kernels for the single-device heat5 solve.
//
// Four kernels, each the port of Pallas kernels in
// heat2d_tpu/ops/pallas_stencil.py; the Python wrappers, their plain
// PyTorch versions and the launch counters live in
// heat2d_tpu_torch/ops/cuda_stencil.py.
//
//   H1 k_step      <- _band_kernel (B) via band_step: one clamped step,
//                     src -> dst.  Bound on the H100 by device-memory
//                     bytes (one read + one write of the grid per step);
//                     one thread per cell, coalesced along rows.
//   H2 k_tile      <- _band_multi_kernel (C) and _band_window_kernel
//                     (C2/C3): nsub <= T steps per round trip to device
//                     memory.  The strip sweep of csrc/tile.cuh (H9's and
//                     H12's): a (TY+2T) x (TX+2T) tile (its centre plus a
//                     T-deep halo ring) is stepped in shared memory by 16
//                     warps, two blocks an SM, each thread a strip of 8
//                     cells of one column with its x neighbours in
//                     registers; a tile whose ring lies inside the grid is
//                     copied in by cp.async and skips the held rule.  Only
//                     the TY x TX centre is written, to a second buffer.
//                     Device memory moves once per sweep; the step loop's
//                     instructions bound it.
//   H3 k_tile<RESID> <- _band_window_resid_kernel (C2R/C3R): H2 plus each
//                     tile's sum of squared deltas over the last step pair
//                     of its centre, one float per tile (the previous
//                     step's value is the strip's register).
//   H4 k_resident  <- _vmem_kernel (A) via multi_step_vmem: all steps in
//                     one cooperative launch, the grid held in shared
//                     memory from the first step to the last, as A holds
//                     it in VMEM: the on-chip resident sweep of
//                     csrc/resident.cuh (H5's and H8's) on a one-member
//                     batch, with the host's scalars (k0 computed in
//                     double).  A block per SM steps its tile K steps,
//                     then trades rings with its neighbours through
//                     stamped words in the L2; no barrier spans the grid.
//
// Semantics shared by all four: compute in f32; global rows 0 / nx-1 and
// columns 0 / ny-1 are held, and so is every cell outside the domain.
// Two step forms, FORM_FMA and FORM_LITERAL (csrc/tile.cuh).  Each cell
// takes the rounded sequence of update<FORM> in every kernel, so H2, H3
// and H4 agree bit for bit with each other, and in the literal form with
// the plain step.  No kernel writes the buffer it reads: GPU blocks run
// in no order.
//
// Every entry point returns a cudaError_t (0 on success); the Python
// wrapper raises on anything else.

#include <cuda_runtime.h>

#include "resident.cuh"
#include "tile.cuh"

namespace {

using heat::BLOCK_X;
using heat::BLOCK_Y;
using heat::Coef;
using heat::FORM_FMA;
using heat::FORM_LITERAL;
using heat::Placement;
using heat::update;

// ---------------------------------------------------------------- H1 --
template <int FORM>
__global__ void k_step(const float* __restrict__ src, float* __restrict__ dst,
                       int nx, int ny, Coef k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const size_t p = (size_t)i * ny + j;
  float v = src[p];
  if (i > 0 && i < nx - 1 && j > 0 && j < ny - 1)
    v = update<FORM>(v, src[p - ny], src[p + ny], src[p - 1], src[p + 1], k);
  dst[p] = v;
}

// ------------------------------------------------------------ H2 / H3 --
constexpr int TILE_BY = heat::STRIP_BY;
// Cells a strip: 8, the heat5 build of the strip sweep (the other strip
// sweeps take heat::STRIP = 4); a strip's column loads serve 8 updates.
constexpr int TILE_STRIP = 8;

// Tile (blockIdx.y, blockIdx.x) of the grid.  `paths` (NULL, or two words
// the caller zeroed): thread (0, 0) adds its tile to the word of the path
// it takes, fast or edge (ops/cuda_stencil.py TILE_PATHS).  With RESID,
// each block writes its tile's partial sum.
template <int FORM, bool RESID>
__global__ void __launch_bounds__(32 * TILE_BY, 2)
    k_tile(const float* __restrict__ src, float* __restrict__ dst,
           float* __restrict__ parts, unsigned* paths, int nx, int ny,
           Coef k, int T, int nsub, int TY, int TX) {
  extern __shared__ float smem[];
  using Op = heat::Heat5<FORM>;
  const heat::GridLoad ld{src, nx, ny};
  const Placement pl{0, 0, nx, ny};
  const bool fast = heat::ext_inside(pl, T, TY, TX, pl);
  const bool first = threadIdx.x == 0 && threadIdx.y == 0;
  if (paths != nullptr && first) atomicAdd(paths + (fast ? 0 : 1), 1u);
  const float acc =
      fast ? heat::strip_sweep_at<Op, TILE_BY, false, RESID, TILE_STRIP>(
                 ld, dst, pl, nx, ny, k, T, nsub, TY, TX, smem)
           : heat::strip_sweep_at<Op, TILE_BY, true, RESID, TILE_STRIP>(
                 ld, dst, pl, nx, ny, k, T, nsub, TY, TX, smem);
  if (RESID && first) parts[blockIdx.y * gridDim.x + blockIdx.x] = acc;
}

template <int FORM, bool RESID>
cudaError_t launch_tile(const float* src, float* dst, float* parts,
                        unsigned* paths, int nx, int ny, Coef k, int T,
                        int nsub, int TY, int TX, cudaStream_t stream) {
  const size_t smem = heat::tile_smem_bytes(T, TY, TX);
  cudaError_t e = cudaFuncSetAttribute(
      k_tile<FORM, RESID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((ny + TX - 1) / TX, (nx + TY - 1) / TY);
  k_tile<FORM, RESID><<<grid, dim3(32, TILE_BY), smem, stream>>>(
      src, dst, parts, paths, nx, ny, k, T, nsub, TY, TX);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- H4 --
// scratch: ops/resident.launch_scratch, zeroed.  src is only read, dst
// only written.  Stepped by window_steps (csrc/resident.cuh), on the H100
// ~30% faster than tile_steps for heat5 in both forms; every member's
// scalars are the host's `k`.
template <int FORM>
__global__ void __launch_bounds__(BLOCK_X * heat::resident_warps(true), 1)
    k_resident(const float* __restrict__ src, float* __restrict__ dst,
               heat::Word* scratch, heat::ResidentPlan P, int steps,
               Coef k) {
  extern __shared__ __align__(16) float smem[];
  heat::resident_sweep<heat::Heat5<FORM>, true>(
      src, dst, scratch, P, steps, [=](int) { return k; }, smem);
}

template <int FORM>
cudaError_t launch_h4(const float* src, float* dst, heat::Word* scratch,
                      const int* plan, int steps, Coef k,
                      cudaStream_t stream) {
  heat::ResidentPlan P = heat::resident_plan(plan);
  void* args[] = {(void*)&src, (void*)&dst,   (void*)&scratch,
                  (void*)&P,   (void*)&steps, (void*)&k};
  return heat::launch_resident<heat::Heat5<FORM>, true>(k_resident<FORM>,
                                                        args, P, stream);
}

}  // namespace

extern "C" {

const char* heat_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// caps[0] L2 bytes, caps[1] opt-in shared memory per block, caps[2] SM
// count, caps[3] cooperative launch supported.
int heat_device_caps(int* caps) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrL2CacheSize, cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMultiProcessorCount, cudaDevAttrCooperativeLaunch};
  for (int a = 0; a < 4; ++a) {
    e = cudaDeviceGetAttribute(&caps[a], attrs[a], dev);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

int heat_step(const float* src, float* dst, int nx, int ny, float cx,
              float cy, float k0, int form, void* stream) {
  const Coef k{cx, cy, k0};
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((ny + BLOCK_X - 1) / BLOCK_X, (nx + BLOCK_Y - 1) / BLOCK_Y);
  cudaStream_t s = (cudaStream_t)stream;
  if (form == FORM_LITERAL)
    k_step<FORM_LITERAL><<<grid, block, 0, s>>>(src, dst, nx, ny, k);
  else
    k_step<FORM_FMA><<<grid, block, 0, s>>>(src, dst, nx, ny, k);
  return cudaGetLastError();
}

// parts == NULL selects H2, otherwise H3 (one partial per tile, tiles in
// row-major order of the (ceil(nx/TY), ceil(ny/TX)) tile grid).  `paths`:
// NULL, or k_tile's two path counts.
int heat_tile_multi(const float* src, float* dst, float* parts,
                    unsigned* paths, int nx, int ny, float cx, float cy,
                    float k0, int form, int T, int nsub, int TY, int TX,
                    void* stream) {
  const Coef k{cx, cy, k0};
  cudaStream_t s = (cudaStream_t)stream;
  auto launch = parts == nullptr
                    ? (form == FORM_LITERAL ? launch_tile<FORM_LITERAL, false>
                                            : launch_tile<FORM_FMA, false>)
                    : (form == FORM_LITERAL ? launch_tile<FORM_LITERAL, true>
                                            : launch_tile<FORM_FMA, true>);
  return launch(src, dst, parts, paths, nx, ny, k, T, nsub, TY, TX, s);
}

// H2's FMA build at `smem` bytes a block: out[0..2] = registers a thread,
// local (spill) bytes a thread, blocks an SM.
int heat_tile_info(int smem, int* out) {
  const void* fn = (const void*)k_tile<FORM_FMA, false>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 32 * TILE_BY,
                                                    (size_t)smem);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return cudaSuccess;
}

// Registers and local (spill) bytes a thread of one build, as
// cudaFuncGetAttributes reports them: which = 0 H1, 1 H2, 2 H3, 3 H4, each
// in the FMA form (the cost cards of obs/perf.py).
int heat_func_attrs(int which, int* out) {
  const void* fns[] = {(const void*)k_step<FORM_FMA>,
                       (const void*)k_tile<FORM_FMA, false>,
                       (const void*)k_tile<FORM_FMA, true>,
                       (const void*)k_resident<FORM_FMA>};
  if (which < 0 || which > 3) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fns[which]);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return cudaSuccess;
}

// plan: the host int array of ops/resident.ResidentPlan.as_ctypes (one
// member).
int heat_resident(const float* src, float* dst, heat::Word* scratch,
                  const int* plan, float cx, float cy, float k0, int form,
                  int steps, void* stream) {
  const Coef k{cx, cy, k0};
  cudaStream_t s = (cudaStream_t)stream;
  return form == FORM_LITERAL
             ? launch_h4<FORM_LITERAL>(src, dst, scratch, plan, steps, k, s)
             : launch_h4<FORM_FMA>(src, dst, scratch, plan, steps, k, s);
}

}  // extern "C"
