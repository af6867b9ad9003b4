// Hand-written Hopper (sm_90a) kernels for batched ensembles: B members
// of one nx x ny shape, stored as one contiguous (B, nx, ny) f32 batch,
// each member with its own (cx, cy) read from device arrays.
//
// Three kernels, the port of the Pallas kernels in
// heat2d_tpu/models/ensemble.py; the Python wrappers, their plain PyTorch
// versions and the launch counters live in
// heat2d_tpu_torch/ops/cuda_ensemble.py.
//
//   H5 k_ens_resident <- _ensemble_kernel (B5) via _run_batch_pallas:
//                     every member advances `steps` steps in one
//                     cooperative launch, as B5 keeps a member in VMEM
//                     for all steps.  The on-chip resident sweep of
//                     csrc/resident.cuh with the heat5 FMA operator: a
//                     (member, tile) pair per SM, the tile's two ext
//                     planes in shared memory from the first step to the
//                     last, one ring exchange with its neighbours per K
//                     steps.  Its step loop (window_steps: 4 columns a
//                     thread, their neighbourhood in registers) moves 10
//                     bytes of shared memory per cell-step and is bound
//                     by instruction rate (tile_steps, 24 bytes, is built
//                     beside it and timed by chip_smoke.py); device memory
//                     is read and written once.  The wrapper sends members too large
//                     to stay on the chip to H6 sweeps.
//   H6 k_ens_tile     <- _ensemble_band_kernel (B6) and _ens_window_kernel
//                     (B7): H2's strip sweep (csrc/tile.cuh; a strip of
//                     8 cells a thread with its x neighbours in
//                     registers, 16 warps, two blocks an SM) with
//                     blockIdx.z = member and a member's slice as the
//                     loader; a tile whose ext lies inside the member is
//                     copied in by cp.async and skips the held rule (one
//                     uniform test per block, H2's).  The window relay
//                     and the band strips were VMEM workarounds and have
//                     no counterpart.  Device memory moves once each way
//                     per sweep; the step loop's instructions bound it.
//   H7 k_ens_tile + active <- _ens_conv_kernel (B8): H6 gated by a
//                     per-member int32 `active` flag -- a frozen member's
//                     blocks copy their centre through unchanged (the
//                     output is a second buffer) -- and, with RESID, one
//                     f32 partial per (member, tile) of the last step
//                     pair's squared deltas (H3's: the previous step's
//                     value is the strip's register); a frozen member's
//                     are 0.
//
// The step is the FMA form only (bitwise parity is not an ensemble
// option).  k0 = (1 - 2cx) - 2cy is computed in f32 on the device from the
// f32 scalars, as the TPU kernels compute it from their SMEM operands.
// The 32-bit index range covers the whole batch (B * nx * ny < 2^31);
// blockIdx.z limits the tile kernels to 65535 members.
//
// Every entry point returns a cudaError_t (0 on success); the Python
// wrapper raises on anything else.

#include <cuda_runtime.h>

#include "resident.cuh"
#include "tile.cuh"

namespace {

using heat::BLOCK_X;
using heat::Coef;
using heat::FORM_FMA;
using heat::Placement;

__device__ __forceinline__ Coef member_coef(const float* cxs,
                                            const float* cys, int m) {
  const float cx = cxs[m], cy = cys[m];
  return Coef{cx, cy,
              __fsub_rn(__fsub_rn(1.0f, __fmul_rn(2.0f, cx)),
                        __fmul_rn(2.0f, cy))};
}

// ---------------------------------------------------------------- H5 --
// scratch: ops/resident.launch_scratch, zeroed.  src is only read, dst
// only written.  WINDOW picks the step loop (csrc/resident.cuh).
template <bool WINDOW>
__global__ void __launch_bounds__(BLOCK_X * heat::resident_warps(WINDOW), 1)
    k_ens_resident(const float* __restrict__ src, float* __restrict__ dst,
                   heat::Word* scratch, const float* __restrict__ cxs,
                   const float* __restrict__ cys, heat::ResidentPlan P,
                   int steps) {
  extern __shared__ __align__(16) float smem[];
  heat::resident_sweep<heat::Heat5<FORM_FMA>, WINDOW>(
      src, dst, scratch, P, steps,
      [=](int m) { return member_coef(cxs, cys, m); }, smem);
}

// ------------------------------------------------------------ H6 / H7 --
constexpr int ENS_BY = heat::STRIP_BY;
// Cells a strip: 8, H2's heat5 build (on the H100 17% faster than 4 for
// H6 and H7).
constexpr int ENS_STRIP = 8;

// Tile (blockIdx.y, blockIdx.x) of member blockIdx.z.  active == NULL is
// H6 (every member steps); otherwise H7.  parts: (B, tiles) row-major.
// `paths` (NULL, or two words the caller zeroed): thread (0, 0) adds its
// tile to the word of the path the member's sweep takes there, fast or
// edge (ops/cuda_ensemble.py), a frozen member's tiles too.
template <bool RESID>
__global__ void __launch_bounds__(32 * ENS_BY, 2)
    k_ens_tile(const float* __restrict__ src, float* __restrict__ dst,
               float* __restrict__ parts, unsigned* paths,
               const float* __restrict__ cxs, const float* __restrict__ cys,
               const int* __restrict__ active, int nx, int ny, int T,
               int nsub, int TY, int TX) {
  extern __shared__ float smem[];
  using Op = heat::Heat5<FORM_FMA>;
  const int m = blockIdx.z;
  const size_t off = (size_t)m * nx * ny;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int tiles = gridDim.x * gridDim.y;
  const Placement pl{0, 0, nx, ny};
  const bool fast = heat::ext_inside(pl, T, TY, TX, pl);
  const bool first = threadIdx.x == 0 && threadIdx.y == 0;
  if (paths != nullptr && first) atomicAdd(paths + (fast ? 0 : 1), 1u);
  if (active != nullptr && active[m] == 0) {
    // Frozen: the centre passes through unchanged (all threads of the
    // block take this branch, so no barrier is skipped by half of it).
    const int i0 = blockIdx.y * TY, j0 = blockIdx.x * TX;
    for (int r = threadIdx.y; r < TY && i0 + r < nx; r += ENS_BY)
      for (int c = threadIdx.x; c < TX && j0 + c < ny; c += 32) {
        const size_t p = off + (size_t)(i0 + r) * ny + (j0 + c);
        dst[p] = src[p];
      }
    if (RESID && first) parts[(size_t)m * tiles + tile] = 0.0f;
    return;
  }
  const heat::GridLoad ld{src + off, nx, ny};
  const Coef k = member_coef(cxs, cys, m);
  const float acc =
      fast ? heat::strip_sweep_at<Op, ENS_BY, false, RESID, ENS_STRIP>(
                 ld, dst + off, pl, nx, ny, k, T, nsub, TY, TX, smem)
           : heat::strip_sweep_at<Op, ENS_BY, true, RESID, ENS_STRIP>(
                 ld, dst + off, pl, nx, ny, k, T, nsub, TY, TX, smem);
  if (RESID && first) parts[(size_t)m * tiles + tile] = acc;
}

template <bool RESID>
cudaError_t launch_ens_tile(const float* src, float* dst, float* parts,
                            unsigned* paths, const float* cxs,
                            const float* cys, const int* active, int nb,
                            int nx, int ny, int T, int nsub, int TY, int TX,
                            cudaStream_t stream) {
  const size_t smem = heat::tile_smem_bytes(T, TY, TX);
  cudaError_t e = cudaFuncSetAttribute(
      k_ens_tile<RESID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((ny + TX - 1) / TX, (nx + TY - 1) / TY, nb);
  k_ens_tile<RESID><<<grid, dim3(32, ENS_BY), smem, stream>>>(
      src, dst, parts, paths, cxs, cys, active, nx, ny, T, nsub, TY, TX);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* heat_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// plan: the host int array of ops/resident.ResidentPlan.as_ctypes;
// window != 0 steps by window_steps, 0 by tile_steps.
int heat_ens_resident(const float* src, float* dst, heat::Word* scratch,
                      const float* cxs, const float* cys, const int* plan,
                      int steps, int window, void* stream) {
  using Op = heat::Heat5<FORM_FMA>;
  heat::ResidentPlan P = heat::resident_plan(plan);
  void* args[] = {(void*)&src, (void*)&dst, (void*)&scratch, (void*)&cxs,
                  (void*)&cys, (void*)&P,   (void*)&steps};
  cudaStream_t s = (cudaStream_t)stream;
  return window ? heat::launch_resident<Op, true>(k_ens_resident<true>, args,
                                                  P, s)
                : heat::launch_resident<Op, false>(k_ens_resident<false>,
                                                   args, P, s);
}

// Registers and local (spill) bytes a thread of one build, as
// cudaFuncGetAttributes reports them: which = 0 H5 (window_steps, the
// wrapper's), 1 H6, 2 H7 (the cost cards of obs/perf.py).
int heat_ens_func_attrs(int which, int* out) {
  const void* fns[] = {(const void*)k_ens_resident<true>,
                       (const void*)k_ens_tile<false>,
                       (const void*)k_ens_tile<true>};
  if (which < 0 || which > 2) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fns[which]);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return cudaSuccess;
}

// active == NULL selects H6, otherwise H7; parts == NULL skips the
// residual partials (one per (member, tile) otherwise).  `paths`: NULL,
// or k_ens_tile's two path counts.
int heat_ens_tile(const float* src, float* dst, float* parts,
                  unsigned* paths, const float* cxs, const float* cys,
                  const int* active, int nb, int nx, int ny, int T, int nsub,
                  int TY, int TX, void* stream) {
  auto launch =
      parts == nullptr ? launch_ens_tile<false> : launch_ens_tile<true>;
  return launch(src, dst, parts, paths, cxs, cys, active, nb, nx, ny, T,
                nsub, TY, TX, (cudaStream_t)stream);
}

}  // extern "C"
