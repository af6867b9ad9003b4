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
//                     cooperative launch, grid.sync() between steps, two
//                     ping-pong batch buffers of its own.  H4 with a
//                     member axis: the grid strides over the whole batch.
//                     Bound by the per-step grid barrier and L2 traffic
//                     while the batch fits the 50 MB L2, by device-memory
//                     bytes per step once it does not.
//   H6 k_ens_tile     <- _ensemble_band_kernel (B6) and _ens_window_kernel
//                     (B7): the shared-memory tile sweep of H2
//                     (csrc/tile.cuh) with blockIdx.z = member.  The
//                     window relay and the band strips were VMEM
//                     workarounds and have no counterpart.  Bound as H2:
//                     one read and one write of the batch per sweep.
//   H7 k_ens_tile + active <- _ens_conv_kernel (B8): H6 gated by a
//                     per-member int32 `active` flag -- a frozen member's
//                     blocks copy their centre through unchanged (the
//                     output is a second buffer) -- and, with RESID, one
//                     f32 partial per (member, tile) of the last step
//                     pair's squared deltas; a frozen member's are 0.
//
// The step is the FMA form only (bitwise parity is not an ensemble
// option).  k0 = (1 - 2cx) - 2cy is computed in f32 on the device from the
// f32 scalars, as the TPU kernels compute it from their SMEM operands.
// The 32-bit index range covers the whole batch (B * nx * ny < 2^31);
// blockIdx.z limits the tile kernels to 65535 members.
//
// Every entry point returns a cudaError_t (0 on success); the Python
// wrapper raises on anything else.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace cg = cooperative_groups;

namespace {

using heat::BLOCK_X;
using heat::BLOCK_Y;
using heat::Coef;
using heat::FORM_FMA;

constexpr int RESIDENT_THREADS = 256;

__device__ __forceinline__ Coef member_coef(const float* cxs,
                                            const float* cys, int m) {
  const float cx = cxs[m], cy = cys[m];
  return Coef{cx, cy,
              __fsub_rn(__fsub_rn(1.0f, __fmul_rn(2.0f, cx)),
                        __fmul_rn(2.0f, cy))};
}

// ---------------------------------------------------------------- H5 --
// Step s reads `cur` and writes `nxt`; src is read only by step 0, so the
// caller's batch is never written.  Steps alternate p0, p1, p0, ...: the
// result is in p0 when steps is odd, in p1 when it is even.  Loads go
// through __ldcg (L2, not the SM's own L1) because other blocks wrote
// them during the previous step.
__global__ void k_ens_resident(const float* src, float* p0, float* p1,
                               const float* __restrict__ cxs,
                               const float* __restrict__ cys, int nb, int nx,
                               int ny, int steps) {
  cg::grid_group grid = cg::this_grid();
  // Unsigned 32-bit: n < 2^31, so p + stride cannot wrap.
  const unsigned plane = (unsigned)nx * ny;
  const unsigned n = nb * plane;
  const unsigned stride = gridDim.x * blockDim.x;
  const float* cur = src;
  float* nxt = p0;
  for (int s = 0; s < steps; ++s) {
    for (unsigned p = blockIdx.x * blockDim.x + threadIdx.x; p < n;
         p += stride) {
      const unsigned m = p / plane;
      const unsigned q = p - m * plane;
      const int i = (int)(q / ny);
      const int j = (int)(q - i * ny);
      float v = __ldcg(cur + p);
      if (i > 0 && i < nx - 1 && j > 0 && j < ny - 1)
        v = heat::update<FORM_FMA>(v, __ldcg(cur + p - ny),
                                   __ldcg(cur + p + ny), __ldcg(cur + p - 1),
                                   __ldcg(cur + p + 1),
                                   member_coef(cxs, cys, m));
      nxt[p] = v;
    }
    grid.sync();
    cur = nxt;
    nxt = (nxt == p0) ? p1 : p0;
  }
}

// ------------------------------------------------------------ H6 / H7 --
// Tile (blockIdx.y, blockIdx.x) of member blockIdx.z.  active == NULL is
// H6 (every member steps); otherwise H7.  parts: (B, tiles) row-major.
template <bool RESID>
__global__ void k_ens_tile(const float* __restrict__ src,
                           float* __restrict__ dst, float* __restrict__ parts,
                           const float* __restrict__ cxs,
                           const float* __restrict__ cys,
                           const int* __restrict__ active, int nx, int ny,
                           int T, int nsub, int TY, int TX) {
  extern __shared__ float smem[];
  const int m = blockIdx.z;
  const size_t off = (size_t)m * nx * ny;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int tiles = gridDim.x * gridDim.y;
  if (active != nullptr && active[m] == 0) {
    // Frozen: the centre passes through unchanged (all threads of the
    // block take this branch, so no barrier is skipped by half of it).
    const int i0 = blockIdx.y * TY, j0 = blockIdx.x * TX;
    for (int r = threadIdx.y; r < TY && i0 + r < nx; r += BLOCK_Y)
      for (int c = threadIdx.x; c < TX && j0 + c < ny; c += BLOCK_X) {
        const size_t p = off + (size_t)(i0 + r) * ny + (j0 + c);
        dst[p] = src[p];
      }
    if (RESID && threadIdx.x == 0 && threadIdx.y == 0)
      parts[(size_t)m * tiles + tile] = 0.0f;
    return;
  }
  const float acc = heat::tile_sweep<heat::Heat5<FORM_FMA>, RESID>(
      src + off, dst + off, nx, ny, member_coef(cxs, cys, m), T, nsub, TY,
      TX, smem);
  if (RESID && threadIdx.x == 0 && threadIdx.y == 0)
    parts[(size_t)m * tiles + tile] = acc;
}

template <bool RESID>
cudaError_t launch_ens_tile(const float* src, float* dst, float* parts,
                            const float* cxs, const float* cys,
                            const int* active, int nb, int nx, int ny, int T,
                            int nsub, int TY, int TX, cudaStream_t stream) {
  const size_t smem = heat::tile_smem_bytes(T, TY, TX);
  cudaError_t e = cudaFuncSetAttribute(
      k_ens_tile<RESID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((ny + TX - 1) / TX, (nx + TY - 1) / TY, nb);
  k_ens_tile<RESID><<<grid, block, smem, stream>>>(
      src, dst, parts, cxs, cys, active, nx, ny, T, nsub, TY, TX);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* heat_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Co-resident H5 blocks on the whole card (the cooperative grid limit).
int heat_ens_resident_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k_ens_resident, RESIDENT_THREADS, 0);
  if (e != cudaSuccess) return e;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

int heat_ens_resident(const float* src, float* p0, float* p1,
                      const float* cxs, const float* cys, int nb, int nx,
                      int ny, int steps, int blocks, void* stream) {
  void* args[] = {(void*)&src, (void*)&p0, (void*)&p1, (void*)&cxs,
                  (void*)&cys, (void*)&nb, (void*)&nx, (void*)&ny,
                  (void*)&steps};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)k_ens_resident, dim3(blocks), dim3(RESIDENT_THREADS), args,
      0, (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// active == NULL selects H6, otherwise H7; parts == NULL skips the
// residual partials (one per (member, tile) otherwise).
int heat_ens_tile(const float* src, float* dst, float* parts,
                  const float* cxs, const float* cys, const int* active,
                  int nb, int nx, int ny, int T, int nsub, int TY, int TX,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (parts == nullptr)
    return launch_ens_tile<false>(src, dst, parts, cxs, cys, active, nb, nx,
                                  ny, T, nsub, TY, TX, s);
  return launch_ens_tile<true>(src, dst, parts, cxs, cys, active, nb, nx, ny,
                               T, nsub, TY, TX, s);
}

}  // extern "C"
