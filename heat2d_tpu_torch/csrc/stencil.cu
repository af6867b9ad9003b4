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
//                     memory.  A (TY+2T) x (TX+2T) tile (its centre plus
//                     a T-deep halo ring) is stepped in shared memory and
//                     only the TY x TX centre is written, to a second
//                     buffer.  Cuts bytes per step by ~T; the bound moves
//                     towards shared-memory traffic and FLOPs.
//   H3 k_tile<RESID> <- _band_window_resid_kernel (C2R/C3R): H2 plus each
//                     tile's sum of squared deltas over the last step pair
//                     of its centre, one float per tile.
//   H4 k_resident  <- _vmem_kernel (A) via multi_step_vmem: all steps in
//                     one cooperative launch; grid.sync() between steps,
//                     two ping-pong buffers small enough for the 50 MB L2.
//                     Bound by the per-step grid barrier and L2 latency on
//                     small grids, by FLOPs in the limit.
//
// Semantics shared by all four: compute in f32; global rows 0 / nx-1 and
// columns 0 / ny-1 are held, and so is every cell outside the domain.
// Two step forms, FORM_FMA and FORM_LITERAL (csrc/tile.cuh, which also
// holds the tile sweep H2/H3 share with the ensemble kernels).
// No kernel writes the buffer it reads: GPU blocks run in no order.
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
using heat::FORM_LITERAL;
using heat::update;

constexpr int RESIDENT_THREADS = 256;

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
template <int FORM, bool RESID>
__global__ void k_tile(const float* __restrict__ src, float* __restrict__ dst,
                       float* __restrict__ parts, int nx, int ny, Coef k,
                       int T, int nsub, int TY, int TX) {
  extern __shared__ float smem[];
  const float acc = heat::tile_sweep<heat::Heat5<FORM>, RESID>(
      src, dst, nx, ny, k, T, nsub, TY, TX, smem);
  if (RESID && threadIdx.x == 0 && threadIdx.y == 0)
    parts[blockIdx.y * gridDim.x + blockIdx.x] = acc;
}

// ---------------------------------------------------------------- H4 --
// Step s reads `cur` and writes `nxt`; src is read only by step 0, so the
// caller's grid is never written.  Steps alternate p0, p1, p0, ...: the
// result is in p0 when steps is odd, in p1 when it is even.  Loads go
// through __ldcg (L2, not the SM's own L1) because other blocks wrote
// them during the previous step.
template <int FORM>
__global__ void k_resident(const float* src, float* p0, float* p1, int nx,
                           int ny, Coef k, int steps) {
  cg::grid_group grid = cg::this_grid();
  const size_t n = (size_t)nx * ny;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const float* cur = src;
  float* nxt = p0;
  for (int s = 0; s < steps; ++s) {
    for (size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
         p += stride) {
      const int i = (int)(p / ny);
      const int j = (int)(p - (size_t)i * ny);
      float v = __ldcg(cur + p);
      if (i > 0 && i < nx - 1 && j > 0 && j < ny - 1)
        v = update<FORM>(v, __ldcg(cur + p - ny), __ldcg(cur + p + ny),
                         __ldcg(cur + p - 1), __ldcg(cur + p + 1), k);
      nxt[p] = v;
    }
    grid.sync();
    cur = nxt;
    nxt = (nxt == p0) ? p1 : p0;
  }
}

template <int FORM, bool RESID>
cudaError_t launch_tile(const float* src, float* dst, float* parts, int nx,
                        int ny, Coef k, int T, int nsub, int TY, int TX,
                        cudaStream_t stream) {
  const size_t smem = heat::tile_smem_bytes(T, TY, TX);
  cudaError_t e = cudaFuncSetAttribute(
      k_tile<FORM, RESID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((ny + TX - 1) / TX, (nx + TY - 1) / TY);
  k_tile<FORM, RESID><<<grid, block, smem, stream>>>(src, dst, parts, nx, ny,
                                                      k, T, nsub, TY, TX);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* heat_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// caps[0] L2 bytes, caps[1] opt-in shared memory per block, caps[2] SM
// count, caps[3] cooperative launch supported, caps[4] co-resident H4
// blocks on the whole card (the cooperative grid limit).
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
  int per_sm_fma = 0, per_sm_lit = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm_fma, k_resident<FORM_FMA>, RESIDENT_THREADS, 0);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm_lit, k_resident<FORM_LITERAL>, RESIDENT_THREADS, 0);
  if (e != cudaSuccess) return e;
  const int per_sm = per_sm_fma < per_sm_lit ? per_sm_fma : per_sm_lit;
  caps[4] = per_sm * caps[2];
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
// row-major order of the (ceil(nx/TY), ceil(ny/TX)) tile grid).
int heat_tile_multi(const float* src, float* dst, float* parts, int nx,
                    int ny, float cx, float cy, float k0, int form, int T,
                    int nsub, int TY, int TX, void* stream) {
  const Coef k{cx, cy, k0};
  cudaStream_t s = (cudaStream_t)stream;
  if (parts == nullptr) {
    return form == FORM_LITERAL
               ? launch_tile<FORM_LITERAL, false>(src, dst, parts, nx, ny, k,
                                                  T, nsub, TY, TX, s)
               : launch_tile<FORM_FMA, false>(src, dst, parts, nx, ny, k, T,
                                              nsub, TY, TX, s);
  }
  return form == FORM_LITERAL
             ? launch_tile<FORM_LITERAL, true>(src, dst, parts, nx, ny, k, T,
                                               nsub, TY, TX, s)
             : launch_tile<FORM_FMA, true>(src, dst, parts, nx, ny, k, T,
                                           nsub, TY, TX, s);
}

int heat_resident(const float* src, float* p0, float* p1, int nx, int ny,
                  float cx, float cy, float k0, int form, int steps,
                  int blocks, void* stream) {
  Coef k{cx, cy, k0};
  void* args[] = {(void*)&src, (void*)&p0, (void*)&p1, (void*)&nx,
                  (void*)&ny,  (void*)&k,  (void*)&steps};
  const void* fn = form == FORM_LITERAL ? (const void*)k_resident<FORM_LITERAL>
                                        : (const void*)k_resident<FORM_FMA>;
  cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(blocks), dim3(RESIDENT_THREADS), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
