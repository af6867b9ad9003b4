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
//                     cooperative launch, grid.sync() between steps, two
//                     ping-pong batch buffers of its own (H5 with a family
//                     operator).  Bound by the per-step grid barrier and
//                     L2 traffic while the batch fits the L2.
//   H9 k_fam_tile     <- _family_band_kernel (B10, runners.py:181): the
//                     shared-memory tile sweep of csrc/tile.cuh with a
//                     ring of depth H = W * T, blockIdx.z = member.  The
//                     TPU kernel holds only global rows, because its band
//                     spans the whole width and its value form holds the
//                     column ring; a tile splits both axes, so the sweep
//                     holds the W-deep global ring on all four sides and
//                     every cell outside the domain.  Bound as H6: one
//                     read and one write of the batch per sweep.
//
// Each operator repeats its plain update's operations in the JAX
// package's order, one rounding per operation (__f*_rn: no contraction
// into FMAs, IEEE division), so kernel and plain version agree to the
// last bit where the plain version rounds the same way; the checks allow
// a stated tolerance all the same.
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

constexpr int FAM_HEAT9 = 0;
constexpr int FAM_ADVDIFF = 1;
constexpr int FAM_REACTDIFF = 2;
constexpr int RESIDENT_THREADS = 256;

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
// Step s reads `cur` and writes `nxt`; src is read only by step 0, so the
// caller's batch is never written.  The result is in p0 when steps is
// odd, in p1 when it is even.  Loads go through __ldcg (L2, not the SM's
// L1) because other blocks wrote them during the previous step.
template <class Op>
__global__ void k_fam_resident(const float* src, float* p0, float* p1,
                               const float* __restrict__ scal, int nb,
                               int nx, int ny, int steps) {
  constexpr int W = Op::W;
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
      const float* at = cur + p;
      float v = __ldcg(at);
      if (i >= W && i < nx - W && j >= W && j < ny - W)
        v = Op::apply([at](int o) { return __ldcg(at + o); }, ny,
                      Op::load(scal + m * Op::S));
      nxt[p] = v;
    }
    grid.sync();
    cur = nxt;
    nxt = (nxt == p0) ? p1 : p0;
  }
}

template <class Op>
cudaError_t resident_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k_fam_resident<Op>, RESIDENT_THREADS, 0);
  if (e != cudaSuccess) return e;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <class Op>
cudaError_t launch_resident(const float* src, float* p0, float* p1,
                            const float* scal, int nb, int nx, int ny,
                            int steps, int blocks, cudaStream_t stream) {
  void* args[] = {(void*)&src, (void*)&p0, (void*)&p1, (void*)&scal,
                  (void*)&nb,  (void*)&nx, (void*)&ny, (void*)&steps};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)k_fam_resident<Op>, dim3(blocks), dim3(RESIDENT_THREADS),
      args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------- H9 --
template <class Op>
__global__ void k_fam_tile(const float* __restrict__ src,
                           float* __restrict__ dst,
                           const float* __restrict__ scal, int nx, int ny,
                           int H, int nsub, int TY, int TX) {
  extern __shared__ float smem[];
  const int m = blockIdx.z;
  const size_t off = (size_t)m * nx * ny;
  heat::tile_sweep<Op, false>(src + off, dst + off, nx, ny,
                              Op::load(scal + m * Op::S), H, nsub, TY, TX,
                              smem);
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
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((ny + TX - 1) / TX, (nx + TY - 1) / TY, nb);
  k_fam_tile<Op><<<grid, block, smem, stream>>>(src, dst, scal, nx, ny, H,
                                                 nsub, TY, TX);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* heat_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Co-resident H8 blocks of family `fam` on the whole card (the
// cooperative grid limit).
int heat_fam_resident_blocks(int fam, int* blocks) {
  switch (fam) {
    case FAM_HEAT9: return resident_blocks<Heat9>(blocks);
    case FAM_ADVDIFF: return resident_blocks<AdvDiff>(blocks);
    case FAM_REACTDIFF: return resident_blocks<ReactDiff>(blocks);
  }
  return cudaErrorInvalidValue;
}

int heat_fam_resident(int fam, const float* src, float* p0, float* p1,
                      const float* scal, int nb, int nx, int ny, int steps,
                      int blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (fam) {
    case FAM_HEAT9:
      return launch_resident<Heat9>(src, p0, p1, scal, nb, nx, ny, steps,
                                    blocks, s);
    case FAM_ADVDIFF:
      return launch_resident<AdvDiff>(src, p0, p1, scal, nb, nx, ny, steps,
                                      blocks, s);
    case FAM_REACTDIFF:
      return launch_resident<ReactDiff>(src, p0, p1, scal, nb, nx, ny,
                                        steps, blocks, s);
  }
  return cudaErrorInvalidValue;
}

// nsub <= T steps of family `fam` in one sweep of tiles with an H = W*T
// deep ring.
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

}  // extern "C"
