// Hand-written Hopper (sm_90a) kernels for the sharded heat5 solve (mode
// hybrid): one shard of a (gx, gy) mesh of (bm, bn) blocks advanced nsub
// steps.  The Python wrappers, their plain PyTorch versions and the launch
// counters live in heat2d_tpu_torch/ops/cuda_shard.py.
//
//   H12 k_shard_tile        <- kernel D (_shard_fused_vmem_kernel,
//                              _shard_fused_band_kernel) and D2
//                              (_shard_window_kernel) of
//                              heat2d_tpu/ops/pallas_stencil.py: the block
//                              plus its four T-deep halo strips (the layout
//                              of parallel/halo.exchange_halo_strips: N/S
//                              (T, bn), W/E (bm+2T, T) carrying the
//                              corners) -> the block advanced nsub <= T
//                              steps, written to a second buffer.
//   H13 k_shard_tile<RESID> <- D2R: H12 plus one partial sum of squared
//                              deltas of the last step pair per tile (the
//                              same template, RESID = true).
//   H14 k_shard_fused       <- kernel F (_fused_ici_kernel): the halo
//                              exchange moves into the kernel.  Tile loads
//                              read ring cells straight from the neighbour
//                              shards' blocks through the table of the
//                              mesh's block pointers the launch carries;
//                              cells past the mesh edge load 0 (the
//                              MPI_PROC_NULL zeros).  One launch covers
//                              every shard a device holds (blockIdx.z).
//
// All three are the strip sweep of csrc/tile.cuh (a strip of S cells a
// thread with its x neighbours in registers, 16 warps, two blocks an SM;
// S = 4 in H12/H13, 8 in H14) with another loader: the TPU kernels'
// VMEM/HBM split and band windows have no counterpart.  None is bound on
// the H100 by device-memory bytes (one read and one write of the block
// per sweep, plus the strips) but by the instructions of the step loop
// and the ring recompute.  The strip sweep tests two things once per
// block, uniformly: (a) the tile's ext lies inside the shard's own block
// u, so its rows are copied straight from u (cp.async), and (b) it lies
// inside the domain, so no cell is held.  A block that passes both (at a
// 2048^2 shard, T = 8, 420 of 512 tiles) runs without either; the others
// load through their loader (ShardLoad's five-way branch, or MeshLoad's
// owner lookup) and hold cells.  The held-cell rule is in global
// coordinates from the shard's origin (x0, y0): the domain's ring and
// every cell past it (pad cells of an uneven decomposition hold their
// stored value, which the loader reads, never recomputes; a tile can pass
// (a) and fail (b) on pad rows).

// No kernel writes a buffer it reads: H14's tiles read the input blocks of
// every shard, so each shard's output is a separate buffer.  With several
// cards, H14 reads the neighbours on other cards through peer access; the
// wrapper orders the launches with events between the devices.
//
// Every entry point returns a cudaError_t (0 on success).

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

using heat::Coef;
using heat::FORM_FMA;
using heat::FORM_LITERAL;
using heat::Placement;

// A shard's block and its halo strips, indexed by global cell; row(gi,
// gj) points at a cell of the block u, for tiles whose ext lies inside it.
struct ShardLoad {
  const float* __restrict__ u;
  const float* __restrict__ n;
  const float* __restrict__ s;
  const float* __restrict__ w;
  const float* __restrict__ e;
  int x0, y0, bm, bn, t;
  __device__ __forceinline__ float operator()(int gi, int gj) const {
    const int li = gi - x0, lj = gj - y0;
    if (li < -t || li >= bm + t || lj < -t || lj >= bn + t) return 0.0f;
    if (lj < 0) return w[(size_t)(li + t) * t + (lj + t)];
    if (lj >= bn) return e[(size_t)(li + t) * t + (lj - bn)];
    if (li < 0) return n[(size_t)(li + t) * bn + lj];
    if (li >= bm) return s[(size_t)(li - bm) * bn + lj];
    return u[(size_t)li * bn + lj];
  }
  __device__ __forceinline__ const float* row(int gi, int gj) const {
    return u + (ptrdiff_t)(gi - x0) * bn + (gj - y0);
  }
};

constexpr int MAX_SHARDS = 64;

// The mesh as H14 sees it, passed by value (__grid_constant__, so no
// copy to local memory): every shard's input block in row-major mesh
// order, and the output and mesh position of each shard of the launch.
struct MeshTable {
  const float* blocks[MAX_SHARDS];
  float* outs[MAX_SHARDS];
  int pos[2 * MAX_SHARDS];
  int gx, gy, bm, bn;
};

// Every shard's block of the mesh, indexed by global cell, as the shard
// at mesh position (px, py) reads it: the owner of (gi, gj) is shard
// (gi / bm, gj / bn); past the mesh edge, 0.  row(gi, gj) points at a
// cell of the shard's own block, for tiles whose ext lies inside it.
// (Finding the owner by comparing against the shard's bounds instead of
// dividing timed 1.9% faster on the H100: below the 5% that would pay
// for its branches.)
struct MeshLoad {
  const MeshTable& m;
  int px, py;
  __device__ __forceinline__ float operator()(int gi, int gj) const {
    if (gi < 0 || gj < 0 || gi >= m.gx * m.bm || gj >= m.gy * m.bn)
      return 0.0f;
    const int ox = gi / m.bm, oy = gj / m.bn;
    return m.blocks[ox * m.gy + oy][(size_t)(gi - ox * m.bm) * m.bn +
                                    (gj - oy * m.bn)];
  }
  __device__ __forceinline__ const float* row(int gi, int gj) const {
    return m.blocks[px * m.gy + py] + (ptrdiff_t)(gi - px * m.bm) * m.bn +
           (gj - py * m.bn);
  }
};

// ------------------------------------------------------------ H12 / H13 --
constexpr int SHARD_BY = heat::STRIP_BY;
// Cells a strip of H14: 8, H2's heat5 build (on the H100 15% faster than
// the 4 of H12/H13).
constexpr int FUSED_STRIP = 8;

// `paths` (NULL, or three words that the caller zeroed): thread (0, 0)
// of each block adds its tile to the word of the path it takes -- fast,
// edge, and of the edge tiles those inside u (ops/cuda_shard.py
// TILE_PATHS).  With RESID, each block writes its tile's partial sum.
template <int FORM, bool RESID>
__global__ void __launch_bounds__(32 * SHARD_BY, 2)
    k_shard_tile(ShardLoad ld, float* __restrict__ dst,
                 float* __restrict__ parts, unsigned* paths, int nx, int ny,
                 Coef k, int T, int nsub, int TY, int TX) {
  extern __shared__ float smem[];
  using Op = heat::Heat5<FORM>;
  const Placement pl{ld.x0, ld.y0, ld.bm, ld.bn};
  const bool in_block = heat::ext_inside(pl, T, TY, TX, pl);
  const bool fast =
      in_block && heat::ext_inside(pl, T, TY, TX, Placement{0, 0, nx, ny});
  const bool first = threadIdx.x == 0 && threadIdx.y == 0;
  if (paths != nullptr && first) {
    atomicAdd(paths + (fast ? 0 : 1), 1u);
    if (in_block && !fast) atomicAdd(paths + 2, 1u);
  }
  const float acc =
      fast ? heat::strip_sweep_at<Op, SHARD_BY, false, RESID>(
                 ld, dst, pl, nx, ny, k, T, nsub, TY, TX, smem)
           : heat::strip_sweep_at<Op, SHARD_BY, true, RESID>(
                 ld, dst, pl, nx, ny, k, T, nsub, TY, TX, smem);
  if (RESID && first) parts[blockIdx.y * gridDim.x + blockIdx.x] = acc;
}

// ---------------------------------------------------------------- H14 --
// Shard z = blockIdx.z of the launch sits at mesh position (m.pos[2z],
// m.pos[2z+1]) and writes m.outs[z].  The fast path is H12's: the ext
// lies inside the shard's own block and inside the domain.  `paths` as
// k_shard_tile's, summed over the launch's shards.
template <int FORM>
__global__ void __launch_bounds__(32 * SHARD_BY, 2)
    k_shard_fused(const __grid_constant__ MeshTable m, unsigned* paths,
                  int nx, int ny, Coef k, int H, int nsub, int TY, int TX) {
  extern __shared__ float smem[];
  using Op = heat::Heat5<FORM>;
  const int z = blockIdx.z;
  const int px = m.pos[2 * z], py = m.pos[2 * z + 1];
  const Placement pl{px * m.bm, py * m.bn, m.bm, m.bn};
  const MeshLoad ld{m, px, py};
  const bool in_block = heat::ext_inside(pl, H, TY, TX, pl);
  const bool fast =
      in_block && heat::ext_inside(pl, H, TY, TX, Placement{0, 0, nx, ny});
  if (paths != nullptr && threadIdx.x == 0 && threadIdx.y == 0) {
    atomicAdd(paths + (fast ? 0 : 1), 1u);
    if (in_block && !fast) atomicAdd(paths + 2, 1u);
  }
  if (fast)
    heat::strip_sweep_at<Op, SHARD_BY, false, false, FUSED_STRIP>(
        ld, m.outs[z], pl, nx, ny, k, H, nsub, TY, TX, smem);
  else
    heat::strip_sweep_at<Op, SHARD_BY, true, false, FUSED_STRIP>(
        ld, m.outs[z], pl, nx, ny, k, H, nsub, TY, TX, smem);
}

template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int FORM, bool RESID>
cudaError_t launch_shard_tile(const ShardLoad& ld, float* dst, float* parts,
                              unsigned* paths, int nx, int ny, Coef k, int T,
                              int nsub, int TY, int TX, cudaStream_t stream) {
  const size_t smem = heat::tile_smem_bytes(T, TY, TX);
  cudaError_t e = allow_smem(k_shard_tile<FORM, RESID>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((ld.bn + TX - 1) / TX, (ld.bm + TY - 1) / TY);
  k_shard_tile<FORM, RESID><<<grid, dim3(32, SHARD_BY), smem, stream>>>(
      ld, dst, parts, paths, nx, ny, k, T, nsub, TY, TX);
  return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_shard_fused(const MeshTable& m, unsigned* paths, int nz,
                               int nx, int ny, Coef k, int H, int nsub,
                               int TY, int TX, cudaStream_t stream) {
  const size_t smem = heat::tile_smem_bytes(H, TY, TX);
  cudaError_t e = allow_smem(k_shard_fused<FORM>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((m.bn + TX - 1) / TX, (m.bm + TY - 1) / TY, nz);
  k_shard_fused<FORM><<<grid, dim3(32, SHARD_BY), smem, stream>>>(
      m, paths, nx, ny, k, H, nsub, TY, TX);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* heat_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// H12 (parts == NULL) or H13 (one partial per tile, row-major over the
// (ceil(bm/TY), ceil(bn/TX)) tile grid) on one shard at global (x0, y0).
// `paths`: NULL, or k_shard_tile's three path counts.
int heat_shard_tile(const float* u, const float* n, const float* s,
                    const float* w, const float* e, float* dst, float* parts,
                    unsigned* paths, int x0, int y0, int bm, int bn, int nx,
                    int ny, float cx, float cy, float k0, int form, int T,
                    int nsub, int TY, int TX, void* stream) {
  const ShardLoad ld{u, n, s, w, e, x0, y0, bm, bn, T};
  const Coef k{cx, cy, k0};
  cudaStream_t st = (cudaStream_t)stream;
  auto launch = parts == nullptr
                    ? (form == FORM_LITERAL
                           ? launch_shard_tile<FORM_LITERAL, false>
                           : launch_shard_tile<FORM_FMA, false>)
                    : (form == FORM_LITERAL
                           ? launch_shard_tile<FORM_LITERAL, true>
                           : launch_shard_tile<FORM_FMA, true>);
  return launch(ld, dst, parts, paths, nx, ny, k, T, nsub, TY, TX, st);
}

// H14: nz shards of one device.  Host arrays: `blocks` the gx * gy input
// block pointers (row-major mesh order), `outs` the nz output pointers,
// `pos` the nz shards' (ix, iy); at most MAX_SHARDS of each.  `paths`:
// NULL, or k_shard_fused's three path counts.
int heat_shard_fused(const void* const* blocks, void* const* outs,
                     const int* pos, unsigned* paths, int nz, int gx, int gy,
                     int bm, int bn, int nx, int ny, float cx, float cy,
                     float k0, int form, int H, int nsub, int TY, int TX,
                     void* stream) {
  if (gx * gy > MAX_SHARDS || nz > MAX_SHARDS || nz < 1)
    return cudaErrorInvalidValue;
  MeshTable m{};
  for (int i = 0; i < gx * gy; ++i) m.blocks[i] = (const float*)blocks[i];
  for (int z = 0; z < nz; ++z) {
    m.outs[z] = (float*)outs[z];
    m.pos[2 * z] = pos[2 * z];
    m.pos[2 * z + 1] = pos[2 * z + 1];
  }
  m.gx = gx;
  m.gy = gy;
  m.bm = bm;
  m.bn = bn;
  const Coef k{cx, cy, k0};
  cudaStream_t st = (cudaStream_t)stream;
  return form == FORM_LITERAL
             ? launch_shard_fused<FORM_LITERAL>(m, paths, nz, nx, ny, k, H,
                                                nsub, TY, TX, st)
             : launch_shard_fused<FORM_FMA>(m, paths, nz, nx, ny, k, H, nsub,
                                            TY, TX, st);
}

// Lets the current device's kernels read memory of device `peer`
// (idempotent: an already enabled peer is not an error).
int heat_shard_enable_peer(int peer) {
  cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return cudaSuccess;
  }
  return e;
}

}  // extern "C"
