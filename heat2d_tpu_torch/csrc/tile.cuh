// Device code shared by csrc/stencil.cu (H2-H4), csrc/ensemble.cu
// (H5-H7), csrc/family.cu (H8/H9) and csrc/shard.cu (H12-H14): the heat5
// step forms, the operator interface, and two pieces generic over an
// operator:
//   - tile_steps: steps of a tile in shared memory, one cell a thread;
//     the step loop of H5/H8's resident sweep (csrc/resident.cuh);
//   - the strip sweep (strip_sweep_at), generic also over where a tile's
//     cells are loaded from: a strip of 4 cells a thread (8 in
//     the heat5 sweeps H2/H3, H6/H7 and H14) with its x neighbours in
//     registers, 16 warps, two blocks an SM, the held rule tested once
//     per block; every streamed kernel: H2/H3, H6/H7, H9 and H12-H14.
//
// An operator Op has a spatial radius Op::W, a scalar set Op::Params,
// and Op::apply(ld, row, k): the updated value of a cell from ld(o), the
// value o cells away in memory (o = +-row for the x neighbours, +-1 for
// the y neighbours).  It updates cells with W <= i < nx-W and
// W <= j < ny-W; the W-deep ring and every cell outside the domain are
// held.
//
// A sweep advances one (TY+2H) x (TX+2H) tile -- its TY x TX centre
// plus an H-deep halo ring, H >= W * nsub -- nsub steps in shared memory
// and writes only the centre, to a second buffer.  Device-memory traffic
// is one read and one write of the grid per sweep (plus the rings), so
// bytes per step fall ~nsub-fold; the bound moves towards shared-memory
// traffic and FLOPs.  Cells outside the domain load as 0 and are held.

#pragma once

#include <cuda_runtime.h>

namespace heat {

constexpr int FORM_FMA = 0;
constexpr int FORM_LITERAL = 1;
constexpr int BLOCK_X = 32;  // threads along a row (coalesced)
constexpr int BLOCK_Y = 8;   // threads along a column

struct Coef {
  float cx, cy, k0;
};

//   FORM_FMA     (1-2cx-2cy)*c + cx*(S+N) + cy*(E+W), contracted into FMAs
//   FORM_LITERAL c + cx*((S+N) - 2c) + cy*((E+W) - 2c), every operation
//                rounded on its own (__f*_rn), the operation order of
//                ops/stencil._laplacian_update, so that it is bitwise
//                equal to the plain PyTorch step.
template <int FORM>
__device__ __forceinline__ float update(float c, float n, float s, float w,
                                        float e, Coef k) {
  if (FORM == FORM_LITERAL) {
    const float two_c = __fmul_rn(2.0f, c);
    const float x = __fmul_rn(k.cx, __fsub_rn(__fadd_rn(s, n), two_c));
    const float y = __fmul_rn(k.cy, __fsub_rn(__fadd_rn(e, w), two_c));
    return __fadd_rn(__fadd_rn(c, x), y);
  }
  return fmaf(k.cy, e + w, fmaf(k.cx, s + n, k.k0 * c));
}

// heat5 as an operator, in either step form.
template <int FORM>
struct Heat5 {
  static constexpr int W = 1;
  using Params = Coef;
  template <class Ld>
  __device__ __forceinline__ static float apply(Ld ld, int row,
                                                const Coef& k) {
    return update<FORM>(ld(0), ld(-row), ld(row), ld(-1), ld(1), k);
  }
};

// The sum of `acc` over a block of WARPS warps of 32 x WARPS threads (x
// fastest), valid in thread (0, 0).
template <int WARPS = BLOCK_X * BLOCK_Y / 32>
__device__ __forceinline__ float block_sum(float acc) {
  static_assert(WARPS <= 32, "one warp sums the warps' partials");
  __shared__ float warp_sums[WARPS];
  const int t = threadIdx.y * BLOCK_X + threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  acc = 0.0f;
  if (warp == 0) {
    acc = lane < WARPS ? warp_sums[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
  }
  return acc;
}

// Asynchronous 4-byte copies from device to shared memory (cp.async: no
// register staging, so a thread keeps all its copies in flight).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The loader of a whole nx x ny grid: the cell's value, 0 outside it.
// row(gi, gj) points at cell (gi, gj) of the grid, for the strip sweep's
// tiles whose ext lies inside it.
struct GridLoad {
  const float* __restrict__ src;
  int nx, ny;
  __device__ __forceinline__ float operator()(int gi, int gj) const {
    return (gi >= 0 && gi < nx && gj >= 0 && gj < ny)
               ? src[(size_t)gi * ny + gj] : 0.0f;
  }
  __device__ __forceinline__ const float* row(int gi, int gj) const {
    return src + (ptrdiff_t)gi * ny + gj;
  }
};

// The block a sweep writes: `rows` x `cols` cells (dst's row stride is
// `cols`) whose (0, 0) is global cell (x0, y0) of the nx x ny domain.  A
// whole grid is {0, 0, nx, ny}; a shard of a mesh sits at its offset.
struct Placement {
  int x0, y0, rows, cols;
};

// nsub steps of the EY x EX ext tile in `cur`, whose cell (0, 0) is global
// cell (i0, j0), by a block of BLOCK_X x BY threads; `nxt` is a second
// ext tile.  Step s rewrites the interior W*s cells in from the tile's
// edge: its neighbours lie in the region step s-1 wrote, so no cell is
// read before it is written, and a cell W*nsub or more cells in is exact.
// The held rule is in global coordinates.  On return `cur` holds the last
// step and `nxt` the one before it (where both were written).
template <class Op, int BY>
__device__ __forceinline__ void tile_steps(float*& cur, float*& nxt, int i0,
                                           int j0, int EY, int EX, int nx,
                                           int ny,
                                           const typename Op::Params& k,
                                           int nsub) {
  constexpr int W = Op::W;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int s = 1; s <= nsub; ++s) {
    const int lo = W * s;
    for (int r = lo + ty; r < EY - lo; r += BY) {
      const int gi = i0 + r;
      const bool row_upd = gi >= W && gi < nx - W;
      for (int c = lo + tx; c < EX - lo; c += BLOCK_X) {
        const int gj = j0 + c;
        const int p = r * EX + c;
        float v = cur[p];
        if (row_upd && gj >= W && gj < ny - W)
          v = Op::apply([&](int o) { return cur[p + o]; }, EX, k);
        nxt[p] = v;
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// ------------------------------------------------------ the strip sweep --
// The tile's ext is read into shared memory once; step s = 1..nsub
// rewrites the region H - W*(nsub - s) cells in from the ext's edge (what
// the centre needs) into the second buffer, and the last step (the
// centre) goes from registers straight to dst.  Unlike tile_steps, a
// thread updates a strip of STRIP cells down one column: the column's
// STRIP + 2W values are loaded once into registers and serve as the
// strip's x neighbours, and the strip's cells are independent update
// chains.  Op::apply is called unchanged -- its ld(o) maps the x offsets
// (multiples of STRIP_ROW) to those registers and the y offsets (+-1,
// +-2) to shared memory -- so each cell's rounded operations are those
// of tile_steps and of the plain version, in their order.
constexpr int STRIP = 4;
// The row stride Op::apply is given: ld(o) reads x offset
// (o + STRIP_ROW/2) >> 16 (in rows) and y offset o - x * STRIP_ROW.
constexpr int STRIP_ROW = 1 << 16;
// Thread rows (warps) of a strip-sweep block: 16, two blocks an SM at the
// plans of ops/cuda_family.py and ops/cuda_shard.py (8 timed slower).
constexpr int STRIP_BY = 16;

// Step (strip, cc) on by BY items of `ncc` column chunks a strip, without
// a division.
template <int BY>
__device__ __forceinline__ void next_item(int& strip, int& cc, int ncc) {
  cc += BY;
  while (cc >= ncc) {
    cc -= ncc;
    ++strip;
  }
}

// Whether the ext (ring H) of this block's tile of `pl` lies inside `box`
// (both in global cells): the strip sweep's uniform fast-path tests.
__device__ __forceinline__ bool ext_inside(Placement pl, int H, int TY,
                                           int TX, Placement box) {
  const int i0 = pl.x0 + (int)blockIdx.y * TY - H - box.x0;
  const int j0 = pl.y0 + (int)blockIdx.x * TX - H - box.y0;
  return i0 >= 0 && j0 >= 0 && i0 + TY + 2 * H <= box.rows &&
         j0 + TX + 2 * H <= box.cols;
}

// One strip sweep of the tile (blockIdx.y, blockIdx.x) of the block `pl`
// (Placement), ring H, centre TY x TX, by a block of 32 x BY threads.
// `load(gi, gj)` gives the value of global cell (gi, gj) at the start of
// the sweep, for every cell of the tile's ext (inside the block, in a
// neighbour's halo, or outside the domain).  The held rule is in global
// coordinates, so a shard holds the domain's ring and every cell past it
// (the pad cells of an uneven decomposition among them).  `smem` holds
// two ext tiles.
// EDGE = false is the fast path, for a block whose ext lies inside the
// domain and inside the one array that load.row addresses (a uniform test
// per block, ext_inside): its rows are copied straight from that array by
// cp.async, and the held rule and the write mask are skipped.  EDGE =
// true loads every cell through load(gi, gj), 8 loads in flight a thread,
// holds the W-deep global ring and every cell outside the domain, and
// writes only cells inside `pl`.  With RESID, returns (in thread (0, 0))
// the tile's sum of squared deltas over the last step pair of its written
// cells, the previous step's value being the strip's register (held
// cells add 0).  S is the strip's length: STRIP in H9 and H12/H13, 8 in
// the heat5 sweeps H2/H3, H6/H7 and H14.
template <class Op, int BY, bool EDGE, bool RESID, int S = STRIP,
          class Load>
__device__ __forceinline__ float strip_sweep_at(const Load& load,
                                                float* __restrict__ dst,
                                                Placement pl, int nx, int ny,
                                                const typename Op::Params& k,
                                                int H, int nsub, int TY,
                                                int TX, float* smem) {
  constexpr int W = Op::W;
  constexpr int LOADS = 8;  // global loads in flight per thread
  const int EY = TY + 2 * H, EX = TX + 2 * H;
  const int i0 = pl.x0 + (int)blockIdx.y * TY - H;
  const int j0 = pl.y0 + (int)blockIdx.x * TX - H;
  const int tx = threadIdx.x, ty = threadIdx.y;
  float* cur = smem;
  float* nxt = smem + EY * EX;

  if (EDGE) {
    for (int r = ty; r < EY; r += BY) {
      const int gi = i0 + r;
      for (int c0 = tx; c0 < EX; c0 += 32 * LOADS) {
        float v[LOADS];
#pragma unroll
        for (int q = 0; q < LOADS; ++q) {
          const int c = c0 + 32 * q;
          v[q] = c < EX ? load(gi, j0 + c) : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < LOADS; ++q)
          if (c0 + 32 * q < EX) cur[r * EX + c0 + 32 * q] = v[q];
      }
    }
  } else {
    // Every copy of the thread in flight at once, one wait.
    for (int r = ty; r < EY; r += BY) {
      const float* srow = load.row(i0 + r, j0);
      for (int c = tx; c < EX; c += 32)
        cp_async4(cur + r * EX + c, srow + c);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  float acc = 0.0f;
  for (int s = 1; s <= nsub; ++s) {
    const bool last = s == nsub;
    const int lo = H - W * (nsub - s);
    const int rows = EY - 2 * lo, cols = EX - 2 * lo;
    // Work items (strip, chunk of 32 columns), dealt to the warps in
    // turn: warp ty takes items ty, ty + BY, ...
    const int ncc = (cols + 31) / 32;
    const int strips = (rows + S - 1) / S;
    int strip = ty / ncc, cc = ty - strip * ncc;
    for (; strip < strips; next_item<BY>(strip, cc, ncc)) {
      const int r0 = lo + strip * S;
      const int c = lo + cc * 32 + tx;
      const int nr = min(S, rows + lo - r0);  // uniform in a warp
      if (c >= lo + cols) continue;
      float col[S + 2 * W];
#pragma unroll
      for (int q = 0; q < S + 2 * W; ++q)
        col[q] = cur[min(r0 - W + q, EY - 1) * EX + c];
      const int gj = j0 + c;
      const bool col_upd = !EDGE || (gj >= W && gj < ny - W);
#pragma unroll
      for (int q = 0; q < S; ++q) {
        if (q >= nr) break;
        const int p = (r0 + q) * EX + c;
        float v = Op::apply(
            [&](int o) {
              const int dx = (o + STRIP_ROW / 2) >> 16;
              const int dy = o - dx * STRIP_ROW;
              return dy == 0 ? col[W + q + dx] : cur[p + dy];
            },
            STRIP_ROW, k);
        const int gi = i0 + r0 + q;
        if (EDGE && !(col_upd && gi >= W && gi < nx - W)) v = col[W + q];
        if (!last) {
          nxt[p] = v;
          continue;
        }
        const int li = gi - pl.x0, lj = gj - pl.y0;
        if (!EDGE || (li < pl.rows && lj < pl.cols)) {
          dst[(size_t)li * pl.cols + lj] = v;
          if (RESID) {
            const float d = v - col[W + q];
            acc += d * d;
          }
        }
      }
    }
    if (!last) {
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  return RESID ? block_sum<BY>(acc) : 0.0f;
}

// Dynamic shared memory of one tile block: two ext tiles, ring H.
inline size_t tile_smem_bytes(int H, int TY, int TX) {
  return 2 * (size_t)(TY + 2 * H) * (TX + 2 * H) * sizeof(float);
}

}  // namespace heat
