// Device code shared by csrc/stencil.cu (H2/H3) and csrc/ensemble.cu
// (H6/H7): the two step forms and the shared-memory tile sweep.
//
// A tile sweep advances one (TY+2T) x (TX+2T) tile -- its TY x TX centre
// plus a T-deep halo ring -- nsub <= T steps in shared memory and writes
// only the centre, to a second buffer.  Device-memory traffic is one
// read and one write of the grid per sweep (plus the rings), so bytes
// per step fall ~T-fold; the bound moves towards shared-memory traffic
// and FLOPs.  Cells outside the domain load as 0 and are held, like the
// domain's own rows 0 / nx-1 and columns 0 / ny-1.

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

// The block's sum of `acc`, valid in thread (0, 0).
__device__ __forceinline__ float block_sum(float acc) {
  __shared__ float warp_sums[BLOCK_X * BLOCK_Y / 32];
  const int t = threadIdx.y * BLOCK_X + threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  acc = 0.0f;
  if (warp == 0) {
    acc = lane < BLOCK_X * BLOCK_Y / 32 ? warp_sums[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
  }
  return acc;
}

// One sweep of the tile (blockIdx.y, blockIdx.x) of an nx x ny grid.
// `smem` holds two ext tiles.  With RESID, returns (in thread (0, 0)) the
// tile's sum of squared deltas over the last step pair of its centre.
template <int FORM, bool RESID>
__device__ __forceinline__ float tile_sweep(const float* __restrict__ src,
                                            float* __restrict__ dst, int nx,
                                            int ny, Coef k, int T, int nsub,
                                            int TY, int TX, float* smem) {
  const int EY = TY + 2 * T, EX = TX + 2 * T;
  float* cur = smem;
  float* nxt = smem + EY * EX;
  const int i0 = blockIdx.y * TY - T;
  const int j0 = blockIdx.x * TX - T;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int r = ty; r < EY; r += BLOCK_Y) {
    const int gi = i0 + r;
    const bool row_in = gi >= 0 && gi < nx;
    for (int c = tx; c < EX; c += BLOCK_X) {
      const int gj = j0 + c;
      cur[r * EX + c] = (row_in && gj >= 0 && gj < ny)
                            ? src[(size_t)gi * ny + gj] : 0.0f;
    }
  }
  __syncthreads();

  // Step s rewrites the ring-s interior [s, E-1-s]: its neighbours lie in
  // the region step s-1 wrote, so no cell is read before it is written,
  // and the centre (T cells in) is exact for every s <= nsub <= T.
  for (int s = 1; s <= nsub; ++s) {
    for (int r = s + ty; r < EY - s; r += BLOCK_Y) {
      const int gi = i0 + r;
      const bool row_upd = gi > 0 && gi < nx - 1;
      for (int c = s + tx; c < EX - s; c += BLOCK_X) {
        const int gj = j0 + c;
        const int p = r * EX + c;
        float v = cur[p];
        if (row_upd && gj > 0 && gj < ny - 1)
          v = update<FORM>(v, cur[p - EX], cur[p + EX], cur[p - 1],
                           cur[p + 1], k);
        nxt[p] = v;
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // cur holds the last step, nxt the one before it.
  float acc = 0.0f;
  for (int r = T + ty; r < T + TY; r += BLOCK_Y) {
    const int gi = i0 + r;
    if (gi >= nx) break;
    for (int c = T + tx; c < T + TX; c += BLOCK_X) {
      const int gj = j0 + c;
      if (gj >= ny) break;
      const float v = cur[r * EX + c];
      dst[(size_t)gi * ny + gj] = v;
      if (RESID) {
        const float d = v - nxt[r * EX + c];
        acc += d * d;
      }
    }
  }
  return RESID ? block_sum(acc) : 0.0f;
}

// Dynamic shared memory of one tile block: two ext tiles.
inline size_t tile_smem_bytes(int T, int TY, int TX) {
  return 2 * (size_t)(TY + 2 * T) * (TX + 2 * T) * sizeof(float);
}

}  // namespace heat
