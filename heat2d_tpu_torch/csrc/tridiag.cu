// Hand-written Hopper (sm_90a) kernels for batched constant-coefficient
// tridiagonal solves: the Crank-Nicolson half-step systems of the ADI
// method, (I - (c/2) d2) x = rhs with identity rows 0 and n-1, one
// diffusion number c per member.
//
// The port of kernel TD of heat2d_tpu/ops/tridiag.py; the Python
// wrappers, their plain PyTorch versions and the launch counters live in
// heat2d_tpu_torch/ops/tridiag.py.
//
//   k_td_coeffs    <- _coeff_loops (TD, tridiag.py:219): the elimination
//                     scalars of each member's matrix, one warp per
//                     member, in the JAX package's order: m = b -
//                     a*cp[i-1], mi = 1/m, cp = a/m, with a = -c/2 and
//                     b = 1 + c on interior rows, (0, 1) on rows 0 and
//                     n-1.  (cp, mi) depend on (c, n) only, so a run
//                     computes them once and hands them to every solve
//                     (the TPU kernel recomputes them per program; XLA
//                     hoists them out of the jnp route's loop).  The
//                     recurrence reaches a float fixed point within a few
//                     dozen rows (38 at c = 51.2); the warp fills the rows
//                     after it.
//   H10 k_td_rows  <- _tridiag_rows_kernel (TD, tridiag.py:324): solve
//                     along axis 1 of a (B, n, m) batch.  One warp takes
//                     a panel of 32 adjacent columns of one member (one
//                     system a lane, 128-byte coalesced rows).
//   H11 k_td_lanes <- _tridiag_lanes_kernel (TD, tridiag.py:349): solve
//                     along axis 2 of a (B, rows, n) batch.  One warp takes
//                     a panel of 32 adjacent rows of one member (one system
//                     a lane): H10's design with the tile transposed in
//                     shared memory (below).
//
// The solve is out[i] = (rhs[i] - a_i*out[i-1]) * mi[i] forward (a_i = a
// on rows 1..n-2, 0 on rows 0 and n-1; row 0 is then rhs[0] exactly) and
// out[i] -= cp[i] * out[i+1] back.  Every operation rounds on its own
// (__f*_rn), as the plain version does, so kernel and plain version
// agree bit for bit.
//
// What bounds H10, and what its design does about it.  By bytes: the
// batch is read once and written once, 8 bytes an unknown, 0.040 ms for
// 4096 x 4096 at 3.35 TB/s; the two sweeps as written read and write it
// twice (0.080 ms) less what the back sweep finds in the 50 MB L2 (it
// starts on the rows the forward sweep wrote last).  By the dependent
// chain: 3 rounded operations a row forward and 2 back, ~20 clocks a row,
// ~8192 x 10 clocks ~ 45 us for a 4096-row system when all systems run at
// once (4096 columns are 128 warps: one per SM).  The recurrence must
// never wait on memory (on the card a warp's sweep still runs at a
// fraction of its chain's rate, whatever the staging tried: PERF.md):
//   - the member's (cp, mi) sit in shared memory (8n bytes, 32 KB at
//     n = 4096), copied once per block; where 8n does not fit beside the
//     rings (n above ~24k rows) they are read through the read-only cache;
//   - each warp stages its panel through a ring of STAGES slots of
//     STAGE_ROWS rows in shared memory with cp.async copies issued
//     STAGES-1 stages ahead of the rows being eliminated: ~28 KB in
//     flight per warp, what one SM's share of the bandwidth needs at
//     ~1 us of latency.  Each lane copies its own column 4 bytes at a
//     time, so a lane reads only what it copied and the warp needs no
//     barrier (16-byte copies, which need one, timed no faster:
//     PERF.md).  A stage gathers its rows into registers before its
//     chain runs;
//   - the forward sweep writes out (the normalised dp) coalesced as it
//     goes; the back sweep stages out the same way, from the last row up.
// A panel's last lanes past m are masked (no copy, no store); a last
// stage of fewer rows runs the same loop with a shorter count.
//
// H11 solves along the contiguous axis, so a lane's system is a row of
// the batch and the 32 lanes' systems lie a row apart: read or written
// by its own lane, every access of a warp would touch 32 rows (the first
// version did so, 3x H10's time).  So the ring's stages are tiles of the
// panel's 32 rows x 32 columns, copied by rows: lane l copies column l of
// each row, one 128-byte segment an instruction, into a slot of row
// stride 33 floats (no bank conflict either way).  A lane then reads its
// own row across the tile, which other lanes copied: each stage waits
// for its copies and then __syncwarp()s, and the slot is refilled only
// after the next __syncwarp.  The chain writes its results back into the
// lane's row of the slot, and the warp stores the tile by rows, coalesced
// again.  The back sweep stages `out` the same way from the aligned
// 32-column group that holds column n-2 down to column 0, after a fence:
// it reads values that other lanes of the warp stored.  Past-the-end rows
// of a panel are neither copied nor stored; their lanes run the chain on
// whatever the slot holds, and nothing reads it.
//
// Every entry point returns a cudaError_t (0 on success); the Python
// wrapper raises on anything else.

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

using heat::cp_async4;
using heat::cp_async_commit;
using heat::cp_async_wait;

constexpr int PANEL = 32;        // lanes of a warp, floats of a ring row
constexpr int STAGE_ROWS = 32;   // rows a ring slot holds
constexpr int STAGES = 8;        // ring slots per warp (a power of two)
constexpr int RING = STAGES * STAGE_ROWS * PANEL;   // floats per warp
constexpr int SLOT_STRIDE = PANEL + 1;  // H11: a slot's row stride, floats
constexpr int SLOT = PANEL * SLOT_STRIDE;            // H11: floats a slot
constexpr int LANES_RING = STAGES * SLOT;            // H11: floats per warp

// Shared memory of one member's (cp, mi), rounded up to 16 bytes.
__host__ __device__ constexpr int coef_floats(int n) {
  return (2 * n + 3) / 4 * 4;
}

// coef: (nb, 2, n) -- cp then mi of each member; one warp per member.
// The recurrence is sequential, and lane 0 runs it; but each row's (cp,
// mi) is a function of the previous row's cp alone (rows 1..n-2 share
// a and d), so once a row repeats its predecessor's cp bit for bit every
// later interior row repeats it too.  From that row on the warp fills the
// rest in parallel: the same values the sequential loop would compute,
// without its ~100 clocks of division a row.
__global__ void k_td_coeffs(const float* __restrict__ c,
                            float* __restrict__ coef, int nb, int n) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float a = __fmul_rn(-0.5f, c[b]);
  const float d = __fadd_rn(1.0f, c[b]);
  float* cp = coef + (size_t)b * 2 * n;
  float* mi = cp + n;
  // Interior rows [fixed, n-2] all hold (cprev, mprev); lane 0's cprev is
  // cp[n-2] (cp[0] = 0 for n < 3) when the loop ends.
  int fixed = n - 1;
  float cprev = 0.0f, mprev = 1.0f;
  if (lane == 0) {
    cp[0] = 0.0f;
    mi[0] = 1.0f;
    for (int i = 1; i <= n - 2; ++i) {
      const float m = __fsub_rn(d, __fmul_rn(a, cprev));
      const float inv = __fdiv_rn(1.0f, m);
      const float next = __fdiv_rn(a, m);
      const bool repeats = __float_as_uint(next) == __float_as_uint(cprev);
      cprev = next;
      mprev = inv;
      if (repeats) {
        // row i+1 sees the cp row i saw: the same m, the same (cp, mi)
        fixed = i;
        break;
      }
      mi[i] = inv;
      cp[i] = next;
    }
  }
  fixed = __shfl_sync(0xffffffffu, fixed, 0);
  const float cfix = __shfl_sync(0xffffffffu, cprev, 0);
  const float mfix = __shfl_sync(0xffffffffu, mprev, 0);
  for (int i = fixed + lane; i <= n - 2; i += 32) {
    cp[i] = cfix;
    mi[i] = mfix;
  }
  if (lane == 0 && n >= 2) {
    // row n-1: a = 0, b = 1
    const float m = __fsub_rn(1.0f, __fmul_rn(0.0f, cprev));
    mi[n - 1] = __fdiv_rn(1.0f, m);
    cp[n - 1] = __fdiv_rn(0.0f, m);
  }
}

// One stage of a warp's panel into a ring slot: rows row0 + dir*k, k <
// cnt, of the panel whose column 0 is `col0` (row stride m), row k to
// slot[k * PANEL + lane], each lane its own column.  The group is
// committed in every lane, empty or not, so the group count stays the
// same in all of them.
__device__ __forceinline__ void stage_in(float* slot, const float* col0,
                                         int row0, int dir, int cnt,
                                         size_t m, int lane, int cols) {
  if (lane < cols) {
    for (int k = 0; k < cnt; ++k)
      cp_async4(slot + k * PANEL + lane,
                col0 + lane + (size_t)(row0 + dir * k) * m);
  }
  cp_async_commit();
}

// H10: warp w of block (blockIdx.x, blockIdx.y) solves the panel of
// columns [(blockIdx.x * warps + w) * 32, +32) of member blockIdx.y of a
// (nb, n, m) batch.
// COEF_SMEM: (cp, mi) copied into shared memory (8n bytes in front of the
// rings), else read from coef through the read-only cache.  Each stage
// first gathers its rows' values and coefficients into registers, then
// runs the chain on them, so that no row's operations wait on a load; a
// stage of interior rows (a_i = a throughout) runs without the per-row
// edge test.
template <bool COEF_SMEM>
__global__ void __launch_bounds__(128) k_td_rows(
    const float* __restrict__ rhs, float* __restrict__ out,
    const float* __restrict__ c, const float* __restrict__ coef, int n,
    int m) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / PANEL, lane = threadIdx.x % PANEL;
  const int warps = blockDim.x / PANEL;
  const float* gcp = coef + (size_t)b * 2 * n;
  const float* gmi = gcp + n;
  float* scp = smem;
  float* smi = smem + n;
  // the warp's ring: slot s, row k, column l at [(s*R + k)*32 + l], 16-byte
  // aligned after the coefficients
  float* ring = smem + (COEF_SMEM ? coef_floats(n) : 0) + warp * RING;
  auto slot_of = [&](int s) {
    return ring + (s % STAGES) * STAGE_ROWS * PANEL;
  };

  if (COEF_SMEM) {
    for (int i = threadIdx.x; i < 2 * n; i += blockDim.x)
      cp_async4(scp + i, gcp + i);
    cp_async_commit();
  }
  const int j0 = (blockIdx.x * warps + warp) * PANEL;
  const int cols = min(PANEL, m - j0);  // the panel's columns in the batch
  const bool valid = lane < cols;
  const size_t mm = (size_t)m;
  const float* src = rhs + (size_t)b * n * m + j0;
  float* dst = out + (size_t)b * n * m + j0;
  const float a = __fmul_rn(-0.5f, c[b]);
  auto cp_at = [&](int i) { return COEF_SMEM ? scp[i] : __ldg(gcp + i); };
  auto mi_at = [&](int i) { return COEF_SMEM ? smi[i] : __ldg(gmi + i); };
  float x[STAGE_ROWS], y[STAGE_ROWS];

  // Forward sweep: stage s holds rows [s*R, s*R + R).
  const int nf = (n + STAGE_ROWS - 1) / STAGE_ROWS;
  auto fwd_cnt = [&](int s) {
    return s < nf ? min(STAGE_ROWS, n - s * STAGE_ROWS) : 0;
  };
  for (int s = 0; s < STAGES - 1; ++s)
    stage_in(slot_of(s), src, s * STAGE_ROWS, 1, fwd_cnt(s), mm, lane,
                  cols);
  if (COEF_SMEM) {
    // The coefficient group is older than the STAGES-1 stage groups.
    cp_async_wait<STAGES - 1>();
    __syncthreads();
  }
  float prev = 0.0f;
  for (int s = 0; s < nf; ++s) {
    const int t = s + STAGES - 1;
    stage_in(slot_of(t), src, t * STAGE_ROWS, 1, fwd_cnt(t), mm, lane,
                  cols);
    cp_async_wait<STAGES - 1>();
    const float* slot = slot_of(s) + lane;
    const int row0 = s * STAGE_ROWS, cnt = fwd_cnt(s);
#pragma unroll
    for (int k = 0; k < STAGE_ROWS; ++k)
      if (k < cnt) {
        x[k] = slot[k * PANEL];
        y[k] = mi_at(row0 + k);
      }
    float* o = dst + lane + row0 * mm;
    if (row0 >= 1 && row0 + STAGE_ROWS <= n - 1) {
#pragma unroll
      for (int k = 0; k < STAGE_ROWS; ++k) {
        prev = __fmul_rn(__fsub_rn(x[k], __fmul_rn(a, prev)), y[k]);
        if (valid) o[k * mm] = prev;
      }
    } else {
#pragma unroll
      for (int k = 0; k < STAGE_ROWS; ++k)
        if (k < cnt) {
          const int i = row0 + k;
          const float ai = (unsigned)(i - 1) < (unsigned)(n - 2) ? a : 0.0f;
          prev = __fmul_rn(__fsub_rn(x[k], __fmul_rn(ai, prev)), y[k]);
          if (valid) o[k * mm] = prev;
        }
    }
  }

  // Back substitution: stage s holds rows n-2 - s*R down to n-1 - (s+1)*R.
  // It reads what the warp stored above: order those stores first.
  __threadfence();
  const int nbk = (n - 1 + STAGE_ROWS - 1) / STAGE_ROWS;
  auto back_cnt = [&](int s) {
    return s < nbk ? min(STAGE_ROWS, n - 1 - s * STAGE_ROWS) : 0;
  };
  for (int s = 0; s < STAGES - 1; ++s)
    stage_in(slot_of(s), dst, n - 2 - s * STAGE_ROWS, -1, back_cnt(s),
                  mm, lane, cols);
  float next = prev;
  for (int s = 0; s < nbk; ++s) {
    const int t = s + STAGES - 1;
    stage_in(slot_of(t), dst, n - 2 - t * STAGE_ROWS, -1, back_cnt(t),
                  mm, lane, cols);
    cp_async_wait<STAGES - 1>();
    const float* slot = slot_of(s) + lane;
    const int hi = n - 2 - s * STAGE_ROWS, cnt = back_cnt(s);
#pragma unroll
    for (int k = 0; k < STAGE_ROWS; ++k)
      if (k < cnt) {
        x[k] = slot[k * PANEL];
        y[k] = cp_at(hi - k);
      }
    float* o = dst + lane + hi * mm;
#pragma unroll
    for (int k = 0; k < STAGE_ROWS; ++k)
      if (k < cnt) {
        next = __fsub_rn(x[k], __fmul_rn(y[k], next));
        if (valid) o[-(ptrdiff_t)(k * mm)] = next;
      }
  }
  cp_async_wait<0>();
}

// One H11 stage: columns [col0, col0 + cnt) of the panel's `nrows` rows
// (row stride n, row 0 at `rows`) into `slot`, lane l copying column
// col0 + l of every row to slot[k * SLOT_STRIDE + l]: one 128-byte row
// segment a warp instruction.  Committed in every lane, as stage_in.
__device__ __forceinline__ void stage_cols(float* slot, const float* rows,
                                           int col0, int cnt, int nrows,
                                           size_t n, int lane) {
  if (lane < cnt) {
    for (int k = 0; k < nrows; ++k)
      cp_async4(slot + k * SLOT_STRIDE + lane, rows + k * n + col0 + lane);
  }
  cp_async_commit();
}

// The slot's tile back to the panel's rows, the same way round.
__device__ __forceinline__ void store_cols(const float* slot, float* rows,
                                           int col0, int cnt, int nrows,
                                           size_t n, int lane) {
  if (lane < cnt) {
    for (int k = 0; k < nrows; ++k)
      rows[k * n + col0 + lane] = slot[k * SLOT_STRIDE + lane];
  }
}

// H11: warp w of block (blockIdx.x, blockIdx.y) solves the panel of rows
// [(blockIdx.x * warps + w) * 32, +32) of member blockIdx.y of a (nb,
// rows, n) batch, lane l row l of the panel.  COEF_SMEM as in H10; each
// stage gathers its values and coefficients into registers first, and a
// stage of interior columns runs without the per-column edge test.
template <bool COEF_SMEM>
__global__ void __launch_bounds__(128) k_td_lanes(
    const float* __restrict__ rhs, float* __restrict__ out,
    const float* __restrict__ c, const float* __restrict__ coef, int rows,
    int n) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / PANEL, lane = threadIdx.x % PANEL;
  const int warps = blockDim.x / PANEL;
  const float* gcp = coef + (size_t)b * 2 * n;
  const float* gmi = gcp + n;
  float* scp = smem;
  float* smi = smem + n;
  float* ring = smem + (COEF_SMEM ? coef_floats(n) : 0) + warp * LANES_RING;
  auto slot_of = [&](int s) { return ring + (s % STAGES) * SLOT; };

  if (COEF_SMEM) {
    for (int i = threadIdx.x; i < 2 * n; i += blockDim.x)
      cp_async4(scp + i, gcp + i);
    cp_async_commit();
  }
  const int r0 = (blockIdx.x * warps + warp) * PANEL;
  const int nrows = min(PANEL, rows - r0);  // the panel's rows in the batch
  const size_t nn = (size_t)n;
  const float* src = rhs + ((size_t)b * rows + r0) * nn;
  float* dst = out + ((size_t)b * rows + r0) * nn;
  const float a = __fmul_rn(-0.5f, c[b]);
  auto cp_at = [&](int i) { return COEF_SMEM ? scp[i] : __ldg(gcp + i); };
  auto mi_at = [&](int i) { return COEF_SMEM ? smi[i] : __ldg(gmi + i); };
  float x[PANEL], y[PANEL];

  // Forward sweep: stage s holds columns [s*32, s*32 + 32).
  const int nf = (n + PANEL - 1) / PANEL;
  auto fwd_cnt = [&](int s) { return s < nf ? min(PANEL, n - s * PANEL) : 0; };
  for (int s = 0; s < STAGES - 1; ++s)
    stage_cols(slot_of(s), src, s * PANEL, fwd_cnt(s), nrows, nn, lane);
  if (COEF_SMEM) {
    // The coefficient group is older than the STAGES-1 stage groups.
    cp_async_wait<STAGES - 1>();
    __syncthreads();
  }
  float prev = 0.0f;
  for (int s = 0; s < nf; ++s) {
    const int t = s + STAGES - 1;
    __syncwarp();  // every lane has stored stage s-1, whose slot t refills
    stage_cols(slot_of(t), src, t * PANEL, fwd_cnt(t), nrows, nn, lane);
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // every lane's copies of stage s have landed
    float* slot = slot_of(s);
    float* mine = slot + lane * SLOT_STRIDE;
    const int col0 = s * PANEL, cnt = fwd_cnt(s);
#pragma unroll
    for (int k = 0; k < PANEL; ++k)
      if (k < cnt) {
        x[k] = mine[k];
        y[k] = mi_at(col0 + k);
      }
    if (col0 >= 1 && col0 + PANEL <= n - 1) {
#pragma unroll
      for (int k = 0; k < PANEL; ++k) {
        prev = __fmul_rn(__fsub_rn(x[k], __fmul_rn(a, prev)), y[k]);
        mine[k] = prev;
      }
    } else {
#pragma unroll
      for (int k = 0; k < PANEL; ++k)
        if (k < cnt) {
          const int i = col0 + k;
          const float ai = (unsigned)(i - 1) < (unsigned)(n - 2) ? a : 0.0f;
          prev = __fmul_rn(__fsub_rn(x[k], __fmul_rn(ai, prev)), y[k]);
          mine[k] = prev;
        }
    }
    __syncwarp();
    store_cols(slot, dst, col0, cnt, nrows, nn, lane);
  }

  // Back substitution over columns n-2 .. 0: stage s holds the aligned
  // group [lo, lo + cnt), lo = (G - s) * 32, G the group of column n-2.
  // It reads what other lanes stored above: order those stores first.
  __threadfence();
  __syncwarp();
  const int G = n >= 2 ? (n - 2) / PANEL : -1;
  const int nbk = G + 1;
  auto back_lo = [&](int s) { return (G - s) * PANEL; };
  auto back_cnt = [&](int s) {
    return s < nbk ? min(PANEL, n - 1 - back_lo(s)) : 0;
  };
  for (int s = 0; s < STAGES - 1; ++s)
    stage_cols(slot_of(s), dst, back_lo(s), back_cnt(s), nrows, nn, lane);
  float next = prev;
  for (int s = 0; s < nbk; ++s) {
    const int t = s + STAGES - 1;
    __syncwarp();
    stage_cols(slot_of(t), dst, back_lo(t), back_cnt(t), nrows, nn, lane);
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    float* slot = slot_of(s);
    float* mine = slot + lane * SLOT_STRIDE;
    const int lo = back_lo(s), cnt = back_cnt(s);
    // register k holds column lo + cnt-1 - k: the chain runs downwards
    if (cnt == PANEL) {
#pragma unroll
      for (int k = 0; k < PANEL; ++k) {
        x[k] = mine[PANEL - 1 - k];
        y[k] = cp_at(lo + PANEL - 1 - k);
      }
#pragma unroll
      for (int k = 0; k < PANEL; ++k) {
        next = __fsub_rn(x[k], __fmul_rn(y[k], next));
        mine[PANEL - 1 - k] = next;
      }
    } else {
#pragma unroll
      for (int k = 0; k < PANEL; ++k)
        if (k < cnt) {
          x[k] = mine[cnt - 1 - k];
          y[k] = cp_at(lo + cnt - 1 - k);
        }
#pragma unroll
      for (int k = 0; k < PANEL; ++k)
        if (k < cnt) {
          next = __fsub_rn(x[k], __fmul_rn(y[k], next));
          mine[cnt - 1 - k] = next;
        }
    }
    __syncwarp();
    store_cols(slot, dst, lo, cnt, nrows, nn, lane);
  }
  cp_async_wait<0>();
}

template <bool COEF_SMEM>
cudaError_t launch_rows(const float* rhs, float* out, const float* c,
                        const float* coef, int nb, int n, int m, int warps,
                        cudaStream_t s) {
  const size_t smem =
      ((COEF_SMEM ? coef_floats(n) : 0) + (size_t)warps * RING) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      k_td_rows<COEF_SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int panels = (m + PANEL - 1) / PANEL;
  const dim3 grid((panels + warps - 1) / warps, nb);
  k_td_rows<COEF_SMEM><<<grid, warps * PANEL, smem, s>>>(rhs, out, c, coef,
                                                         n, m);
  return cudaGetLastError();
}

template <bool COEF_SMEM>
cudaError_t launch_lanes(const float* rhs, float* out, const float* c,
                         const float* coef, int nb, int rows, int n,
                         int warps, cudaStream_t s) {
  const size_t smem =
      ((COEF_SMEM ? coef_floats(n) : 0) + (size_t)warps * LANES_RING) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      k_td_lanes<COEF_SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int panels = (rows + PANEL - 1) / PANEL;
  const dim3 grid((panels + warps - 1) / warps, nb);
  k_td_lanes<COEF_SMEM><<<grid, warps * PANEL, smem, s>>>(rhs, out, c, coef,
                                                          rows, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* heat_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// (cp, mi) of every member: coef is (nb, 2, n).
int heat_td_coeffs(const float* c, float* coef, int nb, int n,
                   void* stream) {
  k_td_coeffs<<<nb, 32, 0, (cudaStream_t)stream>>>(c, coef, nb, n);
  return cudaGetLastError();
}

// Solve along axis 1 of the (nb, n, m) batch with the (nb, 2, n)
// coefficients of heat_td_coeffs: blocks of `warps` panels (1..4), the
// coefficients in shared memory when coef_smem != 0.
int heat_td_rows(const float* rhs, float* out, const float* c,
                 const float* coef, int nb, int n, int m, int warps,
                 int coef_smem, void* stream) {
  if (warps < 1 || warps > 4) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return coef_smem
             ? launch_rows<true>(rhs, out, c, coef, nb, n, m, warps, s)
             : launch_rows<false>(rhs, out, c, coef, nb, n, m, warps, s);
}

// Solve along axis 2 of the (nb, rows, n) batch with the (nb, 2, n)
// coefficients of heat_td_coeffs: blocks of `warps` panels of 32 rows
// (1..4), the coefficients in shared memory when coef_smem != 0.
int heat_td_lanes(const float* rhs, float* out, const float* c,
                  const float* coef, int nb, int rows, int n, int warps,
                  int coef_smem, void* stream) {
  if (warps < 1 || warps > 4) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return coef_smem
             ? launch_lanes<true>(rhs, out, c, coef, nb, rows, n, warps, s)
             : launch_lanes<false>(rhs, out, c, coef, nb, rows, n, warps, s);
}

}  // extern "C"
