// The on-chip resident sweep shared by H4 k_resident (csrc/stencil.cu, a
// one-member batch), H5 k_ens_resident (csrc/ensemble.cu) and H8
// k_fam_resident (csrc/family.cu): every member of a (B, nx, ny) batch
// advances `steps` steps of an operator Op in one cooperative launch, its
// state kept in shared memory from the first step to the last.  The
// schedule is planned on the host and stated in plain PyTorch in
// heat2d_tpu_torch/ops/resident.py (plan_resident, emulate_resident).
//
// What bounds it.  The TPU kernels it replaces keep a member in VMEM for
// all steps; the card's counterpart is the SMs' shared memory (132 x
// 227 KB), not the L2.  A step that reads its neighbours from the L2
// moves 24 bytes (heat5) to 40 bytes (heat9) per cell through it and runs
// at the L2's rate.  Here those bytes move through shared memory (two ext
// planes per tile): tile_steps costs 4 * (2 + 4W) bytes of it per
// cell-step, window_steps 8 + 2W, against 128 bytes per clock and SM.
// Measured on the H100 the step loops are bound by instruction rate and
// latency before that bandwidth (bank-conflicted halo loads cost nothing,
// a longer update costs in proportion); the ring exchange is ~2 us, a
// few percent at the planned K; device memory is read once and written
// once per member for the whole launch, and the L2 carries only the
// rings.
//
// What the design does.  The work unit is a (member, tile) pair, one
// block per SM.  A block loads its tile's ext (centre plus a ring of
// depth H = W * K) once, then per chunk advances it K steps over the
// shrinking region -- by tile_steps (csrc/tile.cuh, the tile sweeps' step
// loop) or by window_steps below, both with the tile sweeps' per-cell
// arithmetic, so results are bitwise theirs -- and exchanges rings: it
// publishes the H-deep border bands of its centre at their global
// coordinates in the exchange plane of the exchange's parity, each cell
// as one 64-bit word that carries the value under the exchange's number,
// and reads its ring back from the plane until every word carries that
// number (0 outside the domain).  A word is trusted by its stamp alone,
// so the exchange needs no flag, fence or barrier, and a pass over the
// ring is one trip to the L2 (the loads are started in batches before the
// first is used).  One exchange per K steps, between neighbours only: no
// barrier spans the grid, and members drift apart freely.  Corners lie in
// the diagonal neighbour's band.  Two planes suffice: a block publishes
// exchange g after refilling from g - 1, which every neighbour had
// published after refilling from g - 2.  A wave is as many whole members
// as the grid holds; a block runs its wave's member for all steps, then
// takes the next wave's, its exchanges counting on.  The cooperative
// launch makes every block co-resident, which the waits need; a wait that
// outlasts SPIN_LIMIT clocks sets the launch's error word, on which every
// waiting block gives up and the wrapper raises (the result is then
// unwritten in part; the context lives on).  Member, tile origin, scalars
// and band rectangles are per-block values: the cell loops have no
// division.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "tile.cuh"

namespace heat {

// Warps of the one block per SM, by how it steps its tile: window_steps
// below (WINDOW) or tile_steps (csrc/tile.cuh).  The wrappers choose the
// loop per operator from the times chip_smoke.py measures for both
// (PERF.md): the window pays where the update is a few instructions a
// cell.
__host__ __device__ constexpr int resident_warps(bool window) {
  return window ? 16 : 32;
}
constexpr int RING_BATCH = 8;  // ring loads a thread keeps in flight
constexpr int PLANE_PAD = 4;   // floats before the first, after the last plane
constexpr long long SPIN_LIMIT = 4000000000LL;  // ~2 s of SM clocks
constexpr long long SPIN_LOOK = 1 << 20;        // ~0.6 ms

// ops/resident.ResidentPlan.as_ctypes, in its order.
struct ResidentPlan {
  int nb, nx, ny;
  int k;        // steps per chunk, between two exchanges
  int ty, tx;   // centre rows and columns per tile
  int gx, gy;   // tile rows and columns per member
  int members;  // members per wave
};

// An exchange word: a cell's value under the number of the exchange that
// published it, one naturally aligned 64-bit access, so a reader sees
// both or neither and needs no fence, flag or barrier to trust the value.
using Word = unsigned long long;

__device__ __forceinline__ void word_store(Word* p, unsigned gen, float v) {
  const Word w = ((Word)gen << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ Word word_load(const Word* p) {
  Word w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

// f(r, c) for every cell of rows [r0, r1) x columns [c0, c1), spread over
// the block's threads (a division per cell: for a wave's load and write
// and the bands, never inside a step).
template <int BY, class F>
__device__ __forceinline__ void for_rect(int r0, int r1, int c0, int c1,
                                         F f) {
  const int w = c1 - c0;
  if (w <= 0 || r1 <= r0) return;
  const int n = (r1 - r0) * w;
  for (int q = threadIdx.y * BLOCK_X + threadIdx.x; q < n;
       q += BLOCK_X * BY) {
    const int r = q / w;
    f(r0 + r, c0 + q - r * w);
  }
}

// One row of a thread's register window: the 4 cells of column group c
// (one 16-byte load) in dst[W .. W+3], the W cells to their left in
// dst[0 .. W-1] and to their right in dst[W+4 ..].  The halo cells are
// scalar loads at a stride of 4 floats between lanes, a 4-way bank
// conflict; taking them from the neighbouring lanes by shuffle instead
// measured slightly slower (PERF.md).
template <int W>
__device__ __forceinline__ void window_row(float* dst,
                                           const float* __restrict__ row,
                                           int c) {
  const float4 v = *reinterpret_cast<const float4*>(row + c);
  dst[W] = v.x, dst[W + 1] = v.y, dst[W + 2] = v.z, dst[W + 3] = v.w;
#pragma unroll
  for (int d = 0; d < W; ++d) {
    dst[d] = row[c - W + d];
    dst[W + 4 + d] = row[c + 4 + d];
  }
}

// f(std::integral_constant<int, 0>) ... f(<N-1>), unrolled.
template <int N, class F>
__device__ __forceinline__ void static_for(F f) {
  if constexpr (N > 0) {
    static_for<N - 1>(f);
    f(std::integral_constant<int, N - 1>{});
  }
}

// nsub steps of the EY x EX ext tile in `cur` (row pitch EXP, a multiple
// of 4; `nxt` a second such tile), whose cell (0, 0) is global cell
// (i0, j0): tile_steps (csrc/tile.cuh) with the same per-cell arithmetic
// and held rule, but each thread owns 4 adjacent columns and marches down
// a run of rows with the (2W+1) x (4+2W) cells around them in registers.
// The window's rows rotate: row r + dr lives in win[(r - r0 + W + dr) %
// (2W+1)], the loop is unrolled 2W+1 rows deep, and Op::apply's offsets
// (row stride RS) decode at compile time, so a new row costs its loads
// and no moves.  A cell-step costs one 16-byte load, 2W scalar loads and
// one 16-byte store per 4 cells: (8 + 2W) bytes of shared memory per cell
// against tile_steps' 4 * (2 + 4W), and a third of its instructions.  A
// warp takes the 128 columns of 32 groups; the region's rows are cut into
// one run per warp; a run whose cells are all updated skips the held
// rule's predicates.  Groups are whole: the cells a group rewrites outside
// step s's region [W*s, E - W*s) (and the pitch's pad columns) are cells
// no valid cell reads later, as in tile_steps, and the loads W cells past
// either end of a row stay inside the planes' 4-float pads.
template <class Op, int BY>
__device__ __forceinline__ void window_steps(float*& cur, float*& nxt,
                                             int i0, int j0, int EY, int EX,
                                             int EXP, int nx, int ny,
                                             const typename Op::Params& k,
                                             int nsub) {
  constexpr int W = Op::W;
  constexpr int RS = 4 + 2 * W;  // window row: W left, 4 centre, W right
  constexpr int NR = 2 * W + 1;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int groups = EXP >> 2;
  for (int s = 1; s <= nsub; ++s) {
    const int lo = W * s;
    const int g_lo = lo >> 2, g_hi = (EX - lo + 3) >> 2;
    const int gw = (g_hi - g_lo + 31) >> 5;  // warps across the region
    const int rows_n = EY - 2 * lo;
    const int per = max(1, BY / gw);  // runs per column of warps
    const int R = (rows_n + per - 1) / per;
    const int runs = (rows_n + R - 1) / R;
    for (int task = warp; task < runs * gw; task += BY) {
      const int run = task / gw;
      const int g = g_lo + (task - run * gw) * 32 + lane;
      const int c = 4 * min(g, groups - 1);  // spare lanes repeat a group
      const int r0 = lo + run * R, r1 = min(r0 + R, EY - lo);
      const bool store = g < g_hi;
      bool col_upd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        col_upd[j] = j0 + c + j >= W && j0 + c + j < ny - W;
      const bool interior =
          i0 + r0 >= W && i0 + r1 - 1 < nx - W &&
          __all_sync(0xffffffffu,
                     col_upd[0] && col_upd[1] && col_upd[2] && col_upd[3]);
      float win[NR][RS];
#pragma unroll
      for (int d = 0; d < 2 * W; ++d)
        window_row<W>(win[d], cur + (r0 - W + d) * EXP, c);
      // Row r at phase P = (r - r0) % NR: rows r - W .. r + W - 1 are in
      // win[P], win[P + 1], ... (mod NR); row r + W goes to win[P - 1].
      auto row_step = [&](auto phase, auto all_updated, int r) {
        constexpr int P = decltype(phase)::value;
        constexpr bool ALL = decltype(all_updated)::value;
        window_row<W>(win[(P + 2 * W) % NR], cur + (r + W) * EXP, c);
        const bool row_upd = ALL || (i0 + r >= W && i0 + r < nx - W);
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          auto ld = [&](int off) {
            const int q = off + W * RS + W;  // >= 0: |off| <= W * RS + W
            return win[(P + q / RS) % NR][q % RS + j];
          };
          o[j] = (ALL || (row_upd && col_upd[j])) ? Op::apply(ld, RS, k)
                                                 : ld(0);
        }
        if (store)
          *reinterpret_cast<float4*>(nxt + r * EXP + c) =
              make_float4(o[0], o[1], o[2], o[3]);
      };
      auto march = [&](auto all_updated) {
        int r = r0;
        for (; r + NR <= r1; r += NR)
          static_for<NR>([&](auto p) {
            row_step(p, all_updated, r + decltype(p)::value);
          });
        static_for<NR - 1>([&](auto p) {
          if (r + decltype(p)::value < r1)
            row_step(p, all_updated, r + decltype(p)::value);
        });
      };
      if (interior)
        march(std::true_type{});
      else
        march(std::false_type{});
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// The sweep of block blockIdx.x.  `params(m)` gives member m's scalars.
// scratch (ops/resident.launch_scratch), zeroed: the launch's error word,
// then the two exchange planes of `members` x nx x ny words (left out when
// the launch never exchanges: one tile a member, or steps <= K); smem: two
// ext tiles.
template <class Op, bool WINDOW, class ParamsOf>
__device__ __forceinline__ void resident_sweep(
    const float* __restrict__ src, float* __restrict__ dst, Word* scratch,
    const ResidentPlan& P, int steps, ParamsOf params, float* smem) {
  constexpr int BY = resident_warps(WINDOW);
  volatile int* err = reinterpret_cast<volatile int*>(scratch);
  Word* xbuf = scratch + 1;
  const int H = Op::W * P.k;
  const int EY = P.ty + 2 * H, EX = P.tx + 2 * H;
  const int EXP = (EX + 3) & ~3;
  const int tiles = P.gx * P.gy;
  const int slot = blockIdx.x / tiles;
  const int tile = blockIdx.x - slot * tiles;
  const int ti = tile / P.gy, tj = tile - ti * P.gy;
  const int i0 = ti * P.ty - H, j0 = tj * P.tx - H;
  const int nx = P.nx, ny = P.ny;
  const size_t plane = (size_t)nx * ny;
  // centre rows and columns inside the domain
  const int rows = min(P.ty, nx - ti * P.ty);
  const int cols = min(P.tx, ny - tj * P.tx);
  const int waves = (P.nb + P.members - 1) / P.members;
  unsigned gen = 0;  // exchanges so far; 0 stamps a word never written

  for (int wave = 0; wave < waves; ++wave) {
    const int m = wave * P.members + slot;
    if (m >= P.nb) return;  // the last wave's spare slots: whole blocks
    const typename Op::Params k = params(m);
    const float* in = src + m * plane;
    float* cur = smem + PLANE_PAD;
    float* nxt = cur + EY * EXP;

    for_rect<BY>(0, EY, 0, EX, [&](int r, int c) {
      const int gi = i0 + r, gj = j0 + c;
      cur[r * EXP + c] = (gi >= 0 && gi < nx && gj >= 0 && gj < ny)
                            ? in[(size_t)gi * ny + gj] : 0.0f;
    });
    __syncthreads();

    for (int done = 0;;) {
      const int n = min(P.k, steps - done);
      // tile_steps takes the pitch for the width: the pad columns are
      // cells of a ring that is 0 to 3 cells deeper on the right.
      if constexpr (WINDOW)
        window_steps<Op, BY>(cur, nxt, i0, j0, EY, EX, EXP, nx, ny, k, n);
      else
        tile_steps<Op, BY>(cur, nxt, i0, j0, EY, EXP, nx, ny, k, n);
      done += n;
      if (done >= steps) break;

      // Exchange `gen`: only the centre is exact now.  Publish its border
      // bands, then read the ring back until every word carries `gen`
      // (whole passes, so the loads of a pass overlap).
      ++gen;
      Word* xp = xbuf + ((gen & 1u) * P.members + slot) * plane;
      auto publish = [&](int r, int c) {
        word_store(xp + (size_t)(i0 + r) * ny + (j0 + c), gen,
                   cur[r * EXP + c]);
      };
      if (ti > 0) for_rect<BY>(H, H + min(H, rows), H, H + cols, publish);
      if (ti < P.gx - 1) for_rect<BY>(P.ty, P.ty + H, H, H + cols, publish);
      if (tj > 0) for_rect<BY>(H, H + rows, H, H + min(H, cols), publish);
      if (tj < P.gy - 1) for_rect<BY>(H, H + rows, P.tx, P.tx + H, publish);
      // The ring in one index space: H rows above and H below the centre
      // (EX wide), then H columns left and H right of it, row by row.  A
      // thread starts the loads of RING_BATCH cells before it uses the
      // first, so a pass costs one trip to the L2, not one per cell.
      const int n_rows = 2 * H * EX, n_ring = n_rows + 2 * H * P.ty;
      const long long t0 = clock64();
      bool dead = false;  // a neighbour's words never came
      for (bool late = true; late && !dead;) {
        late = false;
        for (int q0 = threadIdx.y * BLOCK_X + threadIdx.x; q0 < n_ring;
             q0 += RING_BATCH * BLOCK_X * BY) {
          Word w[RING_BATCH];
          int at[RING_BATCH];
#pragma unroll
          for (int u = 0; u < RING_BATCH; ++u) {
            const int q = q0 + u * BLOCK_X * BY;
            at[u] = -1;
            if (q >= n_ring) continue;
            int r, c;
            if (q < n_rows) {
              r = q / EX, c = q - r * EX;
              if (r >= H) r += P.ty;
            } else {
              r = (q - n_rows) / (2 * H), c = q - n_rows - r * 2 * H;
              r += H;
              if (c >= H) c += P.tx;
            }
            at[u] = r * EXP + c;
            const int gi = i0 + r, gj = j0 + c;
            w[u] = (gi >= 0 && gi < nx && gj >= 0 && gj < ny)
                       ? word_load(xp + (size_t)gi * ny + gj)
                       : (Word)gen << 32;  // outside the domain: 0
          }
#pragma unroll
          for (int u = 0; u < RING_BATCH; ++u) {
            if (at[u] < 0) continue;
            late |= (unsigned)(w[u] >> 32) != gen;
            cur[at[u]] = __uint_as_float((unsigned)w[u]);
          }
        }
        // Late beyond any wait of a healthy launch: look at the error
        // word (no sooner: the look is a trip to the L2 on the way to the
        // next pass).
        if (late && clock64() - t0 > SPIN_LOOK) {
          if (clock64() - t0 > SPIN_LIMIT) *err = 1;
          dead = *err != 0;
        }
      }
      if (__syncthreads_or(dead)) return;
    }

    float* out = dst + m * plane;
    for_rect<BY>(H, H + rows, H, H + cols, [&](int r, int c) {
      out[(size_t)(i0 + r) * ny + (j0 + c)] = cur[r * EXP + c];
    });
    __syncthreads();  // the next wave's load overwrites this tile
  }
}

// Dynamic shared memory of one block: two ext planes at a pitch of whole
// column groups, and a pad at either end (ops/resident.ResidentPlan
// .smem_bytes).
inline size_t resident_smem_bytes(int EY, int EX) {
  return (2 * (size_t)EY * ((EX + 3) & ~3) + 2 * PLANE_PAD) * sizeof(float);
}

// Host side: the plan from its int array, and the cooperative launch of
// `kernel` (whose parameters `args` point to) on the plan's grid.
inline ResidentPlan resident_plan(const int* p) {
  return ResidentPlan{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
}

template <class Op, bool WINDOW, class Kernel>
cudaError_t launch_resident(Kernel kernel, void** args,
                            const ResidentPlan& P, cudaStream_t stream) {
  const int H = Op::W * P.k;
  const size_t smem = resident_smem_bytes(P.ty + 2 * H, P.tx + 2 * H);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  // Refused with cudaErrorCooperativeLaunchTooLarge unless every block is
  // co-resident at this block size and shared memory.
  e = cudaLaunchCooperativeKernel((const void*)kernel,
                                  dim3(P.members * P.gx * P.gy),
                                  dim3(BLOCK_X, resident_warps(WINDOW)),
                                  args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace heat
