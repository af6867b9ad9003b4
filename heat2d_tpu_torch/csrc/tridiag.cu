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
//                     system a lane, 128-byte coalesced rows); where the
//                     batch has fewer panels than SMs, a segment of its
//                     rows (the split, below).
//   H11 k_td_lanes <- _tridiag_lanes_kernel (TD, tridiag.py:349): solve
//                     along axis 2 of a (B, rows, n) batch.  One warp takes
//                     a panel of 32 adjacent rows of one member (one system
//                     a lane): H10's design with the tile transposed in
//                     shared memory (below).
//
// Each solve kernel has a second build, RHS (a template argument, as H3
// is the RESID build of k_tile): one whole half of a Peaceman-Rachford
// ADI step in one launch.  It reads the step's grid u and forms each
// unknown's right-hand side as it stages it, ctr + h*((u[+1] + u[-1]) -
// 2*ctr) along the other axis with h = sc/2, every operation rounded on
// its own in the order of the port's _rhs_half (the JAX package runs it
// as XLA ops around TD), and its stores hold the four edges of u
// (_hold_edges).  The x half runs through H10, whose stencil runs across
// a staged row: a second warp a panel, the producer, stages u with the
// panel's two outer columns and hands the solving warp each stage's
// right-hand side (below).  The y half runs through H11, whose slots also
// stage the row above and the row below the panel.  The chain, the back
// sweep and the stores are the plain build's, so a half equals
// _hold_edges(solve(_rhs_half(u)), u) bit for bit; the torch ops that
// did the same around the solves read and wrote the grid ~10 times a
// half, in ~10 launches.
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
// The RHS builds.  H10's solving warp waits on its own chain (unsplit, at
// the ADI path's sizes, alone on its SM: 2048 columns are 64 panels on
// 132 SMs), so whatever else it issues lengthens the sweep: forming the
// right-hand side in that warp cost a third of H10's time again (its
// neighbours read from ring rows of 34 columns; more with shuffles and
// two halo columns), handing it to a producer warp a sixth, with the
// producer's ring at RAW_STAGES = 2 slots (4 and 8 timed slower:
// PERF.md).  The producer and the solving warp share slots 0 and 1 of
// the solving warp's ring in the forward sweep, which stages nothing
// itself; the back sweep is the plain build's.  H11 forms the right-hand
// side in its own warp: its rows lie across the tile it stages anyway.
//
// The split (H10's SPLIT builds, a template argument as RHS is).  A batch of
// fewer panels than the card has SMs leaves most SMs empty, and each busy
// one runs one latency-bound chain of n rows.  So the planner may cut each
// panel's systems into segments of seg_rows rows, a block each (one solving
// warp, and in the RHS build its producer), every block resident at once (a
// cooperative launch).  Both sweeps are first-order recurrences that
// contract by |cp| (0.67-0.82 a row at c = 12.5-50) once (cp, mi) have
// reached their fixed point, so a chain started from a guess lands, W rows
// on, on the sequential chain's bits, and from there computes exactly its
// values.  A segment therefore starts its forward sweep W rows early from 0,
// stores only its own rows, and then checks its value at the row before its
// first against the verified last d that the segment before publishes; its
// back sweep starts W rows past its last row (from 0, or from d[n-1] where
// that row is nearer) over the next segment's verified d, and checks its
// value at the next segment's first row against the x that segment
// publishes.  A lane whose check fails replays its rows from the verified
// value (the back sweep by running its forward again: the back sweep has
// stored over its d), so every stored bit is the unsplit sweep's, whatever
// W is; W sets only how often that happens.  W is the least multiple of 32
// rows with |cp|^W <= 2^-warm_bits (the member's fixed-point cp, products
// rounded as float32), at most WARM_MAX_STAGES stages and one segment.
//
// The joins: lane l of a segment publishes each value as one 64-bit word
// (the launch's epoch in the high half, the float's bits in the low half),
// stored with release semantics after the lane's own stores of column l;
// lane l of the neighbour spins on that word with acquire loads.  Every
// lane reads and writes only its own column, so the lanes pair up and no
// warp-wide fence is needed.  Per segment: F, its last d (its rows' d are
// final); R, it has staged what it reads of the next segment's rows, which
// that segment then may overwrite; B, its first x.  The waits run one way
// in each sweep (F up, B down; R after F), so with every block resident
// none can wait on itself.  The epoch grows with every launch on a join
// buffer, so the buffer is zeroed once, not before each launch.  A warp in
// which a live lane replayed adds 1 to the buffer's replay word.
//
// Every entry point returns a cudaError_t (0 on success); the Python
// wrapper raises on anything else.

#include <cuda_runtime.h>

#include <type_traits>

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
// The RHS builds' wider rings: H10's producer warp's ring of RAW_STAGES
// slots of rows of 34 columns (the panel's and the two beside it) beside
// the solving warp's, H11's slots of 34 rows.
constexpr int RAW_STAGES = 2;
constexpr int RAW_ROW = PANEL + 2;
constexpr int RAW_RING = RAW_STAGES * STAGE_ROWS * RAW_ROW;
constexpr int SLOT_RHS = (PANEL + 2) * SLOT_STRIDE;

// The split's join buffer (unsigned 64-bit words): SYNC_HEAD words, the
// first the replay count, then JOIN words a segment (F, R and B, a word a
// lane), segments of a panel in order, panels of a member in order.
constexpr int SYNC_HEAD = 32;
constexpr int JOIN = 3 * PANEL;
// The warm-up's longest: 8 stages of 32 rows.
constexpr int WARM_MAX_STAGES = 8;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int rows_ring(bool rhs) {
  return RING + (rhs ? RAW_RING : 0);
}
__host__ __device__ constexpr int lanes_slot(bool rhs) {
  return rhs ? SLOT_RHS : SLOT;
}

// An ADI half's right-hand side at one unknown: ctr + h*((p + q) - 2*ctr),
// every operation rounded on its own, in _rhs_half's order.
__device__ __forceinline__ float half_rhs(float ctr, float p, float q,
                                          float h) {
  return __fadd_rn(
      ctr, __fmul_rn(h, __fsub_rn(__fadd_rn(p, q), __fmul_rn(2.0f, ctr))));
}

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
// slot[k * w + lane] (a ring row of w floats), each lane its own column.
// `side` (the RHS build's forward sweep): lane 0 also copies the column
// left of the panel to slot[k * w - 1] (bit 0) and lane 31 the column
// right of it to slot[k * w + 32] (bit 1), where the batch has them.  The
// group is committed in every lane, empty or not, so the group count
// stays the same in all of them.
__device__ __forceinline__ void stage_in(float* slot, int w,
                                         const float* col0, int row0,
                                         int dir, int cnt, size_t m,
                                         int lane, int cols, int side = 0) {
  // a halo lane's second column (lane 31 has one only in a whole panel,
  // so both are < cols)
  const bool left = lane == 0 && (side & 1);
  const int off = left ? -1 : 1;
  const bool two = left || (lane == PANEL - 1 && (side & 2));
  if (lane < cols) {
    for (int k = 0; k < cnt; ++k) {
      const float* from = col0 + lane + (size_t)(row0 + dir * k) * m;
      cp_async4(slot + k * w + lane, from);
      if (two) cp_async4(slot + k * w + lane + off, from + off);
    }
  }
  cp_async_commit();
}

// A join word: the epoch over a float's bits, stored with release
// semantics (the lane's earlier stores are visible before it).
__device__ __forceinline__ void join_put(unsigned long long* w,
                                         unsigned epoch, float v) {
  const unsigned long long x =
      ((unsigned long long)epoch << 32) | __float_as_uint(v);
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(w), "l"(x)
               : "memory");
}

// The float of join word `w` once it carries this launch's epoch.  A wait
// that has not ended after ~2^26 polls (seconds; a launch takes a
// millisecond) traps, so that a fault in the joins fails the launch instead
// of hanging the card.
__device__ __forceinline__ float join_get(const unsigned long long* w,
                                          unsigned epoch) {
  unsigned long long x;
  for (unsigned polls = 0;; ++polls) {
    asm volatile("ld.acquire.gpu.global.b64 %0, [%1];"
                 : "=l"(x)
                 : "l"(w)
                 : "memory");
    if ((unsigned)(x >> 32) == epoch) break;
    if (polls >= (1u << 26)) __trap();
    __nanosleep(64);
  }
  return __uint_as_float((unsigned)x);
}

// The warm-up W: the least multiple of 32 rows with |cp|^W <= 2^-bits, by
// float32 products (|cp|^32 by five squarings), at most WARM_MAX_STAGES
// stages; 0 rows at bits <= 0.  ops/tridiag.py's warm_rows repeats it.
__device__ __forceinline__ int warm_rows(float cp, int bits) {
  if (bits <= 0) return 0;
  float q = fabsf(cp);
  for (int i = 0; i < 5; ++i) q = __fmul_rn(q, q);
  const float goal = ldexpf(1.0f, -bits);
  float pw = 1.0f;
  int k = 0;
  while (k < WARM_MAX_STAGES && pw > goal) {
    pw = __fmul_rn(pw, q);
    ++k;
  }
  return k * STAGE_ROWS;
}

// The two warps of an RHS panel meet at named barrier 1 + panel.
__device__ __forceinline__ void pair_sync(int panel) {
  asm volatile("bar.sync %0, 64;" ::"r"(1 + panel) : "memory");
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
// RHS: `rhs` is the step's grid u, and each panel has a second warp, its
// producer (warps w + `warps` of the block), for the forward sweep.  The
// solving warp's chain is latency-bound and alone on its SM at the ADI
// path's sizes, so whatever it issues besides lengthens it; the producer
// instead stages u through a ring of its own, RAW_STAGES slots of rows of
// 34 columns (the panel's at 1..32 and the two beside it at 0 and 33,
// where the batch has them), forms each row's right-hand side along the
// columns at h = sc[b]/2 (a __syncwarp after the copies land: a lane
// reads its neighbours' columns), and writes it into slot s % 2 of the
// solving warp's ring while the solving warp runs stage s - 1's chain;
// the two meet at a named barrier once a stage.  An unknown on an edge of
// the grid keeps u's value, and so does its store in both sweeps, while
// its lane's chain runs on as in the plain build.
// SPLIT: one panel a block (warps = 1), block x = panel * nseg + segment;
// the segment's rows and its joins as the header says, through `sync`
// (the join buffer) at this launch's `epoch`.
template <bool COEF_SMEM, bool RHS, bool SPLIT>
__global__ void __launch_bounds__(RHS ? 256 : 128) k_td_rows(
    const float* __restrict__ rhs, float* __restrict__ out,
    const float* __restrict__ c, const float* __restrict__ sc,
    const float* __restrict__ coef, int n, int m,
    unsigned long long* __restrict__ sync, int seg_rows, int warm_bits,
    unsigned epoch) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int lane = threadIdx.x % PANEL;
  const int warps = blockDim.x / PANEL / (RHS ? 2 : 1);  // panels a block
  const bool producer = RHS && (int)threadIdx.x >= warps * PANEL;
  const int warp = threadIdx.x / PANEL - (producer ? warps : 0);  // panel
  const float* gcp = coef + (size_t)b * 2 * n;
  const float* gmi = gcp + n;
  float* scp = smem;
  float* smi = smem + n;
  // the warp's ring: slot s, row k, column l at [(s*R + k)*32 + l], 16-byte
  // aligned after the coefficients; RHS: the producers' rings after all
  float* rings = smem + (COEF_SMEM ? coef_floats(n) : 0);
  float* ring = rings + warp * RING;
  auto slot_of = [&](int s) {
    return ring + (s % STAGES) * STAGE_ROWS * PANEL;
  };

  if (COEF_SMEM) {
    for (int i = threadIdx.x; i < 2 * n; i += blockDim.x)
      cp_async4(scp + i, gcp + i);
    cp_async_commit();
    if (RHS) {
      // the two roles count their groups apart: the coefficients first
      cp_async_wait<0>();
      __syncthreads();
    }
  }
  // SPLIT: segment `seg` of nseg owns rows [own_lo, own_hi) and runs its
  // forward sweep from lo, W rows earlier (its warm-up)
  const int nseg = SPLIT ? (n + seg_rows - 1) / seg_rows : 1;
  const int seg = SPLIT ? (int)blockIdx.x % nseg : 0;
  const int group = SPLIT ? (int)blockIdx.x / nseg : (int)blockIdx.x;
  const int W = SPLIT ? min(seg_rows, warm_rows(__ldg(gcp + max(n - 2, 0)),
                                                warm_bits))
                      : 0;
  const int own_lo = seg * seg_rows;
  const int own_hi = SPLIT ? min(n, own_lo + seg_rows) : n;
  const int lo = max(0, own_lo - W);
  const int j0 = (group * warps + warp) * PANEL;
  const int cols = min(PANEL, m - j0);  // the panel's columns in the batch
  const bool valid = lane < cols;
  const size_t mm = (size_t)m;
  const float* src = rhs + (size_t)b * n * m + j0;
  float* dst = out + (size_t)b * n * m + j0;
  const float a = __fmul_rn(-0.5f, c[b]);
  const float h = RHS ? __fmul_rn(0.5f, sc[b]) : 0.0f;
  // RHS: the lane's column is inside the grid's edges
  const bool inner_col = (unsigned)(j0 + lane - 1) < (unsigned)(m - 2);
  auto cp_at = [&](int i) { return COEF_SMEM ? scp[i] : __ldg(gcp + i); };
  auto mi_at = [&](int i) { return COEF_SMEM ? smi[i] : __ldg(gmi + i); };
  auto inner_row = [&](int i) { return (unsigned)(i - 1) < (unsigned)(n - 2); };

  // Forward sweep: stage s holds rows [lo + s*R, lo + s*R + R).
  const int nf = (own_hi - lo + STAGE_ROWS - 1) / STAGE_ROWS;
  auto fwd_cnt = [&](int s) {
    return s < nf ? min(STAGE_ROWS, own_hi - lo - s * STAGE_ROWS) : 0;
  };

  if (producer) {
    float* raw = rings + warps * RING + warp * RAW_RING;
    auto raw_of = [&](int s) {
      return raw + (s % RAW_STAGES) * STAGE_ROWS * RAW_ROW + 1;
    };
    // the halo columns the panel has (left of column 0, right of 31)
    const int side = (j0 > 0) | ((j0 + PANEL < m) << 1);
    auto raw_stage = [&](int s) {
      stage_in(raw_of(s), RAW_ROW, src, lo + s * STAGE_ROWS, 1, fwd_cnt(s),
               mm, lane, cols, side);
    };
    for (int s = 0; s < RAW_STAGES - 1; ++s) raw_stage(s);
    for (int s = 0; s < nf; ++s) {
      // slot s-1 refills: every lane read it before the last pair_sync
      raw_stage(s + RAW_STAGES - 1);
      cp_async_wait<RAW_STAGES - 1>();
      __syncwarp();  // every lane's copies of stage s have landed
      const float* from = raw_of(s) + lane;
      float* to = slot_of(s % 2) + lane;
      const int row0 = lo + s * STAGE_ROWS;
      // straight-line over the whole slot (rows past the stage's count
      // compute on stale values that nothing reads)
#pragma unroll
      for (int k = 0; k < STAGE_ROWS; ++k) {
        const float ctr = from[k * RAW_ROW];
        const float r = half_rhs(ctr, from[k * RAW_ROW + 1],
                                 from[k * RAW_ROW - 1], h);
        to[k * PANEL] = inner_col && inner_row(row0 + k) ? r : ctr;
      }
      pair_sync(warp);  // stage s is in slot s % 2
    }
    cp_async_wait<0>();
    return;
  }

  // SPLIT's replays, lane by lane from device memory: the right-hand side
  // of row i as the stages form it; the forward sweep over the segment's
  // rows from the d before them (returns the last d); the back sweep over
  // them from the x after them, on the d just stored (returns the first x).
  auto rhs_at = [&](int i) {
    const float* p = src + lane + (size_t)i * mm;
    const float ctr = p[0];
    return RHS && inner_col && inner_row(i) ? half_rhs(ctr, p[1], p[-1], h)
                                            : ctr;
  };
  auto replay_fwd = [&](float d) {
    for (int i = own_lo; i < own_hi; ++i) {
      const float xi = rhs_at(i);
      d = __fmul_rn(__fsub_rn(xi, __fmul_rn(inner_row(i) ? a : 0.0f, d)),
                    mi_at(i));
      dst[lane + (size_t)i * mm] =
          RHS && !(inner_col && inner_row(i)) ? xi : d;
    }
    return d;
  };
  auto replay_back = [&](float x) {
    for (int i = own_hi - 1; i >= own_lo; --i) {
      float* p = dst + lane + (size_t)i * mm;
      const float d = *p;
      x = __fsub_rn(d, __fmul_rn(cp_at(i), x));
      *p = RHS && !(inner_col && i >= 1) ? d : x;
    }
    return x;
  };
  // this segment's joins (F, R, B words: + 0, + PANEL, + 2 * PANEL)
  unsigned long long* join =
      SPLIT ? sync + SYNC_HEAD +
                  ((size_t)(b * (gridDim.x / nseg) + group) * nseg + seg) *
                      JOIN
            : nullptr;
  // a live lane's value is checked (an edge lane of the RHS build stores
  // u's values, whatever its chain holds)
  const bool live = valid && (!RHS || inner_col);
  auto count_replay = [&](bool miss) {
    if (__any_sync(FULL, miss) && lane == 0) atomicAdd(sync, 1ull);
  };

  float x[STAGE_ROWS], y[STAGE_ROWS];
  if (!RHS) {
    for (int s = 0; s < STAGES - 1; ++s)
      stage_in(slot_of(s), PANEL, src, lo + s * STAGE_ROWS, 1, fwd_cnt(s),
               mm, lane, cols);
    if (COEF_SMEM) {
      // The coefficient group is older than the STAGES-1 stage groups.
      cp_async_wait<STAGES - 1>();
      __syncthreads();
    }
  }
  float prev = 0.0f;
  float spec = 0.0f;  // SPLIT: the chain's d at row own_lo - 1
  for (int s = 0; s < nf; ++s) {
    const float* slot;
    if (RHS) {
      pair_sync(warp);  // the producer has written stage s
      slot = slot_of(s % 2) + lane;
    } else {
      const int t = s + STAGES - 1;
      stage_in(slot_of(t), PANEL, src, lo + t * STAGE_ROWS, 1, fwd_cnt(t),
               mm, lane, cols);
      cp_async_wait<STAGES - 1>();
      slot = slot_of(s) + lane;
    }
    const int row0 = lo + s * STAGE_ROWS, cnt = fwd_cnt(s);
    if (SPLIT && row0 == own_lo) spec = prev;
    // a warm-up stage (rows before own_lo) stores nothing
    const bool keep = valid && (!SPLIT || row0 >= own_lo);
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
        if (keep) o[k * mm] = RHS && !inner_col ? x[k] : prev;
      }
    } else {
#pragma unroll
      for (int k = 0; k < STAGE_ROWS; ++k)
        if (k < cnt) {
          const int i = row0 + k;
          const float ai = inner_row(i) ? a : 0.0f;
          prev = __fmul_rn(__fsub_rn(x[k], __fmul_rn(ai, prev)), y[k]);
          if (keep)
            o[k * mm] = RHS && !(inner_col && inner_row(i)) ? x[k] : prev;
        }
    }
  }

  // SPLIT: the forward join.  carry is the verified d at row own_lo - 1.
  float carry = 0.0f;
  if (SPLIT) {
    if (seg > 0) {
      if (valid) carry = join_get(join - JOIN + lane, epoch);
      const bool miss =
          live && __float_as_uint(carry) != __float_as_uint(spec);
      count_replay(miss);
      if (miss) prev = replay_fwd(carry);
    }
    if (valid) join_put(join + lane, epoch, prev);
  }

  // Back substitution: stage s holds rows top - s*R down to top - (s+1)*R
  // + 1 (top = n-2 unsplit; a segment's chain runs down to own_lo).
  // It reads what the warp stored above: order those stores first.
  __threadfence();
  const bool last = !SPLIT || seg == nseg - 1;
  // SPLIT: the chain starts from d[n-1] (exactly) where its warm-up
  // reaches row n-1, else from 0 at row own_hi + W
  const bool exact = !SPLIT || own_hi + W >= n;
  const int top = SPLIT ? min(own_hi + W, n - 1) - 1 : n - 2;
  float next = prev;
  if (SPLIT && !last) {
    next = 0.0f;
    if (valid) {
      (void)join_get(join + JOIN + lane, epoch);  // the next rows' d is final
      if (exact) next = __ldcg(dst + lane + (size_t)(n - 1) * mm);
    }
  }
  const int nbk = (top - own_lo + 1 + STAGE_ROWS - 1) / STAGE_ROWS;
  auto back_cnt = [&](int s) {
    return s < nbk ? min(STAGE_ROWS, top - own_lo + 1 - s * STAGE_ROWS) : 0;
  };
  // SPLIT: R goes out once the stage holding row own_hi has landed (before
  // the loop when the warm-up reads no row)
  const int s_read =
      SPLIT && !last && top >= own_hi ? (top - own_hi) / STAGE_ROWS : -1;
  if (SPLIT && !last && s_read < 0 && valid)
    join_put(join + PANEL + lane, epoch, 0.0f);
  // SPLIT: the segment before has staged its warm-up's rows of this one
  bool freed = !SPLIT || seg == 0;
  // SPLIT: the chain's x at row own_hi (its start where no row precedes)
  float xs = next;
  for (int s = 0; s < STAGES - 1; ++s)
    stage_in(slot_of(s), PANEL, dst, top - s * STAGE_ROWS, -1, back_cnt(s),
             mm, lane, cols);
  for (int s = 0; s < nbk; ++s) {
    const int t = s + STAGES - 1;
    stage_in(slot_of(t), PANEL, dst, top - t * STAGE_ROWS, -1, back_cnt(t),
             mm, lane, cols);
    cp_async_wait<STAGES - 1>();
    if (SPLIT && s == s_read && valid)
      join_put(join + PANEL + lane, epoch, 0.0f);
    const float* slot = slot_of(s) + lane;
    const int hi = top - s * STAGE_ROWS, cnt = back_cnt(s);
    if (SPLIT && !freed && hi - cnt + 1 < own_lo + W) {
      if (valid) (void)join_get(join - JOIN + PANEL + lane, epoch);
      freed = true;
    }
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
        if (SPLIT && hi - k == own_hi) xs = next;
        // RHS: an edge unknown keeps what the forward sweep stored (u's)
        if (valid && (!SPLIT || hi - k < own_hi))
          o[-(ptrdiff_t)(k * mm)] =
              RHS && !(inner_col && hi - k >= 1) ? x[k] : next;
      }
  }
  // SPLIT: the back join against the next segment's first x
  if (SPLIT && !last) {
    float xt = 0.0f;
    if (valid) xt = join_get(join + JOIN + 2 * PANEL + lane, epoch);
    const bool miss = live && __float_as_uint(xt) != __float_as_uint(xs);
    count_replay(miss);
    if (miss) {
      replay_fwd(seg > 0 ? carry : 0.0f);
      next = replay_back(xt);
    }
  }
  if (SPLIT && seg > 0 && valid)
    join_put(join + 2 * PANEL + lane, epoch, next);
  cp_async_wait<0>();
}

// One H11 stage: columns [col0, col0 + cnt) of the panel's rows k in
// [lo, hi) (row stride n, row 0 at `rows`; lo is -1 where the RHS build
// stages the row above the panel) into `slot`, lane l copying column
// col0 + l of every row to slot[k * SLOT_STRIDE + l]: one 128-byte row
// segment a warp instruction.  Committed in every lane, as stage_in.
__device__ __forceinline__ void stage_cols(float* slot, const float* rows,
                                           int col0, int cnt, int lo, int hi,
                                           size_t n, int lane) {
  if (lane < cnt) {
    for (int k = lo; k < hi; ++k)
      cp_async4(slot + k * SLOT_STRIDE + lane,
                rows + (ptrdiff_t)k * (ptrdiff_t)n + col0 + lane);
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
// RHS: `rhs` is the step's grid u; a slot holds 34 rows, the panel's at
// slot rows 1..32 and the rows above and below it at 0 and 33 (where the
// batch has them), and the gather forms each column's right-hand side
// along the rows at h = sc[b]/2 before the chain writes its results over
// the lane's row (a __syncwarp between: the lanes beside read it).  Edge
// unknowns keep u's value, as in H10.
template <bool COEF_SMEM, bool RHS>
__global__ void __launch_bounds__(128) k_td_lanes(
    const float* __restrict__ rhs, float* __restrict__ out,
    const float* __restrict__ c, const float* __restrict__ sc,
    const float* __restrict__ coef, int rows, int n) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / PANEL, lane = threadIdx.x % PANEL;
  const int warps = blockDim.x / PANEL;
  const float* gcp = coef + (size_t)b * 2 * n;
  const float* gmi = gcp + n;
  float* scp = smem;
  float* smi = smem + n;
  float* ring = smem + (COEF_SMEM ? coef_floats(n) : 0) +
                warp * STAGES * lanes_slot(RHS);
  // slot s's panel row 0 (its first row in the plain build, its second in
  // the RHS build)
  auto slot_of = [&](int s) {
    return ring + (s % STAGES) * lanes_slot(RHS) + (RHS ? SLOT_STRIDE : 0);
  };

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
  const float h = RHS ? __fmul_rn(0.5f, sc[b]) : 0.0f;
  // RHS: the lane's row is inside the grid's edges; the rows staged
  const bool inner_row = (unsigned)(r0 + lane - 1) < (unsigned)(rows - 2);
  const int lo = RHS && r0 > 0 ? -1 : 0;
  const int hi = RHS ? min(nrows + 1, rows - r0) : nrows;
  auto cp_at = [&](int i) { return COEF_SMEM ? scp[i] : __ldg(gcp + i); };
  auto mi_at = [&](int i) { return COEF_SMEM ? smi[i] : __ldg(gmi + i); };
  auto inner_col = [&](int i) { return (unsigned)(i - 1) < (unsigned)(n - 2); };
  float x[PANEL] = {}, y[PANEL];

  // Forward sweep: stage s holds columns [s*32, s*32 + 32).
  const int nf = (n + PANEL - 1) / PANEL;
  auto fwd_cnt = [&](int s) { return s < nf ? min(PANEL, n - s * PANEL) : 0; };
  for (int s = 0; s < STAGES - 1; ++s)
    stage_cols(slot_of(s), src, s * PANEL, fwd_cnt(s), lo, hi, nn, lane);
  if (COEF_SMEM) {
    // The coefficient group is older than the STAGES-1 stage groups.
    cp_async_wait<STAGES - 1>();
    __syncthreads();
  }
  float prev = 0.0f;
  for (int s = 0; s < nf; ++s) {
    const int t = s + STAGES - 1;
    __syncwarp();  // every lane has stored stage s-1, whose slot t refills
    stage_cols(slot_of(t), src, t * PANEL, fwd_cnt(t), lo, hi, nn, lane);
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // every lane's copies of stage s have landed
    float* slot = slot_of(s);
    float* mine = slot + lane * SLOT_STRIDE;
    const int col0 = s * PANEL, cnt = fwd_cnt(s);
    const bool interior = col0 >= 1 && col0 + PANEL <= n - 1;
#pragma unroll
    for (int k = 0; k < PANEL; ++k)
      if (k < cnt) {
        x[k] = mine[k];
        y[k] = mi_at(col0 + k);
      }
    if (RHS) {
      // straight-line over the whole tile, as in H10 (columns past cnt
      // and rows outside the batch compute on values nothing reads)
#pragma unroll
      for (int k = 0; k < PANEL; ++k) {
        const float r = half_rhs(x[k], mine[k + SLOT_STRIDE],
                                 mine[k - SLOT_STRIDE], h);
        x[k] = inner_row && (interior || inner_col(col0 + k)) ? r : x[k];
      }
      __syncwarp();  // the lanes beside have read this lane's row
    }
    if (interior) {
#pragma unroll
      for (int k = 0; k < PANEL; ++k) {
        prev = __fmul_rn(__fsub_rn(x[k], __fmul_rn(a, prev)), y[k]);
        mine[k] = RHS && !inner_row ? x[k] : prev;
      }
    } else {
#pragma unroll
      for (int k = 0; k < PANEL; ++k)
        if (k < cnt) {
          const int i = col0 + k;
          const float ai = inner_col(i) ? a : 0.0f;
          prev = __fmul_rn(__fsub_rn(x[k], __fmul_rn(ai, prev)), y[k]);
          mine[k] = RHS && !(inner_row && inner_col(i)) ? x[k] : prev;
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
    stage_cols(slot_of(s), dst, back_lo(s), back_cnt(s), 0, nrows, nn, lane);
  float next = prev;
  for (int s = 0; s < nbk; ++s) {
    const int t = s + STAGES - 1;
    __syncwarp();
    stage_cols(slot_of(t), dst, back_lo(t), back_cnt(t), 0, nrows, nn, lane);
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    float* slot = slot_of(s);
    float* mine = slot + lane * SLOT_STRIDE;
    const int c0 = back_lo(s), cnt = back_cnt(s);
    // RHS: an edge unknown keeps what the forward sweep stored (u's)
    auto held = [&](int i) { return RHS && !(inner_row && i >= 1); };
    // register k holds column c0 + cnt-1 - k: the chain runs downwards
    if (cnt == PANEL) {
#pragma unroll
      for (int k = 0; k < PANEL; ++k) {
        x[k] = mine[PANEL - 1 - k];
        y[k] = cp_at(c0 + PANEL - 1 - k);
      }
#pragma unroll
      for (int k = 0; k < PANEL; ++k) {
        next = __fsub_rn(x[k], __fmul_rn(y[k], next));
        mine[PANEL - 1 - k] = held(c0 + PANEL - 1 - k) ? x[k] : next;
      }
    } else {
#pragma unroll
      for (int k = 0; k < PANEL; ++k)
        if (k < cnt) {
          x[k] = mine[cnt - 1 - k];
          y[k] = cp_at(c0 + cnt - 1 - k);
        }
#pragma unroll
      for (int k = 0; k < PANEL; ++k)
        if (k < cnt) {
          next = __fsub_rn(x[k], __fmul_rn(y[k], next));
          mine[cnt - 1 - k] = held(c0 + cnt - 1 - k) ? x[k] : next;
        }
    }
    __syncwarp();
    store_cols(slot, dst, c0, cnt, nrows, nn, lane);
  }
  cp_async_wait<0>();
}

template <bool COEF_SMEM, bool RHS>
cudaError_t launch_rows(const float* rhs, float* out, const float* c,
                        const float* sc, const float* coef, int nb, int n,
                        int m, int warps, cudaStream_t s) {
  const size_t smem =
      ((COEF_SMEM ? coef_floats(n) : 0) + (size_t)warps * rows_ring(RHS)) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      k_td_rows<COEF_SMEM, RHS, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int panels = (m + PANEL - 1) / PANEL;
  const dim3 grid((panels + warps - 1) / warps, nb);
  k_td_rows<COEF_SMEM, RHS, false>
      <<<grid, warps * PANEL * (RHS ? 2 : 1), smem, s>>>(
          rhs, out, c, sc, coef, n, m, nullptr, 0, 0, 0u);
  return cudaGetLastError();
}

// H10's split launch: a block (one panel, one segment of seg_rows rows) per
// grid x index panel * nseg + segment, every block resident at once.
template <bool COEF_SMEM, bool RHS>
cudaError_t launch_rows_split(const float* rhs, float* out, const float* c,
                              const float* sc, const float* coef,
                              unsigned long long* sync, int nb, int n, int m,
                              int seg_rows, int warm_bits, unsigned epoch,
                              cudaStream_t s) {
  const auto kernel = k_td_rows<COEF_SMEM, RHS, true>;
  const size_t smem =
      ((COEF_SMEM ? coef_floats(n) : 0) + (size_t)rows_ring(RHS)) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int panels = (m + PANEL - 1) / PANEL;
  const int nseg = (n + seg_rows - 1) / seg_rows;
  void* args[] = {&rhs, &out,  &c,        &sc,        &coef, &n,
                  &m,   &sync, &seg_rows, &warm_bits, &epoch};
  // Refused with cudaErrorCooperativeLaunchTooLarge unless every block is
  // co-resident, so that no join can wait on a block that never runs.
  e = cudaLaunchCooperativeKernel((const void*)kernel,
                                  dim3(panels * nseg, nb),
                                  dim3(PANEL * (RHS ? 2 : 1)), args, smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool COEF_SMEM, bool RHS>
cudaError_t launch_lanes(const float* rhs, float* out, const float* c,
                         const float* sc, const float* coef, int nb,
                         int rows, int n, int warps, cudaStream_t s) {
  const size_t smem = ((COEF_SMEM ? coef_floats(n) : 0) +
                       (size_t)warps * STAGES * lanes_slot(RHS)) *
                      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      k_td_lanes<COEF_SMEM, RHS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int panels = (rows + PANEL - 1) / PANEL;
  const dim3 grid((panels + warps - 1) / warps, nb);
  k_td_lanes<COEF_SMEM, RHS><<<grid, warps * PANEL, smem, s>>>(
      rhs, out, c, sc, coef, rows, n);
  return cudaGetLastError();
}

// Either solve kernel's four builds, from the entry points' arguments: the
// RHS build where `sc` (the stencil's diffusion numbers) is given.
template <bool LANES>
int launch(const float* rhs, float* out, const float* c, const float* sc,
           const float* coef, int nb, int n1, int n2, int warps,
           int coef_smem, void* stream) {
  if (warps < 1 || warps > 4) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto go = [&](auto cs, auto rhs_build) {
    constexpr bool CS = decltype(cs)::value, R = decltype(rhs_build)::value;
    return LANES ? launch_lanes<CS, R>(rhs, out, c, sc, coef, nb, n1, n2,
                                       warps, s)
                 : launch_rows<CS, R>(rhs, out, c, sc, coef, nb, n1, n2,
                                      warps, s);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (sc != nullptr)
    return coef_smem ? go(T{}, T{}) : go(F{}, T{});
  return coef_smem ? go(T{}, F{}) : go(F{}, F{});
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
  return launch<false>(rhs, out, c, nullptr, coef, nb, n, m, warps,
                       coef_smem, stream);
}

// Solve along axis 2 of the (nb, rows, n) batch with the (nb, 2, n)
// coefficients of heat_td_coeffs: blocks of `warps` panels of 32 rows
// (1..4), the coefficients in shared memory when coef_smem != 0.
int heat_td_lanes(const float* rhs, float* out, const float* c,
                  const float* coef, int nb, int rows, int n, int warps,
                  int coef_smem, void* stream) {
  return launch<true>(rhs, out, c, nullptr, coef, nb, rows, n, warps,
                      coef_smem, stream);
}

// H10 split (above), the solve and the RHS build (sc != NULL): each
// panel's systems in segments of seg_rows rows, the warm-up from
// warm_bits, the joins in `sync` (SYNC_HEAD + nb * panels * segments * JOIN
// zeroed 64-bit words at first use; word 0 counts replays) at `epoch`, a
// number no earlier launch on this buffer used.
int heat_td_rows_split(const float* rhs, float* out, const float* c,
                       const float* coef, unsigned long long* sync, int nb,
                       int n, int m, int seg_rows, int warm_bits,
                       int coef_smem, int epoch, void* stream) {
  if (seg_rows < 1) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return coef_smem ? launch_rows_split<true, false>(
                         rhs, out, c, nullptr, coef, sync, nb, n, m,
                         seg_rows, warm_bits, (unsigned)epoch, s)
                   : launch_rows_split<false, false>(
                         rhs, out, c, nullptr, coef, sync, nb, n, m,
                         seg_rows, warm_bits, (unsigned)epoch, s);
}

int heat_td_rows_rhs_split(const float* u, float* out, const float* c,
                           const float* sc, const float* coef,
                           unsigned long long* sync, int nb, int n, int m,
                           int seg_rows, int warm_bits, int coef_smem,
                           int epoch, void* stream) {
  if (seg_rows < 1) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return coef_smem ? launch_rows_split<true, true>(
                         u, out, c, sc, coef, sync, nb, n, m, seg_rows,
                         warm_bits, (unsigned)epoch, s)
                   : launch_rows_split<false, true>(
                         u, out, c, sc, coef, sync, nb, n, m, seg_rows,
                         warm_bits, (unsigned)epoch, s);
}

// A split build (rhs: the RHS build; coef_smem as the launch) at `smem`
// bytes a block: out[0..2] = registers a thread, local (spill) bytes a
// thread, blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor):
// what the planner proves residency with.
int heat_td_rows_split_info(int rhs, int coef_smem, int smem, int* out) {
  const void* fns[2][2] = {
      {(const void*)k_td_rows<false, false, true>,
       (const void*)k_td_rows<true, false, true>},
      {(const void*)k_td_rows<false, true, true>,
       (const void*)k_td_rows<true, true, true>}};
  const void* fn = fns[rhs != 0][coef_smem != 0];
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, PANEL * (rhs ? 2 : 1), (size_t)smem);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return cudaSuccess;
}

// The ADI halves, one launch each: heat_td_rows (the x half) and
// heat_td_lanes (the y half) in their RHS builds on the step's grid u,
// the stencil at the (nb,) diffusion numbers sc of the other axis.
int heat_td_rows_rhs(const float* u, float* out, const float* c,
                     const float* sc, const float* coef, int nb, int n,
                     int m, int warps, int coef_smem, void* stream) {
  return launch<false>(u, out, c, sc, coef, nb, n, m, warps, coef_smem,
                       stream);
}

int heat_td_lanes_rhs(const float* u, float* out, const float* c,
                      const float* sc, const float* coef, int nb, int rows,
                      int n, int warps, int coef_smem, void* stream) {
  return launch<true>(u, out, c, sc, coef, nb, rows, n, warps, coef_smem,
                      stream);
}

}  // extern "C"
