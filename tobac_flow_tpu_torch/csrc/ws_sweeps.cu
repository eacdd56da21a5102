// K in-plane Jacobi sweeps of the packed watershed state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tobac_flow_tpu/ops/ws_pallas.py:
// spatial_sweeps_pallas (kernel body _sweep_block, comparison _lex_better).
// It computes what that kernel computes, bit for bit: k Jacobi relaxations
// of (claim f32, claim2 f32, meta i32 = hops << 23 | label + 2) over each
// frame's in-plane taps, in the caller's tap order.  The plain PyTorch
// version of the same arithmetic is spatial_sweeps_reference in
// ops/ws_sweeps.py, and launch_plan there computes the tile, grid and
// shared-memory plan this file checks and runs.
//
// Bound.  One launch reads claim, claim2, meta and field (4 B each),
// seeded and floodable (1 B each) and writes claim, claim2 and meta: 30 B
// per pixel.  At 3.35 TB/s that is 14.1 us for one 1024 x 1536 frame (the
// fine scan step, K = 4), 0.9 us for one 256 x 384 frame (coarse scan
// step), 0.338 ms for the 24 x 1024 x 1536 volume and 21.1 us for the
// 24 x 256 x 384 coarse volume (K = 1 and K = 8 launches alike).  The
// arithmetic is ~19 compares, selects and adds per tap and sweep, plus four
// shared loads; compares and selects issue at 64 lanes per SM and clock on
// Hopper, a quarter of the float32 FMA rate.  So at K = 4 and 8 the kernel
// is bound by instruction issue of the haloed tile's taps, at K = 1 by
// memory.
//
// Design, and what each choice does about that bound:
//
// - State in registers, one candidate build per cell and sweep.  A block of
//   32 x 16 threads owns a 64 x 64 haloed tile; each thread keeps its 8
//   cells' claim, claim2, meta, field and two flag bits in registers for
//   all k sweeps.  A sweep first writes every cell's outgoing candidate
//   (cost, cost2, pushed meta and its barrier key: 16 B) to shared memory,
//   synchronises, and then each cell folds its taps' candidates (4 shared
//   loads a tap) into its registers.  Every tap reads the pre-sweep state
//   (Jacobi).  The candidate buffer is double-buffered, so one barrier per
//   sweep suffices: sweep s + 1 writes the buffer that sweep s - 1 read,
//   and every thread finished reading it before sweep s's barrier.
// - A fold without branches.  The lexicographic compare is written with
//   & and |, the best's hops and barrier key stay in registers, and
//   floodable cells take the result by a select, so the compiler predicates
//   the fold and interleaves the taps of a row's cells (a branch per tap,
//   as early returns compile, serialises them behind their shared loads).
//   A warp skips a row only when no lane in it is floodable.
// - The Jacobi cone.  Sweep s builds candidates in rows [s - 1, 64 - s + 1)
//   and updates rows [s, 64 - s) (whole warps skip the other rows); every
//   column updates, and a halo column's wrapped tap reads a neighbouring
//   row or a guard word, whose error moves one cell a sweep and stops k
//   cells short of the tile's interior.  Out-of-frame cells hold the
//   reference's pad fills (claim +inf, claim2 +inf, meta INT32_MAX, field
//   +inf, not seeded, not floodable): they never update and never push a
//   valid candidate.  The interior, (64 - 2k)^2, is exact after sweep k.
//   At K = 8 a sweep touches on average 1.5x the interior, at K = 4 1.2x.
// - No division in the hot loops.  A cell's shared-memory index is
//   (threadIdx.y + 16 j) * 64 + threadIdx.x + 32 i with j, i unrolled, and
//   a tap is a constant offset dy * 64 + dx.
// - Overlapped asynchronous loads.  The grid is persistent (one block per
//   SM; launch_plan) and walks the tiles of all frames.  Right after the
//   first sweep's barrier of a tile, the block issues cp.async copies of
//   its next tile into a staging area (each thread its own cells' four
//   4-byte values; the byte masks as 4-byte words when the width and the
//   pointers allow it), which land while the tile's k sweeps run.  The
//   next tile then fills its registers from the staging area and writes
//   the pad fills over out-of-frame cells itself.
// - Compile-time K and taps.  Instances for K in {1, 4, 8} with the 4 and
//   8 taps of connectivity 1 and 2 in the reference's order, and one
//   instance with run-time K and taps for every other value.  K = 1 (the
//   in-plane part of a full sweep) runs the same tile.  A streaming path of
//   16-byte loads for it was neither written nor measured.  Its halo adds
//   7 % to the bytes, but what holds K = 1 near half its bound is more
//   likely the bytes in flight: one tile per SM, whose next tile's copies
//   start only after the first sweep's barrier (not measured either).
// - Host side.  ws_sweeps_prepare raises each instance's dynamic shared
//   memory limit once per device; a launch only checks its plan.
//
// What still bounds it: registers (101-113 a thread in the six specialised
// instances, ptxas -v on sm_90a, no spills; the run-time instance 128 and
// 32 B of spills) and shared memory allow one 512-thread block per SM, so
// a 1024 x 1536 frame's 532 tiles at K = 4 take 5 rounds where 4.03 would
// do, and at K = 1 only one tile per SM is in flight.  The bound that
// chip_smoke.py computes counts the 19 operations a tap at the compare
// rate, so it reads "operations" at K = 4 and 8 and "bytes" at K = 1.
//
// Shared memory per block: two candidate buffers 2 x 4 x (4096 + 8) x 4 B,
// staging 4 x 4096 x 4 B + 2 x 64 x 72 B = 206,080 B.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HALO = 64;  // haloed tile, both axes
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 16;
constexpr int THREADS = BLOCK_X * BLOCK_Y;
constexpr int CELLS_X = HALO / BLOCK_X;
constexpr int CELLS_Y = HALO / BLOCK_Y;
constexpr int NCELL = HALO * HALO;
constexpr int GUARD = 4;  // candidate words before and after each buffer
constexpr int CAND_LEN = NCELL + 2 * GUARD;
constexpr int MASK_ROW = HALO + 8;  // staged mask row: the tile's bytes at offset x0 & 3
constexpr int MASK_WORDS = MASK_ROW / 4;
constexpr int MAX_TAPS = 8;
constexpr int MAX_K = 8;
constexpr int32_t META_MAX = 0x7fffffff;
constexpr int32_t LABEL_MASK = (1 << 23) - 1;
constexpr int32_t HOPS_STEP = 1 << 23;
constexpr int32_t HOPS_CAP = 255 << 23;
constexpr int CAND_ARRAYS = 4;  // cost, cost2, pushed meta, its barrier key
constexpr size_t SMEM_BYTES =
    2 * CAND_ARRAYS * CAND_LEN * 4 + 4 * NCELL * 4 + 2 * HALO * MASK_ROW;

// taps packed 4 bits each, (dy + 1) * 3 + (dx + 1), first tap lowest
constexpr uint32_t CONN1 = 0x7531u;      // (-1,0) (0,-1) (0,1) (1,0)
constexpr uint32_t CONN2 = 0x87653210u;  // the 8 neighbours in raster order

__host__ __device__ constexpr int tap_offset(uint32_t code, int j) {
  return (static_cast<int>((code >> (4 * j)) & 15u) / 3 - 1) * HALO +
         (static_cast<int>((code >> (4 * j)) & 15u) % 3 - 1);
}

struct Args {
  const float* claim;
  const float* claim2;
  const int32_t* meta;
  const float* field;
  const uint8_t* seeded;
  const uint8_t* floodable;
  float* out_claim;
  float* out_claim2;
  int32_t* out_meta;
  int h, w, k;
  uint32_t tap_code;
  int n_taps;
  int tiles_x, tiles_per_frame, n_tiles;
  bool words;  // byte masks copied as aligned 4-byte words
};

// The barrier key of a meta: the -1 barrier (label code 1) ranks after
// every positive label on full-tuple ties.
__device__ __forceinline__ int32_t barrier_key(int32_t m) {
  return ((m & LABEL_MASK) == 1) ? (m | LABEL_MASK) : m;
}

// a < b in the (claim, hops, claim2, label) order, given each side's hops
// (meta >> 23) and barrier key.  Written without branches so that the
// compiler predicates it and interleaves the taps of several cells; a NaN
// claim or claim2 compares neither less nor equal, as in the reference.
__device__ __forceinline__ bool lex_better(float c1a, float c2a, int32_t ha, int32_t ka,
                                           float c1b, float c2b, int32_t hb, int32_t kb) {
  return (c1a < c1b) |
         ((c1a == c1b) & ((ha < hb) | ((ha == hb) & ((c2a < c2b) | ((c2a == c2b) & (ka < kb))))));
}

// max(f, c) as jnp.maximum: NaN propagates, and +0 ranks above -0
__device__ __forceinline__ float max_nan(float f, float c) {
  if (f != f || f > c) return f;
  if (c != c || c > f) return c;
  return __int_as_float(__float_as_int(f) & __float_as_int(c));
}

__device__ __forceinline__ void copy4(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src));
}

struct Tile {
  size_t plane;
  int y0, x0;
};

__device__ __forceinline__ Tile locate(const Args& a, int tile, int k) {
  const int frame = tile / a.tiles_per_frame;
  const int r = tile - frame * a.tiles_per_frame;
  const int by = r / a.tiles_x;
  const int bx = r - by * a.tiles_x;
  const int interior = HALO - 2 * k;
  return {static_cast<size_t>(frame) * a.h * a.w, by * interior - k, bx * interior - k};
}

struct Staging {
  float* c;
  float* c2;
  int32_t* m;
  float* f;
  uint8_t* sd;
  uint8_t* fl;
};

// Issue the cp.async copies of one tile into the staging area: each thread
// its own cells, the masks as words spread over the block.  Out-of-frame
// cells are not copied; the fill writes their pad values.
__device__ __forceinline__ void prefetch(const Args& a, const Staging& st, int tile, int k) {
  const Tile tl = locate(a, tile, k);
#pragma unroll
  for (int j = 0; j < CELLS_Y; ++j) {
    const int y = threadIdx.y + BLOCK_Y * j;
    const int gy = tl.y0 + y;
#pragma unroll
    for (int i = 0; i < CELLS_X; ++i) {
      const int x = threadIdx.x + BLOCK_X * i;
      const int gx = tl.x0 + x;
      if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w) {
        const size_t g = tl.plane + static_cast<size_t>(gy) * a.w + gx;
        const int idx = y * HALO + x;
        copy4(st.c + idx, a.claim + g);
        copy4(st.c2 + idx, a.claim2 + g);
        copy4(st.m + idx, a.meta + g);
        copy4(st.f + idx, a.field + g);
      }
    }
  }
  if (a.words) {
    const int xw = tl.x0 & ~3;  // floor to a word; w % 4 == 0, so a word is in the row or out of it
    const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
    for (int q = tid; q < HALO * MASK_WORDS; q += THREADS) {
      const int row = q / MASK_WORDS;
      const int word = q - row * MASK_WORDS;
      const int gy = tl.y0 + row;
      const int gx = xw + 4 * word;
      if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w) {
        const size_t g = tl.plane + static_cast<size_t>(gy) * a.w + gx;
        copy4(st.sd + row * MASK_ROW + 4 * word, a.seeded + g);
        copy4(st.fl + row * MASK_ROW + 4 * word, a.floodable + g);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int K, uint32_t TAPS, int NT>
__global__ void __launch_bounds__(THREADS, 1) sweeps_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // candidate buffer b: cost at cand + b * CAND_ARRAYS * CAND_LEN, then
  // cost2, the pushed meta and its barrier key, CAND_LEN apart
  float* const cand = reinterpret_cast<float*>(smem) + GUARD;
  Staging st;
  st.c = reinterpret_cast<float*>(smem) + 2 * CAND_ARRAYS * CAND_LEN;
  st.c2 = st.c + NCELL;
  st.m = reinterpret_cast<int32_t*>(st.c2 + NCELL);
  st.f = reinterpret_cast<float*>(st.m + NCELL);
  st.sd = reinterpret_cast<uint8_t*>(st.f + NCELL);
  st.fl = st.sd + HALO * MASK_ROW;

  const int k = K > 0 ? K : a.k;
  const int n_taps = NT > 0 ? NT : a.n_taps;
  int offs[MAX_TAPS];
#pragma unroll
  for (int j = 0; j < MAX_TAPS; ++j) offs[j] = tap_offset(a.tap_code, j);

  float c[CELLS_Y][CELLS_X], c2[CELLS_Y][CELLS_X], f[CELLS_Y][CELLS_X];
  int32_t m[CELLS_Y][CELLS_X];
  uint32_t seeded_bits = 0, flood_bits = 0;

  int tile = blockIdx.x;
  if (tile < a.n_tiles) prefetch(a, st, tile, k);
  for (; tile < a.n_tiles; tile += gridDim.x) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // staging -> registers, pad fills outside the frame
    const Tile tl = locate(a, tile, k);
    const int shift = tl.x0 & 3;
    seeded_bits = 0;
    flood_bits = 0;
#pragma unroll
    for (int j = 0; j < CELLS_Y; ++j) {
      const int y = threadIdx.y + BLOCK_Y * j;
      const int gy = tl.y0 + y;
#pragma unroll
      for (int i = 0; i < CELLS_X; ++i) {
        const int x = threadIdx.x + BLOCK_X * i;
        const int gx = tl.x0 + x;
        const int idx = y * HALO + x;
        const int bit = j * CELLS_X + i;
        if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w) {
          c[j][i] = st.c[idx];
          c2[j][i] = st.c2[idx];
          m[j][i] = st.m[idx];
          f[j][i] = st.f[idx];
          bool sd, fl;
          if (a.words) {
            sd = st.sd[y * MASK_ROW + x + shift] != 0;
            fl = st.fl[y * MASK_ROW + x + shift] != 0;
          } else {
            const size_t g = tl.plane + static_cast<size_t>(gy) * a.w + gx;
            sd = a.seeded[g] != 0;
            fl = a.floodable[g] != 0;
          }
          seeded_bits |= static_cast<uint32_t>(sd) << bit;
          flood_bits |= static_cast<uint32_t>(fl) << bit;
        } else {
          c[j][i] = __int_as_float(0x7f800000);
          c2[j][i] = __int_as_float(0x7f800000);
          m[j][i] = META_MAX;
          f[j][i] = __int_as_float(0x7f800000);
        }
      }
    }

    const int next = tile + gridDim.x;
#pragma unroll 1
    for (int s = 1; s <= k; ++s) {
      float* const cost = cand + ((s - 1) & 1) * CAND_ARRAYS * CAND_LEN;
      float* const cost2 = cost + CAND_LEN;
      int32_t* const mpush = reinterpret_cast<int32_t*>(cost2 + CAND_LEN);
      int32_t* const kpush = mpush + CAND_LEN;
      // each cell's outgoing candidate, once
#pragma unroll
      for (int j = 0; j < CELLS_Y; ++j) {
        const int y = threadIdx.y + BLOCK_Y * j;
        if (y < s - 1 || y > HALO - s) continue;
#pragma unroll
        for (int i = 0; i < CELLS_X; ++i) {
          const int idx = y * HALO + threadIdx.x + BLOCK_X * i;
          const bool sd = (seeded_bits >> (j * CELLS_X + i)) & 1u;
          const float cv = c[j][i];
          const float fv = f[j][i];
          const bool rise = fv > cv;
          const int32_t mp = (!sd && rise) ? (m[j][i] & LABEL_MASK) : m[j][i];
          cost[idx] = sd ? fv : max_nan(fv, cv);
          cost2[idx] = sd ? -__int_as_float(0x7f800000) : (rise ? cv : c2[j][i]);
          mpush[idx] = mp;
          kpush[idx] = barrier_key(mp);
        }
      }
      __syncthreads();
      if (s == 1 && next < a.n_tiles) prefetch(a, st, next, k);

      // fold the taps' candidates into each floodable cell; a warp skips a
      // row outside the cone or with no floodable cell in any lane
#pragma unroll
      for (int j = 0; j < CELLS_Y; ++j) {
        const int y = threadIdx.y + BLOCK_Y * j;
        const uint32_t row_flood = (flood_bits >> (j * CELLS_X)) & ((1u << CELLS_X) - 1u);
        if (y < s || y >= HALO - s || !__any_sync(0xffffffffu, row_flood != 0)) continue;
#pragma unroll
        for (int i = 0; i < CELLS_X; ++i) {
          const int idx = y * HALO + threadIdx.x + BLOCK_X * i;
          const float fp = f[j][i];
          float bc = c[j][i];
          float bc2 = c2[j][i];
          int32_t bm = m[j][i];
          int32_t bh = bm >> 23;
          int32_t bk = barrier_key(bm);
#pragma unroll
          for (int t = 0; t < (NT > 0 ? NT : MAX_TAPS); ++t) {
            if (NT == 0 && t >= n_taps) break;
            const int q = idx + (NT > 0 ? tap_offset(TAPS, t) : offs[t]);
            const float cq = cost[q];
            const float c2q = cost2[q];
            const int32_t mq = mpush[q];
            const int32_t step = ((mq < HOPS_CAP) & (fp == cq)) ? HOPS_STEP : 0;
            const int32_t cm = mq + step;
            const int32_t ck = kpush[q] + step;  // hops sit above the label bits
            const int32_t ch = cm >> 23;
            const bool better = (mq != META_MAX) & lex_better(cq, c2q, ch, ck, bc, bc2, bh, bk);
            bc = better ? cq : bc;
            bc2 = better ? c2q : bc2;
            bm = better ? cm : bm;
            bh = better ? ch : bh;
            bk = better ? ck : bk;
          }
          const bool fl = (row_flood >> i) & 1u;
          c[j][i] = fl ? bc : c[j][i];
          c2[j][i] = fl ? bc2 : c2[j][i];
          m[j][i] = fl ? bm : m[j][i];
        }
      }
    }

    // the interior, exact after k sweeps
#pragma unroll
    for (int j = 0; j < CELLS_Y; ++j) {
      const int y = threadIdx.y + BLOCK_Y * j;
      const int gy = tl.y0 + y;
      if (y < k || y >= HALO - k || gy >= a.h) continue;
#pragma unroll
      for (int i = 0; i < CELLS_X; ++i) {
        const int x = threadIdx.x + BLOCK_X * i;
        const int gx = tl.x0 + x;
        if (x < k || x >= HALO - k || gx >= a.w) continue;
        const size_t g = tl.plane + static_cast<size_t>(gy) * a.w + gx;
        a.out_claim[g] = c[j][i];
        a.out_claim2[g] = c2[j][i];
        a.out_meta[g] = m[j][i];
      }
    }
  }
}

using KernelFn = void (*)(Args);

struct Instance {
  int k;           // 0: any k
  uint32_t taps;   // 0 with n_taps 0: any taps
  int n_taps;
  KernelFn fn;
};

const Instance INSTANCES[] = {
    {1, CONN1, 4, sweeps_kernel<1, CONN1, 4>}, {4, CONN1, 4, sweeps_kernel<4, CONN1, 4>},
    {8, CONN1, 4, sweeps_kernel<8, CONN1, 4>}, {1, CONN2, 8, sweeps_kernel<1, CONN2, 8>},
    {4, CONN2, 8, sweeps_kernel<4, CONN2, 8>}, {8, CONN2, 8, sweeps_kernel<8, CONN2, 8>},
    {0, 0u, 0, sweeps_kernel<0, 0u, 0>},
};

KernelFn pick(int k, uint32_t taps, int n_taps) {
  for (const Instance& in : INSTANCES) {
    if (in.n_taps == 0 || (in.k == k && in.taps == taps && in.n_taps == n_taps)) return in.fn;
  }
  return nullptr;
}

}  // namespace

// Raise every instance's dynamic shared-memory limit on the current device;
// call once per device before the first launch there.
extern "C" int ws_sweeps_prepare(void) {
  for (const Instance& in : INSTANCES) {
    const cudaError_t err = cudaFuncSetAttribute(
        in.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Launch on `stream`; returns the CUDA error code (0 on success).  Inputs
// and outputs are contiguous (T, H, W) on the current device;
// seeded/floodable are bool bytes.  Taps are packed 4 bits each,
// (dy + 1) * 3 + (dx + 1), first tap lowest.  The plan (haloed tile,
// tiles, grid, threads, shared bytes) comes from launch_plan in
// ops/ws_sweeps.py and must match this file's tile.
extern "C" int ws_spatial_sweeps(const void* claim, const void* claim2, const void* meta,
                                 const void* field, const void* seeded,
                                 const void* floodable, void* out_claim,
                                 void* out_claim2, void* out_meta, int t, int h, int w,
                                 int k, unsigned int tap_code, int n_taps, int halo,
                                 int tiles_y, int tiles_x, int grid, int threads,
                                 long long smem, void* stream) {
  const int interior = HALO - 2 * k;
  if (k < 1 || k > MAX_K || n_taps < 1 || n_taps > MAX_TAPS || halo != HALO ||
      threads != THREADS || smem != static_cast<long long>(SMEM_BYTES) || t < 1 || h < 1 ||
      w < 1 || grid < 1 || tiles_y < 1 || tiles_x < 1 || (tiles_y - 1) * interior >= h ||
      tiles_y * interior < h || (tiles_x - 1) * interior >= w || tiles_x * interior < w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.claim = static_cast<const float*>(claim);
  a.claim2 = static_cast<const float*>(claim2);
  a.meta = static_cast<const int32_t*>(meta);
  a.field = static_cast<const float*>(field);
  a.seeded = static_cast<const uint8_t*>(seeded);
  a.floodable = static_cast<const uint8_t*>(floodable);
  a.out_claim = static_cast<float*>(out_claim);
  a.out_claim2 = static_cast<float*>(out_claim2);
  a.out_meta = static_cast<int32_t*>(out_meta);
  a.h = h;
  a.w = w;
  a.k = k;
  a.tap_code = tap_code;
  a.n_taps = n_taps;
  a.tiles_x = tiles_x;
  a.tiles_per_frame = tiles_y * tiles_x;
  a.n_tiles = t * tiles_y * tiles_x;
  a.words = w % 4 == 0 && reinterpret_cast<uintptr_t>(seeded) % 4 == 0 &&
            reinterpret_cast<uintptr_t>(floodable) % 4 == 0;
  const KernelFn fn = pick(k, tap_code, n_taps);
  fn<<<grid, dim3(BLOCK_X, BLOCK_Y), SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
