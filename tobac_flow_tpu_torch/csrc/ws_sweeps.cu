// K in-plane Jacobi sweeps of the packed watershed state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tobac_flow_tpu/ops/ws_pallas.py:
// spatial_sweeps_pallas (kernel body _sweep_block, comparison _lex_better).
// It computes what that kernel computes, bit for bit: k_sweeps Jacobi
// relaxations of (claim f32, claim2 f32, meta i32 = hops << 23 | label + 2)
// over each frame's in-plane taps.  The plain PyTorch version of the same
// arithmetic is spatial_sweeps_reference in ops/ws_sweeps.py.
//
// Design.  One block owns a TILE_H x TILE_W interior of one frame and loads
// it with a K-wide halo on all four sides into shared memory.  It runs the
// K sweeps on-chip, ping-ponging (claim, claim2, meta) between two buffers,
// and writes the interior once: one global read and one global write per K
// sweeps.  A K-sweep Jacobi cone reaches K cells, so sweep s (1..K) only
// updates the cells at least s from the tile edge; those read neighbours
// that sweep s-1 (or the load) made exact, and the interior is exact after
// sweep K.  Out-of-frame cells load as the reference's pad fills
// (claim +inf, claim2 +inf, meta INT32_MAX, field +inf, not seeded, not
// floodable), so they never update and never push a valid candidate.  All
// frames run in one launch (grid.z = T).
//
// Bounds on an H100: about 30 bytes per pixel cross device memory per
// launch (3 state arrays read and written, field, two byte masks); the
// work is K sweeps x taps x ~30 integer and float operations per pixel of
// the haloed tile, so at K = 8 the kernel is bound by instruction issue,
// not by memory.  Shared memory per block is (TILE + 2K)^2 x 30 bytes,
// 69,120 bytes at K = 8: above the 48 KB static limit, so the launch raises
// the kernel's dynamic shared-memory limit first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 32;
constexpr int THREADS = 256;
constexpr int MAX_TAPS = 8;
constexpr int MAX_K = 8;
constexpr int32_t META_MAX = 0x7fffffff;
constexpr int32_t LABEL_MASK = (1 << 23) - 1;
constexpr int32_t HOPS_STEP = 1 << 23;
constexpr int32_t HOPS_CAP = 255 << 23;
constexpr int BYTES_PER_CELL = 2 * (4 + 4 + 4) + 4 + 1 + 1;

__host__ __device__ constexpr size_t smem_bytes(int k) {
  return static_cast<size_t>(TILE_H + 2 * k) * (TILE_W + 2 * k) * BYTES_PER_CELL;
}

// (claim, hops, claim2, label) order; the -1 barrier (label code 1) ranks
// after every positive label on full-tuple ties.
__device__ __forceinline__ bool lex_better(float c1a, float c2a, int32_t ma,
                                           float c1b, float c2b, int32_t mb) {
  const int32_t ha = ma >> 23;
  const int32_t hb = mb >> 23;
  const int32_t ka = ((ma & LABEL_MASK) == 1) ? (ma | LABEL_MASK) : ma;
  const int32_t kb = ((mb & LABEL_MASK) == 1) ? (mb | LABEL_MASK) : mb;
  if (c1a != c1b) return c1a < c1b;
  if (ha != hb) return ha < hb;
  if (c2a != c2b) return c2a < c2b;
  return ka < kb;
}

// max(f, c) propagating NaN, as jnp.maximum / torch.maximum do
__device__ __forceinline__ float max_nan(float f, float c) {
  return (f != f || f > c) ? f : c;
}

__global__ void __launch_bounds__(THREADS)
sweeps_kernel(const float* __restrict__ claim, const float* __restrict__ claim2,
              const int32_t* __restrict__ meta, const float* __restrict__ field,
              const uint8_t* __restrict__ seeded, const uint8_t* __restrict__ floodable,
              float* __restrict__ out_claim, float* __restrict__ out_claim2,
              int32_t* __restrict__ out_meta, int h, int w, int k,
              unsigned int tap_code, int n_taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int eh = TILE_H + 2 * k;
  const int ew = TILE_W + 2 * k;
  const int n = eh * ew;
  float* c[2];
  float* c2[2];
  int32_t* m[2];
  c[0] = reinterpret_cast<float*>(smem);
  c[1] = c[0] + n;
  c2[0] = c[1] + n;
  c2[1] = c2[0] + n;
  m[0] = reinterpret_cast<int32_t*>(c2[1] + n);
  m[1] = m[0] + n;
  float* f = reinterpret_cast<float*>(m[1] + n);
  uint8_t* sd = reinterpret_cast<uint8_t*>(f + n);
  uint8_t* fl = sd + n;

  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  const int y0 = blockIdx.y * TILE_H - k;
  const int x0 = blockIdx.x * TILE_W - k;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ly = i / ew;
    const int gy = y0 + ly;
    const int gx = x0 + (i - ly * ew);
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const size_t g = plane + static_cast<size_t>(gy) * w + gx;
      c[0][i] = claim[g];
      c2[0][i] = claim2[g];
      m[0][i] = meta[g];
      f[i] = field[g];
      sd[i] = seeded[g];
      fl[i] = floodable[g];
    } else {
      c[0][i] = __int_as_float(0x7f800000);
      c2[0][i] = __int_as_float(0x7f800000);
      m[0][i] = META_MAX;
      f[i] = __int_as_float(0x7f800000);
      sd[i] = 0;
      fl[i] = 0;
    }
  }

  // tap j in the caller's order: smem offset dy * ew + dx
  int tap_off[MAX_TAPS];
#pragma unroll
  for (int j = 0; j < MAX_TAPS; ++j) {
    const int code = (tap_code >> (4 * j)) & 15;
    tap_off[j] = (code / 3 - 1) * ew + (code % 3 - 1);
  }
  __syncthreads();

  int cur = 0;
  for (int s = 1; s <= k; ++s) {
    const float* cc = c[cur];
    const float* cc2 = c2[cur];
    const int32_t* cm = m[cur];
    float* nc = c[cur ^ 1];
    float* nc2 = c2[cur ^ 1];
    int32_t* nm = m[cur ^ 1];
    const int rh = eh - 2 * s;
    const int rw = ew - 2 * s;
    for (int r = threadIdx.x; r < rh * rw; r += blockDim.x) {
      const int ry = r / rw;
      const int i = (s + ry) * ew + s + (r - ry * rw);
      float bc = cc[i];
      float bc2 = cc2[i];
      int32_t bm = cm[i];
      if (fl[i]) {
        const float fp = f[i];
#pragma unroll
        for (int j = 0; j < MAX_TAPS; ++j) {
          if (j < n_taps) {
            const int q = i + tap_off[j];
            const float cq = cc[q];
            const float fq = f[q];
            const bool sdq = sd[q] != 0;
            const bool rise = fq > cq;
            const float cost = sdq ? fq : max_nan(fq, cq);
            const float cost2 = sdq ? -__int_as_float(0x7f800000) : (rise ? cq : cc2[q]);
            const int32_t mq = cm[q];
            const int32_t mp = (!sdq && rise) ? (mq & LABEL_MASK) : mq;
            if (mp != META_MAX) {
              const int32_t cand = mp + ((mp < HOPS_CAP && fp == cost) ? HOPS_STEP : 0);
              if (lex_better(cost, cost2, cand, bc, bc2, bm)) {
                bc = cost;
                bc2 = cost2;
                bm = cand;
              }
            }
          }
        }
      }
      nc[i] = bc;
      nc2[i] = bc2;
      nm[i] = bm;
    }
    cur ^= 1;
    __syncthreads();
  }

  for (int i = threadIdx.x; i < TILE_H * TILE_W; i += blockDim.x) {
    const int ly = i / TILE_W;
    const int lx = i - ly * TILE_W;
    const int gy = blockIdx.y * TILE_H + ly;
    const int gx = blockIdx.x * TILE_W + lx;
    if (gy < h && gx < w) {
      const int si = (ly + k) * ew + lx + k;
      const size_t g = plane + static_cast<size_t>(gy) * w + gx;
      out_claim[g] = c[cur][si];
      out_claim2[g] = c2[cur][si];
      out_meta[g] = m[cur][si];
    }
  }
}

}  // namespace

// Launch on `stream`; returns the CUDA error code (0 on success).  Inputs
// and outputs are contiguous (T, H, W); seeded/floodable are bool bytes.
// Taps are packed 4 bits each, (dy + 1) * 3 + (dx + 1), first tap lowest.
extern "C" int ws_spatial_sweeps(const void* claim, const void* claim2, const void* meta,
                                 const void* field, const void* seeded,
                                 const void* floodable, void* out_claim,
                                 void* out_claim2, void* out_meta, int t, int h, int w,
                                 int k, unsigned int tap_code, int n_taps,
                                 void* stream) {
  if (k < 1 || k > MAX_K || n_taps < 1 || n_taps > MAX_TAPS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (t == 0 || h == 0 || w == 0) return 0;
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      sweeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, t);
  sweeps_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(claim), static_cast<const float*>(claim2),
      static_cast<const int32_t*>(meta), static_cast<const float*>(field),
      static_cast<const uint8_t*>(seeded), static_cast<const uint8_t*>(floodable),
      static_cast<float*>(out_claim), static_cast<float*>(out_claim2),
      static_cast<int32_t*>(out_meta), h, w, k, tap_code, n_taps);
  return static_cast<int>(cudaGetLastError());
}
