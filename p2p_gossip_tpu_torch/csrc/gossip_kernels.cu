// Hand-written Hopper (sm_90a) kernels for the flood engine's tick.
//
// Plain C interface, loaded with ctypes (p2p_gossip_tpu_torch/ops/kernels.py).
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
//
// Bitmasks arrive as torch.int32 tensors holding the uint32 bit pattern;
// here they are read as uint32_t, so shifts are logical.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// gather_or
//
// Replaces: the XLA ELL gather-OR of the JAX package,
//   p2p_gossip_tpu/ops/ell.py gather_or_frontier / propagate (a blocked
//   lax.scan of frontier-row gathers + bitwise-OR reduce) and the
//   concatenate-and-scatter back to node order in propagate_bucketed
//   (ell.py:523-525). It has no Pallas source.
// Computes:
//   out[rows[r], w] = OR_k mask[r,k] ? hist[slot(r,k), idx[r,k], w] : 0
//   slot(r,k) = ((tick - delay[r,k]) % ring + ring) % ring   (per-edge)
//             = uniform_slot                                  (delay == null)
// Bound on the H100: bytes. Each valid edge reads one W-word frontier row
//   (W*4 bytes) for a 4-byte index and 1-byte mask: with mean degree ~100
//   and W = 256 a tick moves ~10 GB of row reads through L2/HBM, far above
//   the ~0.3 GB the function must move (each input and output once).
// Design: threads run over the W words of a row, so every frontier-row
//   read is one coalesced W*4-byte transaction run; a block holds one row
//   (W >= 256) or several rows (narrow W). The row's index and mask are
//   read once per warp as broadcast loads. Rows are written straight into
//   node order through `rows` (null = identity), dropping rows outside
//   [0, n_out); bucket rows partition range(N), so no two blocks write the
//   same row. All offsets are size_t: ring*N*W passes 2^31 at real sizes.
// ---------------------------------------------------------------------------
__global__ void gather_or_kernel(
    const uint32_t* __restrict__ hist, int n_src, int w, int ring, int tick,
    int uniform_slot, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ delay,
    int n_rows, int cap, const int32_t* __restrict__ rows, int n_out,
    uint32_t* __restrict__ out) {
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= n_rows) return;
  const int dst = rows ? rows[r] : r;
  if (dst < 0 || dst >= n_out) return;
  const size_t e0 = (size_t)r * (size_t)cap;
  const size_t row_words = (size_t)w;
  const size_t slot_words = (size_t)n_src * row_words;
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    uint32_t acc = 0;
#pragma unroll 4
    for (int k = 0; k < cap; ++k) {
      if (!mask[e0 + k]) continue;
      int slot = uniform_slot;
      if (delay) {
        slot = (tick - delay[e0 + k]) % ring;
        if (slot < 0) slot += ring;
      }
      acc |= hist[(size_t)slot * slot_words + (size_t)idx[e0 + k] * row_words + c];
    }
    out[(size_t)dst * row_words + c] = acc;
  }
}

// ---------------------------------------------------------------------------
// popcount_rows
//
// Replaces: p2p_gossip_tpu/ops/pallas_kernels.py popcount_rows_pallas
//   (+ _popcount_rows_kernel), the row-wise set-bit count
//   (N, W) uint32 -> (N,) int32 that apply_tick_updates needs every tick.
// Bound on the H100: bytes (N*W*4 read, N*4 written); __popc is one
//   instruction per word.
// Design: one warp per row; lanes stride the row's words (coalesced
//   128-byte reads), __popc per word, then a warp-shuffle sum. The warp
//   index is uniform within a warp, so whole warps exit together and the
//   full-mask shuffle is safe.
// ---------------------------------------------------------------------------
__global__ void popcount_rows_kernel(const uint32_t* __restrict__ words,
                                     int n, int w, long long ld,
                                     int32_t* __restrict__ out) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;
  const uint32_t* row = words + (size_t)warp * (size_t)ld;
  int s = 0;
  for (int c = lane; c < w; c += 32) s += __popc(row[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) out[warp] = s;
}

// ---------------------------------------------------------------------------
// coverage_per_slot
//
// Replaces: p2p_gossip_tpu/ops/pallas_kernels.py coverage_per_slot_pallas
//   (+ _coverage_kernel, _bit_column_counts): per-share coverage
//   (N, W) -> (S,) int32, out[w*32 + b] = #rows with bit b of word w set.
// Bound on the H100: bytes (N*W*4 read once); the 32 bit tests per word
//   are integer ALU work that the skipped zero words keep small on the
//   sparse per-tick frontier the engine feeds it.
// Design: the TPU kernel carried a (32, W) accumulator across a sequential
//   grid; CUDA blocks run in no order, so nothing carries over between
//   them. Each thread owns one word column over a run of `rows_per` rows
//   (coalesced across the warp), keeps its 32 counters in registers, and
//   ends with one integer atomicAdd per nonzero counter into the zeroed
//   output — exact in any order.
// ---------------------------------------------------------------------------
__global__ void coverage_per_slot_kernel(const uint32_t* __restrict__ words,
                                         int n, int w, long long ld,
                                         int rows_per, int n_slots,
                                         int32_t* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= w) return;
  const long long r0 = (long long)blockIdx.y * rows_per;
  const long long r_end = r0 + rows_per;
  const long long r1 = r_end < n ? r_end : (long long)n;
  int cnt[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) cnt[b] = 0;
  for (long long r = r0; r < r1; ++r) {
    const uint32_t v = words[(size_t)r * (size_t)ld + c];
    if (v == 0u) continue;
#pragma unroll
    for (int b = 0; b < 32; ++b) cnt[b] += (int)((v >> b) & 1u);
  }
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int s = c * 32 + b;
    if (s < n_slots && cnt[b] != 0) atomicAdd(out + s, cnt[b]);
  }
}

}  // namespace

extern "C" {

int gossip_gather_or(const void* hist, int n_src, int w, int ring, int tick,
                     int uniform_slot, const void* idx, const void* mask,
                     const void* delay, int n_rows, int cap, const void* rows,
                     int n_out, void* out, void* stream) {
  const int tx = w >= 256 ? 256 : ((w + 31) / 32) * 32;
  const int ty = 256 / tx;
  const dim3 block(tx, ty);
  const dim3 grid((unsigned)((n_rows + ty - 1) / ty));
  gather_or_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)hist, n_src, w, ring, tick, uniform_slot,
      (const int32_t*)idx, (const uint8_t*)mask, (const int32_t*)delay,
      n_rows, cap, (const int32_t*)rows, n_out, (uint32_t*)out);
  return (int)cudaGetLastError();
}

int gossip_popcount_rows(const void* words, int n, int w, long long ld,
                         void* out, void* stream) {
  const int threads = 256;
  const long long blocks = ((long long)n * 32 + threads - 1) / threads;
  popcount_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n, w, ld, (int32_t*)out);
  return (int)cudaGetLastError();
}

int gossip_coverage_per_slot(const void* words, int n, int w, long long ld,
                             int rows_per, int n_slots, void* out,
                             void* stream) {
  const int tx = w >= 128 ? 128 : ((w + 31) / 32) * 32;
  const dim3 grid((unsigned)((w + tx - 1) / tx),
                  (unsigned)((n + rows_per - 1) / rows_per));
  coverage_per_slot_kernel<<<grid, tx, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n, w, ld, rows_per, n_slots, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
