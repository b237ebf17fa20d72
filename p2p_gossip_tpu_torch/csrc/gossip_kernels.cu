// Hand-written Hopper (sm_90a) kernels for the flood engine's tick, the
// random-partner protocols' round and the telemetry's per-tick digest.
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

constexpr unsigned kFullMask = 0xffffffffu;

// Words per occupancy sector of a w-word row: 8 (one 32-byte L2 sector)
// while w <= 256, doubled until the row has at most 32 sectors, so a row's
// occupancy is always one 32-bit word. The sector is then a power of two
// of at least 8 words, a whole number of 16-byte units.
__host__ __device__ inline int sector_words(int w) {
  int sw = 8;
  while (sw * 32 < w) sw <<= 1;
  return sw;
}

__device__ inline uint32_t or_units(uint32_t a, uint32_t b) { return a | b; }
__device__ inline uint4 or_units(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ inline uint32_t and_not_units(uint32_t a, uint32_t b) { return a & ~b; }
__device__ inline uint4 and_not_units(uint4 a, uint4 b) {
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}
__device__ inline uint32_t shfl_xor(uint32_t v, int m) {
  return __shfl_xor_sync(kFullMask, v, m);
}
__device__ inline uint4 shfl_xor(uint4 v, int m) {
  return make_uint4(shfl_xor(v.x, m), shfl_xor(v.y, m), shfl_xor(v.z, m),
                    shfl_xor(v.w, m));
}
// Position of the set bit of x that has n set bits below it.
__device__ inline int nth_set_bit(uint32_t x, int n) {
  for (int i = 0; i < n; ++i) x &= x - 1u;
  return __ffs(x) - 1;
}
template <typename T> __device__ inline T zero_unit();
template <> __device__ inline uint32_t zero_unit<uint32_t>() { return 0u; }
template <> __device__ inline uint4 zero_unit<uint4>() { return make_uint4(0u, 0u, 0u, 0u); }

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// ---------------------------------------------------------------------------
// sector_occupancy
//
// Replaces: nothing on the TPU; it is the gather's companion pass. The
//   engine runs it on each tick's new frontier slot, so the frontier ring
//   carries a (D, N) ring of occupancy words beside it.
// Computes: out[r] bit s = any word of row r's sector s is nonzero (sector
//   size from sector_words). Exact; gather_or only needs it to over-
//   approximate.
// Bound on the H100: bytes (N*W*4 read, N*4 written).
// Design: one warp per row, lane s ORs sector s's words (16-byte loads when
//   the row allows them) and the warp's ballot of "nonzero" is the row's
//   occupancy word: no shared memory, no reduction tree.
// ---------------------------------------------------------------------------
template <bool kVec>
__global__ void sector_occupancy_kernel(const uint32_t* __restrict__ words,
                                        int n, int w, long long ld, int sw,
                                        int32_t* __restrict__ out) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // warp-uniform
  const uint32_t* p = words + (size_t)row * (size_t)ld;
  const int c0 = lane * sw;
  const int c1 = c0 + sw < w ? c0 + sw : w;
  uint32_t acc = 0u;
  if (kVec) {  // c0 and c1 are multiples of 4 here (sw % 8 == 0, w % 4 == 0)
    const uint4* q = reinterpret_cast<const uint4*>(p);
    for (int c = c0 >> 2; c < (c1 >> 2); ++c) {
      const uint4 v = __ldg(q + c);
      acc |= v.x | v.y | v.z | v.w;
    }
  } else {
    for (int c = c0; c < c1; ++c) acc |= __ldg(p + c);
  }
  const unsigned bits = __ballot_sync(kFullMask, acc != 0u);
  if (lane == 0) out[row] = (int32_t)bits;
}

// ---------------------------------------------------------------------------
// gather_or
//
// Replaces: the XLA ELL gather-OR of the JAX package,
//   p2p_gossip_tpu/ops/ell.py gather_or_frontier / propagate (a blocked
//   lax.scan of frontier-row gathers + bitwise-OR reduce) and the
//   concatenate-and-scatter back to node order in propagate_bucketed
//   (ell.py:523-525). It has no Pallas source.
// Computes:
//   out[dst, :] = up[dst] ? OR_k keep(r,k) ? hist[slot(r,k), idx[r,k], :] & S : 0
//                         : 0
//   dst = rows ? rows[r] : r
//   keep(r,k) = mask[r,k] && !drop(idx[r,k], dst, tick)
//   drop(s, d, t) = mix32(seed ^ s*0x9E3779B1 ^ d*0x85EBCA77 ^ t*0xC2B2AE3D)
//                   <= loss_limit (uint32; only in the kLoss instantiation)
//   slot(r,k) = ((tick - delay[r,k]) % ring + ring) % ring   (per-edge)
//             = uniform_slot                                  (delay == null)
//   S = the sectors that occ[slot(r,k), idx[r,k]] marks (all when occ is
//   null). With an exact or over-approximating occupancy, S drops only
//   zero words, so the result is the plain gather-OR. `up` (null: every
//   node up) is the churn model's destination mask, `drop` the link-loss
//   coin of p2p_gossip_tpu/ops/ell.py _loss_keep (models/linkloss.py spec;
//   the JAX package applies both in and after its gather).
//   Node ids: the coin hashes dst + id_offset, the destination's GLOBAL
//   node id (a node shard of the sharded engine passes its first row's
//   id; 0 everywhere else). Source ids are idx values, global already.
//   Replicas (Monte-Carlo campaigns): B independent rings stacked along
//   the rows, hist (ring, B*n_src, w), occ (ring, B*n_src), out
//   (B*n_out, w), up (B*n_out). Replica r = blockIdx.y reads source row
//   r*n_src + s, writes row r*n_out + dst and tests up[r*n_out + dst];
//   its coin hashes the node ids s and dst with loss_seeds[r] (loss_seed
//   for every replica when loss_seeds is null). The ELL is shared. With
//   B = 1 every offset is the solo kernel's.
// Bound on the H100: bytes. The function must move each source row once
//   (~0.1 GB at N = 100,000, W = 256), but each valid edge reads its source
//   row again: ~100 edges per row turn that into ~10 GB of row reads per
//   tick, and the source slot (100 MB) is twice the 50 MB L2. Most of those
//   words are zero: shares are ordered by generation tick, so a row's new
//   bits sit in the few 32-byte sectors of the shares now spreading (about
//   0.1-0.2 of the sectors in the middle of a flood).
// Design: one warp per destination row, 8 rows per block.
//   1. Stage: the warp compacts the row's valid entries through `mask`
//      (ballot + prefix popcount) into shared memory, 128 entries at a
//      time: each neighbour's source-row offset and its occupancy word.
//      Neighbours with no occupied sector are dropped here. The OR of the
//      staged occupancy words (`any`) is the output row's possibly nonzero
//      sectors.
//   2. Sectors outside `any` are written as zeros without a read. The
//      16-byte units of the sectors in `any` (the row's band) are numbered
//      densely and lanes own two units of the band each: a band of at most
//      2L units takes L lanes per neighbour (L a power of two, at most
//      32), so 32 / L neighbours are read at once. A lane ORs in its unit
//      of a neighbour only when that neighbour's occupancy marks the
//      unit's sector; a shuffle-XOR tree folds the neighbour groups. With
//      every sector occupied this is one neighbour at a time, the lanes
//      covering 64 units of its row per pass.
//   The loop runs over neighbours, not sectors, so each neighbour's
//   occupied sectors are read together as coalesced runs of its row.
//   Walking sector by sector (16 neighbours' 32-byte sector per load) was
//   faster than a neighbour walk over the whole row when the occupied data
//   sits in L2 (a uniform-delay ring mid-flood), but several times slower
//   when it comes from DRAM (a dense ring, or a per-edge ring spread over
//   D slots). Spreading the lanes over the band only gives the neighbour
//   walk the fewer iterations that made the sector walk fast (PERF.md).
//   Rows with more than 128 entries take further staging rounds that OR
//   into the row the first round wrote. Loads are 16 bytes a thread when
//   w % 4 == 0 and hist and out are 16-byte aligned (the entry point picks
//   the instantiation), 4 bytes otherwise. Rows are written straight into
//   node order through `rows` (null = identity), dropping rows outside
//   [0, n_out); bucket rows partition range(N), so no two warps write the
//   same row. Offsets are size_t: ring*N*W passes 2^31 at real sizes.
//   No tensor cores: an OR over a 0.1%-dense adjacency has no matrix-
//   product form that pays. Replicas are grid y, so B replicas are one
//   launch; a staged entry's row in the ring is slot * B*n_src + r*n_src +
//   s, its word offset that row times w.
//   Options (off: the kernel reads and writes what it did without them).
//   The loss coin is a separate instantiation (kLoss), computed in the
//   staging step: about a dozen integer operations in registers per valid
//   edge, the per-row part (seed, dst, tick) hashed in once per row. A
//   dropped edge is not staged, exactly like a padded entry, so its source
//   row is never read and its occupancy does not widen the row's band. A
//   down destination (`up`) writes a zero row and reads nothing; it must
//   still write, because the callers hand in uninitialised outputs.
//   Registers: the gather waits on L2 and is paced by the warps resident
//   per SM. The loss instantiation asks for six blocks of 256 threads a
//   SM, which caps it at the 40 registers the loss-free kernel takes on
//   its own; left free it took 48, five blocks a SM, and ran ~20% slower
//   than the loss-free kernel though it reads fewer edges. The loss-free
//   instantiation keeps its plain bound: the six-block request, at the
//   same 40 registers, made it slower in the flood (PERF.md).
// ---------------------------------------------------------------------------
constexpr int kGatherWarps = 8;
constexpr int kGatherMinBlocks = 6;
constexpr int kGatherStage = 128;
constexpr int kLaneUnits = 2;

constexpr uint32_t kCoinSrc = 0x9E3779B1u;
constexpr uint32_t kCoinDst = 0x85EBCA77u;
constexpr uint32_t kCoinTick = 0xC2B2AE3Du;

// splitmix32 finalizer (models/linkloss.py); uint32 arithmetic wraps.
__device__ inline uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

template <typename T, bool kLoss>
__global__ void __launch_bounds__(kGatherWarps * 32, kLoss ? kGatherMinBlocks : 0)
gather_or_kernel(const uint32_t* __restrict__ hist,
                 const uint32_t* __restrict__ occ, int n_src, int slot_rows,
                 int w, int sw,
                 int ring, int tick, int uniform_slot,
                 const int32_t* __restrict__ idx,
                 const uint8_t* __restrict__ mask,
                 const int32_t* __restrict__ delay, int n_rows, int cap,
                 const int32_t* __restrict__ rows, int n_out,
                 const uint8_t* __restrict__ up, uint32_t loss_seed,
                 uint32_t loss_limit, const uint32_t* __restrict__ loss_seeds,
                 int id_offset, uint32_t* __restrict__ out) {
  __shared__ unsigned long long s_off[kGatherWarps][kGatherStage];
  __shared__ uint32_t s_occ[kGatherWarps][kGatherStage];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kGatherWarps + warp;
  if (r >= n_rows) return;  // warp-uniform: only warp-level syncs follow
  const int dst = rows ? rows[r] : r;
  if (dst < 0 || dst >= n_out) return;

  constexpr int kUnitWords = (int)(sizeof(T) / sizeof(uint32_t));
  const int n_units = w / kUnitWords;
  const int sec_shift = __ffs(sw / kUnitWords) - 1;  // unit -> sector
  const int nsec = (w + sw - 1) / sw;
  const uint32_t all = nsec >= 32 ? kFullMask : ((1u << nsec) - 1u);
  // slot_rows = B * n_src rows make one ring slot (< 2^31, as every row
  // count here; a kernel argument, so the staging loop holds no more
  // registers than with one replica). The word offsets stay size_t.
  const int src_row0 = (int)blockIdx.y * n_src;  // the replica's first row
  const T* src = reinterpret_cast<const T*>(hist);
  const int dst_row = (int)blockIdx.y * n_out + dst;
  T* row_out = reinterpret_cast<T*>(out + (size_t)dst_row * (size_t)w);
  const size_t e0 = (size_t)r * (size_t)cap;
  unsigned long long* off = s_off[warp];
  uint32_t* occ_of = s_occ[warp];

  if (up && !up[dst_row]) {  // warp-uniform: a down node receives nothing
    for (int u = lane; u < n_units; u += 32) row_out[u] = zero_unit<T>();
    return;
  }
  const uint32_t seed = loss_seeds ? loss_seeds[blockIdx.y] : loss_seed;
  const uint32_t coin_row =
      kLoss ? seed ^ ((uint32_t)(dst + id_offset) * kCoinDst) ^ ((uint32_t)tick * kCoinTick)
            : 0u;

  int k0 = 0;
  do {
    // 1. Stage this round's valid entries, compacted.
    const int k1 = k0 + kGatherStage < cap ? k0 + kGatherStage : cap;
    int nv = 0;
    uint32_t any = 0u;
    for (int kb = k0; kb < k1; kb += 32) {
      const int k = kb + lane;
      bool keep = k < k1 && mask[e0 + k];
      unsigned long long o = 0;
      uint32_t oc = 0u;
      if (keep) {
        const int s = idx[e0 + k];  // a node id: the coin hashes it
        if (kLoss && mix32(coin_row ^ ((uint32_t)s * kCoinSrc)) <= loss_limit) {
          keep = false;  // erased in flight: not staged, never read
        } else {
          int slot = uniform_slot;
          if (delay) {
            slot = (tick - delay[e0 + k]) % ring;
            if (slot < 0) slot += ring;
          }
          const size_t row = (size_t)slot * (size_t)slot_rows + (size_t)(src_row0 + s);
          o = row * (size_t)w / kUnitWords;
          oc = occ ? (occ[row] & all) : all;
          keep = oc != 0u;
        }
      }
      const unsigned b = __ballot_sync(kFullMask, keep);
      if (keep) {
        const int pos = nv + __popc(b & ((1u << lane) - 1u));
        off[pos] = o;
        occ_of[pos] = oc;
        any |= oc;
      }
      nv += __popc(b);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) any |= __shfl_xor_sync(kFullMask, any, m);
    __syncwarp();

    // 2. Zeros outside the band, then passes over the band.
    if (k0 == 0) {
      for (int u = lane; u < n_units; u += 32)
        if (!((any >> (u >> sec_shift)) & 1u)) row_out[u] = zero_unit<T>();
    }
    const int n_band = __popc(any) << sec_shift;
    int lanes = 32;
    while (lanes > 1 && (lanes >> 1) * kLaneUnits >= n_band) lanes >>= 1;
    const int groups = 32 / lanes;
    const int group = lane / lanes;
    const int part = lane & (lanes - 1);
    for (int c0 = 0; c0 < n_band; c0 += lanes * kLaneUnits) {
      T acc[kLaneUnits];
      int unit[kLaneUnits];  // -1: no unit (past the band or the row)
      int sec[kLaneUnits];
#pragma unroll
      for (int i = 0; i < kLaneUnits; ++i) {
        const int c = c0 + i * lanes + part;
        unit[i] = -1;
        sec[i] = 0;
        acc[i] = zero_unit<T>();
        if (c < n_band) {
          const int s = nth_set_bit(any, c >> sec_shift);
          const int u = (s << sec_shift) + (c & ((1 << sec_shift) - 1));
          if (u < n_units) {
            unit[i] = u;
            sec[i] = s;
          }
        }
      }
#pragma unroll 4
      for (int j = group; j < nv; j += groups) {
        const uint32_t oc = occ_of[j];
        const T* row = src + off[j];
#pragma unroll
        for (int i = 0; i < kLaneUnits; ++i)
          if (unit[i] >= 0 && ((oc >> sec[i]) & 1u))
            acc[i] = or_units(acc[i], __ldg(row + unit[i]));
      }
#pragma unroll
      for (int i = 0; i < kLaneUnits; ++i) {
        for (int m = lanes; m < 32; m <<= 1) acc[i] = or_units(acc[i], shfl_xor(acc[i], m));
        if (group == 0 && unit[i] >= 0)
          row_out[unit[i]] = k0 == 0 ? acc[i] : or_units(row_out[unit[i]], acc[i]);
      }
    }
    __syncwarp();  // the next round overwrites this round's staging
    k0 += kGatherStage;
  } while (k0 < cap);
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
// Bound on the H100: bytes (N*W*4 read once) once the per-word work is a
//   few logic operations. Counting each bit with its own shift-and-add (32
//   per word, as the first port did) made it ALU-bound at ~15x its bytes.
// Design: each thread owns one word column over an interleaved run of a
//   block's rows and keeps bit-sliced vertical counters: kCovPlanes uint32
//   planes, plane i holding bit i of 32 per-bit counts. Adding a word is a
//   ripple carry over the planes (t = plane & carry; plane ^= carry;
//   carry = t): two logic operations a plane. It runs through all planes
//   without testing the carry: on the card a per-plane test-and-branch cost
//   more than the planes it skipped, on dense and on sparse-bit words
//   alike (the warp waits for its longest carry anyway). Before the planes
//   could overflow (every 2^k - 1 nonzero words) they flush into 32
//   integer counts in registers. Zero words are skipped. Rows are loaded
//   kCovBatch at a time so each warp keeps that many 128-byte loads in
//   flight. The block's 8 warps reduce their counts in shared memory, then
//   one global atomicAdd per nonzero slot per block into the zeroed
//   output: exact in any order.
//   Replicas: grid z is the replica. Replica z counts its own n rows,
//   starting rep_ld words after replica z - 1's, into out + z * n_slots,
//   so B replicas' (B*N, W) frontier gives (B, S) counts in one launch.
// ---------------------------------------------------------------------------
constexpr int kCovPlanes = 8;
constexpr int kCovFlush = (1 << kCovPlanes) - 1;
constexpr int kCovWarps = 8;
constexpr int kCovBatch = 8;

struct BitSlicedCounter {
  uint32_t plane[kCovPlanes];
  int cnt[32];
  int pending;

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < kCovPlanes; ++i) plane[i] = 0u;
#pragma unroll
    for (int b = 0; b < 32; ++b) cnt[b] = 0;
    pending = 0;
  }
  __device__ void flush() {
#pragma unroll
    for (int i = 0; i < kCovPlanes; ++i) {
#pragma unroll
      for (int b = 0; b < 32; ++b) cnt[b] += (int)((plane[i] >> b) & 1u) << i;
      plane[i] = 0u;
    }
    pending = 0;
  }
  __device__ void add(uint32_t v) {
    if (v == 0u) return;
    if (pending == kCovFlush) flush();
    uint32_t carry = v;
#pragma unroll
    for (int i = 0; i < kCovPlanes; ++i) {
      const uint32_t t = plane[i] & carry;
      plane[i] ^= carry;
      carry = t;
    }
    ++pending;
  }
};

__global__ void __launch_bounds__(kCovWarps * 32)
coverage_per_slot_kernel(const uint32_t* __restrict__ words, int n, int w,
                         long long ld, long long rep_ld, int rows_per,
                         int n_slots, int32_t* __restrict__ out) {
  __shared__ int s_cnt[32 * 32];  // [bit][column of the block's tile]
  words += (size_t)blockIdx.z * (size_t)rep_ld;
  out += (size_t)blockIdx.z * (size_t)n_slots;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  for (int i = threadIdx.x; i < 32 * 32; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();
  const long long r0 = (long long)blockIdx.y * rows_per;
  const long long r_end = r0 + rows_per;
  const long long r1 = r_end < n ? r_end : (long long)n;
  if (c < w) {
    BitSlicedCounter ctr;
    ctr.init();
    const uint32_t* col = words + c;
    const size_t step = (size_t)ld * kCovWarps;
    long long r = r0 + warp;
    for (; r + (kCovBatch - 1) * kCovWarps < r1; r += kCovBatch * kCovWarps) {
      uint32_t v[kCovBatch];
      const uint32_t* p = col + (size_t)r * (size_t)ld;
#pragma unroll
      for (int i = 0; i < kCovBatch; ++i) v[i] = __ldg(p + i * step);
#pragma unroll
      for (int i = 0; i < kCovBatch; ++i) ctr.add(v[i]);
    }
    for (; r < r1; r += kCovWarps) ctr.add(__ldg(col + (size_t)r * (size_t)ld));
    ctr.flush();
#pragma unroll
    for (int b = 0; b < 32; ++b)
      if (ctr.cnt[b] != 0) atomicAdd(&s_cnt[b * 32 + lane], ctr.cnt[b]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * 32; i += blockDim.x) {
    const int v = s_cnt[i];
    const int s = (blockIdx.x * 32 + (i & 31)) * 32 + (i >> 5);
    if (v != 0 && s < n_slots) atomicAdd(out + s, v);
  }
}

// ---------------------------------------------------------------------------
// scatter_or
//
// Replaces: the XLA scatter-OR of the JAX package,
//   p2p_gossip_tpu/ops/segment.py scatter_or (argsort by destination, a
//   segmented associative OR-scan, a scatter of the segment tails) and its
//   narrow-row twin scatter_or_bits (bit unpack + scatter-add), together
//   with the OR the protocols build a round's row from,
//   p2p_gossip_tpu/models/protocols.py:160 (remote | pushed) & ~seen, then
//   ORed into seen. It has no Pallas source: XLA has no scatter-OR, and
//   neither has torch.
// Computes, for every destination row d < n_out:
//   acc = base && !kAndNot ? base[d] : 0
//   acc |= src[pull_row[d]]             when 0 <= pull_row[d] < n_src
//   acc |= src[entries[e]]              for e in [offsets[d], offsets[d+1]),
//                                       entries outside [0, n_src) dropped
//   out[d] = kAndNot ? acc & ~base[d] : acc
//   pull_row, base and offsets may be null (no pull, a zero base, no
//   entries). Every row of out is written, once.
// Precondition: no entry and no pull row names a row of `out` (src may be
//   a ring that holds out as one slot; the protocols write slot t mod D and
//   read slots t - d with 1 <= d <= D - 1). base == out is allowed: each
//   warp reads its own row before it writes it.
// Bound on the H100: bytes: base read once, each distinct kept source row
//   read once (W*4 bytes), out written once, 4(n_out + 1) bytes of offsets
//   and 4 bytes per entry and per pull row. The protocols read their rows
//   straight out of the (D*N, W) history ring, so no (M, W) payload is
//   built, and the round's new ring row is this one write.
// Design: the transpose is done before the kernel: kernels.scatter_or_plan
//   sorts each round's entries by destination (a sort in torch, index
//   bookkeeping of a few MB against GBs of rows), so the scatter becomes a
//   gather that one warp per destination row owns, eight rows a block. The
//   warp ORs the base row, the pulled row and its entries' rows in
//   registers and stores each word once: no atomics, no zero fill, and the
//   result does not depend on the entries' order. Lanes stride the row in
//   16-byte units when W % 4 == 0 and every table is 16-byte aligned (the
//   entry point picks the instantiation), 4-byte words otherwise, two
//   units a lane a pass; wider rows take more passes. The warp reads up to
//   32 entry indices with one coalesced load and broadcasts them with
//   __shfl_sync; a longer run (one hot destination) loops. Source rows are
//   loaded kScatterBatch entries at a time before they are ORed, so a warp
//   keeps several row loads in flight. Rows of src are read through the
//   read-only path; base is read with plain loads, since it may be out.
// ---------------------------------------------------------------------------
constexpr int kScatterWarps = 8;
constexpr int kScatterLaneUnits = 2;
constexpr int kScatterBatch = 4;

template <typename T, bool kAndNot>
__global__ void __launch_bounds__(kScatterWarps * 32)
scatter_or_kernel(const uint32_t* src, int n_src, int w,
                  const int32_t* __restrict__ offsets,
                  const int32_t* __restrict__ entries,
                  const int32_t* __restrict__ pull_row, const uint32_t* base,
                  int n_out, uint32_t* out) {
  const int d = blockIdx.x * kScatterWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (d >= n_out) return;  // warp-uniform: only warp-level syncs follow
  constexpr int kUnitWords = (int)(sizeof(T) / sizeof(uint32_t));
  const int n_units = w / kUnitWords;
  const T* rows = reinterpret_cast<const T*>(src);
  const T* base_row =
      base ? reinterpret_cast<const T*>(base + (size_t)d * (size_t)w) : nullptr;
  T* out_row = reinterpret_cast<T*>(out + (size_t)d * (size_t)w);
  const int e0 = offsets ? offsets[d] : 0;
  const int e1 = offsets ? offsets[d + 1] : 0;
  const int p = pull_row ? pull_row[d] : -1;
  const bool pull = p >= 0 && p < n_src;  // warp-uniform

  for (int c0 = 0; c0 < n_units; c0 += 32 * kScatterLaneUnits) {
    T acc[kScatterLaneUnits];
    T keep[kScatterLaneUnits];  // kAndNot: the base words to clear
    bool ok[kScatterLaneUnits];
#pragma unroll
    for (int i = 0; i < kScatterLaneUnits; ++i) {
      const int u = c0 + i * 32 + lane;
      ok[i] = u < n_units;
      const T b = base_row && ok[i] ? base_row[u] : zero_unit<T>();
      acc[i] = kAndNot ? zero_unit<T>() : b;
      keep[i] = b;
      if (pull && ok[i]) acc[i] = or_units(acc[i], __ldg(rows + (size_t)p * n_units + u));
    }
    for (int eb = e0; eb < e1; eb += 32) {
      const int n = e1 - eb < 32 ? e1 - eb : 32;
      const int mine = lane < n ? entries[eb + lane] : -1;
      for (int j = 0; j < n; j += kScatterBatch) {
        T v[kScatterBatch][kScatterLaneUnits];
#pragma unroll
        for (int q = 0; q < kScatterBatch; ++q) {
          const int s = __shfl_sync(kFullMask, mine, (j + q) & 31);
          const bool live = j + q < n && s >= 0 && s < n_src;  // warp-uniform
#pragma unroll
          for (int i = 0; i < kScatterLaneUnits; ++i) {
            const int u = c0 + i * 32 + lane;
            v[q][i] = live && ok[i] ? __ldg(rows + (size_t)s * n_units + u) : zero_unit<T>();
          }
        }
#pragma unroll
        for (int q = 0; q < kScatterBatch; ++q)
#pragma unroll
          for (int i = 0; i < kScatterLaneUnits; ++i) acc[i] = or_units(acc[i], v[q][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kScatterLaneUnits; ++i) {
      if (!ok[i]) continue;
      const int u = c0 + i * 32 + lane;
      out_row[u] = kAndNot ? and_not_units(acc[i], keep[i]) : acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// scatter_or_atomic
//
// The scatter_or design this file had before the destination-owned one,
// kept only as the same-call baseline that chip_smoke.py times the new
// kernel against; no path of the package launches it.
// Computes: out[dst[m], :] |= src[row(m), :] for every entry m < M with
//   mask[m] (null: every entry), row(m) = src_row[m] (null: m),
//   dst[m] in [0, n_out) and row(m) in [0, n_src); other entries are
//   dropped. `out` is ORed into, not overwritten.
// Design: one warp per entry, eight entries per block, 16- or 4-byte
//   loads as above; each nonzero source word goes to `out` by one
//   atomicOr, exact in any order. Once rows saturate, every word is one
//   atomic, most setting no new bit (PERF.md).
// ---------------------------------------------------------------------------
__device__ inline void or_word(uint32_t* p, uint32_t v) {
  if (v) atomicOr(p, v);
}
__device__ inline void or_into(uint32_t* p, uint32_t v) { or_word(p, v); }
__device__ inline void or_into(uint32_t* p, uint4 v) {
  or_word(p, v.x);
  or_word(p + 1, v.y);
  or_word(p + 2, v.z);
  or_word(p + 3, v.w);
}

template <typename T>
__global__ void __launch_bounds__(kScatterWarps * 32)
scatter_or_atomic_kernel(const uint32_t* __restrict__ src, int n_src, int w,
                         const int32_t* __restrict__ src_row,
                         const int32_t* __restrict__ dst,
                         const uint8_t* __restrict__ mask, int m, int n_out,
                         uint32_t* out) {
  const long long e =
      (long long)blockIdx.x * kScatterWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= m) return;  // warp-uniform, as every test below
  if (mask && !mask[e]) return;
  const int d = dst[e];
  const long long s = src_row ? (long long)src_row[e] : e;
  if (d < 0 || d >= n_out || s < 0 || s >= n_src) return;
  constexpr int kUnitWords = (int)(sizeof(T) / sizeof(uint32_t));
  const int n_units = w / kUnitWords;
  const T* row = reinterpret_cast<const T*>(src + (size_t)s * (size_t)w);
  uint32_t* o = out + (size_t)d * (size_t)w;
  for (int u = lane; u < n_units; u += 32) {
    or_into(o + u * kUnitWords, __ldg(row + u));
  }
}


// ---------------------------------------------------------------------------
// tick_digest
//
// Replaces: p2p_gossip_tpu/telemetry/digest.py tick_digest (the XLA XOR
//   fold _fold_sparse_jnp + lax.reduce(bitwise_xor)), the flight recorder's
//   one uint32 per tick. PyTorch has no XOR reduction, so the port folds
//   with this kernel.
// Computes, for each replica r of B stacked along the rows (row r*N + i
//   is node i of replica r): out[r] ^= XOR over every nonzero entry of
//     mix(seen[i,k] ^ k*SALT_WORD ^ i*SALT_NODE)        (words)
//     mix(received[i] ^ i*SALT_NODE ^ SALT_RECV)         (counters; and
//     mix(sent_lo[i] ^ i*SALT_NODE ^ SALT_SENT_LO)        sent_hi when it
//     mix(sent_hi[i] ^ i*SALT_NODE ^ SALT_SENT_HI)        is not null)
//   over replica r's rows, with mix = lowbias32, all in uint32. The salt is
//   the node id i, never the stacked row, so replica r's digest is its solo
//   run's. A zero entry contributes nothing (the JAX digest's pad-width
//   invariance). B = 1 is the solo digest. A node shard of the sharded
//   engine passes id_offset, its first row's global id, so i above is
//   the global node id and the XOR of the shards' digests is the solo
//   digest (telemetry/digest.py tick_digest_sharded).
// Bound on the H100: bytes (B*(N*W*4 + 8*N), + 4*N a replica with sent_hi,
//   read once); the mix is ~12 integer operations a word, far below the
//   integer rate.
// Design: grid y selects the replica (as in gather_or), grid x a
//   grid-stride loop of one warp per row over that replica's N rows; 16-byte
//   loads where the row allows them; each thread XORs in registers, then a
//   shuffle fold in the warp, a shared-memory fold in the block and one
//   atomicXor per block into its replica's slot. XOR is associative and
//   commutative, so the atomics give the same bits in any block order:
//   unlike an atomic add, the result is deterministic. The slots must hold
//   zero before the tick (a fresh ring, and each tick writes its slots
//   once), so no fill launch is needed; one launch covers all B replicas.
// ---------------------------------------------------------------------------
constexpr uint32_t kMixM1 = 0x21F0AAADu;
constexpr uint32_t kMixM2 = 0xD35A2D97u;
constexpr uint32_t kSaltNode = 0xB5297A4Du;
constexpr uint32_t kSaltWord = 0x68E31DA4u;
constexpr uint32_t kSaltRecv = 0x1B56C4E9u;
constexpr uint32_t kSaltSentLo = 0x7F4A7C15u;
constexpr uint32_t kSaltSentHi = 0x94D049BBu;
constexpr int kDigestWarps = 8;

__device__ inline uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= kMixM1;
  x ^= x >> 15;
  x *= kMixM2;
  x ^= x >> 15;
  return x;
}

// The sparse fold's term: nothing for a zero value.
__device__ inline uint32_t digest_term(uint32_t value, uint32_t salt) {
  return value ? lowbias32(value ^ salt) : 0u;
}

template <bool kVec>
__global__ void __launch_bounds__(kDigestWarps * 32)
tick_digest_kernel(const uint32_t* __restrict__ seen, int n, int w,
                   long long ld, const uint32_t* __restrict__ received,
                   const uint32_t* __restrict__ sent_lo,
                   const uint32_t* __restrict__ sent_hi, int id_offset,
                   uint32_t* __restrict__ out, long long out_stride) {
  __shared__ uint32_t part[kDigestWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n_warps = (long long)gridDim.x * kDigestWarps;
  const long long first = (long long)blockIdx.y * n;  // replica's first row
  uint32_t acc = 0u;
  for (long long node = (long long)blockIdx.x * kDigestWarps + warp; node < n;
       node += n_warps) {
    const uint32_t node_salt = (uint32_t)(node + id_offset) * kSaltNode;
    const long long row = first + node;
    const uint32_t* p = seen + (size_t)row * (size_t)ld;
    if (kVec) {  // w % 4 == 0 and every row 16-byte aligned
      const uint4* q = reinterpret_cast<const uint4*>(p);
      for (int u = lane; u < (w >> 2); u += 32) {
        const uint4 v = __ldg(q + u);
        const uint32_t k = (uint32_t)u << 2;
        acc ^= digest_term(v.x, k * kSaltWord ^ node_salt);
        acc ^= digest_term(v.y, (k + 1u) * kSaltWord ^ node_salt);
        acc ^= digest_term(v.z, (k + 2u) * kSaltWord ^ node_salt);
        acc ^= digest_term(v.w, (k + 3u) * kSaltWord ^ node_salt);
      }
    } else {
      for (int c = lane; c < w; c += 32) {
        acc ^= digest_term(__ldg(p + c), (uint32_t)c * kSaltWord ^ node_salt);
      }
    }
    // The row's counters, one lane each.
    if (lane == 0) {
      acc ^= digest_term(__ldg(received + row), node_salt ^ kSaltRecv);
    } else if (lane == 1) {
      acc ^= digest_term(__ldg(sent_lo + row), node_salt ^ kSaltSentLo);
    } else if (lane == 2 && sent_hi != nullptr) {
      acc ^= digest_term(__ldg(sent_hi + row), node_salt ^ kSaltSentHi);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc ^= shfl_xor(acc, off);
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kDigestWarps ? part[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc ^= shfl_xor(acc, off);
    if (lane == 0 && acc != 0u) atomicXor(out + (size_t)blockIdx.y * (size_t)out_stride, acc);
  }
}


// ---------------------------------------------------------------------------
// compress_deltas
//
// Replaces: p2p_gossip_tpu/parallel/exchange.py compress_deltas (XLA: a
//   (k, n_loc*W) candidate mask, its cumsum ranks and two scatters into
//   (k, capacity + 1) buffers with a trash slot).
// Computes, for each destination shard d < k: the words j (flat index over
//   the (n_loc, W) row-major `changed` slice) with changed[j] != 0 and
//   need[j / W, d], in ascending j: idx[d, r] = j and val[d, r] =
//   changed[j] for the r-th of them while r < capacity; counts[d] = how
//   many there are (the true count, past capacity too). The caller fills
//   idx with -1 and val with 0 first, so unused slots are the JAX padding.
// Bound on the H100: bytes (the slice and `need` read once, the buffers
//   written once); the ranking is a few integer operations a word.
// Design: an ordered stream compaction in two passes over the same
//   partition of the words into blocks of `iters` x 256 words (at most
//   ~1024 blocks). Pass 1 counts each block's candidates per destination
//   (a warp ballot a destination, a shared-memory sum). Pass 2 starts each
//   block at the sum of the earlier blocks' counts (the exclusive scan,
//   read from pass 1's per-block counts: at most ~1024 x k words a block),
//   then walks its words in order, 256 at a time: a ballot a destination
//   gives each lane its rank in the warp, the warps' counts in shared
//   memory give the warp's rank in the step, and a running base carries
//   over the steps. A word whose rank is below capacity is stored; a block
//   whose every buffer is full stops. Pass 1 reads the slice once more than
//   the bound: simple first. Not the JAX dense (k, n_loc*W) rank arrays:
//   at a 4-shard split of 100,000 x 256 they are k x 25.6 MB a tick.
// ---------------------------------------------------------------------------
constexpr int kCompressThreads = 256;
constexpr int kCompressWarps = kCompressThreads / 32;
constexpr int kMaxDests = 32;

// Row `row`'s destinations as bits: bit d = need[row, d].
__device__ inline uint32_t dest_bits(const uint8_t* __restrict__ need, long long row,
                                     int k) {
  uint32_t m = 0u;
  for (int d = 0; d < k; ++d) m |= (uint32_t)(need[row * k + d] != 0) << d;
  return m;
}

__global__ void __launch_bounds__(kCompressThreads)
compress_count_kernel(const uint32_t* __restrict__ changed, long long n_words, int w,
                      const uint8_t* __restrict__ need, int k, int iters,
                      int32_t* __restrict__ block_counts) {
  __shared__ int s_cnt[kMaxDests];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < k) s_cnt[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kCompressThreads * iters;
  for (int it = 0; it < iters; ++it) {
    const long long j0 = base + (long long)it * kCompressThreads;
    if (j0 >= n_words) break;  // block-uniform
    const long long j = j0 + threadIdx.x;
    uint32_t bits = 0u;
    if (j < n_words && __ldg(changed + j) != 0u) bits = dest_bits(need, j / w, k);
    for (int d = 0; d < k; ++d) {
      const unsigned b = __ballot_sync(kFullMask, (bits >> d) & 1u);
      if (lane == 0 && b) atomicAdd(&s_cnt[d], __popc(b));
    }
  }
  __syncthreads();
  if (threadIdx.x < k)
    block_counts[(long long)blockIdx.x * k + threadIdx.x] = s_cnt[threadIdx.x];
}

__global__ void __launch_bounds__(kCompressThreads)
compress_write_kernel(const uint32_t* __restrict__ changed, long long n_words, int w,
                      const uint8_t* __restrict__ need, int k, int iters,
                      const int32_t* __restrict__ block_counts, int capacity,
                      int32_t* __restrict__ idx, uint32_t* __restrict__ val,
                      int32_t* __restrict__ counts) {
  __shared__ int s_base[kMaxDests];
  __shared__ int s_warp[kCompressWarps][kMaxDests];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // The block's first rank per destination: the earlier blocks' counts.
  for (int d = warp; d < k; d += kCompressWarps) {
    long long s = 0;
    for (int b = lane; b < (int)blockIdx.x; b += 32) s += block_counts[(long long)b * k + d];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(kFullMask, s, m);
    if (lane == 0) {
      s_base[d] = s < capacity ? (int)s : capacity;  // ranks >= capacity are dropped
      if (blockIdx.x == gridDim.x - 1)
        counts[d] = (int)(s + block_counts[(long long)blockIdx.x * k + d]);
    }
  }
  __syncthreads();
  const long long base = (long long)blockIdx.x * kCompressThreads * iters;
  const unsigned below = (1u << lane) - 1u;
  for (int it = 0; it < iters; ++it) {
    bool full = true;
    for (int d = 0; d < k; ++d) full = full && s_base[d] >= capacity;
    const long long j0 = base + (long long)it * kCompressThreads;
    if (full || j0 >= n_words) break;  // block-uniform
    const long long j = j0 + threadIdx.x;
    uint32_t v = 0u, bits = 0u;
    if (j < n_words) {
      v = __ldg(changed + j);
      if (v != 0u) bits = dest_bits(need, j / w, k);
    }
    for (int d = 0; d < k; ++d) {
      const unsigned b = __ballot_sync(kFullMask, (bits >> d) & 1u);
      if (lane == 0) s_warp[warp][d] = __popc(b);
    }
    __syncthreads();
    for (int d = 0; d < k; ++d) {
      const unsigned b = __ballot_sync(kFullMask, (bits >> d) & 1u);
      if ((bits >> d) & 1u) {
        int r = s_base[d] + __popc(b & below);
        for (int u = 0; u < warp; ++u) r += s_warp[u][d];
        if (r < capacity) {
          idx[(long long)d * capacity + r] = (int32_t)j;
          val[(long long)d * capacity + r] = v;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < k) {
      int r = s_base[threadIdx.x];
      for (int u = 0; u < kCompressWarps; ++u) r += s_warp[u][threadIdx.x];
      s_base[threadIdx.x] = r < capacity ? r : capacity;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// scatter_deltas
//
// Replaces: p2p_gossip_tpu/parallel/exchange.py scatter_deltas (XLA: a
//   scatter-set into a zero (n_padded * W,) canvas, mode="drop").
// Computes: out[s * src_words + idx[s, e]] = val[s, e] for every entry with
//   idx >= 0 whose word falls inside the canvas (the caller zeroes it).
// Bound on the H100: bytes (the canvas written once, the buffers read once).
// Design: one thread an entry; sources own disjoint rows, so no two
//   entries store to one word and no atomics are needed.
// ---------------------------------------------------------------------------
__global__ void scatter_deltas_kernel(const int32_t* __restrict__ idx,
                                      const uint32_t* __restrict__ val,
                                      long long n_entries, int capacity,
                                      long long src_words, long long canvas_words,
                                      uint32_t* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  const int i = __ldg(idx + e);
  if (i < 0) return;
  const long long g = (e / capacity) * src_words + i;
  if (g < canvas_words) out[g] = __ldg(val + e);
}

}  // namespace

extern "C" {

int gossip_sector_occupancy(const void* words, int n, int w, long long ld,
                            void* out, void* stream) {
  const int threads = 256;
  const long long blocks = ((long long)n * 32 + threads - 1) / threads;
  const int sw = sector_words(w);
  if (w % 4 == 0 && ld % 4 == 0 && aligned16(words)) {
    sector_occupancy_kernel<true><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, n, w, ld, sw, (int32_t*)out);
  } else {
    sector_occupancy_kernel<false><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, n, w, ld, sw, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// `up` may be null (every node up). loss_on == 0 launches the loss-free
// instantiation; otherwise an edge drops when its coin is <= loss_limit
// (threshold - 1, so 0xFFFFFFFF drops every edge).
// `replicas` stacked rings (grid y): n_src and n_out count one replica's
// rows; `loss_seeds` (null: loss_seed for all) holds one seed a replica.
// `id_offset` is added to each destination row's node id in the coin.
int gossip_gather_or(const void* hist, const void* occ, int n_src, int w,
                     int ring, int tick, int uniform_slot, const void* idx,
                     const void* mask, const void* delay, int n_rows, int cap,
                     const void* rows, int n_out, const void* up, int loss_on,
                     unsigned int loss_seed, unsigned int loss_limit,
                     const void* loss_seeds, int replicas, int id_offset,
                     void* out, void* stream) {
  const dim3 grid((unsigned)((n_rows + kGatherWarps - 1) / kGatherWarps),
                  (unsigned)replicas);
  const int sw = sector_words(w);
  const bool vec = w % 4 == 0 && aligned16(hist) && aligned16(out);
#define GOSSIP_GATHER_LAUNCH(T, LOSS)                                          \
  gather_or_kernel<T, LOSS><<<grid, kGatherWarps * 32, 0, (cudaStream_t)stream>>>( \
      (const uint32_t*)hist, (const uint32_t*)occ, n_src, replicas * n_src, w, \
      sw, ring, tick,                                                          \
      uniform_slot, (const int32_t*)idx, (const uint8_t*)mask,                 \
      (const int32_t*)delay, n_rows, cap, (const int32_t*)rows, n_out,         \
      (const uint8_t*)up, loss_seed, loss_limit, (const uint32_t*)loss_seeds, \
      id_offset, (uint32_t*)out)
  if (vec && loss_on) {
    GOSSIP_GATHER_LAUNCH(uint4, true);
  } else if (vec) {
    GOSSIP_GATHER_LAUNCH(uint4, false);
  } else if (loss_on) {
    GOSSIP_GATHER_LAUNCH(uint32_t, true);
  } else {
    GOSSIP_GATHER_LAUNCH(uint32_t, false);
  }
#undef GOSSIP_GATHER_LAUNCH
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

// `replicas` row blocks of n rows each, rep_ld words apart; out holds
// replicas * n_slots counts.
int gossip_coverage_per_slot(const void* words, int n, int w, long long ld,
                             int replicas, long long rep_ld, int n_slots,
                             void* out, void* stream) {
  // A block spans 32 word columns times 8 warps, each warp on every 8th row
  // of the block's run. The grid aims at one wave: ~4 resident blocks (64
  // registers a thread) on each of the H100's 132 SMs, shared out over the
  // replicas. More blocks add global atomics per slot without adding loads
  // in flight, and so does a wider block: spanning all 128 columns of a
  // (100,000, 128) bitmask, each block holds every slot and the kernel
  // took twice as long.
  const int grid_x = (w + 31) / 32;
  long long grid_y = 132 * 4 / ((long long)grid_x * replicas);
  const long long max_y = (n + kCovWarps - 1) / kCovWarps;
  if (grid_y > max_y) grid_y = max_y;
  if (grid_y > 65535) grid_y = 65535;
  if (grid_y < 1) grid_y = 1;
  const int rows_per = (int)((n + grid_y - 1) / grid_y);
  const dim3 grid((unsigned)grid_x, (unsigned)((n + rows_per - 1) / rows_per),
                  (unsigned)replicas);
  coverage_per_slot_kernel<<<grid, kCovWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n, w, ld, rep_ld, rows_per, n_slots, (int32_t*)out);
  return (int)cudaGetLastError();
}

// `offsets`/`entries`, `pull_row` and `base` may each be null (no
// entries, no pull, a zero base); `offsets` holds n_out + 1 positions into
// `entries`. and_not != 0 writes acc & ~base. `src`, `base` and `out` are
// row-major with W words a row.
int gossip_scatter_or(const void* src, int n_src, int w, const void* offsets,
                      const void* entries, const void* pull_row,
                      const void* base, int and_not, int n_out, void* out,
                      void* stream) {
  const dim3 grid((unsigned)((n_out + kScatterWarps - 1) / kScatterWarps));
  const bool vec = w % 4 == 0 && aligned16(src) && aligned16(out) &&
                   (base == nullptr || aligned16(base));
#define GOSSIP_SCATTER_LAUNCH(T, ANDNOT)                                           \
  scatter_or_kernel<T, ANDNOT><<<grid, kScatterWarps * 32, 0, (cudaStream_t)stream>>>( \
      (const uint32_t*)src, n_src, w, (const int32_t*)offsets,                     \
      (const int32_t*)entries, (const int32_t*)pull_row, (const uint32_t*)base,    \
      n_out, (uint32_t*)out)
  if (vec && and_not) {
    GOSSIP_SCATTER_LAUNCH(uint4, true);
  } else if (vec) {
    GOSSIP_SCATTER_LAUNCH(uint4, false);
  } else if (and_not) {
    GOSSIP_SCATTER_LAUNCH(uint32_t, true);
  } else {
    GOSSIP_SCATTER_LAUNCH(uint32_t, false);
  }
#undef GOSSIP_SCATTER_LAUNCH
  return (int)cudaGetLastError();
}

// `src_row` and `mask` may be null (row m reads src row m; every entry
// kept). `src` and `out` are row-major with W words a row.
int gossip_scatter_or_atomic(const void* src, int n_src, int w,
                             const void* src_row, const void* dst,
                             const void* mask, int m, int n_out, void* out,
                             void* stream) {
  const dim3 grid((unsigned)(((long long)m + kScatterWarps - 1) / kScatterWarps));
  const bool vec = w % 4 == 0 && aligned16(src) && aligned16(out);
#define GOSSIP_SCATTER_ATOMIC_LAUNCH(T)                                          \
  scatter_or_atomic_kernel<T><<<grid, kScatterWarps * 32, 0, (cudaStream_t)stream>>>( \
      (const uint32_t*)src, n_src, w, (const int32_t*)src_row,                  \
      (const int32_t*)dst, (const uint8_t*)mask, m, n_out, (uint32_t*)out)
  if (vec) {
    GOSSIP_SCATTER_ATOMIC_LAUNCH(uint4);
  } else {
    GOSSIP_SCATTER_ATOMIC_LAUNCH(uint32_t);
  }
#undef GOSSIP_SCATTER_ATOMIC_LAUNCH
  return (int)cudaGetLastError();
}


// `seen` is (replicas * n, w) with row stride ld words, replica r's node i
// at row r * n + i; `received`, `sent_lo` and (when not null) `sent_hi` are
// (replicas * n,) 32-bit counters; `out` holds one uint32 slot a replica,
// slot r at out[r * out_stride], that replica r's digest is XORed into;
// node i is salted as node i + id_offset.
int gossip_tick_digest(const void* seen, int n, int w, long long ld,
                       const void* received, const void* sent_lo,
                       const void* sent_hi, int replicas, int id_offset,
                       void* out, long long out_stride, void* stream) {
  // Up to 8 resident blocks of 256 threads on each of the H100's 132 SMs,
  // shared among the replicas, each warp striding over its replica's rows:
  // one atomicXor per block.
  long long blocks = ((long long)n + kDigestWarps - 1) / kDigestWarps;
  const long long cap = (132 * 8) / (replicas > 0 ? replicas : 1);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)replicas);
  const bool vec = w % 4 == 0 && ld % 4 == 0 && aligned16(seen);
  if (vec) {
    tick_digest_kernel<true><<<grid, kDigestWarps * 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)seen, n, w, ld, (const uint32_t*)received,
        (const uint32_t*)sent_lo, (const uint32_t*)sent_hi, id_offset, (uint32_t*)out,
        out_stride);
  } else {
    tick_digest_kernel<false><<<grid, kDigestWarps * 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)seen, n, w, ld, (const uint32_t*)received,
        (const uint32_t*)sent_lo, (const uint32_t*)sent_hi, id_offset, (uint32_t*)out,
        out_stride);
  }
  return (int)cudaGetLastError();
}


// `changed` is (n_loc, w) row-major, n_loc * w < 2^31 words; `need` is
// (n_loc, k) bytes, k <= 32; `block_counts` holds scratch for
// compress_blocks(n_loc * w) x k ints; idx/val (k, capacity) are filled
// with -1/0 by the caller; `counts` (k,) is written here.
int gossip_compress_blocks(long long n_words, int* iters) {
  long long it = (n_words + 1024LL * kCompressThreads - 1) / (1024LL * kCompressThreads);
  if (it < 32) it = 32;
  *iters = (int)it;
  const long long per = it * kCompressThreads;
  return (int)((n_words + per - 1) / per);
}

int gossip_compress_deltas(const void* changed, int n_loc, int w, const void* need, int k,
                           int capacity, void* block_counts, void* idx, void* val,
                           void* counts, void* stream) {
  if (k < 1 || k > kMaxDests) return (int)cudaErrorInvalidValue;
  const long long n_words = (long long)n_loc * w;
  int iters = 0;
  const int blocks = gossip_compress_blocks(n_words, &iters);
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  compress_count_kernel<<<blocks, kCompressThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)changed, n_words, w, (const uint8_t*)need, k, iters,
      (int32_t*)block_counts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compress_write_kernel<<<blocks, kCompressThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)changed, n_words, w, (const uint8_t*)need, k, iters,
      (const int32_t*)block_counts, capacity, (int32_t*)idx, (uint32_t*)val,
      (int32_t*)counts);
  return (int)cudaGetLastError();
}

// `idx`/`val` are (n_srcs, capacity); source s's entries land at word
// s * src_words + idx of the (zeroed) canvas of canvas_words words.
int gossip_scatter_deltas(const void* idx, const void* val, int n_srcs, int capacity,
                          long long src_words, long long canvas_words, void* out,
                          void* stream) {
  const long long n = (long long)n_srcs * capacity;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    scatter_deltas_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const uint32_t*)val, n, capacity, src_words, canvas_words,
        (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
