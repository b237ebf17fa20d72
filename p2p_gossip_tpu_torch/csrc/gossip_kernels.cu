// Hand-written Hopper (sm_90a) kernels for the flood engine's tick, the
// random-partner protocols' round, the sharded engines' exchange and the
// telemetry's per-tick digest.
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
//   raw[dst, :] = up[dst] ? OR_k keep(r,k) ? hist[slot(r,k), idx[r,k], :] & S : 0
//                         : 0
//   out[dst, :] = raw[dst, :]                 (seen null)
//               = raw[dst, :] & ~seen[dst, :] (the seen instantiations)
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
//   the JAX package applies both in and after its gather). `seen` (the
//   rows of `out`) makes the output the flood tick's `newly` before its
//   generations, the only part of the arrivals the tick keeps
//   (tick_update below), and lets the kernel skip every read that could
//   only bring bits the destination already has.
//   Node ids: the coin hashes dst + id_offset, the destination's GLOBAL
//   node id (a node shard of the sharded engine passes its first row's
//   id; 0 everywhere else). Source ids are idx values, global already.
//   Replicas (Monte-Carlo campaigns): B independent rings stacked along
//   the rows, hist (ring, B*n_src, w), occ (ring, B*n_src), out and seen
//   (B*n_out, w), up (B*n_out). Replica r = blockIdx.y reads source row
//   r*n_src + s, writes row r*n_out + dst, tests up[r*n_out + dst] and
//   reads seen[r*n_out + dst]; its coin hashes the node ids s and dst with
//   loss_seeds[r] (loss_seed for every replica when loss_seeds is null).
//   The ELL is shared. With B = 1 every offset is the solo kernel's.
// Bound on the H100: bytes. The function must move each occupied source
//   sector once (~0.1 GB at N = 100,000, W = 256), but each valid edge
//   reads its source row again: ~100 edges per row turn that into ~10 GB
//   of row reads per tick, and the source slot (100 MB) is twice the 50 MB
//   L2, so the kernel waits on L2 and DRAM for those rereads, a round trip
//   per batch of neighbours, and is paced by the round trips of a row and
//   the warps resident per SM. Most rereads carry nothing the tick keeps:
//   shares are ordered by generation tick, so a 16-byte unit of a row holds
//   shares of one generation; a source's units of the generation now at
//   hop 3 are almost always seen already at the destination, and the bits
//   it lacks of the generation at hop 2 come from ~10 of its ~100
//   neighbours. With `seen` the kernel reads the staging, the
//   destination's seen units in the band, and a neighbour's unit only while
//   the destination still lacks a bit of it. At burst32k's dense ticks it
//   loads 48-50% of the unmasked kernel's neighbour units and takes 0.66-0.84
//   of its time (chip_smoke phase 22, PERF.md). The time falls by less than
//   the loads: the units of the two newest generations are never covered
//   (most of the bits a destination lacks there reach no neighbour yet), so
//   a warp reads every neighbour of such rows, batch after batch; most of
//   the gain is the saturated sectors (step 2): without that pass, on
//   per-unit coverage alone, the same ticks took 0.85-0.99 of the unmasked
//   time. The seen read costs a round trip to DRAM a wide row, paid where
//   nothing prunes: renewal's sparse ticks take 1.07-1.11 of the unmasked
//   time, coverage4k's early ticks (W = 128, nothing seen yet) 1.17.
// Design: one warp per destination row, 8 rows per block.
//   1. Stage: the warp compacts the row's valid entries through `mask`
//      (ballot + prefix popcount) into shared memory, 128 entries at a
//      time: each neighbour's source-row offset and its occupancy word.
//      Neighbours with no occupied sector are dropped here. The OR of the
//      staged occupancy words (`any`) is the output row's possibly nonzero
//      sectors.
//   2. (seen) Saturated sectors: a sector of `any` none of whose units the
//      destination lacks a bit of is taken out of `any`, and a staged
//      neighbour left with no sector of `any` is dropped from the staging
//      (an in-place recompaction, only when a sector went). Where the row's
//      seen is one 16-byte load a lane (W <= 128 words: a BA row of ~6
//      entries, paced by its dependent loads; kRowSeen) that load is
//      issued before the staging's, which do not wait on it, so it costs no
//      round trip; a wider row reads only its band's seen units, after
//      staging (W = 1,024: ~100 entries a row, the read is small beside
//      them). Both schedules follow from W; the rest is one code path.
//   3. Sectors outside `any` are written as zeros without a read. The
//      16-byte units of the sectors in `any` (the row's band) are numbered
//      densely and lanes own two units of the band each: a band of at most
//      2L units takes L lanes per neighbour (L a power of two, at most
//      32), so 32 / L neighbours are read at once. A lane ORs in its unit
//      of a neighbour only when that neighbour's occupancy marks the
//      unit's sector; a shuffle-XOR tree folds the neighbour groups. With
//      every sector occupied this is one neighbour at a time, the lanes
//      covering 64 units of its row per pass.
//      (seen) A lane's accumulator starts at its unit's seen (loaded again:
//      the warp read it a moment before; OR what earlier staging rounds
//      wrote), so a unit is covered once the accumulator is all ones, and
//      the output is accumulator & ~seen. A lane loads a neighbour's unit
//      only while its unit is not covered; units the destination has whole
//      are never read. The neighbours are taken kSeenBatch a group at a
//      time: the loads of a batch are issued together (a covered test
//      before each load would chain every load on the one before it), then
//      the groups' accumulators are folded by the shuffle-XOR tree, so
//      every lane sees the whole warp's coverage, and between batches the
//      warp stops once no lane lacks a bit (a vote). The fold period,
//      kSeenBatch = 8 neighbours a group, was the fastest of 4, 6, 8 and 12
//      at burst32k's ticks and within 3% of the best at coverage4k's.
//      Starting the first batch before the seen load returns (its loads
//      not waiting on coverage), a one-batch path for rows whose
//      neighbours fit one batch (seen loaded beside the neighbours), and an
//      L2 prefetch of the whole seen row before staging were each slower at
//      both shapes and at renewal's: the first two hold seen values in
//      registers across the batch, the third adds 4 KB of reads a row.
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
//   w % 4 == 0 and hist, out and seen are 16-byte aligned (the entry point
//   picks the instantiation), 4 bytes otherwise. Rows are written straight
//   into node order through `rows` (null = identity), dropping rows
//   outside [0, n_out); bucket rows partition range(N), so no two warps
//   write the same row. Offsets are size_t: ring*N*W passes 2^31 at real
//   sizes. No tensor cores: an OR over a 0.1%-dense adjacency has no
//   matrix-product form that pays. Replicas are grid y, so B replicas are
//   one launch; a staged entry's row in the ring is slot * B*n_src +
//   r*n_src + s, its word offset that row times w.
//   Options (off: the kernel reads and writes what it did without them).
//   The loss coin is a separate instantiation (kLoss), computed in the
//   staging step: about a dozen integer operations in registers per valid
//   edge, the per-row part (seed, dst, tick) hashed in once per row. A
//   dropped edge is not staged, exactly like a padded entry, so its source
//   row is never read and its occupancy does not widen the row's band. A
//   down destination (`up`) writes a zero row and reads nothing; it must
//   still write, because the callers hand in uninitialised outputs.
//   `seen` is a separate instantiation too (kSeen): without it the kernel
//   is the unmasked one, read for read.
//   Twelve instantiations in all: 16- or 4-byte units, loss on or off,
//   and unmasked, seen in one load a lane (kRowSeen) or seen read over
//   the band. A run with telemetry's spans on launches the same ones as a
//   run with them off.
//   Registers: the gather waits on L2 and is paced by the warps resident
//   per SM. The loss instantiation asks for six blocks of 256 threads a
//   SM, which caps it at the 40 registers the loss-free kernel takes on
//   its own; left free it took 48, five blocks a SM, and ran ~20% slower
//   than the loss-free kernel though it reads fewer edges. The loss-free
//   instantiation keeps its plain bound: the six-block request, at the
//   same 40 registers, made it slower in the flood (PERF.md). The seen
//   instantiations ask for six blocks too: left free they took 48-64
//   registers (four or five blocks a SM) and ran 10-25% slower at
//   burst32k's ticks than at 40 registers, where `-Xptxas -v` reports
//   24-112 bytes of spills (the batch's loads in flight are what the
//   registers hold); the unmasked instantiations take 40 (16-byte units)
//   and 32 registers.
// ---------------------------------------------------------------------------
constexpr int kGatherWarps = 8;
constexpr int kGatherMinBlocks = 6;
constexpr int kGatherStage = 128;
constexpr int kLaneUnits = 2;
constexpr int kSeenBatch = 8;  // neighbours a group between coverage tests

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

template <typename T> __device__ inline T ones_unit();
template <> __device__ inline uint32_t ones_unit<uint32_t>() { return kFullMask; }
template <> __device__ inline uint4 ones_unit<uint4>() {
  return make_uint4(kFullMask, kFullMask, kFullMask, kFullMask);
}
__device__ inline bool full_units(uint32_t v) { return v == kFullMask; }
__device__ inline bool full_units(uint4 v) { return (v.x & v.y & v.z & v.w) == kFullMask; }
__device__ inline uint32_t shfl_from(uint32_t v, int src) {
  return __shfl_sync(kFullMask, v, src);
}
__device__ inline uint4 shfl_from(uint4 v, int src) {
  return make_uint4(shfl_from(v.x, src), shfl_from(v.y, src), shfl_from(v.z, src),
                    shfl_from(v.w, src));
}

// One destination row, by one warp (`off` and `occ_of` its staging in
// shared memory).
template <typename T, bool kLoss, bool kSeen, bool kRowSeen>
__device__ __forceinline__ void gather_row(
    const uint32_t* __restrict__ hist, const uint32_t* __restrict__ occ, int n_src,
    int slot_rows, int w, int sw, int ring, int tick, int uniform_slot,
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ delay, int r, int cap, const int32_t* __restrict__ rows,
    int n_out, const uint8_t* __restrict__ up, uint32_t loss_seed, uint32_t loss_limit,
    const uint32_t* __restrict__ loss_seeds, int id_offset,
    const uint32_t* __restrict__ seen, uint32_t* __restrict__ out,
    unsigned long long* off, uint32_t* occ_of) {
  const int lane = threadIdx.x & 31;
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
  const T* seen_row =
      kSeen ? reinterpret_cast<const T*>(seen + (size_t)dst_row * (size_t)w) : nullptr;
  const size_t e0 = (size_t)r * (size_t)cap;

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
    // The row's seen, one unit a lane, where it fits one load a lane
    // (lanes past the row hold ones: nothing lacking). Issued before the
    // staging's loads, which do not wait on it.
    T sv = ones_unit<T>();
    if (kRowSeen && lane < n_units) sv = __ldg(seen_row + lane);

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

    if constexpr (kSeen) {
      // 2. The sectors of `any` where the destination lacks a bit.
      uint32_t lack = 0u;
      if (kRowSeen) {
        const unsigned units = __ballot_sync(kFullMask, !full_units(sv));
        const int ups = 1 << sec_shift;
        lack = __ballot_sync(
            kFullMask,
            lane < nsec && ((units >> (lane << sec_shift)) & ((1u << ups) - 1u)) != 0u);
      } else {
        const int n_band = __popc(any) << sec_shift;
        for (int c = lane; c < n_band; c += 32) {
          const int s = nth_set_bit(any, c >> sec_shift);
          const int u = (s << sec_shift) + (c & ((1 << sec_shift) - 1));
          if (u < n_units && !full_units(__ldg(seen_row + u))) lack |= 1u << s;
        }
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) lack |= __shfl_xor_sync(kFullMask, lack, m);
      }
      const uint32_t band = any & lack;
      if (band != any) {  // warp-uniform: drop neighbours left with no sector
        int nk = 0;
        for (int jb = 0; jb < nv; jb += 32) {
          const int j = jb + lane;
          unsigned long long o = 0;
          uint32_t oc = 0u;
          if (j < nv) {
            o = off[j];
            oc = occ_of[j];
          }
          const bool keep = (oc & band) != 0u;
          const unsigned b = __ballot_sync(kFullMask, keep);
          __syncwarp();  // this chunk read before any lane overwrites it
          if (keep) {
            const int pos = nk + __popc(b & ((1u << lane) - 1u));
            off[pos] = o;
            occ_of[pos] = oc;
          }
          nk += __popc(b);
        }
        __syncwarp();
        nv = nk;
        any = band;
      }
    }

    // 3. Zeros outside the band, then passes over the band.
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
      if constexpr (!kSeen) {
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
      } else {
        // The accumulator starts at what the destination has: its seen
        // and what earlier rounds wrote. No unit: all ones (covered).
#pragma unroll
        for (int i = 0; i < kLaneUnits; ++i) {
          acc[i] = ones_unit<T>();
          if (unit[i] >= 0) {
            acc[i] = __ldg(seen_row + unit[i]);
            if (k0 > 0) acc[i] = or_units(acc[i], row_out[unit[i]]);
          }
        }
        const int step = groups * kSeenBatch;
        for (int jb = 0; jb < nv; jb += step) {
          bool want[kLaneUnits];
#pragma unroll
          for (int i = 0; i < kLaneUnits; ++i) want[i] = !full_units(acc[i]);
#pragma unroll
          for (int p = 0; p < kSeenBatch; ++p) {
            const int j = jb + p * groups + group;
            if (j < nv) {
              const uint32_t oc = occ_of[j];
              const T* row = src + off[j];
#pragma unroll
              for (int i = 0; i < kLaneUnits; ++i)
                if (want[i] && ((oc >> (unit[i] >> sec_shift)) & 1u))
                  acc[i] = or_units(acc[i], __ldg(row + unit[i]));
            }
          }
          bool left = false;
#pragma unroll
          for (int i = 0; i < kLaneUnits; ++i) {
            for (int m = lanes; m < 32; m <<= 1) acc[i] = or_units(acc[i], shfl_xor(acc[i], m));
            left |= !full_units(acc[i]);
          }
          if (jb + step < nv && !__any_sync(kFullMask, left)) break;  // covered
        }
        // Every group holds the warp's accumulator (each batch ends in
        // the fold; without a batch the groups' starts are equal).
#pragma unroll
        for (int i = 0; i < kLaneUnits; ++i)
          if (group == 0 && unit[i] >= 0)
            row_out[unit[i]] = and_not_units(acc[i], __ldg(seen_row + unit[i]));
      }
    }
    __syncwarp();  // the next round overwrites this round's staging
    k0 += kGatherStage;
  } while (k0 < cap);
}

template <typename T, bool kLoss, bool kSeen, bool kRowSeen>
__global__ void __launch_bounds__(kGatherWarps * 32, kLoss || kSeen ? kGatherMinBlocks : 0)
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
                 int id_offset, const uint32_t* __restrict__ seen,
                 uint32_t* __restrict__ out) {
  __shared__ unsigned long long s_off[kGatherWarps][kGatherStage];
  __shared__ uint32_t s_occ[kGatherWarps][kGatherStage];
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kGatherWarps + warp;
  if (r < n_rows)  // warp-uniform: only warp-level syncs inside
    gather_row<T, kLoss, kSeen, kRowSeen>(
        hist, occ, n_src, slot_rows, w, sw, ring, tick, uniform_slot, idx, mask, delay, r,
        cap, rows, n_out, up, loss_seed, loss_limit, loss_seeds, id_offset, seen, out,
        s_off[warp], s_occ[warp]);
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
// tick_update
//
// Replaces: no TPU kernel. The JAX package's tick update (engine/sync.py
//   apply_tick_updates: arrivals & ~seen, its popcount, the ORs into seen
//   and the frontier, the counters) is a few jnp expressions that XLA
//   fused into its own loops on the TPU. Eager PyTorch ran them as a chain
//   of elementwise passes, some 18 reads and writes of (N, W) planes a
//   tick, one of them a fresh plane built for the tick's few generation
//   bits.
// Computes, over the n rows of w words of seen, arrivals and out:
//   newly = arrivals & ~seen;  seen |= arrivals;  out = newly
//   cnt[r] = the set bits of row r of newly
//   newly_cnt[r] = cnt[r];  received[r] += cnt[r];
//   sent[r] += (cnt[r] + gen_cnt[r]) * degree[r]
//   in uint32, so the counters wrap as the engine's int32 counters do.
//   Then (tick_generations_kernel) for each event e with active[e], 0 <=
//   rows[e] < n and 0 <= slots[e] < 32 w: bit slots[e] % 32 of word
//   slots[e] / 32 of row rows[e] is ORed into seen and, when `out` is
//   passed to it, into out. The generations enter after newly is taken, as
//   the torch passes had it.
// Bound on the H100: bytes. A dense tick reads arrivals, reads and writes
//   seen and writes out: 16 B a word, 1.64 GB at 100,000 x 1,024. Where a
//   16-byte unit of arrivals is zero, seen does not change, so neither its
//   read nor its write is needed: a sparse frontier costs 8 B a word.
// Design: g lanes own a row, g the least power of two that gives each
//   lane at most kTickBatch of the row's units (16 bytes when the rows are
//   whole aligned 16-byte units, else 4), at most 32; a block of 256
//   threads holds 256 / g rows. So W = 1 puts 256 rows in a block, W = 128
//   (32 units) 8 lanes on a row, W = 1,024 a warp on a row. One code path
//   for every W. Each lane loads kTickBatch units of arrivals before it
//   uses any, then seen for those of them that are nonzero, so a lane
//   keeps that many loads in flight; seen is stored only where the unit's
//   newly is nonzero. (At 10^6 x 128 a warp a row, one unit a lane, took
//   0.85 ms dense and 0.69 sparse against 0.81 and 0.56 this way; a batch
//   of 8 was slower at both widths, PERF.md.) The row's count sums in registers and folds
//   over its g lanes by shuffle-XOR (every lane of the warp takes part,
//   rows past n with 0); the group's first lane writes the counters. The
//   events' launch is one thread an event, with atomicOr because two
//   events may share a word. It covers every event every tick, inactive
//   ones returning at once, so the host never reads how many fire.
// ---------------------------------------------------------------------------
constexpr int kTickThreads = 256;
constexpr int kTickBatch = 4;

__device__ inline bool any_bits(uint32_t v) { return v != 0u; }
__device__ inline bool any_bits(uint4 v) { return (v.x | v.y | v.z | v.w) != 0u; }
__device__ inline int popc_units(uint32_t v) { return __popc(v); }
__device__ inline int popc_units(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

template <typename T>
__global__ void __launch_bounds__(kTickThreads)
    tick_update_kernel(T* __restrict__ seen, const T* __restrict__ arrivals,
                       T* __restrict__ out, int n, int units, int g,
                       const int32_t* __restrict__ gen_cnt,
                       const int32_t* __restrict__ degree,
                       uint32_t* __restrict__ received, uint32_t* __restrict__ sent,
                       int32_t* __restrict__ newly_cnt) {
  const int sub = threadIdx.x & (g - 1);
  const long long row = (long long)blockIdx.x * (kTickThreads / g) + threadIdx.x / g;
  const bool live = row < n;
  int cnt = 0;
  if (live) {
    const size_t base = (size_t)row * (size_t)units;
    T* s_row = seen + base;
    const T* a_row = arrivals + base;
    T* o_row = out + base;
    for (int u0 = sub; u0 < units; u0 += g * kTickBatch) {
      T a[kTickBatch], s[kTickBatch];
#pragma unroll
      for (int i = 0; i < kTickBatch; ++i) {
        const int u = u0 + i * g;
        a[i] = u < units ? __ldcs(a_row + u) : zero_unit<T>();
      }
#pragma unroll
      for (int i = 0; i < kTickBatch; ++i) {
        const int u = u0 + i * g;
        s[i] = u < units && any_bits(a[i]) ? s_row[u] : zero_unit<T>();
      }
#pragma unroll
      for (int i = 0; i < kTickBatch; ++i) {
        const int u = u0 + i * g;
        if (u < units) {
          const T newly = and_not_units(a[i], s[i]);
          o_row[u] = newly;
          if (any_bits(newly)) {
            s_row[u] = or_units(s[i], a[i]);
            cnt += popc_units(newly);
          }
        }
      }
    }
  }
  for (int off = g >> 1; off > 0; off >>= 1) cnt += __shfl_xor_sync(kFullMask, cnt, off);
  if (live && sub == 0) {
    const uint32_t c = (uint32_t)cnt;
    newly_cnt[row] = (int32_t)c;
    received[row] += c;
    sent[row] += (c + (uint32_t)gen_cnt[row]) * (uint32_t)degree[row];
  }
}

__global__ void tick_generations_kernel(const long long* __restrict__ rows,
                                        const long long* __restrict__ slots,
                                        const uint8_t* __restrict__ active, int m,
                                        int n, int w, uint32_t* seen, uint32_t* out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m || !active[e]) return;
  const long long r = rows[e], s = slots[e];
  if (r < 0 || r >= n || s < 0 || s >= 32LL * w) return;
  const size_t off = (size_t)r * (size_t)w + (size_t)(s >> 5);
  const uint32_t bit = 1u << (unsigned)(s & 31);
  atomicOr(seen + off, bit);
  if (out != nullptr) atomicOr(out + off, bit);
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
//   gather that a group of kLanes lanes per destination row owns, 32 /
//   kLanes rows a warp and eight warps a block. The group ORs the base row,
//   the pulled row and its entries' rows in registers and stores each word
//   once: no atomics, no zero fill, and the result does not depend on the
//   entries' order. Lanes stride the row in 16-byte units when W % 4 == 0
//   and every table is 16-byte aligned (the entry point picks the
//   instantiation), 4-byte words otherwise. kLanes is the smallest power of
//   two at least the row's units, capped at 32; the caller computes it
//   (kernels.scatter_or_row_lanes) and passes it, so its launch counter and
//   the launch agree.
//   kLanes = 32 (rows of 32 units or more, e.g. W = 128 at uint4): a warp a
//   row, two units a lane a pass; wider rows take more passes. The warp
//   reads up to 32 entry indices with one coalesced load and broadcasts
//   them with __shfl_sync; a longer run (one hot destination) loops.
//   kLanes < 32 (narrow rows, e.g. W = 4 at uint4: one lane a row): a lane
//   holds at most one unit of its row. The group reads its run's entry
//   indices kScatterBatch or more at a time, one load each lane, and
//   broadcasts them with __shfl_sync within the group (width kLanes; a
//   lone lane keeps its own). A run longer than kScatterLongRun (a hub that
//   hundreds of nodes push to) would hold the whole warp behind one group:
//   its group leaves it, the warp finds such rows with __ballot_sync once
//   its short rows are done, and all 32 lanes take each in turn, 32 /
//   kLanes entries at a time, folding the row with __reduce_or_sync unit by
//   unit and word by word into the owning lane's registers. Every row is
//   still stored once, at the end, by its own group.
//   In both, source rows are loaded kScatterBatch entries at a time before
//   they are ORed, so a lane keeps several row loads in flight. Rows of src
//   are read through the read-only path; base is read with plain loads,
//   since it may be out.
// ---------------------------------------------------------------------------
constexpr int kScatterWarps = 8;
constexpr int kScatterLaneUnits = 2;
constexpr int kScatterBatch = 4;
// Runs longer than this leave a narrow group for the whole warp. On a 1M
// BA push-pull round at W = 4 (runs up to 685) 8 and 16 were fastest, 32
// 3% and 128 9% slower, and no long-run pass 45% slower; at campaign8's
// runs (at most ~9) the threshold is never reached.
constexpr int kScatterLongRun = 16;

__device__ inline uint32_t reduce_or(uint32_t v) { return __reduce_or_sync(kFullMask, v); }
__device__ inline uint4 reduce_or(uint4 v) {
  return make_uint4(reduce_or(v.x), reduce_or(v.y), reduce_or(v.z), reduce_or(v.w));
}

// scatter_or_kernel at kLanes < 32: a group of kLanes lanes a destination
// row, each lane at most one unit of it (the row has at most kLanes units).
template <typename T, bool kAndNot, int kLanes>
__device__ __forceinline__ void scatter_or_narrow(
    const uint32_t* src, int n_src, int w, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ entries, const int32_t* __restrict__ pull_row,
    const uint32_t* base, int n_out, uint32_t* out) {
  constexpr int kRows = 32 / kLanes;  // rows a warp
  // Entry indices a lane loads a step, so a group reads at least
  // kScatterBatch of its run at once.
  constexpr int kIdx = kLanes >= kScatterBatch ? 1 : kScatterBatch / kLanes;
  constexpr int kStep = kLanes * kIdx;
  constexpr int kUnitWords = (int)(sizeof(T) / sizeof(uint32_t));
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * kScatterWarps + (threadIdx.x >> 5)) * kRows;
  if (first >= n_out) return;  // warp-uniform: only warp-level syncs follow
  const int group = lane / kLanes;  // the lane's row in the warp
  const int u = lane % kLanes;      // the lane's unit of it
  const unsigned gmask = ((1u << kLanes) - 1u) << (group * kLanes);
  const int d = first + group;
  const bool row_ok = d < n_out;  // a row past n_out stays empty
  const int n_units = w / kUnitWords;
  const bool ok = row_ok && u < n_units;
  const T* rows = reinterpret_cast<const T*>(src);
  int e0 = 0, e1 = 0, p = -1;
  if (row_ok) {
    if (offsets) {
      e0 = offsets[d];
      e1 = offsets[d + 1];
    }
    if (pull_row) p = pull_row[d];
  }
  const T keep = base && ok  // kAndNot: the base words to clear
                     ? reinterpret_cast<const T*>(base + (size_t)d * (size_t)w)[u]
                     : zero_unit<T>();
  T acc = kAndNot ? zero_unit<T>() : keep;
  if (ok && p >= 0 && p < n_src) acc = or_units(acc, __ldg(rows + (size_t)p * n_units + u));

  // A long run is left to the whole warp; the group's first lane flags it.
  const bool hub = e1 - e0 > kScatterLongRun;
  const unsigned hubs = __ballot_sync(kFullMask, hub && u == 0);
  const int end = hub ? e0 : e1;  // group-uniform
  for (int eb = e0; eb < end; eb += kStep) {
    int mine[kIdx];
#pragma unroll
    for (int k = 0; k < kIdx; ++k) {
      const int e = eb + k * kLanes + u;
      mine[k] = e < end ? entries[e] : -1;
    }
    const int n = end - eb < kStep ? end - eb : kStep;
    for (int j = 0; j < n; j += kScatterBatch) {  // j == 0 alone when kIdx > 1
      T v[kScatterBatch];
#pragma unroll
      for (int q = 0; q < kScatterBatch; ++q) {
        int s;
        if constexpr (kLanes == 1) {
          s = mine[q];
        } else if constexpr (kIdx > 1) {
          s = __shfl_sync(gmask, mine[q / kLanes], q % kLanes, kLanes);
        } else {
          s = __shfl_sync(gmask, mine[0], (j + q) & (kLanes - 1), kLanes);
        }
        const bool live = j + q < n && s >= 0 && s < n_src;  // group-uniform
        v[q] = live && ok ? __ldg(rows + (size_t)s * n_units + u) : zero_unit<T>();
      }
#pragma unroll
      for (int q = 0; q < kScatterBatch; ++q) acc = or_units(acc, v[q]);
    }
  }

  // The long runs, one at a time with every lane: lane (slot, u) reads
  // unit u of entries h0 + slot, h0 + slot + kRows, ...
  for (unsigned h = hubs; h != 0u; h &= h - 1u) {
    const int lead = __ffs(h) - 1;  // the hub row's first lane
    const int h0 = __shfl_sync(kFullMask, e0, lead);
    const int h1 = __shfl_sync(kFullMask, e1, lead);
    const bool unit_ok = u < n_units;
    T part = zero_unit<T>();
    for (int eb = h0 + group; eb < h1; eb += kRows * kScatterBatch) {
      int s[kScatterBatch];
#pragma unroll
      for (int q = 0; q < kScatterBatch; ++q) {
        const int e = eb + q * kRows;
        s[q] = e < h1 ? entries[e] : -1;
      }
      T v[kScatterBatch];
#pragma unroll
      for (int q = 0; q < kScatterBatch; ++q)
        v[q] = unit_ok && s[q] >= 0 && s[q] < n_src ? __ldg(rows + (size_t)s[q] * n_units + u)
                                                    : zero_unit<T>();
#pragma unroll
      for (int q = 0; q < kScatterBatch; ++q) part = or_units(part, v[q]);
    }
    for (int uu = 0; uu < n_units; ++uu) {
      const T all = reduce_or(u == uu ? part : zero_unit<T>());
      if (lane == lead + uu) acc = or_units(acc, all);
    }
  }

  if (ok) {
    T* out_row = reinterpret_cast<T*>(out + (size_t)d * (size_t)w);
    out_row[u] = kAndNot ? and_not_units(acc, keep) : acc;
  }
}

template <typename T, bool kAndNot, int kLanes>
__global__ void __launch_bounds__(kScatterWarps * 32)
scatter_or_kernel(const uint32_t* src, int n_src, int w,
                  const int32_t* __restrict__ offsets,
                  const int32_t* __restrict__ entries,
                  const int32_t* __restrict__ pull_row, const uint32_t* base,
                  int n_out, uint32_t* out) {
  if constexpr (kLanes < 32) {
    scatter_or_narrow<T, kAndNot, kLanes>(src, n_src, w, offsets, entries, pull_row, base,
                                          n_out, out);
    return;
  }
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
// Computes, for each replica b < B and destination shard d < k: the words j
//   (flat index over replica b's (n_loc, W) row-major slice of the (B *
//   n_loc, W) `changed` rows) with changed[b, j] != 0 and need[j / W, d]
//   (`need` is shared by the replicas), in ascending j: idx[b, d, r] = j
//   and val[b, d, r] = changed[b, j] for the r-th of them while r <
//   capacity; counts[b, d] = how many there are (the true count, past
//   capacity too); every slot from min(count, capacity) on holds the JAX
//   padding, -1 and 0. B = 1 is the one-run exchange.
// Bound on the H100: bytes (the slice and `need` read once, the buffers
//   and counts written once); the ranking is a few integer operations a
//   word.
// Design: one pass over the slice, an ordered stream compaction with a
//   decoupled look-back across tiles (Merrill & Garland, "Single-pass
//   Parallel Prefix Scan with Decoupled Look-back", 2016).
//   - A block takes a tile of kCompressTileWords words from an atomic
//     ticket (the replica folded into it), so every earlier tile's block
//     has started and the look-back always advances.
//   - The tile goes to shared memory by 16-byte cp.async copies (thread t:
//     words 4t..4t+3 of each 1,024-word step), so no register holds it
//     between phases; each of its rows' k `need` bytes become one k-bit
//     mask in shared memory, read once for the row's W words.
//   - Ranks: a thread counts its words' candidates four destinations to a
//     32-bit word, a byte each (spread4); a shuffle scan ranks them in the
//     warp; one warp a destination scans the (step, warp) totals.
//   - That warp publishes the tile's count (a status word: flag and count
//     in 64 bits), looks back over its predecessors (an aggregate adds and
//     the look-back goes on, an inclusive prefix adds and ends it, a tile
//     not yet published is read again), and publishes the inclusive
//     prefix. The newest inclusive prefix trails a starting tile by about
//     a hundred tiles, so the warp reads kLookBackWindows windows of 32 in
//     one round trip. The loads and stores are relaxed at gpu scope: no
//     other data is published through a status word, and the flag and the
//     count travel in one word; an acquire load would hold back the loads
//     after it, and the window's loads are meant to be in flight together.
//   - Each slot is written once. The tile's kept candidates (ranks below
//     capacity) go to a shared stage, destination-major in rank order, and
//     each destination's run of slots is written with coalesced stores.
//     The last tile of a replica writes its counts; a second small launch
//     writes the padding slots [min(count, capacity), capacity) from the
//     counts alone (compress_pad_kernel). A tile with no rank below
//     capacity still counts but writes nothing.
//   - The replica's status words are its own, and its flat indices stay
//     below 2^31.
// ---------------------------------------------------------------------------
constexpr int kCompressThreads = 256;
constexpr int kCompressWarps = kCompressThreads / 32;
constexpr int kCompressSteps = 4;
constexpr int kCompressStepWords = kCompressThreads * 4;
constexpr int kCompressTileWords = kCompressSteps * kCompressStepWords;  // 4,096
constexpr int kCompressParts = kCompressSteps * kCompressWarps;  // (step, warp) parts
constexpr int kPartsPerLane = kCompressParts / 32;
constexpr int kLookBackWindows = 4;  // windows of 32 predecessors read at once
constexpr int kMaxDests = 32;
constexpr unsigned long long kTileAggregate = 1ull << 32;
constexpr unsigned long long kTilePrefix = 2ull << 32;
constexpr int kPadSlots = 4096;  // padding slots a block of compress_pad_kernel
static_assert(kCompressParts % 32 == 0, "whole (step, warp) parts a scan lane");

__device__ inline void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ inline unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}
__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// Four destination bits (bit e of x, x < 16) as four byte counts (byte e).
__device__ inline uint32_t spread4(uint32_t x) { return (x * 0x00204081u) & 0x01010101u; }

__device__ inline uint32_t warp_sum(uint32_t x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(kFullMask, x, m);
  return x;
}

__device__ inline uint32_t warp_inclusive_scan(uint32_t x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t t = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += t;
  }
  return x;
}

// The tile's exclusive prefix for one destination, from the status words
// `st` of its predecessors 0..tile-1 (all lanes of one warp call it). Lane
// l reads predecessor end-l of each of kLookBackWindows windows of 32 at
// once (one round trip), then walks the windows nearest first.
__device__ uint32_t look_back(const unsigned long long* st, int tile, int lane) {
  uint32_t sum = 0u;
  for (int end = tile - 1;; end -= 32 * kLookBackWindows) {
    unsigned long long s[kLookBackWindows];
#pragma unroll
    for (int i = 0; i < kLookBackWindows; ++i) {
      const int at = end - 32 * i - lane;
      s[i] = at >= 0 ? load_relaxed(st + at) : kTilePrefix;
    }
#pragma unroll
    for (int i = 0; i < kLookBackWindows; ++i) {
      const int at = end - 32 * i - lane;
      unsigned pre;
      for (;;) {
        // Only the lanes up to the nearest inclusive prefix (all 32 without
        // one) have to be published; the lanes past it are counted in it.
        pre = __ballot_sync(kFullMask, (s[i] & kTilePrefix) != 0ull);
        const unsigned upto = pre ? (2u << (__ffs(pre) - 1)) - 1u : kFullMask;
        if ((__ballot_sync(kFullMask, s[i] < kTileAggregate) & upto) == 0u) break;
        if (s[i] < kTileAggregate) s[i] = load_relaxed(st + at);
      }
      const int stop = pre ? __ffs(pre) - 1 : 31;
      sum += warp_sum(lane <= stop ? (uint32_t)s[i] : 0u);
      if (pre) return sum;
    }
  }
}

// The destinations of a step's four words j..j+3 (bit d of m[q]: word q
// is nonzero and its row is in destination d's cut), from the tile's row
// masks: one division a step, none where the four words are zero.
__device__ inline void step_dests(uint4 u, uint32_t j, int w, int row0,
                                  const uint32_t* s_mask, uint32_t (&m)[4]) {
  const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) m[q] = 0u;
  if ((u.x | u.y | u.z | u.w) == 0u) return;
  uint32_t row = j / (uint32_t)w;
  uint32_t col = j - row * (uint32_t)w;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (v[q] != 0u) m[q] = s_mask[row - row0];
    if (++col == (uint32_t)w) {
      col = 0u;
      ++row;
    }
  }
}

// KP 32-bit words of byte counts cover destinations 0..4*KP-1.
template <bool kVec, int KP>
__global__ void __launch_bounds__(kCompressThreads)
compress_deltas_kernel(const uint32_t* __restrict__ changed, int n_words, int w,
                       const uint8_t* __restrict__ need, int k, int tiles, int capacity,
                       unsigned long long* __restrict__ scratch, int32_t* __restrict__ idx,
                       uint32_t* __restrict__ val, int32_t* __restrict__ counts) {
  // Dynamic (compress_smem_bytes): the tile's words, the stage of kept
  // candidates (word positions in the tile), the tile's rows' masks.
  extern __shared__ uint4 s_dyn[];
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_dyn);
  uint32_t* s_stage = s_words + kCompressTileWords;
  uint32_t* s_mask = s_stage + kCompressTileWords;
  __shared__ uint32_t s_before[kCompressSteps][KP][kCompressThreads];  // see below
  __shared__ uint32_t s_total[kCompressParts][KP];  // (step, warp) -> a byte a destination
  __shared__ int s_rank[kCompressParts][4 * KP];    // (step, warp), d -> first rank in tile
  __shared__ int s_first[kMaxDests];                // d -> the tile's first rank
  __shared__ int s_keep[kMaxDests];                 // d -> its ranks below capacity
  __shared__ int s_off[kMaxDests + 1];              // d -> its first slot in s_stage
  __shared__ int s_ticket;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_ticket = (int)atomicAdd(scratch, 1ull);
  __syncthreads();
  const int b = s_ticket / tiles;
  const int tile = s_ticket - b * tiles;
  // Replica b's slice, status words, buffers and counts.
  changed += (long long)b * n_words;
  unsigned long long* status = scratch + 1 + (long long)b * k * tiles;
  idx += (long long)b * k * capacity;
  val += (long long)b * k * capacity;
  counts += (long long)b * k;

  // Step s, thread t: words j0 + s * 1024 + 4t .. + 3, at the same place of
  // s_words (zeros past the slice).
  const int j0 = tile * kCompressTileWords;
  const uint32_t jt = (uint32_t)j0 + 4u * threadIdx.x;
  uint4* s_words4 = reinterpret_cast<uint4*>(s_words);
#pragma unroll
  for (int s = 0; s < kCompressSteps; ++s) {
    const long long j = (long long)jt + s * kCompressStepWords;
    uint4* dst = s_words4 + s * kCompressThreads + threadIdx.x;
    if (kVec) {
      if (j < n_words) cp_async16(dst, changed + j);
      else *dst = make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint32_t* d4 = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
      for (int q = 0; q < 4; ++q) d4[q] = j + q < n_words ? __ldg(changed + j + q) : 0u;
    }
  }
  const int row0 = j0 / w;
  const long long j_last = min((long long)j0 + kCompressTileWords, (long long)n_words) - 1;
  const int rows = (int)(j_last / w) - row0 + 1;
  for (int r = threadIdx.x; r < rows; r += kCompressThreads) {
    const uint8_t* p = need + (long long)(row0 + r) * k;
    uint32_t m = 0u;
    for (int d = 0; d < k; ++d) m |= (uint32_t)(__ldg(p + d) != 0) << d;
    s_mask[r] = m;
  }
  if (kVec) cp_async_wait_all();
  __syncthreads();

  // s_before: the candidates of the warp's earlier threads in each step, a
  // byte a destination; s_total: the (step, warp) totals.
#pragma unroll 1
  for (int s = 0; s < kCompressSteps; ++s) {
    uint32_t m[4];
    step_dests(s_words4[s * kCompressThreads + threadIdx.x], jt + s * kCompressStepWords, w,
               row0, s_mask, m);
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      uint32_t own = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) own += spread4((m[q] >> (4 * p)) & 0xFu);
      const uint32_t inc = warp_inclusive_scan(own, lane);  // bytes <= 128: no carry
      s_before[s][p][threadIdx.x] = inc - own;
      if (lane == 31) s_total[s * kCompressWarps + warp][p] = inc;
    }
  }
  __syncthreads();

  // One warp a destination: the scan of the tile's (step, warp) totals
  // (kPartsPerLane a lane), the look-back, the inclusive prefix published.
  for (int d = warp; d < k; d += kCompressWarps) {
    uint32_t c[kPartsPerLane];
    uint32_t mine = 0u;
#pragma unroll
    for (int i = 0; i < kPartsPerLane; ++i) {
      c[i] = (s_total[lane * kPartsPerLane + i][d >> 2] >> (8 * (d & 3))) & 0xFFu;
      mine += c[i];
    }
    const uint32_t inc = warp_inclusive_scan(mine, lane);
    const uint32_t agg = __shfl_sync(kFullMask, inc, 31);
    unsigned long long* st = status + (long long)d * tiles;
    uint32_t prefix = 0u;
    if (tile > 0) {
      if (lane == 0) store_relaxed(st + tile, kTileAggregate | agg);
      prefix = look_back(st, tile, lane);
    }
    if (lane == 0) {
      store_relaxed(st + tile, kTilePrefix | (prefix + agg));
      if (tile == tiles - 1) counts[d] = (int32_t)(prefix + agg);
      s_first[d] = (int)prefix;
      s_keep[d] = prefix >= (uint32_t)capacity ? 0 : (int)min(agg, capacity - prefix);
    }
    uint32_t first = inc - mine;
#pragma unroll
    for (int i = 0; i < kPartsPerLane; ++i) {
      s_rank[lane * kPartsPerLane + i][d] = (int)first;
      first += c[i];
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int keep = lane < k ? s_keep[lane] : 0;
    const int inc = (int)warp_inclusive_scan((uint32_t)keep, lane);
    if (lane < k) s_off[lane] = inc - keep;
    if (lane == k - 1) s_off[k] = inc;
  }
  __syncthreads();
  if (s_off[k] == 0) return;  // block-uniform: nothing below capacity

  // Destinations d_lo..d_hi-1 whose kept runs fit the stage at once (all of
  // them, unless the tile is dense): stage, then write each run.
  for (int d_lo = 0; d_lo < k;) {
    int d_hi = d_lo + 1;
    while (d_hi < k && s_off[d_hi + 1] - s_off[d_lo] <= kCompressTileWords) ++d_hi;
#pragma unroll 1
    for (int s = 0; s < kCompressSteps; ++s) {
      uint32_t m[4];
      step_dests(s_words4[s * kCompressThreads + threadIdx.x], jt + s * kCompressStepWords, w,
                 row0, s_mask, m);
      if ((m[0] | m[1] | m[2] | m[3]) == 0u) continue;
      const int pos = s * kCompressStepWords + 4 * threadIdx.x;  // the word's place in the tile
      const int* rank = s_rank[s * kCompressWarps + warp];
#pragma unroll
      for (int p = 0; p < KP; ++p) {
        uint32_t run = s_before[s][p][threadIdx.x];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t bits = (m[q] >> (4 * p)) & 0xFu;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 4 * p + e;
            if (((bits >> e) & 1u) && d >= d_lo && d < d_hi) {
              const int r = rank[d] + (int)((run >> (8 * e)) & 0xFFu);
              if (r < s_keep[d]) s_stage[s_off[d] - s_off[d_lo] + r] = (uint32_t)(pos + q);
            }
          }
          run += spread4(bits);
        }
      }
    }
    __syncthreads();
    for (int d = d_lo; d < d_hi; ++d) {
      const int from = s_off[d] - s_off[d_lo];
      const long long at = (long long)d * capacity + s_first[d];
      for (int i = threadIdx.x; i < s_keep[d]; i += kCompressThreads) {
        const uint32_t pos = s_stage[from + i];
        idx[at + i] = j0 + (int32_t)pos;
        val[at + i] = s_words[pos];
      }
    }
    d_lo = d_hi;
    if (d_lo < k) __syncthreads();  // before the stage fills again
  }
}

// The padding of each (replica, destination) buffer row: slots from
// min(counts[row], capacity) on get -1 and 0. A block covers kPadSlots
// slots of one row (16-byte stores where the row allows them).
template <bool kVec>
__global__ void __launch_bounds__(256)
compress_pad_kernel(const int32_t* __restrict__ counts, int capacity, int chunks,
                    int32_t* __restrict__ idx, uint32_t* __restrict__ val) {
  const long long row = blockIdx.x / chunks;
  const int s0 = (int)(blockIdx.x - row * chunks) * kPadSlots;
  const int s1 = min(s0 + kPadSlots, capacity);
  const int from = max(s0, min(__ldg(counts + row), capacity));
  if (from >= s1) return;
  idx += row * capacity;
  val += row * capacity;
  if (kVec) {
    // Scalar up to the first 16-byte boundary, then four slots a store.
    const int head = min((from + 3) & ~3, s1);
    for (int s = from + threadIdx.x; s < head; s += blockDim.x) {
      idx[s] = -1;
      val[s] = 0u;
    }
    for (int s = head + 4 * threadIdx.x; s < s1; s += 4 * blockDim.x) {
      if (s + 4 <= s1) {
        *reinterpret_cast<int4*>(idx + s) = make_int4(-1, -1, -1, -1);
        *reinterpret_cast<uint4*>(val + s) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        for (int t = s; t < s1; ++t) {
          idx[t] = -1;
          val[t] = 0u;
        }
      }
    }
  } else {
    for (int s = from + threadIdx.x; s < s1; s += blockDim.x) {
      idx[s] = -1;
      val[s] = 0u;
    }
  }
}

// compress_deltas_kernel's dynamic shared memory for rows of w words: the
// tile, the stage and one mask a row the tile touches.
int compress_smem_bytes(int w) {
  const int rows = kCompressTileWords / w + 2;
  return (2 * kCompressTileWords + (rows < kCompressTileWords ? rows : kCompressTileWords)) *
         (int)sizeof(uint32_t);
}

constexpr int kMaxDevices = 64;

// The main kernel's instantiation for k <= 4 * kp destinations.
template <bool kVec>
void launch_compress(int kp, unsigned blocks, cudaStream_t stream,
                     const uint32_t* changed, int n_words, int w, const uint8_t* need,
                     int k, int tiles, int capacity, unsigned long long* scratch,
                     int32_t* idx, uint32_t* val, int32_t* counts) {
  const int smem = compress_smem_bytes(w);
  int dev = 0;
  cudaGetDevice(&dev);
  // The opt-in above 48 KB (rows of 1 or 2 words), once a device and kernel.
#define GOSSIP_COMPRESS(KP)                                                          \
  {                                                                                  \
    static bool opted[kMaxDevices];                                                  \
    if (dev >= kMaxDevices || !opted[dev]) {                                         \
      cudaFuncSetAttribute(compress_deltas_kernel<kVec, KP>,                         \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,              \
                           compress_smem_bytes(1));                                  \
      if (dev < kMaxDevices) opted[dev] = true;                                      \
    }                                                                                \
    compress_deltas_kernel<kVec, KP><<<blocks, kCompressThreads, smem, stream>>>(    \
        changed, n_words, w, need, k, tiles, capacity, scratch, idx, val, counts);   \
  }
  switch (kp) {
    case 1: GOSSIP_COMPRESS(1) break;
    case 2: GOSSIP_COMPRESS(2) break;
    case 4: GOSSIP_COMPRESS(4) break;
    default: GOSSIP_COMPRESS(8) break;
  }
#undef GOSSIP_COMPRESS
}

// ---------------------------------------------------------------------------
// scatter_deltas
//
// Replaces: p2p_gossip_tpu/parallel/exchange.py scatter_deltas (XLA: a
//   scatter-set into a zero (n_padded * W,) canvas, mode="drop").
// Computes, for each replica b < B: out[b, s * src_words + idx[s, b, e]] =
//   val[s, b, e] for every entry with idx >= 0 whose word falls inside
//   replica b's canvas of canvas_words words (the caller zeroes the (B,
//   canvas_words) output). B = 1 is the one-run rebuild.
// Bound on the H100: bytes (the canvas written once, the buffers read once).
// Design: one thread an entry, the replica on grid y; sources own disjoint
//   rows, so no two entries store to one word and no atomics are needed.
// ---------------------------------------------------------------------------
__global__ void scatter_deltas_kernel(const int32_t* __restrict__ idx,
                                      const uint32_t* __restrict__ val,
                                      long long n_entries, int capacity,
                                      long long src_words, long long canvas_words,
                                      uint32_t* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;  // n_entries = n_srcs * capacity, a replica's
  const long long s = e / capacity;
  const long long at = (s * gridDim.y + blockIdx.y) * capacity + (e - s * capacity);
  const int i = __ldg(idx + at);
  if (i < 0) return;
  const long long g = s * src_words + i;
  if (g < canvas_words) out[(long long)blockIdx.y * canvas_words + g] = __ldg(val + at);
}

// ---------------------------------------------------------------------------
// or_fold
//
// Replaces: p2p_gossip_tpu/parallel/protocols_sharded.py _reduce_scatter_or
//   (XLA: lax.reduce with bitwise_or over axis 0 of the all_to_all's
//   (k, n_loc, W) stack of pushed rows).
// Computes: out[i] = OR over j < k of stack[j * n + i], n = n_loc * W words
//   (k >= 1: k = 1 is a copy).
// Bound on the H100: bytes (k * n words read once, n words written once).
// Design: one thread per 16-byte unit of the output, k 16-byte loads (one
//   from each slice, n words apart) and one 16-byte store; no shared memory,
//   no reduction tree. When n is not a multiple of 4 the slices are not
//   16-byte aligned, and the scalar instantiation takes one word a thread.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
or_fold_kernel(const T* __restrict__ stack, long long items, int k, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= items) return;
  T acc = __ldg(stack + i);
  for (int j = 1; j < k; ++j) acc = or_units(acc, __ldg(stack + (long long)j * items + i));
  out[i] = acc;
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
// `seen` (null: the unmasked gather) has out's rows and masks the output
// with ~seen.
int gossip_gather_or(const void* hist, const void* occ, int n_src, int w,
                     int ring, int tick, int uniform_slot, const void* idx,
                     const void* mask, const void* delay, int n_rows, int cap,
                     const void* rows, int n_out, const void* up, int loss_on,
                     unsigned int loss_seed, unsigned int loss_limit,
                     const void* loss_seeds, int replicas, int id_offset,
                     const void* seen, void* out, void* stream) {
  const dim3 grid((unsigned)((n_rows + kGatherWarps - 1) / kGatherWarps),
                  (unsigned)replicas);
  const int sw = sector_words(w);
  const bool vec = w % 4 == 0 && aligned16(hist) && aligned16(out) &&
                   (!seen || aligned16(seen));
#define GOSSIP_GATHER_LAUNCH(T, LOSS, SEEN, ROW)                               \
  gather_or_kernel<T, LOSS, SEEN, ROW><<<grid, kGatherWarps * 32, 0,            \
                                         (cudaStream_t)stream>>>(               \
      (const uint32_t*)hist, (const uint32_t*)occ, n_src, replicas * n_src, w, \
      sw, ring, tick,                                                          \
      uniform_slot, (const int32_t*)idx, (const uint8_t*)mask,                 \
      (const int32_t*)delay, n_rows, cap, (const int32_t*)rows, n_out,         \
      (const uint8_t*)up, loss_seed, loss_limit, (const uint32_t*)loss_seeds, \
      id_offset, (const uint32_t*)seen, (uint32_t*)out)
#define GOSSIP_GATHER_SEEN(T, LOSS)                                            \
  if (!seen) {                                                                 \
    GOSSIP_GATHER_LAUNCH(T, LOSS, false, false);                               \
  } else if (w / (int)(sizeof(T) / 4) <= 32) {                                 \
    GOSSIP_GATHER_LAUNCH(T, LOSS, true, true);                                 \
  } else {                                                                     \
    GOSSIP_GATHER_LAUNCH(T, LOSS, true, false);                                \
  }
  if (vec && loss_on) {
    GOSSIP_GATHER_SEEN(uint4, true);
  } else if (vec) {
    GOSSIP_GATHER_SEEN(uint4, false);
  } else if (loss_on) {
    GOSSIP_GATHER_SEEN(uint32_t, true);
  } else {
    GOSSIP_GATHER_SEEN(uint32_t, false);
  }
#undef GOSSIP_GATHER_SEEN
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
// `seen`, `arrivals` and `out` are (n, w) row-major and distinct; `gen_cnt`,
// `degree`, `received`, `sent` and `newly_cnt` (n,) 32-bit; `rows` and
// `slots` (m,) int64, `active` (m,) bytes. frontier == 0: the generation
// bits go into seen only. Two launches, the row pass then the events'.
int gossip_tick_update(void* seen, const void* arrivals, void* out, int n, int w,
                       const void* gen_cnt, const void* degree, void* received, void* sent,
                       void* newly_cnt, const void* rows, const void* slots,
                       const void* active, int m, int frontier, void* stream) {
  if (n < 0 || w < 1 || m < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = w % 4 == 0 && aligned16(seen) && aligned16(arrivals) && aligned16(out);
  const int units = vec ? w / 4 : w;
  int g = 1;
  while (g * kTickBatch < units && g < 32) g <<= 1;
  const int rows_per_block = kTickThreads / g;
  const long long blocks = ((long long)n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0) {
#define GOSSIP_TICK_UPDATE_LAUNCH(T)                                                  \
  tick_update_kernel<T><<<(unsigned)blocks, kTickThreads, 0, s>>>(                    \
      (T*)seen, (const T*)arrivals, (T*)out, n, units, g, (const int32_t*)gen_cnt,    \
      (const int32_t*)degree, (uint32_t*)received, (uint32_t*)sent, (int32_t*)newly_cnt)
    if (vec) {
      GOSSIP_TICK_UPDATE_LAUNCH(uint4);
    } else {
      GOSSIP_TICK_UPDATE_LAUNCH(uint32_t);
    }
#undef GOSSIP_TICK_UPDATE_LAUNCH
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (m > 0) {
    const int threads = 256;
    tick_generations_kernel<<<(unsigned)((m + threads - 1) / threads), threads, 0, s>>>(
        (const long long*)rows, (const long long*)slots, (const uint8_t*)active, m, n, w,
        (uint32_t*)seen, frontier ? (uint32_t*)out : nullptr);
  }
  return (int)cudaGetLastError();
}

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
// row-major with W words a row. `lanes` (1, 2, 4, 8, 16 or 32) is the
// lanes a destination row takes, kernels.scatter_or_row_lanes of W and of
// the instantiation below; any other value, or fewer lanes than the row's
// units (at most 32) at the instantiation picked here, refuses the launch.
int gossip_scatter_or(const void* src, int n_src, int w, const void* offsets,
                      const void* entries, const void* pull_row,
                      const void* base, int and_not, int n_out, void* out,
                      int lanes, void* stream) {
  const bool vec = w % 4 == 0 && aligned16(src) && aligned16(out) &&
                   (base == nullptr || aligned16(base));
  // A group narrower than the row would leave its units past the group's
  // lanes unwritten: refuse it, whatever the caller's test of alignment.
  const int units = vec ? w / 4 : w;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      lanes < (units < 32 ? units : 32))
    return (int)cudaErrorInvalidValue;
  const int rows_per_block = kScatterWarps * 32 / lanes;
  const dim3 grid((unsigned)((n_out + rows_per_block - 1) / rows_per_block));
#define GOSSIP_SCATTER_LAUNCH(T, ANDNOT, LANES)                                    \
  scatter_or_kernel<T, ANDNOT, LANES><<<grid, kScatterWarps * 32, 0,             \
                                        (cudaStream_t)stream>>>(                  \
      (const uint32_t*)src, n_src, w, (const int32_t*)offsets,                     \
      (const int32_t*)entries, (const int32_t*)pull_row, (const uint32_t*)base,    \
      n_out, (uint32_t*)out)
#define GOSSIP_SCATTER_LANES(T, ANDNOT)                                            \
  switch (lanes) {                                                                 \
    case 1: GOSSIP_SCATTER_LAUNCH(T, ANDNOT, 1); break;                            \
    case 2: GOSSIP_SCATTER_LAUNCH(T, ANDNOT, 2); break;                            \
    case 4: GOSSIP_SCATTER_LAUNCH(T, ANDNOT, 4); break;                            \
    case 8: GOSSIP_SCATTER_LAUNCH(T, ANDNOT, 8); break;                            \
    case 16: GOSSIP_SCATTER_LAUNCH(T, ANDNOT, 16); break;                          \
    default: GOSSIP_SCATTER_LAUNCH(T, ANDNOT, 32); break;                          \
  }
  if (vec && and_not) {
    GOSSIP_SCATTER_LANES(uint4, true);
  } else if (vec) {
    GOSSIP_SCATTER_LANES(uint4, false);
  } else if (and_not) {
    GOSSIP_SCATTER_LANES(uint32_t, true);
  } else {
    GOSSIP_SCATTER_LANES(uint32_t, false);
  }
#undef GOSSIP_SCATTER_LANES
#undef GOSSIP_SCATTER_LAUNCH
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


// `changed` is (replicas * n_loc, w) row-major, n_loc * w < 2^31 words; `need`
// is (n_loc, k) bytes, k <= 32, shared by the replicas; `scratch` holds 1 +
// replicas x k x gossip_compress_tiles(n_loc * w) 64-bit words (the ticket
// and the tiles' status words, zeroed here); idx/val (replicas, k,
// capacity) and `counts` (replicas, k) are written here, every slot once.
int gossip_compress_tiles(long long n_words) {
  return (int)((n_words + kCompressTileWords - 1) / kCompressTileWords);
}

int gossip_compress_deltas(const void* changed, int n_loc, int w, const void* need, int k,
                           int capacity, void* scratch, void* idx, void* val,
                           void* counts, int replicas, void* stream) {
  const long long n_words = (long long)n_loc * w;
  if (k < 1 || k > kMaxDests || replicas < 1 || capacity < 1 || n_loc < 0 || w < 0 ||
      n_words >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long tiles = gossip_compress_tiles(n_words);
  const long long pad_chunks = (capacity + kPadSlots - 1) / kPadSlots;
  if (tiles * replicas > 0x7fffffffLL || pad_chunks * k * replicas > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (tiles == 0) {
    err = cudaMemsetAsync(counts, 0, (size_t)replicas * k * sizeof(int32_t), s);
  } else {
    err = cudaMemsetAsync(scratch, 0, (size_t)(1 + replicas * k * tiles) * 8, s);
    if (err != cudaSuccess) return (int)err;
    const int kp = k <= 4 ? 1 : k <= 8 ? 2 : k <= 16 ? 4 : 8;
    const bool vec = n_words % 4 == 0 && aligned16(changed);
    (vec ? launch_compress<true> : launch_compress<false>)(
        kp, (unsigned)(tiles * replicas), s, (const uint32_t*)changed, (int)n_words, w,
        (const uint8_t*)need, k, (int)tiles, capacity, (unsigned long long*)scratch,
        (int32_t*)idx, (uint32_t*)val, (int32_t*)counts);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  const unsigned pad_blocks = (unsigned)(pad_chunks * k * replicas);
  if (capacity % 4 == 0 && aligned16(idx) && aligned16(val)) {
    compress_pad_kernel<true><<<pad_blocks, 256, 0, s>>>(
        (const int32_t*)counts, capacity, (int)pad_chunks, (int32_t*)idx, (uint32_t*)val);
  } else {
    compress_pad_kernel<false><<<pad_blocks, 256, 0, s>>>(
        (const int32_t*)counts, capacity, (int)pad_chunks, (int32_t*)idx, (uint32_t*)val);
  }
  return (int)cudaGetLastError();
}

// `idx`/`val` are (n_srcs, replicas, capacity); replica b's source s's
// entries land at word s * src_words + idx of replica b's (zeroed) canvas of
// canvas_words words, the canvases one after another in `out`.
int gossip_scatter_deltas(const void* idx, const void* val, int n_srcs, int capacity,
                          long long src_words, long long canvas_words, int replicas,
                          void* out, void* stream) {
  if (replicas < 1 || replicas > 65535) return (int)cudaErrorInvalidValue;
  const long long n = (long long)n_srcs * capacity;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    scatter_deltas_kernel<<<dim3((unsigned)blocks, replicas), threads, 0,
                            (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const uint32_t*)val, n, capacity, src_words, canvas_words,
        (uint32_t*)out);
  return (int)cudaGetLastError();
}

// `stack` is (k, n_words) row-major, k >= 1; out holds n_words words.
int gossip_or_fold(const void* stack, long long n_words, int k, void* out, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const bool vec = n_words % 4 == 0 && aligned16(stack) && aligned16(out);
  const long long items = vec ? n_words / 4 : n_words;
  const long long blocks = (items + threads - 1) / threads;
  if (blocks > 0) {
    if (vec) {
      or_fold_kernel<uint4><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          (const uint4*)stack, items, k, (uint4*)out);
    } else {
      or_fold_kernel<uint32_t><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)stack, items, k, (uint32_t*)out);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
