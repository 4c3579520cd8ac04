// The LLC round loop of one epoch chunk, every round in one launch.
//
// No Pallas kernel computes this: in the JAX package the round loop is
// plain JAX under lax.scan (repro/core/llc.py: round_transition :213,
// round_step_fn :335, _scan_rounds, simulate_epoch(_lanes)) and, in the
// fused engine, a lax.while_loop over the rounds of an epoch
// (repro/core/fused.py::_run_rounds_batch :496).  The port's plain version
// (kernels/llc_rounds/ops.py) runs ~70 small torch ops a round, so a round
// cost the host's dispatch; this kernel runs all rounds of a chunk.
//
// Semantics (round_transition, per round r of every lane l):
//   * rounds are applied in order; round r's events are the column
//     line[l, r, :] / meta[l, r, :], at most one per set; an event whose
//     meta lacks M_VALID (padding: line -1, meta 0) changes nothing;
//   * every event of a round reads the SHCT tables as they stood at the
//     round's start; the round's +1 / -1 deltas are then added (integers:
//     the order of the adds cannot change a sum), and the tables clipped
//     to [0, counter_max] (the whole table after the first round, as the
//     JAX .at[].add then clip does; afterwards only the entries a round
//     touched can leave the range, so only those are clipped);
//   * ties go to the first way (argmax of the hit vector, first empty
//     way, argmin of the LRU ticks over the allowed ways, way 0 when no
//     way is allowed);
//   * sampler sets are s & ((1 << sampler_shift) - 1) == 0;
//   * the tick advances on every round, padding rounds too.
// With n_rounds (the fused engine's round count per lane) the chunk runs
// max(n_rounds) over all lanes instead of all R rows, as the JAX
// while_loop does.
//
// Bound on the card: a chain of R dependent rounds; the bytes (events
// read once, state read and written once) are far under a microsecond at
// 3.35 TB/s.  On an H100 (tools/llc_rounds_probe.py --ablation) a chunk of
// the cluster kernel costs the launch of the clusters, the cluster
// barriers (their release fence, ~0.5 us each, against ~0.05 us relaxed),
// and per round the chain of one event's search.  Two designs share these
// semantics:
//
// llc_rounds (the path's kernel): one thread-block cluster of C CTAs per
// lane, launched with cudaLaunchKernelEx (C up to 16, non-portable above
// 8; cudaOccupancyMaxActiveClusters checks the shape).  The lane's sets
// are cut into C contiguous blocks, one per CTA; L lanes are L clusters,
// which run in waves when they exceed the card.
//   * The set rows stay in shared memory for the whole chunk, struct of
//     arrays (tag, lru tick, and sig with owner and reused in its bits 30
//     and 29), loaded once at the start and written back once at the end.
//   * Each set is searched by a group of Wp lanes of a warp (W rounded up
//     to a power of two), one way a lane: the hit and the first empty way
//     are the first set bits of two __ballot_sync, the LRU victim the
//     first way whose tick equals the group's minimum (__reduce_min_sync
//     at Wp = 32, a butterfly of __shfl_xor_sync below), and the victim's
//     and the hit way's fields come by __shfl_sync.  No loop over the
//     ways remains.
//   * With SHIP_DEFAULT (2 x 4096 int32, 32 KB) every CTA holds a replica
//     of both SHCT tables.  An event that makes a delta posts it, one word
//     per sampler set, into a mailbox in the shared memory of every CTA of
//     the cluster (distributed shared memory, cluster.map_shared_rank) and
//     stamps the round into each CTA's flag.  A cluster barrier
//     (barrier.cluster.arrive.release / wait.acquire) ends the round: it
//     separates every read of the round from the adds.  A CTA whose flag
//     holds the round's stamp (every CTA sees the same) then applies the
//     mailbox to its own replica, clips what it touched, and goes on
//     after a __syncthreads; all replicas receive the same adds, so they
//     stay equal.  A barrier round with no delta in the cluster costs the
//     one cluster barrier.  The mailbox and the flag are double-buffered
//     by the parity of the barriers, and stamped, so nothing is reset
//     across CTAs.
//   * Only a valid event of a sampler set can make a delta.  At the start
//     every CTA reads the sampler sets' events of all rounds (the same
//     data, so all agree) and marks the rounds that have one; the other
//     rounds end in no barrier at all: the tables cannot change there, so
//     each warp goes on to its sets' next round at its own pace.
//   * SHIP_LARGE (128 K entries, 1 MB a lane) stays in device memory: the
//     deltas go to the mailbox of CTA 0 alone, which applies and clips
//     them on the one copy, and a second cluster barrier publishes the
//     tables before the next round reads them (L2 reads, __ldcg).
//   * The events (meta, line) of a CTA's sets come into shared memory
//     kBlock rounds at a time with cp.async, one block ahead (two halves).
//     On its arrival each warp marks, per set it takes, the rounds of the
//     block with a valid event (a __ballot_sync a Wp rounds) and then
//     visits only those rounds and the barrier rounds: with ~5 % of a
//     chunk's slots valid, most warps skip most rounds.  The tick of a
//     round is the chunk's first tick plus the round.
//   * Stats are counted in registers, per-core counts with shared
//     atomics, and both are folded once at the end through distributed
//     shared memory into CTA 0 of the cluster.
//
// llc_rounds_simple (the first design, kept for the cross-check and for
// timing the two in turns; on no path): one CTA per lane, its threads
// striding over the sets, the set rows in device memory (each set belongs
// to one thread), the two SHCT tables in shared memory when both fit and
// else in device memory; a round with no SHCT delta in the whole CTA costs
// one barrier (__syncthreads_or), one with deltas three.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSetsPerThread = 4;   // simple kernel: S <= 4096
constexpr int kMaxRounds = (1 << 16) / kMaxSetsPerThread - 1;
constexpr int kStats = 10;
constexpr int kCores = 8;
constexpr int kFold = kStats + 2 * kCores;
constexpr int kKnobs = 5;  // accel_mode, core_bypass, shared, core, accel mask

constexpr int M_VALID = 1 << 0;
constexpr int M_ACCEL = 1 << 1;
constexpr int M_WRITE = 1 << 2;
constexpr int M_HINT = 1 << 3;
constexpr int M_PREFETCH = 1 << 4;
constexpr int M_DLOK = 1 << 5;
constexpr int M_SRC_SHIFT = 8;

constexpr int A_NONE = 0;
constexpr int A_SHIP = 2;

// the cluster kernel
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 16;
constexpr int kBlock = 16;               // rounds of events a ring half
constexpr int kMaxIt = 8;                // sets a lane group takes a round
constexpr int kOwnerBit = 1 << 30;       // in a row's packed sig word
constexpr int kReusedBit = 1 << 29;
constexpr int kSigMask = kReusedBit - 1;
constexpr int kMaxEntries = 1 << 20;     // a mailbox word holds idx << 3
constexpr int kHeader = kFold + 4;       // fold, stamps, round count
constexpr int kNeedScan = 1 << 18;       // sampler events read at the start
// stages of a round: the path runs kAll; the others exist for the probe's
// ablation (tools/llc_rounds_probe.py) and compute no simulator result
constexpr int kBarriers = 0;  // the kernel's cluster barriers, nothing else
constexpr int kEvents = 1;    // + the ring of events, read and counted
constexpr int kRows = 2;      // + the way-parallel search and row updates
constexpr int kAll = 3;       // + the SHCT reads, deltas and clips
// the probe's barrier loops beside kBarriers: a relaxed cluster arrive
// (barrier.cluster.arrive.relaxed, then wait), and __syncthreads alone
constexpr int kRelaxedBarriers = 4;
constexpr int kCtaBarriers = 5;
__host__ __device__ constexpr bool only_barriers(int stage) {
  return stage == kBarriers || stage == kRelaxedBarriers ||
         stage == kCtaBarriers;
}

struct Params {
  const int* line;      // [L, R, S]
  const int* meta;      // [L, R, S]
  const int* knobs;     // [L, kKnobs]
  const int* n_rounds;  // [L] or null
  int* tags;            // [L, S, W]
  int* lru;
  int* owner;
  int* sig;
  uint8_t* reused;      // bool [L, S, W]
  int* tick;            // [L]
  int* shct_core;       // [L, T]
  int* shct_accel;      // [L, T]
  int* stats;           // [L, kStats]
  int* percore;         // [L, kCores, 2]
  int n_lanes, rounds, sets, ways, entries, sampler_shift, region_lines,
      counter_max, smem_tables;
  // the cluster kernel's shape: CTAs a lane, sets a CTA, mailbox words
  // (sampler sets), log2 of the lanes that search one set
  int cluster, cta_sets, slots, wp_shift;
};

// ship.signature: the line's 32-line region, xor-folded and hashed in
// uint32, into the table's index space.
__device__ __forceinline__ int signature(int line, int region, int entries) {
  long long q = static_cast<long long>(line) / region;
  if (line % region != 0 && line < 0) --q;  // floor division
  uint32_t r = static_cast<uint32_t>(q);
  uint32_t h = r ^ (r >> 7) ^ (r >> 15);
  h *= 0x9E3779B9u;
  return static_cast<int>(h >> 16) & (entries - 1);
}

// signature() for the cluster kernel: a region of 2^region_shift lines
// (region_shift >= 0) is an arithmetic shift, which floors as the
// division does; else the division.
__device__ __forceinline__ int signature_at(int line, int region,
                                            int region_shift, int entries) {
  if (region_shift < 0) return signature(line, region, entries);
  uint32_t r = static_cast<uint32_t>(line >> region_shift);
  uint32_t h = r ^ (r >> 7) ^ (r >> 15);
  h *= 0x9E3779B9u;
  return static_cast<int>(h >> 16) & (entries - 1);
}

__device__ __forceinline__ void clip_entry(int* t, int i, int cmax) {
  const int v = t[i];
  const int c = min(max(v, 0), cmax);
  if (c != v) t[i] = c;  // every writer writes the same value
}

// an SHCT entry of the cluster kernel: shared memory, or device memory
// read through L2 (another SM of the cluster may have written it)
template <bool kShared>
__device__ __forceinline__ int table_at(const int* t, int i) {
  return kShared ? t[i] : __ldcg(t + i);
}

// a cluster barrier's two halves without the release of cluster.sync()
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}


template <bool kShared>
__device__ __forceinline__ void clip_at(int* t, int i, int cmax) {
  const int v = table_at<kShared>(t, i);
  const int c = min(max(v, 0), cmax);
  if (c != v) t[i] = c;  // every writer writes the same value
}

// ---------------------------------------------------------------------------
// the cluster kernel (llc_rounds)
// ---------------------------------------------------------------------------
template <bool kSmemTables, int kStage>
__global__ void __launch_bounds__(kMaxThreads, 1)
    llc_rounds_cluster_kernel(Params p) {
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int l = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int S = p.sets, W = p.ways, T = p.entries, SC = p.cta_sets;
  const int s0 = rank * SC;                     // the CTA's first set
  const int n_sets = max(0, min(SC, S - s0));   // and its number of sets
  const int n_rows = n_sets * W;

  // shared memory: [fold | stamp x 2 | rounds | pad] [tables 2T]
  // [tag, lru, sig: SC x W each] [mailbox 2 x slots]
  // [ring 2 x kBlock x 2 x SC] [need: a bit a round] [wmask: kMaxIt a warp]
  int* fold = smem;
  int* stamp = smem + kFold;
  int* max_rounds = smem + kFold + 2;
  int* tab = smem + kHeader;
  int* s_tag = tab + (kSmemTables ? 2 * T : 0);
  int* s_lru = s_tag + SC * W;
  int* s_sig = s_lru + SC * W;
  int* mbox = s_sig + SC * W;
  int* ring = mbox + 2 * p.slots;
  unsigned* need = reinterpret_cast<unsigned*>(ring + 2 * kBlock * 2 * SC);

  const int* kn = p.knobs + l * kKnobs;
  const int accel_mode = kn[0];
  const bool core_bypass = kn[1] != 0;
  const bool shared_pred = kn[2] != 0;
  const uint32_t core_mask = static_cast<uint32_t>(kn[3]);
  const uint32_t accel_mask = static_cast<uint32_t>(kn[4]);
  const bool accel_ship = accel_mode == A_SHIP;
  const int sampler_mask = (1 << p.sampler_shift) - 1;
  const int cmax = p.counter_max;
  int region_shift = -1;
  for (int k = 0; k < 31; ++k)
    if (p.region_lines == 1 << k) region_shift = k;

  int* tc = kSmemTables ? tab : p.shct_core + static_cast<size_t>(l) * T;
  int* ta = kSmemTables ? tab + T : p.shct_accel + static_cast<size_t>(l) * T;
  const size_t row0 = (static_cast<size_t>(l) * S + s0) * W;
  for (int i = tid; i < n_rows; i += nt) {
    s_tag[i] = p.tags[row0 + i];
    s_lru[i] = p.lru[row0 + i];
    s_sig[i] = p.sig[row0 + i] | (p.owner[row0 + i] != 0 ? kOwnerBit : 0) |
               (p.reused[row0 + i] != 0 ? kReusedBit : 0);
  }
  if (kSmemTables) {
    const int* gc = p.shct_core + static_cast<size_t>(l) * T;
    const int* ga = p.shct_accel + static_cast<size_t>(l) * T;
    for (int i = tid; i < T; i += nt) {
      tab[i] = gc[i];
      tab[T + i] = ga[i];
    }
  }
  for (int i = tid; i < 2 * p.slots; i += nt) mbox[i] = 0;
  for (int i = tid; i < kFold; i += nt) fold[i] = 0;
  if (tid == 0) {
    stamp[0] = 0;
    stamp[1] = 0;
    int r = p.rounds;
    if (p.n_rounds != nullptr) {
      int m = 0;
      for (int i = 0; i < p.n_lanes; ++i) m = max(m, p.n_rounds[i]);
      r = min(m, r);
    }
    *max_rounds = r;
  }
  __syncthreads();
  const int R = *max_rounds;
  // need bit r: round r has a valid event in a sampler set of the lane, so
  // it may post SHCT deltas, and ends in a cluster barrier.  Every CTA
  // reads the same events, so all agree on the rounds without one; there
  // no delta is possible, the tables stay as they are, and the CTAs' warps
  // go on to the next round each at its own pace.  Above kNeedScan events
  // to read, every round takes the barrier.
  const bool scan = static_cast<long long>(R) * p.slots <= kNeedScan;
  for (int i = tid; i < (R + 31) / 32; i += nt) need[i] = scan ? 0u : ~0u;
  __syncthreads();
  if (scan) {
    const int* lane_meta = p.meta + static_cast<size_t>(l) * p.rounds * S;
    for (int i = tid; i < R * p.slots; i += nt) {
      const int r = i / p.slots;
      const int q = i - r * p.slots;
      if (lane_meta[static_cast<size_t>(r) * S + (q << p.sampler_shift)] &
          M_VALID)
        atomicOr(need + (r >> 5), 1u << (r & 31));
    }
  }
  // every CTA of the cluster runs, has cleared its mailbox and stamps and
  // knows the rounds that end in a barrier: from here on its peers may
  // post into its mailbox
  cluster.sync();

  // the lanes of a warp in groups of Wp, one set a group, one way a lane
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wps = p.wp_shift;
  const int Wp = 1 << wps;
  const int w = lane & (Wp - 1);
  const int base = lane & ~(Wp - 1);            // the group's first lane
  const unsigned gmask = Wp == 32 ? kFull : ((1u << Wp) - 1u) << base;
  const int groups = (nt >> 5) << (5 - wps);    // groups in the CTA
  const int g = (warp << (5 - wps)) + (lane >> wps);
  const int n_it = (n_sets + groups - 1) / groups;   // <= kMaxIt
  const bool leader = w == 0;
  // wmask[it]: the rounds of the block with an event of the warp's sets of
  // iteration it
  unsigned* wmask = need + (R + 31) / 32 + warp * kMaxIt;

  // block b's events of the CTA's sets into ring half b & 1, laid out
  // [round of the block][meta, line][set of the CTA]: each lane of a group
  // copies every Wp-th round of its set; every thread commits one group of
  // copies a block
  const int n_blocks = (R + kBlock - 1) / kBlock;
  const int* meta_g = p.meta + static_cast<size_t>(l) * p.rounds * S + s0;
  const int* line_g = p.line + static_cast<size_t>(l) * p.rounds * S + s0;
  auto prefetch = [=](int b) {
    if (b < n_blocks) {
      int* dst = ring + (b & 1) * kBlock * 2 * SC;
      for (int it = 0; it < n_it; ++it) {
        const int sl = it * groups + g;
        if (sl >= n_sets) continue;
        for (int j = w; j < kBlock && b * kBlock + j < R; j += Wp) {
          const size_t at = static_cast<size_t>(b * kBlock + j) * S + sl;
          __pipeline_memcpy_async(dst + 2 * j * SC + sl, meta_g + at,
                                  sizeof(int));
          __pipeline_memcpy_async(dst + (2 * j + 1) * SC + sl, line_g + at,
                                  sizeof(int));
        }
      }
    }
    __pipeline_commit();
  };

  int st[kStats];
#pragma unroll
  for (int j = 0; j < kStats; ++j) st[j] = 0;
  const int tick0 = p.tick[l];
  int k = 0;   // the cluster barriers so far
  if (!only_barriers(kStage)) prefetch(0);
  for (int b = 0; b < n_blocks; ++b) {
    const int r0 = b * kBlock;
    const int nb = min(kBlock, R - r0);
    // the rounds of the block that end in a cluster barrier (round 0
    // always: the first round clips the whole table)
    unsigned bars = (need[r0 >> 5] >> (r0 & 31)) & ((1u << nb) - 1u);
    if (b == 0) bars |= 1u;
    // the rounds this warp visits: its events' and the barriers
    unsigned todo = bars;
    const int* ev = ring + (b & 1) * kBlock * 2 * SC;
    if (!only_barriers(kStage)) {
      __syncwarp();   // the warp is done with the half that b + 1 refills
      prefetch(b + 1);
      __pipeline_wait_prior(1);   // this thread's copies of block b
      __syncwarp();               // and its group's
      for (int it = 0; it < n_it; ++it) {
        const int sl = it * groups + g;
        unsigned m = 0;
        for (int j0 = 0; j0 < kBlock; j0 += Wp) {
          const int j = j0 + w;
          const bool v =
              sl < n_sets && j < nb && (ev[2 * j * SC + sl] & M_VALID);
          m |= ((__ballot_sync(kFull, v) & gmask) >> base) << j0;
        }
        m = __reduce_or_sync(kFull, m);
        if (lane == 0) wmask[it] = m;
        todo |= m;
      }
      __syncwarp();
    }
    while (todo != 0) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int r = r0 + j;
      const int tick = tick0 + r + 1;
      // the mailbox half and the stamp of this round: by the parity of the
      // barriers, so that a peer posts into a half only after a barrier
      // that follows this CTA's clearing of it
      const int par = k & 1;
      for (int it = 0; !only_barriers(kStage) && it < n_it; ++it) {
        if (!((wmask[it] >> j) & 1u)) continue;   // no event of the warp
        const int sl = it * groups + g;
        const int meta = sl < n_sets ? ev[2 * j * SC + sl] : 0;
        const bool valid = (meta & M_VALID) != 0;
        if (kStage == kEvents) {
          st[0] += valid && leader;
          continue;
        }
        const int line = valid ? ev[(2 * j + 1) * SC + sl] : -1;
        const int s = s0 + sl;
        const bool is_accel = meta & M_ACCEL;
        const bool write = meta & M_WRITE;
        const bool hint = meta & M_HINT;
        const bool prefetch_ev = meta & M_PREFETCH;
        const bool dlok = meta & M_DLOK;
        const int src = (meta >> M_SRC_SHIFT) & 0x7;

        // this lane's way of the set
        const int i = sl * W + w;
        const bool way = valid && w < W;
        const int tag = way ? s_tag[i] : -1;
        const int tick_w = way ? s_lru[i] : INT_MAX;
        const int sp = way ? s_sig[i] : 0;

        const unsigned hits =
            __ballot_sync(kFull, way && tag == line && tag != -1) & gmask;
        const bool hit = hits != 0;
        const int wh = hit ? __ffs(hits) - 1 - base : 0;
        const int sig_e =
            valid ? signature_at(line, p.region_lines, region_shift, T) : 0;
        bool dead_core = false, dead_accel = false;
        if (kStage == kAll && valid) {
          dead_core = table_at<kSmemTables>(tc, sig_e) == 0;
          dead_accel = shared_pred ? dead_core
                                   : table_at<kSmemTables>(ta, sig_e) == 0;
        }
        const bool byp_accel =
            (accel_ship ? dead_accel : (hint && accel_mode != A_NONE)) &&
            dlok;
        const bool byp_core = dead_core && core_bypass;
        const bool sampler = (s & sampler_mask) == 0;
        const bool ship_driven = is_accel ? accel_ship : core_bypass;
        const bool bypass = (is_accel ? byp_accel : byp_core) &&
                            !prefetch_ev && !(sampler && ship_driven);
        const bool inval = is_accel && write && bypass && hit;
        const bool served = hit && !inval;
        const bool insert = valid && !hit && !bypass;

        // the victim: the first allowed empty way, else the first allowed
        // way of the least tick, else way 0 (no way allowed)
        const uint32_t allowed =
            (is_accel || prefetch_ev) ? accel_mask : core_mask;
        const bool allowed_w = way && ((allowed >> w) & 1u);
        const unsigned empties =
            __ballot_sync(kFull, allowed_w && tag == -1) & gmask;
        const int v = allowed_w ? tick_w : INT_MAX;
        int least = v;
        if (Wp == 32) {
          least = __reduce_min_sync(kFull, least);
        } else {
          for (int o = Wp >> 1; o > 0; o >>= 1)
            least = min(least, __shfl_xor_sync(kFull, least, o));
        }
        const unsigned at_least =
            __ballot_sync(kFull, w < W && v == least) & gmask;
        const int victim = empties ? __ffs(empties) - 1 - base
                                   : __ffs(at_least) - 1 - base;
        const int vic_tag = __shfl_sync(kFull, tag, base + victim);
        const int vic_sp = __shfl_sync(kFull, sp, base + victim);
        const int hit_sp = __shfl_sync(kFull, sp, base + wh);
        const bool evict = insert && !empties && vic_tag != -1;

        if (kStage == kAll) {
          // SHCT delta (read before this event's row updates), one mailbox
          // word of the set: idx << 3 | accel table << 2 | +1: 1, -1: 2
          int word = 0;
          if (served && !prefetch_ev && sampler) {
            word = (hit_sp & kSigMask) << 3 | 1 |
                   ((hit_sp & kOwnerBit) && !shared_pred ? 4 : 0);
          } else if (evict && !(vic_sp & kReusedBit) && sampler) {
            word = (vic_sp & kSigMask) << 3 | 2 |
                   ((vic_sp & kOwnerBit) && !shared_pred ? 4 : 0);
          }
          if (word != 0) {   // the same in every lane of the group
            const int q = s >> p.sampler_shift;
            int* box = mbox + par * p.slots + q;
            for (int c = w; c < C; c += Wp) {
              if (kSmemTables || c == 0)
                *cluster.map_shared_rank(box, c) = word;
              *cluster.map_shared_rank(stamp + par, c) = r + 1;
            }
          }
        }

        if (way) {
          if (inval && w == wh) s_tag[i] = -1;
          if (insert && w == victim) {
            s_tag[i] = line;
            s_lru[i] = tick;
            s_sig[i] = sig_e | (is_accel ? kOwnerBit : 0);
          }
          if (served && w == wh) {
            s_lru[i] = tick;
            if (!prefetch_ev) s_sig[i] = sp | kReusedBit;
          }
        }

        if (leader && valid) {
          const bool vis = !prefetch_ev;
          const bool core_hit = vis && !is_accel && served;
          const bool core_miss = vis && !is_accel && !hit;
          st[0] += core_hit;
          st[1] += core_miss;
          st[2] += core_miss && bypass;
          st[3] += vis && is_accel && served;
          st[4] += vis && is_accel && !served;
          st[5] += vis && is_accel && bypass && !served;
          st[6] += vis && is_accel && write && bypass;
          st[7] += evict;
          st[8] += prefetch_ev && insert;
          st[9] += inval;
          if (core_hit || core_miss)
            atomicAdd(fold + kStats + 2 * src + (core_hit ? 0 : 1), 1);
        }
      }
      if (!((bars >> j) & 1u)) continue;   // no delta anywhere: no wait
      ++k;
      if (kStage == kRelaxedBarriers) {
        cluster_arrive_relaxed();
        cluster_wait();
        continue;
      }
      if (kStage == kCtaBarriers) {
        __syncthreads();
        continue;
      }
      // every event of the cluster has read the tables and posted its delta
      cluster.sync();
      if (kStage == kAll && (r == 0 || stamp[par] == r + 1)) {
        if (kSmemTables || rank == 0) {
          int* box = mbox + par * p.slots;
          for (int q = tid; q < p.slots; q += nt) {
            const int word = box[q];
            if (word != 0)
              atomicAdd(((word & 4) ? ta : tc) + (word >> 3),
                        (word & 1) ? 1 : -1);
          }
          __syncthreads();
          if (r == 0) {
            for (int i = tid; i < T; i += nt) {
              clip_at<kSmemTables>(tc, i, cmax);
              clip_at<kSmemTables>(ta, i, cmax);
            }
          }
          for (int q = tid; q < p.slots; q += nt) {
            const int word = box[q];
            if (word != 0) {
              if (r != 0)
                clip_at<kSmemTables>((word & 4) ? ta : tc, word >> 3, cmax);
              box[q] = 0;   // no peer posts into this half before the
                            // barrier after the next one
            }
          }
        }
        // the clipped tables before the next round reads them
        if (kSmemTables) {
          __syncthreads();
        } else {
          cluster.sync();
        }
      }
    }
  }
  const int tick = tick0 + R;

  // fold the stats: per warp, then one shared atomic per warp
#pragma unroll
  for (int j = 0; j < kStats; ++j) {
    const int v = __reduce_add_sync(kFull, st[j]);
    if (lane == 0 && v) atomicAdd(fold + j, v);
  }
  __syncthreads();   // every warp is past its last round (which may have
                     // ended in no barrier) before the rows go back
  for (int i = tid; i < n_rows; i += nt) {
    const int sp = s_sig[i];
    p.tags[row0 + i] = s_tag[i];
    p.lru[row0 + i] = s_lru[i];
    p.sig[row0 + i] = sp & kSigMask;
    p.owner[row0 + i] = (sp & kOwnerBit) ? 1 : 0;
    p.reused[row0 + i] = (sp & kReusedBit) ? 1 : 0;
  }
  if (kSmemTables && rank == 0) {
    int* gc = p.shct_core + static_cast<size_t>(l) * T;
    int* ga = p.shct_accel + static_cast<size_t>(l) * T;
    for (int i = tid; i < T; i += nt) {
      gc[i] = tab[i];
      ga[i] = tab[T + i];
    }
  }
  cluster.sync();   // every CTA's counts are folded
  if (rank == 0) {
    if (tid < kFold) {
      int total = 0;
      for (int c = 0; c < C; ++c)
        total += cluster.map_shared_rank(fold, c)[tid];
      if (tid < kStats) {
        p.stats[l * kStats + tid] = total;
      } else {
        p.percore[l * 2 * kCores + tid - kStats] = total;
      }
    }
    if (tid == 0) p.tick[l] = tick;
  }
  cluster.sync();   // the peers' shared memory lives until CTA 0 has read it
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    llc_rounds_cluster_empty_kernel(Params) {}

// ---------------------------------------------------------------------------
// the first design (llc_rounds_simple)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kMaxThreads, 1)
    llc_rounds_simple_kernel(Params p) {
  extern __shared__ int tables[];
  __shared__ int fold[kStats + 2 * kCores];
  __shared__ int max_rounds;
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int S = p.sets, W = p.ways, T = p.entries;

  const int* kn = p.knobs + l * kKnobs;
  const int accel_mode = kn[0];
  const bool core_bypass = kn[1] != 0;
  const bool shared_pred = kn[2] != 0;
  const uint32_t core_mask = static_cast<uint32_t>(kn[3]);
  const uint32_t accel_mask = static_cast<uint32_t>(kn[4]);
  const bool accel_ship = accel_mode == A_SHIP;
  const int sampler_mask = (1 << p.sampler_shift) - 1;

  int* tc = p.shct_core + static_cast<size_t>(l) * T;
  int* ta = p.shct_accel + static_cast<size_t>(l) * T;
  if (p.smem_tables) {
    for (int i = tid; i < T; i += nt) {
      tables[i] = tc[i];
      tables[T + i] = ta[i];
    }
    tc = tables;
    ta = tables + T;
  }
  for (int i = tid; i < kStats + 2 * kCores; i += nt) fold[i] = 0;
  if (tid == 0) {
    int r = p.rounds;
    if (p.n_rounds != nullptr) {
      int m = 0;
      for (int i = 0; i < p.n_lanes; ++i) m = max(m, p.n_rounds[i]);
      r = min(m, r);
    }
    max_rounds = r;
  }
  __syncthreads();
  const int R = max_rounds;

  int st[kStats];
#pragma unroll
  for (int j = 0; j < kStats; ++j) st[j] = 0;
  // per-core (hits, misses), 16 bits each: a thread sees at most
  // rounds x kMaxSetsPerThread < 2^16 events (the wrapper checks rounds)
  uint32_t pc[kCores];
#pragma unroll
  for (int c = 0; c < kCores; ++c) pc[c] = 0;

  int tick = p.tick[l];
  const size_t lane_rows = static_cast<size_t>(l) * S * W;
  for (int r = 0; r < R; ++r) {
    ++tick;
    const size_t col = (static_cast<size_t>(l) * p.rounds + r) * S;
    int pend_idx[kMaxSetsPerThread];
    int pend_code[kMaxSetsPerThread];  // 0 none, else delta | table << 2
    bool mine = false;
#pragma unroll
    for (int k = 0; k < kMaxSetsPerThread; ++k) {
      pend_idx[k] = 0;
      pend_code[k] = 0;
      const int s = tid + k * nt;
      if (s >= S) continue;
      const int meta = p.meta[col + s];
      if (!(meta & M_VALID)) continue;
      const int line = p.line[col + s];
      const bool is_accel = meta & M_ACCEL;
      const bool write = meta & M_WRITE;
      const bool hint = meta & M_HINT;
      const bool prefetch = meta & M_PREFETCH;
      const bool dlok = meta & M_DLOK;
      const int src = (meta >> M_SRC_SHIFT) & 0x7;
      int* tg = p.tags + lane_rows + static_cast<size_t>(s) * W;
      int* lu = p.lru + lane_rows + static_cast<size_t>(s) * W;
      int* ow = p.owner + lane_rows + static_cast<size_t>(s) * W;
      int* sg = p.sig + lane_rows + static_cast<size_t>(s) * W;
      uint8_t* ru = p.reused + lane_rows + static_cast<size_t>(s) * W;

      int way_hit = -1;
      for (int w = 0; w < W; ++w) {
        const int t = tg[w];
        if (t == line && t != -1) {
          way_hit = w;
          break;
        }
      }
      const bool hit = way_hit >= 0;
      const int wh = hit ? way_hit : 0;
      const int sig_e = signature(line, p.region_lines, T);
      const bool dead_core = tc[sig_e] == 0;
      const bool dead_accel = shared_pred ? dead_core : ta[sig_e] == 0;
      const bool byp_accel =
          (accel_ship ? dead_accel : (hint && accel_mode != A_NONE)) && dlok;
      const bool byp_core = dead_core && core_bypass;
      const bool sampler = (s & sampler_mask) == 0;
      const bool ship_driven = is_accel ? accel_ship : core_bypass;
      const bool bypass = (is_accel ? byp_accel : byp_core) && !prefetch &&
                          !(sampler && ship_driven);
      const bool inval = is_accel && write && bypass && hit;
      const bool served = hit && !inval;
      const bool insert = !hit && !bypass;

      int victim = 0;
      bool evict = false;
      bool vic_reused = false;
      int vic_sig = 0, vic_owner = 0;
      if (insert) {
        const uint32_t allowed = (is_accel || prefetch) ? accel_mask
                                                        : core_mask;
        int first_empty = -1;
        int lru_way = 0;
        int lru_min = (allowed & 1u) ? lu[0] : INT_MAX;
        for (int w = 0; w < W; ++w) {
          const bool a = (allowed >> w) & 1u;
          if (a && first_empty < 0 && tg[w] == -1) first_empty = w;
          if (w > 0) {
            const int v = a ? lu[w] : INT_MAX;
            if (v < lru_min) {
              lru_min = v;
              lru_way = w;
            }
          }
        }
        victim = first_empty >= 0 ? first_empty : lru_way;
        evict = first_empty < 0 && tg[victim] != -1;
        vic_reused = ru[victim] != 0;
        vic_sig = sg[victim];
        vic_owner = ow[victim];
      }

      // SHCT delta (read before this event's row updates)
      if (served && !prefetch && sampler) {
        pend_idx[k] = sg[wh];
        pend_code[k] = 1 | ((ow[wh] == 1 && !shared_pred) << 2);
      } else if (evict && !vic_reused && sampler) {
        pend_idx[k] = vic_sig;
        pend_code[k] = 2 | ((vic_owner == 1 && !shared_pred) << 2);
      }
      mine |= pend_code[k] != 0;

      if (inval) tg[wh] = -1;
      if (insert) {
        tg[victim] = line;
        lu[victim] = tick;
        ow[victim] = is_accel ? 1 : 0;
        sg[victim] = sig_e;
        ru[victim] = 0;
      }
      if (served) {
        lu[wh] = tick;
        if (!prefetch) ru[wh] = 1;
      }

      const bool v = !prefetch;
      const bool core_hit = v && !is_accel && served;
      const bool core_miss = v && !is_accel && !hit;
      st[0] += core_hit;
      st[1] += core_miss;
      st[2] += core_miss && bypass;
      st[3] += v && is_accel && served;
      st[4] += v && is_accel && !served;
      st[5] += v && is_accel && bypass && !served;
      st[6] += v && is_accel && write && bypass;
      st[7] += evict;
      st[8] += prefetch && insert;
      st[9] += inval;
#pragma unroll
      for (int c = 0; c < kCores; ++c)
        pc[c] += (src == c) * (static_cast<uint32_t>(core_hit) |
                               (static_cast<uint32_t>(core_miss) << 16));
    }
    // every event of the round has read the tables: apply the deltas
    const bool first = r == 0;
    if (__syncthreads_or(mine) || first) {
#pragma unroll
      for (int k = 0; k < kMaxSetsPerThread; ++k) {
        if (pend_code[k] == 0) continue;
        int* t = (pend_code[k] & 4) ? ta : tc;
        atomicAdd(t + pend_idx[k], (pend_code[k] & 1) ? 1 : -1);
      }
      __syncthreads();
      if (first) {
        for (int i = tid; i < T; i += nt) {
          clip_entry(tc, i, p.counter_max);
          clip_entry(ta, i, p.counter_max);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kMaxSetsPerThread; ++k) {
          if (pend_code[k] == 0) continue;
          clip_entry((pend_code[k] & 4) ? ta : tc, pend_idx[k],
                     p.counter_max);
        }
      }
      __syncthreads();
    }
  }

  // fold the counters: per warp, then one shared atomic per warp
  const int lane_id = tid & 31;
#pragma unroll
  for (int j = 0; j < kStats; ++j) {
    const int v = __reduce_add_sync(0xffffffffu, st[j]);
    if (lane_id == 0 && v) atomicAdd(&fold[j], v);
  }
#pragma unroll
  for (int c = 0; c < kCores; ++c) {
    const int h = __reduce_add_sync(0xffffffffu, static_cast<int>(pc[c] & 0xffffu));
    const int m = __reduce_add_sync(0xffffffffu, static_cast<int>(pc[c] >> 16));
    if (lane_id == 0 && h) atomicAdd(&fold[kStats + 2 * c], h);
    if (lane_id == 0 && m) atomicAdd(&fold[kStats + 2 * c + 1], m);
  }
  __syncthreads();
  if (tid < kStats) p.stats[l * kStats + tid] = fold[tid];
  if (tid < 2 * kCores) p.percore[l * 2 * kCores + tid] = fold[kStats + tid];
  if (tid == 0) p.tick[l] = tick;
  if (p.smem_tables) {
    int* gc = p.shct_core + static_cast<size_t>(l) * T;
    int* ga = p.shct_accel + static_cast<size_t>(l) * T;
    for (int i = tid; i < T; i += nt) {
      gc[i] = tc[i];
      ga[i] = ta[i];
    }
  }
}

__global__ void llc_rounds_empty_kernel() {}

// threads of a lane's CTA in the simple kernel: the sets rounded up to a
// warp, at most 1024
int block_threads(int sets) {
  const int t = (sets + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// ---------------------------------------------------------------------------
// the cluster kernel's shape and launch
// ---------------------------------------------------------------------------
struct Shape {
  int cluster = 0, threads = 0, cta_sets = 0, slots = 0, wp_shift = 0;
  bool smem_tables = false;
  size_t smem = 0;  // dynamic shared memory bytes a CTA
};

// the dynamic shared memory a CTA of `sh` takes
size_t shape_bytes(const Shape& sh, int ways, int entries, int rounds) {
  const size_t words = kHeader +
                       (sh.smem_tables ? 2 * static_cast<size_t>(entries) : 0) +
                       3 * static_cast<size_t>(sh.cta_sets) * ways +
                       2 * static_cast<size_t>(sh.slots) +
                       2 * kBlock * 2 * static_cast<size_t>(sh.cta_sets) +
                       (static_cast<size_t>(rounds) + 31) / 32 +
                       static_cast<size_t>(sh.threads / 32) * kMaxIt;
  return words * sizeof(int);
}

// A process may launch on several cards: what is read or set once per card
// is kept per device (the current one, which the wrapper sets to the
// tensors' card before every call).
constexpr int kMaxDevices = 64;

// the current device's opt-in dynamic shared memory a block
int device_smem_optin() {
  static int optin[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 48 * 1024;
  if (optin[dev] == 0 &&
      cudaDeviceGetAttribute(&optin[dev],
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    optin[dev] = 48 * 1024;
  return optin[dev];
}

// The shape of a lane's cluster: `cluster` CTAs (0: the smallest power of
// two, at most kMaxCluster, whose CTAs each give every set a group of Wp
// threads within kMaxThreads, or kMaxCluster), `threads` a CTA (0: one
// group a set, at most kMaxThreads).  The SHCT tables sit in shared
// memory when they fit beside the rows.  Returns false for a shape that
// does not fit a CTA's shared memory.
bool pick_shape(int sets, int ways, int entries, int sampler_shift,
                int rounds, int cluster, int threads, Shape* out) {
  Shape sh;
  while ((1 << sh.wp_shift) < ways) ++sh.wp_shift;
  const int wp = 1 << sh.wp_shift;
  sh.cluster = cluster;
  if (sh.cluster <= 0) {
    sh.cluster = 1;
    while (sh.cluster < kMaxCluster &&
           static_cast<long long>((sets + sh.cluster - 1) / sh.cluster) * wp >
               kMaxThreads)
      sh.cluster *= 2;
  }
  if (sh.cluster > kMaxCluster) return false;
  sh.cta_sets = (sets + sh.cluster - 1) / sh.cluster;
  sh.threads = threads;
  if (sh.threads <= 0) {
    const long long want = static_cast<long long>(sh.cta_sets) * wp;
    sh.threads = static_cast<int>(
        want < kMaxThreads ? (want + 31) / 32 * 32 : kMaxThreads);
  }
  if (sh.threads < 32 || sh.threads > kMaxThreads || sh.threads % 32 != 0 ||
      (sh.cta_sets + (sh.threads >> sh.wp_shift) - 1) /
              (sh.threads >> sh.wp_shift) > kMaxIt)
    return false;
  sh.slots = ((sets - 1) >> sampler_shift) + 1;
  const size_t optin = static_cast<size_t>(device_smem_optin());
  sh.smem_tables = true;
  sh.smem = shape_bytes(sh, ways, entries, rounds);
  if (sh.smem > optin) {
    sh.smem_tables = false;
    sh.smem = shape_bytes(sh, ways, entries, rounds);
  }
  if (sh.smem > optin) return false;
  *out = sh;
  return true;
}

// The cluster launch of `kernel` at shape `sh` for n_lanes lanes.  The
// first launch of a kernel lets it take a cluster above the portable 8
// CTAs and all of a block's shared memory; each new shape is checked once
// with cudaOccupancyMaxActiveClusters (no cluster of it fits: the launch
// is refused with cudaErrorInvalidConfiguration).
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;

  ClusterLaunch(const Shape& sh, int n_lanes, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = sh.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3(n_lanes * sh.cluster);
    cfg.blockDim = dim3(sh.threads);
    cfg.dynamicSmemBytes = sh.smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename Kernel>
cudaError_t prepare(Kernel* kernel, const ClusterLaunch& cl, int* active) {
  // the shapes checked so far (one per device, kernel, cluster, threads,
  // bytes) and the kernels whose attributes are set (one per device)
  struct Checked {
    int dev;
    const void* fn;
    int cluster, threads;
    size_t smem;
    int active;
  };
  struct Opened {
    int dev;
    const void* fn;
  };
  static Checked seen[256];
  static int n_seen = 0;
  static Opened opened[64];
  static int n_opened = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const int cluster = static_cast<int>(cl.attr[0].val.clusterDim.x);
  for (int i = 0; i < n_seen; ++i) {
    const Checked& c = seen[i];
    if (c.dev == dev && c.fn == fn && c.cluster == cluster &&
        c.threads == static_cast<int>(cl.cfg.blockDim.x) &&
        c.smem == cl.cfg.dynamicSmemBytes) {
      *active = c.active;
      return c.active > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
    }
  }
  bool open = false;
  for (int i = 0; i < n_opened; ++i)
    open |= opened[i].dev == dev && opened[i].fn == fn;
  if (!open) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          device_smem_optin() - static_cast<int>(fa.sharedSizeBytes));
    if (e != cudaSuccess) return e;
    if (n_opened < 64) opened[n_opened++] = {dev, fn};
  }
  *active = 0;
  e = cudaOccupancyMaxActiveClusters(active, kernel, &cl.cfg);
  if (e != cudaSuccess) return e;
  if (n_seen < 256)
    seen[n_seen++] = {dev, fn, cluster, static_cast<int>(cl.cfg.blockDim.x),
                      cl.cfg.dynamicSmemBytes, *active};
  return *active > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename Kernel>
int launch_cluster(Kernel* kernel, const Params& p, const Shape& sh,
                   cudaStream_t stream) {
  ClusterLaunch cl(sh, p.n_lanes, stream);
  int active = 0;
  cudaError_t e = prepare(kernel, cl, &active);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cl.cfg, kernel, p);
  if (e != cudaSuccess) cudaGetLastError();   // leave no error behind
  return static_cast<int>(e);
}

bool valid_args(int n_lanes, int rounds, int sets, int ways, int entries,
                int sampler_shift, int region_lines) {
  return n_lanes >= 1 && rounds >= 0 && rounds <= kMaxRounds && sets >= 1 &&
         sets <= kMaxThreads * kMaxSetsPerThread && ways >= 1 && ways <= 32 &&
         entries >= 1 && entries <= kMaxEntries &&
         (entries & (entries - 1)) == 0 && region_lines >= 1 &&
         sampler_shift >= 0 && sampler_shift < 31;
}

// stage -1: the empty kernel at the shape; 0..3 the round's stages
int launch_stage(const Params& p, const Shape& sh, int stage,
                 cudaStream_t stream) {
  if (stage == -1)
    return launch_cluster(llc_rounds_cluster_empty_kernel, p, sh, stream);
  if (!sh.smem_tables) {
    if (stage != kAll) return static_cast<int>(cudaErrorInvalidValue);
    return launch_cluster(llc_rounds_cluster_kernel<false, kAll>, p, sh,
                          stream);
  }
  switch (stage) {
    case kBarriers:
      return launch_cluster(llc_rounds_cluster_kernel<true, kBarriers>, p,
                            sh, stream);
    case kEvents:
      return launch_cluster(llc_rounds_cluster_kernel<true, kEvents>, p, sh,
                            stream);
    case kRows:
      return launch_cluster(llc_rounds_cluster_kernel<true, kRows>, p, sh,
                            stream);
    case kAll:
      return launch_cluster(llc_rounds_cluster_kernel<true, kAll>, p, sh,
                            stream);
    case kRelaxedBarriers:
      return launch_cluster(llc_rounds_cluster_kernel<true, kRelaxedBarriers>,
                            p, sh, stream);
    case kCtaBarriers:
      return launch_cluster(llc_rounds_cluster_kernel<true, kCtaBarriers>, p,
                            sh, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Params make_params(const int* line, const int* meta, const int* knobs,
                   const int* n_rounds, int* tags, int* lru, int* owner,
                   int* sig, uint8_t* reused, int* tick, int* shct_core,
                   int* shct_accel, int* stats, int* percore, int n_lanes,
                   int rounds, int sets, int ways, int entries,
                   int sampler_shift, int region_lines, int counter_max) {
  return Params{line, meta, knobs, n_rounds, tags, lru, owner, sig, reused,
                tick, shct_core, shct_accel, stats, percore, n_lanes, rounds,
                sets, ways, entries, sampler_shift, region_lines,
                counter_max, 0, 0, 0, 0, 0};
}

int launch_shaped(Params p, int cluster, int threads, int stage,
                  cudaStream_t stream) {
  if (!valid_args(p.n_lanes, p.rounds, p.sets, p.ways, p.entries,
                  p.sampler_shift, p.region_lines))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  if (!pick_shape(p.sets, p.ways, p.entries, p.sampler_shift, p.rounds,
                  cluster, threads, &sh))
    return static_cast<int>(cudaErrorInvalidValue);
  p.smem_tables = sh.smem_tables;
  p.cluster = sh.cluster;
  p.cta_sets = sh.cta_sets;
  p.slots = sh.slots;
  p.wp_shift = sh.wp_shift;
  return launch_stage(p, sh, stage, stream);
}

}  // namespace

// Enqueue the round loop on `stream` (the cluster kernel).  Every tensor is
// contiguous and int32 (reused: bool); the state is updated in place,
// stats and percore are written whole.  n_rounds may be null.  Returns the
// launch's cudaError_t (0 on success); an argument the kernel does not take
// returns cudaErrorInvalidValue, and a cluster that does not fit the card
// cudaErrorInvalidConfiguration, without launching.
extern "C" int llc_rounds(const int* line, const int* meta, const int* knobs,
                          const int* n_rounds, int* tags, int* lru,
                          int* owner, int* sig, uint8_t* reused, int* tick,
                          int* shct_core, int* shct_accel, int* stats,
                          int* percore, int n_lanes, int rounds, int sets,
                          int ways, int entries, int sampler_shift,
                          int region_lines, int counter_max, void* stream) {
  return launch_shaped(
      make_params(line, meta, knobs, n_rounds, tags, lru, owner, sig, reused,
                  tick, shct_core, shct_accel, stats, percore, n_lanes,
                  rounds, sets, ways, entries, sampler_shift, region_lines,
                  counter_max),
      0, 0, kAll, static_cast<cudaStream_t>(stream));
}

// The cluster kernel at a chosen shape (`cluster` CTAs a lane, `threads` a
// CTA; 0 picks as llc_rounds does) and stage: 3 is llc_rounds itself, 0..2
// the probe's ablation (barriers only; + events; + the row search), 4 and
// 5 its barriers as relaxed cluster barriers or as __syncthreads, -1 the
// empty kernel at the shape.  Stages other than 3 leave no result.
extern "C" int llc_rounds_shaped(
    const int* line, const int* meta, const int* knobs, const int* n_rounds,
    int* tags, int* lru, int* owner, int* sig, uint8_t* reused, int* tick,
    int* shct_core, int* shct_accel, int* stats, int* percore, int n_lanes,
    int rounds, int sets, int ways, int entries, int sampler_shift,
    int region_lines, int counter_max, int cluster, int threads, int stage,
    void* stream) {
  return launch_shaped(
      make_params(line, meta, knobs, n_rounds, tags, lru, owner, sig, reused,
                  tick, shct_core, shct_accel, stats, percore, n_lanes,
                  rounds, sets, ways, entries, sampler_shift, region_lines,
                  counter_max),
      cluster, threads, stage, static_cast<cudaStream_t>(stream));
}

// The first design (one CTA per lane), with llc_rounds's arguments.
extern "C" int llc_rounds_simple(
    const int* line, const int* meta, const int* knobs, const int* n_rounds,
    int* tags, int* lru, int* owner, int* sig, uint8_t* reused, int* tick,
    int* shct_core, int* shct_accel, int* stats, int* percore, int n_lanes,
    int rounds, int sets, int ways, int entries, int sampler_shift,
    int region_lines, int counter_max, void* stream) {
  if (!valid_args(n_lanes, rounds, sets, ways, entries, sampler_shift,
                  region_lines))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(line, meta, knobs, n_rounds, tags, lru, owner, sig,
                         reused, tick, shct_core, shct_accel, stats, percore,
                         n_lanes, rounds, sets, ways, entries, sampler_shift,
                         region_lines, counter_max);
  const size_t table_bytes = 2 * static_cast<size_t>(entries) * sizeof(int);
  p.smem_tables = table_bytes <= 48 * 1024;
  const int threads = block_threads(sets);
  llc_rounds_simple_kernel<<<n_lanes, threads,
                             p.smem_tables ? table_bytes : 0,
                             static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The simple kernel's launch shape with an empty body: the floor of its
// call's time.
extern "C" int llc_rounds_empty(int n_lanes, int sets, void* stream) {
  const int threads = block_threads(sets);
  llc_rounds_empty_kernel<<<n_lanes, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The cluster kernel's shape for a geometry and a chunk of `rounds` rows
// (cluster / threads 0: as llc_rounds picks): out = {CTAs a lane, threads a CTA, sets a CTA,
// dynamic shared memory bytes a CTA, SHCT tables in shared memory (1/0),
// lanes that search one set, clusters of it the card holds at once
// (cudaOccupancyMaxActiveClusters)}.  Returns a cudaError_t.
extern "C" int llc_rounds_cluster(int sets, int ways, int entries,
                                  int sampler_shift, int rounds, int cluster,
                                  int threads, int* out) {
  Shape sh;
  if (!valid_args(1, rounds, sets, ways, entries, sampler_shift, 1) ||
      !pick_shape(sets, ways, entries, sampler_shift, rounds, cluster,
                  threads, &sh))
    return static_cast<int>(cudaErrorInvalidValue);
  ClusterLaunch cl(sh, 1, nullptr);
  int active = 0;
  const cudaError_t e =
      sh.smem_tables
          ? prepare(llc_rounds_cluster_kernel<true, kAll>, cl, &active)
          : prepare(llc_rounds_cluster_kernel<false, kAll>, cl, &active);
  if (e != cudaSuccess && e != cudaErrorInvalidConfiguration)
    cudaGetLastError();
  out[0] = sh.cluster;
  out[1] = sh.threads;
  out[2] = sh.cta_sets;
  out[3] = static_cast<int>(sh.smem);
  out[4] = sh.smem_tables ? 1 : 0;
  out[5] = 1 << sh.wp_shift;
  out[6] = active;
  return static_cast<int>(e == cudaErrorInvalidConfiguration ? cudaSuccess
                                                             : e);
}
