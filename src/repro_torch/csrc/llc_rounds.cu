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
//     round's start; the round's +1 / -1 deltas are then added (integer
//     atomics: the order of the adds cannot change a sum), and the tables
//     clipped to [0, counter_max] (the whole table after the first round,
//     as the JAX .at[].add then clip does; afterwards only the entries a
//     round touched can leave the range, so only those are clipped);
//   * ties go to the first way (argmax of the hit vector, first empty
//     way, argmin of the LRU ticks over the allowed ways);
//   * sampler sets are s & ((1 << sampler_shift) - 1) == 0;
//   * the tick advances on every round, padding rounds too.
// With n_rounds (the fused engine's round count per lane) the chunk runs
// max(n_rounds) rounds instead of all R rows, as the JAX while_loop does.
//
// Bound on the card: a sequential chain of R dependent rounds, each a
// handful of dependent loads of one set's 16-way row and two barriers;
// the bytes (events read once, state read and written once) are far under
// a microsecond at 3.35 TB/s.  So the design is simple: one CTA per lane
// (the lanes are independent), its threads striding over the sets, the set
// rows in device memory (each set belongs to one thread, so rows need no
// synchronisation), the two SHCT tables in shared memory when both fit
// (SHIP_DEFAULT: 2 x 4096 ints = 32 KB) and else in device memory (the
// 128 K-entry SHIP_LARGE tables; one CTA per lane with the same barriers,
// __syncthreads orders device-memory accesses within a block too).  A
// round with no SHCT delta in the whole CTA costs one barrier
// (__syncthreads_or), one with deltas three.  Stats and per-core counters
// stay in registers and are folded once at the end.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSetsPerThread = 4;   // S <= 4096 (the 16 MB LLC: 2048)
constexpr int kStats = 10;
constexpr int kCores = 8;
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

__device__ __forceinline__ void clip_entry(int* t, int i, int cmax) {
  const int v = t[i];
  const int c = min(max(v, 0), cmax);
  if (c != v) t[i] = c;  // every writer writes the same value
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    llc_rounds_kernel(Params p) {
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

// threads of a lane's CTA: the sets rounded up to a warp, at most 1024
int block_threads(int sets) {
  const int t = (sets + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

}  // namespace

// Enqueue the round loop on `stream`.  Every tensor is contiguous and
// int32 (reused: bool); the state is updated in place, stats and percore
// are written whole.  n_rounds may be null.  Returns the launch's
// cudaError_t (0 on success); an argument the kernel does not take returns
// cudaErrorInvalidValue without launching.
extern "C" int llc_rounds(const int* line, const int* meta, const int* knobs,
                          const int* n_rounds, int* tags, int* lru,
                          int* owner, int* sig, uint8_t* reused, int* tick,
                          int* shct_core, int* shct_accel, int* stats,
                          int* percore, int n_lanes, int rounds, int sets,
                          int ways, int entries, int sampler_shift,
                          int region_lines, int counter_max, void* stream) {
  if (n_lanes < 1 || rounds < 0 || sets < 1 || ways < 1 || ways > 32 ||
      entries < 1 || (entries & (entries - 1)) != 0 || region_lines < 1 ||
      sets > kMaxThreads * kMaxSetsPerThread ||
      static_cast<long long>(rounds) * kMaxSetsPerThread >= (1 << 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{line, meta, knobs, n_rounds, tags, lru, owner, sig, reused, tick,
           shct_core, shct_accel, stats, percore, n_lanes, rounds, sets,
           ways, entries, sampler_shift, region_lines, counter_max, 0};
  const size_t table_bytes = 2 * static_cast<size_t>(entries) * sizeof(int);
  p.smem_tables = table_bytes <= 48 * 1024;
  const int threads = block_threads(sets);
  llc_rounds_kernel<<<n_lanes, threads, p.smem_tables ? table_bytes : 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  const cudaError_t e = cudaGetLastError();
  return static_cast<int>(e);
}

// The same launch shape with an empty body: the floor of a call's time.
extern "C" int llc_rounds_empty(int n_lanes, int sets, void* stream) {
  const int threads = block_threads(sets);
  llc_rounds_empty_kernel<<<n_lanes, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// 1 if the SHCT tables of `entries` entries sit in shared memory.
extern "C" int llc_rounds_smem_tables(int entries) {
  return 2 * static_cast<size_t>(entries) * sizeof(int) <= 48 * 1024;
}
