// K1 — the fused frontier step, hand-written for Hopper.
//
// Replaces: raft_tla_tpu/ops/pallas_step.py `build_step_megakernel`
// (:131; kernel body `kernel` at :175, launch `_call` at :184,
// pl.pallas_call at :194), whole: parity and faithful mode, and its three
// orbit-scan variants (full scan, prescan, sig-prune).  The TPU kernel
// stages the XLA step's jaxpr over 128-row blocks so that the [B, A, W]
// candidate block stays in VMEM between stages; this kernel computes the
// same lanes as the plain torch step (ops/kernels.build_step): unpack, the
// action family's guard and effect, the history updates and the allLogs
// union (faithful mode), canonicalize (message-slot sort, election-slot
// sort), pack, the dedup key (VIEW, then the orbit-minimal fingerprint
// under SYMMETRY), invariants (registry and expression), StateConstraint.
//
// What bounds it on the H100.  Not every lane is enabled: on the flagship
// universe 34-42% of the (row, action lane) pairs of stored rows are
// valid, and the contract below needs outputs only there.  So the bytes it
// must move are the rows read once, one `valid` byte per lane and, per
// valid lane, the packed successor, its keys and masks: about 40 MB per
// 8,192-row launch at W = 60.  The integer work is |G| orbit elements per
// valid lane, each about 2W multiply-adds plus relabels and the slot sort
// networks; it passes the bytes at a few group elements.  Neither bound is
// near when every lane is finished on warps whose lanes run different
// families and are in good part invalid: then latency and divergence set
// the time.  So the design runs the expensive part only where it is
// needed, on convergent warps.
//
// Design: a block owns R rows (R = 32, fewer when the launch has few rows,
// so that the grid still covers the card) and runs three phases.
//
// 1. Guards.  The rows are copied once into shared memory.  Thread t takes
//    the pairs p = t, t + T, ... with p = a * R + r, so at R = 32 a warp
//    evaluates one action lane over 32 rows and the family's branch is
//    uniform across it.  `apply<false>` reads the parent row in shared
//    memory in place and returns `valid`; it writes nothing (every guard
//    reads only the unprimed state).  Valid pairs are compacted into a
//    shared queue (warp ballot, one shared atomic per warp), and the
//    block's `valid` bytes leave as one contiguous run.
// 2. Finish.  The block's threads take the queued pairs.  Each owner copies
//    its pair's row into its own slot of shared memory, applies the action
//    (`apply<true>`), the allLogs union, canonicalize, and leaves the
//    canonical successor there: the struct `St` is the packed row, word
//    for word, so the slot is the staged output.  The orbit key, the
//    invariants and the constraint read the slot.  When a block has fewer
//    pairs than threads, `split` threads (a power of two, at most the
//    |P| server permutations) share one pair: each scans every split-th
//    server permutation (with all of its value permutations), and a
//    shuffle takes the minimum, so a launch with few valid pairs or a
//    large group still keeps its threads busy.
// 3. Write.  Each warp writes its staged successors with neighbouring
//    threads on neighbouring words (16-byte stores when W is a multiple of
//    4).  Keys and masks go straight to their lanes: valid lanes are
//    sparse, so they would not form contiguous runs.
//
// Shared memory holds the rows and the slots at an odd stride (W | 1
// words), so 32 threads reading one field of 32 states hit 32 banks.  The
// fingerprint constants are a kernel parameter: every fold reads them at a
// compile-time word offset, so they are constant-bank operands of the
// multiply-adds and cost no load.  The layout's sizes (N servers, L log
// capacity, S message slots, and in faithful mode E election slots, WA
// allLogs words and the log universe's T terms and V values, hence W) are
// compile-time macros; build.py compiles one library per layout.  A parity
// layout has E = 0 and compiles none of the history code.
//
// Faithful mode (ops/state.HISTORY_FIELDS, ops/loguniv.py): logs enter the
// history as ranks in the bounded log universe, rank = off[len] + the
// entry codes (t-1)*V + (v-1) read as base-T*V digits (`log_rank`).
// Restart and Timeout clear voterLog[i]; AppendEntries and the RequestVote
// reply put rank(log[i]) into the g field of the lo word; a granted vote
// response fills voterLog[i][j] = g + 1 unless an entry is there;
// BecomeLeader inserts (term, i, rank, votesGranted, voterLog[i]) into the
// first free election slot unless an equal record is present, and a full
// table is the lane's overflow.  allLogs' is the parent's allLogs with the
// ranks of the PARENT's logs added (raft.tla:464-465), the same on every
// lane, so it is computed from the parent row before the action runs.
//
// The dedup key (ops/symmetry.build_orbit_fp, ops/kernels.build_step):
// key = min over g in [0, P*Q) of fp(canonicalize(g(view(s)))), the min
// lexicographic on the unsigned pair (hi, lo); P = n! with Server symmetry
// (else 1), Q = V! with Value symmetry (else 1), g = 0 the identity, so at
// P*Q = 1 without a view the key is the plain fingerprint of the packed
// successor and one code path serves every case.  The permuted state is
// never built: each permuted word is read from the slot at its source
// index and folded into the fingerprint accumulators in place; only the S
// message slots are remapped into registers and re-sorted.  The server
// part of the fold is shared by the Q value permutations of one server
// permutation.  The view (deadvotes: vote sets of non-candidates read as
// 0) is applied as each vote word is read.
//
// Orbit-scan variants (the Pallas kernel's three, `variant` bits of the
// same kernel; ops/kernels.prescan_enabled, sigprune_enabled).  The
// prescan: each pair's owner takes the raw fingerprint of its canonical
// successor and claims it in a block-wide shared table (a 64-bit
// atomicCAS); the first claimant is the group's representative, the
// others take its key, this round or a later one.  Raw-identical
// successors are the same state, so any scope of grouping gives the same
// keys (the reference's _PRESCAN_RUNGS argument).  Skipping a lane alone
// saves nothing on a warp, so a round is one pair a thread and its
// representatives are compacted into a list and scanned `split` threads
// to each by their count.  Sig-prune: per valid lane, exact probes of
// the server and value transpositions (the image built as the scan
// builds it, compared word by word with the viewed successor, after a
// field-by-field necessary test), then the scan skips every group
// element that is not increasing on each verified pair: one element per
// coset of the verified stabilizer, the same minimum
// (ops/symmetry.pruned_orbit_fp).  The two compose.
//
// Group tables: the kernel takes only the permutations themselves, P rows
// of (p[n], inv[n]) and Q rows of q[V], int8 (ops/symmetry.kernel_tables),
// and derives the reference's other tables in the thread: votedFor
// relabel p[j] + 1, the vote-bitmask permutation (n bit moves), the
// message src/dst relabel and the value relabel q[v - 1] + 1.  The
// permutations take P*2n + Q*V bytes (8.7 KB at 6 servers), copied into
// shared memory by each block; the threads of a pair group walk them in
// step, so most table reads are broadcasts.
//
// Faithful mode under Value symmetry also needs the Q rank maps
// (rank -> rank of the value-permuted log, ops/symmetry.kernel_rank_maps),
// int16 [Q][U].  They stay in device memory and are read through the
// read-only cache (__ldg): at U = 1,024 and V = 5 they take 240 KB, over a
// block's shared memory, while the flagship layout's 2 x 43 entries stay
// hot in L1 either way.  Server permutations fix allLogs, eLog, eTerm and
// mlog (ranks hold no server ids); voterLog reorders both axes, occupied
// election slots map eLeader through p and bit-permute eVotes, eVLog
// reorders its columns.  The election slots are remapped into registers
// and re-sorted per group element, like the message slots.
//
// Invariants.  The registry invariants are code paths of `invariant`, by
// the code of models/invariants.CODES.  A cfg expression
// (frontend/predicate.py) has no code path: the host lowers it to a flat
// program of scalar ops over the packed row (ops/predprog.py), and
// `run_expr` interprets it on the canonical successor in the slot, where
// the registry invariants read it.  The invariant codes and the programs
// lie in device memory (a code < 0 is an expression whose program starts
// at word -1 - code), so any number of invariants and any cfg expression
// run on one library per layout; the programs' registers live in local
// memory.  With no expression the stage costs one code read per
// invariant.
//
// Contract (held against the plain step): `valid` equal on every lane;
// every other output bit-equal where `valid` is true.  The other outputs
// of an invalid lane are left unwritten (the engine reads them only where
// `valid` is set); the plain step writes zeros there.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "fp.cuh"

#if !defined(RT_N) || !defined(RT_L) || !defined(RT_S)
#error "compile with -DRT_N=<servers> -DRT_L=<log capacity> -DRT_S=<slots>"
#endif
#ifndef RT_E
#define RT_E 0
#endif
#if RT_E > 0 && (!defined(RT_WA) || !defined(RT_T) || !defined(RT_V))
#error "a faithful layout (RT_E > 0) also needs -DRT_WA, -DRT_T and -DRT_V"
#endif

namespace {

constexpr int N = RT_N, L = RT_L, S = RT_S;
// Flat-vector offsets: ops/state.STATE_FIELDS order.
constexpr int O_ROLE = 0, O_TERM = N, O_VOTED = 2 * N, O_COMMIT = 3 * N,
              O_LOGLEN = 4 * N, O_LOGTERM = 5 * N, O_LOGVAL = 5 * N + N * L,
              O_VRESP = 5 * N + 2 * N * L, O_VGRANT = O_VRESP + N,
              O_NEXT = O_VGRANT + N, O_MATCH = O_NEXT + N * N,
              O_MHI = O_MATCH + N * N, O_MLO = O_MHI + S, O_MCNT = O_MLO + S;
#if RT_E > 0
// Faithful mode: ops/state.HISTORY_FIELDS after the parity fields, and the
// log universe (ops/loguniv.py): radix R = T*V, off(k) = (R^k - 1)/(R - 1)
// logs shorter than k, U = off(L + 1) logs in all.
constexpr int E = RT_E, WA = RT_WA, TC = RT_T, NV = RT_V, RADIX = TC * NV;
constexpr int O_ALLLOGS = O_MCNT + S, O_VLOG = O_ALLLOGS + WA,
              O_ETERM = O_VLOG + N * N, O_ELEADER = O_ETERM + E,
              O_ELOG = O_ELEADER + E, O_EVOTES = O_ELOG + E,
              O_EVLOG = O_EVOTES + E, W = O_EVLOG + E * N;
constexpr int off_c(int k) { return k == 0 ? 0 : off_c(k - 1) * RADIX + 1; }
constexpr int U = off_c(L + 1);
static_assert((U + 31) / 32 == WA, "allLogs words do not match the universe");
static_assert(U <= 1024, "the log universe is capped at 1,024 ranks");
#else
constexpr int W = O_MCNT + S;
#endif

// models/spec.FAMILY_CODES order.
enum Family {
  RESTART, TIMEOUT, REQUESTVOTE, BECOMELEADER, CLIENTREQUEST, ADVANCECOMMIT,
  APPENDENTRIES, RECEIVE, DUPLICATE, DROP
};
enum Role { FOLLOWER = 0, CANDIDATE = 1, LEADER = 2 };
enum MType { M_RVREQ = 1, M_RVRESP = 2, M_AEREQ = 3, M_AERESP = 4 };
// models/invariants.CODES order.
enum Invariant {
  INV_ELECTION_SAFETY, INV_NAIVE_NO_TWO_LEADERS, INV_LOG_MATCHING,
  INV_COMMITTED_WITHIN_LOG, INV_LEADER_COMPLETENESS,
  INV_ELECTION_SAFETY_HIST, INV_LEADER_COMPLETENESS_HIST,
  INV_ALL_LOGS_PREFIX_CLOSED
};

constexpr int kExprRegs = 64;      // ops/predprog.MAX_REGS
constexpr int kThreads = 128;      // threads per block
// Blocks a multiprocessor should hold at once (__launch_bounds__): caps a
// thread's registers at 65,536 / (128 * 4) = 128.
constexpr int kMinBlocks = 4;
constexpr int kMaxRows = 32;       // rows per block, at most
constexpr int kMaxLanes = 256;     // action lanes per row, at most
constexpr int kWp = W | 1;         // shared-memory stride of a row or slot
constexpr int kMaxValues = 15;     // the 4-bit message value field
constexpr int kViewDeadvotes = 1;  // models/views.KERNEL_CODES
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Limits {
  int max_term, max_log, max_msgs, max_dup;
};

// The fingerprint's per-position constants (ops/fingerprint.lane_constants),
// passed by value: read at compile-time offsets, they stay in the constant
// bank.
struct Consts {
  uint32_t c1[W], c2[W];
};

// The state, field by field in ops/state.STATE_FIELDS order: the packed row
// itself, so a row copied into shared memory is read and written in place.
struct St {
  int role[N], term[N], voted[N], commit[N], loglen[N];
  int logterm[N][L], logval[N][L];
  int vresp[N], vgrant[N];
  int next[N][N], match[N][N];
  int mhi[S], mlo[S], mcnt[S];
#if RT_E > 0
  int alllogs[WA], vlog[N][N];
  int eterm[E], eleader[E], elog[E], evotes[E], evlog[E][N];
#endif
};
static_assert(sizeof(St) == W * sizeof(int), "St must be the packed row");

// -- struct access at a runtime index ---------------------------------------
//
// The state lives in shared memory, so a runtime index reads and writes it
// directly.  The write helpers take the pass: `kW` false is the guard pass,
// which evaluates `valid` from the parent row in place and writes nothing.

__device__ __forceinline__ int clampi(int i, int m) {
  return i < 0 ? 0 : (i > m - 1 ? m - 1 : i);
}

// a[i], i clamped into range (as a JAX gather with a traced index is).
template <int M>
__device__ __forceinline__ int rd(const int (&a)[M], int i) {
  return a[clampi(i, M)];
}

template <int M, int K>
__device__ __forceinline__ int rd2(const int (&a)[M][K], int i, int j) {
  return a[clampi(i, M)][clampi(j, K)];
}

// a[i] = v; an index out of range writes nothing (a one-hot update).
template <bool kW, int M>
__device__ __forceinline__ void wr(int (&a)[M], int i, int v) {
  if constexpr (kW) {
    if (i >= 0 && i < M) a[i] = v;
  }
}

template <bool kW, int M, int K>
__device__ __forceinline__ void wr2(int (&a)[M][K], int i, int j, int v) {
  if constexpr (kW) {
    if (i >= 0 && i < M && j >= 0 && j < K) a[i][j] = v;
  }
}

template <bool kW, int M, int K>
__device__ __forceinline__ void wr_row(int (&a)[M][K], int i, int v) {
  if constexpr (kW) {
    if (i >= 0 && i < M) {
#pragma unroll
      for (int y = 0; y < K; ++y) a[i][y] = v;
    }
  }
}

// -- message fields: ops/msgbits.py ----------------------------------------

__device__ __forceinline__ int fld(int w, int sh, int wd) {
  return (w >> sh) & ((1 << wd) - 1);
}
__device__ __forceinline__ int mtype(int hi) { return fld(hi, 0, 3); }
__device__ __forceinline__ int mterm(int hi) { return fld(hi, 3, 6); }
__device__ __forceinline__ int fa(int hi) { return fld(hi, 9, 6); }
__device__ __forceinline__ int fb(int hi) { return fld(hi, 15, 6); }
__device__ __forceinline__ int msrc(int hi) { return fld(hi, 21, 4); }
__device__ __forceinline__ int mdst(int hi) { return fld(hi, 25, 4); }
__device__ __forceinline__ int fc(int lo) { return fld(lo, 0, 1); }
__device__ __forceinline__ int fd(int lo) { return fld(lo, 1, 6); }
__device__ __forceinline__ int fe(int lo) { return fld(lo, 7, 4); }
__device__ __forceinline__ int ff(int lo) { return fld(lo, 11, 6); }
__device__ __forceinline__ int fg(int lo) { return fld(lo, 17, 14); }

// Shifts through uint32, so the bits match int32 two's-complement packing.
__device__ __forceinline__ int shl(int x, int s) {
  return static_cast<int>(static_cast<uint32_t>(x) << s);
}
__device__ __forceinline__ int pack_hi(int mt, int term, int a, int b, int s,
                                       int d) {
  return mt | shl(term, 3) | shl(a, 9) | shl(b, 15) | shl(s, 21) | shl(d, 25);
}
__device__ __forceinline__ int pack_lo(int c, int d, int e, int f,
                                       int g = 0) {
  return c | shl(d, 1) | shl(e, 7) | shl(f, 11) | shl(g, 17);
}

// -- bag operations (raft.tla:106-130) -------------------------------------

// WithMessage; returns the overflow flag (no free slot for a new message).
template <bool kW>
__device__ __forceinline__ bool bag_add(St& s, int hi, int lo) {
  bool exists = false, has_empty = false;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    exists |= s.mhi[k] == hi && s.mlo[k] == lo && s.mcnt[k] > 0;
    has_empty |= s.mcnt[k] == 0;
  }
  if constexpr (kW) {
    bool seen_empty = false;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const bool match = s.mhi[k] == hi && s.mlo[k] == lo && s.mcnt[k] > 0;
      const bool empty = s.mcnt[k] == 0;
      const bool ins = !exists && empty && !seen_empty;
      seen_empty |= empty;
      if (ins) {
        s.mhi[k] = hi;
        s.mlo[k] = lo;
      }
      s.mcnt[k] += static_cast<int>(match) + static_cast<int>(ins);
    }
  }
  return !exists && !has_empty;
}

// WithoutMessage; a no-op when absent.
template <bool kW>
__device__ __forceinline__ void bag_remove(St& s, int hi, int lo) {
  if constexpr (kW) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const bool match = s.mhi[k] == hi && s.mlo[k] == lo && s.mcnt[k] > 0;
      const int c2 = s.mcnt[k] - static_cast<int>(match);
      if (match && c2 == 0) {
        s.mhi[k] = 0;
        s.mlo[k] = 0;
      }
      s.mcnt[k] = c2;
    }
  }
}

// Reply: remove the request, then add the response.
template <bool kW>
__device__ __forceinline__ bool reply(St& s, int resp_hi, int resp_lo,
                                      int req_hi, int req_lo) {
  bag_remove<kW>(s, req_hi, req_lo);
  return bag_add<kW>(s, resp_hi, resp_lo);
}

__device__ __forceinline__ int last_term(const St& s, int i) {
  const int ln = rd(s.loglen, i);
  return ln > 0 ? rd2(s.logterm, i, ln - 1) : 0;
}

#if RT_E > 0
// -- the log universe (ops/loguniv.py) --------------------------------------

// off(k) for 0 <= k <= L + 1 (0 past the end, never asked).
__device__ __forceinline__ int log_off(int k) {
  int o = 0, r = 0;
#pragma unroll
  for (int j = 1; j <= L + 1; ++j) {
    o = o * RADIX + 1;
    if (j == k) r = o;
  }
  return r;
}

// Rank of log[i] (i and the length clamped, as the plain step gathers).
__device__ __forceinline__ int log_rank(const St& s, int i) {
  const int r = clampi(i, N);
  const int ln = min(max(s.loglen[r], 0), L);
  int acc = 0;
#pragma unroll
  for (int k = 0; k < L; ++k)
    if (k < ln)
      acc = acc * RADIX + (s.logterm[r][k] - 1) * NV + (s.logval[r][k] - 1);
  return log_off(ln) + acc;
}

__device__ __forceinline__ int rank_len(int id) {
  int ln = 0;
#pragma unroll
  for (int k = 1; k <= L; ++k)
    if (id >= log_off(k)) ln = k;
  return ln;
}

// Rank of the log minus its last entry (the empty log maps to 0).
__device__ __forceinline__ int prefix_rank(int id) {
  const int ln = rank_len(id);
  const int kk = ln < 1 ? 1 : ln;
  const int rest = max(id - log_off(kk), 0);
  return ln > 0 ? log_off(kk - 1) + rest / RADIX : 0;
}

// Rank -> the log's entries (0 past its length) and length.
__device__ __forceinline__ void decode_log(int id, int (&t)[L], int (&v)[L],
                                          int* len) {
  const int ln = rank_len(id);
  int rem = id - log_off(ln);
#pragma unroll
  for (int k = 0; k < L; ++k) {
    int w = 1;
#pragma unroll
    for (int e = 1; e < L; ++e)
      if (ln - 1 - k >= e) w *= RADIX;
    const bool live = k < ln;
    const int digit = live ? rem / w : 0;
    if (live) rem -= digit * w;
    t[k] = live ? digit / NV + 1 : 0;
    v[k] = live ? digit % NV + 1 : 0;
  }
  *len = ln;
}

__device__ __forceinline__ bool has_rank(const int (&mask)[WA], int r) {
  return (static_cast<uint32_t>(mask[r >> 5]) >> (r & 31)) & 1u;
}
#endif

// -- the message handlers of Receive(m) (raft.tla:284-436) -----------------

// Returns whether a branch was enabled; sets *ovf for the taken branch.
// Every branch condition reads the unprimed state, before any write.
template <bool kW>
__device__ __forceinline__ bool receive(St& s, int slot, bool* ovf) {
  const int hi = rd(s.mhi, slot), lo = rd(s.mlo, slot);
  const int i = mdst(hi), j = msrc(hi);
  const int mt = mterm(hi), mty = mtype(hi);
  const int ct = rd(s.term, i), role_i = rd(s.role, i);
  const int len_i = rd(s.loglen, i);
  if (mt > ct) {  // UpdateTerm (raft.tla:406-412): message kept
    wr<kW>(s.term, i, mt);
    wr<kW>(s.role, i, FOLLOWER);
    wr<kW>(s.voted, i, 0);
    return true;
  }
  if (mty == M_RVREQ) {  // HandleRequestVoteRequest (raft.tla:284-303)
    const int lt = last_term(s, i);
    const bool log_ok = fa(hi) > lt || (fa(hi) == lt && fb(hi) >= len_i);
    const int voted_i = rd(s.voted, i);
    const bool grant =
        mt == ct && log_ok && (voted_i == 0 || voted_i == j + 1);
#if RT_E > 0
    const int mlog = log_rank(s, i);  // the voter's log (raft.tla:297-299)
#else
    const int mlog = 0;
#endif
    if (grant) wr<kW>(s.voted, i, j + 1);
    *ovf = reply<kW>(s, pack_hi(M_RVRESP, ct, grant, 0, i, j),
                     pack_lo(0, 0, 0, 0, mlog), hi, lo);
    return true;
  }
  if (mty == M_RVRESP && mt < ct) {  // DropStaleResponse (raft.tla:415-418)
    bag_remove<kW>(s, hi, lo);
    return true;
  }
  if (mty == M_RVRESP && mt == ct) {  // HandleRequestVoteResponse (:307-321)
    const int bit = shl(1, j);
    wr<kW>(s.vresp, i, rd(s.vresp, i) | bit);
    if (fa(hi) > 0) wr<kW>(s.vgrant, i, rd(s.vgrant, i) | bit);
#if RT_E > 0
    // voterLog[i] @@ (j :> m.mlog): the existing entry wins (:316-317)
    if (fa(hi) > 0 && rd2(s.vlog, i, j) == 0)
      wr2<kW>(s.vlog, i, j, fg(lo) + 1);
#endif
    bag_remove<kW>(s, hi, lo);
    return true;
  }
  if (mty == M_AEREQ) {  // HandleAppendEntriesRequest (raft.tla:327-389)
    const int prev_idx = fa(hi), prev_term = fb(hi);
    const int n_ent = fc(lo), ent_term = fd(lo), ent_val = fe(lo);
    const bool log_ok =
        prev_idx == 0 || (prev_idx > 0 && prev_idx <= len_i &&
                          prev_term == rd2(s.logterm, i, prev_idx - 1));
    if (mt < ct || (mt == ct && role_i == FOLLOWER && !log_ok)) {  // reject
      *ovf = reply<kW>(s, pack_hi(M_AERESP, ct, 0, 0, i, j), 0, hi, lo);
      return true;
    }
    if (mt == ct && role_i == CANDIDATE) {  // step down; message kept
      wr<kW>(s.role, i, FOLLOWER);
      return true;
    }
    if (mt == ct && role_i == FOLLOWER && log_ok) {  // accept
      const int index = prev_idx + 1;
      const int t_at = rd2(s.logterm, i, index - 1);
      if (n_ent == 0 || (len_i >= index && t_at == ent_term)) {
        // already done (raft.tla:356-374): commitIndex := mcommitIndex
        wr<kW>(s.commit, i, ff(lo));
        *ovf = reply<kW>(s, pack_hi(M_AERESP, ct, 1, prev_idx + n_ent, i, j),
                         0, hi, lo);
        return true;
      }
      if (n_ent > 0 && len_i >= index && t_at != ent_term) {
        // conflict: drop one entry off the tail; message kept
        wr2<kW>(s.logterm, i, len_i - 1, 0);
        wr2<kW>(s.logval, i, len_i - 1, 0);
        wr<kW>(s.loglen, i, len_i - 1);
        return true;
      }
      if (n_ent > 0 && len_i == prev_idx) {  // append (raft.tla:383-388)
        wr2<kW>(s.logterm, i, len_i, ent_term);
        wr2<kW>(s.logval, i, len_i, ent_val);
        wr<kW>(s.loglen, i, len_i + 1);
        *ovf = len_i >= L;
        return true;
      }
    }
    return false;
  }
  if (mty == M_AERESP && mt < ct) {  // DropStaleResponse
    bag_remove<kW>(s, hi, lo);
    return true;
  }
  if (mty == M_AERESP && mt == ct) {  // HandleAppendEntriesResponse
    const bool succ = fa(hi) > 0;
    const int match = fb(hi);
    const int ni = rd2(s.next, i, j);
    wr2<kW>(s.next, i, j, succ ? match + 1 : max(ni - 1, 1));
    if (succ) wr2<kW>(s.match, i, j, match);
    bag_remove<kW>(s, hi, lo);
    return true;
  }
  return false;
}

#if RT_E > 0
// BecomeLeader's record into the elections set (raft.tla:237-242), all from
// the unprimed state: the first free slot (eTerm = 0) unless an equal
// record is present.  Returns the overflow flag (no free slot).
template <bool kW>
__device__ __forceinline__ bool elections_insert(St& s, int i) {
  const int r = clampi(i, N);
  const int lid = log_rank(s, i), ti = s.term[r], vg = s.vgrant[r];
  bool exists = false, has_empty = false;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool occ = s.eterm[e] > 0;
    bool match = occ && s.eterm[e] == ti && s.eleader[e] == i &&
                 s.elog[e] == lid && s.evotes[e] == vg;
#pragma unroll
    for (int m = 0; m < N; ++m) match &= s.evlog[e][m] == s.vlog[r][m];
    exists |= match;
    has_empty |= !occ;
  }
  if constexpr (kW) {
    bool seen_empty = false;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool empty = !(s.eterm[e] > 0);
      if (!exists && empty && !seen_empty) {
        s.eterm[e] = ti;
        s.eleader[e] = i;
        s.elog[e] = lid;
        s.evotes[e] = vg;
#pragma unroll
        for (int m = 0; m < N; ++m) s.evlog[e][m] = s.vlog[r][m];
      }
      seen_empty |= empty;
    }
  }
  return !exists && !has_empty;
}
#endif

// -- the action families (raft.tla:167-276, 421-450) -----------------------

// Applies lane (fam, i, j, v, slot) to s in place; returns `valid` and sets
// *ovf (already masked by valid).  Every guard reads the unprimed state
// before the family writes anything, so the guard pass (kW false) returns
// the same `valid` without touching s.
template <bool kW>
__device__ __forceinline__ bool apply(St& s, int fam, int i, int j, int v,
                                      int slot, bool* ovf) {
  bool valid = false, o = false;
  switch (fam) {
    case RESTART:
      wr<kW>(s.role, i, FOLLOWER);
      wr<kW>(s.vresp, i, 0);
      wr<kW>(s.vgrant, i, 0);
      wr_row<kW>(s.next, i, 1);
      wr_row<kW>(s.match, i, 0);
      wr<kW>(s.commit, i, 0);
#if RT_E > 0
      wr_row<kW>(s.vlog, i, 0);  // voterLog[i] := empty map (raft.tla:171)
#endif
      valid = true;
      break;
    case TIMEOUT: {
      const int r = rd(s.role, i), t = rd(s.term, i);
      valid = r == FOLLOWER || r == CANDIDATE;
      wr<kW>(s.role, i, CANDIDATE);
      wr<kW>(s.term, i, t + 1);
      wr<kW>(s.voted, i, 0);
      wr<kW>(s.vresp, i, 0);
      wr<kW>(s.vgrant, i, 0);
#if RT_E > 0
      wr_row<kW>(s.vlog, i, 0);  // voterLog[i] := empty map (raft.tla:186)
#endif
      break;
    }
    case REQUESTVOTE: {
      valid = rd(s.role, i) == CANDIDATE && ((rd(s.vresp, i) >> j) & 1) == 0;
      const int hi =
          pack_hi(M_RVREQ, rd(s.term, i), last_term(s, i), rd(s.loglen, i), i,
                  j);
      o = bag_add<kW>(s, hi, 0);
      break;
    }
    case BECOMELEADER: {
      valid = rd(s.role, i) == CANDIDATE &&
              2 * __popc(static_cast<uint32_t>(rd(s.vgrant, i))) > N;
      const int ln = rd(s.loglen, i);
      wr<kW>(s.role, i, LEADER);
      wr_row<kW>(s.next, i, ln + 1);
      wr_row<kW>(s.match, i, 0);
#if RT_E > 0
      o = elections_insert<kW>(s, i);
#endif
      break;
    }
    case CLIENTREQUEST: {
      const int ln = rd(s.loglen, i), t = rd(s.term, i);
      valid = rd(s.role, i) == LEADER;
      wr2<kW>(s.logterm, i, ln, t);
      wr2<kW>(s.logval, i, ln, v);
      wr<kW>(s.loglen, i, ln + 1);
      o = ln >= L;
      break;
    }
    case ADVANCECOMMIT: {
      valid = rd(s.role, i) == LEADER;
      if constexpr (kW) {
        const int ln = rd(s.loglen, i);
        int max_agree = 0;
#pragma unroll
        for (int idx = 1; idx <= L; ++idx) {
          int cnt = 0;
#pragma unroll
          for (int k = 0; k < N; ++k)
            cnt += (rd2(s.match, i, k) >= idx || k == i) ? 1 : 0;
          if (2 * cnt > N && idx <= ln) max_agree = idx;
        }
        const int t_at = rd2(s.logterm, i, max_agree - 1);
        const int commit = (max_agree > 0 && t_at == rd(s.term, i))
                               ? max_agree
                               : rd(s.commit, i);
        wr<kW>(s.commit, i, commit);
      }
      break;
    }
    case APPENDENTRIES: {
      valid = i != j && rd(s.role, i) == LEADER;
      const int ni = rd2(s.next, i, j);
      const int prev_idx = ni - 1;
      const int prev_term = prev_idx > 0 ? rd2(s.logterm, i, prev_idx - 1) : 0;
      const int last_entry = min(rd(s.loglen, i), ni);
      const bool has_ent = ni <= last_entry;
      const int ent_term = has_ent ? rd2(s.logterm, i, ni - 1) : 0;
      const int ent_val = has_ent ? rd2(s.logval, i, ni - 1) : 0;
      const int hi = pack_hi(M_AEREQ, rd(s.term, i), prev_idx, prev_term, i, j);
#if RT_E > 0
      const int mlog = log_rank(s, i);  // the leader's log (raft.tla:220-222)
#else
      const int mlog = 0;
#endif
      const int lo = pack_lo(has_ent, ent_term, ent_val,
                             min(rd(s.commit, i), last_entry), mlog);
      o = bag_add<kW>(s, hi, lo);
      break;
    }
    case RECEIVE: {
      const bool occupied = rd(s.mcnt, slot) > 0;
      valid = receive<kW>(s, slot, &o) && occupied;
      break;
    }
    case DUPLICATE:
      valid = rd(s.mcnt, slot) > 0;
      wr<kW>(s.mcnt, slot, rd(s.mcnt, slot) + 1);
      break;
    case DROP:
      valid = rd(s.mcnt, slot) > 0;
      bag_remove<kW>(s, rd(s.mhi, slot), rd(s.mlo, slot));
      break;
    default:
      break;
  }
  *ovf = valid && o;
  return valid;
}

// Message slots into canonical order: occupied first, then (hi, lo); empty
// slots all-zero.  Odd-even transposition network (ops/state._network_sort).
__device__ __forceinline__ void sort_bag(int (&hi)[S], int (&lo)[S],
                                         int (&cnt)[S]) {
  int occ[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const bool o = cnt[k] > 0;
    occ[k] = o ? 0 : 1;
    if (!o) {
      hi[k] = 0;
      lo[k] = 0;
      cnt[k] = 0;
    }
  }
#pragma unroll
  for (int r = 0; r < S; ++r)
#pragma unroll
    for (int a = r % 2; a < S - 1; a += 2) {
      const int b = a + 1;
      bool le = lo[a] <= lo[b];
      le = hi[a] < hi[b] || (hi[a] == hi[b] && le);
      le = occ[a] < occ[b] || (occ[a] == occ[b] && le);
      if (!le) {
        int t = occ[a]; occ[a] = occ[b]; occ[b] = t;
        t = hi[a]; hi[a] = hi[b]; hi[b] = t;
        t = lo[a]; lo[a] = lo[b]; lo[b] = t;
        t = cnt[a]; cnt[a] = cnt[b]; cnt[b] = t;
      }
    }
}

#if RT_E > 0
// Election slots into canonical order (ops/state.canonicalize): occupied
// (eTerm > 0) first, then (eTerm, eLeader, eLog, eVotes, eVLog columns),
// the same odd-even network over E slots.
__device__ __forceinline__ void sort_elections(int (&et)[E], int (&el)[E],
                                               int (&eg)[E], int (&ev)[E],
                                               int (&evl)[E][N]) {
#pragma unroll
  for (int r = 0; r < E; ++r)
#pragma unroll
    for (int a = r % 2; a < E - 1; a += 2) {
      const int b = a + 1;
      bool le = true;  // key[a] <= key[b], least significant word first
#pragma unroll
      for (int m = N - 1; m >= 0; --m)
        le = evl[a][m] < evl[b][m] || (evl[a][m] == evl[b][m] && le);
      le = ev[a] < ev[b] || (ev[a] == ev[b] && le);
      le = eg[a] < eg[b] || (eg[a] == eg[b] && le);
      le = el[a] < el[b] || (el[a] == el[b] && le);
      le = et[a] < et[b] || (et[a] == et[b] && le);
      const int oa = et[a] > 0 ? 0 : 1, ob = et[b] > 0 ? 0 : 1;
      le = oa < ob || (oa == ob && le);
      if (!le) {
        int t = et[a]; et[a] = et[b]; et[b] = t;
        t = el[a]; el[a] = el[b]; el[b] = t;
        t = eg[a]; eg[a] = eg[b]; eg[b] = t;
        t = ev[a]; ev[a] = ev[b]; ev[b] = t;
#pragma unroll
        for (int m = 0; m < N; ++m) {
          t = evl[a][m]; evl[a][m] = evl[b][m]; evl[b][m] = t;
        }
      }
    }
}
#endif

// Sorts in registers and writes back: the slot is read and written once.
__device__ __forceinline__ void canonicalize(St& s) {
  int hi[S], lo[S], cnt[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    hi[k] = s.mhi[k];
    lo[k] = s.mlo[k];
    cnt[k] = s.mcnt[k];
  }
  sort_bag(hi, lo, cnt);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    s.mhi[k] = hi[k];
    s.mlo[k] = lo[k];
    s.mcnt[k] = cnt[k];
  }
#if RT_E > 0
  int et[E], el[E], eg[E], ev[E], evl[E][N];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    et[e] = s.eterm[e];
    el[e] = s.eleader[e];
    eg[e] = s.elog[e];
    ev[e] = s.evotes[e];
#pragma unroll
    for (int m = 0; m < N; ++m) evl[e][m] = s.evlog[e][m];
  }
  sort_elections(et, el, eg, ev, evl);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    s.eterm[e] = et[e];
    s.eleader[e] = el[e];
    s.elog[e] = eg[e];
    s.evotes[e] = ev[e];
#pragma unroll
    for (int m = 0; m < N; ++m) s.evlog[e][m] = evl[e][m];
  }
#endif
}

// -- invariants (models/invariants.py) and the StateConstraint --------------

__device__ __forceinline__ bool invariant(const St& s, int code) {
  switch (code) {
    case INV_ELECTION_SAFETY: {
      bool ok = true;
#pragma unroll
      for (int a = 0; a < N; ++a)
#pragma unroll
        for (int b = a + 1; b < N; ++b)
          ok &= !(s.role[a] == LEADER && s.role[b] == LEADER &&
                  s.term[a] == s.term[b]);
      return ok;
    }
    case INV_NAIVE_NO_TWO_LEADERS: {
      int cnt = 0;
#pragma unroll
      for (int a = 0; a < N; ++a) cnt += s.role[a] == LEADER;
      return cnt <= 1;
    }
    case INV_LOG_MATCHING: {
      bool ok = true;
#pragma unroll
      for (int a = 0; a < N; ++a)
#pragma unroll
        for (int b = a + 1; b < N; ++b) {
          bool prefix = true;
#pragma unroll
          for (int k = 0; k < L; ++k) {
            const bool teq = s.logterm[a][k] == s.logterm[b][k];
            prefix &= teq && s.logval[a][k] == s.logval[b][k];
            const bool in_both = k < s.loglen[a] && k < s.loglen[b];
            ok &= !(in_both && teq && !prefix);
          }
        }
      return ok;
    }
    case INV_COMMITTED_WITHIN_LOG: {
      bool ok = true;
#pragma unroll
      for (int a = 0; a < N; ++a) ok &= s.commit[a] <= s.loglen[a];
      return ok;
    }
    case INV_LEADER_COMPLETENESS: {
      bool ok = true;
#pragma unroll
      for (int a = 0; a < N; ++a)        // the later leader
#pragma unroll
        for (int b = 0; b < N; ++b)      // the committing server
#pragma unroll
          for (int k = 0; k < L; ++k) {
            const bool must = s.role[a] == LEADER && s.term[a] > s.term[b] &&
                              k < s.commit[b];
            const bool has = k < s.loglen[a] &&
                             s.logterm[a][k] == s.logterm[b][k] &&
                             s.logval[a][k] == s.logval[b][k];
            ok &= !(must && !has);
          }
      return ok;
    }
#if RT_E > 0
    case INV_ELECTION_SAFETY_HIST: {  // one leader ever elected per term
      bool ok = true;
#pragma unroll
      for (int a = 0; a < E; ++a)
#pragma unroll
        for (int b = 0; b < E; ++b)
          ok &= !(s.eterm[a] > 0 && s.eterm[b] > 0 &&
                  s.eterm[a] == s.eterm[b] && s.eleader[a] != s.eleader[b]);
      return ok;
    }
    case INV_LEADER_COMPLETENESS_HIST: {  // committed entries in every later
      bool ok = true;                     // election's elog
#pragma unroll 1
      for (int e = 0; e < E; ++e) {
        int et[L], ev[L], eln;
        decode_log(s.elog[e], et, ev, &eln);
#pragma unroll
        for (int j = 0; j < N; ++j)
#pragma unroll
          for (int k = 0; k < L; ++k) {
            const bool must =
                s.eterm[e] > 0 && s.eterm[e] > s.term[j] && k < s.commit[j];
            const bool has = k < eln && et[k] == s.logterm[j][k] &&
                             ev[k] == s.logval[j][k];
            ok &= !(must && !has);
          }
      }
      return ok;
    }
    case INV_ALL_LOGS_PREFIX_CLOSED: {  // every recorded log's prefix too
#pragma unroll 1
      for (int w = 0; w < WA; ++w) {
        uint32_t bits = static_cast<uint32_t>(s.alllogs[w]);
        while (bits) {
          const int r = 32 * w + __ffs(bits) - 1;
          bits &= bits - 1;
          if (r >= 1 && r < U && !has_rank(s.alllogs, prefix_rank(r)))
            return false;
        }
      }
      return true;
    }
#endif
    default:
      return false;
  }
}

// ops/predprog.OPS order.
enum ExprOp {
  X_CONST, X_LOAD, X_LOADIX, X_NEG, X_NOT, X_ADD, X_SUB, X_MUL, X_EQ, X_NE,
  X_LT, X_LE, X_GT, X_GE, X_AND, X_OR, X_IMPL, X_MIN, X_MAX, X_RET
};

// An expression invariant: the program at `prog`, five words an
// instruction (op, dst, a, b, c), over the row `row`.  Arithmetic wraps
// modulo 2^32 as the reference's int32 does; an indexed load wraps a
// negative index once and clamps it into range, as a JAX gather does.
__device__ __noinline__ bool run_expr(const int* row,
                                      const int* __restrict__ prog) {
  int r[kExprRegs];
  for (const int* p = prog;; p += 5) {
    const int op = __ldg(p), d = __ldg(p + 1), a = __ldg(p + 2),
              b = __ldg(p + 3), c = __ldg(p + 4);
    int v;
    switch (op) {
      case X_CONST: v = a; break;
      case X_LOAD: v = row[a]; break;
      case X_LOADIX: {
        int i = r[c];
        i = i < 0 ? i + b : i;
        v = row[a + (i < 0 ? 0 : (i > b - 1 ? b - 1 : i))];
        break;
      }
      case X_NEG: v = static_cast<int>(0u - static_cast<uint32_t>(r[a])); break;
      case X_NOT: v = r[a] == 0; break;
      case X_ADD:
        v = static_cast<int>(static_cast<uint32_t>(r[a]) +
                             static_cast<uint32_t>(r[b]));
        break;
      case X_SUB:
        v = static_cast<int>(static_cast<uint32_t>(r[a]) -
                             static_cast<uint32_t>(r[b]));
        break;
      case X_MUL:
        v = static_cast<int>(static_cast<uint32_t>(r[a]) *
                             static_cast<uint32_t>(r[b]));
        break;
      case X_EQ: v = r[a] == r[b]; break;
      case X_NE: v = r[a] != r[b]; break;
      case X_LT: v = r[a] < r[b]; break;
      case X_LE: v = r[a] <= r[b]; break;
      case X_GT: v = r[a] > r[b]; break;
      case X_GE: v = r[a] >= r[b]; break;
      case X_AND: v = r[a] != 0 && r[b] != 0; break;
      case X_OR: v = r[a] != 0 || r[b] != 0; break;
      case X_IMPL: v = r[a] == 0 || r[b] != 0; break;
      case X_MIN: v = r[a] < r[b] ? r[a] : r[b]; break;
      case X_MAX: v = r[a] > r[b] ? r[a] : r[b]; break;
      default: return r[a] != 0;  // X_RET
    }
    r[d] = v;
  }
}

__device__ __forceinline__ bool constraint_ok(const St& s, const Limits& lim) {
  bool ok = true;
  int msgs = 0;
#pragma unroll
  for (int a = 0; a < N; ++a)
    ok &= s.term[a] <= lim.max_term && s.loglen[a] <= lim.max_log;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    msgs += s.mcnt[k] > 0;
    ok &= s.mcnt[k] <= lim.max_dup;
  }
  return ok && msgs <= lim.max_msgs;
}

// -- the dedup key: VIEW and the orbit-minimal fingerprint ------------------
//
// ops/symmetry.py: a server permutation p (new index of old server j is
// p[j]) reads row inv[k] into row k, relabels votedFor through p (0 = Nil
// fixed), moves bit j of a vote mask to bit p[j], reorders both axes of
// nextIndex/matchIndex and relabels src/dst of occupied message slots; a
// value permutation q relabels logVal (0 fixed) and the entry-value field e
// of occupied slots.  Out-of-range inputs are clamped as the reference's
// table gathers clamp them.

struct Group {
  const int8_t* perm;     // P rows of (p[N], inv[N])
  const int8_t* vals;     // Q rows of q[nv]
  const int16_t* rmaps;   // faithful mode with nv > 0: Q rows of rank maps
  int P, Q, nv;           // nv = 0: no value permutation
  int view;               // models/views.KERNEL_CODES
};

constexpr int kHiKeep = ~((15 << 21) | (15 << 25));  // msgbits src, dst
constexpr int kLoKeepE = ~(15 << 7);                 // msgbits e

// Folds word x at position w (a compile-time offset after unrolling).
__device__ __forceinline__ void mac(RtFp& acc, const Consts& cs, int w,
                                    int x) {
  rt_fp_mac(acc, x, cs.c1[w], cs.c2[w]);
}

// The value relabel q[v - 1] + 1 of vlut[clamp(v, 0, V)].
__device__ __forceinline__ int relabel_value(const int8_t* q, int nv, int v) {
  const int c = v < 0 ? 0 : (v > nv ? nv : v);
  return c == 0 ? 0 : q[c - 1] + 1;
}

#if RT_E > 0
constexpr int kGMask = (1 << 14) - 1;  // msgbits g

// rank -> rank of the value-permuted log (rmap clamped, as the plain
// version's table gathers clamp), and the same in the rank+1 form.
__device__ __forceinline__ int map_rank(const int16_t* rm, int r) {
  return rm ? __ldg(rm + (r < 0 ? 0 : (r > U - 1 ? U - 1 : r))) : r;
}
__device__ __forceinline__ int map_rank1(const int16_t* rm, int x) {
  if (!rm) return x;
  const int c = x < 0 ? 0 : (x > U ? U : x);
  return c == 0 ? 0 : __ldg(rm + c - 1) + 1;
}

// The history fields of g(s), word by word into `out` (a fold or a
// compare, below): server permutation `row` (p[N] then inv[N]) then the
// value permutation's rank map rm (null: identity); the election slots are
// remapped into registers and re-sorted.
template <class Sink>
__device__ __forceinline__ void history_words(const St& s, const int8_t* row,
                                              const int (&p)[N],
                                              const int (&inv)[N],
                                              const int16_t* rm, Sink& out) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int m = 0; m < N; ++m)
      out(O_VLOG + k * N + m, map_rank1(rm, s.vlog[inv[k]][inv[m]]));
  if (rm) {  // allLogs: bit r moves to bit rm[r]
    int mask[WA];
#pragma unroll
    for (int w = 0; w < WA; ++w) mask[w] = 0;
#pragma unroll 1
    for (int w = 0; w < WA; ++w) {
      uint32_t bits = static_cast<uint32_t>(s.alllogs[w]);
      while (bits) {
        const int r = 32 * w + __ffs(bits) - 1;
        bits &= bits - 1;
        if (r < U) {
          const int t = __ldg(rm + r);
#pragma unroll
          for (int x = 0; x < WA; ++x)
            if (x == t >> 5) mask[x] |= shl(1, t & 31);
        }
      }
    }
#pragma unroll
    for (int w = 0; w < WA; ++w) out(O_ALLLOGS + w, mask[w]);
  } else {
#pragma unroll
    for (int w = 0; w < WA; ++w) out(O_ALLLOGS + w, s.alllogs[w]);
  }
  int et[E], el[E], eg[E], ev[E], evl[E][N];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool occ = s.eterm[e] > 0;
    et[e] = s.eterm[e];
    const int ld = s.eleader[e] < 0 ? 0 : (s.eleader[e] > 15 ? 15
                                                             : s.eleader[e]);
    el[e] = occ ? (ld < N ? row[ld] : 0) : s.eleader[e];
    eg[e] = map_rank(rm, s.elog[e]);
    int pv = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) pv |= ((s.evotes[e] >> j) & 1) << p[j];
    ev[e] = occ ? pv : s.evotes[e];
#pragma unroll
    for (int m = 0; m < N; ++m) evl[e][m] = map_rank1(rm, s.evlog[e][inv[m]]);
  }
  sort_elections(et, el, eg, ev, evl);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    out(O_ETERM + e, et[e]);
    out(O_ELEADER + e, el[e]);
    out(O_ELOG + e, eg[e]);
    out(O_EVOTES + e, ev[e]);
#pragma unroll
    for (int m = 0; m < N; ++m) out(O_EVLOG + e * N + m, evl[e][m]);
  }
}
#endif

// The two sinks of an image's words.  A fold takes each word into the
// fingerprint accumulators (the key of a group element); a compare holds
// each word to the same word of the (viewed) canonical successor, which
// is how sig-prune's transposition probes test g(s) == s exactly.
struct FoldSink {
  const Consts& cs;
  RtFp acc;
  __device__ __forceinline__ void operator()(int w, int x) {
    mac(acc, cs, w, x);
  }
};

struct CmpSink {
  const int* id;  // the canonical successor, unviewed, in its slot
  int view;
  bool eq;
  __device__ __forceinline__ void operator()(int w, int x) {
    int y = id[w];
    // w is a compile-time offset after unrolling: the test folds away
    if (w >= O_VRESP && w < O_VGRANT + N && view == kViewDeadvotes &&
        id[O_ROLE + (w - O_VRESP) % N] != CANDIDATE)
      y = 0;
    eq &= x == y;
  }
};

// The server permutation `row` = (p, inv) applied to everything but logVal
// and the messages' value fields and order: shared by the Q value
// permutations of one server permutation.  The view (deadvotes) is applied
// as each vote word is read.
template <class Sink>
__device__ __forceinline__ void server_words(const St& s, const int8_t* row,
                                             const int (&p)[N],
                                             const int (&inv)[N], int view,
                                             Sink& out) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int src = inv[k];
    const int role = s.role[src];
    out(O_ROLE + k, role);
    out(O_TERM + k, s.term[src]);
    const int vf = clampi(s.voted[src], N + 1);
    out(O_VOTED + k, vf == 0 ? 0 : row[vf - 1] + 1);
    out(O_COMMIT + k, s.commit[src]);
    out(O_LOGLEN + k, s.loglen[src]);
#pragma unroll
    for (int l = 0; l < L; ++l) out(O_LOGTERM + k * L + l, s.logterm[src][l]);
    const bool dead = view == kViewDeadvotes && role != CANDIDATE;
    const int vr = dead ? 0 : s.vresp[src];
    const int vg = dead ? 0 : s.vgrant[src];
    int pr = 0, pg = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      pr |= ((vr >> j) & 1) << p[j];
      pg |= ((vg >> j) & 1) << p[j];
    }
    out(O_VRESP + k, pr);
    out(O_VGRANT + k, pg);
#pragma unroll
    for (int m = 0; m < N; ++m) {
      out(O_NEXT + k * N + m, s.next[src][inv[m]]);
      out(O_MATCH + k * N + m, s.match[src][inv[m]]);
    }
  }
}

// The messages' hi words with src and dst relabelled by `row` (occupied
// slots only), before the re-sort.
__device__ __forceinline__ void relabel_hi(const St& s, const int8_t* row,
                                           int (&phi)[S]) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int hi = s.mhi[k];
    const int sx = (hi >> 21) & 15, dx = (hi >> 25) & 15;
    const int ns = sx < N ? row[sx] : 0, nd = dx < N ? row[dx] : 0;
    phi[k] = s.mcnt[k] > 0 ? (hi & kHiKeep) | shl(ns, 21) | shl(nd, 25) : hi;
  }
}

// The rest of the image under value permutation qi (g.nv = 0: none):
// logVal, the re-sorted messages and, in faithful mode, the history.
template <class Sink>
__device__ __forceinline__ void value_words(const St& s, const Group& g,
                                            const int8_t* row,
                                            const int (&p)[N],
                                            const int (&inv)[N],
                                            const int (&phi)[S], int qi,
                                            Sink& out) {
  const int8_t* q = g.vals + qi * g.nv;
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int v = s.logval[inv[k]][l];
      out(O_LOGVAL + k * L + l, g.nv ? relabel_value(q, g.nv, v) : v);
    }
#if RT_E > 0
  // The value permutation's rank map (none: the identity).
  const int16_t* rm = g.nv ? g.rmaps + qi * U : nullptr;
#endif
  int mh[S], ml[S], mc[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    mh[k] = phi[k];
    mc[k] = s.mcnt[k];
    const int lo = s.mlo[k];
    const int e = (lo >> 7) & 15;
    const int ne = e >= 1 && e <= g.nv ? q[e - 1] + 1 : 0;
    int nlo = (lo & kLoKeepE) | shl(ne, 7);
#if RT_E > 0
    if (rm) {  // mlog, the g field
      const int gr = (lo >> 17) & kGMask;
      nlo = (nlo & ~(kGMask << 17)) | shl(gr < U ? __ldg(rm + gr) : 0, 17);
    }
#endif
    ml[k] = g.nv && mc[k] > 0 ? nlo : lo;
  }
  sort_bag(mh, ml, mc);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    out(O_MHI + k, mh[k]);
    out(O_MLO + k, ml[k]);
    out(O_MCNT + k, mc[k]);
  }
#if RT_E > 0
  history_words(s, row, p, inv, rm, out);
#endif
}

__device__ __forceinline__ void load_perm(const int8_t* row, int (&p)[N],
                                          int (&inv)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    p[k] = row[k];
    inv[k] = row[N + k];
  }
}

// Sig-prune (ops/symmetry.pruned_orbit_fp).  Pair k of n items is the k-th
// (a, b), a < b, in lexicographic order; its transposition's index in the
// group table is its rank among the n! permutations in lexicographic
// (itertools) order: c_a = b - a, c_i = 1 for a < i < b, else 0.
__device__ __forceinline__ void pair_of(int k, int n, int* a, int* b) {
  int x = 0;
  while (k >= n - 1 - x) {
    k -= n - 1 - x;
    ++x;
  }
  *a = x;
  *b = x + 1 + k;
}

__device__ __forceinline__ int transposition_rank(int a, int b, int n) {
  int r = 0;
  for (int i = 0; i < n; ++i)
    r = r * (n - i) + (i == a ? b - a : (i > a && i < b ? 1 : 0));
  return r;
}

// Exact probe: does the transposition (a b) of the servers (`server`) or
// of the values map the (viewed) successor s to itself?  The image is
// built as the orbit scan builds it and compared word by word.
__device__ __forceinline__ bool probe(const St& s, const Group& g, bool server,
                                      int a, int b) {
  const int8_t* row =
      g.perm + (server ? transposition_rank(a, b, N) : 0) * 2 * N;
  const int qi = server ? 0 : transposition_rank(a, b, g.nv);
  int p[N], inv[N], phi[S];
  load_perm(row, p, inv);
  relabel_hi(s, row, phi);
  CmpSink c{reinterpret_cast<const int*>(&s), g.view, true};
  server_words(s, row, p, inv, g.view, c);
  value_words(s, g, row, p, inv, phi, qi, c);
  return c.eq;
}

// A cheap necessary condition for servers a and b to be interchangeable
// (the reference's `_server_sig`, compared field by field instead of
// hashed): equal role, term, commitIndex, log, votedFor class and vote
// counts.  It only skips probes that would fail.
__device__ __forceinline__ bool may_swap(const St& s, int view, int a, int b) {
  bool ok = s.role[a] == s.role[b] && s.term[a] == s.term[b] &&
            s.commit[a] == s.commit[b] && s.loglen[a] == s.loglen[b];
#pragma unroll
  for (int l = 0; l < L; ++l)
    ok &= s.logterm[a][l] == s.logterm[b][l] &&
          s.logval[a][l] == s.logval[b][l];
  const int va = s.voted[a], vb = s.voted[b];
  ok &= (va == 0 ? 0 : (va == a + 1 ? 1 : 2)) ==
        (vb == 0 ? 0 : (vb == b + 1 ? 1 : 2));
  const bool da = view == kViewDeadvotes && s.role[a] != CANDIDATE;
  const bool db = view == kViewDeadvotes && s.role[b] != CANDIDATE;
  ok &= __popc(da ? 0 : s.vresp[a]) == __popc(db ? 0 : s.vresp[b]) &&
        __popc(da ? 0 : s.vgrant[a]) == __popc(db ? 0 : s.vgrant[b]);
  return ok;
}

// Is `perm` (n entries) increasing on every verified pair of `eq`?  The
// coset-representative rule: exactly one element of each coset of the
// verified stabilizer passes, so skipping the others drops only duplicate
// orbit members and the minimum is the full scan's.
template <class T>
__device__ __forceinline__ bool kept(const T* perm, int n, unsigned eq) {
  bool keep = true;
  for (int k = 0; eq; ++k, eq >>= 1)
    if (eq & 1) {
      int a, b;
      pair_of(k, n, &a, &b);
      keep &= perm[a] < perm[b];
    }
  return keep;
}

// The minimum, as (hi << 32) | lo, of the keys of the group elements whose
// server permutation is sub, sub + split, ... (each with all Q value
// permutations), skipping the elements that the verified server and value
// pairs `eqs` and `eqv` drop (0, 0: none); all ones when there is none.
// `scanned` counts the elements keyed.
__device__ __forceinline__ uint64_t orbit_min(const St& s, const Group& g,
                                              const Consts& cs, int sub,
                                              int split, unsigned eqs,
                                              unsigned eqv, int* scanned) {
  uint64_t best = ~0ull;
#pragma unroll 1
  for (int pi = sub; pi < g.P; pi += split) {
    const int8_t* row = g.perm + pi * 2 * N;
    int p[N], inv[N];
    load_perm(row, p, inv);
    if (eqs && !kept(p, N, eqs)) continue;
    FoldSink base{cs, RtFp{}};
    server_words(s, row, p, inv, g.view, base);
    int phi[S];
    relabel_hi(s, row, phi);
#pragma unroll 1
    for (int qi = 0; qi < g.Q; ++qi) {
      if (eqv && !kept(g.vals + qi * g.nv, g.nv, eqv)) continue;
      FoldSink acc = base;
      value_words(s, g, row, p, inv, phi, qi, acc);
      const uint64_t key = (static_cast<uint64_t>(rt_fmix32(
                                acc.acc.s1 + RT_LANE_SEED_HI)) << 32) |
                           rt_fmix32(acc.acc.s2 + RT_LANE_SEED_LO);
      best = key < best ? key : best;
      ++*scanned;
    }
  }
  return best;
}

// The prescan (ops/kernels.orbit_fp_prescan): the raw fingerprint of the
// canonical successor, unviewed — raw-identical successors of one block
// share one orbit scan.
__device__ __forceinline__ uint64_t raw_key(const St& s, const Consts& cs) {
  const int* w = reinterpret_cast<const int*>(&s);
  RtFp acc{};
#pragma unroll
  for (int x = 0; x < W; ++x) mac(acc, cs, x, w[x]);
  return (static_cast<uint64_t>(rt_fmix32(acc.s1 + RT_LANE_SEED_HI)) << 32) |
         rt_fmix32(acc.s2 + RT_LANE_SEED_LO);
}

// -- the kernel --------------------------------------------------------------

// One pair's orbit key, by the `split` threads of its group (`sub` each;
// `on` false: a thread without a pair, which takes part in the shuffles):
// sig-prune's probes shared out and their verified pairs OR-ed across the
// group, the orbit scan, the minimum across the group.
__device__ __forceinline__ uint64_t scan_pair(const St& s, const Group& g,
                                              const Consts& cs, bool on,
                                              bool sigprune, int sub,
                                              int split, int* scanned,
                                              int* probes) {
  const int sp = g.P > 1 ? N * (N - 1) / 2 : 0;
  const int vp = g.Q > 1 ? g.nv * (g.nv - 1) / 2 : 0;
  unsigned eqs = 0, eqv = 0;
  if (sigprune && on) {
    for (int t = sub; t < sp + vp; t += split) {
      int a, b;
      if (t < sp) {
        pair_of(t, N, &a, &b);
        if (may_swap(s, g.view, a, b)) {
          eqs |= static_cast<unsigned>(probe(s, g, true, a, b)) << t;
          ++*probes;
        }
      } else {
        pair_of(t - sp, g.nv, &a, &b);
        eqv |= static_cast<unsigned>(probe(s, g, false, a, b)) << (t - sp);
        ++*probes;
      }
    }
  }
  for (int o = split >> 1; o > 0; o >>= 1) {
    eqs |= __shfl_xor_sync(kFull, eqs, o);
    eqv |= __shfl_xor_sync(kFull, eqv, o);
  }
  uint64_t key = on ? orbit_min(s, g, cs, sub, split, eqs, eqv, scanned)
                    : ~0ull;
  for (int o = split >> 1; o > 0; o >>= 1) {
    const uint64_t other = __shfl_xor_sync(kFull, key, o);
    key = other < key ? other : key;
  }
  return key;
}

struct Outputs {
  int* svecs;
  uint8_t *valid, *ovf;
  int *fp_hi, *fp_lo;
  uint8_t *inv, *con;
};

// The orbit-scan variants, bits of the launch's `variant`
// (ops/pallas_step.VARIANTS): the full scan is 0.
constexpr int kPrescan = 1, kSigPrune = 2;
// The prescan's table of the block's raw keys: open addressing, a short
// linear probe; a pair that finds no slot scans its own orbit.
constexpr int kPrescanSlots = 256, kPrescanProbe = 8;
// The prescan's shared memory in ints: the table, and a key, a list entry
// and a table slot per thread.
constexpr int kPrescanInts = 4 * kPrescanSlots + 4 * kThreads;
// Counters of `stats` (optional, for measurement): valid pairs, pairs
// whose orbit scan the prescan skipped, group elements keyed, probes run.
constexpr int kStats = 4;

// Shared memory of one block: the prescan table (when on), rows, slots,
// the lane table, the pair queue, the valid flags, then the group table's
// bytes.
__host__ __device__ constexpr size_t smem_bytes(int R, int A, int n_group,
                                                int variant) {
  return (variant & kPrescan ? kPrescanInts * sizeof(int) : 0) +
         static_cast<size_t>(R + kThreads) * kWp * 4 +
         static_cast<size_t>(A) * 5 * 4 + static_cast<size_t>(R) * A * 3 +
         static_cast<size_t>(n_group);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    step_kernel(const int* __restrict__ vecs, int B, int lgR,
                const int* __restrict__ table, int A, const Consts cs,
                const int8_t* __restrict__ groupg, int P, int Q, int nv,
                const int16_t* __restrict__ rmaps, int view,
                const int* __restrict__ inv_codes, int n_inv,
                const int* __restrict__ prog, Limits lim, int variant,
                unsigned long long* stats, Outputs out) {
  extern __shared__ int sm[];
  __shared__ int n_queued;
  __shared__ unsigned counts[kStats];
  __shared__ int n_reps[2];
  const int R = 1 << lgR;
  const bool prescan = variant & kPrescan, sigprune = variant & kSigPrune;
  // the prescan's table (keys, then values), the round's keys and the
  // representatives' list and table slots
  uint64_t* ptab = reinterpret_cast<uint64_t*>(sm);
  uint64_t* rkey = ptab + 2 * kPrescanSlots;       // kThreads
  int* reps = reinterpret_cast<int*>(rkey + kThreads);  // kThreads
  int* rslot = reps + kThreads;                    // kThreads
  int* rows = sm + (prescan ? kPrescanInts : 0);   // R x kWp
  int* slots = rows + R * kWp;                     // kThreads x kWp
  int* lanes = slots + kThreads * kWp;             // A x 5
  uint16_t* queue = reinterpret_cast<uint16_t*>(lanes + A * 5);  // R*A
  uint8_t* vflags = reinterpret_cast<uint8_t*>(queue + R * A);   // R*A
  int8_t* group = reinterpret_cast<int8_t*>(vflags + R * A);
  const int n_group = P * 2 * N + Q * nv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int nrows = B - row0 < R ? static_cast<int>(B - row0) : R;

  for (int r = warp; r < nrows; r += kThreads / 32)
    for (int w = lane; w < W; w += 32)
      rows[r * kWp + w] = vecs[(row0 + r) * W + w];
  for (int t = tid; t < A * 5; t += kThreads) lanes[t] = table[t];
  for (int t = tid; t < n_group; t += kThreads) group[t] = groupg[t];
  if (prescan)
    for (int t = tid; t < kPrescanSlots; t += kThreads) ptab[t] = ~0ull;
  if (tid < kStats) counts[tid] = 0;
  if (tid < 2) n_reps[tid] = 0;
  if (tid == 0) n_queued = 0;
  __syncthreads();

  // Phase 1: guards, pair p = a * R + r; at R = 32 a warp is one lane.
  const int pairs = R * A;
  for (int p0 = 0; p0 < pairs; p0 += kThreads) {
    const int p = p0 + tid, a = p >> lgR, r = p & (R - 1);
    bool ok = false;
    if (p < pairs && r < nrows) {
      const int* act = lanes + a * 5;
      bool o;
      ok = apply<false>(*reinterpret_cast<St*>(rows + r * kWp), act[0],
                        act[1], act[2], act[3], act[4], &o);
      vflags[r * A + a] = ok;
    }
    const unsigned m = __ballot_sync(kFull, ok);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&n_queued, __popc(m));
    base = __shfl_sync(kFull, base, 0);
    if (ok) queue[base + __popc(m & ((1u << lane) - 1u))] = p;
  }
  __syncthreads();
  for (int t = tid; t < nrows * A; t += kThreads)
    out.valid[row0 * A + t] = vflags[t];

  // Phase 2: finish the queued pairs, `split` threads to a pair.  With the
  // prescan, a round is kThreads pairs, one a thread, and its orbit scans
  // run after it in a compacted pass over the round's representatives,
  // `split` threads to each by their count.
  const int nq = n_queued;
  int split = 1;
  while (!prescan && split < 32 && 2 * split <= P && 2 * split * nq <= kThreads)
    split *= 2;
  const int sub = tid & (split - 1);
  const int owner = tid - sub;  // the slot of the pair's first thread
  St& s = *reinterpret_cast<St*>(slots + owner * kWp);
  const Group g{group, group + P * 2 * N, rmaps, P, Q, nv, view};
  int scanned = 0, skipped = 0, probes = 0;
  for (int q0 = 0, round = 0; q0 < nq; q0 += kThreads / split, ++round) {
    const int k = q0 + tid / split;
    const bool active = k < nq;
    long long lane_g = 0;
    if (active) {
      const int p = queue[k], a = p >> lgR, r = p & (R - 1);
      lane_g = (row0 + r) * A + a;
      if (sub == 0) {
        int* sw = slots + owner * kWp;
        const int* prow = rows + r * kWp;
#pragma unroll 4
        for (int w = 0; w < W; ++w) sw[w] = prow[w];
#if RT_E > 0
        // allLogs' = allLogs \cup {log[i] : i \in Server}, parent's logs.
        int alllogs[WA];
#pragma unroll
        for (int w = 0; w < WA; ++w) alllogs[w] = s.alllogs[w];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int rk = log_rank(s, i);
#pragma unroll
          for (int w = 0; w < WA; ++w)
            if (w == rk >> 5) alllogs[w] |= shl(1, rk & 31);
        }
#endif
        const int* act = lanes + a * 5;
        bool ovf;
        apply<true>(s, act[0], act[1], act[2], act[3], act[4], &ovf);
        out.ovf[lane_g] = ovf;
#if RT_E > 0
#pragma unroll
        for (int w = 0; w < WA; ++w) s.alllogs[w] = alllogs[w];
#endif
        canonicalize(s);
      }
    }
    __syncwarp();
    uint64_t key;
    if (prescan) {
      // The pair claims its raw key in the block's table: the first
      // claimant (this round or an earlier one) is the representative,
      // the others take its key.  The round's representatives are
      // compacted into a list and scanned together.
      int slot = -1;
      bool member = false;
      if (active) {
        const uint64_t raw = raw_key(s, cs);
        int h = static_cast<int>(raw) & (kPrescanSlots - 1);
        for (int t = 0; raw != ~0ull && t < kPrescanProbe; ++t) {
          const unsigned long long old =
              atomicCAS(reinterpret_cast<unsigned long long*>(ptab + h),
                        ~0ull, static_cast<unsigned long long>(raw));
          if (old == ~0ull || old == raw) {
            slot = h;
            member = old == raw;
            break;
          }
          h = (h + 1) & (kPrescanSlots - 1);
        }
        skipped += member;
      }
      const bool rep = active && !member;
      rslot[tid] = slot;
      const unsigned m = __ballot_sync(kFull, rep);
      int base = 0;
      if (lane == 0 && m) base = atomicAdd(&n_reps[round & 1], __popc(m));
      base = __shfl_sync(kFull, base, 0);
      if (rep) reps[base + __popc(m & ((1u << lane) - 1u))] = tid;
      __syncthreads();
      const int nr = n_reps[round & 1];
      if (tid == 0) n_reps[(round + 1) & 1] = 0;
      int sp2 = 1;
      while (sp2 < 32 && 2 * sp2 <= P && 2 * sp2 * nr <= kThreads) sp2 *= 2;
      const int sub2 = tid & (sp2 - 1);
      for (int j0 = 0; j0 < nr; j0 += kThreads / sp2) {
        const int j = j0 + tid / sp2;
        const int o = j < nr ? reps[j] : tid;
        const uint64_t rk = scan_pair(
            *reinterpret_cast<const St*>(slots + o * kWp), g, cs, j < nr,
            sigprune, sub2, sp2, &scanned, &probes);
        if (j < nr && sub2 == 0) {
          rkey[o] = rk;
          if (rslot[o] >= 0) ptab[kPrescanSlots + rslot[o]] = rk;
        }
      }
      __syncthreads();
      key = !active ? ~0ull : member ? ptab[kPrescanSlots + slot] : rkey[tid];
    } else {
      key = scan_pair(s, g, cs, active, sigprune, sub, split, &scanned,
                      &probes);
    }
    const bool lead = active && sub == 0;
    if (lead) {
      out.fp_hi[lane_g] = static_cast<int>(key >> 32);
      out.fp_lo[lane_g] = static_cast<int>(key & 0xFFFFFFFFu);
      for (int c = 0; c < n_inv; ++c) {
        const int code = __ldg(inv_codes + c);
        out.inv[lane_g * n_inv + c] =
            code >= 0 ? invariant(s, code)
                      : run_expr(reinterpret_cast<const int*>(&s),
                                 prog - code - 1);
      }
      out.con[lane_g] = constraint_ok(s, lim);
    }
    // Phase 3: the warp writes its staged successors, word-coalesced.
    unsigned m = __ballot_sync(kFull, lead);
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      const long long dst = __shfl_sync(kFull, lane_g, j);
      const int* src = slots + (warp * 32 + j) * kWp;
      int* o = out.svecs + dst * W;
      if constexpr (W % 4 == 0) {
        for (int c = lane; c < W / 4; c += 32)
          reinterpret_cast<int4*>(o)[c] =
              make_int4(src[4 * c], src[4 * c + 1], src[4 * c + 2],
                        src[4 * c + 3]);
      } else {
        for (int w = lane; w < W; w += 32) o[w] = src[w];
      }
    }
    __syncwarp();
  }
  if (stats) {
    if (scanned) atomicAdd(&counts[2], static_cast<unsigned>(scanned));
    if (skipped) atomicAdd(&counts[1], static_cast<unsigned>(skipped));
    if (probes) atomicAdd(&counts[3], static_cast<unsigned>(probes));
    __syncthreads();
    if (tid == 0) {
      atomicAdd(stats, static_cast<unsigned long long>(nq));
      for (int c = 1; c < kStats; ++c)
        atomicAdd(stats + c, static_cast<unsigned long long>(counts[c]));
    }
  }
}

// Rows per block: 32, halved while the grid would have fewer than 256
// blocks, so a small launch still spreads over the card.
int rows_log2(int B) {
  int lg = 5;
  while (lg > 0 && (B + (1 << lg) - 1) >> lg < 256) --lg;
  return lg;
}

// -- the orbit key of given rows ---------------------------------------------
//
// Replaces: raft_tla_tpu/ops/symmetry.py:557 `build_orbit_fp` — XLA code,
// not a Pallas kernel: the dedup key of the IR-compiled Raft step under
// SYMMETRY or a VIEW (ops/orbit_key.py; its plain version is the port's
// ops/symmetry.build_orbit_fp after the view).  K1's dedup-key stage on
// rows it did not compute: each row is a canonical successor, unviewed,
// and its key is K1's, min over g of fp(canonicalize(g(view(s)))), by the
// same `scan_pair` (full scan).  A group of `split` threads owns a row
// (split a power of two, at most 32 and at most P), each scanning every
// split-th server permutation; the block's rows are copied into shared
// memory with the group table beside them.  A first launch
// (orbit_list_kernel) keys the invalid rows 0 and lists the valid ones,
// so the scan's blocks hold valid rows alone: no group idles on an
// invalid row while its warp scans.
__global__ void __launch_bounds__(kThreads)
    orbit_list_kernel(const uint8_t* __restrict__ valid, long long n,
                      int* __restrict__ list, int* __restrict__ count,
                      int* __restrict__ out_hi, int* __restrict__ out_lo) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool v = i < n && valid[i];
  if (i < n && !v) {
    out_hi[i] = 0;
    out_lo[i] = 0;
  }
  const unsigned m = __ballot_sync(kFull, v);
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(kFull, base, 0);
  if (v) list[base + __popc(m & ((1u << lane) - 1u))] = static_cast<int>(i);
}

// `list`, `count`: the valid rows' indices and their number, from
// orbit_list_kernel.
__global__ void __launch_bounds__(kThreads)
    orbit_key_kernel(const int* __restrict__ rows,
                     const int* __restrict__ list,
                     const int* __restrict__ count, int lg_split,
                     const Consts cs, const int8_t* __restrict__ groupg,
                     int P, int Q, int nv, const int16_t* __restrict__ rmaps,
                     int view, int* __restrict__ out_hi,
                     int* __restrict__ out_lo) {
  extern __shared__ int sm[];
  const int split = 1 << lg_split, per = kThreads >> lg_split;
  const int total = *count;
  const int row0 = blockIdx.x * per;
  if (row0 >= total) return;             // past the valid rows: the block
  int* slots = sm;                                       // per x kWp
  int8_t* group = reinterpret_cast<int8_t*>(slots + per * kWp);
  const int n_group = P * 2 * N + Q * nv;
  const int tid = threadIdx.x;
  const int nrows = total - row0 < per ? total - row0 : per;
  for (int t = tid; t < nrows * W; t += kThreads)
    slots[(t / W) * kWp + t % W] =
        rows[static_cast<long long>(list[row0 + t / W]) * W + t % W];
  for (int t = tid; t < n_group; t += kThreads) group[t] = groupg[t];
  __syncthreads();
  const int r = tid >> lg_split, sub = tid & (split - 1);
  const bool on = r < nrows;
  const Group g{group, group + P * 2 * N, rmaps, P, Q, nv, view};
  int scanned = 0, probes = 0;
  const uint64_t key =
      scan_pair(*reinterpret_cast<const St*>(slots + r * kWp), g, cs, on,
                false, sub, split, &scanned, &probes);
  if (on && sub == 0) {
    const int o = list[row0 + r];
    out_hi[o] = static_cast<int>(key >> 32);
    out_lo[o] = static_cast<int>(key & 0xFFFFFFFFu);
  }
}

}  // namespace

extern "C" int rt_step_width() { return W; }

// Blocks of the kernel one multiprocessor holds at once for a launch of B
// rows with A lanes, the group table's n_group bytes and the orbit-scan
// `variant`, and the shared memory each takes.
extern "C" int rt_step_occupancy(int B, int A, int n_group, int variant,
                                 int* blocks, int* smem) {
  const size_t bytes = smem_bytes(1 << rows_log2(B), A, n_group, variant);
  cudaError_t err = cudaFuncSetAttribute(
      step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = static_cast<int>(bytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, step_kernel, kThreads, bytes));
}

// `c1`, `c2`: the W fingerprint constants, in host memory.  `group`: P rows
// of (p[N], inv[N]) then Q rows of q[nv], int8, on the device
// (ops/symmetry.kernel_tables); nv = 0 when Value symmetry is off (then
// Q = 1 and no value row is read).  `rmaps`: in a faithful layout with
// nv > 0, Q rows of U int16 rank maps on the device
// (ops/symmetry.kernel_rank_maps); otherwise unused and may be null.
// `inv_codes`: the n_inv invariant codes, and `prog`: the expression
// programs, int32 on the device (ops/predprog.kernel_tables).  `variant`:
// the orbit-scan variant bits (kPrescan, kSigPrune; 0 the full scan), the
// same keys by construction.  `stats`: null, or kStats counters on the
// device that the launch adds to.  `svecs` must be 16-byte aligned.
extern "C" int rt_step_launch(const int* vecs, int B, const int* table, int A,
                              const uint32_t* c1, const uint32_t* c2,
                              const int8_t* group, int P, int Q, int nv,
                              const int16_t* rmaps, int view,
                              const int* inv_codes, int n_inv,
                              const int* prog,
                              int max_term, int max_log, int max_msgs,
                              int max_dup, int variant,
                              unsigned long long* stats, int* svecs,
                              uint8_t* valid, uint8_t* ovf, int* fp_hi,
                              int* fp_lo, uint8_t* inv_ok, uint8_t* con_ok,
                              void* stream) {
  if (n_inv < 0 || (n_inv > 0 && (inv_codes == nullptr || prog == nullptr)) ||
      A < 1 || A > kMaxLanes || P < 1 || Q < 1 || nv < 0 || nv > kMaxValues ||
      (nv == 0 && Q != 1) || variant < 0 ||
      variant > (kPrescan | kSigPrune) ||
      reinterpret_cast<uintptr_t>(svecs) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#if RT_E > 0
  if (nv > 0 && rmaps == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#endif
  if (B <= 0) return 0;
  const Limits lim{max_term, max_log, max_msgs, max_dup};
  Consts cs;
  for (int w = 0; w < W; ++w) {
    cs.c1[w] = c1[w];
    cs.c2[w] = c2[w];
  }
  const int lgR = rows_log2(B);
  const unsigned blocks =
      static_cast<unsigned>((B + (1 << lgR) - 1) >> lgR);
  const size_t smem = smem_bytes(1 << lgR, A, P * 2 * N + Q * nv, variant);
  const cudaError_t err = cudaFuncSetAttribute(
      step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Outputs out{svecs, valid, ovf, fp_hi, fp_lo, inv_ok, con_ok};
  step_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      vecs, B, lgR, table, A, cs, group, P, Q, nv, rmaps, view, inv_codes,
      n_inv, prog, lim, variant, stats, out);
  return static_cast<int>(cudaGetLastError());
}

// The orbit key of n given rows (orbit_key_kernel): `rows` int32 [n, W] on
// the device, canonical successors, unviewed; `valid`: n flags on the
// device (a row flagged 0 is skipped and keyed 0); `work`: n + 1 ints on
// the device for the valid rows' list and count; `c1`, `c2`,
// `group`, P, Q, nv, `rmaps` and `view` as for rt_step_launch.  Writes the
// keys' hi and lo words as int32 bit patterns.
extern "C" int rt_orbit_key_launch(const int* rows, const uint8_t* valid,
                                   int* work, long long n,
                                   const uint32_t* c1, const uint32_t* c2,
                                   const int8_t* group, int P, int Q, int nv,
                                   const int16_t* rmaps, int view, int* hi,
                                   int* lo, void* stream) {
  if (n < 0 || n > INT_MAX || P < 1 || Q < 1 || nv < 0 || nv > kMaxValues ||
      (nv == 0 && Q != 1) || valid == nullptr || work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
#if RT_E > 0
  if (nv > 0 && rmaps == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#endif
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Consts cs;
  for (int w = 0; w < W; ++w) {
    cs.c1[w] = c1[w];
    cs.c2[w] = c2[w];
  }
  int* list = work;
  int* count = work + n;
  cudaError_t err = static_cast<cudaError_t>(
      cudaMemsetAsync(count, 0, sizeof(int), st));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned lblocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  orbit_list_kernel<<<lblocks, kThreads, 0, st>>>(valid, n, list, count, hi,
                                                  lo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int lg_split = 0;
  while (lg_split < 5 && (2 << lg_split) <= P) ++lg_split;
  const int per = kThreads >> lg_split;
  const unsigned blocks = static_cast<unsigned>((n + per - 1) / per);
  const size_t smem = static_cast<size_t>(per) * kWp * 4 + P * 2 * N + Q * nv;
  err = cudaFuncSetAttribute(orbit_key_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  orbit_key_kernel<<<blocks, kThreads, smem, st>>>(
      rows, list, count, lg_split, cs, group, P, Q, nv, rmaps, view, hi, lo);
  return static_cast<int>(cudaGetLastError());
}
