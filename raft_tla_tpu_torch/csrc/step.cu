// K1 — the fused frontier step, hand-written for Hopper.
//
// Replaces: raft_tla_tpu/ops/pallas_step.py `build_step_megakernel`
// (:131; kernel body `kernel` at :175, launch `_call` at :184,
// pl.pallas_call at :194), whole: parity and faithful mode.  The TPU kernel
// stages the XLA step's jaxpr over 128-row blocks so that the [B, A, W]
// candidate block stays in VMEM between stages; this kernel computes the
// same lanes as the plain torch step (ops/kernels.build_step): unpack, the
// action family's guard and effect, the history updates and the allLogs
// union (faithful mode), canonicalize (message-slot sort, election-slot
// sort), pack, the dedup key (VIEW, then the orbit-minimal fingerprint
// under SYMMETRY), invariants, StateConstraint.
//
// Design: one thread per (row, action lane).  A block holds R = 256 / A
// rows; it copies their W words once into shared memory, and each of the A
// threads of a row unpacks the row into a struct, applies its lane's
// family (read from a small per-lane table), and finishes the candidate
// without it ever touching device memory between stages: every output is
// written once.  The layout's sizes (N servers, L log capacity, S message
// slots, and in faithful mode E election slots, WA allLogs words and the
// log universe's T terms and V values, hence W) are compile-time macros;
// build.py compiles one library per layout.  A parity layout has E = 0 and
// compiles none of the history code.  The struct sits in the thread's
// local memory, which stays in L1 (see `rd`/`wr` below for why not in
// registers).
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
// lane, so it is computed once per thread before the action runs.
//
// The dedup key (ops/symmetry.build_orbit_fp, ops/kernels.build_step):
// key = min over g in [0, P*Q) of fp(canonicalize(g(view(s)))), the min
// lexicographic on the unsigned pair (hi, lo); P = n! with Server symmetry
// (else 1), Q = V! with Value symmetry (else 1), g = 0 the identity, so at
// P*Q = 1 without a view the key is the plain fingerprint of the packed
// successor and one code path serves every case.  The permuted state is
// never built: each permuted word is read from the struct at its source
// index and folded into the fingerprint accumulators in place; only the S
// message slots are remapped into registers and re-sorted.  The server
// part of the fold is shared by the Q value permutations of one server
// permutation.  The view (deadvotes: vote sets of non-candidates read as
// 0) is applied as each vote word is read.
//
// Group tables: the kernel takes only the permutations themselves, P rows
// of (p[n], inv[n]) and Q rows of q[V], int8 (ops/symmetry.kernel_tables),
// and derives the reference's other tables in the thread: votedFor
// relabel p[j] + 1, the vote-bitmask permutation (n bit moves), the
// message src/dst relabel and the value relabel q[v - 1] + 1.  The
// reference's stacked tables (inv_idx, vf_map, bit_lut, p_lut, vlut,
// e_lut) take 720 x 93 ints = 268 KB at 6 servers, over the 227 KB of
// shared memory a block may use; the permutations alone take P*2n + Q*V
// bytes (8.7 KB at 6 servers), copied into shared memory by each block.
// All lanes of a block walk g in step, so each table read is a broadcast.
//
// Faithful mode under Value symmetry also needs the Q rank maps
// (rank -> rank of the value-permuted log, ops/symmetry.kernel_rank_maps),
// int16 [Q][U].  They stay in device memory and are read through the
// read-only cache (__ldg), not copied to shared memory: at U = 1,024 and
// V = 5 they take 240 KB, over a block's shared memory, while the flagship
// layout's 2 x 43 entries (172 bytes) stay hot in L1 either way.  Lanes
// read them at data-dependent ranks, so a shared copy would buy no
// broadcast.  Server permutations fix allLogs, eLog, eTerm and mlog (ranks
// hold no server ids); voterLog reorders both axes, occupied election
// slots map eLeader through p and bit-permute eVotes, eVLog reorders its
// columns.  The election slots are remapped into registers and re-sorted
// per group element, like the message slots.
//
// What bounds it on the H100: bytes written at |G| = 1 (each lane writes
// its packed successor, W int32, plus its masks and keys: about
// A * (W + 5) * 4 bytes per input row of W * 4 bytes); integer work at
// large |G| (each lane spends |G| x (about 2W multiply-adds plus the
// relabels and the S-slot sort network)), which passes the bytes at a few
// dozen elements.  Lanes of a warp run different families and diverge;
// that costs issue slots, not bytes.
//
// Contract (held against the plain step): `valid` equal on every lane;
// every other output bit-equal where `valid` is true.  Invalid lanes are
// written as zeros (the engine never reads them).
#include <cuda_runtime.h>

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

constexpr int kMaxInv = 8;
constexpr int kThreads = 256;
constexpr int kMaxValues = 15;   // the 4-bit message value field
constexpr int kViewDeadvotes = 1;  // models/views.KERNEL_CODES

struct InvList {
  int n;
  int code[kMaxInv];
};

struct Limits {
  int max_term, max_log, max_msgs, max_dup;
};

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

// -- struct access at a runtime index ---------------------------------------
//
// A runtime index reads and writes the struct's arrays directly, so the
// compiler keeps the struct in local memory (L1-resident, a few hundred
// bytes a thread).  The first form of this kernel selected with fully
// unrolled compare-and-assign loops to keep the struct in registers; ptxas
// at its default optimization level gave wrong lanes for it on sm_90a
// (right under -Xptxas -O0, -G, and a host emulation of the same source),
// so it was replaced by this form, which is right at the same speed.

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
template <int M>
__device__ __forceinline__ void wr(int (&a)[M], int i, int v) {
  if (i >= 0 && i < M) a[i] = v;
}

template <int M, int K>
__device__ __forceinline__ void wr2(int (&a)[M][K], int i, int j, int v) {
#pragma unroll
  for (int x = 0; x < M; ++x)
#pragma unroll
    for (int y = 0; y < K; ++y)
      if (x == i && y == j) a[x][y] = v;
}

template <int M, int K>
__device__ __forceinline__ void wr_row(int (&a)[M][K], int i, int v) {
#pragma unroll
  for (int x = 0; x < M; ++x)
#pragma unroll
    for (int y = 0; y < K; ++y)
      if (x == i) a[x][y] = v;
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
__device__ __forceinline__ bool bag_add(St& s, int hi, int lo) {
  bool exists = false, has_empty = false;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    exists |= s.mhi[k] == hi && s.mlo[k] == lo && s.mcnt[k] > 0;
    has_empty |= s.mcnt[k] == 0;
  }
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
  return !exists && !has_empty;
}

// WithoutMessage; a no-op when absent.
__device__ __forceinline__ void bag_remove(St& s, int hi, int lo) {
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

// Reply: remove the request, then add the response.
__device__ __forceinline__ bool reply(St& s, int resp_hi, int resp_lo,
                                      int req_hi, int req_lo) {
  bag_remove(s, req_hi, req_lo);
  return bag_add(s, resp_hi, resp_lo);
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
__device__ __forceinline__ bool receive(St& s, int slot, bool* ovf) {
  const int hi = rd(s.mhi, slot), lo = rd(s.mlo, slot);
  const int i = mdst(hi), j = msrc(hi);
  const int mt = mterm(hi), mty = mtype(hi);
  const int ct = rd(s.term, i), role_i = rd(s.role, i);
  const int len_i = rd(s.loglen, i);
  if (mt > ct) {  // UpdateTerm (raft.tla:406-412): message kept
    wr(s.term, i, mt);
    wr(s.role, i, FOLLOWER);
    wr(s.voted, i, 0);
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
    if (grant) wr(s.voted, i, j + 1);
    *ovf = reply(s, pack_hi(M_RVRESP, ct, grant, 0, i, j),
                 pack_lo(0, 0, 0, 0, mlog), hi, lo);
    return true;
  }
  if (mty == M_RVRESP && mt < ct) {  // DropStaleResponse (raft.tla:415-418)
    bag_remove(s, hi, lo);
    return true;
  }
  if (mty == M_RVRESP && mt == ct) {  // HandleRequestVoteResponse (:307-321)
    const int bit = shl(1, j);
    wr(s.vresp, i, rd(s.vresp, i) | bit);
    if (fa(hi) > 0) wr(s.vgrant, i, rd(s.vgrant, i) | bit);
#if RT_E > 0
    // voterLog[i] @@ (j :> m.mlog): the existing entry wins (:316-317)
    if (fa(hi) > 0 && rd2(s.vlog, i, j) == 0) wr2(s.vlog, i, j, fg(lo) + 1);
#endif
    bag_remove(s, hi, lo);
    return true;
  }
  if (mty == M_AEREQ) {  // HandleAppendEntriesRequest (raft.tla:327-389)
    const int prev_idx = fa(hi), prev_term = fb(hi);
    const int n_ent = fc(lo), ent_term = fd(lo), ent_val = fe(lo);
    const bool log_ok =
        prev_idx == 0 || (prev_idx > 0 && prev_idx <= len_i &&
                          prev_term == rd2(s.logterm, i, prev_idx - 1));
    if (mt < ct || (mt == ct && role_i == FOLLOWER && !log_ok)) {  // reject
      *ovf = reply(s, pack_hi(M_AERESP, ct, 0, 0, i, j), 0, hi, lo);
      return true;
    }
    if (mt == ct && role_i == CANDIDATE) {  // step down; message kept
      wr(s.role, i, FOLLOWER);
      return true;
    }
    if (mt == ct && role_i == FOLLOWER && log_ok) {  // accept
      const int index = prev_idx + 1;
      const int t_at = rd2(s.logterm, i, index - 1);
      if (n_ent == 0 || (len_i >= index && t_at == ent_term)) {
        // already done (raft.tla:356-374): commitIndex := mcommitIndex
        wr(s.commit, i, ff(lo));
        *ovf = reply(s, pack_hi(M_AERESP, ct, 1, prev_idx + n_ent, i, j), 0,
                     hi, lo);
        return true;
      }
      if (n_ent > 0 && len_i >= index && t_at != ent_term) {
        // conflict: drop one entry off the tail; message kept
        wr2(s.logterm, i, len_i - 1, 0);
        wr2(s.logval, i, len_i - 1, 0);
        wr(s.loglen, i, len_i - 1);
        return true;
      }
      if (n_ent > 0 && len_i == prev_idx) {  // append (raft.tla:383-388)
        wr2(s.logterm, i, len_i, ent_term);
        wr2(s.logval, i, len_i, ent_val);
        wr(s.loglen, i, len_i + 1);
        *ovf = len_i >= L;
        return true;
      }
    }
    return false;
  }
  if (mty == M_AERESP && mt < ct) {  // DropStaleResponse
    bag_remove(s, hi, lo);
    return true;
  }
  if (mty == M_AERESP && mt == ct) {  // HandleAppendEntriesResponse
    const bool succ = fa(hi) > 0;
    const int match = fb(hi);
    const int ni = rd2(s.next, i, j);
    wr2(s.next, i, j, succ ? match + 1 : max(ni - 1, 1));
    if (succ) wr2(s.match, i, j, match);
    bag_remove(s, hi, lo);
    return true;
  }
  return false;
}

#if RT_E > 0
// BecomeLeader's record into the elections set (raft.tla:237-242), all from
// the unprimed state: the first free slot (eTerm = 0) unless an equal
// record is present.  Returns the overflow flag (no free slot).
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
  return !exists && !has_empty;
}
#endif

// -- the action families (raft.tla:167-276, 421-450) -----------------------

// Applies lane (fam, i, j, v, slot) to s in place; returns `valid` and sets
// *ovf (already masked by valid).
__device__ __forceinline__ bool apply(St& s, int fam, int i, int j, int v,
                                      int slot, bool* ovf) {
  bool valid = false, o = false;
  switch (fam) {
    case RESTART:
      wr(s.role, i, FOLLOWER);
      wr(s.vresp, i, 0);
      wr(s.vgrant, i, 0);
      wr_row(s.next, i, 1);
      wr_row(s.match, i, 0);
      wr(s.commit, i, 0);
#if RT_E > 0
      wr_row(s.vlog, i, 0);  // voterLog[i] := empty map (raft.tla:171)
#endif
      valid = true;
      break;
    case TIMEOUT: {
      const int r = rd(s.role, i), t = rd(s.term, i);
      valid = r == FOLLOWER || r == CANDIDATE;
      wr(s.role, i, CANDIDATE);
      wr(s.term, i, t + 1);
      wr(s.voted, i, 0);
      wr(s.vresp, i, 0);
      wr(s.vgrant, i, 0);
#if RT_E > 0
      wr_row(s.vlog, i, 0);  // voterLog[i] := empty map (raft.tla:186)
#endif
      break;
    }
    case REQUESTVOTE: {
      valid = rd(s.role, i) == CANDIDATE && ((rd(s.vresp, i) >> j) & 1) == 0;
      const int hi =
          pack_hi(M_RVREQ, rd(s.term, i), last_term(s, i), rd(s.loglen, i), i,
                  j);
      o = bag_add(s, hi, 0);
      break;
    }
    case BECOMELEADER: {
      valid = rd(s.role, i) == CANDIDATE &&
              2 * __popc(static_cast<uint32_t>(rd(s.vgrant, i))) > N;
      const int ln = rd(s.loglen, i);
      wr(s.role, i, LEADER);
      wr_row(s.next, i, ln + 1);
      wr_row(s.match, i, 0);
#if RT_E > 0
      o = elections_insert(s, i);
#endif
      break;
    }
    case CLIENTREQUEST: {
      const int ln = rd(s.loglen, i), t = rd(s.term, i);
      valid = rd(s.role, i) == LEADER;
      wr2(s.logterm, i, ln, t);
      wr2(s.logval, i, ln, v);
      wr(s.loglen, i, ln + 1);
      o = ln >= L;
      break;
    }
    case ADVANCECOMMIT: {
      valid = rd(s.role, i) == LEADER;
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
      wr(s.commit, i, commit);
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
      o = bag_add(s, hi, lo);
      break;
    }
    case RECEIVE: {
      const bool occupied = rd(s.mcnt, slot) > 0;
      valid = receive(s, slot, &o) && occupied;
      break;
    }
    case DUPLICATE:
      valid = rd(s.mcnt, slot) > 0;
#pragma unroll
      for (int k = 0; k < S; ++k)
        if (k == slot) s.mcnt[k] += 1;
      break;
    case DROP:
      valid = rd(s.mcnt, slot) > 0;
      bag_remove(s, rd(s.mhi, slot), rd(s.mlo, slot));
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

__device__ __forceinline__ void canonicalize(St& s) {
  sort_bag(s.mhi, s.mlo, s.mcnt);
#if RT_E > 0
  sort_elections(s.eterm, s.eleader, s.elog, s.evotes, s.evlog);
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

// -- unpack / pack -----------------------------------------------------------

__device__ __forceinline__ void unpack(const int* v, St& s) {
#pragma unroll
  for (int a = 0; a < N; ++a) {
    s.role[a] = v[O_ROLE + a];
    s.term[a] = v[O_TERM + a];
    s.voted[a] = v[O_VOTED + a];
    s.commit[a] = v[O_COMMIT + a];
    s.loglen[a] = v[O_LOGLEN + a];
    s.vresp[a] = v[O_VRESP + a];
    s.vgrant[a] = v[O_VGRANT + a];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      s.logterm[a][k] = v[O_LOGTERM + a * L + k];
      s.logval[a][k] = v[O_LOGVAL + a * L + k];
    }
#pragma unroll
    for (int b = 0; b < N; ++b) {
      s.next[a][b] = v[O_NEXT + a * N + b];
      s.match[a][b] = v[O_MATCH + a * N + b];
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    s.mhi[k] = v[O_MHI + k];
    s.mlo[k] = v[O_MLO + k];
    s.mcnt[k] = v[O_MCNT + k];
  }
#if RT_E > 0
#pragma unroll
  for (int w = 0; w < WA; ++w) s.alllogs[w] = v[O_ALLLOGS + w];
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int b = 0; b < N; ++b) s.vlog[a][b] = v[O_VLOG + a * N + b];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    s.eterm[e] = v[O_ETERM + e];
    s.eleader[e] = v[O_ELEADER + e];
    s.elog[e] = v[O_ELOG + e];
    s.evotes[e] = v[O_EVOTES + e];
#pragma unroll
    for (int m = 0; m < N; ++m) s.evlog[e][m] = v[O_EVLOG + e * N + m];
  }
#endif
}

// Writes the packed successor (ops/state.STATE_FIELDS order).
__device__ __forceinline__ void pack(const St& s, int* out) {
#pragma unroll
  for (int a = 0; a < N; ++a) {
    out[O_ROLE + a] = s.role[a];
    out[O_TERM + a] = s.term[a];
    out[O_VOTED + a] = s.voted[a];
    out[O_COMMIT + a] = s.commit[a];
    out[O_LOGLEN + a] = s.loglen[a];
    out[O_VRESP + a] = s.vresp[a];
    out[O_VGRANT + a] = s.vgrant[a];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      out[O_LOGTERM + a * L + k] = s.logterm[a][k];
      out[O_LOGVAL + a * L + k] = s.logval[a][k];
    }
#pragma unroll
    for (int b = 0; b < N; ++b) {
      out[O_NEXT + a * N + b] = s.next[a][b];
      out[O_MATCH + a * N + b] = s.match[a][b];
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    out[O_MHI + k] = s.mhi[k];
    out[O_MLO + k] = s.mlo[k];
    out[O_MCNT + k] = s.mcnt[k];
  }
#if RT_E > 0
#pragma unroll
  for (int w = 0; w < WA; ++w) out[O_ALLLOGS + w] = s.alllogs[w];
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int b = 0; b < N; ++b) out[O_VLOG + a * N + b] = s.vlog[a][b];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    out[O_ETERM + e] = s.eterm[e];
    out[O_ELEADER + e] = s.eleader[e];
    out[O_ELOG + e] = s.elog[e];
    out[O_EVOTES + e] = s.evotes[e];
#pragma unroll
    for (int m = 0; m < N; ++m) out[O_EVLOG + e * N + m] = s.evlog[e][m];
  }
#endif
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

__device__ __forceinline__ void mac(RtFp& acc, const uint32_t* c1,
                                    const uint32_t* c2, int w, int x) {
  rt_fp_mac(acc, x, c1[w], c2[w]);
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

// Folds the history fields of g(s) into acc: server permutation (p, inv)
// then the value permutation's rank map rm (null: identity); the election
// slots are remapped into registers and re-sorted.
__device__ __forceinline__ void history_key(const St& s, const int (&p)[N],
                                            const int (&inv)[N],
                                            const int16_t* rm,
                                            const uint32_t* c1,
                                            const uint32_t* c2, RtFp& acc) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int m = 0; m < N; ++m)
      mac(acc, c1, c2, O_VLOG + k * N + m,
          map_rank1(rm, s.vlog[inv[k]][inv[m]]));
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
          mask[t >> 5] |= shl(1, t & 31);
        }
      }
    }
#pragma unroll
    for (int w = 0; w < WA; ++w) mac(acc, c1, c2, O_ALLLOGS + w, mask[w]);
  } else {
#pragma unroll
    for (int w = 0; w < WA; ++w) mac(acc, c1, c2, O_ALLLOGS + w, s.alllogs[w]);
  }
  int et[E], el[E], eg[E], ev[E], evl[E][N];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool occ = s.eterm[e] > 0;
    et[e] = s.eterm[e];
    const int ld = s.eleader[e] < 0 ? 0 : (s.eleader[e] > 15 ? 15
                                                             : s.eleader[e]);
    el[e] = occ ? (ld < N ? p[ld] : 0) : s.eleader[e];
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
    mac(acc, c1, c2, O_ETERM + e, et[e]);
    mac(acc, c1, c2, O_ELEADER + e, el[e]);
    mac(acc, c1, c2, O_ELOG + e, eg[e]);
    mac(acc, c1, c2, O_EVOTES + e, ev[e]);
#pragma unroll
    for (int m = 0; m < N; ++m) mac(acc, c1, c2, O_EVLOG + e * N + m, evl[e][m]);
  }
}
#endif

__device__ void orbit_key(const St& s, const Group& g, const uint32_t* c1,
                          const uint32_t* c2, int* key_hi, int* key_lo) {
  uint32_t bh = 0u, bl = 0u;
  bool first = true;
#pragma unroll 1
  for (int pi = 0; pi < g.P; ++pi) {
    const int8_t* row = g.perm + pi * 2 * N;
    int p[N], inv[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      p[k] = row[k];
      inv[k] = row[N + k];
    }
    // Everything but logVal and the messages: shared by the Q elements.
    RtFp base{};
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int src = inv[k];
      const int role = s.role[src];
      mac(base, c1, c2, O_ROLE + k, role);
      mac(base, c1, c2, O_TERM + k, s.term[src]);
      const int vf = clampi(s.voted[src], N + 1);
      mac(base, c1, c2, O_VOTED + k, vf == 0 ? 0 : row[vf - 1] + 1);
      mac(base, c1, c2, O_COMMIT + k, s.commit[src]);
      mac(base, c1, c2, O_LOGLEN + k, s.loglen[src]);
#pragma unroll
      for (int l = 0; l < L; ++l)
        mac(base, c1, c2, O_LOGTERM + k * L + l, s.logterm[src][l]);
      const bool dead = g.view == kViewDeadvotes && role != CANDIDATE;
      const int vr = dead ? 0 : s.vresp[src];
      const int vg = dead ? 0 : s.vgrant[src];
      int pr = 0, pg = 0;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        pr |= ((vr >> j) & 1) << p[j];
        pg |= ((vg >> j) & 1) << p[j];
      }
      mac(base, c1, c2, O_VRESP + k, pr);
      mac(base, c1, c2, O_VGRANT + k, pg);
#pragma unroll
      for (int m = 0; m < N; ++m) {
        mac(base, c1, c2, O_NEXT + k * N + m, s.next[src][inv[m]]);
        mac(base, c1, c2, O_MATCH + k * N + m, s.match[src][inv[m]]);
      }
    }
    int phi[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int hi = s.mhi[k];
      const int sx = (hi >> 21) & 15, dx = (hi >> 25) & 15;
      const int ns = sx < N ? row[sx] : 0, nd = dx < N ? row[dx] : 0;
      phi[k] = s.mcnt[k] > 0 ? (hi & kHiKeep) | shl(ns, 21) | shl(nd, 25)
                             : hi;
    }
#pragma unroll 1
    for (int qi = 0; qi < g.Q; ++qi) {
      const int8_t* q = g.vals + qi * g.nv;
      RtFp acc = base;
#pragma unroll
      for (int k = 0; k < N; ++k)
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const int v = s.logval[inv[k]][l];
          mac(acc, c1, c2, O_LOGVAL + k * L + l,
              g.nv ? relabel_value(q, g.nv, v) : v);
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
        mac(acc, c1, c2, O_MHI + k, mh[k]);
        mac(acc, c1, c2, O_MLO + k, ml[k]);
        mac(acc, c1, c2, O_MCNT + k, mc[k]);
      }
#if RT_E > 0
      history_key(s, p, inv, rm, c1, c2, acc);
#endif
      const uint32_t h = rt_fmix32(acc.s1 + RT_LANE_SEED_HI);
      const uint32_t l = rt_fmix32(acc.s2 + RT_LANE_SEED_LO);
      if (first || h < bh || (h == bh && l < bl)) {
        bh = h;
        bl = l;
      }
      first = false;
    }
  }
  *key_hi = static_cast<int>(bh);
  *key_lo = static_cast<int>(bl);
}

__global__ void __launch_bounds__(kThreads)
    step_kernel(const int* __restrict__ vecs, int B, int R,
                const int* __restrict__ table, int A,
                const uint32_t* __restrict__ c1g,
                const uint32_t* __restrict__ c2g,
                const int8_t* __restrict__ groupg, int P, int Q, int nv,
                const int16_t* __restrict__ rmaps, int view, InvList inv,
                Limits lim, int* __restrict__ svecs,
                uint8_t* __restrict__ valid_out, uint8_t* __restrict__ ovf_out,
                int* __restrict__ fp_hi, int* __restrict__ fp_lo,
                uint8_t* __restrict__ inv_out, uint8_t* __restrict__ con_out) {
  // R rows of W words, then c1[W], c2[W], then the group table's bytes.
  extern __shared__ int sm[];
  uint32_t* c1 = reinterpret_cast<uint32_t*>(sm + R * W);
  uint32_t* c2 = c1 + W;
  int8_t* group = reinterpret_cast<int8_t*>(c2 + W);
  const int n_group = P * 2 * N + Q * nv;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int nrows = B - row0 < R ? static_cast<int>(B - row0) : R;
  for (int t = threadIdx.x; t < nrows * W; t += blockDim.x)
    sm[t] = vecs[row0 * W + t];
  for (int t = threadIdx.x; t < W; t += blockDim.x) {
    c1[t] = c1g[t];
    c2[t] = c2g[t];
  }
  for (int t = threadIdx.x; t < n_group; t += blockDim.x) group[t] = groupg[t];
  __syncthreads();
  const int r = threadIdx.x / A, a = threadIdx.x - r * A;
  if (r >= nrows) return;
  const long long lane = (row0 + r) * A + a;
  const int* act = table + a * 5;

  St s;
  unpack(sm + r * W, s);
#if RT_E > 0
  // allLogs' = allLogs \cup {log[i] : i \in Server} with the parent's logs.
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
  bool ovf;
  const bool valid = apply(s, act[0], act[1], act[2], act[3], act[4], &ovf);
  valid_out[lane] = valid;
  ovf_out[lane] = ovf;
  int* out = svecs + lane * W;
  if (!valid) {  // never read by the engine: written as zeros
    for (int w = 0; w < W; ++w) out[w] = 0;
    fp_hi[lane] = 0;
    fp_lo[lane] = 0;
    for (int k = 0; k < inv.n; ++k) inv_out[lane * inv.n + k] = 0;
    con_out[lane] = 0;
    return;
  }
#if RT_E > 0
#pragma unroll
  for (int w = 0; w < WA; ++w) s.alllogs[w] = alllogs[w];
#endif
  canonicalize(s);
  pack(s, out);
  const Group g{group, group + P * 2 * N, rmaps, P, Q, nv, view};
  orbit_key(s, g, c1, c2, fp_hi + lane, fp_lo + lane);
  for (int k = 0; k < inv.n; ++k)
    inv_out[lane * inv.n + k] = invariant(s, inv.code[k]);
  con_out[lane] = constraint_ok(s, lim);
}

}  // namespace

extern "C" int rt_step_width() { return W; }

// `group`: P rows of (p[N], inv[N]) then Q rows of q[nv], int8, on the
// device (ops/symmetry.kernel_tables); nv = 0 when Value symmetry is off
// (then Q = 1 and no value row is read).  `rmaps`: in a faithful layout
// with nv > 0, Q rows of U int16 rank maps on the device
// (ops/symmetry.kernel_rank_maps); otherwise unused and may be null.
extern "C" int rt_step_launch(const int* vecs, int B, const int* table, int A,
                              const uint32_t* c1, const uint32_t* c2,
                              const int8_t* group, int P, int Q, int nv,
                              const int16_t* rmaps, int view,
                              const int* inv_codes, int n_inv,
                              int max_term, int max_log, int max_msgs,
                              int max_dup, int* svecs, uint8_t* valid,
                              uint8_t* ovf, int* fp_hi, int* fp_lo,
                              uint8_t* inv_ok, uint8_t* con_ok, void* stream) {
  if (n_inv < 0 || n_inv > kMaxInv || A < 1 || A > kThreads || P < 1 ||
      Q < 1 || nv < 0 || nv > kMaxValues || (nv == 0 && Q != 1))
    return static_cast<int>(cudaErrorInvalidValue);
#if RT_E > 0
  if (nv > 0 && rmaps == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#endif
  if (B <= 0) return 0;
  InvList inv{};
  inv.n = n_inv;
  for (int k = 0; k < n_inv; ++k) inv.code[k] = inv_codes[k];
  const Limits lim{max_term, max_log, max_msgs, max_dup};
  const int R = kThreads / A;
  const unsigned blocks = static_cast<unsigned>((B + R - 1) / R);
  const size_t smem = static_cast<size_t>(R * W + 2 * W) * 4 +
                      static_cast<size_t>(P * 2 * N + Q * nv);
  const cudaError_t err = cudaFuncSetAttribute(
      step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  step_kernel<<<blocks, R * A, smem, static_cast<cudaStream_t>(stream)>>>(
      vecs, B, R, table, A, c1, c2, group, P, Q, nv, rmaps, view, inv, lim,
      svecs,
      valid, ovf, fp_hi, fp_lo, inv_ok, con_ok);
  return static_cast<int>(cudaGetLastError());
}
