// Conflict detection & resolution tiles, hand-written for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of bluesky_tpu, all with one split
// walker (items_kernel) and one row merge (merge_kernel, C entry
// cd_merge_items):
//   * ops/cd_sched.py::_sched_kernel   <- cd_sched_tiles on the blocks of
//                                         each row's segments
//   * ops/cd_pallas.py::_kernel_resume <- cd_sched_tiles on the reachable
//                                         blocks of the overflow rows (the
//                                         sparse overflow fallback)
//   * ops/cd_pallas.py::_kernel        <- cd_full_grid on the reachable
//                                         blocks, no partner table (the
//                                         pallas backend)
//   * ops/cd_pallas.py::_kernel_cand   <- cd_cand_items on the sub-chunks
//                                         of each row's candidate table
// cd_sched_tiles and cd_full_grid also come in the mesh forms of the
// shard modes (ROADMAP B3, the compile-time flag MESH): the ownship rows
// are the local row blocks of an own-row slab array, local row i being
// global row row0 + i * rstride (the row subset of a shard: rstride D in
// the replicate row split), and the intruder tiles are local blocks of
// the column slab array, local block j being global block col0 + j (the
// halo window of a spatial stripe), or gid[j] with a table (the present
// set of a tile, ranked by global block id: _sched_kernel's gid_mode).
// Slab reads keep the local indices; the pair exclusion, the partner ids
// and the old-partner test use the global ones.  The row merge needs no
// mesh form: the partials already hold global ids and it works on local
// rows.
// All run one per-pair body (cd_pallas._tile_pairs: factored haversine,
// CPA, horizontal/vertical entry and exit times, conflict and LoS flags,
// the resolver's displacement sums and a running top-K of partner
// candidates, K the partner-table width, any K >= 1).  The resolver is
// the compile-time parameter RESO:
//   * RESO_MVP: the MVP displacement of each conflict pair outside NORESO
//     (cr_mvp.pair_contrib_trig) and its vertical solve time;
//   * RESO_EBY: the Eby displacement of each conflict pair
//     (cr_eby.pair_contrib) on the TAS velocities tr*u, tr*v (the tr slab
//     row holds tas/gs), no NORESO mask, tsolv left at BIG;
//   * RESO_SWARM: the MVP sums, and on every visited pair (not only the
//     conflict pairs) the Swarm neighbour test (cr_swarm.pair_weight:
//     within 7.5 nm and 1500 ft, track within 90 deg) adding w, w*cas,
//     w*vs, w*dtrk, w*dx, w*dy and w*alt (the tr row holds the CAS) to
//     seven more per-ownship sums.  They live in dynamic shared memory,
//     one bank per thread, touched only by a neighbour pair (through the
//     non-inlined swarm_add), so the walk keeps its 64 registers without
//     spills; the CTA then needs 52 KB (opted in), and four still fit on
//     an SM.  The candidate pass has no Swarm form.
// With the compile-time flag RESUME (the first two) the body also
// evaluates the resume keep predicate, offers only kept conflict pairs as
// candidates, and the row ends with the partner merge
// (cd_pallas._merge_partners_block); without it (the last two) every
// conflict pair is a candidate and only the accumulators and the top-K
// are stored.
//
// Design.  One thread per ownship, a CTA of B <= 256 threads per work
// item of an ownship row block.  For each tile of its item the CTA stages
// B intruder columns of the [16, B] f32 slab layout in shared memory
// (16 KB at B=256) and every thread walks the B intruders in ascending id.
// Masked pairs (inactive, self) are skipped instead of being pushed out of
// range with +1e9.
//
// * Work items.  A Morton row block of the 100k continental fleet reaches
//   41 tiles on average but up to 171; the overflow rows of a dense clump
//   and the rows that fit a candidate table are few and long.  With one
//   CTA per row the longest row set the time and most SMs sat empty.  So
//   each row's tiles, in ascending order, are cut into at most C items of
//   ceil(r / C) tiles (cd_pallas.work_items; C = 8 cuts the 171-tile row
//   into 22-tile items, below the ~31 tiles per resident CTA slot of the
//   whole grid).  The grid is fixed, nb * C CTAs, and an empty item exits
//   at once: the host knows every size without reading device data, and
//   nothing needs a device counter.  Rows are launched longest items
//   first, so the long items do not start in the last wave.  The segment
//   walker takes the same cut over its row's segment blocks instead of one
//   item per segment: a row's items are then equal to within one tile.
//   Where a row's tiles are the set columns of a mask (the reachable
//   blocks, the candidate sub-chunks that hold an id), cd_mask_items
//   builds the items in one call: a block scan per row, then the launch
//   order by rank.
// * Tile source (IDS).  A tile is an intruder block jb, staged from the
//   slabs, or, for the candidate pass, the jb-th sub-chunk of B entries of
//   the row's candidate table: the B slab columns are read straight from
//   the packed slabs through the ids (stage_ids), and each intruder's id
//   is the staged one instead of jb*B + lane; the sentinel id nb*B is
//   staged as an inactive column.  Ids ascend within a row, and an item
//   visits its sub-chunks in ascending order, so the walk offers ids in
//   ascending order there too.  An overflow row's table is all sentinel:
//   it has no sub-chunk and all its items are empty.
// * Deterministic row merge (cd_merge_items).  Each item writes its 8
//   accumulators (15 with the Swarm sums), its top-K (tin, id) and, with
//   RESUME, its keep bits to
//   scratch; a second kernel, one thread per ownship, folds a row's items
//   in ascending item order (sums and counts add, tcpamax max, tsolv min,
//   inconf and keep bits or, top-K merged by (tin, id)) and, with RESUME,
//   runs the partner merge.  No float atomics: one input gives one output,
//   bit for bit, from launch to launch.  A walk visits ids in ascending
//   order, so its strict-'<' insert and the (tin, id) order of the merge
//   are the same order: the Pallas tie order (smallest tin first, ties to
//   the smaller id).
// * Registers.  A pair walk keeps in registers only the ownship column and
//   the 8 accumulators; the top-K list, the old partners, the keep bits
//   and the ownship's gse, gsn and trk live in shared memory, one bank per
//   thread (Side), and are touched only by a conflict pair or an old
//   partner.  The keep predicate runs only for those pairs (its result is
//   read nowhere else), and the old-partner test is a per-tile mask of the
//   partners inside the staged block.
// * Partner width K.  Side holds (3K + 4) words a thread, in dynamic shared
//   memory sized by the launch: 28 KB at K = 8 and B = 256, 52 KB at 16,
//   100 KB at 32, past the 48 KB of static shared memory.  K = 8, the
//   default of every path, is compiled as a constant (KT = 8: Side's rows
//   at the fixed stride MAXB, every address a constant offset, the loops
//   over K unrolled) under __launch_bounds__(256, 4): 64 registers, 4 CTAs
//   (32 warps) an SM, 44 KB of shared memory each (45 KB with the staged
//   ids).  Every other K up to KWORD = 32 takes the run-time form (KT = 0:
//   K and the stride B read from the arguments) under
//   __launch_bounds__(256, 3), 80 registers; shared memory then allows 3
//   CTAs an SM at K = 16 and 1 at K = 32.  Up to K = 32 the keep bits of
//   an ownship's old partners are one 32-bit word.
// * Wide partner tables (K > 32: the wide form, KT = KT_WIDE).  In the
//   layout above Side would pass the 227 KB a CTA may hold from about
//   K = 67 at B = 256, and the keep bits would take more than one word.
//   Of the two ways out, keeping the top-K list and the old partners in
//   global memory, or splitting a row block's ownships over several CTAs
//   so that each one's Side fits, this form takes the first: it leaves no
//   limit on K but device memory, and keeps one CTA per work item, so no
//   tile is staged twice.  The cost falls where the walk is rare: a
//   conflict pair inserts into its item's own rows of the partials pct
//   and pci ([K, G, B], which the merge reads anyway; the row merge uses
//   its outputs ctin and cidx as the list), and the old partners are read
//   where the caller passed them (pold [nb, K, B]), K coalesced loads a
//   tile to build the tile's old-partner mask (up to the thread's last
//   old partner).  Side then holds only KW = ceil(K / 32) keep words, KW
//   words of that mask, two counts (the old partners' extent and the
//   list's length, so an insert moves only the entries it passes) and
//   gse, gsn and trk: (2 KW + 5) words a thread, 9 KB at K = 64 and
//   B = 256.  The
//   walker's keep partials are [G, KW, B] (KW = 1: the [G, B] of the
//   narrower forms).  The tie order is the same: a list in global memory
//   takes the same inserts.  Built under __launch_bounds__(256, 3).
//
// Bound on the card: the pair math.  Each visited tile costs B*B pairs of
// 168 f32 operations (the keep predicate adds 26 on the conflict and
// old-partner pairs only; chip_smoke.py has the hand counts) against
// 16*B*4 bytes of slab, so the kernels sit far above the memory roofline
// and are bounded by the f32 rate.  The body is scalar f32 with sqrt,
// rsqrt and IEEE divisions under a fixed rounding contract, so the tensor
// cores do not apply; built with --fmad=false, the body issues no fused
// multiply-add, so half of the f32 peak is the most it can reach.  Where
// the split walkers lose the rest is not measured (no instruction-level
// profiler runs on the card); the serial per-pair chain of sqrt, rsqrt
// and divisions at 32 warps per SM is the first suspect.  The merge
// moves (8 + 2*K + 1) words per ownship and item, and is bounded by
// bytes.
//
// Plain C interface (built with nvcc, loaded with ctypes); every entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 16;        // slab rows (cd_pallas._FIELDS)
constexpr int MAXB = 256;     // max block width
constexpr int K8 = 8;         // the default partner-table width K
constexpr int KWORD = 32;     // widest K of one keep word (KT = 8 and 0)
constexpr int KT_WIDE = -1;   // the form of K > KWORD (KW keep words)
constexpr float BIG = 1e9f;
constexpr int BIG_I = 1 << 30;
constexpr int NACC = 8;       // accumulators of every form
constexpr int NSW = 7;        // Swarm neighbour sums (cd_pallas.N_SWARM)

// resolver forms, cd_pallas.RESO_CODE
enum { RESO_MVP = 0, RESO_EBY = 1, RESO_SWARM = 2 };

// slab row order, cd_pallas._FIELDS
enum {
  F_LAT = 0, F_LON, F_SL, F_CL, F_RLOC, F_ABSLAT, F_U, F_V, F_ALT, F_VS,
  F_GSE, F_GSN, F_TRK, F_TR, F_ACTIVE, F_NORESO
};

constexpr float RAD = (float)(3.14159265358979323846 / 180.0);
constexpr float A_WGS = 6378137.0f;
constexpr float AA = (float)(6378137.0 * 6378137.0);
constexpr float B_WGS = (float)6356752.314245;
constexpr float BB = (float)(6356752.314245 * 6356752.314245);
constexpr float REARTH = 6371000.0f;
constexpr float INV360 = (float)(1.0 / 360.0);
constexpr float C1 = (float)(1.0 / 6.0);
constexpr float C2 = (float)(3.0 / 40.0);
constexpr float C3 = (float)(15.0 / 336.0);
constexpr float C4 = (float)(105.0 / 3456.0);
// cr_swarm.R_SWARM squared and DH_SWARM, rounded to f32 as the plain
// version's comparisons round them
constexpr float R2_SWARM = (float)((7.5 * 1852.0) * (7.5 * 1852.0));
constexpr float DH_SWARM = (float)(1500.0 * 0.3048);

struct Params {
  int kk;                           // partner-table width K
  float rpz, r2, hpz, tlook;        // detection
  float rpz_m, hpz_m, tlook_m;      // MVP (margin-scaled zone)
  float rpz_resume;                 // resume-nav radius rpz * resofach
  double eby_s, eby_s10;            // Eby: 1 / rpz_m and 10 m in that unit
};

// Final outputs, [.., nb, .., B] as cd_pallas.alloc_outputs lays them out.
struct Outs {
  float* acc;     // [8, NT]: inconf tcpamax sdve sdvn sdvv tsolv ncnt lcnt
                  // (then the NSW Swarm sums: [15, NT])
  float* ctin;    // [nb, K, B]
  int* cidx;      // [nb, K, B]
  float* keep;    // [nb, K, B]
  int* merged;    // [nb, K, B]
  float* active;  // [NT]
};

// Partials of the work items, item g = row * C + k of G = nb * C.
struct Parts {
  float* acc;      // [8, G, B] ([15, G, B] with the Swarm sums)
  float* ct;       // [K, G, B]
  int* ci;         // [K, G, B]
  unsigned* keep;  // [G, B] keep bits (RESUME)
};

// The mesh form of a walk (MESH): own-row slabs and the local -> global
// maps of rows and column blocks.
struct Mesh {
  const float* own;   // [nb, NF, B] own-row slabs (local rows)
  int row0, rstride;  // local row i is global row row0 + i * rstride
  int col0;           // local column block j is global block col0 + j,
  const int* gid;     // or gid[j] when the table is given
};

// The hot per-ownship state of a walk, in registers.
struct Acc {
  float inconf, tcpamax, sdve, sdvn, sdvv, tsolv, ncnt, lcnt;
};

// The rare-path per-ownship state, in dynamic shared memory at base:
// rows [k][thread] of stride S, so the threads of a warp touch 32
// different banks.  In order: ct [K][S] the top-K entry times, ascending;
// ci [K][S] their intruder ids; pold [K][S] the old partners (RESUME); keep
// [S] the keep bits of the old partners (RESUME); gse, gsn, trk [S] the
// ownship fields of the rare paths.  KT > 0 fixes K = KT and S = MAXB at
// compile time; KT = 0 takes K = kr and S = sr (the launch's B).
// KT = KT_WIDE (K = kr > KWORD, S = sr): ct and ci in global memory, entry
// (k, t) at gct[k * gs + t] and gci[k * gs + t]; the old partners read in
// place, gpold[k * S + t]; in shared memory keep [KW][S], the old-partner
// mask of the staged tile pm [KW][S] (bit b of word w: partner 32 w + b),
// kn [S] one past the last old partner (pold[kn..K) are all -1, so the
// per-tile mask reads no further), kc [S] the entries the top-K list
// holds (an insert then shifts only those, not all K), then gse, gsn,
// trk [S].
template <int KT>
struct Side {
  static constexpr bool WIDE = KT < 0;
  float* base;
  int kr, sr;
  float* gct = nullptr;   // the wide form's global rows
  int* gci = nullptr;
  size_t gs = 0;
  int* gpold = nullptr;
  __device__ __forceinline__ int K() const { return KT > 0 ? KT : kr; }
  __device__ __forceinline__ int S() const { return KT > 0 ? MAXB : sr; }
  // keep words a thread
  __device__ __forceinline__ int KW() const {
    return WIDE ? (kr + KWORD - 1) / KWORD : 1;
  }
  __device__ __forceinline__ float& ct(int k, int t) const {
    if constexpr (WIDE) return gct[k * gs + t];
    return base[k * S() + t];
  }
  __device__ __forceinline__ int& ci(int k, int t) const {
    if constexpr (WIDE) return gci[k * gs + t];
    return reinterpret_cast<int*>(base)[(K() + k) * S() + t];
  }
  __device__ __forceinline__ int& pold(int k, int t) const {
    if constexpr (WIDE) return gpold[k * S() + t];
    return reinterpret_cast<int*>(base)[(2 * K() + k) * S() + t];
  }
  // keep word w (always word 0 outside the wide form)
  __device__ __forceinline__ unsigned& keep(int t, int w = 0) const {
    if constexpr (WIDE) return reinterpret_cast<unsigned*>(base)[w * S() + t];
    return reinterpret_cast<unsigned*>(base)[3 * K() * S() + t];
  }
  __device__ __forceinline__ unsigned& pm(int w, int t) const {
    return reinterpret_cast<unsigned*>(base)[(KW() + w) * S() + t];
  }
  __device__ __forceinline__ int& kn(int t) const {
    return reinterpret_cast<int*>(base)[2 * KW() * S() + t];
  }
  __device__ __forceinline__ int& kc(int t) const {
    return reinterpret_cast<int*>(base)[(2 * KW() + 1) * S() + t];
  }
  // the first row past the top-K list, old partners and keep words (and
  // the wide form's mask words and counts)
  __device__ __forceinline__ int rows() const {
    return WIDE ? 2 * KW() + 2 : 3 * K() + 1;
  }
  __device__ __forceinline__ float& gse(int t) const {
    return base[rows() * S() + t];
  }
  __device__ __forceinline__ float& gsn(int t) const {
    return base[(rows() + 1) * S() + t];
  }
  __device__ __forceinline__ float& trk(int t) const {
    return base[(rows() + 2) * S() + t];
  }
  // the first word past Side: the Swarm sums start there
  __device__ __forceinline__ float* end() const {
    return base + (rows() + 3) * S();
  }
};

// Side at dynamic shared memory dsm, width kk, stride S; in the wide form
// with its global rows: the top-K list at ct and ci, row stride gs, and
// the old partners at pold.
template <int KT>
__device__ __forceinline__ Side<KT> side_at(float* dsm, int kk, int S,
                                            float* ct, int* ci, size_t gs,
                                            const int* pold) {
  Side<KT> sd{dsm, kk, S};
  if constexpr (Side<KT>::WIDE) {
    sd.gct = ct;
    sd.gci = ci;
    sd.gs = gs;
    sd.gpold = const_cast<int*>(pold);
  }
  return sd;
}

// Bytes of Side at width kk and stride S (cd_pallas.cta_shared_bytes).
constexpr size_t side_bytes(int kk, int S) {
  return (size_t)(kk > KWORD ? 2 * ((kk + KWORD - 1) / KWORD) + 5
                             : 3 * kk + 4) * S * sizeof(float);
}

// The reference divides by 6, 20 and 42; compiled, it multiplies by the
// f32 reciprocals, and so does the plain PyTorch version.
constexpr float INV6 = 1.0f / 6.0f;
constexpr float INV20 = 1.0f / 20.0f;
constexpr float INV42 = 1.0f / 42.0f;

__device__ __forceinline__ float sin_poly(float x) {
  const float x2 = x * x;
  return x * (1.0f - x2 * INV6 * (1.0f - x2 * INV20 * (1.0f - x2 * INV42)));
}

__device__ __forceinline__ float asin_taylor(float s) {
  float s2 = s * s;
  return s * (1.0f + s2 * (C1 + s2 * (C2 + s2 * (C3 + s2 * C4))));
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// cr_eby.pair_contrib of one conflict pair: the relative position
// (dx, dy, dz) and TAS-based relative velocity (vx, vy, vz), evaluated in
// units of the zone radius (s = 1 / rpz_m, s10 = 10 m in that unit), in
// the reference's order of operations, in double precision as the plain
// version computes it: on a near-grazing pair the quadratic's b*b and 4ac
// agree to 1e-6 and float arithmetic would lose the displacement.  Only
// conflict pairs reach it.  Writes the displacement, rounded to float.
__device__ __forceinline__ void eby_pair(float fdx, float fdy, float fdz,
                                         float fvx, float fvy, float fvz,
                                         double s, double s10, float& ox,
                                         float& oy, float& oz) {
  const double eps = 1e-12;
  const double dx = fdx * s, dy = fdy * s, dz = fdz * s;
  const double vx = fvx * s, vy = fvy * s, vz = fvz * s;
  const double d2 = dx * dx + dy * dy + dz * dz;
  const double v2 = vx * vx + vy * vy + vz * vz;
  const double dv = dx * vx + dy * vy + dz * vz;
  // the quadratic for tstar (Eby.py:104-117), zone radius 1
  const double a = v2 - dv * dv;
  const double b = 2.0 * dv * (1.0 - d2);
  const double c = d2 - d2 * d2;
  const double disc = fmax(b * b - 4.0 * a * c, 0.0);
  const double a_safe = fabs(a) < eps ? eps : a;
  const double sq = sqrt(disc);
  const double time1 = (-b + sq) / (2.0 * a_safe);
  const double time2 = (-b - sq) / (2.0 * a_safe);
  const double tstar = fmin(fabs(time1), fabs(time2));
  // relative position at tstar; within 10 m, pushed sideways to 10 m
  double dsx = dx + vx * tstar, dsy = dy + vy * tstar;
  const double dsz = dz + vz * tstar;
  double dstar = sqrt(dsx * dsx + dsy * dsy + dsz * dsz);
  const double dif = s10 - dstar;
  const double vperp = sqrt(vy * vy + vx * vx);
  const double vp_safe = vperp < eps ? eps : vperp;
  if (dif > 0.0) {
    dsx = dsx + dif * (-vy) / vp_safe;
    dsy = dsy + dif * vx / vp_safe;
  }
  dstar = sqrt(dsx * dsx + dsy * dsy + dsz * dsz);
  // intrusion and displacement, back in metres
  const double intr = 1.0 - dstar;
  double denom = dstar * tstar;
  if (fabs(denom) < eps) denom = eps;
  const double scale = intr / (denom * s);
  ox = (float)(scale * dsx);
  oy = (float)(scale * dsy);
  oz = (float)(scale * dsz);
}

// cr_swarm.wrap_track: (x + 180) mod 360 - 180 with the floored modulo of
// torch.remainder and jnp.remainder (fmod, then + 360 where it is below 0).
__device__ __forceinline__ float wrap_track(float x) {
  float m = fmodf(x + 180.0f, 360.0f);
  if (m != 0.0f && m < 0.0f) m += 360.0f;
  return m - 180.0f;
}

// The rest of cr_swarm.pair_weight for a pair within 7.5 nm and 1500 ft
// (the track difference d, wrapped, within 90 deg) and its seven sums.
// Not inlined: only such pairs call it, and inlined its temporaries made
// the resume walker spill.
__device__ __noinline__ void swarm_add(float* sw, int B, int tt, float d,
                                       float cas, float vs, float dx,
                                       float dy, float alt) {
  const float dtrk = wrap_track(d);
  if (fabsf(dtrk) < 90.0f) {
    sw[0 * B + tt] += 1.0f;
    sw[1 * B + tt] += cas;
    sw[2 * B + tt] += vs;
    sw[3 * B + tt] += dtrk;
    sw[4 * B + tt] += dx;
    sw[5 * B + tt] += dy;
    sw[6 * B + tt] += alt;
  }
}

__device__ __forceinline__ Acc acc_init() {
  Acc a;
  a.inconf = a.tcpamax = a.sdve = a.sdvn = a.sdvv = 0.0f;
  a.tsolv = BIG;
  a.ncnt = a.lcnt = 0.0f;
  return a;
}

// (tin, id) before (ct, ci) in lexicographic order.  A walk offers ids in
// ascending order, so there it is the strict '<' on tin alone.
__device__ __forceinline__ bool before(float tin, int id, float ct, int ci) {
  return tin < ct || (tin == ct && id < ci);
}

// Insert (tin, id) into thread t's top-K list; false if it stays out.
// The wide form starts at the list's end, kc entries in (the empty slots
// past it are (BIG, BIG_I)), so an insert moves only the entries it
// passes.
template <int KT>
__device__ bool insert_cand(const Side<KT>& sd, int t, float tin, int id) {
  const int kk = sd.K();
  int j = kk - 1;
  if constexpr (Side<KT>::WIDE) {
    const int n = sd.kc(t);
    if (!before(tin, id, n < kk ? BIG : sd.ct(j, t),
                n < kk ? BIG_I : sd.ci(j, t)))
      return false;
    if (n < kk) {
      j = n;
      sd.kc(t) = n + 1;
    }
  } else {
    if (!before(tin, id, sd.ct(kk - 1, t), sd.ci(kk - 1, t))) return false;
  }
  for (; j > 0 && before(tin, id, sd.ct(j - 1, t), sd.ci(j - 1, t)); --j) {
    sd.ct(j, t) = sd.ct(j - 1, t);
    sd.ci(j, t) = sd.ci(j - 1, t);
  }
  sd.ct(j, t) = tin;
  sd.ci(j, t) = id;
  return true;
}

// The ownship column: in registers o, but for the three fields only the
// MVP tail and the keep predicate read, which go to shared memory.
template <int KT>
__device__ __forceinline__ void own_begin(float* o, const Side<KT>& sd,
                                          const float* packed, int i, int B,
                                          int t) {
#pragma unroll
  for (int f = 0; f < NF; ++f) o[f] = packed[((size_t)i * NF + f) * B + t];
  sd.gse(t) = o[F_GSE];
  sd.gsn(t) = o[F_GSN];
  sd.trk(t) = o[F_TRK];
}

template <bool RESUME, int KT>
__device__ __forceinline__ void side_begin(const Side<KT>& sd,
                                           const int* pold, int i, int B,
                                           int t) {
  const int kk = sd.K();
  int kn = 0;
#pragma unroll
  for (int k = 0; k < kk; ++k) {
    sd.ct(k, t) = BIG;
    sd.ci(k, t) = BIG_I;
    if constexpr (!Side<KT>::WIDE)   // the wide form reads pold in place
      sd.pold(k, t) = RESUME ? pold[((size_t)i * kk + k) * B + t] : -1;
    else if (RESUME && sd.pold(k, t) >= 0)
      kn = k + 1;
  }
  for (int w = 0; w < sd.KW(); ++w) sd.keep(t, w) = 0u;
  if constexpr (Side<KT>::WIDE) {
    sd.kn(t) = kn;
    sd.kc(t) = 0;
  }
}

// Bits k of the old partners pold[k] inside intruder block jb.  The wide
// form writes them to its KW mask words pm and returns their or.
template <bool RESUME, int KT>
__device__ __forceinline__ unsigned old_mask(const Side<KT>& sd, int t,
                                             int jb, int B) {
  unsigned m = 0u;
  if constexpr (RESUME) {
    const int lo = jb * B;
    const int kk = sd.K();
    if constexpr (Side<KT>::WIDE) {
      const int kn = sd.kn(t);
      for (int w = 0; w < sd.KW(); ++w) {
        unsigned mw = 0u;
        for (int b = 0; b < KWORD && w * KWORD + b < kn; ++b) {
          const int q = sd.pold(w * KWORD + b, t);
          if (q >= lo && q < lo + B) mw |= 1u << b;
        }
        sd.pm(w, t) = mw;
        m |= mw;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kk; ++k) {
        const int q = sd.pold(k, t);
        if (q >= lo && q < lo + B) m |= 1u << k;
      }
    }
  }
  return m;
}

// The wide form's old-partner test of intruder gid against the staged
// tile's mask words: without set, whether it is an old partner; with set,
// its keep bits are set too.  Not inlined: only a tile that holds an old
// partner calls it.
template <int KT>
__device__ __noinline__ bool old_hits(const Side<KT>& sd, int t, int gid,
                                      bool set) {
  bool any = false;
  for (int w = 0; w < sd.KW(); ++w)
    for (unsigned m = sd.pm(w, t); m; m &= m - 1u) {
      const int b = __ffs(m) - 1;
      if (sd.pold(w * KWORD + b, t) != gid) continue;
      if (!set) return true;
      sd.keep(t, w) |= 1u << b;
      any = true;
    }
  return any;
}

// One ownship (column o, slot id gid) against one staged intruder slab
// (cd_pallas._tile_pairs; with RESUME, the resume keep predicate too).
// The intruder ids are the staged ids sid with IDS, else those of block
// jb, jb*B + lane.  pmask: old_mask of this block.  sw: the Swarm sums,
// [NSW][B] in shared memory (RESO_SWARM).
template <bool RESUME, bool IDS, int RESO, int KT>
__device__ __forceinline__ void tile_pairs(float (*s)[MAXB], const int* sid,
                                           int jb, int B, const float* o,
                                           int gid, unsigned pmask, Acc& a,
                                           const Side<KT>& sd, int tt,
                                           const Params& P, float* sw) {
  for (int t = 0; t < B; ++t) {
    const int gid_i = IDS ? sid[t] : jb * B + t;
    if (!(s[F_ACTIVE][t] > 0.5f) || gid_i == gid) continue;
    const float lat_i = s[F_LAT][t], lon_i = s[F_LON][t];
    const float sl_i = s[F_SL][t], cl_i = s[F_CL][t];

    // --- geometry: cd_tiled.tile_geometry (general branch) ---
    const float cos_sum = o[F_CL] * cl_i - o[F_SL] * sl_i;
    const float sin_sum = o[F_SL] * cl_i + o[F_CL] * sl_i;
    const float an = AA * cos_sum, bn = BB * sin_sum;
    const float ad = A_WGS * cos_sum, bd = B_WGS * sin_sum;
    const float res1 = sqrtf(an * an + bn * bn) * rsqrtf(ad * ad + bd * bd);
    const float denom = o[F_ABSLAT] + s[F_ABSLAT][t]
                        + (o[F_LAT] == 0.0f ? 1e-6f : 0.0f);
    const float res2 = 0.5f * (o[F_ABSLAT] * (o[F_RLOC] + A_WGS)
                               + s[F_ABSLAT][t] * (s[F_RLOC][t] + A_WGS))
                       / denom;
    const float rr = (o[F_LAT] * lat_i < 0.0f) ? res2 : res1;
    const float dlat = (lat_i - o[F_LAT]) * RAD;
    const float dlon_deg = lon_i - o[F_LON];
    const float dlon = (dlon_deg - 360.0f * rintf(dlon_deg * INV360)) * RAD;
    const float sh_lat = sin_poly(0.5f * dlat);
    const float sh_lon = sin_poly(0.5f * dlon);
    float root = sh_lat * sh_lat + o[F_CL] * cl_i * sh_lon * sh_lon;
    root = clampf(root, 0.0f, 1.0f);
    const float dist = 2.0f * rr * asin_taylor(sqrtf(root));
    const float qy = sin_poly(dlon) * cl_i;
    const float qx = sin_poly(dlat) + o[F_SL] * cl_i * (2.0f * sh_lon * sh_lon);
    const float rh = rsqrtf(fmaxf(qx * qx + qy * qy, 1e-37f));
    const float sinq = qy * rh, cosq = qx * rh;

    // --- CPA and entry/exit times ---
    const float dx = dist * sinq, dy = dist * cosq;
    const float du = s[F_U][t] - o[F_U];
    const float dv = s[F_V][t] - o[F_V];
    float dv2 = du * du + dv * dv;
    if (fabsf(dv2) < 1e-6f) dv2 = 1e-6f;
    const float rvrel = rsqrtf(dv2);
    const float tcpa = -(du * dx + dv * dy) * (rvrel * rvrel);
    const float dcpa2 = dist * dist - tcpa * tcpa * dv2;
    const bool swhor = dcpa2 < P.r2;
    const float dtinhor = sqrtf(fmaxf(0.0f, P.r2 - dcpa2)) * rvrel;
    const float tinhor = swhor ? tcpa - dtinhor : 1e8f;
    const float touthor = swhor ? tcpa + dtinhor : -1e8f;
    const float dalt = s[F_ALT][t] - o[F_ALT];
    const float vrel_v = s[F_VS][t] - o[F_VS];
    const float dvs = (fabsf(vrel_v) < 1e-6f) ? 1e-6f : vrel_v;
    const float nrdvs = -1.0f / dvs;
    const float tcrosshi = (dalt + P.hpz) * nrdvs;
    const float tcrosslo = (dalt - P.hpz) * nrdvs;
    const float tinconf = fmaxf(fminf(tcrosshi, tcrosslo), tinhor);
    const float toutconf = fminf(fmaxf(tcrosshi, tcrosslo), touthor);
    const bool swconfl = swhor && (tinconf <= toutconf) && (toutconf > 0.0f)
                         && (tinconf < P.tlook);
    const bool swlos = (dist < P.rpz) && (fabsf(dalt) < P.hpz);

    if (swlos) a.lcnt += 1.0f;
    if constexpr (RESO == RESO_SWARM) {
      // --- Swarm neighbour sums: cr_swarm.pair_weight ---
      if (dx * dx + dy * dy < R2_SWARM && fabsf(dalt) < DH_SWARM)
        swarm_add(sw, B, tt, s[F_TRK][t] - sd.trk(tt), s[F_TR][t],
                  s[F_VS][t], dx, dy, s[F_ALT][t]);
    }
    if (swconfl) {
      a.inconf = 1.0f;
      a.tcpamax = fmaxf(a.tcpamax, tcpa);
      a.ncnt += 1.0f;
      if constexpr (RESO == RESO_EBY) {
        // --- Eby pair contribution: cr_eby.pair_contrib ---
        float dve, dvn, dvv;
        eby_pair(dx, dy, dalt, s[F_TR][t] * s[F_U][t] - o[F_TR] * o[F_U],
                 s[F_TR][t] * s[F_V][t] - o[F_TR] * o[F_V], vrel_v, P.eby_s,
                 P.eby_s10, dve, dvn, dvv);
        a.sdve += dve;
        a.sdvn += dvn;
        a.sdvv += dvv;
      } else if (!(s[F_NORESO][t] > 0.5f)) {
        // --- MVP pair contribution: cr_mvp.pair_contrib_trig ---
        const float vrel_e = s[F_GSE][t] - sd.gse(tt);
        const float vrel_n = s[F_GSN][t] - sd.gsn(tt);
        const float drel_e = sinq * dist, drel_n = cosq * dist;
        float dcpa_e = drel_e + vrel_e * tcpa;
        float dcpa_n = drel_n + vrel_n * tcpa;
        float dabsh = sqrtf(dcpa_e * dcpa_e + dcpa_n * dcpa_n);
        const float ih = P.rpz_m - dabsh;
        const float safe_dist = fmaxf(dist, 1e-9f);
        if (dabsh <= 10.0f) {
          dcpa_e = drel_n / safe_dist * 10.0f;
          dcpa_n = -drel_e / safe_dist * 10.0f;
          dabsh = 10.0f;
        }
        const float abstcpa = fmaxf(fabsf(tcpa), 1e-9f);
        float dve = (ih * dcpa_e) / (abstcpa * dabsh);
        float dvn = (ih * dcpa_n) / (abstcpa * dabsh);
        const bool apply_err = (P.rpz_m < dist) && (dabsh < dist);
        const float ratio1 = clampf(P.rpz_m / safe_dist, -1.0f, 1.0f);
        const float ratio2 = clampf(dabsh / safe_dist, -1.0f, 1.0f);
        float err = sqrtf(fmaxf(0.0f, 1.0f - ratio1 * ratio1))
                    * sqrtf(fmaxf(0.0f, 1.0f - ratio2 * ratio2))
                    + ratio1 * ratio2;
        if (!apply_err) err = 1.0f;
        if (fabsf(err) < 1e-9f) err = 1e-9f;
        dve = dve / err;
        dvn = dvn / err;
        const bool has_dvs = fabsf(vrel_v) > 0.0f;
        float iv = has_dvs ? P.hpz_m : P.hpz_m - fabsf(dalt);
        float tsolv = has_dvs ? fabsf(dalt / vrel_v) : tinconf;
        if (tsolv > P.tlook_m) {
          tsolv = tinconf;
          iv = P.hpz_m;
        }
        const float tsafe = (fabsf(tsolv) < 1e-9f) ? 1e-9f : tsolv;
        const float dvv = has_dvs
            ? (iv / tsafe) * (vrel_v > 0.0f ? -1.0f : 1.0f)
            : iv / tsafe;
        a.sdve += dve;
        a.sdvn += dvn;
        a.sdvv += dvv;
        a.tsolv = fminf(a.tsolv, tsolv);
      }
    }

    if constexpr (!RESUME) {
      if (swconfl) insert_cand(sd, tt, tinconf, gid_i);
      continue;
    }
    // The old partners this intruder is; the keep predicate is read only
    // for them and for a conflict pair.
    unsigned hit = 0u;
    if constexpr (Side<KT>::WIDE) {
      hit = pmask && old_hits(sd, tt, gid_i, false);
    } else {
      for (unsigned m = pmask; m; m &= m - 1u) {
        const int k = __ffs(m) - 1;
        if (sd.pold(k, tt) == gid_i) hit |= 1u << k;
      }
    }
    if (!swconfl && !hit) continue;
    // --- resume-nav keep predicate: cr_mvp.resume_keep_core ---
    const float vrel_e = s[F_GSE][t] - sd.gse(tt);
    const float vrel_n = s[F_GSN][t] - sd.gsn(tt);
    const float cos_half = sqrtf(fmaxf(0.5f + 0.5f * cos_sum, 0.0f));
    const float dist_e = REARTH * ((lon_i - o[F_LON]) * RAD) * cos_half;
    const float dist_n = REARTH * ((lat_i - o[F_LAT]) * RAD);
    const bool past_cpa = dist_e * vrel_e + dist_n * vrel_n > 0.0f;
    const float hdist = sqrtf(dist_e * dist_e + dist_n * dist_n);
    const bool keep = !past_cpa || (hdist < P.rpz)
        || ((fabsf(sd.trk(tt) - s[F_TRK][t]) < 30.0f)
            && (hdist < P.rpz_resume));
    if (keep) {
      if constexpr (Side<KT>::WIDE) {
        if (hit) old_hits(sd, tt, gid_i, true);
      } else {
        sd.keep(tt) |= hit;
      }
      if (swconfl) insert_cand(sd, tt, tinconf, gid_i);
    }
  }
}

__device__ __forceinline__ void stage(float (*s)[MAXB], const float* packed,
                                      int jb, int B, int t) {
  __syncthreads();
#pragma unroll
  for (int f = 0; f < NF; ++f) s[f][t] = packed[((size_t)jb * NF + f) * B + t];
  __syncthreads();
}

// Stage B candidate aircraft by id, read through the ids from the packed
// slabs; the sentinel n (= nb*B) becomes an all-zero, inactive column.
__device__ __forceinline__ void stage_ids(float (*s)[MAXB], int* sid,
                                          const float* packed,
                                          const int* ids, int n, int B,
                                          int t) {
  __syncthreads();
  const int id = ids[t];
  const bool real = id >= 0 && id < n;
  const size_t base = real ? ((size_t)(id / B) * NF) * B + id % B : 0;
#pragma unroll
  for (int f = 0; f < NF; ++f) s[f][t] = real ? packed[base + (size_t)f * B] : 0.0f;
  sid[t] = id;
  __syncthreads();
}

// The final stores of one ownship: the 8 accumulators, the Swarm sums sw
// (RESO_SWARM) and the top-K; with RESUME also the keep bits and
// cd_pallas._merge_partners_block (fresh candidates in urgency order,
// then the kept old partners in slot order that are not fresh ones, the
// first K) and the engagement flag.
template <bool RESUME, int RESO, int KT>
__device__ void finish_row(const Acc& a, const float* sw,
                           const Side<KT>& sd, const Outs& out, int i, int B,
                           int t, size_t nt) {
  const size_t g = (size_t)i * B + t;
  out.acc[0 * nt + g] = a.inconf;
  out.acc[1 * nt + g] = a.tcpamax;
  out.acc[2 * nt + g] = a.sdve;
  out.acc[3 * nt + g] = a.sdvn;
  out.acc[4 * nt + g] = a.sdvv;
  out.acc[5 * nt + g] = a.tsolv;
  out.acc[6 * nt + g] = a.ncnt;
  out.acc[7 * nt + g] = a.lcnt;
  if constexpr (RESO == RESO_SWARM) {
#pragma unroll
    for (int k = 0; k < NSW; ++k) out.acc[(NACC + k) * nt + g] = sw[k];
  }
  const int kk = sd.K();
  const size_t e0 = (size_t)i * kk * B + t;
  if constexpr (!Side<KT>::WIDE) {   // the wide form's list is ctin, cidx
#pragma unroll
    for (int k = 0; k < kk; ++k) {
      out.ctin[e0 + (size_t)k * B] = sd.ct(k, t);
      out.cidx[e0 + (size_t)k * B] = sd.ci(k, t);
    }
  }
  if constexpr (RESUME) {
    const unsigned keep = sd.keep(t);
    // keep bit k: of the one word, or of word k / 32 in the wide form
    auto kept = [&](int k) -> unsigned {
      if constexpr (Side<KT>::WIDE)
        return (sd.keep(t, k / KWORD) >> (k % KWORD)) & 1u;
      return (keep >> k) & 1u;
    };
    int n = 0;
    for (int k = 0; k < kk; ++k) {
      out.keep[e0 + (size_t)k * B] = (float)kept(k);
      if (sd.ct(k, t) < BIG) out.merged[e0 + (size_t)(n++) * B] = sd.ci(k, t);
    }
    for (int k = 0; k < kk && n < kk; ++k) {
      if (!kept(k)) continue;
      const int q = sd.pold(k, t);
      bool dup = false;
      for (int m = 0; m < kk; ++m)
        dup |= sd.ct(m, t) < BIG && sd.ci(m, t) == q;
      if (!dup) out.merged[e0 + (size_t)(n++) * B] = q;
    }
    for (int k = n; k < kk; ++k) out.merged[e0 + (size_t)k * B] = -1;
    out.active[g] = n > 0 ? 1.0f : 0.0f;
  }
}

// The split walker: work item k of row block i walks tiles[i, start :
// start + len] of its row's ascending tile list and stores its partials.
// CTA b takes item b % C of row order[b / C].  A tile is an intruder block
// jb, staged from the slabs (cd_sched_tiles with RESUME, cd_full_grid,
// and cd_sched_tiles on the overflow rows for _kernel_resume), or with
// IDS the jb-th sub-chunk of B entries of the row's candidate table
// cand[i, 0:c_cap], staged through its ids (cd_cand_items).  Dynamic
// shared memory holds Side (side_bytes), then with RESO_SWARM the NSW * B
// floats of its sums.  With MESH the ownship column comes from M.own and
// the ids are lifted to global ones (struct Mesh); without it M is unread.
template <bool RESUME, bool IDS, int RESO, int KT, bool MESH>
__global__ void __launch_bounds__(MAXB, KT > 0 ? 4 : 3)
items_kernel(const float* __restrict__ packed, int B,
             const int* __restrict__ tiles, int W,
             const int* __restrict__ istart, const int* __restrict__ ilen,
             const int* __restrict__ order, int C,
             const int* __restrict__ cand, int c_cap,
             const int* __restrict__ pold, Params P, Parts pt, Mesh M) {
  static_assert(!(RESUME && IDS), "the candidate pass has no partner table");
  static_assert(!(IDS && RESO == RESO_SWARM),
                "the candidate pass has no Swarm form");
  static_assert(!(IDS && MESH), "the candidate pass has no mesh form");
  __shared__ float s[NF][MAXB];
  __shared__ int sid[IDS ? MAXB : 1];
  extern __shared__ float dsm[];   // Side, then [NSW][B] (RESO_SWARM)
  const int i = order[blockIdx.x / C];
  const size_t g = (size_t)i * C + blockIdx.x % C;
  const size_t n = (size_t)gridDim.x * B;
  // the wide form's top-K list: this item's rows of the partials
  const Side<KT> sd = side_at<KT>(
      dsm, P.kk, B, pt.ct + g * B, pt.ci + g * B, n,
      RESUME ? pold + (size_t)i * P.kk * B : nullptr);
  float* sw = sd.end();
  const int len = ilen[g];
  if (len <= 0) return;
  const int t = threadIdx.x;
  float o[NF];
  own_begin(o, sd, MESH ? M.own : packed, i, B, t);
  side_begin<RESUME, KT>(sd, pold, i, B, t);
  const int gid = (MESH ? M.row0 + i * M.rstride : i) * B + t;
  if constexpr (RESO == RESO_SWARM) {
#pragma unroll
    for (int k = 0; k < NSW; ++k) sw[k * B + t] = 0.0f;
  }
  Acc a = acc_init();
  const bool own_act = o[F_ACTIVE] > 0.5f;
  if (__syncthreads_or(own_act)) {
    const int* tl = tiles + (size_t)i * W + istart[g];
    for (int q = 0; q < len; ++q) {
      const int jb = tl[q];
      if constexpr (IDS)
        stage_ids(s, sid, packed, cand + (size_t)i * c_cap + (size_t)jb * B,
                  gridDim.x / C * B, B, t);
      else
        stage(s, packed, jb, B, t);
      // the tile's global block (the slab stays at its local jb)
      const int jg = MESH ? (M.gid ? M.gid[jb] : M.col0 + jb) : jb;
      if (own_act)
        tile_pairs<RESUME, IDS, RESO, KT>(s, sid, jg, B, o, gid,
                                          old_mask<RESUME, KT>(sd, t, jg, B),
                                          a, sd, t, P, sw);
    }
  }
  const size_t e = g * B + t;
  pt.acc[0 * n + e] = a.inconf;
  pt.acc[1 * n + e] = a.tcpamax;
  pt.acc[2 * n + e] = a.sdve;
  pt.acc[3 * n + e] = a.sdvn;
  pt.acc[4 * n + e] = a.sdvv;
  pt.acc[5 * n + e] = a.tsolv;
  pt.acc[6 * n + e] = a.ncnt;
  pt.acc[7 * n + e] = a.lcnt;
  if constexpr (RESO == RESO_SWARM) {
#pragma unroll
    for (int k = 0; k < NSW; ++k) pt.acc[(NACC + k) * n + e] = sw[k * B + t];
  }
  const int kk = sd.K();
  if constexpr (Side<KT>::WIDE) {   // the list is in place; KW keep words
    if constexpr (RESUME)
      for (int w = 0; w < sd.KW(); ++w)
        pt.keep[(g * sd.KW() + w) * B + t] = sd.keep(t, w);
  } else {
#pragma unroll
    for (int k = 0; k < kk; ++k) {
      pt.ct[k * n + e] = sd.ct(k, t);
      pt.ci[k * n + e] = sd.ci(k, t);
    }
    if constexpr (RESUME) pt.keep[e] = sd.keep(t);
  }
}

// cd_merge_items: ownship t of row block i folds the partials of its
// row's non-empty items in ascending item order, then finishes the row.
// Dynamic shared memory holds Side (side_bytes); the wide form's list is
// the row's outputs ctin and cidx.
template <bool RESUME, int RESO, int KT>
__global__ void __launch_bounds__(MAXB)
merge_kernel(int B, int C, int kk, const int* __restrict__ ilen,
             const int* __restrict__ pold, Parts pt, Outs out) {
  extern __shared__ float dsm[];
  const int i = blockIdx.x, t = threadIdx.x;
  const size_t r0 = (size_t)i * kk * B;
  const Side<KT> sd = side_at<KT>(dsm, kk, B, out.ctin + r0, out.cidx + r0,
                                  B, RESUME ? pold + r0 : nullptr);
  side_begin<RESUME, KT>(sd, pold, i, B, t);
  Acc a = acc_init();
  float sw[NSW] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const size_t n = (size_t)gridDim.x * C * B;
  unsigned keep = 0u;
  for (int k = 0; k < C; ++k) {
    const size_t g = (size_t)i * C + k;
    if (ilen[g] <= 0) continue;
    const size_t e = g * B + t;
    a.inconf = fmaxf(a.inconf, pt.acc[0 * n + e]);
    a.tcpamax = fmaxf(a.tcpamax, pt.acc[1 * n + e]);
    a.sdve += pt.acc[2 * n + e];
    a.sdvn += pt.acc[3 * n + e];
    a.sdvv += pt.acc[4 * n + e];
    a.tsolv = fminf(a.tsolv, pt.acc[5 * n + e]);
    a.ncnt += pt.acc[6 * n + e];
    a.lcnt += pt.acc[7 * n + e];
    if constexpr (RESO == RESO_SWARM) {
#pragma unroll
      for (int q = 0; q < NSW; ++q) sw[q] += pt.acc[(NACC + q) * n + e];
    }
    // each item's list ascends, so its first entry that stays out ends it
    for (int m = 0; m < sd.K(); ++m)
      if (!insert_cand(sd, t, pt.ct[m * n + e], pt.ci[m * n + e])) break;
    if constexpr (RESUME) {
      if constexpr (Side<KT>::WIDE) {
        for (int w = 0; w < sd.KW(); ++w)
          sd.keep(t, w) |= pt.keep[(g * sd.KW() + w) * B + t];
      } else {
        keep |= pt.keep[e];
      }
    }
  }
  if constexpr (!Side<KT>::WIDE) sd.keep(t) = keep;
  finish_row<RESUME, RESO, KT>(a, sw, sd, out, i, B, t,
                               (size_t)gridDim.x * B);
}

// cd_mask_items: row i's work items over the columns j with mask[i, j]
// (cd_pallas.mask_items; its plain version is compact_rows + work_items).
// One CTA per row compacts the row by a block-wide scan in chunks of
// blockDim columns, then cuts its count tiles into at most C items of
// ceil(count / C).  A dozen tensor ops did this before, and on the main
// path, where the overflow pass finds no row, their host time was most
// of the pass.
__global__ void __launch_bounds__(MAXB)
mask_items_kernel(const uint8_t* __restrict__ mask, int W, int C,
                  int* __restrict__ tiles, int* __restrict__ istart,
                  int* __restrict__ ilen) {
  __shared__ int sc[MAXB];
  __shared__ int base;
  const int i = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const uint8_t* m = mask + (size_t)i * W;
  int* out = tiles + (size_t)i * W;
  if (t == 0) base = 0;
  for (int j0 = 0; j0 < W; j0 += nt) {
    const int j = j0 + t;
    const bool v = j < W && m[j];
    sc[t] = v;
    __syncthreads();
    for (int d = 1; d < nt; d <<= 1) {   // inclusive scan of sc
      const int add = t >= d ? sc[t - d] : 0;
      __syncthreads();
      sc[t] += add;
      __syncthreads();
    }
    if (v) out[base + sc[t] - 1] = j;
    const int total = sc[nt - 1];
    __syncthreads();
    if (t == 0) base += total;
  }
  __syncthreads();
  const int count = base, size = max((count + C - 1) / C, 1);
  for (int k = t; k < C; k += nt) {
    const size_t g = (size_t)i * C + k;
    istart[g] = k * size;
    ilen[g] = max(min(count - k * size, size), 0);
  }
}

// The launch order of mask_items_kernel's rows: by descending length of
// their first item ilen[i, 0] (ceil(count / C), 0 for an empty row), ties
// in row order, as the stable argsort of work_items; thread i counts the
// rows that go before it.
__global__ void __launch_bounds__(MAXB)
items_order_kernel(const int* __restrict__ ilen, int nb, int C,
                   int* __restrict__ order) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nb) return;
  const int s = ilen[(size_t)i * C];
  int rank = 0;
  for (int j = 0; j < nb; ++j) {
    const int sj = ilen[(size_t)j * C];
    rank += sj > s || (sj == s && j < i);
  }
  order[rank] = i;
}

Params make_params(int kk, float rpz, float r2, float hpz, float tlook,
                   float rpz_m, float hpz_m, float tlook_m, float rpz_resume,
                   double eby_s, double eby_s10) {
  Params p;
  p.kk = kk;
  p.rpz = rpz; p.r2 = r2; p.hpz = hpz; p.tlook = tlook;
  p.rpz_m = rpz_m; p.hpz_m = hpz_m; p.tlook_m = tlook_m;
  p.rpz_resume = rpz_resume;
  p.eby_s = eby_s; p.eby_s10 = eby_s10;
  return p;
}

// Ask for the largest shared-memory carveout (once per kernel, at its
// first launch), so that four 44 KB CTAs (52 KB with the Swarm sums) fit
// on an SM beside the L1 at K = 8, and opt in to the most dynamic shared
// memory any launch of the kernel takes (the Swarm sums and a Side wider
// than K = 8 go past the 48 KB of a default launch).
template <typename K>
void prefer_shared(K* kernel, int dyn) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
  if (dyn > 0)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         dyn);
}

// prefer_shared for a launch of dyn bytes, once per kernel for the forms
// whose largest Side is known at compile time (KT = 8 and 0: max_dyn), at
// each new largest dyn for the wide form, whose Side grows with K.  opted
// is the kernel's own record of what it opted in to.
template <int KT, typename K>
void opt_in(K* kernel, size_t dyn, size_t max_dyn, size_t& opted) {
  const size_t want = KT == KT_WIDE ? dyn : max_dyn;
  if (want > opted) {
    prefer_shared(kernel, (int)want);
    opted = want;
  }
}

template <bool RESUME, bool IDS, int RESO, int KT, bool MESH>
int launch_items(const float* packed, int nb, int B, const int* tiles, int W,
                 const int* istart, const int* ilen, const int* order, int C,
                 const int* cand, int c_cap, const int* pold,
                 const Params& P, const Parts& pt, const Mesh& M,
                 void* stream) {
  constexpr size_t sw_max = RESO == RESO_SWARM ? NSW * MAXB * sizeof(float)
                                               : 0;
  const size_t dyn = side_bytes(P.kk, KT > 0 ? MAXB : B)
      + (RESO == RESO_SWARM ? (size_t)NSW * B * sizeof(float) : 0);
  static size_t opted = 0;
  opt_in<KT>(items_kernel<RESUME, IDS, RESO, KT, MESH>, dyn,
             side_bytes(KT ? KT : KWORD, MAXB) + sw_max, opted);
  items_kernel<RESUME, IDS, RESO, KT, MESH>
      <<<nb * C, B, dyn, (cudaStream_t)stream>>>(
          packed, B, tiles, W, istart, ilen, order, C, cand, c_cap, pold, P,
          pt, M);
  return (int)cudaGetLastError();
}

// launch_items in the form of the width P.kk: the constant K = 8 form,
// the run-time form up to KWORD or the wide form past it.
template <bool RESUME, bool IDS, int RESO, bool MESH>
int launch_kt(const float* packed, int nb, int B, const int* tiles, int W,
              const int* istart, const int* ilen, const int* order, int C,
              const int* cand, int c_cap, const int* pold, const Params& P,
              const Parts& pt, const Mesh& M, void* stream) {
  if (P.kk == K8)
    return launch_items<RESUME, IDS, RESO, K8, MESH>(
        packed, nb, B, tiles, W, istart, ilen, order, C, cand, c_cap, pold,
        P, pt, M, stream);
  if (P.kk <= KWORD)
    return launch_items<RESUME, IDS, RESO, 0, MESH>(
        packed, nb, B, tiles, W, istart, ilen, order, C, cand, c_cap, pold,
        P, pt, M, stream);
  return launch_items<RESUME, IDS, RESO, KT_WIDE, MESH>(
      packed, nb, B, tiles, W, istart, ilen, order, C, cand, c_cap, pold, P,
      pt, M, stream);
}

// launch_kt in the mesh form when M.own is given.
template <bool RESUME, bool IDS, int RESO>
int launch_k(const float* packed, int nb, int B, const int* tiles, int W,
             const int* istart, const int* ilen, const int* order, int C,
             const int* cand, int c_cap, const int* pold, const Params& P,
             const Parts& pt, const Mesh& M, void* stream) {
  if (B <= 0 || B > MAXB || C <= 0 || W <= 0 || (IDS && c_cap < W * B)
      || P.kk < 1 || (IDS && M.own) || (M.own && M.rstride < 1))
    return (int)cudaErrorInvalidValue;
  if (nb <= 0) return 0;
  if constexpr (!IDS) {
    if (M.own)
      return launch_kt<RESUME, IDS, RESO, true>(
          packed, nb, B, tiles, W, istart, ilen, order, C, cand, c_cap, pold,
          P, pt, M, stream);
  }
  return launch_kt<RESUME, IDS, RESO, false>(
      packed, nb, B, tiles, W, istart, ilen, order, C, cand, c_cap, pold, P,
      pt, M, stream);
}

template <bool RESUME, bool IDS>
int launch_reso(int reso, const float* packed, int nb, int B,
                const int* tiles, int W, const int* istart, const int* ilen,
                const int* order, int C, const int* cand, int c_cap,
                const int* pold, const Params& P, const Parts& pt,
                const Mesh& M, void* stream) {
  switch (reso) {
    case RESO_MVP:
      return launch_k<RESUME, IDS, RESO_MVP>(
          packed, nb, B, tiles, W, istart, ilen, order, C, cand, c_cap, pold,
          P, pt, M, stream);
    case RESO_EBY:
      return launch_k<RESUME, IDS, RESO_EBY>(
          packed, nb, B, tiles, W, istart, ilen, order, C, cand, c_cap, pold,
          P, pt, M, stream);
    case RESO_SWARM:
      if constexpr (!IDS)
        return launch_k<RESUME, IDS, RESO_SWARM>(
            packed, nb, B, tiles, W, istart, ilen, order, C, cand, c_cap,
            pold, P, pt, M, stream);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool RESUME, int RESO, int KT>
void launch_merge_k(int nb, int B, int C, int kk, const int* ilen,
                    const int* pold, const Parts& pt, const Outs& o,
                    void* stream) {
  const size_t dyn = side_bytes(kk, KT > 0 ? MAXB : B);
  static size_t opted = 0;
  opt_in<KT>(merge_kernel<RESUME, RESO, KT>, dyn,
             side_bytes(KT ? KT : KWORD, MAXB), opted);
  merge_kernel<RESUME, RESO, KT><<<nb, B, dyn, (cudaStream_t)stream>>>(
      B, C, kk, ilen, pold, pt, o);
}

template <bool RESUME, int RESO>
void launch_merge(int nb, int B, int C, int kk, const int* ilen,
                  const int* pold, const Parts& pt, const Outs& o,
                  void* stream) {
  if (kk == K8)
    launch_merge_k<RESUME, RESO, K8>(nb, B, C, kk, ilen, pold, pt, o, stream);
  else if (kk <= KWORD)
    launch_merge_k<RESUME, RESO, 0>(nb, B, C, kk, ilen, pold, pt, o, stream);
  else
    launch_merge_k<RESUME, RESO, KT_WIDE>(nb, B, C, kk, ilen, pold, pt, o,
                                          stream);
}

template <bool RESUME>
int merge_reso(int reso, int nb, int B, int C, int kk, const int* ilen,
               const int* pold, const Parts& pt, const Outs& o,
               void* stream) {
  switch (reso) {
    case RESO_MVP:
    case RESO_EBY:   // the same accumulators as MVP
      launch_merge<RESUME, RESO_MVP>(nb, B, C, kk, ilen, pold, pt, o, stream);
      return 0;
    case RESO_SWARM:
      launch_merge<RESUME, RESO_SWARM>(nb, B, C, kk, ilen, pold, pt, o,
                                       stream);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The split walkers write the partials of their nb * C work items
// (cd_pallas.work_items: tiles [nb, W], istart and ilen [nb, C], order
// [nb]); cd_merge_items makes the outputs.  B <= 256; the partner tables
// and top-K lists are kk wide, any kk >= 1 (pct and pci [kk, G, B]; pkeep
// [G, ceil(kk / 32), B]).
// reso is the resolver form (RESO_MVP, RESO_EBY,
// RESO_SWARM; pacc holds 8 accumulators a work item, 15 with RESO_SWARM),
// eby_s and eby_s10 the Eby scale (read by RESO_EBY only).
// cd_sched_tiles, with the partner table pold, serves both _sched_kernel
// (the segment blocks) and _kernel_resume (the reachable blocks of the
// overflow rows).  _sched_kernel's no-resume form (rpz_m=None: no
// partner table, no keep bits) is cd_full_grid over the segment blocks
// (cd_sched.window_items).
// cd_sched_tiles and cd_full_grid take the mesh form (struct Mesh) when
// own is given: then nb counts the rows of own (and of pold and the
// items), packed holds the column slabs the tiles index, local row i is
// global row row0 + i * rstride (rstride >= 1), and local tile j global
// block gid[j], or col0 + j when gid is null.  With own null the other
// four are unread (the single-device form: own = packed, identity ids).
int cd_sched_tiles(const float* packed, int nb, int B, const int* tiles,
                   int W, const int* istart, const int* ilen,
                   const int* order, int C, const int* pold, float rpz,
                   float r2, float hpz, float tlook, float rpz_m, float hpz_m,
                   float tlook_m, float rpz_resume, double eby_s,
                   double eby_s10, int reso, int kk, float* pacc,
                   float* pct, int* pci, unsigned* pkeep, const float* own,
                   int row0, int rstride, int col0, const int* gid,
                   void* stream) {
  Params P = make_params(kk, rpz, r2, hpz, tlook, rpz_m, hpz_m, tlook_m,
                         rpz_resume, eby_s, eby_s10);
  return launch_reso<true, false>(reso, packed, nb, B, tiles, W, istart,
                                  ilen, order, C, nullptr, 0, pold, P,
                                  Parts{pacc, pct, pci, pkeep},
                                  Mesh{own, row0, rstride, col0, gid},
                                  stream);
}

// The reach-masked full grid without a partner table (rpz_resume unused).
int cd_full_grid(const float* packed, int nb, int B, const int* tiles, int W,
                 const int* istart, const int* ilen, const int* order, int C,
                 float rpz, float r2, float hpz, float tlook, float rpz_m,
                 float hpz_m, float tlook_m, float rpz_resume, double eby_s,
                 double eby_s10, int reso, int kk, float* pacc, float* pct,
                 int* pci, const float* own, int row0, int rstride, int col0,
                 const int* gid, void* stream) {
  Params P = make_params(kk, rpz, r2, hpz, tlook, rpz_m, hpz_m, tlook_m,
                         rpz_resume, eby_s, eby_s10);
  return launch_reso<false, false>(reso, packed, nb, B, tiles, W, istart,
                                   ilen, order, C, nullptr, 0, nullptr, P,
                                   Parts{pacc, pct, pci, nullptr},
                                   Mesh{own, row0, rstride, col0, gid},
                                   stream);
}

// The candidate pass: a tile is a sub-chunk index of the row's candidate
// table cand [nb, c_cap] (ascending ids, then the sentinel nb * B), W
// sub-chunks of B entries (c_cap >= W * B; rpz_resume unused; no Swarm
// form).
int cd_cand_items(const float* packed, int nb, int B, const int* tiles,
                  int W, const int* istart, const int* ilen,
                  const int* order, int C, const int* cand, int c_cap,
                  float rpz, float r2, float hpz, float tlook, float rpz_m,
                  float hpz_m, float tlook_m, float rpz_resume, double eby_s,
                  double eby_s10, int reso, int kk, float* pacc, float* pct,
                  int* pci, void* stream) {
  Params P = make_params(kk, rpz, r2, hpz, tlook, rpz_m, hpz_m, tlook_m,
                         rpz_resume, eby_s, eby_s10);
  return launch_reso<false, true>(reso, packed, nb, B, tiles, W, istart,
                                  ilen, order, C, cand, c_cap, nullptr, P,
                                  Parts{pacc, pct, pci, nullptr},
                                  Mesh{nullptr, 0, 1, 0, nullptr}, stream);
}

// The work items of a row mask [nb, W] (bool, one byte each): tiles
// [nb, W], istart and ilen [nb, C], order [nb], as cd_pallas.work_items
// cuts them.
int cd_mask_items(const uint8_t* mask, int nb, int W, int C, int* tiles,
                  int* istart, int* ilen, int* order, void* stream) {
  if (W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (nb <= 0) return 0;
  mask_items_kernel<<<nb, MAXB, 0, (cudaStream_t)stream>>>(mask, W, C, tiles,
                                                           istart, ilen);
  items_order_kernel<<<(nb + MAXB - 1) / MAXB, MAXB, 0,
                       (cudaStream_t)stream>>>(ilen, nb, C, order);
  return (int)cudaGetLastError();
}

// The row merge of any walker: with pold (the cd_sched_tiles form) the
// keep bits and the partner merge too, and all six outputs; without it
// only acc, ctin and cidx.  reso is the walker's resolver form: with
// RESO_SWARM pacc and acc hold the 7 Swarm sums after the 8 accumulators.
// kk is the walker's partner width.
int cd_merge_items(int nb, int B, int C, int kk, const int* ilen,
                   const int* pold, const float* pacc, const float* pct,
                   const int* pci, const unsigned* pkeep, float* acc,
                   float* ctin, int* cidx, float* keep, int* merged,
                   float* active, int reso, void* stream) {
  if (B <= 0 || B > MAXB || C <= 0 || kk < 1)
    return (int)cudaErrorInvalidValue;
  if (nb <= 0) return 0;
  Parts pt{const_cast<float*>(pacc), const_cast<float*>(pct),
           const_cast<int*>(pci), const_cast<unsigned*>(pkeep)};
  Outs o{acc, ctin, cidx, keep, merged, active};
  const int rc = pold ? merge_reso<true>(reso, nb, B, C, kk, ilen, pold, pt,
                                         o, stream)
                      : merge_reso<false>(reso, nb, B, C, kk, ilen, nullptr,
                                          pt, o, stream);
  return rc ? rc : (int)cudaGetLastError();
}

}  // extern "C"
