// Conflict detection & MVP resolution tiles, hand-written for Hopper
// (sm_90a).
//
// Replaces the four Pallas TPU kernels of bluesky_tpu:
//   * cd_sched_tiles      <- ops/cd_sched.py::_sched_kernel (segment walker)
//   * cd_full_grid_resume <- ops/cd_pallas.py::_kernel_resume (reach-masked
//                            full-grid walker, the sparse overflow fallback)
//   * cd_full_grid        <- ops/cd_pallas.py::_kernel (the same walker
//                            without a partner table: the pallas backend)
//   * cd_cand_tiles       <- ops/cd_pallas.py::_kernel_cand (ownship block
//                            against its candidate aircraft)
// All run one per-pair body (cd_pallas._tile_pairs: factored haversine,
// CPA, horizontal/vertical entry and exit times, conflict and LoS flags,
// MVP displacement sums and a running top-KK of partner candidates).
// With the compile-time flag RESUME (the first two) the body also
// evaluates the resume keep predicate, offers only kept conflict pairs as
// candidates, and the row ends with the partner merge
// (cd_pallas._merge_partners_block); without it (the last two) every
// conflict pair is a candidate and only the accumulators and the top-KK
// are stored.
//
// Design (correct first, not yet fast): one CTA per ownship row block of
// B <= 256 slots, one thread per ownship.  For each intruder block the
// CTA stages the [16, B] f32 slab in shared memory (16 KB at B=256) and
// every thread walks the B intruders in ascending id, keeping its
// accumulators, its top-KK (tin, id) list, its KK old partners and their
// keep bits in registers.  Visiting tiles in ascending block order and
// inserting with a strict '<' reproduces the Pallas tie order (smallest
// tin first, ties to the earlier / smaller id).  Masked pairs (inactive,
// self) are skipped instead of being pushed out of range with +1e9.
//
// The candidate kernel stages, for each sub-chunk of B entries of its row's
// candidate table, the B slab columns straight from the packed slabs
// through the ids (the gather the TPU path materializes as a
// [nb*nsub, 16, B] array) and takes each intruder's id from the staged
// table instead of jb*B + lane.  The sentinel id nb*B is staged as an
// inactive column.  Ids ascend within a row, so the strict '<' insert
// keeps the Pallas tie order there too.
//
// Bound on the card: the pair math.  Each visited tile costs B*B pairs
// of ~175 f32 operations without the keep predicate and ~220 with it
// (a handful of sqrt/rsqrt/divisions among them; chip_smoke.py has the
// hand counts) against 16*B*4 bytes of slab, so the kernels sit far
// above the memory roofline and are bounded by the f32 rate
// (chip_smoke.py computes the bound from the active pairs of each run).
// The full-grid walker gives each row block one CTA, so the row with the
// most reachable tiles (a Morton block straddling a jump of the curve has
// a wide bounding box) sets its time.  Nothing here uses the tensor
// cores; occupancy, intruder reuse and splitting long rows are later work.
//
// Plain C interface (built with nvcc, loaded with ctypes); every entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 16;        // slab rows (cd_pallas._FIELDS)
constexpr int MAXB = 256;     // max block width
constexpr float BIG = 1e9f;
constexpr int BIG_I = 1 << 30;

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

struct Params {
  float rpz, r2, hpz, tlook;        // detection
  float rpz_m, hpz_m, tlook_m;      // MVP (margin-scaled zone)
  float rpz_resume;                 // resume-nav radius rpz * resofach
};

struct Outs {
  float* acc;     // [8, NT]: inconf tcpamax sdve sdvn sdvv tsolv ncnt lcnt
  float* ctin;    // [nb, KK, B]
  int* cidx;      // [nb, KK, B]
  float* keep;    // [nb, KK, B]
  int* merged;    // [nb, KK, B]
  float* active;  // [NT]
};

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

template <int KK>
struct Row {
  float o[NF];          // ownship slab column
  int gid;
  float inconf, tcpamax, sdve, sdvn, sdvv, tsolv, ncnt, lcnt;
  float ct[KK];
  int ci[KK];
  int pold[KK];
  unsigned keep;
};

template <int KK>
__device__ __forceinline__ void insert_cand(Row<KK>& r, float tin, int id) {
  if (!(tin < r.ct[KK - 1])) return;
#pragma unroll
  for (int j = KK - 1; j > 0; --j) {
    if (tin < r.ct[j - 1]) {
      r.ct[j] = r.ct[j - 1];
      r.ci[j] = r.ci[j - 1];
    } else if (tin < r.ct[j]) {
      r.ct[j] = tin;
      r.ci[j] = id;
    }
  }
  if (tin < r.ct[0]) {
    r.ct[0] = tin;
    r.ci[0] = id;
  }
}

// One ownship against one staged intruder slab (cd_pallas._tile_pairs; with
// RESUME, the resume keep predicate too).  The intruder ids are the staged
// ids sid with IDS, else those of block jb, jb*B + lane.
template <int KK, bool RESUME, bool IDS>
__device__ void tile_pairs(float (*s)[MAXB], const int* sid, int jb, int B,
                           Row<KK>& r, const Params& P) {
  const float* o = r.o;
  for (int t = 0; t < B; ++t) {
    const int gid_i = IDS ? sid[t] : jb * B + t;
    if (!(s[F_ACTIVE][t] > 0.5f) || gid_i == r.gid) continue;
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
    const float vrel_e = s[F_GSE][t] - o[F_GSE];
    const float vrel_n = s[F_GSN][t] - o[F_GSN];

    if (swlos) r.lcnt += 1.0f;
    if (swconfl) {
      r.inconf = 1.0f;
      r.tcpamax = fmaxf(r.tcpamax, tcpa);
      r.ncnt += 1.0f;
      if (!(s[F_NORESO][t] > 0.5f)) {
        // --- MVP pair contribution: cr_mvp.pair_contrib_trig ---
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
        r.sdve += dve;
        r.sdvn += dvn;
        r.sdvv += dvv;
        r.tsolv = fminf(r.tsolv, tsolv);
      }
    }

    if constexpr (!RESUME) {
      if (swconfl) insert_cand<KK>(r, tinconf, gid_i);
      continue;
    }
    // --- resume-nav keep predicate: cr_mvp.resume_keep_core ---
    const float cos_half = sqrtf(fmaxf(0.5f + 0.5f * cos_sum, 0.0f));
    const float dist_e = REARTH * ((lon_i - o[F_LON]) * RAD) * cos_half;
    const float dist_n = REARTH * ((lat_i - o[F_LAT]) * RAD);
    const bool past_cpa = dist_e * vrel_e + dist_n * vrel_n > 0.0f;
    const float hdist = sqrtf(dist_e * dist_e + dist_n * dist_n);
    const bool keep = !past_cpa || (hdist < P.rpz)
        || ((fabsf(o[F_TRK] - s[F_TRK][t]) < 30.0f) && (hdist < P.rpz_resume));
    if (keep) {
#pragma unroll
      for (int k = 0; k < KK; ++k)
        if (r.pold[k] == gid_i) r.keep |= 1u << k;
      if (swconfl) insert_cand<KK>(r, tinconf, gid_i);
    }
  }
}

template <int KK, bool RESUME>
__device__ void row_begin(Row<KK>& r, const float* packed, const int* pold,
                          int i, int B, int t) {
#pragma unroll
  for (int f = 0; f < NF; ++f) r.o[f] = packed[((size_t)i * NF + f) * B + t];
  r.gid = i * B + t;
  r.inconf = r.tcpamax = r.sdve = r.sdvn = r.sdvv = 0.0f;
  r.tsolv = BIG;
  r.ncnt = r.lcnt = 0.0f;
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    r.ct[k] = BIG;
    r.ci[k] = BIG_I;
    if constexpr (RESUME) r.pold[k] = pold[((size_t)i * KK + k) * B + t];
    else r.pold[k] = -1;
  }
  r.keep = 0u;
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

// The stores of one ownship: the 8 accumulators and the top-KK; with
// RESUME, cd_pallas._merge_partners_block first, then the keep bits, the
// merged partners and the engagement flag too.  (Merging before the
// stores keeps the resume kernels at 80 registers; storing first took 93,
// one CTA fewer per SM, and made K1 ~30 % slower on an H100.)
template <int KK, bool RESUME>
__device__ void row_finish(const Row<KK>& r, const Outs& out, int i, int B,
                           int t, size_t nt) {
  int merged[KK];
  int n = 0;
  if constexpr (RESUME) {
    int cat[2 * KK];
#pragma unroll
    for (int k = 0; k < KK; ++k) cat[k] = r.ct[k] < BIG ? r.ci[k] : -1;
#pragma unroll
    for (int k = 0; k < KK; ++k) {
      int old = ((r.keep >> k) & 1u) ? r.pold[k] : -1;
#pragma unroll
      for (int m = 0; m < KK; ++m)
        if (cat[m] >= 0 && old == cat[m]) old = -1;
      cat[KK + k] = old;
    }
#pragma unroll
    for (int k = 0; k < KK; ++k) merged[k] = -1;
#pragma unroll
    for (int c = 0; c < 2 * KK; ++c) {
      if (cat[c] >= 0) {
#pragma unroll
        for (int k = 0; k < KK; ++k)
          if (k == n) merged[k] = cat[c];
        ++n;
      }
    }
  }
  const size_t g = (size_t)i * B + t;
  out.acc[0 * nt + g] = r.inconf;
  out.acc[1 * nt + g] = r.tcpamax;
  out.acc[2 * nt + g] = r.sdve;
  out.acc[3 * nt + g] = r.sdvn;
  out.acc[4 * nt + g] = r.sdvv;
  out.acc[5 * nt + g] = r.tsolv;
  out.acc[6 * nt + g] = r.ncnt;
  out.acc[7 * nt + g] = r.lcnt;
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    const size_t e = ((size_t)i * KK + k) * B + t;
    out.ctin[e] = r.ct[k];
    out.cidx[e] = r.ci[k];
    if constexpr (RESUME) {
      out.keep[e] = (float)((r.keep >> k) & 1u);
      out.merged[e] = merged[k];
    }
  }
  if constexpr (RESUME) out.active[g] = n > 0 ? 1.0f : 0.0f;
}

// _sched_kernel: row block i walks its <= S (start, len) segments of
// <= wmax contiguous intruder blocks each.
template <int KK>
__global__ void __launch_bounds__(MAXB)
sched_kernel(const float* __restrict__ packed, int nbc, int B,
             const int* __restrict__ wst, const int* __restrict__ wln, int S,
             int wmax, const int* __restrict__ pold, Params P, Outs out) {
  __shared__ float s[NF][MAXB];
  const int i = blockIdx.x, t = threadIdx.x;
  Row<KK> r;
  row_begin<KK, true>(r, packed, pold, i, B, t);
  const bool own_act = r.o[F_ACTIVE] > 0.5f;
  if (__syncthreads_or(own_act)) {
    for (int sg = 0; sg < S; ++sg) {
      const int base = wst[i * S + sg];
      const int len = min(wln[i * S + sg], wmax);
      for (int k = 0; k < len; ++k) {
        const int jb = base + k;
        if (jb >= nbc) break;
        stage(s, packed, jb, B, t);
        if (own_act) tile_pairs<KK, true, false>(s, nullptr, jb, B, r, P);
      }
    }
  }
  row_finish<KK, true>(r, out, i, B, t, (size_t)gridDim.x * B);
}

// _kernel_resume (RESUME) and _kernel: row block i visits every intruder
// block jb with reach[i, jb] != 0, in ascending jb (the callers restrict
// reach to the overflow rows where it is a fallback).
template <int KK, bool RESUME>
__global__ void __launch_bounds__(MAXB)
full_grid_kernel(const float* __restrict__ packed, int nbc, int B,
                 const uint8_t* __restrict__ reach,
                 const int* __restrict__ pold, Params P, Outs out) {
  __shared__ float s[NF][MAXB];
  const int i = blockIdx.x, t = threadIdx.x;
  Row<KK> r;
  row_begin<KK, RESUME>(r, packed, pold, i, B, t);
  const bool own_act = r.o[F_ACTIVE] > 0.5f;
  if (__syncthreads_or(own_act)) {
    const uint8_t* rrow = reach + (size_t)i * nbc;
    for (int jb = 0; jb < nbc; ++jb) {
      if (!rrow[jb]) continue;
      stage(s, packed, jb, B, t);
      if (own_act) tile_pairs<KK, RESUME, false>(s, nullptr, jb, B, r, P);
    }
  }
  row_finish<KK, RESUME>(r, out, i, B, t, (size_t)gridDim.x * B);
}

// _kernel_cand: row block i against the aircraft of its candidate table
// cand[i, 0:c_cap] (ascending ids, then sentinels nb*B), B at a time.
// A sub-chunk that starts with the sentinel holds nothing else, nor does
// any later one, so the row ends there (an overflow row's table is all
// sentinel and costs one read).
template <int KK>
__global__ void __launch_bounds__(MAXB)
cand_kernel(const float* __restrict__ packed, int nb, int B,
            const int* __restrict__ cand, int c_cap, Params P, Outs out) {
  __shared__ float s[NF][MAXB];
  __shared__ int sid[MAXB];
  const int i = blockIdx.x, t = threadIdx.x;
  const int n = nb * B;
  Row<KK> r;
  row_begin<KK, false>(r, packed, nullptr, i, B, t);
  const bool own_act = r.o[F_ACTIVE] > 0.5f;
  if (__syncthreads_or(own_act)) {
    const int* crow = cand + (size_t)i * c_cap;
    for (int c = 0; c < c_cap; c += B) {
      if (crow[c] >= n) break;
      stage_ids(s, sid, packed, crow + c, n, B, t);
      if (own_act) tile_pairs<KK, false, true>(s, sid, 0, B, r, P);
    }
  }
  row_finish<KK, false>(r, out, i, B, t, (size_t)gridDim.x * B);
}

Params make_params(float rpz, float r2, float hpz, float tlook, float rpz_m,
                   float hpz_m, float tlook_m, float rpz_resume) {
  Params p;
  p.rpz = rpz; p.r2 = r2; p.hpz = hpz; p.tlook = tlook;
  p.rpz_m = rpz_m; p.hpz_m = hpz_m; p.tlook_m = tlook_m;
  p.rpz_resume = rpz_resume;
  return p;
}

}  // namespace

extern "C" {

// kk must be 8 (the partner-table width K of the state); B <= 256.
int cd_sched_tiles(const float* packed, int nb, int B, const int* wst,
                   const int* wln, int S, int wmax, const int* pold, float rpz,
                   float r2, float hpz, float tlook, float rpz_m, float hpz_m,
                   float tlook_m, float rpz_resume, float* acc, float* ctin,
                   int* cidx, float* keep, int* merged, float* active,
                   void* stream) {
  if (B <= 0 || B > MAXB) return (int)cudaErrorInvalidValue;
  if (nb <= 0) return 0;
  Params P = make_params(rpz, r2, hpz, tlook, rpz_m, hpz_m, tlook_m,
                         rpz_resume);
  Outs o{acc, ctin, cidx, keep, merged, active};
  sched_kernel<8><<<nb, B, 0, (cudaStream_t)stream>>>(
      packed, nb, B, wst, wln, S, wmax, pold, P, o);
  return (int)cudaGetLastError();
}

int cd_full_grid_resume(const float* packed, int nb, int B,
                        const uint8_t* reach, const int* pold, float rpz,
                        float r2, float hpz, float tlook, float rpz_m,
                        float hpz_m, float tlook_m, float rpz_resume,
                        float* acc, float* ctin, int* cidx, float* keep,
                        int* merged, float* active, void* stream) {
  if (B <= 0 || B > MAXB) return (int)cudaErrorInvalidValue;
  if (nb <= 0) return 0;
  Params P = make_params(rpz, r2, hpz, tlook, rpz_m, hpz_m, tlook_m,
                         rpz_resume);
  Outs o{acc, ctin, cidx, keep, merged, active};
  full_grid_kernel<8, true><<<nb, B, 0, (cudaStream_t)stream>>>(
      packed, nb, B, reach, pold, P, o);
  return (int)cudaGetLastError();
}

// The reach-masked full grid without a partner table (rpz_resume unused).
int cd_full_grid(const float* packed, int nb, int B, const uint8_t* reach,
                 float rpz, float r2, float hpz, float tlook, float rpz_m,
                 float hpz_m, float tlook_m, float rpz_resume, float* acc,
                 float* ctin, int* cidx, void* stream) {
  if (B <= 0 || B > MAXB) return (int)cudaErrorInvalidValue;
  if (nb <= 0) return 0;
  Params P = make_params(rpz, r2, hpz, tlook, rpz_m, hpz_m, tlook_m,
                         rpz_resume);
  Outs o{acc, ctin, cidx, nullptr, nullptr, nullptr};
  full_grid_kernel<8, false><<<nb, B, 0, (cudaStream_t)stream>>>(
      packed, nb, B, reach, nullptr, P, o);
  return (int)cudaGetLastError();
}

// The candidate pass; c_cap is a multiple of B (rpz_resume unused).
int cd_cand_tiles(const float* packed, int nb, int B, const int* cand,
                  int c_cap, float rpz, float r2, float hpz, float tlook,
                  float rpz_m, float hpz_m, float tlook_m, float rpz_resume,
                  float* acc, float* ctin, int* cidx, void* stream) {
  if (B <= 0 || B > MAXB || c_cap < 0 || c_cap % B)
    return (int)cudaErrorInvalidValue;
  if (nb <= 0) return 0;
  Params P = make_params(rpz, r2, hpz, tlook, rpz_m, hpz_m, tlook_m,
                         rpz_resume);
  Outs o{acc, ctin, cidx, nullptr, nullptr, nullptr};
  cand_kernel<8><<<nb, B, 0, (cudaStream_t)stream>>>(packed, nb, B, cand,
                                                     c_cap, P, o);
  return (int)cudaGetLastError();
}

}  // extern "C"
