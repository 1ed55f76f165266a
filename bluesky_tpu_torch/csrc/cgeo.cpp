// Host-side geodesy core: the C twin of ops/hostgeo.py's NumPy path.
//
// Port of bluesky_tpu/src_cpp/cgeo.cpp.  The math is the same (WGS-84
// local radius and gravity, the hemisphere-aware mean radius with its
// two modes, haversine bearing/distance, great-circle projection and the
// flat-earth kwik pair); the interface is a plain C one over flat
// float64 arrays in place of the CPython method table, so the library
// needs no Python or NumPy headers.  It is built with the host compiler
// into bluesky_tpu_torch/_build/ on first use and loaded with ctypes
// (ops/hostgeo.py), which owns broadcasting and the scalar/matrix
// conventions: every entry point takes arrays of one common length n.
//
// One difference from the JAX package's core: kwik reduces its bearing
// the way NumPy's `%` does (fmod, then +360 below zero) where JAX's adds
// 360 before fmod.  The two agree to within an ulp of 360; the NumPy way
// keeps the low bits of a small bearing, so the C and NumPy paths of the
// port agree to the last bits there too.
#include <cmath>

namespace {

constexpr double A = 6378137.0;              // WGS-84 semi-major axis [m]
constexpr double B = 6356752.314245;         // WGS-84 semi-minor axis [m]
constexpr double REARTH = 6371000.0;         // kwik* mean radius [m]
constexpr double NM = 1852.0;
constexpr double D2R = 0.017453292519943295;
constexpr double R2D = 57.29577951308232;

inline double rwgs84_rad(double coslat, double sinlat) {
    const double an = A * A * coslat, bn = B * B * sinlat;
    const double ad = A * coslat, bd = B * sinlat;
    return std::sqrt((an * an + bn * bn) / (ad * ad + bd * bd));
}

inline double rwgs84_deg(double latd) {
    const double lat = D2R * latd;
    return rwgs84_rad(std::cos(lat), std::sin(lat));
}

// Hemisphere-aware mean radius; mode 0 = scalar qdrdist semantics
// (radius at the average latitude), mode 1 = the matrix-variant quirks
// (radius at the SUM of latitudes; 1e-6 deg epsilon when lat1 == 0).
inline double mean_radius(double lat1, double lat2, int mode) {
    if (mode == 0) {
        if (lat1 * lat2 >= 0.0) return rwgs84_deg(0.5 * (lat1 + lat2));
        double denom = std::fabs(lat1) + std::fabs(lat2);
        if (denom < 1e-30) denom = 1e-30;
        return 0.5 * (std::fabs(lat1) * (rwgs84_deg(lat1) + A)
                      + std::fabs(lat2) * (rwgs84_deg(lat2) + A)) / denom;
    }
    if (lat1 * lat2 < 0.0) {
        const double denom = std::fabs(lat1) + std::fabs(lat2)
                             + (lat1 == 0.0 ? 1e-6 : 0.0);
        return 0.5 * (std::fabs(lat1) * (rwgs84_deg(lat1) + A)
                      + std::fabs(lat2) * (rwgs84_deg(lat2) + A)) / denom;
    }
    return rwgs84_deg(lat1 + lat2);
}

inline void haversine(double latd1, double lond1, double latd2,
                      double lond2, double r, double* qdr, double* dist) {
    const double lat1 = D2R * latd1, lon1 = D2R * lond1;
    const double lat2 = D2R * latd2, lon2 = D2R * lond2;
    const double s1 = std::sin(0.5 * (lat2 - lat1));
    const double s2 = std::sin(0.5 * (lon2 - lon1));
    const double c1 = std::cos(lat1), c2 = std::cos(lat2);
    const double root = s1 * s1 + c1 * c2 * s2 * s2;
    *dist = 2.0 * r * std::atan2(std::sqrt(root), std::sqrt(1.0 - root));
    *qdr = R2D * std::atan2(
        std::sin(lon2 - lon1) * c2,
        c1 * std::sin(lat2) - std::sin(lat1) * c2 * std::cos(lon2 - lon1));
}

}  // namespace

extern "C" {

// rwgs84(lat) -> local radius [m]
void cgeo_rwgs84(const double* lat, long n, double* r) {
    for (long i = 0; i < n; ++i) r[i] = rwgs84_deg(lat[i]);
}

// wgsg(lat) -> gravity [m/s2]
void cgeo_wgsg(const double* lat, long n, double* g) {
    for (long i = 0; i < n; ++i) {
        const double s = std::sin(D2R * lat[i]);
        g[i] = 9.7803 * (1.0 + 0.001932 * s * s)
               / std::sqrt(1.0 - 6.694e-3 * s * s);
    }
}

// qdrdist(lat1, lon1, lat2, lon2, mode) -> (qdr deg, dist m)
void cgeo_qdrdist(const double* lat1, const double* lon1, const double* lat2,
                  const double* lon2, long n, int mode, double* q,
                  double* d) {
    for (long i = 0; i < n; ++i) {
        const double r = mean_radius(lat1[i], lat2[i], mode);
        haversine(lat1[i], lon1[i], lat2[i], lon2[i], r, &q[i], &d[i]);
    }
}

// qdrpos(lat1, lon1, qdr deg, dist nm) -> (lat2, lon2) [deg]
void cgeo_qdrpos(const double* lat1d, const double* lon1d, const double* qdr,
                 const double* dist, long n, double* la, double* lo) {
    for (long i = 0; i < n; ++i) {
        const double R = rwgs84_deg(lat1d[i]) / NM;
        const double lat1 = D2R * lat1d[i], lon1 = D2R * lon1d[i];
        const double dr = dist[i] / R, qdrr = D2R * qdr[i];
        const double sl = std::sin(lat1), cl = std::cos(lat1);
        const double lat2 = std::asin(
            sl * std::cos(dr) + cl * std::sin(dr) * std::cos(qdrr));
        la[i] = R2D * lat2;
        lo[i] = R2D * (lon1 + std::atan2(
            std::sin(qdrr) * std::sin(dr) * cl,
            std::cos(dr) - sl * std::sin(lat2)));
    }
}

// kwik(lat1, lon1, lat2, lon2) -> (qdr deg in [0, 360], dist m)
void cgeo_kwik(const double* lat1, const double* lon1, const double* lat2,
               const double* lon2, long n, double* q, double* d) {
    for (long i = 0; i < n; ++i) {
        const double dlat = D2R * (lat2[i] - lat1[i]);
        const double dlon = D2R * (lon2[i] - lon1[i]);
        const double cav = std::cos(D2R * (lat1[i] + lat2[i]) * 0.5);
        d[i] = REARTH * std::sqrt(dlat * dlat + dlon * dlon * cav * cav);
        double qd = std::fmod(R2D * std::atan2(dlon * cav, dlat), 360.0);
        if (qd < 0.0) qd += 360.0;
        q[i] = qd;
    }
}

}  // extern "C"
