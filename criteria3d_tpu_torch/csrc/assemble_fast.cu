// The float32 Picard assembly of the catchment water system, for Hopper
// (sm_90a): capacity, conductivity, boundary flows and the Jacobi-scaled
// psi-form stencil of solver/water.py assemble_fast in two passes.
//
// Replaces no TPU kernel. In the JAX package criteria3d_tpu/solver/water.py
// assemble_fast is plain jnp code that XLA fuses into one pass; PyTorch runs
// the same chain eagerly as several hundred elementwise kernels, each with a
// whole-box temporary in device memory (solver/water.py
// assemble_fast_reference, which stays the plain version for CPU tensors and
// the tests). This library takes its place for CUDA tensors.
//
// Bound: device memory. At the 7 x 768 x 768 storm box the assembly must
// read 350,355,600 bytes (psi, psi_old, se, the float64 sink, the float32
// grid and soil fields, the boundary types and the mask) and write
// 247,726,080 (b, c_up, c_down, diag, 8 x c_lat, the water flow, the
// boundary rate and k): 0.1785 ms at 3.35 TB/s. The two passes move about
// 1.1 x those bytes, pass 2 rereading pass 1's four outputs and k's and the
// mask's rings. On an H100 80GB HBM3 (700 W) pass 1 takes 0.152 ms and
// pass 2 0.289 ms at that box (0.447 ms, 40 % of the bound), the eager
// chain 10-16 ms. Neither reaches the bandwidth: pass 1 is held by its
// float64 powers (up to 6 a soil node, the float32 powers widened as below;
// evaluating only the branches taken cut it by a fifth), pass 2 most likely
// by the latency of its layer walk. Both run more blocks an SM than their
// registers would allow (6 and 4), at the price of a few spilled bytes,
// which paid; pass 2 at 6 spilled much more and slowed.
//
// Design: two passes, because the stencil reads its lateral neighbours' k,
// which the retention chain makes.
// - Pass 1 (assemble_pass1_kernel), one thread a node, coalesced: the
//   retention chain (k, and the capacity by its secant or analytic dSe/dpsi),
//   the sink with its surface cap, and every boundary rate (runoff, free
//   drainage, free lateral drainage, prescribed potential and culvert when
//   the grid has them) with the DBL_EPSILON flush and the mask; of each of
//   the chain's selects it evaluates only the branch taken. It writes k,
//   the rate, the capacity (into diag, which pass 2 overwrites in place) and
//   the flow (layers >= 1 into water_flow, layer 0 into a plane that pass 2
//   only reads: its neighbours read it for their surface heads). Nodes off
//   the mask, and the surface layer's retention chain, take the constants
//   the chain selects there, without their powers.
// - Between the passes the wrapper runs the heat hooks in PyTorch: the
//   boundary flow is added to the rate and the thermal flux is evaluated on
//   pass 1's k (solver/assemble_kernel.py).
// - Pass 2 (assemble_pass2_kernel): a 32 x 8 tile of (row, col) columns, one
//   thread a column walking its L layers in registers. Each layer's k (as
//   k * lateral_vertical_ratio, clamped) and mask come into shared memory
//   with a one-cell ring (0 and false past the box edge, as shift2d fills),
//   double-buffered: the next layer's ring is fetched into registers while
//   this one computes, so one barrier a layer suffices; the surface heads,
//   ponds and roughness of layer 0 likewise. The surface
//   links (Manning conductance and the Courant number) are computed once per
//   column at layer 0, the vertical links (redistribution, and infiltration
//   into layer 1) one layer ahead of the walk, and each layer's diagonal,
//   psi-form right-hand side and Jacobi-scaled coefficients are written.
//
// The Courant number is the maximum over every surface link: each block
// folds its threads' maxima and adds its own to one float64 word with an
// integer atomicMax on the bits, which order as the values do for the
// non-negative numbers it sees (a NaN wins, as torch's amax keeps it). The
// result is exact and independent of the blocks' order. Pass 1's first
// thread resets the word, inside the same stream (and CUDA graph), never the
// host.
//
// Numerics: the result is bit-equal to the eager chain on the card. Every
// float32 expression keeps the chain's operand order and one rounding per
// operation: the library is built with --fmad=false so that nvcc contracts
// no multiply and add into an FMA. Division and sqrtf are IEEE (no fast
// math), the logarithmic mean uses log1pf, and each float32 power is
// evaluated as core/soil.py power() does: the operands widened to double,
// CUDA's double pow, one rounding to float32. Constants are the float32
// values torch rounds its Python scalars to (hex literals below);
// maximum, minimum and the clamps keep a NaN as torch does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// BoundaryType (core/grid.py)
constexpr int kRunoff = 1;
constexpr int kFreeDrainage = 2;
constexpr int kFreeLateralDrainage = 3;
constexpr int kPrescribed = 4;
constexpr int kUrban = 5;
constexpr int kRoad = 6;
constexpr int kCulvert = 7;

// variant flags (solver/assemble_kernel.py Variant.bits)
constexpr int kModifiedVG = 1;
constexpr int kMeanShift = 1;     // 2 bits: 0 arithmetic, 1 geometric, 2 logarithmic
constexpr int kCourantCompat = 8;
constexpr int kCulvertCompat = 16;
constexpr int kHasPrescribed = 32;
constexpr int kHasCulvert = 64;
constexpr int kExtraHook = 128;

// torch's float32 roundings of the chain's Python constants
constexpr float kTwoThirds = 0x1.555556p-1f;   // 2/3
constexpr float k054 = 0x1.147ae2p-1f;         // 0.54
constexpr float k263 = 0x1.50a3d8p+1f;         // 2.63
constexpr float k1em4 = 0x1.a36e2ep-14f;       // 1e-4
constexpr float k1em12 = 0x1.197998p-40f;      // 1e-12
constexpr float k1em20 = 0x1.79ca1p-67f;       // 1e-20
constexpr float k1em30 = 0x1.4484cp-100f;      // 1e-30
constexpr float kEpsMeter = 0x1.4f8b58p-17f;   // EPSILON_METER 1e-5
constexpr float kEpsRunoff = 0x1.0624dep-10f;  // EPSILON_RUNOFF 1e-3
constexpr float kMinInfil = 0x1.e91012p-36f;   // MIN_INFILTRATION_RATE 2.78e-11
constexpr float kDblEps = 0x1p-52f;            // DBL_EPSILON
constexpr float kTiny = 0x1p-126f;             // finfo(float32).tiny
constexpr float kUrbanFactor = 0x1.51eb86p-2f; // 0.33
constexpr float kPi = 0x1.921fb6p+1f;          // PI
constexpr float kHazen = 0x1.cba5e4p+1f;       // 3.591

constexpr int kThreads1 = 256;
constexpr int kTC = 32;                 // pass 2 tile: columns
constexpr int kTR = 8;                  // rows
constexpr int kHW = kTC + 2;            // ring-grown tile
constexpr int kHalo = kHW * (kTR + 2);
constexpr int kSlots = (kHalo + kTC * kTR - 1) / (kTC * kTR);  // ring cells a thread

}  // namespace

// The kernels' arguments, as solver/assemble_kernel.py _Args lays them out.
// Float32 fields are the grid's float32 copy (Grid.astype); float64 ones
// are the state's and the grid's own.
struct AssembleArgs {
  const float* psi;            // (L, R, C)
  const float* psi_old;
  const float* se;
  const double* sink;          // (L, R, C)
  const double* pond;          // (R, C)
  const float* volume;         // (L, R, C)
  const float* bsize;
  const float* bslope;
  const float* roughness;      // (R, C)
  const float* vg_alpha;       // the soil fields, (L, R, C)
  const float* vg_n;
  const float* vg_m;
  const float* vg_he;
  const float* vg_sc;
  const float* theta_s;
  const float* theta_r;
  const float* k_sat;
  const float* mualem_l;
  const float* mualem_den;
  const float* lat_dist3d;     // (8, R, C)
  const float* dz_lat;         // (8, R, C)
  const float* lat_dist2d;     // (8,)
  const float* lat_area;       // (L,)
  const float* area;           // (1,)
  const float* z32;            // (L, R, C): the culvert's reference water level
  const float* culvert_w;      // (R, C)
  const float* culvert_h;
  const float* culvert_rough;
  const double* vert_dist;     // (L,)
  const double* prescribed_h;  // (L, R, C)
  const double* z;             // (L, R, C)
  const int8_t* btype;         // (L, R, C)
  const uint8_t* mask;         // (L, R, C)
  const double* dt;            // 0-d (dt_kind 1)
  const int64_t* approx;       // 0-d int64 (approx_kind 1)
  const float* extra;          // (L, R, C) thermal flux (kExtraHook)
  float* b;                    // outputs, (L, R, C)
  float* c_up;
  float* c_down;
  float* c_lat;                // (8, L, R, C)
  float* diag;
  float* water_flow;
  float* rate;
  float* k;
  float* flow0;                // (R, C) scratch: layer 0's flow
  double* courant;             // 0-d
  float lvr;                   // lateral_vertical_ratio
  float dt_host;               // dt when dt_kind is 0
  int first_host;              // approx == 0 when approx_kind is 0
  int dt_kind;
  int approx_kind;
  int flags;
  int L, R, C;
};

namespace {

// torch's float32 elementwise functions on the card (NaN kept as torch does)
__device__ __forceinline__ bool is_nan(float v) { return v != v; }
__device__ __forceinline__ float t_max(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_min(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return is_nan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return is_nan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return is_nan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float sign(float v) {
  return static_cast<float>((0.0f < v) - (v < 0.0f));
}
// core/soil.py power(): widened to double, CUDA's pow, rounded once
__device__ __forceinline__ float power(float x, float y) {
  return static_cast<float>(pow(static_cast<double>(x), static_cast<double>(y)));
}

// core/soil.py compute_mean
__device__ __forceinline__ float mean(float v1, float v2, int type) {
  if (type == 0) return 0.5f * (v1 + v2);
  if (type == 1) return sign(v1) * sqrtf(v1 * v2);
  const float hi = t_max(v1, v2);
  const float lo = t_min(v1, v2);
  const float hi_safe = hi == 0.0f ? 1.0f : hi;
  const float d = (hi - lo) / hi_safe;
  float denom = -log1pf(-clamp_max(d, 1.0f));
  const bool tiny = d <= kTiny;
  denom = tiny ? 1.0f : denom;
  return tiny ? hi : (hi - lo) / denom;
}

struct Soil {
  float alpha, n, m, he, sc, ksat, l, den;
};

__device__ __forceinline__ Soil soil_at(const AssembleArgs& a, int64_t i, bool mvg) {
  Soil s;
  s.alpha = a.vg_alpha[i];
  s.n = a.vg_n[i];
  s.m = a.vg_m[i];
  s.sc = a.vg_sc[i];
  s.ksat = a.k_sat[i];
  s.l = a.mualem_l[i];
  s.he = mvg ? a.vg_he[i] : 0.0f;
  s.den = mvg ? a.mualem_den[i] : 1.0f;
  return s;
}

// core/soil.py se_from_psi
__device__ __forceinline__ float se_from_psi(const Soil& s, float psi, bool mvg) {
  const float base = power(power(s.alpha * psi, s.n) + 1.0f, -s.m);
  if (!mvg) return base;
  return psi <= s.he ? 1.0f : base / s.sc;
}

// core/soil.py mualem_conductivity
__device__ __forceinline__ float mualem(const Soil& s, float se, bool mvg) {
  const float inv_m = 1.0f / s.m;
  const float se_c = clamp(se, k1em12, 1.0f);
  float temp;
  if (!mvg) {
    temp = 1.0f - power(1.0f - power(se_c, inv_m), s.m);
  } else {
    const float sesc = clamp_max(se_c * s.sc, 1.0f);
    temp = (1.0f - power(1.0f - power(sesc, inv_m), s.m)) / s.den;
  }
  const float k = ((s.ksat * power(se_c, s.l)) * temp) * temp;
  return se >= 1.0f ? s.ksat : k;
}

__device__ __forceinline__ float step_dt(const AssembleArgs& a) {
  return a.dt_kind == 1 ? static_cast<float>(*a.dt) : a.dt_host;
}

__device__ __forceinline__ bool step_first(const AssembleArgs& a) {
  return a.approx_kind == 1 ? *a.approx == 0 : a.first_host != 0;
}

// the vertical distance of layer l as the stencil divides by it
// (where(vert_dist > 0, vert_dist, 1) in float64, then float32)
__device__ __forceinline__ float vert_dist(const AssembleArgs& a, int l) {
  const double v = a.vert_dist[l];
  return v > 0.0 ? static_cast<float>(v) : 1.0f;
}

// pass 1: one node
__global__ void __launch_bounds__(kThreads1, 6) assemble_pass1_kernel(const AssembleArgs a) {
  const int64_t plane = static_cast<int64_t>(a.R) * a.C;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads1 + threadIdx.x;
  if (i == 0) *a.courant = 0.0;
  if (i >= plane * a.L) return;
  const int l = static_cast<int>(i / plane);
  const int64_t rc = i - l * plane;
  if (!a.mask[i]) {
    a.k[i] = 0.0f;
    a.diag[i] = 1.0f;
    a.rate[i] = 0.0f;
    if (l == 0) {
      a.flow0[rc] = 0.0f;
    } else {
      a.water_flow[i] = 0.0f;
    }
    return;
  }
  const int f = a.flags;
  const bool mvg = f & kModifiedVG;
  const int mean_type = (f >> kMeanShift) & 3;
  const float dt = step_dt(a);
  const float psi = a.psi[i];
  const float psi_old = a.psi_old[i];
  const float vol = a.volume[i];

  // capacity + conductivity: the retention chain (layer 0: k = 0, C = vol)
  float k = 0.0f;
  float cap = vol;
  if (l > 0) {
    const Soil s = soil_at(a, i, mvg);
    const float se = a.se[i];
    const float psi_c = fabsf(clamp_max(psi, 0.0f));
    const float psi_p = fabsf(clamp_max(psi_old, 0.0f));
    const float x = s.alpha * clamp_min(psi_c, k1em20);
    const float xn = power(x, s.n);
    const float one = xn + 1.0f;
    // only the branch each select takes (the powers are most of the work)
    if (se >= 1.0f) {
      k = s.ksat;
    } else {
      const float se_c = clamp(se, k1em12, 1.0f);
      const float num = 1.0f - power(xn / one, s.m);
      const float temp = mvg ? num / s.den : num;
      k = ((s.ksat * power(se_c, s.l)) * temp) * temp;
    }
    const bool saturated = mvg ? (psi_c <= s.he) && (psi_p <= s.he)
                               : (psi_c == 0.0f) && (psi_p == 0.0f);
    float dse = 0.0f;
    if (!saturated) {
      if (fabsf(psi_c - psi_p) > k1em4) {
        // the secant, where the chord is float32-resolvable
        const float se_p = se_from_psi(s, psi_p, mvg);
        const float dh = psi - psi_old;
        dse = fabsf((se - se_p) / (dh != 0.0f ? dh : 1.0f));
      } else {
        const float term = (power(one, -s.m) / one) * (xn / x);
        dse = (((s.alpha * s.n) * s.m) * term) / s.sc;
      }
    }
    cap = (vol * dse) * (a.theta_s[i] - a.theta_r[i]);
  }

  // the sink, the surface's capped at the water it holds
  float flow = static_cast<float>(a.sink[i]);
  if (l == 0) {
    const float h_s0 = clamp_min(0.5f * (psi + psi_old), 0.0f);
    const float max_surf_flux = ((-h_s0) * vol) / dt;
    flow = flow < 0.0f ? t_max(flow, max_surf_flux) : flow;
    a.flow0[rc] = flow;
  } else {
    a.water_flow[i] = flow;
  }

  // the boundary rate of the node's type
  const int bt = a.btype[i];
  float rate = 0.0f;
  if (bt == kRunoff) {
    if (l == 0) {
      const float pond = static_cast<float>(a.pond[rc]);
      const float hs0 = clamp_min(0.5f * (psi + psi_old) - pond, 0.0f);
      const float rough_s = clamp_min(a.roughness[rc], k1em12);
      const float v =
          (power(hs0, kTwoThirds) * sqrtf(clamp_min(a.bslope[i], 0.0f))) / rough_s;
      const float max_flow = (hs0 * vol) / dt;
      const float val_flow = (hs0 * v) * a.bsize[i];
      rate = hs0 < kEpsRunoff ? 0.0f : -t_min(val_flow, max_flow);
    }
  } else if (bt == kFreeDrainage) {
    rate = (-k) * a.area[0];
  } else if (bt == kFreeLateralDrainage) {
    rate = (((-k) * a.bsize[i]) * a.bslope[i]) * a.lvr;
  } else if (bt == kPrescribed && (f & kHasPrescribed)) {
    // fixed total potential 1 m below the node
    const float presc_psi = static_cast<float>(a.prescribed_h[i] - a.z[i]);
    const float boundary_psi = presc_psi + 1.0f;
    const Soil s = soil_at(a, i, mvg);
    const float k_bound = boundary_psi >= 0.0f
                              ? s.ksat
                              : mualem(s, se_from_psi(s, fabsf(boundary_psi), mvg), mvg);
    const float mean_kb = mean(k_bound, clamp_min(k, k1em30), mean_type);
    rate = ((mean_kb * a.bsize[i]) * (presc_psi - psi)) / 1.0f;
  } else if (bt == kCulvert && (f & kHasCulvert)) {
    if (l == 0) {
      const float cw = a.culvert_w[rc];
      const float ch = clamp_min(a.culvert_h[rc], k1em12);
      const float crough = clamp_min(a.culvert_rough[rc], k1em12);
      const float cslope = clamp_min(a.bslope[i], 0.0f);
      // the reference's verbatim 0.5*(H - Hold) - z (water.cpp:760)
      const float wl = (f & kCulvertCompat) ? 0.5f * (psi - psi_old) - a.z32[rc]
                                            : 0.5f * (psi + psi_old);
      const float eq_diam = sqrtf(((4.0f * cw) * ch) / kPi);
      const float pressure =
          ((70.0f * power(cslope, k054)) * power(eq_diam, k263)) / kHazen;
      const float bsize = a.bsize[i];
      const float hr_full = bsize / clamp_min(cw + 2.0f * ch, k1em12);
      const float manning_full =
          ((bsize / crough) * sqrtf(cslope)) * power(hr_full, kTwoThirds);
      const float mix_w = clamp((wl - ch) / (0.5f * ch), 0.0f, 1.0f);
      const float mixed = mix_w * pressure + (1.0f - mix_w) * manning_full;
      const float wl0 = clamp_min(wl, 0.0f);
      const float oc_area = cw * wl0;
      const float hr_open = oc_area / clamp_min(cw + 2.0f * wl0, k1em12);
      const float open_flow =
          ((oc_area / crough) * sqrtf(cslope)) * power(hr_open, kTwoThirds);
      const float pond = static_cast<float>(a.pond[rc]);
      const float cflow =
          wl >= 1.5f * ch ? pressure
                          : (wl >= ch ? mixed : (wl > pond ? open_flow : 0.0f));
      rate = -cflow;
    }
  }
  // rates below DBL_EPSILON are zeroed, as the reference does
  rate = fabsf(rate) < kDblEps ? 0.0f : rate;

  a.k[i] = k;
  a.diag[i] = cap;
  a.rate[i] = rate;
}

// the surface head of a layer-0 cell with the approx-0 rainfall predictor
__device__ __forceinline__ float surface_head(const AssembleArgs& a, int64_t j, float dt,
                                              bool first) {
  const float wf0 = a.flow0[j] + a.rate[j];
  const float avg0 = 0.5f * (a.psi[j] + a.psi_old[j]);
  return avg0 + ((wf0 > 0.0f && first) ? ((0.5f * wf0) * dt) / a.volume[j] : 0.0f);
}

__device__ __forceinline__ int lat_dr(int k) {
  return (k == 0 || k == 4 || k == 5) ? -1 : ((k == 1 || k == 6 || k == 7) ? 1 : 0);
}
__device__ __forceinline__ int lat_dc(int k) {
  return (k == 2 || k == 4 || k == 6) ? -1 : ((k == 3 || k == 5 || k == 7) ? 1 : 0);
}

// pass 2: one (row, col) column a thread, its layers walked in registers
__global__ void __launch_bounds__(kTC * kTR, 4) assemble_pass2_kernel(const AssembleArgs a) {
  __shared__ float s_v[kHalo];         // layer 0: surface heads
  __shared__ float s_pond[kHalo];
  __shared__ float s_rough[kHalo];
  __shared__ float s_k[2][kHalo];      // layer l (in l % 2): k x lvr, clamped
  __shared__ uint8_t s_mk[2][kHalo];   // layer l's mask
  __shared__ unsigned int s_cmax[kTR];

  const int L = a.L, R = a.R, C = a.C;
  const int f = a.flags;
  const int mean_type = (f >> kMeanShift) & 3;
  const int tid = threadIdx.y * kTC + threadIdx.x;
  const int r0 = blockIdx.y * kTR;
  const int c0 = blockIdx.x * kTC;
  const int r = r0 + threadIdx.y;
  const int c = c0 + threadIdx.x;
  const bool in = r < R && c < C;
  const int64_t plane = static_cast<int64_t>(R) * C;
  const int64_t rc = in ? static_cast<int64_t>(r) * C + c : 0;
  const int ci = (threadIdx.y + 1) * kHW + threadIdx.x + 1;
  const float dt = step_dt(a);
  const bool first = step_first(a);

  // the ring-grown tile: each thread holds up to kSlots of its cells, whose
  // next layer's k and mask it fetches into registers while this layer
  // computes
  int64_t slot_j[kSlots];   // the cell's (row, col) offset, -1 past the box
  int slot_h[kSlots];
  for (int s = 0; s < kSlots; ++s) {
    const int h = tid + s * kTC * kTR;
    const int gr = r0 + h / kHW - 1;
    const int gc = c0 + h % kHW - 1;
    slot_h[s] = h < kHalo ? h : -1;
    slot_j[s] = (h < kHalo && gr >= 0 && gr < R && gc >= 0 && gc < C)
                    ? static_cast<int64_t>(gr) * C + gc
                    : -1;
  }
  float next_k[kSlots];
  uint8_t next_m[kSlots];
  for (int s = 0; s < kSlots; ++s) {
    const int64_t j = slot_j[s];
    if (slot_h[s] < 0) continue;
    float hv = 0.0f, pond = 0.0f, rough = 0.0f;
    uint8_t m = 0;
    if (j >= 0) {
      m = a.mask[j];
      hv = surface_head(a, j, dt, first);
      pond = static_cast<float>(a.pond[j]);
      rough = a.roughness[j];
    }
    s_v[slot_h[s]] = hv;
    s_pond[slot_h[s]] = pond;
    s_rough[slot_h[s]] = rough;
    s_mk[0][slot_h[s]] = m;
    // layer 1's ring, stored after layer 0 is done
    next_k[s] = j >= 0 ? a.k[plane + j] : 0.0f;
    next_m[s] = j >= 0 ? a.mask[plane + j] : 0;
  }
  __syncthreads();

  float dz[8], ld3[8], alat[8];
  unsigned int cmax = 0;  // the float bits of the column's largest Courant number
  float infil = 0.0f;
  float k_cur = 0.0f;
  bool m_cur = false;
  if (in) {
    for (int idx = 0; idx < 8; ++idx) {
      dz[idx] = a.dz_lat[idx * plane + rc];
      ld3[idx] = a.lat_dist3d[idx * plane + rc];
      alat[idx] = 0.0f;
    }
    k_cur = a.k[rc];
    m_cur = s_mk[0][ci];
    if (m_cur) {
      // surface runoff conductances and the Courant number (offset space)
      const float hi = s_v[ci];
      const float pond_i = s_pond[ci];
      const float rough_i = s_rough[ci];
      const float lat_area0 = a.lat_area[0];
      for (int idx = 0; idx < 8; ++idx) {
        const int j = ci + lat_dr(idx) * kHW + lat_dc(idx);
        const float hj = s_v[j];
        const float hs = t_max(hi, hj + dz[idx]) - t_max(pond_i, s_pond[j] + dz[idx]);
        const float dxy = a.lat_dist2d[idx];
        const float rough_ij = 0.5f * (rough_i + s_rough[j]);
        const float hs23 = power(clamp_min(hs, 0.0f), kTwoThirds);
        float a_surface = ((lat_area0 * hs) * hs23) / (rough_ij * dxy);
        const bool invalid = (hs <= kEpsMeter) || (rough_ij <= 0.0f);
        a_surface = invalid ? 0.0f : a_surface;
        float dh = fabsf((hi - hj) - dz[idx]);
        // the reference's integer abs (water.cpp:477)
        if (f & kCourantCompat) dh = truncf(dh);
        const float slope = dh > kEpsMeter ? dh / dxy : 0.0f;
        const float vv = (hs23 * sqrtf(slope)) / rough_ij;
        const bool nbr_ok = s_mk[0][j];
        const float cour = (invalid || !nbr_ok) ? 0.0f : (vv * dt) / dxy;
        cmax = max(cmax, __float_as_uint(cour));
        alat[idx] = nbr_ok ? a_surface : 0.0f;
      }
      if (a.mask[plane + rc]) {
        // infiltration, the link (0, 1)
        const float psi1 = a.psi[plane + rc];
        const float avg0 = 0.5f * (a.psi[rc] + a.psi_old[rc]);
        const float avg1 = 0.5f * (psi1 + a.psi_old[plane + rc]);
        const float wf0 = a.flow0[rc] + a.rate[rc];
        const float dist01 = static_cast<float>(a.vert_dist[1]);
        const int bt1 = a.btype[plane + rc];
        float bf = bt1 == kRoad ? 0.0f : 1.0f;
        bf = bt1 == kUrban ? kUrbanFactor : bf;
        const float ksat1 = a.k_sat[plane + rc];
        const float area = a.area[0];
        const float sat_val = ((ksat1 * bf) * area) / dist01;
        float sw = clamp_min(avg0, 0.0f);
        sw = wf0 < 0.0f ? clamp_min(sw + (wf0 * dt) / a.volume[rc], 0.0f) : sw;
        const float max_inf = sw / dt;
        const float dh01 = clamp_min((avg0 - avg1) + dist01, k1em12);
        const float max_k = (max_inf * dist01) / dh01;
        const float mean01 = mean(ksat1, clamp_min(a.k[plane + rc], k1em30), mean_type);
        const float unsat =
            max_inf < kMinInfil ? 0.0f : (t_min(bf * mean01, max_k) * area) / dist01;
        infil = psi1 > dist01 ? sat_val : unsat;
      }
    }
  }

  float a_up = 0.0f;  // a_up of the layer the walk is at
  for (int l = 0; l < L; ++l) {
    const int buf = l & 1;
    if (l > 0) {
      // layer l's ring, fetched during layer l - 1
      for (int s = 0; s < kSlots; ++s) {
        if (slot_h[s] < 0) continue;
        s_k[buf][slot_h[s]] = slot_j[s] >= 0 ? clamp_min(next_k[s] * a.lvr, k1em30) : 0.0f;
        s_mk[buf][slot_h[s]] = next_m[s];
      }
      __syncthreads();
      if (l + 1 < L) {
        for (int s = 0; s < kSlots; ++s) {
          const int64_t j = slot_j[s];
          next_k[s] = j >= 0 ? a.k[(l + 1) * plane + j] : 0.0f;
          next_m[s] = j >= 0 ? a.mask[(l + 1) * plane + j] : 0;
        }
      }
    }
    if (!in) continue;
    const int64_t i = l * plane + rc;
    if (l > 0) {
      // lateral redistribution
      const float ks = s_k[buf][ci];
      const float la = a.lat_area[l];
      for (int idx = 0; idx < 8; ++idx) {
        const int j = ci + lat_dr(idx) * kHW + lat_dc(idx);
        alat[idx] = (m_cur && s_mk[buf][j])
                        ? (mean(ks, clamp_min(s_k[buf][j], k1em30), mean_type) * la) / ld3[idx]
                        : 0.0f;
      }
    }
    // the link to the layer below, a_up of layer l + 1
    float a_down = 0.0f;
    float k_next = 0.0f;
    bool m_next = false;
    if (l + 1 < L) {
      k_next = a.k[i + plane];
      m_next = a.mask[i + plane];
      if (m_next && m_cur) {
        a_down = l == 0 ? infil
                        : (mean(clamp_min(k_next, k1em30), clamp_min(k_cur, k1em30), mean_type) *
                           a.area[0]) /
                              vert_dist(a, l + 1);
      }
    }

    const float cap_dt = a.diag[i] / dt;
    const float wf = (l == 0 ? a.flow0[rc] : a.water_flow[i]) + a.rate[i];
    a.water_flow[i] = wf;
    float lat = alat[0];
    for (int idx = 1; idx < 8; ++idx) lat = lat + alat[idx];
    float diag = cap_dt + ((a_up + a_down) + lat);
    diag = m_cur ? diag : 1.0f;
    const float rhs = (f & kExtraHook) ? wf + a.extra[i] : wf;
    float b = cap_dt * a.psi_old[i] + rhs;
    b = (b + a_up * vert_dist(a, l)) - a_down * vert_dist(a, (l + 1) % L);
    for (int idx = 0; idx < 8; ++idx) b = b + alat[idx] * dz[idx];
    b = m_cur ? b : 0.0f;
    const float inv = 1.0f / diag;
    a.b[i] = b * inv;
    a.c_up[i] = a_up * inv;
    a.c_down[i] = a_down * inv;
    for (int idx = 0; idx < 8; ++idx) a.c_lat[idx * plane * L + i] = alat[idx] * inv;
    a.diag[i] = diag;

    a_up = a_down;
    k_cur = k_next;
    m_cur = m_next;
  }

  // the block's largest Courant number, folded into the word by its bits
  cmax = __reduce_max_sync(0xffffffffu, cmax);
  if (threadIdx.x == 0) s_cmax[threadIdx.y] = cmax;
  __syncthreads();
  if (tid == 0) {
    unsigned int m = s_cmax[0];
    for (int w = 1; w < kTR; ++w) m = max(m, s_cmax[w]);
    const double d = static_cast<double>(__uint_as_float(m));
    atomicMax(reinterpret_cast<unsigned long long*>(a.courant),
              static_cast<unsigned long long>(__double_as_longlong(d)));
  }
}

bool bad_args(const AssembleArgs* a) {
  return a == nullptr || a->L < 2 || a->R < 1 || a->C < 1 ||
         static_cast<int64_t>(a->L) * a->R * a->C > (int64_t{1} << 40);
}

}  // namespace

// Pass 1 on `stream`: k, the rate, the capacity (in diag), the flow (in
// water_flow, layer 0 in flow0); resets the Courant word. Returns the CUDA
// error of the launch (0 on success).
extern "C" int c3d_assemble_pass1(const AssembleArgs* args, void* stream) {
  if (bad_args(args)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(args->L) * args->R * args->C;
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads1 - 1) / kThreads1);
  assemble_pass1_kernel<<<blocks, kThreads1, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 on `stream`: the stencil, the water flow and the Courant number,
// reading pass 1's outputs and the rate with the boundary hook added.
extern "C" int c3d_assemble_pass2(const AssembleArgs* args, void* stream) {
  if (bad_args(args)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((args->C + kTC - 1) / kTC, (args->R + kTR - 1) / kTR);
  const dim3 block(kTC, kTR);
  assemble_pass2_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(AssembleArgs), for the wrapper to check its layout against.
extern "C" int c3d_assemble_args_size() { return static_cast<int>(sizeof(AssembleArgs)); }
