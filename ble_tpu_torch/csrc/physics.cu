// Fused balloon physics substeps for Hopper (sm_90a).
//
// Replaces the TPU kernel ble_tpu/ops/pallas_physics.py:simulate_substeps_fused
// (kernel _kernel, helper _at_pressure_layers_leading). For each env, N
// substeps of balloon.substep_math run in registers: advection, buoyancy and
// drag ascent with the closed-form dp/dh, the 7-layer at_pressure, the NOAA
// solar model, the thermal ODE, the superpressure/volume solve, ACS venting
// and compressing, and the battery. Balloons whose status is not OK freeze.
// The safety remap runs outside, in torch (ops/physics.py).
//
// Bound: ~256 B of traffic per env (1 MB at 4096 envs, well under a
// microsecond at 3.35 TB/s) against ~18 x 1000 float operations, many of
// them transcendentals. Each env's substeps are one serial dependency
// chain, so the kernel is bound by that chain's latency, not by any
// unit's throughput.
//
// Design: the sun is taken off the chain. A substep reads lat/lng and the
// NOAA solar model (two thirds of its operations) at its *starting* x, y
// and time only, and those advance by constants the loop does not change
// (x, y by the step's fixed wind times dt, time by the stride). So each CTA
// of G envs (G from ops/physics.py:env_split, at most 32) runs two phases:
//   1. the solar track, all threads: for each (env, substep) pair, x and y
//      by the loop's own sequence of additions, lat/lng, the solar
//      elevation and flux, and the terms of the attenuation and the panel
//      power that depend on the elevation alone (614 sin(el), the two
//      cos x shadow terms), into shared memory, 20 bytes a pair;
//   2. the serial chain, one thread per env, in registers, reading the
//      track instead of recomputing it.
// Substeps past an env's first non-OK status are computed in phase 1 and
// never read. More than 18 substeps run as chunks of 18, one track each.
// Each thread loads its 16 + 3 float/int state fields, 23 atmosphere
// values, 2 winds and the action once (structure-of-arrays rows, so a
// warp's loads coalesce); the atmosphere's layer is picked by an unrolled
// select, which keeps the 23 values in registers. The ACS efficiency table
// and the layer heights sit in __constant__ memory; the fleet-uniform
// BalloonParams arrive as a by-value struct.
//
// Numerics: built with --fmad=false so that every multiply and add rounds
// on its own, as the plain PyTorch version's separate elementwise ops do;
// contracting them into FMAs would drift from it through 18 substeps of the
// superpressure solve. expf/logf/sinf/cosf/sqrtf are the accurate ones (no
// --use_fast_math). Constants are written as double literals cast to float,
// which is how Python-float constants reach float32 in the plain version;
// products of two constants are formed in double and rounded once, as
// Python does. The two phases perform the same operations on the same
// values as one thread running the loop alone, so they give the same bits.

#include <cuda_runtime.h>

#define F(x) ((float)(x))

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr double kGravity = 9.80665;
constexpr double kRUniv = 8.3144621;
constexpr double kDryAirMolarMass = 0.028964922481160;
constexpr double kHeMolarMass = 0.004002602;
constexpr double kRDry = kRUniv / kDryAirMolarMass;
constexpr double kEarthRadiusM = 6371.0 * 1000.0;
constexpr double kDeg = kPi / 180.0;
constexpr double kRad = 180.0 / kPi;
constexpr double kMinSolarElDeg = -4.242;
// atan2(sqrt(h * (10.41603 + h)), 8.69275) in degrees for h = 3.3, 2.7.
constexpr double kShadowElDeg33 = 37.738149050524044;
constexpr double kShadowElDeg27 = 34.39486500086289;
constexpr double kShadowFactor = 0.4392;

constexpr int kNumF32 = 16;
constexpr int kNumI32 = 3;
constexpr int kNumAtmo = 23;
constexpr int kNumLayers = 7;
constexpr int kStatusOk = 0, kStatusOutOfPower = 1, kStatusBurst = 2,
              kStatusZeroPressure = 3;
constexpr int kDown = 0, kUp = 2;
// Envs a CTA (ops/physics.py:MAX_ENVS_PER_CTA) and substeps a solar track.
constexpr int kMaxEnvsPerCta = 32;
constexpr int kChunk = 18;
constexpr int kMaxThreads = kMaxEnvsPerCta * kChunk;

__constant__ float kHeights[8] = {
    F(-610.0), F(17000.0), F(21000.0), F(32000.0),
    F(47000.0), F(51000.0), F(71000.0), F(85000.0)};

__constant__ float kEffTable[4][13] = {
    {F(0.4), F(0.4), F(0.3), F(0.2), F(0.2), F(0.0), F(0.0), F(0.0), F(0.0),
     F(0.0), F(0.0), F(0.0), F(0.0)},
    {F(0.4), F(0.3), F(0.3), F(0.30), F(0.25), F(0.23), F(0.20), F(0.15),
     F(0.12), F(0.10), F(0.0), F(0.0), F(0.0)},
    {F(0.0), F(0.3), F(0.25), F(0.25), F(0.25), F(0.20), F(0.20), F(0.20),
     F(0.2), F(0.15), F(0.13), F(0.12), F(0.11)},
    {F(0.0), F(0.23), F(0.23), F(0.23), F(0.23), F(0.23), F(0.20), F(0.20),
     F(0.20), F(0.18), F(0.16), F(0.15), F(0.13)}};

// Field order of the (16, E) float rows and (3, E) int rows; matches
// balloon.SUBSTEP_F32_FIELDS / SUBSTEP_I32_FIELDS.
enum F32Field {
  kX, kY, kPressure, kAmbientT, kInternalT, kMolsAir, kVolume, kSuperpressure,
  kAcsPower, kAcsMassFlow, kSolarCharging, kPowerLoad, kBattery, kUpwellingIr,
  kCenterLat, kCenterLng
};
enum I32Field { kTime, kTimeElapsed, kStatus };

struct Params {
  float envelope_volume_base;
  float envelope_volume_dv_pressure;
  float envelope_mass;
  float envelope_max_superpressure;
  float envelope_cod;
  float payload_mass;
  float nighttime_power_load_w;
  float daytime_power_load_w;
  float acs_valve_hole_diameter_m;
  float battery_capacity_j;
  float mols_lift_gas;
};
constexpr int kNumParams = 11;

// --- ops/pmath.py ---------------------------------------------------------

__device__ float ipow2(float x) { return x * x; }
__device__ float ipow3(float x) { return x * (x * x); }
__device__ float ipow5(float x) {
  float x2 = x * x;
  return x * (x2 * x2);
}

__device__ float atan_poly(float x) {
  float t = x * x;
  float p = F(-0.0040540580);
  p = p * t + F(0.0218612288);
  p = p * t - F(0.0559098861);
  p = p * t + F(0.0964200441);
  p = p * t - F(0.1390853351);
  p = p * t + F(0.1994653599);
  p = p * t - F(0.3332985605);
  p = p * t + F(0.9999993329);
  return x * p;
}

__device__ float pm_atan(float x) {
  float inv = 1.0f / (x == 0.0f ? 1.0f : x);
  float sign = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  float outer = sign * F(kPi / 2.0) - atan_poly(inv);
  return fabsf(x) > 1.0f ? outer : atan_poly(x);
}

__device__ float pm_atan2(float y, float x) {
  float base = pm_atan(y / (x == 0.0f ? 1.0f : x));
  float result = x > 0.0f ? base : (y >= 0.0f ? base + F(kPi) : base - F(kPi));
  float on_axis = y > 0.0f ? F(kPi / 2.0) : (y < 0.0f ? -F(kPi / 2.0) : 0.0f);
  return x == 0.0f ? on_axis : result;
}

__device__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ float pm_asin(float x) {
  x = clampf(x, -1.0f, 1.0f);
  return pm_atan2(x, sqrtf(fmaxf((1.0f - x) * (1.0f + x), 0.0f)));
}

__device__ float pm_acos(float x) { return F(kPi / 2.0) - pm_asin(x); }

__device__ float pm_tan(float x) { return sinf(x) / cosf(x); }

__device__ float pm_fmod(float a, float b) { return a - truncf(a / b) * b; }

__device__ float pm_powf(float x, float p) {
  return x > 0.0f ? expf(p * logf(fmaxf(x, F(1e-30)))) : 0.0f;
}

// --- utils/time_lib.py ----------------------------------------------------

__device__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ void days_from_j2000(int time_s, float* jd_out, float* frac_out) {
  int days = floordiv(time_s, 86400);
  int second_of_day = time_s - days * 86400;
  int z = days + 719468;
  int era = floordiv(z >= 0 ? z : z - 146096, 146097);
  int doe = z - era * 146097;
  int yoe = floordiv(doe - floordiv(doe, 1460) + floordiv(doe, 36524) -
                         floordiv(doe, 146096), 365);
  int y = yoe + era * 400;
  int doy = doe - (365 * yoe + floordiv(yoe, 4) - floordiv(yoe, 100));
  int mp = floordiv(5 * doy + 2, 153);
  int day = doy - floordiv(153 * mp + 2, 5) + 1;
  int month = mp < 10 ? mp + 3 : mp - 9;
  int year = month <= 2 ? y + 1 : y;

  float yf = (float)year;
  float mf = (float)month;
  float t1 = 367.0f * yf;
  float t2 = floorf(7.0f * (yf + floorf((mf + 9.0f) / 12.0f)) / 4.0f);
  float t3 = floorf(3.0f * (floorf((yf + (mf - 9.0f) / 7.0f) / 100.0f) + 1.0f) /
                    4.0f);
  float t4 = floorf(275.0f * mf / 9.0f);
  float int_part = t1 - t2 - t3 + t4 + (float)day;
  float frac = (float)second_of_day / 86400.0f;
  *frac_out = frac;
  *jd_out = (int_part - F(730516.5)) + frac;
}

// --- env/solar.py ---------------------------------------------------------

__device__ void solar_calculator(float lat, float lng, int time_s,
                                 float* el_out, float* flux_out) {
  const float deg = F(kDeg), rad = F(kRad);
  float jd, fraction_of_day;
  days_from_j2000(time_s, &jd, &fraction_of_day);
  float jc = jd / F(36525.0);

  float gml = (F(280.46646) + jc * (F(36000.76983) + jc * F(0.0003032))) * deg;
  float sin2l0 = sinf(2.0f * gml);
  float cos2l0 = cosf(2.0f * gml);
  float sin4l0 = sinf(4.0f * gml);

  float gma = (F(357.52911) + jc * (F(35999.05029) - F(0.0001537) * jc)) * deg;
  float sinm0 = sinf(gma);
  float sin2m0 = sinf(2.0f * gma);
  float sin3m0 = sinf(3.0f * gma);

  float moe = (23.0f + (26.0f + ((F(21.448) - jc * (F(46.815) + jc *
              (F(0.00059) - jc * F(0.001813))))) / 60.0f) / 60.0f) * deg;
  float oc = moe + (F(0.00256) * cosf((F(125.04) - F(1934.136) * jc) * deg)) *
             deg;
  float var_y = ipow2(pm_tan(oc / 2.0f));
  float ecc = F(0.016708634) - jc * (F(0.000042037) + F(0.0000001267) * jc);

  float eot = 4.0f * (var_y * sin2l0 - 2.0f * ecc * sinm0 +
                      4.0f * ecc * var_y * sinm0 * cos2l0 -
                      0.5f * var_y * var_y * sin4l0 -
                      1.25f * ecc * ecc * sin2m0);

  float ha_arg = pm_fmod(1440.0f * fraction_of_day + eot * rad +
                         4.0f * (lng * rad), 1440.0f);
  float ha = (ha_arg * deg) / 4.0f;
  ha = ha < 0.0f ? ha + F(kPi) : ha - F(kPi);

  float eoc = (sinm0 * (F(1.914602) - jc * (F(0.004817) + F(0.000014) * jc)) +
               sin2m0 * (F(0.019993) - F(0.000101) * jc) +
               sin3m0 * F(0.000289)) * deg;
  float tls = gml + eoc;
  float als = tls - (F(0.00569) - F(0.00478) *
                     sinf((F(125.04) - F(1934.136) * jc) * deg)) * deg;
  float decl = pm_asin(sinf(oc) * sinf(als));

  float cos_zenith = sinf(lat) * sinf(decl) +
                     cosf(lat) * cosf(decl) * cosf(ha);
  float zenith = pm_acos(clampf(cos_zenith, -1.0f, 1.0f));
  float elu = 90.0f - zenith * rad;

  float tan_seu = pm_tan(elu * deg);
  float safe_tan = fabsf(tan_seu) < F(1e-8)
                       ? (tan_seu < 0.0f ? F(-1e-8) : F(1e-8)) : tan_seu;
  float refr_high = F(58.1) / safe_tan - F(0.07) / ipow3(safe_tan) +
                    F(0.000086) / ipow5(safe_tan);
  float refr_mid = F(1735.0) + elu * (F(-518.2) + elu * (F(103.4) + elu *
                   (F(-12.79) + elu * F(0.711))));
  float refr_low = F(-20.772) / safe_tan;
  float refr = elu > 85.0f ? 0.0f
               : (elu > 5.0f ? refr_high
                  : (elu > F(-0.575) ? refr_mid : refr_low));
  *el_out = elu + refr / 3600.0f;
  *flux_out = F(1366.0) * (1.0f + 0.5f * (ipow2((1.0f + ecc) / (1.0f - ecc)) -
                                          1.0f) * cosf(gma));
}

// What a substep needs from the sun, at its starting position and time:
// the elevation (deg) and flux, and the terms of solar_attenuation and
// solar_power that depend on the elevation alone.
struct Sun {
  float el, flux;
  float sin_term;       // 614 sin(el)
  float panel35;        // 4 cos(el - 35) shadow(el, 3.3 m)
  float panel65;        // 2 cos(el - 65) shadow(el, 2.7 m)
};
constexpr int kNumSun = 5;

__device__ float shadow(float el_deg, float cutoff) {
  return el_deg >= cutoff ? F(kShadowFactor) : 1.0f;
}

__device__ float solar_attenuation(const Sun& sun, float pressure) {
  const float tmp = sun.sin_term;
  float airmass = F(0.34764) * (pressure / F(101325.0)) *
                  (sqrtf(F(1229.0) + tmp * tmp) - tmp);
  float att = 0.5f * (expf(F(-0.65) * airmass) + expf(F(-0.95) * airmass));
  return sun.el < F(kMinSolarElDeg) ? 0.0f : att;
}

__device__ float solar_power(const Sun& sun, float pressure) {
  float att = solar_attenuation(sun, pressure);
  return F(210.0) * att * (sun.panel35 + sun.panel65);
}

// --- env/thermal.py -------------------------------------------------------

__device__ float absorptivity_ir(float t) {
  return F(0.04587) + F(0.000232) * (t - 210.0f);
}

__device__ float total_absorptivity(float a) {
  float transmisivity = 1.0f - a - F(0.0291);
  return a * (1.0f + transmisivity / F(1.0 - 0.0291));
}

__device__ float d_balloon_temperature_dt(const Params& prm, float volume,
                                          float t_int, float t_amb,
                                          float pressure, const Sun& sun,
                                          float earth_flux) {
  float radius = pm_powf(3.0f * volume / F(4.0 * kPi), F(1.0 / 3.0));
  float area = F(4.0 * kPi) * radius * radius;

  float att = solar_attenuation(sun, pressure);
  const double a_s = 0.01435;
  const float solar_abs =
      F(a_s * (1.0 + (1.0 - a_s - 0.0291) / (1.0 - 0.0291)));
  float q_solar = sun.flux * att * F(0.25) * area * solar_abs;

  float earth_t = pm_powf(earth_flux / F(5.6704e-8), 0.25f);
  float q_earth = earth_flux * F(0.4605) * area *
                  total_absorptivity(absorptivity_ir(earth_t));

  float t2 = t_int * t_int;
  float q_emitted = F(5.6704e-8) * t2 * t2 * area *
                    total_absorptivity(absorptivity_ir(t_int));

  float viscosity = F(1.458e-6) * pm_powf(t_amb, 1.5f) / (t_amb + F(110.4));
  float conductivity = F(0.0241) * pm_powf(t_amb / F(273.15), F(0.9));
  float prandtl = F(0.804) - F(3.25e-4) * t_amb;
  float air_density = pressure * F(kDryAirMolarMass) / (F(kRUniv) * t_amb);
  float diam = 2.0f * radius;
  float grashof = (F(kGravity) * (air_density * air_density) *
                   (diam * diam * diam) / (t_amb * ipow2(viscosity))) *
                  fabsf(t_amb - t_int);
  float rayleigh = prandtl * grashof;
  float nusselt = 2.0f + F(0.457) * pm_powf(rayleigh, 0.25f) +
                  pm_powf(1.0f + F(2.69e-8) * rayleigh, F(1.0 / 12.0));
  float k_heat = nusselt * conductivity / (2.0f * radius);
  float q_convective = area * (k_heat * (t_amb - t_int));

  float heat_capacity = F(1500.0 * (double)prm.envelope_mass);
  return (q_solar + q_earth + q_convective - q_emitted) / heat_capacity;
}

// --- env/acs.py -----------------------------------------------------------

__device__ float most_efficient_power(float pressure_ratio) {
  const double kx[5] = {1.0, 1.05, 1.2, 1.25, 1.35};
  const double ky[5] = {100.0, 100.0, 300.0, 400.0, 400.0};
  float pr = clampf(pressure_ratio, F(kx[0]), F(kx[4]));
  float power = F(ky[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float seg = F(ky[i]) + (pr - F(kx[i])) *
                F((ky[i + 1] - ky[i]) / (kx[i + 1] - kx[i]));
    power = pr >= F(kx[i]) ? seg : power;
  }
  return fminf(power, F(ky[4]));
}

__device__ float fan_efficiency(float pr, float pw) {
  float cj = clampf(floorf((pr - F(1.05)) / F(0.025)), 0.0f, 11.0f);
  float wj = (pr - (F(1.05) + cj * F(0.025))) / F(0.025);
  float ci = clampf(floorf((pw - 100.0f) / 100.0f), 0.0f, 2.0f);
  float wi = (pw - (100.0f + ci * 100.0f)) / 100.0f;
  int r = (int)ci, c = (int)cj;
  float z00 = kEffTable[r][c], z01 = kEffTable[r][c + 1];
  float z10 = kEffTable[r + 1][c], z11 = kEffTable[r + 1][c + 1];
  return (1.0f - wi) * ((1.0f - wj) * z00 + wj * z01) +
         wi * ((1.0f - wj) * z10 + wj * z11);
}

// --- one substep (env/balloon.py:substep_math) ----------------------------

// The layer is picked by an unrolled select over the seven layers, not by
// indexing `atmo` at a runtime index, which would put the array in local
// memory; the values are the same.
__device__ void at_pressure_temperature(const float* atmo, float pressure,
                                        float* temperature) {
  const float* lapse = atmo;
  const float* temps = atmo + kNumLayers;
  const float* pres = atmo + 2 * kNumLayers + 1;
  int mask_sum = 0;
#pragma unroll
  for (int i = 0; i < kNumLayers; ++i) mask_sum += pressure > pres[i + 1];
  int idx = kNumLayers - mask_sum;
  // idx == kNumLayers: the top transition, with no lapse rate.
  float p0 = pres[kNumLayers], t0 = temps[kNumLayers], l0 = 0.0f;
  float h0 = kHeights[kNumLayers];
#pragma unroll
  for (int i = 0; i < kNumLayers; ++i) {
    const bool here = idx == i;
    p0 = here ? pres[i] : p0;
    t0 = here ? temps[i] : t0;
    l0 = here ? lapse[i] : l0;
    h0 = here ? kHeights[i] : h0;
  }
  const float r = F(kRDry), g = F(kGravity);
  float height;
  if (l0 == 0.0f) {
    height = (-r * t0 / g) * logf(pressure / p0) + h0;
  } else {
    height = (pm_powf(pressure / p0, -r * l0 / g) - 1.0f) * t0 / l0 + h0;
  }
  *temperature = t0 + l0 * (height - h0);
}

__device__ void latlng_from_offset(float clat, float clng, float x, float y,
                                   float* lat_out, float* lng_out) {
  float heading = pm_atan2(x, y);
  float angle = sqrtf(x * x + y * y) / F(kEarthRadiusM);
  float ca = cosf(angle), sa = sinf(angle);
  float sfl = sinf(clat), cfl = cosf(clat);
  float sin_lat = ca * sfl + sa * cfl * cosf(heading);
  float d_lng = pm_atan2(sa * cfl * sinf(heading), ca - sfl * sin_lat);
  float lat = pm_asin(clampf(sin_lat, -1.0f, 1.0f));
  *lat_out = clampf(lat, -F(kPi / 2.0), F(kPi / 2.0));
  float lng = clng + d_lng;
  *lng_out = lng - floorf((lng + F(kPi)) / F(2.0 * kPi)) * F(2.0 * kPi);
}

// The sun at offset (x, y) from (clat, clng) at time_s (phase 1).
__device__ Sun sun_at(float clat, float clng, float x, float y, int time_s) {
  float lat, lng;
  latlng_from_offset(clat, clng, x, y, &lat, &lng);
  Sun sun;
  solar_calculator(lat, lng, time_s, &sun.el, &sun.flux);
  sun.sin_term = 614.0f * sinf(sun.el * F(kDeg));
  sun.panel35 = 4.0f * cosf((sun.el - 35.0f) * F(kDeg)) *
                shadow(sun.el, F(kShadowElDeg33));
  sun.panel65 = 2.0f * cosf((sun.el - 65.0f) * F(kDeg)) *
                shadow(sun.el, F(kShadowElDeg27));
  return sun;
}

// One substep (phase 2) with the sun at its start taken from the track.
__device__ void substep(const Params& prm, const float* atmo, float wind_u,
                        float wind_v, int action, int stride_s,
                        const Sun& sun, float* v, int* vi) {
  const float dt = (float)stride_s;
  const float x = v[kX], y = v[kY], p = v[kPressure];
  const float t_amb = v[kAmbientT], t_int = v[kInternalT];
  const float mols_air = v[kMolsAir], volume = v[kVolume];
  const float sp = v[kSuperpressure], battery = v[kBattery];

  // Step 1: advection.
  float new_x = x + wind_u * dt;
  float new_y = y + wind_v * dt;

  // Step 2: buoyancy -> dh/dt -> dp/dt.
  float rho_air = (p * F(kDryAirMolarMass)) / (F(kRUniv) * t_amb);
  float drag = prm.envelope_cod * pm_powf(volume, F(2.0 / 3.0));
  float total_mass = F(kHeMolarMass * (double)prm.mols_lift_gas) +
                     F(kDryAirMolarMass) * mols_air + prm.envelope_mass +
                     prm.payload_mass;
  float direction = rho_air * volume >= total_mass ? 1.0f : -1.0f;
  float dh_dt = direction * sqrtf(fabsf(2.0f * (rho_air * volume - total_mass) *
                                        F(kGravity) / (rho_air * drag)));
  float new_t_amb;
  at_pressure_temperature(atmo, p, &new_t_amb);
  float dp_dh = -(F(kGravity) * p / (F(kRDry) * new_t_amb));
  float dp_dt = dp_dh * dh_dt;
  float new_p = p + dp_dt * dt;

  // Step 3: ambient + internal temperature.
  float d_int = d_balloon_temperature_dt(prm, volume, t_int, t_amb, p, sun,
                                         v[kUpwellingIr]);
  float new_t_int = t_int + d_int * dt;

  // Step 4: superpressure & volume.
  float unconstrained = (prm.mols_lift_gas + mols_air) * F(kRUniv) * t_int / p;
  float b = -(prm.envelope_volume_base - prm.envelope_volume_dv_pressure * p);
  float c = -(prm.envelope_volume_dv_pressure * unconstrained * p);
  float vol_inflated = 0.5f * (-b + sqrtf(b * b - 4.0f * c));
  float sp_inflated = p * unconstrained / vol_inflated - p;
  bool inflated = unconstrained > prm.envelope_volume_base;
  float new_volume = inflated ? vol_inflated : unconstrained;
  float new_sp = inflated ? sp_inflated : 0.0f;

  // Step 5: ACS.
  float sp_pos = fmaxf(sp, 0.0f);
  float pr = (p + sp_pos) / p;
  double d = prm.acs_valve_hole_diameter_m;
  float up_coeff = F(-0.62 * (kPi * (d * d) / 4.0));
  float gas_density = (sp + p) * (F(kDryAirMolarMass) / (F(kRUniv) * t_int));
  float up_mass_flow = up_coeff * sqrtf(2.0f * sp_pos * gas_density);
  float down_power = most_efficient_power(pr);
  float down_eff = fan_efficiency(pr, down_power);
  float down_mass_flow = down_eff * down_power / 3600.0f;
  float new_acs_power = action == kDown ? down_power : 0.0f;
  float new_acs_mass_flow =
      action == kUp ? up_mass_flow : (action == kDown ? down_mass_flow : 0.0f);
  float new_mols_air = fmaxf(
      mols_air + (new_acs_mass_flow / F(kDryAirMolarMass)) * dt, 0.0f);

  // Step 6: power & battery.
  bool is_day = sun.el > F(kMinSolarElDeg);
  float new_solar = is_day ? solar_power(sun, p) : 0.0f;
  float new_load = (is_day ? prm.daytime_power_load_w
                           : prm.nighttime_power_load_w) + new_acs_power;
  float new_battery = clampf(battery + (new_solar - new_load) * dt, 0.0f,
                             prm.battery_capacity_j);

  int status = kStatusOk;
  if (new_sp > prm.envelope_max_superpressure) status = kStatusBurst;
  if (new_sp <= 0.0f) status = kStatusZeroPressure;
  if (new_battery <= 0.0f) status = kStatusOutOfPower;

  v[kX] = new_x;
  v[kY] = new_y;
  v[kPressure] = new_p;
  v[kAmbientT] = new_t_amb;
  v[kInternalT] = new_t_int;
  v[kMolsAir] = new_mols_air;
  v[kVolume] = new_volume;
  v[kSuperpressure] = new_sp;
  v[kAcsPower] = new_acs_power;
  v[kAcsMassFlow] = new_acs_mass_flow;
  v[kSolarCharging] = new_solar;
  v[kPowerLoad] = new_load;
  v[kBattery] = new_battery;
  vi[kTime] += stride_s;
  vi[kTimeElapsed] += stride_s;
  vi[kStatus] = status;
}

__global__ void __launch_bounds__(kMaxThreads)
physics_substeps_kernel(const float* __restrict__ f32_in,
                        const int* __restrict__ i32_in,
                        const float* __restrict__ atmo_in,
                        const float* __restrict__ wind_in,
                        const int* __restrict__ action_in,
                        float* __restrict__ f32_out,
                        int* __restrict__ i32_out, int n, int num_substeps,
                        int stride_s, int envs_per_cta, Params prm) {
  // The solar track of one chunk: [substep][field][env], so that the
  // serial threads' reads of one field at one substep are consecutive.
  __shared__ float track[kChunk][kNumSun][kMaxEnvsPerCta];
  const int e0 = blockIdx.x * envs_per_cta;
  const int envs = min(envs_per_cta, n - e0);
  const int tid = threadIdx.x;
  const bool serial = tid < envs;  // this thread carries env e0 + tid
  const int e = e0 + tid;
  const float dt = (float)stride_s;

  float v[kNumF32];
  int vi[kNumI32];
  float atmo[kNumAtmo];
  float wind_u = 0.0f, wind_v = 0.0f;
  int action = 0;
  if (serial) {
#pragma unroll
    for (int i = 0; i < kNumF32; ++i) v[i] = f32_in[i * n + e];
#pragma unroll
    for (int i = 0; i < kNumI32; ++i) vi[i] = i32_in[i * n + e];
#pragma unroll
    for (int i = 0; i < kNumAtmo; ++i) atmo[i] = atmo_in[i * n + e];
    wind_u = wind_in[e];
    wind_v = wind_in[n + e];
    action = action_in[e];
  }

  for (int s0 = 0; s0 < num_substeps; s0 += kChunk) {
    const int chunk = min(kChunk, num_substeps - s0);
    // Phase 1: the sun at each (env, substep) pair of the chunk, for the
    // envs still OK at the start; x and y by the loop's own additions.
    for (int item = tid; item < envs * chunk; item += blockDim.x) {
      const int g = item % envs, s = item / envs, ee = e0 + g;
      if (i32_in[kStatus * n + ee] != kStatusOk) continue;
      const float wu = wind_in[ee], wv = wind_in[n + ee];
      float x = f32_in[kX * n + ee], y = f32_in[kY * n + ee];
      for (int k = 0; k < s0 + s; ++k) {
        x = x + wu * dt;
        y = y + wv * dt;
      }
      const Sun sun = sun_at(f32_in[kCenterLat * n + ee],
                             f32_in[kCenterLng * n + ee], x, y,
                             i32_in[kTime * n + ee] + (s0 + s) * stride_s);
      track[s][0][g] = sun.el;
      track[s][1][g] = sun.flux;
      track[s][2][g] = sun.sin_term;
      track[s][3][g] = sun.panel35;
      track[s][4][g] = sun.panel65;
    }
    __syncthreads();
    // Phase 2: the serial chain.
    if (serial) {
      for (int s = 0; s < chunk; ++s) {
        if (vi[kStatus] != kStatusOk) break;  // Terminal balloons freeze.
        const Sun sun{track[s][0][tid], track[s][1][tid], track[s][2][tid],
                      track[s][3][tid], track[s][4][tid]};
        substep(prm, atmo, wind_u, wind_v, action, stride_s, sun, v, vi);
      }
    }
    __syncthreads();
  }

  if (serial) {
#pragma unroll
    for (int i = 0; i < kNumF32; ++i) f32_out[i * n + e] = v[i];
#pragma unroll
    for (int i = 0; i < kNumI32; ++i) i32_out[i * n + e] = vi[i];
  }
}

}  // namespace

// f32_in (16, n), i32_in (3, n), atmo (23, n) = [lapse x7, temperature
// transitions x8, pressure transitions x8], wind (2, n), action (n,);
// params: 11 floats in Params order (host memory); envs_per_cta: G in
// [1, 32], each CTA's envs (ops/physics.py:env_split). Returns the launch's
// cudaGetLastError().
extern "C" int ble_physics_substeps(const float* f32_in, const int* i32_in,
                                    const float* atmo, const float* wind,
                                    const int* action, float* f32_out,
                                    int* i32_out, int n, int num_substeps,
                                    int stride_s, int envs_per_cta,
                                    const float* params,
                                    cudaStream_t stream) {
  if (envs_per_cta < 1 || envs_per_cta > kMaxEnvsPerCta)
    return (int)cudaErrorInvalidValue;
  Params prm;
  float* dst = reinterpret_cast<float*>(&prm);
  for (int i = 0; i < kNumParams; ++i) dst[i] = params[i];
  if (n > 0) {
    // Threads: every (env, substep) pair of a chunk, in whole warps.
    const int pairs =
        envs_per_cta * (num_substeps < kChunk ? num_substeps : kChunk);
    const int threads = pairs < 32 ? 32 : (pairs + 31) / 32 * 32;
    const int blocks = (n + envs_per_cta - 1) / envs_per_cta;
    physics_substeps_kernel<<<blocks, threads, 0, stream>>>(
        f32_in, i32_in, atmo, wind, action, f32_out, i32_out, n,
        num_substeps, stride_s, envs_per_cta, prm);
  }
  return (int)cudaGetLastError();
}
