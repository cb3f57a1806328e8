// One MHD constrained-transport step, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel ramses_tpu/mhd/pallas_ct.py::ct_step_slab, whose
// body is ramses_tpu/mhd/uniform.py::step_padded: ctoprim -> TVD slopes ->
// conservative Hancock half-step -> half-dt face field -> per-direction
// face fluxes (LLF, HLL, HLLD, Roe, upwind) -> edge EMFs by the
// Gardiner-Stone average or a 2D corner solver (llf, roe, upwind, hll,
// hlla, hlld), with an optional override -> induction update of the
// staggered faces and the conservative update of the cells (with an
// optional refined-cell mask on the cell fluxes).  1D, 2D and 3D, slope
// types 0/1/2/7/8, up to MAX_PASSIVE passive scalars, f32.  Every device
// function computes what the JAX function of the same name computes, in
// the same f32 arithmetic order, so the kernel and its plain version
// (mhd/ct_slab.py::ct_step_slab_ref) part only by nvcc's FMA contraction,
// and for the Roe solvers by the order of the 7x7 solve's sums.
//
// Contract (the padded one of step_padded, so that a halo-exchanged slab
// can be fed as it is): cells up[nvar][*sp+4] (B slots ignored), low faces
// bf[3][*sp+6]; per axis a padded cell P has face-box index P+1.  Outputs
// are the interior only, un[nvar][*sp] and bfn[3][*sp].
//
// What bounds it on an H100 (2048^2, 2D, hlld/llf): the function must read
// 8 cell and 3 face arrays and write 11, 0.32 GB, 0.095 ms at 3.35 TB/s;
// the arithmetic it needs, counted op by op on the plain version
// (chip_smoke.py), is 10.3 G f32 operations, 0.15 ms at 67 TFLOP/s:
// operations bound it.
//
// The fused design: one launch a step, every intermediate in shared
// memory or registers, each primitive, slope, predicted cell, face flux
// and edge EMF computed once per block that needs it.  A block owns a tile
// of columns and marches along axis 0 (the slow axis) over a chunk of rows
// (2D) or planes (3D); 1D is the same kernel with a single row whose
// columns are axis 0.  Tiles (Tile<ND>): 2D 126 columns of axis 1, 128
// threads; 3D 12 x 16 columns of axes 1 x 2, 384 threads; 1D 126 cells,
// 128 threads.  The chunk is chosen at launch from the box and the card
// (run(): 16 rows at 2048^2, 8 at 512^2).  The per-row work is laid over
// a "predicted grid" of the tile plus one column of halo on each side (QA
// x QB, for 2D 128 = the block's threads); primitives need one more (PA x
// PB).  At row t of the march, between three barriers:
//   A  each thread's own cell: the conservative and induction update of
//      row t-2 (of row t-1 in 1D) from the fluxes of faces t-2 and t-1
//      and the EMFs of edge rows t-2 and t-1, and the column fluxes'
//      update terms of row t-1; then the predicted cells of row t:
//      slopes in every direction, the Hancock half-step du_half, the
//      half-step primitives q_half and the half-dt faces bf_half (edge0
//      quarter-sums from the primitives) of every cell of the predicted
//      grid;
//   B  face fluxes: along the marching axis through face t (between rows
//      t-1 and t), and along each column axis in row t;
//   C  edge EMFs: the pairs with the marching axis on edge row t, the
//      (1,2) pair in row t (3D), then the override; the primitives of
//      row t+2 (for A of row t+1).
// Rings in shared memory (dynamic, sized from the passive count): 3 rows
// of primitives, 2 of predicted cells (slopes, du_half, q_half, bf_half),
// the marching flux components the EMFs read, a row of column fluxes and
// 2 of their component 5, 2 rows of passive fluxes a direction, 2 of EMFs
// a pair.  The rest of the fluxes stays in registers of the thread whose
// cell it updates (Rings).  A chunk starts with its first 3 rows of
// primitives and one warm-up row of predicted cells and column fluxes.
// Device memory sees the padded inputs (read by the primitive, predictor
// and update passes; the neighbouring tiles' halo again) and the interior
// outputs once: no scratch tensor.  2D, 8 variables: 53,952 B a block, 4
// blocks an SM (3 for the Roe kernels); 3D: 145,632 B (217,440 with 4
// passives), one block of 384 threads an SM, at most 170 registers (the
// Roe kernels spill).  The kernel is bound by latency, not by bytes or
// operations: fewer resident warps an SM slow it markedly (PERF.md), so
// the layout spends shared memory and registers to keep more warps.
//
// The bitwise rule.  A predicted cell, face flux or edge EMF in a tile's
// halo is computed by two blocks, and a row is a warm-up row in one chunk
// and a steady row in the next; a staggered face's new value is computed
// by the cells on both of its sides (each writes its centred B from it).
// Each such quantity must come out with the same bits wherever it is
// computed, or div B and the centred-B identity break at tile edges on
// the card, where nvcc contracts a*b+c into FMAs call site by call site.
// So every stage is one `#pragma unroll 1` loop body with one call site of
// its device function (one 1D solver, one corner solver, one induction a
// face component), run alike for halo and tile items, warm-up and steady
// rows; what differs between them is run-time data (directions, pairs,
// offsets, which results are kept).
//
// The Roe solver (face and corner) solves R alpha = dW for the wave
// strengths in each thread: Gaussian elimination with partial pivoting
// (the first row of largest |pivot|, as LAPACK's getrf picks it) on a 7x7
// array held in registers, rows swapped by selects so that no index is
// dynamic.  No library is called.  Offsets into device memory are 64-bit.

#include "muscl_common.cuh"   // slope(): K1's TVD limiter

namespace {

constexpr int NV = 8;            // MHD cell variables; passives follow
constexpr int MAX_PASSIVE = 4;   // the passive counts the kernel takes
constexpr float EPS = 1e-30f;    // _EPS of mhd/riemann.py, roe.py, riemann2d.py
constexpr float ISQ2 = 0.70710678118654752f;   // roe.py's 1/sqrt(2)

struct MConsts {
  float gamma, gm1, g2, ig1, smallr, smallc, smallc2, pfloor, eint_floor;
  float slope;      // the limiter factor of slope types 1, 2, 8
  int slope_type;   // 0, 1, 2, 7 or 8
  float dx[3];
};

// Padded-box geometry by physical axis.  Unused axes have extent 1 and
// stride 0.
struct Geo {
  int e[3];         // padded cell extents n + 4
  int64_t s[3];     // cell strides
  int64_t np;       // padded cells
  int64_t fs[3];    // face-box strides (extents n + 6)
  int64_t nf;       // face-box points
  int64_t is[3];    // interior strides (extents n)
  int64_t ni;       // interior cells
  int nv;           // cell variables: 8 + passives
  int ch;           // rows of axis 0 a block updates
};

__device__ __forceinline__ float sign0(float x) {  // jnp.sign: sign(0) = 0
  return (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
}

// hydro/muscl.uslope: types 1, 2 and 8 are K1's slope(); 0 is no slope;
// 7 is the van Leer harmonic mean (its guard's + 1e-300 is 0 in f32).
__device__ __forceinline__ float mslope(float ql, float q, float qr,
                                        const MConsts& k) {
  if (k.slope_type == 0) return 0.0f;
  if (k.slope_type == 7) {
    float dl = q - ql;
    float dr = qr - q;
    float prod = dl * dr;
    bool mono = prod > 0.0f;
    float den = mono ? dl + dr : 1.0f;
    float vl = 2.0f * prod / den;
    return mono ? vl : 0.0f;
  }
  return slope(ql, q, qr, k.slope);
}

// ---- mhd/core.py ----------------------------------------------------------

__device__ __forceinline__ void ctoprim(const float u[NV], const MConsts& k,
                                        float q[NV]) {
  float r = fmaxf(u[0], k.smallr);
  float inv_r = 1.0f / r;
  float v0 = u[1] * inv_r, v1 = u[2] * inv_r, v2 = u[3] * inv_r;
  float eken = 0.5f * ((v0 * v0 + v1 * v1) + v2 * v2);
  float emag = 0.5f * ((u[5] * u[5] + u[6] * u[6]) + u[7] * u[7]) * inv_r;
  float eint = fmaxf(u[4] * inv_r - eken - emag, k.eint_floor);
  q[0] = r;
  q[1] = v0;
  q[2] = v1;
  q[3] = v2;
  q[4] = k.gm1 * r * eint;
  q[5] = u[5];
  q[6] = u[6];
  q[7] = u[7];
}

__device__ __forceinline__ void prim_to_cons(const float q[NV],
                                             const MConsts& k, float u[NV]) {
  float r = fmaxf(q[0], k.smallr);
  float e = (q[4] / k.gm1 + 0.5f * r * ((q[1] * q[1] + q[2] * q[2]) + q[3] * q[3]))
            + 0.5f * ((q[5] * q[5] + q[6] * q[6]) + q[7] * q[7]);
  u[0] = r;
  u[1] = r * q[1];
  u[2] = r * q[2];
  u[3] = r * q[3];
  u[4] = e;
  u[5] = q[5];
  u[6] = q[6];
  u[7] = q[7];
}

// flux_along: the physical flux along axis D from primitives.
template <int D>
__device__ __forceinline__ void flux_along(const float q[NV], const MConsts& k,
                                           float f[NV]) {
  float r = fmaxf(q[0], k.smallr);
  const float* v = q + 1;
  const float* b = q + 5;
  float p = q[4];
  float b2 = (b[0] * b[0] + b[1] * b[1]) + b[2] * b[2];
  float ptot = p + 0.5f * b2;
  float vdotb = (v[0] * b[0] + v[1] * b[1]) + v[2] * b[2];
  float e = (p / k.gm1 + 0.5f * r * ((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]))
            + 0.5f * b2;
  float vd = v[D];
  f[0] = r * vd;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float fc = r * vd * v[c] - b[D] * b[c];
    f[1 + c] = (c == D) ? fc + ptot : fc;
  }
  f[4] = (e + ptot) * vd - b[D] * vdotb;
#pragma unroll
  for (int c = 0; c < 3; ++c) f[5 + c] = (c == D) ? 0.0f : vd * b[c] - v[c] * b[D];
}

// ---- mhd/riemann.py (rotated layout: r, vn, vt1, vt2, p, -, bt1, bt2) ------

__device__ __forceinline__ float fast(float r, float p, float bn, float bt1,
                                      float bt2, const MConsts& k) {
  float c2 = k.gamma * p / r;
  float b2 = ((bn * bn + bt1 * bt1) + bt2 * bt2) / r;
  float s = c2 + b2;
  float disc = sqrtf(fmaxf(s * s - 4.0f * c2 * (bn * bn) / r, 0.0f));
  return sqrtf(fmaxf(0.5f * (s + disc), k.smallc2));
}

__device__ __forceinline__ void cons1d(float r, float vn, float vt1, float vt2,
                                       float p, float bn, float bt1, float bt2,
                                       const MConsts& k, float u[NV]) {
  u[0] = r;
  u[1] = r * vn;
  u[2] = r * vt1;
  u[3] = r * vt2;
  u[4] = (p / k.gm1 + 0.5f * r * ((vn * vn + vt1 * vt1) + vt2 * vt2))
         + 0.5f * ((bn * bn + bt1 * bt1) + bt2 * bt2);
  u[5] = bn;
  u[6] = bt1;
  u[7] = bt2;
}

__device__ __forceinline__ void flux1d(float r, float vn, float vt1, float vt2,
                                       float p, float bn, float bt1, float bt2,
                                       const MConsts& k, float f[NV]) {
  float b2 = (bn * bn + bt1 * bt1) + bt2 * bt2;
  float ptot = p + 0.5f * b2;
  float vdotb = (vn * bn + vt1 * bt1) + vt2 * bt2;
  float e = (p / k.gm1 + 0.5f * r * ((vn * vn + vt1 * vt1) + vt2 * vt2)) + 0.5f * b2;
  f[0] = r * vn;
  f[1] = r * vn * vn - bn * bn + ptot;
  f[2] = r * vn * vt1 - bn * bt1;
  f[3] = r * vn * vt2 - bn * bt2;
  f[4] = (e + ptot) * vn - bn * vdotb;
  f[5] = 0.0f;
  f[6] = vn * bt1 - vt1 * bn;
  f[7] = vn * bt2 - vt2 * bn;
}

__device__ __forceinline__ void llf(const float ql[NV], const float qr[NV],
                                    float bn, const MConsts& k, float out[NV]) {
  float rl = fmaxf(ql[0], k.smallr), pl = fmaxf(ql[4], k.pfloor);
  float rr = fmaxf(qr[0], k.smallr), pr = fmaxf(qr[4], k.pfloor);
  float al = fast(rl, pl, bn, ql[6], ql[7], k) + fabsf(ql[1]);
  float ar = fast(rr, pr, bn, qr[6], qr[7], k) + fabsf(qr[1]);
  float a = fmaxf(al, ar);
  // fluxes and states take the unfloored pressure, as the JAX solver does
  float fl[NV], fr[NV], ul[NV], ur[NV];
  flux1d(rl, ql[1], ql[2], ql[3], ql[4], bn, ql[6], ql[7], k, fl);
  flux1d(rr, qr[1], qr[2], qr[3], qr[4], bn, qr[6], qr[7], k, fr);
  cons1d(rl, ql[1], ql[2], ql[3], ql[4], bn, ql[6], ql[7], k, ul);
  cons1d(rr, qr[1], qr[2], qr[3], qr[4], bn, qr[6], qr[7], k, ur);
#pragma unroll
  for (int v = 0; v < NV; ++v)
    out[v] = 0.5f * (fl[v] + fr[v]) - 0.5f * a * (ur[v] - ul[v]);
}

__device__ __forceinline__ void wave_bounds(const float ql[NV],
                                            const float qr[NV], float bn,
                                            const MConsts& k, float& rl,
                                            float& pl, float& rr, float& pr,
                                            float& SL, float& SR) {
  rl = fmaxf(ql[0], k.smallr);
  pl = fmaxf(ql[4], k.pfloor);
  rr = fmaxf(qr[0], k.smallr);
  pr = fmaxf(qr[4], k.pfloor);
  float cl = fast(rl, pl, bn, ql[6], ql[7], k);
  float cr = fast(rr, pr, bn, qr[6], qr[7], k);
  SL = fminf(ql[1] - cl, qr[1] - cr);
  SR = fmaxf(ql[1] + cl, qr[1] + cr);
}

__device__ __forceinline__ void hll(const float ql[NV], const float qr[NV],
                                    float bn, const MConsts& k, float out[NV]) {
  float rl, pl, rr, pr, SL, SR;
  wave_bounds(ql, qr, bn, k, rl, pl, rr, pr, SL, SR);
  float fl[NV], fr[NV], ul[NV], ur[NV];
  flux1d(rl, ql[1], ql[2], ql[3], pl, bn, ql[6], ql[7], k, fl);
  flux1d(rr, qr[1], qr[2], qr[3], pr, bn, qr[6], qr[7], k, fr);
  cons1d(rl, ql[1], ql[2], ql[3], pl, bn, ql[6], ql[7], k, ul);
  cons1d(rr, qr[1], qr[2], qr[3], pr, bn, qr[6], qr[7], k, ur);
  float SLc = fminf(SL, 0.0f);
  float SRc = fmaxf(SR, 0.0f);
  float den = SRc - SLc + EPS;
#pragma unroll
  for (int v = 0; v < NV; ++v)
    out[v] = (SRc * fl[v] - SLc * fr[v] + SLc * SRc * (ur[v] - ul[v])) / den;
}

// Miyoshi & Kusano (2005): every region's flux is computed, then selected.
__device__ __forceinline__ void hlld(const float ql[NV], const float qr[NV],
                                     float bn, const MConsts& k,
                                     float out[NV]) {
  float rl, pl, rr, pr, SL, SR;
  wave_bounds(ql, qr, bn, k, rl, pl, rr, pr, SL, SR);
  const float vnl = ql[1], vt1l = ql[2], vt2l = ql[3], bt1l = ql[6], bt2l = ql[7];
  const float vnr = qr[1], vt1r = qr[2], vt2r = qr[3], bt1r = qr[6], bt2r = qr[7];
  const float bn2 = bn * bn;
  float b2l = (bn2 + bt1l * bt1l) + bt2l * bt2l;
  float b2r = (bn2 + bt1r * bt1r) + bt2r * bt2r;
  float ptl = pl + 0.5f * b2l;
  float ptr = pr + 0.5f * b2r;

  float dl = rl * (SL - vnl);
  float dr = rr * (SR - vnr);
  float SM = (dr * vnr - dl * vnl - ptr + ptl) / (dr - dl + EPS);
  float pts = (dr * ptl - dl * ptr + dl * dr * (vnr - vnl)) / (dr - dl + EPS);

  // star states
  float rsl = dl / (SL - SM + EPS);
  float rsr = dr / (SR - SM + EPS);
  float denl = dl * (SL - SM) - bn2;
  float denr = dr * (SR - SM) - bn2;
  float tl = fabsf(SL) + fabsf(vnl);
  float tr = fabsf(SR) + fabsf(vnr);
  bool degl = fabsf(denl) < 1e-12f * (rl * (tl * tl) + bn2 + EPS);
  bool degr = fabsf(denr) < 1e-12f * (rr * (tr * tr) + bn2 + EPS);
  float sdl = degl ? 1.0f : denl;
  float sdr = degr ? 1.0f : denr;
  float vt1sl = degl ? vt1l : vt1l - bn * bt1l * (SM - vnl) / sdl;
  float vt2sl = degl ? vt2l : vt2l - bn * bt2l * (SM - vnl) / sdl;
  float bt1sl = degl ? bt1l : bt1l * (dl * (SL - vnl) - bn2) / sdl;
  float bt2sl = degl ? bt2l : bt2l * (dl * (SL - vnl) - bn2) / sdl;
  float vt1sr = degr ? vt1r : vt1r - bn * bt1r * (SM - vnr) / sdr;
  float vt2sr = degr ? vt2r : vt2r - bn * bt2r * (SM - vnr) / sdr;
  float bt1sr = degr ? bt1r : bt1r * (dr * (SR - vnr) - bn2) / sdr;
  float bt2sr = degr ? bt2r : bt2r * (dr * (SR - vnr) - bn2) / sdr;

  float el = (pl / k.gm1 + 0.5f * rl * ((vnl * vnl + vt1l * vt1l) + vt2l * vt2l))
             + 0.5f * b2l;
  float er = (pr / k.gm1 + 0.5f * rr * ((vnr * vnr + vt1r * vt1r) + vt2r * vt2r))
             + 0.5f * b2r;
  float vbl = (vnl * bn + vt1l * bt1l) + vt2l * bt2l;
  float vbsl = (SM * bn + vt1sl * bt1sl) + vt2sl * bt2sl;
  float vbr = (vnr * bn + vt1r * bt1r) + vt2r * bt2r;
  float vbsr = (SM * bn + vt1sr * bt1sr) + vt2sr * bt2sr;
  float esl = ((SL - vnl) * el - ptl * vnl + pts * SM + bn * (vbl - vbsl))
              / (SL - SM + EPS);
  float esr = ((SR - vnr) * er - ptr * vnr + pts * SM + bn * (vbr - vbsr))
              / (SR - SM + EPS);

  // Alfven (double-star) states
  float sq_rsl = sqrtf(fmaxf(rsl, k.smallr));
  float sq_rsr = sqrtf(fmaxf(rsr, k.smallr));
  float SLs = SM - fabsf(bn) / sq_rsl;
  float SRs = SM + fabsf(bn) / sq_rsr;
  float sgn = sign0(bn);
  float ssum = sq_rsl + sq_rsr + EPS;
  float vt1ss = (sq_rsl * vt1sl + sq_rsr * vt1sr + sgn * (bt1sr - bt1sl)) / ssum;
  float vt2ss = (sq_rsl * vt2sl + sq_rsr * vt2sr + sgn * (bt2sr - bt2sl)) / ssum;
  float bt1ss = (sq_rsl * bt1sr + sq_rsr * bt1sl
                 + sgn * sq_rsl * sq_rsr * (vt1sr - vt1sl)) / ssum;
  float bt2ss = (sq_rsl * bt2sr + sq_rsr * bt2sl
                 + sgn * sq_rsl * sq_rsr * (vt2sr - vt2sl)) / ssum;
  float vbssl = (SM * bn + vt1ss * bt1ss) + vt2ss * bt2ss;
  float essl = esl - sq_rsl * sgn * (vbsl - vbssl);
  float essr = esr + sq_rsr * sgn * (vbsr - vbssl);

  float ul[NV], ur[NV], fl[NV], fr[NV];
  cons1d(rl, vnl, vt1l, vt2l, pl, bn, bt1l, bt2l, k, ul);
  cons1d(rr, vnr, vt1r, vt2r, pr, bn, bt1r, bt2r, k, ur);
  flux1d(rl, vnl, vt1l, vt2l, pl, bn, bt1l, bt2l, k, fl);
  flux1d(rr, vnr, vt1r, vt2r, pr, bn, bt1r, bt2r, k, fr);
  // pack(r, vn, vt1, vt2, e, bt1, bt2) = [r, r vn, r vt1, r vt2, e, bn, bt1, bt2]
  const float usl[NV] = {rsl, rsl * SM, rsl * vt1sl, rsl * vt2sl, esl, bn, bt1sl, bt2sl};
  const float usr[NV] = {rsr, rsr * SM, rsr * vt1sr, rsr * vt2sr, esr, bn, bt1sr, bt2sr};
  const float ussl[NV] = {rsl, rsl * SM, rsl * vt1ss, rsl * vt2ss, essl, bn, bt1ss, bt2ss};
  const float ussr[NV] = {rsr, rsr * SM, rsr * vt1ss, rsr * vt2ss, essr, bn, bt1ss, bt2ss};
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float fsl = fl[v] + SL * (usl[v] - ul[v]);
    float fsr = fr[v] + SR * (usr[v] - ur[v]);
    float fssl = fsl + SLs * (ussl[v] - usl[v]);
    float fssr = fsr + SRs * (ussr[v] - usr[v]);
    out[v] = (SL > 0.0f) ? fl[v]
           : (SLs > 0.0f) ? fsl
           : (SM > 0.0f) ? fssl
           : (SRs > 0.0f) ? fssr
           : (SR > 0.0f) ? fsr : fr[v];
  }
}

// ---- mhd/roe.py (the same rotated layout; slot 5 unused) ------------------

// Cargo & Gallice (1997) averaged state and wave speeds (roe_mean).
struct RoeMean {
  float d, v0, v1, v2, bt1, bt2, a, asq, ca, cf, cs, b1h, b2h, alf, als, s;
};

__device__ __forceinline__ float roe_hside(const float q[NV], float r, float bn,
                                           const MConsts& k) {
  float b2 = (bn * bn + q[6] * q[6]) + q[7] * q[7];
  float e = (q[4] / k.gm1 + 0.5f * r * ((q[1] * q[1] + q[2] * q[2]) + q[3] * q[3]))
            + 0.5f * b2;
  return ((e + q[4]) + 0.5f * b2) / r;
}

__device__ __forceinline__ RoeMean roe_mean(const float ql[NV],
                                            const float qr[NV], float bn,
                                            const MConsts& k) {
  RoeMean m;
  const float g1 = k.gm1, g2 = k.g2;
  const float rl = ql[0], rr = qr[0];
  const float wl = sqrtf(rl), wr = sqrtf(rr);
  const float nrm = wl + wr;
  const float d = wl * wr;
  m.d = d;
  m.v0 = (wl * ql[1] + wr * qr[1]) / nrm;
  m.v1 = (wl * ql[2] + wr * qr[2]) / nrm;
  m.v2 = (wl * ql[3] + wr * qr[3]) / nrm;
  const float h = (wl * roe_hside(ql, rl, bn, k) + wr * roe_hside(qr, rr, bn, k))
                  / nrm;
  const float bt1 = (wl * qr[6] + wr * ql[6]) / nrm;
  const float bt2 = (wl * qr[7] + wr * ql[7]) / nrm;
  m.bt1 = bt1;
  m.bt2 = bt2;
  const float d6 = qr[6] - ql[6], d7 = qr[7] - ql[7];
  const float x = (d6 * d6 + d7 * d7) / (2.0f * (nrm * nrm));
  const float y = (rl + rr) / (2.0f * d);
  const float vsq = (m.v0 * m.v0 + m.v1 * m.v1) + m.v2 * m.v2;
  const float btsq = bt1 * bt1 + bt2 * bt2;
  const float bt_starsq = (g1 - g2 * y) * btsq;
  const float vaxsq = bn * bn / d;
  const float hp = h - (vaxsq + btsq / d);
  const float asq = fmaxf(g1 * (hp - 0.5f * vsq) - g2 * x, EPS);
  const float ct2 = bt_starsq / d;
  const float tsum = (vaxsq + ct2) + asq;
  const float tdif = (vaxsq + ct2) - asq;
  const float cf2_cs2 = sqrtf(tdif * tdif + 4.0f * asq * ct2);
  const float cfsq = 0.5f * (tsum + cf2_cs2);
  const float cssq = asq * vaxsq / fmaxf(cfsq, EPS);
  m.asq = asq;
  m.cf = sqrtf(cfsq);
  m.cs = sqrtf(cssq);
  m.a = sqrtf(asq);
  m.ca = sqrtf(vaxsq);
  const float bt = sqrtf(fmaxf(btsq, 0.0f));
  const bool deg_t = bt < 1e-12f * sqrtf(asq * d);   // no transverse field
  m.b1h = deg_t ? ISQ2 : bt1 / fmaxf(bt, EPS);
  m.b2h = deg_t ? ISQ2 : bt2 / fmaxf(bt, EPS);
  // alpha_f / alpha_s with the triple-umbilic conventions
  const float den = fmaxf(cfsq - cssq, EPS);
  const float af2 = fminf(fmaxf((asq - cssq) / den, 0.0f), 1.0f);
  const float as2 = fminf(fmaxf((cfsq - asq) / den, 0.0f), 1.0f);
  const bool degen = (cfsq - cssq) <= 1e-12f * asq;
  m.alf = degen ? 1.0f : sqrtf(af2);
  m.als = degen ? 0.0f : sqrtf(as2);
  m.s = (bn >= 0.0f) ? 1.0f : -1.0f;
  return m;
}

// Roe & Balsara (1996) primitive right eigenvectors R[row][wave], waves in
// the order fast-, Alfven-, slow-, entropy, slow+, Alfven+, fast+.
__device__ __forceinline__ void roe_eigenvectors(const RoeMean& m,
                                                 float R[7][7]) {
  const float sqd = sqrtf(m.d);
  const float dbt1 = -m.b2h * sqd, dbt2 = m.b1h * sqd;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const float sgn = side ? 1.0f : -1.0f;
    const int kf = side ? 6 : 0, ka = side ? 5 : 1, ks = side ? 4 : 2;
    // fast
    R[0][kf] = m.d * m.alf;
    R[1][kf] = sgn * m.cf * m.alf;
    R[2][kf] = -sgn * m.cs * m.als * m.b1h * m.s;
    R[3][kf] = -sgn * m.cs * m.als * m.b2h * m.s;
    R[4][kf] = m.d * m.asq * m.alf;
    R[5][kf] = m.als * sqd * m.a * m.b1h;
    R[6][kf] = m.als * sqd * m.a * m.b2h;
    // Alfven
    R[0][ka] = 0.0f;
    R[1][ka] = 0.0f;
    R[2][ka] = -sgn * m.s * dbt1 / sqd;
    R[3][ka] = -sgn * m.s * dbt2 / sqd;
    R[4][ka] = 0.0f;
    R[5][ka] = dbt1;
    R[6][ka] = dbt2;
    // slow
    R[0][ks] = m.d * m.als;
    R[1][ks] = sgn * m.cs * m.als;
    R[2][ks] = sgn * m.cf * m.alf * m.b1h * m.s;
    R[3][ks] = sgn * m.cf * m.alf * m.b2h * m.s;
    R[4][ks] = m.d * m.asq * m.als;
    R[5][ks] = -m.alf * sqd * m.a * m.b1h;
    R[6][ks] = -m.alf * sqd * m.a * m.b2h;
  }
#pragma unroll
  for (int r = 0; r < 7; ++r) R[r][3] = (r == 0) ? 1.0f : 0.0f;   // entropy
}

// b := A^-1 b by Gaussian elimination with partial pivoting: in column c
// the first row at or below c of largest |A[r][c]| becomes the pivot.
// Every index is a compile-time constant; rows swap by selects.
template <int N>
__device__ __forceinline__ void solve_pivoted(float A[N][N], float b[N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    float best = fabsf(A[c][c]);
    int p = c;
#pragma unroll
    for (int r = c + 1; r < N; ++r) {
      const float x = fabsf(A[r][c]);
      if (x > best) {
        best = x;
        p = r;
      }
    }
#pragma unroll
    for (int r = c + 1; r < N; ++r) {
      const bool sw = (r == p);
#pragma unroll
      for (int j = c; j < N; ++j) {
        const float t = A[c][j];
        A[c][j] = sw ? A[r][j] : t;
        A[r][j] = sw ? t : A[r][j];
      }
      const float t = b[c];
      b[c] = sw ? b[r] : t;
      b[r] = sw ? t : b[r];
    }
    const float inv = 1.0f / A[c][c];
#pragma unroll
    for (int r = c + 1; r < N; ++r) {
      const float l = A[r][c] * inv;
#pragma unroll
      for (int j = c + 1; j < N; ++j) A[r][j] = A[r][j] - l * A[c][j];
      b[r] = b[r] - l * b[c];
    }
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float x = b[i];
#pragma unroll
    for (int j = i + 1; j < N; ++j) x = x - A[i][j] * b[j];
    b[i] = x / A[i][i];
  }
}

// t = R (|lam| alpha) with R alpha = dW: the wave sum of roe_dissipation in
// primitive rows; the dissipation is 0.5 M t, M the dU/dW Jacobian.
__device__ __forceinline__ void roe_wave_sum(const float ql[NV],
                                             const float qr[NV], float bn,
                                             const MConsts& k, RoeMean& m,
                                             float t[7]) {
  m = roe_mean(ql, qr, bn, k);
  float R[7][7];
  roe_eigenvectors(m, R);
  float al[7] = {qr[0] - ql[0], qr[1] - ql[1], qr[2] - ql[2], qr[3] - ql[3],
                 qr[4] - ql[4], qr[6] - ql[6], qr[7] - ql[7]};
  solve_pivoted<7>(R, al);
  const float vn = m.v0;
  const float lam[7] = {vn - m.cf, vn - m.ca, vn - m.cs, vn,
                        vn + m.cs, vn + m.ca, vn + m.cf};
#pragma unroll
  for (int w = 0; w < 7; ++w) al[w] = fabsf(lam[w]) * al[w];
  roe_eigenvectors(m, R);   // the elimination overwrote it
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    float x = 0.0f;
#pragma unroll
    for (int w = 0; w < 7; ++w) x = x + R[r][w] * al[w];
    t[r] = x;
  }
}

// roe_dissipation (7-row layout): 0.5 M t, M (_cons_of_prim_jac) applied
// row by row from its sparsity.
__device__ __forceinline__ void roe_dissipation(const float ql[NV],
                                                const float qr[NV], float bn,
                                                const MConsts& k,
                                                float diss[7]) {
  RoeMean m;
  float t[7];
  roe_wave_sum(ql, qr, bn, k, m, t);
  const float d = m.d;
  const float vsq = (m.v0 * m.v0 + m.v1 * m.v1) + m.v2 * m.v2;
  diss[0] = 0.5f * t[0];
  diss[1] = 0.5f * (m.v0 * t[0] + d * t[1]);
  diss[2] = 0.5f * (m.v1 * t[0] + d * t[2]);
  diss[3] = 0.5f * (m.v2 * t[0] + d * t[3]);
  diss[4] = 0.5f * ((((((0.5f * vsq) * t[0] + (d * m.v0) * t[1])
                       + (d * m.v1) * t[2]) + (d * m.v2) * t[3])
                     + k.ig1 * t[4]) + (m.bt1 * t[5] + m.bt2 * t[6]));
  diss[5] = 0.5f * t[5];
  diss[6] = 0.5f * t[6];
}

// Row 5 (Bt1) of roe_dissipation, all a corner EMF reads: M's row 5 is
// the identity's.
__device__ __forceinline__ float roe_dissipation5(const float ql[NV],
                                                  const float qr[NV],
                                                  float bn, const MConsts& k) {
  RoeMean m;
  float t[7];
  roe_wave_sum(ql, qr, bn, k, m, t);
  return 0.5f * t[5];
}

// roe: centred flux of the floored states minus the Roe dissipation.
__device__ __forceinline__ void roe(const float ql[NV], const float qr[NV],
                                    float bn, const MConsts& k,
                                    float out[NV]) {
  float qls[NV], qrs[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    qls[v] = ql[v];
    qrs[v] = qr[v];
  }
  qls[0] = fmaxf(ql[0], k.smallr);
  qrs[0] = fmaxf(qr[0], k.smallr);
  qls[4] = fmaxf(ql[4], k.pfloor);
  qrs[4] = fmaxf(qr[4], k.pfloor);
  float diss[7];
  roe_dissipation(qls, qrs, bn, k, diss);
  float fl[NV], fr[NV];
  flux1d(qls[0], qls[1], qls[2], qls[3], qls[4], bn, qls[6], qls[7], k, fl);
  flux1d(qrs[0], qrs[1], qrs[2], qrs[3], qrs[4], bn, qrs[6], qrs[7], k, fr);
  const int row[NV] = {0, 1, 2, 3, 4, -1, 5, 6};   // _expand8
#pragma unroll
  for (int v = 0; v < NV; ++v)
    out[v] = (row[v] < 0) ? 0.0f : 0.5f * (fl[v] + fr[v]) - diss[row[v]];
}

// upwind (godunov_utils.f90:313): centred flux minus |mean vn| times the
// state jump, on the states as they come (no floors).
__device__ __forceinline__ void upwind(const float ql[NV], const float qr[NV],
                                       float bn, const MConsts& k,
                                       float out[NV]) {
  float fl[NV], fr[NV], ul[NV], ur[NV];
  flux1d(ql[0], ql[1], ql[2], ql[3], ql[4], bn, ql[6], ql[7], k, fl);
  flux1d(qr[0], qr[1], qr[2], qr[3], qr[4], bn, qr[6], qr[7], k, fr);
  cons1d(ql[0], ql[1], ql[2], ql[3], ql[4], bn, ql[6], ql[7], k, ul);
  cons1d(qr[0], qr[1], qr[2], qr[3], qr[4], bn, qr[6], qr[7], k, ur);
  const float vmean = 0.5f * (ql[1] + qr[1]);
#pragma unroll
  for (int v = 0; v < NV; ++v)
    out[v] = (v == 5) ? 0.0f
                      : 0.5f * (fl[v] + fr[v]) - 0.5f * fabsf(vmean) * (ur[v] - ul[v]);
}

template <int RS>
__device__ __forceinline__ void riemann1d(const float ql[NV], const float qr[NV],
                                      float bn, const MConsts& k,
                                      float out[NV]) {
  if (RS == 0) llf(ql, qr, bn, k, out);
  else if (RS == 1) hll(ql, qr, bn, k, out);
  else if (RS == 2) hlld(ql, qr, bn, k, out);
  else if (RS == 3) roe(ql, qr, bn, k, out);
  else upwind(ql, qr, bn, k, out);
}

// Orientation sign of an edge pair: +1 for (0,1), (1,2), (2,0).
__device__ __forceinline__ constexpr float pair_sig(int d1, int d2) {
  return ((d1 == 0 && d2 == 1) || (d1 == 1 && d2 == 2) || (d1 == 2 && d2 == 0))
             ? 1.0f : -1.0f;
}

__device__ __forceinline__ constexpr int pair_index(int d1, int d2) {
  return d1 == 0 ? d2 - 1 : 2;   // (0,1) -> 0, (0,2) -> 1, (1,2) -> 2
}

// ---- mhd/riemann2d.py: the corner solvers ----------------------------------

// The corner solvers of mhd/riemann2d.py (corner_emf) on the four corner
// states around an edge, in its order LB, RB, LT, RT (x = L|R along d1,
// y = B|T along d2).  A corner state is (r, p, u, v, w, c): density and
// pressure (floored), the velocities along d1, d2 and the third axis, and
// the third axis's cell field.  Each returns eps = u B - v A upwinded; the
// caller applies the pair's orientation sign.
struct Corner {
  float r, p, u, v, w, c;
};

// eps of each corner state: A = B_d1 of its y side, B = B_d2 of its x side.
struct CornerFaces {
  float A_T, A_B, B_R, B_L;
  __device__ float A(int q) const { return q < 2 ? A_B : A_T; }
  __device__ float B(int q) const { return (q & 1) ? B_R : B_L; }
};

__device__ __forceinline__ float llf_corner(const Corner& LB, const Corner& RB,
                                            const Corner& LT, const Corner& RT,
                                            float A_T, float A_B, float B_R,
                                            float B_L, const MConsts& k) {
  // floors of corner_emf (idempotent on the floored corner states)
  const float rLB = fmaxf(LB.r, k.smallr), rRB = fmaxf(RB.r, k.smallr);
  const float rLT = fmaxf(LT.r, k.smallr), rRT = fmaxf(RT.r, k.smallr);
  const float pLB = fmaxf(LB.p, k.pfloor), pRB = fmaxf(RB.p, k.pfloor);
  const float pLT = fmaxf(LT.p, k.pfloor), pRT = fmaxf(RT.p, k.pfloor);
  float eLB = LB.u * B_L - LB.v * A_B;
  float eRB = RB.u * B_R - RB.v * A_B;
  float eLT = LT.u * B_L - LT.v * A_T;
  float eRT = RT.u * B_R - RT.v * A_T;
  float ebar = 0.25f * (eLB + eRB + eLT + eRT);
  // x-solve on the y-averaged sides L = (LB, LT), R = (RB, RT)
  float bnx = 0.5f * (A_T + A_B);
  float sL = fabsf(0.5f * (LB.u + LT.u))
             + fast(0.5f * (rLB + rLT), 0.5f * (pLB + pLT), bnx, B_L,
                    0.5f * (LB.c + LT.c), k);
  float sR = fabsf(0.5f * (RB.u + RT.u))
             + fast(0.5f * (rRB + rRT), 0.5f * (pRB + pRT), bnx, B_R,
                    0.5f * (RB.c + RT.c), k);
  float dx5 = 0.5f * fmaxf(sL, sR) * (B_R - B_L);
  // y-solve on the x-averaged sides B = (LB, RB), T = (LT, RT)
  float bny = 0.5f * (B_R + B_L);
  float sB = fabsf(0.5f * (LB.v + RB.v))
             + fast(0.5f * (rLB + rRB), 0.5f * (pLB + pRB), bny, A_B,
                    0.5f * (LB.c + RB.c), k);
  float sT = fabsf(0.5f * (LT.v + RT.v))
             + fast(0.5f * (rLT + rRT), 0.5f * (pLT + pRT), bny, A_T,
                    0.5f * (LT.c + RT.c), k);
  float dy5 = 0.5f * fmaxf(sB, sT) * (A_T - A_B);
  return ebar - dx5 + dy5;
}

// pack_x / pack_y of corner_emf: the rotated 1D state averaged over two
// corners, normal velocity u (x-solve) or v (y-solve), field bt on slot 6.
__device__ __forceinline__ void corner_pack(const Corner& a, const Corner& b,
                                            bool y_solve, float bt,
                                            float q[NV]) {
  q[0] = 0.5f * (a.r + b.r);
  q[1] = y_solve ? 0.5f * (a.v + b.v) : 0.5f * (a.u + b.u);
  q[2] = y_solve ? 0.5f * (a.u + b.u) : 0.5f * (a.v + b.v);
  q[3] = 0.5f * (a.w + b.w);
  q[4] = 0.5f * (a.p + b.p);
  q[5] = 0.0f;
  q[6] = bt;
  q[7] = 0.5f * (a.c + b.c);
}

// 'roe' and 'upwind': the quarter-average of the corner EMFs plus the
// dissipative part (row 5) of an x- and a y-solve on side-averaged states.
template <bool ROE>
__device__ __forceinline__ float dissipative_corner(const Corner q[4],
                                                    const CornerFaces& f,
                                                    const float eps[4],
                                                    const MConsts& k) {
  const float ebar = 0.25f * (eps[0] + eps[1] + eps[2] + eps[3]);
  float ql[NV], qr[NV];
  corner_pack(q[0], q[2], false, f.B_L, ql);
  corner_pack(q[1], q[3], false, f.B_R, qr);
  const float bn_x = 0.5f * (f.A_T + f.A_B);
  const float dx5 = ROE ? roe_dissipation5(ql, qr, bn_x, k)
                        : 0.5f * fabsf(0.5f * (ql[1] + qr[1])) * (qr[6] - ql[6]);
  corner_pack(q[0], q[1], true, f.A_B, ql);
  corner_pack(q[2], q[3], true, f.A_T, qr);
  const float bn_y = 0.5f * (f.B_R + f.B_L);
  const float dy5 = ROE ? roe_dissipation5(ql, qr, bn_y, k)
                        : 0.5f * fabsf(0.5f * (ql[1] + qr[1])) * (qr[6] - ql[6]);
  return ebar - dx5 + dy5;
}

// 'hll' (fast speeds) and 'hlla' (Alfven speeds): Londrillo & Del Zanna
// (2004) four-state 2D-HLL average.
template <bool ALFVEN>
__device__ __forceinline__ float hll_corner(const Corner q[4],
                                            const CornerFaces& f,
                                            const float eps[4],
                                            const MConsts& k) {
  float umin = q[0].u, umax = q[0].u, vmin = q[0].v, vmax = q[0].v;
  float cxmax = 0.0f, cymax = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float A = f.A(j), B = f.B(j);
    const float cx = ALFVEN ? sqrtf(fmaxf(A * A / q[j].r, k.smallc2))
                            : fast(q[j].r, q[j].p, A, B, q[j].c, k);
    const float cy = ALFVEN ? sqrtf(fmaxf(B * B / q[j].r, k.smallc2))
                            : fast(q[j].r, q[j].p, B, A, q[j].c, k);
    cxmax = j ? fmaxf(cxmax, cx) : cx;
    cymax = j ? fmaxf(cymax, cy) : cy;
    umin = fminf(umin, q[j].u);
    umax = fmaxf(umax, q[j].u);
    vmin = fminf(vmin, q[j].v);
    vmax = fmaxf(vmax, q[j].v);
  }
  const float SL = fminf(umin - cxmax, 0.0f);
  const float SR = fmaxf(umax + cxmax, 0.0f);
  const float SB = fminf(vmin - cymax, 0.0f);
  const float ST = fmaxf(vmax + cymax, 0.0f);
  const float dx_ = SR - SL + EPS;
  const float dy_ = ST - SB + EPS;
  return (SL * SB * eps[3] - SL * ST * eps[1] - SR * SB * eps[2]
          + SR * ST * eps[0]) / (dx_ * dy_)
         - ST * SB / dy_ * (f.A_T - f.A_B) + SR * SL / dx_ * (f.B_R - f.B_L);
}

// 'hlld' (_hlld2d): the four-state HLLD with a contact (ustar, vstar), star
// states per quadrant and Alfven-bounded inner waves.  Every guard of the
// JAX code is a select on finite values.
__device__ __forceinline__ float hlld_corner(const Corner q[4],
                                             const CornerFaces& f,
                                             const float eps[4],
                                             const MConsts& k) {
  float cxm = 0.0f, cym = 0.0f;
  float umin = q[0].u, umax = q[0].u, vmin = q[0].v, vmax = q[0].v;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float cx = fast(q[j].r, q[j].p, f.A(j), f.B(j), q[j].c, k);
    const float cy = fast(q[j].r, q[j].p, f.B(j), f.A(j), q[j].c, k);
    cxm = j ? fmaxf(cxm, cx) : cx;
    cym = j ? fmaxf(cym, cy) : cy;
    umin = fminf(umin, q[j].u);
    umax = fmaxf(umax, q[j].u);
    vmin = fminf(vmin, q[j].v);
    vmax = fmaxf(vmax, q[j].v);
  }
  const float SL = umin - cxm, SR = umax + cxm;
  const float SB = vmin - cym, ST = vmax + cym;
  float ptot[4], rcx[4], rcy[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float A = f.A(j), B = f.B(j);
    ptot[j] = q[j].p + 0.5f * ((A * A + B * B) + q[j].c * q[j].c);
    rcx[j] = q[j].r * ((j & 1) ? (SR - q[j].u) : (q[j].u - SL));
    rcy[j] = q[j].r * ((j < 2) ? (q[j].v - SB) : (ST - q[j].v));
  }
  // mass-weighted contact speeds (the reference's ustar / vstar)
  const float ustar =
      ((((rcx[0] * q[0].u + rcx[1] * q[1].u) + rcx[2] * q[2].u) + rcx[3] * q[3].u)
       + (((ptot[0] - ptot[1]) + ptot[2]) - ptot[3]))
      / ((((rcx[0] + rcx[1]) + rcx[2]) + rcx[3]) + EPS);
  const float vstar =
      ((((rcy[0] * q[0].v + rcy[1] * q[1].v) + rcy[2] * q[2].v) + rcy[3] * q[3].v)
       + (((ptot[0] - ptot[2]) + ptot[1]) - ptot[3]))
      / ((((rcy[0] + rcy[1]) + rcy[2]) + rcy[3]) + EPS);
  float rstar_x[4], rstar_y[4], rstar[4], Astar[4], Bstar[4];
  float Ex[4], Ey[4], Es[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float Sx = (j & 1) ? SR : SL;
    const float Sy = (j < 2) ? SB : ST;
    const float fx = (Sx - q[j].u) / (Sx - ustar + ((Sx >= ustar) ? EPS : -EPS));
    const float fy = (Sy - q[j].v) / (Sy - vstar + ((Sy >= vstar) ? EPS : -EPS));
    rstar_x[j] = q[j].r * fx;
    rstar_y[j] = q[j].r * fy;
    rstar[j] = q[j].r * fx * fy;
    Bstar[j] = f.B(j) * fx;
    Astar[j] = f.A(j) * fy;
    Ex[j] = ustar * Bstar[j] - q[j].v * f.A(j);
    Ey[j] = q[j].u * f.B(j) - vstar * Astar[j];
    Es[j] = ustar * Bstar[j] - vstar * Astar[j];
  }
  // Alfven speeds of a side: its two quadrants' plain and star fields
  auto ca_side = [&](int j0, int j1, bool a_field) {
    float out = k.smallc;
    const int js[2] = {j0, j1};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int j = js[n];
      const float fld = a_field ? f.A(j) : f.B(j);
      const float fst = a_field ? Astar[j] : Bstar[j];
      const float rsx = a_field ? rstar_x[j] : rstar_y[j];
      out = fmaxf(out, fabsf(fld) / sqrtf(fmaxf(rsx, k.smallr)));
      out = fmaxf(out, fabsf(fst) / sqrtf(fmaxf(rstar[j], k.smallr)));
    }
    return out;
  };
  const float caL = ca_side(0, 2, true), caR = ca_side(1, 3, true);
  const float caB = ca_side(0, 1, false), caT = ca_side(2, 3, false);
  const float SAL = fminf(ustar - caL, 0.0f);
  const float SAR = fmaxf(ustar + caR, 0.0f);
  const float SAB = fminf(vstar - caB, 0.0f);
  const float SAT = fmaxf(vstar + caT, 0.0f);
  const float dax = SAR - SAL + EPS;
  const float day = SAT - SAB + EPS;
  const float AstarT = (SAR * Astar[3] - SAL * Astar[2]) / dax;
  const float AstarB = (SAR * Astar[1] - SAL * Astar[0]) / dax;
  const float BstarR = (SAT * Bstar[3] - SAB * Bstar[1]) / day;
  const float BstarL = (SAT * Bstar[2] - SAB * Bstar[0]) / day;
  // supersonic rows / columns
  const float dB = f.B_R - f.B_L, dA = f.A_T - f.A_B;
  const float e_b = (SL > 0.0f) ? eps[0] : (SR < 0.0f) ? eps[1]
                  : (SAR * Ex[0] - SAL * Ex[1] + SAR * SAL * dB) / dax;
  const float e_t = (SL > 0.0f) ? eps[2] : (SR < 0.0f) ? eps[3]
                  : (SAR * Ex[2] - SAL * Ex[3] + SAR * SAL * dB) / dax;
  const float e_l = (SAT * Ey[0] - SAB * Ey[2] - SAT * SAB * dA) / day;
  const float e_r = (SAT * Ey[1] - SAB * Ey[3] - SAT * SAB * dA) / day;
  const float e_c = (SAL * SAB * Es[3] - SAL * SAT * Es[1] - SAR * SAB * Es[2]
                     + SAR * SAT * Es[0]) / (dax * day)
                    - SAT * SAB / day * (AstarT - AstarB)
                    + SAR * SAL / dax * (BstarR - BstarL);
  return (SB > 0.0f) ? e_b : (ST < 0.0f) ? e_t : (SL > 0.0f) ? e_l
       : (SR < 0.0f) ? e_r : e_c;
}

// corner_emf of kind R2: 1 llf, 2 roe, 3 upwind, 4 hll, 5 hlla, 6 hlld.
template <int R2>
__device__ __forceinline__ float corner_emf(const Corner q[4],
                                            const CornerFaces& f,
                                            const MConsts& k) {
  if (R2 == 1)
    return llf_corner(q[0], q[1], q[2], q[3], f.A_T, f.A_B, f.B_R, f.B_L, k);
  float eps[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) eps[j] = q[j].u * f.B(j) - q[j].v * f.A(j);
  if (R2 == 2) return dissipative_corner<true>(q, f, eps, k);
  if (R2 == 3) return dissipative_corner<false>(q, f, eps, k);
  if (R2 == 4) return hll_corner<false>(q, f, eps, k);
  if (R2 == 5) return hll_corner<true>(q, f, eps, k);
  return hlld_corner(q, f, eps, k);
}

// ---- the fused step: tiles, rings, positions ------------------------------

// A block's tile: T0 x T1 updated columns (T1 = 1 below 3D; HB = 1 where
// the second column axis has a halo) and a chunk of Geo::ch rows along
// the marching axis, NT threads, MINB blocks an SM that the shared memory
// allows (the launch bounds' second argument: without it nvcc trades a
// few spills for register counts that would fit more blocks than the
// shared memory does).  2D: the predicted grid (T0 + 2 columns) is NT
// items, so the predictor and the marching fluxes are one item a thread.
template <int ND> struct Tile;
template <> struct Tile<1> {
  static constexpr int NT = 128, T0 = 126, T1 = 1, HB = 0, MINB = 1;
};
template <> struct Tile<2> {
  static constexpr int NT = 128, T0 = 126, T1 = 1, HB = 0, MINB = 4;
};
template <> struct Tile<3> {
  static constexpr int NT = 384, T0 = 12, T1 = 16, HB = 1, MINB = 1;
};

// The Roe solvers (face or corner) keep a 7x7 matrix in registers: their
// kernels are held to at most 3 blocks an SM (170 registers).
template <int ND, int RS, int R2>
struct MinBlocks {
  static constexpr int value =
      ((RS == 3 || R2 == 2) && Tile<ND>::MINB > 3) ? 3 : Tile<ND>::MINB;
};

template <int ND>
struct Lay : Tile<ND> {
  using T = Tile<ND>;
  // the predicted grid: the tile and one halo column a side (QB fastest);
  // every face flux and edge EMF of a row lies on it too
  static constexpr int QA = T::T0 + 2, QB = T::T1 + 2 * T::HB, QG = QA * QB;
  // the primitive grid: two halo columns a side
  static constexpr int PA = T::T0 + 4, PB = T::T1 + 4 * T::HB, PG = PA * PB;
  static constexpr int NPAIR = ND == 3 ? 3 : ND - 1;
  static constexpr int NCA = ND == 3 ? 2 : 1;   // column axes
  static constexpr int NM = ND >= 2 ? NCA : 0;  // marching components kept
};

// Dynamic shared memory of a launch with nv cell variables (bytes): the
// rings of Rings, in its order.
template <int ND>
int smem_bytes(int nv) {
  using L = Lay<ND>;
  const int pf = (ND + 1) * nv + 8 + ND;
  return (int)sizeof(float)
         * (3 * nv * L::PG + 2 * pf * L::QG + L::NM * L::QG
            + L::NCA * (NV + 2) * L::QG + 2 * ND * (nv - NV) * L::QG
            + 2 * L::NPAIR * L::QG);
}

struct Pos {
  int r, i;   // a row of the march and an index into a row's grid
};

// One step of s (+-1) along physical axis d on a grid whose rows are B
// long: the marching axis moves the row, column axis 0 (axis 0 in 1D,
// axis 1 above) the index by B, column axis 1 (axis 2) by 1.
template <int ND>
__device__ __forceinline__ Pos step(Pos x, int d, int s, int B) {
  if (ND >= 2 && d == 0) return Pos{x.r + s, x.i};
  return Pos{x.r, x.i + s * ((ND == 1 || d == 1) ? B : 1)};
}

// The rings in shared memory, each variable-major.  The face fluxes of
// the MHD variables that only the update reads live in registers: the
// marching flux through face t in the thread of its column (which updates
// that column's cell of row t-1 next, and of row t after), the column
// fluxes' update terms of row t in the thread of the cell (which updates
// it a row later).  Shared memory keeps what other threads read.
template <int ND>
struct Rings {
  float* prim;  // [3][nv][PG]  primitives of row r at slot r % 3
  float* pred;  // [2][pf][QG]  predicted cells of row r at slot r & 1
  float* fm;    // [NM][QG]     component 5 + d of the marching flux through
                //              face t (for the edges of pair (0, d))
  float* fc;    // [NCA][8][QG] the column fluxes of row t, MHD variables
  float* fc5;   // [NCA][2][QG] their component 5, row r at slot r & 1
  float* fp;    // [ND][2][nv-8][QG] passive fluxes by direction; a marching
                //              face between rows r-1 and r is row r
  float* emf;   // [NPAIR][2][QG]  edge EMFs by pair; a marching edge as
                //                  its face
  int nv, pf;
  __device__ float& P(Pos x, int v) const {
    return prim[((x.r % 3) * nv + v) * Lay<ND>::PG + x.i];
  }
  __device__ float& Q(Pos x, int f) const {
    return pred[((x.r & 1) * pf + f) * Lay<ND>::QG + x.i];
  }
  // d a physical axis; a column axis's index is d - 1 above 1D
  __device__ float& FM(int d, Pos x) const {
    return fm[(d - 1) * Lay<ND>::QG + x.i];
  }
  __device__ float& FC(int d, int v, Pos x) const {
    return fc[((ND == 1 ? 0 : d - 1) * NV + v) * Lay<ND>::QG + x.i];
  }
  __device__ float& FC5(int d, Pos x) const {
    return fc5[((ND == 1 ? 0 : d - 1) * 2 + (x.r & 1)) * Lay<ND>::QG + x.i];
  }
  __device__ float& FP(int d, Pos x, int s) const {
    return fp[((d * 2 + (x.r & 1)) * (nv - NV) + s) * Lay<ND>::QG + x.i];
  }
  __device__ float& E(int pr, Pos x) const {
    return emf[(pr * 2 + (x.r & 1)) * Lay<ND>::QG + x.i];
  }
  // the fields of a predicted cell: slopes, du_half, q_half, bf_half
  __device__ int DQ(int d, int v) const { return d * nv + v; }
  __device__ int DUH(int v) const { return ND * nv + v; }
  __device__ int QH(int v) const { return (ND + 1) * nv + v; }
  __device__ int BFH(int c) const { return (ND + 1) * nv + 8 + c; }
  __device__ Pos qstep(Pos x, int d, int s) const {
    return step<ND>(x, d, s, Lay<ND>::QB);
  }
  __device__ Pos pstep(Pos x, int d, int s) const {
    return step<ND>(x, d, s, Lay<ND>::PB);
  }
};

// Physical padded coordinates of (row, column 0, column 1) and their
// offsets into the cell, face and interior boxes.
template <int ND>
__device__ __forceinline__ void phys(int row, int pa, int pb, int P[3]) {
  P[0] = ND == 1 ? pa : row;
  P[1] = ND == 1 ? 0 : pa;
  P[2] = ND == 3 ? pb : 0;
}

template <int ND>
__device__ __forceinline__ int64_t cell_off(const Geo& g, const int P[3]) {
  int64_t o = 0;
#pragma unroll
  for (int a = 0; a < ND; ++a) o += (int64_t)P[a] * g.s[a];
  return o;
}

template <int ND>
__device__ __forceinline__ int64_t face_off(const Geo& g, const int P[3]) {
  int64_t o = 0;
#pragma unroll
  for (int a = 0; a < ND; ++a) o += (int64_t)(P[a] + 1) * g.fs[a];
  return o;
}

template <int ND>
__device__ __forceinline__ int64_t int_off(const Geo& g, const int P[3]) {
  int64_t o = 0;
#pragma unroll
  for (int a = 0; a < ND; ++a) o += (int64_t)(P[a] - 2) * g.is[a];
  return o;
}

// The rotated layout (r, vn, vt1, vt2, p, bn, bt1, bt2) of a state along
// axis D (vt1, vt2 along (D+1)%3, (D+2)%3), and its inverse, by selects.
__device__ __forceinline__ float sel3(int D, float a, float b, float c) {
  return D == 0 ? a : (D == 1 ? b : c);
}

__device__ __forceinline__ void rotate(const float q[NV], int D, float o[NV]) {
  o[0] = q[0];
  o[1] = sel3(D, q[1], q[2], q[3]);
  o[2] = sel3(D, q[2], q[3], q[1]);
  o[3] = sel3(D, q[3], q[1], q[2]);
  o[4] = q[4];
  o[5] = sel3(D, q[5], q[6], q[7]);
  o[6] = sel3(D, q[6], q[7], q[5]);
  o[7] = sel3(D, q[7], q[5], q[6]);
}

__device__ __forceinline__ void unrotate(const float f[NV], int D,
                                         float o[NV]) {
  o[0] = f[0];
  o[1] = sel3(D, f[1], f[3], f[2]);
  o[2] = sel3(D, f[2], f[1], f[3]);
  o[3] = sel3(D, f[3], f[2], f[1]);
  o[4] = f[4];
  o[5] = sel3(D, f[5], f[7], f[6]);
  o[6] = sel3(D, f[6], f[5], f[7]);
  o[7] = sel3(D, f[7], f[6], f[5]);
}

// ---- primitives: face-averaged cell B, ctoprim ---------------------------

template <int ND>
__device__ __forceinline__ void prim_cell(const Rings<ND>& w, const Geo& g,
                                          const MConsts& k,
                                          const float* __restrict__ up,
                                          const float* __restrict__ bf,
                                          Pos x, int64_t i, int64_t fo) {
  float u[NV], q[NV];
#pragma unroll
  for (int v = 0; v < 5; ++v) u[v] = __ldg(up + v * g.np + i);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lo = __ldg(bf + c * g.nf + fo);
    u[5 + c] = (c < ND) ? 0.5f * (lo + __ldg(bf + c * g.nf + fo + g.fs[c])) : lo;
  }
  ctoprim(u, k, q);
#pragma unroll
  for (int v = 0; v < NV; ++v) w.P(x, v) = q[v];
  const float inv_r = 1.0f / fmaxf(u[0], k.smallr);
  for (int v = NV; v < g.nv; ++v) w.P(x, v) = __ldg(up + v * g.np + i) * inv_r;
}

// ---- A: slopes, Hancock predictor, q_half, bf_half -----------------------

// e_edge0 of pair (D1, D2) at primitive position x: the quarter-sum of the
// cell EMFs of the four cells around the edge.
template <int D1, int D2, int ND>
__device__ __forceinline__ float edge0(const Rings<ND>& w, Pos x) {
  const float sig = pair_sig(D1, D2);
  auto ec = [&](Pos o) {
    const float v1 = w.P(o, 1 + D1), v2 = w.P(o, 1 + D2);
    const float b1 = w.P(o, 5 + D1), b2 = w.P(o, 5 + D2);
    return sig * (v2 * b1 - v1 * b2);
  };
  const Pos x1 = w.pstep(x, D1, -1);
  return 0.25f * (ec(x) + ec(x1) + ec(w.pstep(x, D2, -1))
                  + ec(w.pstep(x1, D2, -1)));
}

template <int D1, int D2, int ND>
__device__ __forceinline__ void bf_half_pair(const Rings<ND>& w,
                                             const MConsts& k, float dt,
                                             Pos x, float bh[3]) {
  const float sig = pair_sig(D1, D2);
  const float e0 = edge0<D1, D2>(w, x);
  bh[D1] = bh[D1] - sig * (0.5f * dt / k.dx[D2])
                        * (edge0<D1, D2>(w, w.pstep(x, D2, 1)) - e0);
  bh[D2] = bh[D2] + sig * (0.5f * dt / k.dx[D1])
                        * (edge0<D1, D2>(w, w.pstep(x, D1, 1)) - e0);
}

// The predicted cell at primitive position xp, stored at xq.
template <int ND>
__device__ __forceinline__ void predict_cell(const Rings<ND>& w,
                                             const Geo& g, const MConsts& k,
                                             const float* __restrict__ up,
                                             const float* __restrict__ bf,
                                             float dt, Pos xp, Pos xq,
                                             int64_t i, int64_t fo) {
  float qc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) qc[v] = w.P(xp, v);
  float dq[ND][NV];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const Pos m = w.pstep(xp, d, -1), p = w.pstep(xp, d, 1);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      dq[d][v] = mslope(w.P(m, v), qc[v], w.P(p, v), k);
      w.Q(xq, w.DQ(d, v)) = dq[d][v];
    }
  }
  // conservative Hancock half-step from the cell's own faces
  float du[NV], mhi[ND], mlo[ND];
#pragma unroll
  for (int v = 0; v < NV; ++v) du[v] = 0.0f;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    float qhi[NV], qlo[NV], fhi[NV], flo[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      qhi[v] = qc[v] + 0.5f * dq[d][v];
      qlo[v] = qc[v] - 0.5f * dq[d][v];
    }
    if (d == 0) { flux_along<0>(qhi, k, fhi); flux_along<0>(qlo, k, flo); }
    else if (d == 1) { flux_along<1>(qhi, k, fhi); flux_along<1>(qlo, k, flo); }
    else { flux_along<2>(qhi, k, fhi); flux_along<2>(qlo, k, flo); }
    const float c = 0.5f * dt / k.dx[d];
#pragma unroll
    for (int v = 0; v < NV; ++v) du[v] = du[v] - c * (fhi[v] - flo[v]);
    mhi[d] = fhi[0];
    mlo[d] = flo[0];
  }
  // passives: slopes and the Hancock half-step (flux = mass flux * q_s)
  for (int v = NV; v < g.nv; ++v) {
    const float qs = w.P(xp, v);
    float dus = 0.0f;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const float dqs = mslope(w.P(w.pstep(xp, d, -1), v), qs,
                               w.P(w.pstep(xp, d, 1), v), k);
      w.Q(xq, w.DQ(d, v)) = dqs;
      const float c = 0.5f * dt / k.dx[d];
      dus = dus - c * (mhi[d] * (qs + 0.5f * dqs) - mlo[d] * (qs - 0.5f * dqs));
    }
    w.Q(xq, w.DUH(v)) = dus;
  }
  // half-step primitives: up (with the face-averaged B of qc) + du_half
  float u2[NV], qh[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    w.Q(xq, w.DUH(v)) = du[v];
    u2[v] = ((v < 5) ? __ldg(up + v * g.np + i) : qc[v]) + du[v];
  }
  ctoprim(u2, k, qh);
#pragma unroll
  for (int v = 0; v < NV; ++v) w.Q(xq, w.QH(v)) = qh[v];
  // half-dt face field, pairs in the order (0,1), (0,2), (1,2)
  float bh[3];
#pragma unroll
  for (int c = 0; c < ND; ++c) bh[c] = __ldg(bf + c * g.nf + fo);
  if constexpr (ND >= 2) bf_half_pair<0, 1>(w, k, dt, xp, bh);
  if constexpr (ND == 3) {
    bf_half_pair<0, 2>(w, k, dt, xp, bh);
    bf_half_pair<1, 2>(w, k, dt, xp, bh);
  }
#pragma unroll
  for (int c = 0; c < ND; ++c) w.Q(xq, w.BFH(c)) = bh[c];
}

// ---- B: the flux through the low face along D of the cell at (rq, rp) -----

// The MHD variables' flux goes to f; the passives' to their ring.
template <int ND, int RS>
__device__ __forceinline__ void face_flux(const Rings<ND>& w, const Geo& g,
                                          const MConsts& k, int D, Pos rq,
                                          Pos rp, float f[NV]) {
  // left state: the high face of the cell below; right: the low face of
  // this one
  const Pos lq = w.qstep(rq, D, -1), lp = w.pstep(rp, D, -1);
  float ql[NV], qr[NV];
  float rho_f[2], inv_r[2];   // a side's prim_to_cons density, 1/ctoprim's
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const Pos cq = side ? rq : lq, cp = side ? rp : lp;
    const float half = side ? -0.5f : 0.5f;
    float qf[NV], uf[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) qf[v] = w.P(cp, v) + half * w.Q(cq, w.DQ(D, v));
    prim_to_cons(qf, k, uf);
    rho_f[side] = uf[0];
#pragma unroll
    for (int v = 0; v < NV; ++v) uf[v] = uf[v] + w.Q(cq, w.DUH(v));
    inv_r[side] = 1.0f / fmaxf(uf[0], k.smallr);
    ctoprim(uf, k, side ? qr : ql);
  }
  float qlr[NV], qrr[NV], fg[NV];
  rotate(ql, D, qlr);
  rotate(qr, D, qrr);
  riemann1d<RS>(qlr, qrr, w.Q(rq, w.BFH(D)), k, fg);
  unrotate(fg, D, f);
  // passives, upwinded on the sign of the mass flux (riemann.solve)
  for (int v = NV; v < g.nv; ++v) {
    float qs[2];
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const Pos cq = side ? rq : lq, cp = side ? rp : lp;
      const float half = side ? -0.5f : 0.5f;
      const float qf = w.P(cp, v) + half * w.Q(cq, w.DQ(D, v));
      qs[side] = (rho_f[side] * qf + w.Q(cq, w.DUH(v))) * inv_r[side];
    }
    w.FP(D, rq, v - NV) = (fg[0] > 0.0f) ? fg[0] * qs[0] : fg[0] * qs[1];
  }
}

// ---- C: the EMF of pair (D1, D2) on the edge at the low corner of x ------

// Corner state of the predicted cell x at (s1, s2) along (D1, D2): q_half
// + 0.5 (s1 dq_D1 + s2 dq_D2), density and pressure floored.
template <int ND>
__device__ __forceinline__ Corner corner(const Rings<ND>& w, const MConsts& k,
                                         int D1, int D2, Pos x, float s1,
                                         float s2) {
  const int DO = 3 - D1 - D2;
  auto at = [&](int v) {
    return w.Q(x, w.QH(v))
           + 0.5f * (s1 * w.Q(x, w.DQ(D1, v)) + s2 * w.Q(x, w.DQ(D2, v)));
  };
  Corner c;
  c.r = fmaxf(at(0), k.smallr);
  c.p = fmaxf(at(4), k.pfloor);
  c.u = at(1 + D1);
  c.v = at(1 + D2);
  c.w = at(1 + DO);
  c.c = at(5 + DO);
  return c;
}

template <int ND, int R2>
__device__ __forceinline__ void edge_emf(const Rings<ND>& w, const Geo& g,
                                         const MConsts& k, int D1, int D2,
                                         Pos x, const float* __restrict__ ovm,
                                         const float* __restrict__ ovv,
                                         int64_t i) {
  const float sig = pair_sig(D1, D2);
  const Pos x1 = w.qstep(x, D1, -1), x2 = w.qstep(x, D2, -1);
  const Pos x12 = w.qstep(x1, D2, -1);
  float e;
  if (R2 == 0) {  // Gardiner & Stone (2005) arithmetic corner average
    auto ec = [&](Pos o) {
      const float v1 = w.Q(o, w.QH(1 + D1)), v2 = w.Q(o, w.QH(1 + D2));
      const float b1 = w.Q(o, w.QH(5 + D1)), b2 = w.Q(o, w.QH(5 + D2));
      return sig * (v2 * b1 - v1 * b2);
    };
    // f1: the flux along D1, component 5 + D2, at x and x2; f2: along
    // D2, component 5 + D1, at x and x1 (x1 is row t-1 for D1 = 0)
    float f1, f1b, f2, f2l;
    if (ND >= 2 && D1 == 0) {
      f1 = w.FM(D2, x);
      f1b = w.FM(D2, x2);
      f2 = w.FC5(D2, x);
      f2l = w.FC5(D2, x1);
    } else {
      f1 = w.FC(D1, 5 + D2, x);
      f1b = w.FC(D1, 5 + D2, x2);
      f2 = w.FC(D2, 5 + D1, x);
      f2l = w.FC(D2, 5 + D1, x1);
    }
    const float ef1 = -sig * f1, ef1b = -sig * f1b;
    const float ef2 = sig * f2, ef2l = sig * f2l;
    e = 0.5f * (ef1 + ef1b + ef2 + ef2l)
        - 0.25f * (ec(x) + ec(x1) + ec(x2) + ec(x12));
  } else {        // a corner solver on primitive corner states
    const Corner q[4] = {corner<ND>(w, k, D1, D2, x12, 1.0f, 1.0f),
                         corner<ND>(w, k, D1, D2, x2, -1.0f, 1.0f),
                         corner<ND>(w, k, D1, D2, x1, 1.0f, -1.0f),
                         corner<ND>(w, k, D1, D2, x, -1.0f, -1.0f)};
    CornerFaces f;
    f.A_T = w.Q(x, w.BFH(D1));
    f.A_B = w.Q(x2, w.BFH(D1));
    f.B_R = w.Q(x, w.BFH(D2));
    f.B_L = w.Q(x1, w.BFH(D2));
    e = -sig * corner_emf<R2>(q, f, k);
  }
  const int pr = pair_index(D1, D2);
  if (ovm != nullptr && __ldg(ovm + pr * g.np + i) > 0.5f)
    e = __ldg(ovv + pr * g.np + i);
  w.E(pr, x) = e;
}

// ---- A: conservative update, induction, centred B -------------------------

// The new low face of component C of the cell at x (face offset fo): the
// stored face plus the curl of the edge EMFs, pairs in order.
template <int ND, int C>
__device__ __forceinline__ float induct(const Rings<ND>& w, const Geo& g,
                                        const MConsts& k, float dt,
                                        const float* __restrict__ bf, Pos x,
                                        int64_t fo) {
  float b = __ldg(bf + C * g.nf + fo);
#pragma unroll
  for (int d1 = 0; d1 < ND; ++d1)
#pragma unroll
    for (int d2 = d1 + 1; d2 < ND; ++d2) {
      if (C != d1 && C != d2) continue;
      const float sig = pair_sig(d1, d2);
      const int pr = pair_index(d1, d2);
      if (C == d1)
        b = b - sig * (dt / k.dx[d2]) * (w.E(pr, w.qstep(x, d2, 1)) - w.E(pr, x));
      else
        b = b + sig * (dt / k.dx[d1]) * (w.E(pr, w.qstep(x, d1, 1)) - w.E(pr, x));
    }
  return b;
}

// Face C of the cell at x, low (h = 0) and high (h = 1), through one call
// site: the high face's bits are those its upper neighbour stores.
template <int ND, int C>
__device__ __forceinline__ void staggered(const Rings<ND>& w, const Geo& g,
                                          const MConsts& k, float dt,
                                          const float* __restrict__ bf, Pos x,
                                          int64_t fo, int64_t io,
                                          float* __restrict__ un,
                                          float* __restrict__ bfn) {
  float b0 = 0.0f, b1 = 0.0f;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const float b = induct<ND, C>(w, g, k, dt, bf, h ? w.qstep(x, C, 1) : x,
                                  h ? fo + g.fs[C] : fo);
    b0 = h ? b0 : b;
    b1 = h ? b : b1;
  }
  bfn[C * g.ni + io] = b0;
  un[(5 + C) * g.ni + io] = 0.5f * (b0 + b1);
}

// The update terms of the column fluxes of the cell at x (row t), one per
// column axis and MHD variable: (dt/dx_d) (F_lo keep_lo - F_hi keep_hi),
// as the update adds them after the marching axis's.
template <int ND>
__device__ __forceinline__ void column_terms(const Rings<ND>& w, const Geo& g,
                                             const MConsts& k, float dt,
                                             const float* __restrict__ okp,
                                             Pos x, const int P[3],
                                             float ct[Lay<ND>::NCA][NV]) {
  const int64_t i = cell_off<ND>(g, P);
#pragma unroll
  for (int c = 0; c < Lay<ND>::NCA; ++c) {
    const int d = ND == 1 ? 0 : c + 1;
    float keep_lo = 1.0f, keep_hi = 1.0f;
    if (okp != nullptr) {
      const bool o = __ldg(okp + i) > 0.5f;
      keep_lo = (o || __ldg(okp + i - g.s[d]) > 0.5f) ? 0.0f : 1.0f;
      keep_hi = (o || __ldg(okp + i + g.s[d]) > 0.5f) ? 0.0f : 1.0f;
    }
    const Pos hi = w.qstep(x, d, 1);
#pragma unroll
    for (int v = 0; v < NV; ++v)
      ct[c][v] = (dt / k.dx[d]) * (w.FC(d, v, x) * keep_lo
                                   - w.FC(d, v, hi) * keep_hi);
  }
}

// The cell at x (row u): f0lo, f0hi its marching fluxes through faces u
// and u+1 (2D, 3D), ct its column terms.
template <int ND>
__device__ __forceinline__ void update_cell(
    const Rings<ND>& w, const Geo& g, const MConsts& k, float dt,
    const float* __restrict__ up, const float* __restrict__ bf,
    const float* __restrict__ okp, Pos x, const int P[3],
    const float f0lo[NV], const float f0hi[NV],
    const float ct[Lay<ND>::NCA][NV], float* __restrict__ un,
    float* __restrict__ bfn) {
  const int64_t i = cell_off<ND>(g, P), fo = face_off<ND>(g, P);
  const int64_t io = int_off<ND>(g, P);
  // face keep factors: a face next to a refined cell carries no cell flux
  float keep_lo[3], keep_hi[3];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    if (okp != nullptr) {
      const bool o = __ldg(okp + i) > 0.5f;
      keep_lo[d] = (o || __ldg(okp + i - g.s[d]) > 0.5f) ? 0.0f : 1.0f;
      keep_hi[d] = (o || __ldg(okp + i + g.s[d]) > 0.5f) ? 0.0f : 1.0f;
    } else {
      keep_lo[d] = keep_hi[d] = 1.0f;
    }
  }
  // variables 0-4 and the degenerate B components take the flux update,
  // the axes in order
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = v - 5;
    if (v >= 5 && c < ND) continue;   // staggered: from the new faces below
    float y = (v < 5) ? __ldg(up + v * g.np + i) : __ldg(bf + c * g.nf + fo);
    if constexpr (ND >= 2)
      y = y + (dt / k.dx[0]) * (f0lo[v] * keep_lo[0] - f0hi[v] * keep_hi[0]);
#pragma unroll
    for (int a = 0; a < Lay<ND>::NCA; ++a) y = y + ct[a][v];
    un[v * g.ni + io] = y;
    if (v >= 5) bfn[c * g.ni + io] = y;
  }
  for (int v = NV; v < g.nv; ++v) {   // passives
    float y = __ldg(up + v * g.np + i);
#pragma unroll
    for (int d = 0; d < ND; ++d)
      y = y + (dt / k.dx[d]) * (w.FP(d, x, v - NV) * keep_lo[d]
                                - w.FP(d, w.qstep(x, d, 1), v - NV) * keep_hi[d]);
    un[v * g.ni + io] = y;
  }
  staggered<ND, 0>(w, g, k, dt, bf, x, fo, io, un, bfn);
  if constexpr (ND >= 2) staggered<ND, 1>(w, g, k, dt, bf, x, fo, io, un, bfn);
  if constexpr (ND == 3) staggered<ND, 2>(w, g, k, dt, bf, x, fo, io, un, bfn);
}

// ---- the kernel ----------------------------------------------------------

// One block: the tile (blockIdx.x along column axis 0, blockIdx.y along
// column axis 1) and the chunk of rows blockIdx.z.  Every item loop is one
// call site of its stage; all branches on t are uniform over the block,
// so every thread meets every barrier.
template <int ND, int RS, int R2>
__global__ void __launch_bounds__(Tile<ND>::NT, MinBlocks<ND, RS, R2>::value)
mhd_ct_fused(const float* __restrict__ up, const float* __restrict__ bf,
             const float* __restrict__ okp, const float* __restrict__ ovm,
             const float* __restrict__ ovv, const float* __restrict__ dt_ptr,
             float* __restrict__ un, float* __restrict__ bfn, Geo g,
             MConsts k) {
  using L = Lay<ND>;
  extern __shared__ __align__(16) float smem[];
  Rings<ND> w;
  w.nv = g.nv;
  w.pf = (ND + 1) * g.nv + 8 + ND;
  w.prim = smem;
  w.pred = w.prim + 3 * g.nv * L::PG;
  w.fm = w.pred + 2 * w.pf * L::QG;
  w.fc = w.fm + L::NM * L::QG;
  w.fc5 = w.fc + L::NCA * NV * L::QG;
  w.fp = w.fc5 + L::NCA * 2 * L::QG;
  w.emf = w.fp + 2 * ND * (g.nv - NV) * L::QG;
  const int tid = threadIdx.x;
  const float dt = __ldg(dt_ptr);
  const int ca0 = ND == 1 ? 0 : 1;   // the physical axis of column axis 0
  const int ec0 = g.e[ca0], ec1 = g.e[2];
  const int A0 = 2 + blockIdx.x * L::T0;            // padded column a = 0
  const int B0 = ND == 3 ? 2 + blockIdx.y * L::T1 : 0;
  // rows: updated [R0, R1), predicted [R0 - W, R1], primitives
  // [R0 - 2W, R1 + W]; 1D has the one row 0
  constexpr int W = ND >= 2 ? 1 : 0;
  constexpr int LEAD = ND >= 2 ? 2 : 1;   // primitives run this far ahead
  const int R0 = ND >= 2 ? 2 + blockIdx.z * g.ch : 0;
  const int R1 = ND >= 2 ? min(R0 + g.ch, g.e[0] - 2) : 0;
  constexpr int NC0 = (L::T0 + 1) * L::QB;   // column-0 faces of a row
  constexpr int NC1 = ND == 3 ? L::QA * (L::T1 + 1) : 0;
  constexpr int NE0 = (L::T0 + 1) * L::T1;   // edges of pair (0, 1)
  constexpr int NE1 = ND == 3 ? L::T0 * (L::T1 + 1) : 0;        // (0, 2)
  constexpr int NE2 = ND == 3 ? (L::T0 + 1) * (L::T1 + 1) : 0;  // (1, 2)
  // this thread's own cell: the predicted-grid point tid, updated by it
  const int ao = tid / L::QB - 1, bo = tid % L::QB - L::HB;
  const bool own = tid < L::QG && ao >= 0 && ao < L::T0 && bo >= 0
                   && bo < L::T1 && A0 + ao <= ec0 - 3
                   && (ND < 3 || B0 + bo <= ec1 - 3);
  // its marching fluxes through faces t-1 and t, and its column terms
  float f0lo[NV], f0hi[NV], ct[L::NCA][NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    f0lo[v] = f0hi[v] = 0.0f;
#pragma unroll
    for (int c = 0; c < L::NCA; ++c) ct[c][v] = 0.0f;
  }

  // rows this block updates: [R0, RU)
  const int RU = ND >= 2 ? R1 : 1;

#pragma unroll 1
  for (int t = R0 - LEAD; t <= RU + W; ++t) {
    __syncthreads();
    // ---- A: this thread's cell (the update of row t-1-W, the column
    // terms of row t-1), then the predicted cells of row t ----
    if (own) {
      const int ur = t - 1 - W, cr = t - 1;
      int P[3];
      if constexpr (ND == 1) {
        if (cr >= R0 && cr < RU) {
          phys<ND>(cr, A0 + ao, B0 + bo, P);
          column_terms<ND>(w, g, k, dt, okp, Pos{cr, tid}, P, ct);
        }
      }
      if (ur >= R0 && ur < RU) {
        phys<ND>(ur, A0 + ao, B0 + bo, P);
        update_cell<ND>(w, g, k, dt, up, bf, okp, Pos{ur, tid}, P, f0lo,
                        f0hi, ct, un, bfn);
      }
      if constexpr (ND >= 2) {
        if (cr >= R0 && cr < RU) {
          phys<ND>(cr, A0 + ao, B0 + bo, P);
          column_terms<ND>(w, g, k, dt, okp, Pos{cr, tid}, P, ct);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) f0lo[v] = f0hi[v];
    const bool row_on = t >= R0 - W && t <= R1;   // predicted rows
    const int npred = row_on ? L::QG : 0;
#pragma unroll 1
    for (int it = tid; it < npred; it += L::NT) {
      const int a = it / L::QB - 1, b = it % L::QB - L::HB;
      const int pa = A0 + a, pb = B0 + b;
      if (pa > ec0 - 2 || (ND == 3 && pb > ec1 - 2)) continue;
      int P[3];
      phys<ND>(t, pa, pb, P);
      predict_cell<ND>(w, g, k, up, bf, dt,
                       Pos{t, (a + 2) * L::PB + b + 2 * L::HB}, Pos{t, it},
                       cell_off<ND>(g, P), face_off<ND>(g, P));
    }
    __syncthreads();
    // ---- B: marching face t (from row R0), column faces of row t ----
    const bool march_on = ND >= 2 && t >= R0 && t <= R1;
    const int nm = march_on ? L::QG : 0;
    const int nflux = row_on ? nm + NC0 + NC1 : 0;
#pragma unroll 1
    for (int it = tid; it < nflux; it += L::NT) {
      int D, a, b;
      if (it < nm) {
        D = 0;
        a = it / L::QB - 1;
        b = it % L::QB - L::HB;
      } else if (it < nm + NC0) {
        const int j = it - nm;
        D = ca0;
        a = j / L::QB;
        b = j % L::QB - L::HB;
      } else {
        const int j = it - nm - NC0;
        D = 2;
        a = j / (L::T1 + 1) - 1;
        b = j % (L::T1 + 1);
      }
      if (A0 + a > ec0 - 2 || (ND == 3 && B0 + b > ec1 - 2)) continue;
      const Pos x{t, (a + 1) * L::QB + b + L::HB};
      float f[NV];
      face_flux<ND, RS>(w, g, k, D, x, Pos{t, (a + 2) * L::PB + b + 2 * L::HB},
                        f);
      if (it < nm) {    // a marching face: item it is this thread's column
#pragma unroll
        for (int v = 0; v < NV; ++v) f0hi[v] = f[v];
#pragma unroll
        for (int c = 1; c <= L::NM; ++c) w.FM(c, x) = f[5 + c];
      } else {
#pragma unroll
        for (int v = 0; v < NV; ++v) w.FC(D, v, x) = f[v];
        w.FC5(D, x) = f[5];
      }
    }
    __syncthreads();
    // ---- C: edges of row t with the marching axis and (1,2) in row t;
    // the primitives of the rows A needs next ----
    if constexpr (ND >= 2) {
      const int nme = march_on ? NE0 + NE1 : 0;
      const int nemf = nme + ((ND == 3 && t >= R0 && t < R1) ? NE2 : 0);
#pragma unroll 1
      for (int it = tid; it < nemf; it += L::NT) {
        int D1, D2, a, b;
        if (it < nme && it < NE0) {
          D1 = 0;
          D2 = 1;
          a = it / L::T1;
          b = it % L::T1;
        } else {
          const int j = it < nme ? it - NE0 : it - nme;
          D1 = it < nme ? 0 : 1;
          D2 = 2;
          a = j / (L::T1 + 1);
          b = j % (L::T1 + 1);
        }
        const int pa = A0 + a, pb = B0 + b;
        if (pa > ec0 - 2 || (ND == 3 && pb > ec1 - 2)) continue;
        int P[3];
        phys<ND>(t, pa, pb, P);
        edge_emf<ND, R2>(w, g, k, D1, D2, Pos{t, (a + 1) * L::QB + b + L::HB},
                         ovm, ovv, cell_off<ND>(g, P));
      }
    }
    const int plo = t == R0 - LEAD ? R0 - 2 * W : t + LEAD;
    const int phi = min(t + LEAD, R1 + W);
    const int nprim = phi >= plo ? (phi - plo + 1) * L::PG : 0;
#pragma unroll 1
    for (int it = tid; it < nprim; it += L::NT) {
      const int c = it % L::PG, row = plo + it / L::PG;
      const int a = c / L::PB - 2, b = c % L::PB - 2 * L::HB;
      const int pa = A0 + a, pb = B0 + b;
      if (pa > ec0 - 1 || (ND == 3 && pb > ec1 - 1)) continue;
      int P[3];
      phys<ND>(row, pa, pb, P);
      prim_cell<ND>(w, g, k, up, bf, Pos{row, c}, cell_off<ND>(g, P),
                    face_off<ND>(g, P));
    }
  }
}

// ---- host side -------------------------------------------------------------

struct Call {
  const float *up, *bf, *okp, *ovm, *ovv, *dt;
  float *un, *bfn;
  Geo g;        // g.ch 0: choose the chunk at launch
  MConsts k;
  cudaStream_t s;
  int* info;    // non-null: report the launch's resources, launch nothing
};

// cudaFuncSetAttribute once per instantiation and device: the dynamic
// shared memory of the largest passive count.  Returns its error.
template <int ND, int RS, int R2>
int prepare() {
  static unsigned long long done = 0;  // one bit a device
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return 0;
  err = (int)cudaFuncSetAttribute(mhd_ct_fused<ND, RS, R2>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem_bytes<ND>(NV + MAX_PASSIVE));
  if (!err) done |= bit;
  return err;
}

template <int ND, int RS, int R2>
int run(const Call& c) {
  using L = Lay<ND>;
  int err = prepare<ND, RS, R2>();
  if (err) return err;
  const int smem = smem_bytes<ND>(c.g.nv);
  if (c.info != nullptr) {
    cudaFuncAttributes a;
    err = (int)cudaFuncGetAttributes(&a, mhd_ct_fused<ND, RS, R2>);
    if (err) return err;
    int nblk = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nblk, mhd_ct_fused<ND, RS, R2>, L::NT, smem);
    c.info[0] = nblk;
    c.info[1] = smem;
    c.info[2] = a.numRegs;
    c.info[3] = (int)a.localSizeBytes;
    return err;
  }
  const int ca0 = ND == 1 ? 0 : 1;
  const int64_t tiles = (int64_t)((c.g.e[ca0] - 4 + L::T0 - 1) / L::T0)
                        * (ND == 3 ? (c.g.e[2] - 4 + L::T1 - 1) / L::T1 : 1);
  const int n0 = c.g.e[0] - 4;
  Geo g = c.g;
  if (ND == 1) {
    g.ch = 1;
  } else if (g.ch == 0) {
    // The chunk of rows a block marches: each costs its rows, a warm-up
    // row and two more rows of primitives, and a launch takes as many
    // such steps as it has waves of resident blocks; the fewest steps
    // win, the longer chunk on a tie (2048^2: 16 rows; 512^2: 8).
    int dev = 0, nsm = 0, nblk = 0;
    err = (int)cudaGetDevice(&dev);
    if (!err)
      err = (int)cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                        dev);
    if (!err)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &nblk, mhd_ct_fused<ND, RS, R2>, L::NT, smem);
    if (err) return err;
    const int64_t slots =
        (int64_t)(nblk > 0 ? nblk : 1) * (nsm > 0 ? nsm : 1);
    int64_t best = -1;
    for (int ch = 64; ch >= 2; ch /= 2) {
      const int64_t blocks = tiles * ((n0 + ch - 1) / ch);
      const int64_t cost = (blocks + slots - 1) / slots * (ch + 3);
      if (best < 0 || cost < best) {
        best = cost;
        g.ch = ch;
      }
    }
  }
  if (ND >= 2 && (n0 + g.ch - 1) / g.ch > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((c.g.e[ca0] - 4 + L::T0 - 1) / L::T0,
                  ND == 3 ? (c.g.e[2] - 4 + L::T1 - 1) / L::T1 : 1,
                  ND >= 2 ? (n0 + g.ch - 1) / g.ch : 1);
  const dim3 block(L::NT);
  const cudaStream_t s = c.s;
  mhd_ct_fused<ND, RS, R2><<<grid, block, smem, s>>>(
      c.up, c.bf, c.okp, c.ovm, c.ovv, c.dt, c.un, c.bfn, g, c.k);
  return (int)cudaGetLastError();
}

template <int ND, int RS>
int by_corner(const Call& c, int riemann2d) {
  if constexpr (ND == 1) {
    return run<1, RS, 0>(c);   // no edges in 1D
  } else {
    switch (riemann2d) {
      case 0: return run<ND, RS, 0>(c);
      case 1: return run<ND, RS, 1>(c);
      case 2: return run<ND, RS, 2>(c);
      case 3: return run<ND, RS, 3>(c);
      case 4: return run<ND, RS, 4>(c);
      case 5: return run<ND, RS, 5>(c);
      default: return run<ND, RS, 6>(c);
    }
  }
}

template <int ND>
int by_solver(const Call& c, int riemann, int riemann2d) {
  switch (riemann) {
    case 0: return by_corner<ND, 0>(c, riemann2d);
    case 1: return by_corner<ND, 1>(c, riemann2d);
    case 2: return by_corner<ND, 2>(c, riemann2d);
    case 3: return by_corner<ND, 3>(c, riemann2d);
    default: return by_corner<ND, 4>(c, riemann2d);
  }
}

// The box and the configuration into c.g, c.k; cudaErrorInvalidValue for
// what the kernel does not take.
int configure(Call& c, int ndim, int n0, int n1, int n2, int npassive,
              int riemann, int riemann2d, int slope_type, int chunk) {
  if (ndim < 1 || ndim > 3) return (int)cudaErrorInvalidValue;
  if (riemann < 0 || riemann > 4 || riemann2d < 0 || riemann2d > 6)
    return (int)cudaErrorInvalidValue;
  if (npassive < 0 || npassive > MAX_PASSIVE) return (int)cudaErrorInvalidValue;
  if (slope_type != 0 && slope_type != 1 && slope_type != 2 && slope_type != 7
      && slope_type != 8)
    return (int)cudaErrorInvalidValue;
  const int n[3] = {n0, ndim > 1 ? n1 : 1, ndim == 3 ? n2 : 1};
  Geo& g = c.g;
  g.nv = NV + npassive;
  for (int a = 0; a < 3; ++a) {
    if (n[a] < 1 || n[a] > (1 << 28)) return (int)cudaErrorInvalidValue;
    g.e[a] = (a < ndim) ? n[a] + 4 : 1;
  }
  if (chunk < 0) return (int)cudaErrorInvalidValue;
  g.ch = chunk;
  // grid.y is at most 65535 blocks (grid.z is checked at launch)
  if (ndim == 3 && (n[2] + Tile<3>::T1 - 1) / Tile<3>::T1 > 65535)
    return (int)cudaErrorInvalidValue;
  const int fe[3] = {n[0] + 6, ndim > 1 ? n[1] + 6 : 1, ndim > 2 ? n[2] + 6 : 1};
  g.s[2] = 1;
  g.s[1] = g.e[2];
  g.s[0] = (int64_t)g.e[1] * g.e[2];
  g.np = g.s[0] * g.e[0];
  g.fs[2] = 1;
  g.fs[1] = fe[2];
  g.fs[0] = (int64_t)fe[1] * fe[2];
  g.nf = g.fs[0] * fe[0];
  g.is[2] = 1;
  g.is[1] = n[2];
  g.is[0] = (int64_t)n[1] * n[2];
  g.ni = g.is[0] * n[0];
  if (ndim == 2) {  // the 2D box is [e0][e1]: axis 1 is the contiguous one
    g.s[1] = 1;
    g.s[0] = g.e[1];
    g.s[2] = 0;
    g.fs[1] = 1;
    g.fs[0] = fe[1];
    g.fs[2] = 0;
    g.is[1] = 1;
    g.is[0] = n[1];
    g.is[2] = 0;
  }
  return 0;
}

int dispatch(const Call& c, int ndim, int riemann, int riemann2d) {
  return ndim == 1 ? by_solver<1>(c, riemann, riemann2d)
         : ndim == 2 ? by_solver<2>(c, riemann, riemann2d)
                     : by_solver<3>(c, riemann, riemann2d);
}

}  // namespace

// The largest passive count ramses_mhd_ct takes.
extern "C" int ramses_mhd_ct_max_passive() { return MAX_PASSIVE; }

// up: [8 + npassive, *sp+4], bf: [3, *sp+6] f32 contiguous; okp: [*sp+4]
// f32 0/1 or NULL; ovm, ovv: [npair, *sp+4] f32 (mask 0/1, values) or
// NULL; dt: one f32 on the device; un: [8 + npassive, *sp], bfn: [3, *sp].
// n1 = 1 in 1D, n2 = 1 below 3D.  riemann: 0 llf, 1 hll, 2 hlld, 3 roe,
// 4 upwind; riemann2d: 0 average, 1 llf, 2 roe, 3 upwind, 4 hll, 5 hlla,
// 6 hlld; slope_type 0, 1, 2, 7 or 8 (slope_factor: 1, 2 or theta).
// chunk: rows of axis 0 a block updates (2D, 3D), or 0 to choose them from
// the box and the card; the result does not depend on it.
// One launch on `stream`, no synchronisation, nothing allocated; returns
// the error of cudaFuncSetAttribute or of the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int ramses_mhd_ct(
    const float* up, const float* bf, const float* okp, const float* ovm,
    const float* ovv, const float* dt, float* un, float* bfn, int ndim,
    int n0, int n1, int n2, int npassive, int riemann, int riemann2d,
    int slope_type, float slope_factor, float gamma, float gm1, float g2,
    float ig1, float smallr, float smallc, float smallc2, float pfloor,
    float eint_floor, float dx0, float dx1, float dx2, int chunk,
    void* stream) {
  if ((ovm == nullptr) != (ovv == nullptr)) return (int)cudaErrorInvalidValue;
  Call c;
  int err = configure(c, ndim, n0, n1, n2, npassive, riemann, riemann2d,
                      slope_type, chunk);
  if (err) return err;
  c.up = up; c.bf = bf; c.okp = okp; c.ovm = ovm; c.ovv = ovv; c.dt = dt;
  c.un = un; c.bfn = bfn;
  c.s = (cudaStream_t)stream;
  c.info = nullptr;
  MConsts& k = c.k;
  k.gamma = gamma; k.gm1 = gm1; k.g2 = g2; k.ig1 = ig1;
  k.smallr = smallr; k.smallc = smallc; k.smallc2 = smallc2;
  k.pfloor = pfloor; k.eint_floor = eint_floor;
  k.slope = slope_factor; k.slope_type = slope_type;
  k.dx[0] = dx0; k.dx[1] = dx1; k.dx[2] = dx2;
  return dispatch(c, ndim, riemann, riemann2d);
}

// The launch's resources on the current device for (ndim, riemann,
// riemann2d, npassive), codes as ramses_mhd_ct's: out[0] resident blocks an
// SM, out[1] dynamic shared memory a block (bytes), out[2] registers a
// thread, out[3] local memory a thread (bytes; spills), out[4] threads a
// block.  Returns the first CUDA error.
extern "C" int ramses_mhd_ct_info(int ndim, int riemann, int riemann2d,
                                  int npassive, int* out) {
  Call c;
  int err = configure(c, ndim, 8, 8, 8, npassive, riemann, riemann2d, 1, 0);
  if (err) return err;
  c.info = out;
  out[4] = ndim == 1 ? Tile<1>::NT : ndim == 2 ? Tile<2>::NT : Tile<3>::NT;
  return dispatch(c, ndim, riemann, riemann2d);
}
