// Device functions of the MUSCL-Hancock body shared by the port's hydro
// kernels: fused_muscl.cu (K1, the uniform / complete-level step) and
// oct_muscl.cu (K3 on blocked Morton tiles, K2 on per-oct stencils).
//
// The TPU kernels they replace share one body too (ramses_tpu/hydro/
// pallas_muscl.py _slopes, _llf_flux, _hllc_flux, used by pallas_oct.py):
// ctoprim -> TVD slopes -> trace3d predictor -> face states -> floors ->
// LLF/HLLC.  Only where a cell's conserved state comes from differs, so
// make_cell takes a loader: K1 maps ghost indices through the boundary
// kinds, K2/K3 read an already gathered block.  Every function computes
// what the TPU kernel computes, in the same f32 arithmetic order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Consts {
  float gamma, gm1, entho, smallr, smallc2, smallp, smalle, slope;
  float dx, fac;
};

// ctoprim of one cell: primitive state (r, vx, vy, vz, p) and 1/r.
__device__ __forceinline__ void cons_to_prim(float u0, float u1, float u2,
                                             float u3, float u4,
                                             const Consts& k, float q[5],
                                             float* ir_out) {
  float r = fmaxf(u0, k.smallr);
  float ir = 1.0f / r;
  float v0 = u1 * ir;
  float v1 = u2 * ir;
  float v2 = u3 * ir;
  float ek = 0.5f * (v0 * v0 + v1 * v1 + v2 * v2);
  float eint = fmaxf(u4 * ir - ek, k.smalle);
  q[0] = r;
  q[1] = v0;
  q[2] = v1;
  q[3] = v2;
  q[4] = k.gm1 * r * eint;
  *ir_out = ir;
}

// _slopes: TVD slope from (left, centre, right); sign(0) = 0 as jnp.sign.
__device__ __forceinline__ float slope(float ql, float q, float qr, float f) {
  float dl = q - ql;
  float dr = qr - q;
  float dcen = 0.5f * (dl + dr);
  float slop = f * fminf(fabsf(dl), fabsf(dr));
  float dlim = (dl * dr <= 0.0f) ? 0.0f : slop;
  float sgn = (dcen > 0.0f) ? 1.0f : ((dcen < 0.0f) ? -1.0f : 0.0f);
  return sgn * fminf(dlim, fabsf(dcen));
}

// One cell's primitives, slopes in the three directions and the trace3d
// source terms: everything its face states need.
struct Cell {
  float q[5];
  float dq[3][5];
  float sr0, sp0, sv0[3];
};

// Load(x, y, z, q, &ir) fills a cell's primitives and 1/r.
template <class Load>
__device__ __forceinline__ void make_cell(const Load& load, const Consts& k,
                                          int x, int y, int z, Cell& c) {
  float ir, irn;
  load(x, y, z, c.q, &ir);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float qm1[5], qp1[5];
    int e0 = d == 0, e1 = d == 1, e2 = d == 2;
    load(x - e0, y - e1, z - e2, qm1, &irn);
    load(x + e0, y + e1, z + e2, qp1, &irn);
#pragma unroll
    for (int v = 0; v < 5; ++v) c.dq[d][v] = slope(qm1[v], c.q[v], qp1[v], k.slope);
  }
  float divv = c.dq[0][1] + c.dq[1][2] + c.dq[2][3];
#define ADV(comp) (c.q[1] * c.dq[0][comp] + c.q[2] * c.dq[1][comp] + \
                   c.q[3] * c.dq[2][comp])
  c.sr0 = -ADV(0) - divv * c.q[0];
  c.sp0 = -ADV(4) - divv * k.gamma * c.q[4];
#pragma unroll
  for (int j = 0; j < 3; ++j) c.sv0[j] = -ADV(1 + j) - c.dq[j][4] * ir;
#undef ADV
}

// Face state of cell c in direction d: half=+0.5 its high face, -0.5 its low.
__device__ __forceinline__ void face_state(const Cell& c, const Consts& k,
                                           int d, float half, float dtdx2,
                                           float f[5]) {
  float rho = c.q[0] + half * c.dq[d][0] + c.sr0 * dtdx2;
  f[0] = (rho < k.smallr) ? c.q[0] : rho;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    f[1 + j] = c.q[1 + j] + half * c.dq[d][1 + j] + c.sv0[j] * dtdx2;
  f[4] = c.q[4] + half * c.dq[d][4] + c.sp0 * dtdx2;
}

// Floors of riemann.py _prims as the TPU kernel applies them: the pressure
// floor uses the unfloored density.
__device__ __forceinline__ void floor_face(float f[5], const Consts& k) {
  float r = f[0];
  f[0] = fmaxf(r, k.smallr);
  f[4] = fmaxf(f[4], r * k.smallp);
}

// _llf_flux: state-layout LLF flux (mass, mom_x, mom_y, mom_z, energy).
__device__ __forceinline__ void llf_flux(const float ql[5], const float qr[5],
                                         int d, const Consts& k, float out[5]) {
  float ul = ql[1 + d], ur = qr[1 + d];
  float cl = sqrtf(fmaxf(k.gamma * ql[4] / ql[0], k.smallc2));
  float cr = sqrtf(fmaxf(k.gamma * qr[4] / qr[0], k.smallc2));
  float cmax = fmaxf(fabsf(ul) + cl, fabsf(ur) + cr);
  float uc[2][5], fx[2][5];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float* q = s ? qr : ql;
    float un = s ? ur : ul;
    float r = q[0], p = q[4];
    float ek = 0.5f * r * (q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
    float et = p * k.entho + ek;
    uc[s][0] = r;
    uc[s][1] = r * q[1];
    uc[s][2] = r * q[2];
    uc[s][3] = r * q[3];
    uc[s][4] = et;
    float run = r * un;
    fx[s][0] = run;
#pragma unroll
    for (int c = 0; c < 3; ++c) fx[s][1 + c] = run * q[1 + c];
    fx[s][1 + d] = fx[s][1 + d] + p;
    fx[s][4] = un * (et + p);
  }
#pragma unroll
  for (int v = 0; v < 5; ++v)
    out[v] = 0.5f * (fx[0][v] + fx[1][v] - cmax * (uc[1][v] - uc[0][v]));
}

// _hllc_flux: HLLC with Toro sampling.  Every branch is computed and then
// selected, so a division in a branch not taken cannot reach the result.
__device__ __forceinline__ void hllc_flux(const float ql[5], const float qr[5],
                                          int d, const Consts& k, float out[5]) {
  float rl = ql[0], pl = ql[4], rr = qr[0], pr = qr[4];
  float ul = ql[1 + d], ur = qr[1 + d];
  float ekl = 0.5f * rl * (ql[1] * ql[1] + ql[2] * ql[2] + ql[3] * ql[3]);
  float ekr = 0.5f * rr * (qr[1] * qr[1] + qr[2] * qr[2] + qr[3] * qr[3]);
  float etotl = pl * k.entho + ekl;
  float etotr = pr * k.entho + ekr;
  float cfastl = sqrtf(fmaxf(k.gamma * pl / rl, k.smallc2));
  float cfastr = sqrtf(fmaxf(k.gamma * pr / rr, k.smallc2));
  float SL = fminf(ul, ur) - fmaxf(cfastl, cfastr);
  float SR = fmaxf(ul, ur) + fmaxf(cfastl, cfastr);
  float rcl = rl * (ul - SL);
  float rcr = rr * (SR - ur);
  float ustar = (rcr * ur + rcl * ul + (pl - pr)) / (rcr + rcl);
  float pstar = (rcr * pl + rcl * pr + rcl * rcr * (ul - ur)) / (rcr + rcl);
  float rstarl = rl * (SL - ul) / (SL - ustar);
  float etotstarl = ((SL - ul) * etotl - pl * ul + pstar * ustar) / (SL - ustar);
  float rstarr = rr * (SR - ur) / (SR - ustar);
  float etotstarr = ((SR - ur) * etotr - pr * ur + pstar * ustar) / (SR - ustar);
  bool sl_pos = SL > 0.0f, us_pos = ustar > 0.0f, sr_pos = SR > 0.0f;
#define SEL(a_l, a_sl, a_sr, a_r) \
  (sl_pos ? (a_l) : (us_pos ? (a_sl) : (sr_pos ? (a_sr) : (a_r))))
  float ro = SEL(rl, rstarl, rstarr, rr);
  float uo = SEL(ul, ustar, ustar, ur);
  float po = SEL(pl, pstar, pstar, pr);
  float etoto = SEL(etotl, etotstarl, etotstarr, etotr);
#undef SEL
  float fmass = ro * uo;
  out[0] = fmass;
  out[4] = (etoto + po) * uo;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[1 + c] = (c == d) ? fmass * uo + po
                          : fmass * (us_pos ? ql[1 + c] : qr[1 + c]);
}

template <int RS>
__device__ __forceinline__ void solve(float ql[5], float qr[5], int d,
                                      const Consts& k, float out[5]) {
  floor_face(ql, k);
  floor_face(qr, k);
  if (RS == 0) llf_flux(ql, qr, d, k, out);
  else hllc_flux(ql, qr, d, k, out);
}

}  // namespace
