"""Roe-type characteristic-upwind solver for adiabatic MHD (PyTorch).

Port of ``ramses_tpu/mhd/roe.py``, the counterpart of the reference's
``athena_roe`` (``mhd/godunov_utils.f90:878``, dispatched from
``mhd/umuscl.f90:1396`` for ``riemann='roe'`` and for the 2D corner
solver ``riemann2d='roe'``):

* Cargo & Gallice (1997) Roe averages — sqrt-density-weighted
  velocities and enthalpy, OPPOSITE-weighted transverse field, and the
  X/Y correction terms in the effective sound speed.
* Roe & Balsara (1996) normalized magnetosonic eigenvectors in
  PRIMITIVE variables.
* Wave strengths from a batched 7x7 linear solve ``R_p @ alpha = dW``
  (complete by construction), mapped to conserved variables through the
  analytic dU/dW Jacobian at the Roe mean.

The 7-wave system (Bn is a constant parameter of the interface):
entropy, 2 Alfven, 2 slow, 2 fast.  No entropy fix.  ``zero_flux``
multiplies the centred flux part (``mhd/umuscl.f90:1978`` passes 0).
"""

from __future__ import annotations

import math

import torch

from ramses_tpu_torch.mhd.core import MhdStatic
from ramses_tpu_torch.mhd.riemann import _fast

_EPS = 1e-30


def roe_mean(ql, qr, bn, g):
    """Cargo-Gallice averaged state and wave speeds: a dict of mean
    quantities over the trailing interface batch."""
    g1, g2 = g - 1.0, g - 2.0
    rl, rr = ql[0], qr[0]
    wl, wr = torch.sqrt(rl), torch.sqrt(rr)
    nrm = wl + wr
    d = wl * wr                                   # Roe density
    v = [(wl * ql[k] + wr * qr[k]) / nrm for k in (1, 2, 3)]

    def hside(q, r):
        # total enthalpy per unit mass H = (E + Ptot)/rho
        b2 = bn * bn + q[6] * q[6] + q[7] * q[7]
        e = q[4] / g1 + 0.5 * r * (q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) \
            + 0.5 * b2
        return (e + q[4] + 0.5 * b2) / r
    h = (wl * hside(ql, rl) + wr * hside(qr, rr)) / nrm
    # transverse field: OPPOSITE sqrt-rho weights (CG97)
    bt1 = (wl * qr[6] + wr * ql[6]) / nrm
    bt2 = (wl * qr[7] + wr * ql[7]) / nrm
    d6, d7 = qr[6] - ql[6], qr[7] - ql[7]
    x = (d6 * d6 + d7 * d7) / (2.0 * (nrm * nrm))
    y = (rl + rr) / (2.0 * d)

    vsq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    btsq = bt1 * bt1 + bt2 * bt2
    bt_starsq = (g1 - g2 * y) * btsq
    vaxsq = bn * bn / d
    hp = h - (vaxsq + btsq / d)
    asq = torch.clamp(g1 * (hp - 0.5 * vsq) - g2 * x, min=_EPS)
    ct2 = bt_starsq / d
    tsum = vaxsq + ct2 + asq
    tdif = vaxsq + ct2 - asq
    cf2_cs2 = torch.sqrt(tdif * tdif + 4.0 * asq * ct2)
    cfsq = 0.5 * (tsum + cf2_cs2)
    cf = torch.sqrt(cfsq)
    cssq = asq * vaxsq / torch.clamp(cfsq, min=_EPS)
    cs = torch.sqrt(cssq)
    a = torch.sqrt(asq)
    ca = torch.sqrt(vaxsq)

    bt = torch.sqrt(torch.clamp(btsq, min=0.0))
    deg_t = bt < 1e-12 * torch.sqrt(asq * d)      # no transverse field
    isq2 = 1.0 / math.sqrt(2.0)
    b1h = torch.where(deg_t, isq2, bt1 / torch.clamp(bt, min=_EPS))
    b2h = torch.where(deg_t, isq2, bt2 / torch.clamp(bt, min=_EPS))
    # alpha_f/alpha_s with the triple-umbilic conventions
    den = torch.clamp(cfsq - cssq, min=_EPS)
    af2 = torch.clamp((asq - cssq) / den, 0.0, 1.0)
    as2 = torch.clamp((cfsq - asq) / den, 0.0, 1.0)
    degen = (cfsq - cssq) <= 1e-12 * asq
    alf = torch.where(degen, 1.0, torch.sqrt(af2))
    als = torch.where(degen, 0.0, torch.sqrt(as2))
    s = torch.where(bn >= 0.0, 1.0, -1.0).to(d.dtype)
    return dict(d=d, v=v, h=h, bt1=bt1, bt2=bt2, a=a, asq=asq, ca=ca,
                cf=cf, cs=cs, b1h=b1h, b2h=b2h, alf=alf, als=als, s=s)


def _right_eigenvectors(m):
    """Primitive-variable right eigenvectors (Roe-Balsara normalized).

    Returns (lams [7, ...], R [7 rows(W), 7 waves, ...])."""
    d, v = m["d"], m["v"]
    a, ca, cf, cs = m["a"], m["ca"], m["cf"], m["cs"]
    b1h, b2h, alf, als, s = (m["b1h"], m["b2h"], m["alf"], m["als"],
                             m["s"])
    sqd = torch.sqrt(d)
    vn = v[0]
    zero = torch.zeros_like(d)
    one = torch.ones_like(d)

    def fast(sgn):
        # sgn = -1 for vn - cf, +1 for vn + cf
        return [d * alf,
                sgn * cf * alf,
                -sgn * cs * als * b1h * s,
                -sgn * cs * als * b2h * s,
                d * m["asq"] * alf,
                als * sqd * a * b1h,
                als * sqd * a * b2h]

    def slow(sgn):
        return [d * als,
                sgn * cs * als,
                sgn * cf * alf * b1h * s,
                sgn * cf * alf * b2h * s,
                d * m["asq"] * als,
                -alf * sqd * a * b1h,
                -alf * sqd * a * b2h]

    def alfven(sgn):
        # lambda = vn + sgn*ca ; dvt = -sgn*s*dBt/sqrt(d)
        dbt1, dbt2 = -b2h * sqd, b1h * sqd
        return [zero,
                zero,
                -sgn * s * dbt1 / sqd,
                -sgn * s * dbt2 / sqd,
                zero,
                dbt1,
                dbt2]

    entropy = [one, zero, zero, zero, zero, zero, zero]
    cols = [fast(-1.0), alfven(-1.0), slow(-1.0), entropy,
            slow(1.0), alfven(1.0), fast(1.0)]
    lams = torch.stack([vn - cf, vn - ca, vn - cs, vn,
                        vn + cs, vn + ca, vn + cf])
    R = torch.stack([torch.stack(col) for col in cols], dim=1)  # [row, wave]
    return lams, R


def _cons_of_prim_jac(m, bn, g):
    """dU/dW at the mean state; U=(rho, Mn, Mt1, Mt2, E, Bt1, Bt2)."""
    d, v = m["d"], m["v"]
    bt1, bt2 = m["bt1"], m["bt2"]
    vsq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    z = torch.zeros_like(d)
    o = torch.ones_like(d)
    ig1 = 1.0 / (g - 1.0)
    rows = [
        [o, z, z, z, z, z, z],
        [v[0], d, z, z, z, z, z],
        [v[1], z, d, z, z, z, z],
        [v[2], z, z, d, z, z, z],
        [0.5 * vsq, d * v[0], d * v[1], d * v[2], ig1 * o, bt1, bt2],
        [z, z, z, z, z, o, z],
        [z, z, z, z, z, z, o],
    ]
    return torch.stack([torch.stack(r) for r in rows])   # [7, 7, ...]


def roe_dissipation(ql, qr, bn, cfg: MhdStatic):
    """0.5 * sum_k |lam_k| alpha_k R^cons_k — the upwind half of the Roe
    flux, shared by the 1D solver and the 2D corner EMF."""
    g = cfg.gamma
    m = roe_mean(ql, qr, bn, g)
    lams, R = _right_eigenvectors(m)
    dW = torch.stack([qr[0] - ql[0], qr[1] - ql[1], qr[2] - ql[2],
                      qr[3] - ql[3], qr[4] - ql[4], qr[6] - ql[6],
                      qr[7] - ql[7]])
    # batched 7x7 solve: move the state axes to batch position
    batch_shape = dW.shape[1:]
    Rb = torch.movedim(R.reshape(7, 7, -1), -1, 0)        # [B, 7, 7]
    dWb = torch.movedim(dW.reshape(7, -1), -1, 0)[..., None]
    alpha = torch.linalg.solve(Rb, dWb)[..., 0]          # [B, 7]
    alpha = torch.movedim(alpha, 0, -1).reshape((7,) + tuple(batch_shape))
    M = _cons_of_prim_jac(m, bn, g)
    # R^cons[:, k] = M @ R[:, k]
    Rc = torch.einsum("ij...,jk...->ik...", M, R)
    return 0.5 * torch.einsum("k...,ik...->i...", torch.abs(lams) * alpha,
                              Rc)


def _flux_cons(q, bn, g):
    """(U, F) with the 7-row layout (Bn row dropped)."""
    r, vn, vt1, vt2, p, bt1, bt2 = (q[0], q[1], q[2], q[3], q[4],
                                    q[6], q[7])
    b2 = bn * bn + bt1 * bt1 + bt2 * bt2
    ptot = p + 0.5 * b2
    vdotb = vn * bn + vt1 * bt1 + vt2 * bt2
    e = p / (g - 1.0) + 0.5 * r * (vn * vn + vt1 * vt1 + vt2 * vt2) \
        + 0.5 * b2
    U = [r, r * vn, r * vt1, r * vt2, e, bt1, bt2]
    F = [r * vn,
         r * vn * vn - bn * bn + ptot,
         r * vn * vt1 - bn * bt1,
         r * vn * vt2 - bn * bt2,
         (e + ptot) * vn - bn * vdotb,
         vn * bt1 - vt1 * bn,
         vn * bt2 - vt2 * bn]
    return torch.stack(U), torch.stack(F)


def _expand8(f7):
    """Insert the zero Bn-flux row back (solver bank layout has 8)."""
    z = torch.zeros_like(f7[0])
    return torch.stack([f7[0], f7[1], f7[2], f7[3], f7[4], z, f7[5],
                        f7[6]])


def roe(ql, qr, bn, cfg: MhdStatic, zero_flux=1.0):
    """Roe flux in the rotated interface layout of the solver bank."""
    g = cfg.gamma
    rl = torch.clamp(ql[0], min=cfg.smallr)
    rr = torch.clamp(qr[0], min=cfg.smallr)
    pl = torch.clamp(ql[4], min=cfg.smallr * cfg.smallc ** 2)
    pr = torch.clamp(qr[4], min=cfg.smallr * cfg.smallc ** 2)
    qls = torch.cat([rl[None], ql[1:4], pl[None], ql[5:]])
    qrs = torch.cat([rr[None], qr[1:4], pr[None], qr[5:]])
    _, Fl = _flux_cons(qls, bn, g)
    _, Fr = _flux_cons(qrs, bn, g)
    diss = roe_dissipation(qls, qrs, bn, cfg)
    f7 = zero_flux * 0.5 * (Fl + Fr) - diss
    return _expand8(f7)


def upwind(ql, qr, bn, cfg: MhdStatic, zero_flux=1.0):
    """The reference's 1D 'upwind' solver semantics
    (``mhd/godunov_utils.f90:313``): centred flux minus |mean normal
    velocity| times the state jump."""
    g = cfg.gamma
    Ul, Fl = _flux_cons(ql, bn, g)
    Ur, Fr = _flux_cons(qr, bn, g)
    vmean = 0.5 * (ql[1] + qr[1])
    f7 = zero_flux * 0.5 * (Fl + Fr) - 0.5 * torch.abs(vmean) * (Ur - Ul)
    return _expand8(f7)


def llf_dissipation(ql, qr, bn, cfg: MhdStatic):
    """0.5 * max(|vn|+cfast) * dU in the 7-row layout (for the 2D corner
    assembly; the 1D llf lives in mhd.riemann)."""
    g = cfg.gamma
    Ul, _ = _flux_cons(ql, bn, g)
    Ur, _ = _flux_cons(qr, bn, g)

    def speed(q):
        return torch.abs(q[1]) + _fast(q[0], q[4], bn, q[6], q[7], g,
                                       cfg.smallc)
    a = torch.maximum(speed(ql), speed(qr))
    return 0.5 * a * (Ur - Ul)


def upwind_dissipation(ql, qr, bn, cfg: MhdStatic):
    Ul, _ = _flux_cons(ql, bn, cfg.gamma)
    Ur, _ = _flux_cons(qr, bn, cfg.gamma)
    vmean = 0.5 * (ql[1] + qr[1])
    return 0.5 * torch.abs(vmean) * (Ur - Ul)
