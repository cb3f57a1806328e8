"""1D MHD Riemann solvers on rotated interface states (PyTorch).

Port of ``ramses_tpu/mhd/riemann.py``: the per-direction solvers of
``mag_unsplit`` (``mhd/umuscl.f90:1393``; options llf|hll|hlld,
``hydro/read_hydro_params.f90:184-223``).  HLLD follows Miyoshi & Kusano
(2005), branchless with ``torch.where`` region selection.

Interface layout (normal first): [ρ, v_n, v_t1, v_t2, P, B_n, B_t1, B_t2,
passives…].  The normal field ``B_n`` is the staggered face value, shared
by both sides (slot 5 of ql/qr is ignored; ``bn`` is passed separately).
Returned flux layout matches; the B_n flux slot is zero.
"""

from __future__ import annotations

import torch

from ramses_tpu_torch.mhd.core import MhdStatic

_EPS = 1e-30


def _split(q, bn):
    return (q[0], q[1], q[2], q[3], q[4], bn, q[6], q[7])


def _cons(r, vn, vt1, vt2, p, bn, bt1, bt2, gamma):
    e = (p / (gamma - 1.0) + 0.5 * r * (vn * vn + vt1 * vt1 + vt2 * vt2)
         + 0.5 * (bn * bn + bt1 * bt1 + bt2 * bt2))
    return [r, r * vn, r * vt1, r * vt2, e, bn, bt1, bt2]


def _flux(r, vn, vt1, vt2, p, bn, bt1, bt2, gamma):
    b2 = bn * bn + bt1 * bt1 + bt2 * bt2
    ptot = p + 0.5 * b2
    vdotb = vn * bn + vt1 * bt1 + vt2 * bt2
    e = (p / (gamma - 1.0) + 0.5 * r * (vn * vn + vt1 * vt1 + vt2 * vt2)
         + 0.5 * b2)
    return [r * vn,
            r * vn * vn - bn * bn + ptot,
            r * vn * vt1 - bn * bt1,
            r * vn * vt2 - bn * bt2,
            (e + ptot) * vn - bn * vdotb,
            torch.zeros_like(r),
            vn * bt1 - vt1 * bn,
            vn * bt2 - vt2 * bn]


def _fast(r, p, bn, bt1, bt2, gamma, smallc):
    c2 = gamma * p / r
    b2 = (bn * bn + bt1 * bt1 + bt2 * bt2) / r
    s = c2 + b2
    disc = torch.sqrt(torch.clamp(s * s - 4.0 * c2 * (bn * bn) / r, min=0.0))
    return torch.sqrt(torch.clamp(0.5 * (s + disc), min=smallc ** 2))


def _sanitize(q, cfg):
    r = torch.clamp(q[0], min=cfg.smallr)
    p = torch.clamp(q[4], min=cfg.smallr * cfg.smallc ** 2)
    return r, p


def solve(ql, qr, bn, cfg: MhdStatic):
    if cfg.riemann == "llf":
        f = llf(ql, qr, bn, cfg)
    elif cfg.riemann == "hll":
        f = hll(ql, qr, bn, cfg)
    elif cfg.riemann == "hlld":
        f = hlld(ql, qr, bn, cfg)
    elif cfg.riemann == "roe":
        from ramses_tpu_torch.mhd import roe as roemod
        f = roemod.roe(ql, qr, bn, cfg)
    elif cfg.riemann == "upwind":
        from ramses_tpu_torch.mhd import roe as roemod
        f = roemod.upwind(ql, qr, bn, cfg)
    else:
        raise NotImplementedError(f"mhd riemann={cfg.riemann}")
    if cfg.npassive:
        mass = f[0]
        pf = [torch.where(mass > 0.0, mass * ql[8 + s], mass * qr[8 + s])
              for s in range(cfg.npassive)]
        f = torch.cat([f, torch.stack(pf)], dim=0)
    return f


def llf(ql, qr, bn, cfg: MhdStatic):
    g = cfg.gamma
    rl, pl = _sanitize(ql, cfg)
    rr, pr = _sanitize(qr, cfg)
    sl = _split(ql, bn)
    sr = _split(qr, bn)
    al = _fast(rl, pl, bn, ql[6], ql[7], g, cfg.smallc) + torch.abs(ql[1])
    ar = _fast(rr, pr, bn, qr[6], qr[7], g, cfg.smallc) + torch.abs(qr[1])
    a = torch.maximum(al, ar)
    # the fluxes and states take the unfloored pressure, as the JAX
    # solver does (its _split passes q[4] through)
    fl = _flux(rl, *sl[1:5], bn, *sl[6:], g)
    fr = _flux(rr, *sr[1:5], bn, *sr[6:], g)
    ul = _cons(rl, *sl[1:5], bn, *sl[6:], g)
    ur = _cons(rr, *sr[1:5], bn, *sr[6:], g)
    return torch.stack([0.5 * (a1 + a2) - 0.5 * a * (u2 - u1)
                        for a1, a2, u1, u2 in zip(fl, fr, ul, ur)])


def _wave_bounds(ql, qr, bn, cfg):
    g = cfg.gamma
    rl, pl = _sanitize(ql, cfg)
    rr, pr = _sanitize(qr, cfg)
    cl = _fast(rl, pl, bn, ql[6], ql[7], g, cfg.smallc)
    cr = _fast(rr, pr, bn, qr[6], qr[7], g, cfg.smallc)
    sl_speed = torch.minimum(ql[1] - cl, qr[1] - cr)
    sr_speed = torch.maximum(ql[1] + cl, qr[1] + cr)
    return rl, pl, rr, pr, sl_speed, sr_speed


def hll(ql, qr, bn, cfg: MhdStatic):
    g = cfg.gamma
    rl, pl, rr, pr, SL, SR = _wave_bounds(ql, qr, bn, cfg)
    fl = _flux(rl, ql[1], ql[2], ql[3], pl, bn, ql[6], ql[7], g)
    fr = _flux(rr, qr[1], qr[2], qr[3], pr, bn, qr[6], qr[7], g)
    ul = _cons(rl, ql[1], ql[2], ql[3], pl, bn, ql[6], ql[7], g)
    ur = _cons(rr, qr[1], qr[2], qr[3], pr, bn, qr[6], qr[7], g)
    SLc = torch.clamp(SL, max=0.0)
    SRc = torch.clamp(SR, min=0.0)
    den = SRc - SLc + _EPS
    return torch.stack([
        (SRc * f1 - SLc * f2 + SLc * SRc * (u2 - u1)) / den
        for f1, f2, u1, u2 in zip(fl, fr, ul, ur)])


def hlld(ql, qr, bn, cfg: MhdStatic):
    """Miyoshi & Kusano (2005) five-wave solver, fully vectorized."""
    g = cfg.gamma
    rl, pl, rr, pr, SL, SR = _wave_bounds(ql, qr, bn, cfg)
    vnl, vt1l, vt2l, bt1l, bt2l = ql[1], ql[2], ql[3], ql[6], ql[7]
    vnr, vt1r, vt2r, bt1r, bt2r = qr[1], qr[2], qr[3], qr[6], qr[7]
    bn2 = bn * bn
    b2l = bn2 + bt1l * bt1l + bt2l * bt2l
    b2r = bn2 + bt1r * bt1r + bt2r * bt2r
    ptl = pl + 0.5 * b2l
    ptr = pr + 0.5 * b2r

    dl = rl * (SL - vnl)
    dr = rr * (SR - vnr)
    SM = (dr * vnr - dl * vnl - ptr + ptl) / (dr - dl + _EPS)
    pts = (dr * ptl - dl * ptr + dl * dr * (vnr - vnl)) / (dr - dl + _EPS)

    # star states
    rsl = dl / (SL - SM + _EPS)
    rsr = dr / (SR - SM + _EPS)
    denl = dl * (SL - SM) - bn2
    denr = dr * (SR - SM) - bn2
    tl = torch.abs(SL) + torch.abs(vnl)
    tr = torch.abs(SR) + torch.abs(vnr)
    degl = torch.abs(denl) < 1e-12 * (rl * (tl * tl) + bn2 + _EPS)
    degr = torch.abs(denr) < 1e-12 * (rr * (tr * tr) + bn2 + _EPS)
    safe_denl = torch.where(degl, 1.0, denl)
    safe_denr = torch.where(degr, 1.0, denr)
    vt1sl = torch.where(degl, vt1l,
                        vt1l - bn * bt1l * (SM - vnl) / safe_denl)
    vt2sl = torch.where(degl, vt2l,
                        vt2l - bn * bt2l * (SM - vnl) / safe_denl)
    bt1sl = torch.where(degl, bt1l,
                        bt1l * (dl * (SL - vnl) - bn2) / safe_denl)
    bt2sl = torch.where(degl, bt2l,
                        bt2l * (dl * (SL - vnl) - bn2) / safe_denl)
    vt1sr = torch.where(degr, vt1r,
                        vt1r - bn * bt1r * (SM - vnr) / safe_denr)
    vt2sr = torch.where(degr, vt2r,
                        vt2r - bn * bt2r * (SM - vnr) / safe_denr)
    bt1sr = torch.where(degr, bt1r,
                        bt1r * (dr * (SR - vnr) - bn2) / safe_denr)
    bt2sr = torch.where(degr, bt2r,
                        bt2r * (dr * (SR - vnr) - bn2) / safe_denr)

    el = (pl / (g - 1.0) + 0.5 * rl * (vnl * vnl + vt1l * vt1l
                                       + vt2l * vt2l) + 0.5 * b2l)
    er = (pr / (g - 1.0) + 0.5 * rr * (vnr * vnr + vt1r * vt1r
                                       + vt2r * vt2r) + 0.5 * b2r)
    vbl = vnl * bn + vt1l * bt1l + vt2l * bt2l
    vbsl = SM * bn + vt1sl * bt1sl + vt2sl * bt2sl
    vbr = vnr * bn + vt1r * bt1r + vt2r * bt2r
    vbsr = SM * bn + vt1sr * bt1sr + vt2sr * bt2sr
    esl = ((SL - vnl) * el - ptl * vnl + pts * SM + bn * (vbl - vbsl)) \
        / (SL - SM + _EPS)
    esr = ((SR - vnr) * er - ptr * vnr + pts * SM + bn * (vbr - vbsr)) \
        / (SR - SM + _EPS)

    # Alfvén (double-star) states
    sq_rsl = torch.sqrt(torch.clamp(rsl, min=cfg.smallr))
    sq_rsr = torch.sqrt(torch.clamp(rsr, min=cfg.smallr))
    SLs = SM - torch.abs(bn) / sq_rsl
    SRs = SM + torch.abs(bn) / sq_rsr
    sgn = torch.sign(bn)                 # sign(0) = 0, as jnp.sign
    ssum = sq_rsl + sq_rsr + _EPS
    vt1ss = (sq_rsl * vt1sl + sq_rsr * vt1sr
             + sgn * (bt1sr - bt1sl)) / ssum
    vt2ss = (sq_rsl * vt2sl + sq_rsr * vt2sr
             + sgn * (bt2sr - bt2sl)) / ssum
    bt1ss = (sq_rsl * bt1sr + sq_rsr * bt1sl
             + sgn * sq_rsl * sq_rsr * (vt1sr - vt1sl)) / ssum
    bt2ss = (sq_rsl * bt2sr + sq_rsr * bt2sl
             + sgn * sq_rsl * sq_rsr * (vt2sr - vt2sl)) / ssum
    vbssl = SM * bn + vt1ss * bt1ss + vt2ss * bt2ss
    essl = esl - sq_rsl * sgn * (vbsl - vbssl)
    essr = esr + sq_rsr * sgn * (vbsr - vbssl)

    def pack(r, vn, vt1, vt2, e, bt1, bt2):
        return [r, r * vn, r * vt1, r * vt2, e, bn, bt1, bt2]

    ul = _cons(rl, vnl, vt1l, vt2l, pl, bn, bt1l, bt2l, g)
    ur = _cons(rr, vnr, vt1r, vt2r, pr, bn, bt1r, bt2r, g)
    usl = pack(rsl, SM, vt1sl, vt2sl, esl, bt1sl, bt2sl)
    usr = pack(rsr, SM, vt1sr, vt2sr, esr, bt1sr, bt2sr)
    ussl = pack(rsl, SM, vt1ss, vt2ss, essl, bt1ss, bt2ss)
    ussr = pack(rsr, SM, vt1ss, vt2ss, essr, bt1ss, bt2ss)
    fl = _flux(rl, vnl, vt1l, vt2l, pl, bn, bt1l, bt2l, g)
    fr = _flux(rr, vnr, vt1r, vt2r, pr, bn, bt1r, bt2r, g)

    out = []
    for k in range(8):
        fsl = fl[k] + SL * (usl[k] - ul[k])
        fsr = fr[k] + SR * (usr[k] - ur[k])
        fssl = fsl + SLs * (ussl[k] - usl[k])
        fssr = fsr + SRs * (ussr[k] - usr[k])
        f = torch.where(SL > 0.0, fl[k],
                        torch.where(SLs > 0.0, fsl,
                                    torch.where(SM > 0.0, fssl,
                                                torch.where(SRs > 0.0, fssr,
                                                            torch.where(
                                                                SR > 0.0, fsr,
                                                                fr[k])))))
        out.append(f)
    return torch.stack(out)
