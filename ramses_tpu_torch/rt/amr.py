"""Radiative transfer on the AMR hierarchy (M1 + thermochemistry), PyTorch.

Port of ``ramses_tpu/rt/amr.py``.  The reference subcycles ``rt_step``
inside ``amr_step`` per level (``amr/amr_step.f90:594-672``,
``rt/rt_godunov_fine.f90``).  Here the radiation state lives as per-level
flat f64 rows next to the gas state and advances at coarse-step cadence
with RT-Courant substeps, each substep:

  * the sources: the point source (``rt_ndot``), the stellar particles of
    the SED tables and the sink-spawned stellar objects (Vacca fit), each
    an add into its NGP cell's rows;
  * COMPLETE levels: the rows → the dense box ``[ng·(1+nd), *sp]`` (one
    gather), one launch of K8's dense entry, and back;
  * PARTIAL levels: the 6^d oct stencils gathered with minmod-interpolated
    coarse ghosts (``amr/kernels.interp_cells`` with itype 1 and
    ``_gather_uloc``, as the hydro sweep gathers them) and one launch of
    K8's block entry, which writes each oct's interior cells into the rows;
  * the photochemistry per level, one launch of K9 each, on the N columns
    of the rows in place (the gray H system, or with ``rt_ngroups > 1`` /
    ``rt_y_he > 0`` the multigroup 3-ion ladder), against the gas density
    and temperature at the start of the advance; the UV background
    (``rt_uv_hom``) adds its rates;
  * restriction (``restrict_upload``) of ``rad``, ``xion`` and ``xhe``.

After the substeps the integrated temperature change is written back into
the gas energy.  Row layout: ``rad[l]`` is ``[ncell_pad, ng·(1+nd)]`` —
group-major (N, F_x..F_z) blocks, so every index kernel (gather, interp,
restriction, regrid migration) moves ALL groups in one call.  Regrid
migration replays the hierarchy's host prolongation maps (``_mig_log``),
so an RT hierarchy never takes the device migrate (K7), as in the JAX
package.  Nothing is fetched inside the substep loop: ``nsub`` and the
source lists come from the host once a coarse step.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, NamedTuple

import numpy as np
import torch

from ramses_tpu_torch.amr import kernels as K
from ramses_tpu_torch.rt import chem as chem_mod
from ramses_tpu_torch.rt import m1
from ramses_tpu_torch.rt.chem import divisor
from ramses_tpu_torch.rt.driver import F64, RtSpec
from ramses_tpu_torch.units import X_frac, mH


class _Cols(NamedTuple):
    """ndim/nvar-only cfg of the generic gather/interp/restrict kernels
    for ``nvar`` columns of RT rows (the JAX package's ``_CfgShim``)."""
    ndim: int
    nvar: int


def _levels_of(sim, pos: np.ndarray) -> np.ndarray:
    """Finest level covering each position (``assign_levels`` on the host,
    in f64)."""
    from ramses_tpu_torch.pm.amr_pm import assign_levels
    return assign_levels(sim.tree, torch.as_tensor(pos, dtype=F64),
                         sim.boxlen).numpy()


def _rows_at(sim, pos: np.ndarray, lvl: int) -> np.ndarray:
    from ramses_tpu_torch.pm.amr_physics import ngp_rows
    return ngp_rows(sim.tree, pos, lvl, sim.boxlen, sim.bc_kinds)


class RtAmrCoupled:
    """Owns the per-level radiation rows of an :class:`AmrSim`."""

    def __init__(self, sim, params, un):
        spec = RtSpec.from_params(params)
        self.spec = spec
        self.un = un
        self.params = params
        self.device = sim.device
        nd = sim.cfg.ndim
        self.nd = nd
        # multigroup/He surface: ng group-major (N, F) blocks per row,
        # He ion fractions ride a companion [ncp, 2] array
        self.full3 = spec.full3
        self.ng = len(spec.groups3) if self.full3 else 1
        self.x_frac = (1.0 - spec.y_he if spec.y_he > 0 else X_frac)
        self.rad: Dict[int, torch.Tensor] = {}
        self.xion: Dict[int, torch.Tensor] = {}
        self.xhe: Dict[int, torch.Tensor] = {}
        for l in sim.levels():
            ncp = sim.maps[l].ncell_pad
            self.rad[l] = self._fresh_rad(ncp)
            self.xion[l] = self._fresh_x(ncp)
            if self.full3:
                self.xhe[l] = self._fresh_he(ncp)
        # point source → NGP cell at its finest covering level
        r = params.rt
        self._src_info = self._point_source(sim)
        # stellar SED tables (rt/rt_spectra.f90): star particles become
        # photon sources with age/metallicity-dependent rates, and the
        # population refreshes the chemistry's group cross-sections
        self.sed = None
        if r.sed_dir or os.environ.get("RAMSES_SED_DIR"):
            from ramses_tpu_torch.rt.sed import SedTables, read_sed_dir
            g3 = spec.groups3
            bounds = [g.e_lo for g in g3] + [g3[-1].e_hi]
            self.sed = SedTables(read_sed_dir(r.sed_dir), bounds)
        self._esc = float(getattr(r, "rt_esc_frac", 1.0))
        self._sed_update = max(1, int(getattr(r, "sedprops_update", 5)))
        self._sed_count = 0
        self._star_src = {}
        self._sink_src = {}
        # cumulative photons injected by all sources [photons], the
        # denominator of the rt_stats conservation ratio (host floats: the
        # source rates are host numbers)
        self._injected = 0.0
        # homogeneous UV background (rt_UV_hom): amplitude follows the
        # cooling module's J21/a_spec/z_reion epoch dependence
        self.uv_on = bool(getattr(r, "rt_uv_hom", False))
        self._uv = None
        # substeps run since construction (each one K8 launch and one K9
        # launch a level)
        self.substeps = 0

    def _point_source(self, sim):
        """(level, row, photon density rate) of ``rt_ndot``'s cell, or
        None without it; recomputed after every migration (the cell may
        move level or row)."""
        r = self.params.rt
        if float(r.rt_ndot) <= 0.0:
            return None
        pos = np.asarray([[float(v) * sim.boxlen
                           for v in r.rt_src_pos[:self.nd]]])
        lsrc = int(_levels_of(sim, pos)[0])
        row = int(_rows_at(sim, pos, lsrc)[0])
        vol_cgs = (sim.dx(lsrc) * self.un.scale_l) ** self.nd
        return (lsrc, row, float(r.rt_ndot) / vol_cgs)

    def _refresh_stellar_sources(self, sim):
        """Rebuild per-level stellar injection lists from the SED tables
        and, at the ``sedprops_update`` cadence, refresh the chemistry's
        group properties to the population's photon-rate-weighted
        average (``rt_spectra.f90`` star_RT_feedback +
        update_SED_group_props roles).  One fetch of the particles."""
        self._star_src = {}
        if self.sed is None or sim.p is None:
            return
        from ramses_tpu_torch.pm.particles import FAM_STAR
        from ramses_tpu_torch.pm.star_formation import M_SUN
        p = sim.p
        sel = ((p.family == FAM_STAR) & p.active).cpu().numpy()
        if not sel.any():
            return
        un = self.un
        GYR = 3.15576e16
        tp = p.tp.to(F64).cpu().numpy()[sel]
        age_gyr = np.maximum((sim.t - tp) * un.scale_t / GYR, 0.0)
        zmet = p.zp.to(F64).cpu().numpy()[sel]
        m_sun = p.m.to(F64).cpu().numpy()[sel] * un.scale_d \
            * un.scale_l ** self.nd / M_SUN
        rates = self.sed.star_rates(age_gyr, zmet, m_sun) * self._esc
        pos = p.x.to(F64).cpu().numpy()[sel]
        levs = _levels_of(sim, pos)
        for l in sim.levels():
            at_l = levs == l
            if not at_l.any():
                continue
            rows = _rows_at(sim, pos[at_l], l)
            ok = rows >= 0
            if not ok.any():
                continue
            vol = (sim.dx(l) * un.scale_l) ** self.nd
            self._star_src[l] = (rows[ok], rates[at_l][ok] / vol)
        if self._sed_count % self._sed_update == 0:
            g3 = self.sed.population_groups(age_gyr, zmet, m_sun)
            if self.full3:
                self.spec = dataclasses.replace(self.spec, groups3=g3)
            else:
                # gray chemistry consumes spec.group, not groups3
                self.spec = dataclasses.replace(
                    self.spec, groups3=g3,
                    group=chem_mod.GroupSpec(sigma=g3[0].sigmaN[0],
                                             e_photon=g3[0].e_photon))
        self._sed_count += 1

    def _refresh_sink_sources(self, sim):
        """Sink RT (HII) feedback: sink-spawned stellar objects emit
        ionizing photons into their sink's NGP cell while younger than
        ``hii_t`` — the Vacca+96 ionizing-flux fit
        ``S(M) = stf_K·(M/m0)^a/(1+(M/m0)^b)^c``
        (``pm/sink_rt_feedback.f90`` ``gather_ioni_flux`` +
        ``sink_RT_vsweep_stellar``; the single-cell limit)."""
        self._sink_src = {}
        st = getattr(sim, "stellar", None)
        sp = getattr(sim, "stellar_spec", None)
        if (st is None or st.n == 0 or sim.sinks is None
                or sp is None or sp.hii_t_myr <= 0.0):
            return
        MYR = 3.15576e13
        age_s = (sim.t - st.tform) * self.un.scale_t
        live = age_s < sp.hii_t_myr * MYR
        if not live.any():
            return
        m = st.m[live]
        S = sp.stf_k * (m / sp.stf_m0) ** sp.stf_a \
            / (1.0 + (m / sp.stf_m0) ** sp.stf_b) ** sp.stf_c
        # photons follow the sink's CURRENT position, not the birth one
        sink_of = {int(i): k for k, i in enumerate(sim.sinks.idp)}
        snk = np.array([sink_of.get(int(s), -1)
                        for s in st.sink_idp[live]])
        ok = snk >= 0
        if not ok.any():
            return
        pos = np.asarray(sim.sinks.x)[snk[ok]]
        S = S[ok]
        levs = _levels_of(sim, pos)
        gidx = min(max(sp.fb_group, 0), self.ng - 1)
        for l in sim.levels():
            at_l = levs == l
            if not at_l.any():
                continue
            rows = _rows_at(sim, pos[at_l], l)
            okr = rows >= 0
            if not okr.any():
                continue
            vol = (sim.dx(l) * self.un.scale_l) ** self.nd
            dens = np.zeros((int(okr.sum()), self.ng))
            dens[:, gidx] = S[at_l][okr] / vol
            self._sink_src[l] = (rows[okr], dens)

    def _fresh_rad(self, ncp: int) -> torch.Tensor:
        """Vacuum radiation rows [ncp, ng*(1+nd)]."""
        rad = torch.zeros((ncp, self.ng * (1 + self.nd)), dtype=F64,
                          device=self.device)
        rad[:, ::1 + self.nd] = m1.SMALL_NP          # N columns
        return rad

    def _fresh_x(self, ncp: int) -> torch.Tensor:
        """Initial HII fraction rows (the reference's x_ini)."""
        return torch.full((ncp,), 1.2e-3, dtype=F64, device=self.device)

    def _fresh_he(self, ncp: int) -> torch.Tensor:
        """Initial (HeII, HeIII) fraction rows."""
        he = torch.empty((ncp, 2), dtype=F64, device=self.device)
        he[:, 0] = 1e-6
        he[:, 1] = 1e-8
        return he

    def _ncol(self, g: int) -> int:
        """Column of group ``g``'s photon density N."""
        return g * (1 + self.nd)

    def photon_total(self, sim) -> float:
        """Total photon count over leaf cells, all groups (Σ N·dV)."""
        tot = 0.0
        for l in sim.levels():
            rad = sim.tree_order_cells(self.rad[l], l)
            leaf = ~sim.tree.refined_mask(l)
            dv = (sim.dx(l) * self.un.scale_l) ** self.nd
            for g in range(self.ng):
                tot += float(np.sum(rad[leaf, self._ncol(g)])) * dv
        return tot

    def rt_stats(self, sim) -> dict:
        """Photon-budget stats (the reference's ``output_rt_stats`` role,
        ``amr/amr_step.f90:467``): live photon count vs cumulative
        injected; the ratio falls below 1 as gas absorbs."""
        tot = self.photon_total(sim)
        inj = float(self._injected)
        return {"photons": tot, "injected": inj,
                "ratio": (tot / inj) if inj > 0.0 else 0.0}

    def ionized_volume(self, sim) -> float:
        """Σ x dV over leaves (the Strömgren measure, code volume)."""
        tot = 0.0
        for l in sim.levels():
            x = sim.tree_order_cells(self.xion[l], l)
            leaf = ~sim.tree.refined_mask(l)
            tot += float(x[leaf].sum()) * sim.dx(l) ** self.nd
        return tot

    # ------------------------------------------------------------------
    def _mu(self, l):
        """Mean molecular weight rows from the current ion state
        (``rt_cooling_module``'s getMu with mass fractions X/Y)."""
        x = self.xion[l]
        y = self.spec.y_he
        if self.full3 and y > 0:
            xh2, xh3 = self.xhe[l][:, 0], self.xhe[l][:, 1]
            denom = (1.0 - y) * (1.0 + x) + 0.25 * y * (1.0 + xh2
                                                        + 2.0 * xh3)
        else:
            denom = 1.0 + x
        return 1.0 / torch.clamp(denom, min=1e-10)

    def _gas_nT(self, sim, l):
        """(nH [1/cc] f64, T [K] f64) rows of level ``l`` from the gas state,
        in the gas dtype until the f64 ion state joins, as the JAX
        package computes them."""
        cfg = sim.cfg
        u = sim.u[l]
        rho = torch.clamp(u[:, 0], min=cfg.smallr)
        mom2 = sum(u[:, 1 + d] ** 2 for d in range(cfg.ndim))
        eint = torch.clamp(u[:, cfg.ndim + 1] - 0.5 * mom2 / rho, min=1e-300)
        t2 = (cfg.gamma - 1.0) * eint / rho * self.un.scale_T2
        nH = rho * self.un.scale_d * self.x_frac / divisor(mH, rho)
        return nH.to(F64), torch.clamp(t2 * self._mu(l), min=0.1)

    def _refresh_uv(self, sim):
        if not self.uv_on:
            return
        from ramses_tpu_torch.hydro.cooling import uv_amplitude, uv_rates
        c = self.params.cooling
        aexp = sim.aexp_now() if sim.cosmo is not None else 1.0
        J = uv_amplitude(aexp, float(c.J21), float(c.z_reion),
                         bool(c.haardt_madau))
        if J > 0.0:
            g, h = uv_rates(J, float(c.a_spec))
            self._uv = ((g.get("HI", 0.0), g.get("HeI", 0.0),
                         g.get("HeII", 0.0)),
                        (h.get("HI", 0.0), h.get("HeI", 0.0),
                         h.get("HeII", 0.0)))
        else:
            self._uv = None

    def _add_sources(self, dt_sub, spec, dev_src):
        """One substep's injection into the rows (each an add on the
        device)."""
        if self._src_info is not None:
            lsrc, row, rate = self._src_info
            if self.full3:
                for g, grp in enumerate(spec.groups3):
                    self.rad[lsrc][row, self._ncol(g)] += \
                        dt_sub * rate * grp.frac
            else:
                self.rad[lsrc][row, 0] += dt_sub * rate
        for l, rows, dens in dev_src:
            rad = self.rad[l]
            if self.full3:
                for g in range(self.ng):
                    rad.index_put_((rows, torch.full_like(rows,
                                                          self._ncol(g))),
                                   dt_sub * dens[:, g], accumulate=True)
            else:
                rad.index_put_((rows, torch.zeros_like(rows)),
                               dt_sub * dens.sum(dim=1), accumulate=True)

    def _transport(self, sim, l, dt_sub, spec):
        """One K8 substep of every group on level ``l``."""
        nd, ng = self.nd, self.ng
        ncols = ng * (1 + nd)
        m, d = sim.maps[l], sim.dev[l]
        dx_cgs = sim.dx(l) * self.un.scale_l
        rad = self.rad[l]
        shim = _Cols(nd, ncols)
        if m.complete:
            shp = tuple(sim.tree.cell_dims(l))
            dense = K._rows_to_vars(rad, d.get("inv_perm"), shp)
            out = m1.transport(dense.reshape((ng, 1 + nd) + shp), dt_sub,
                               dx_cgs, spec.c_red, nd, spec.periodic)
            ncell = m.noct * (1 << nd)
            rows = K._vars_to_rows(out.reshape((ncols,) + shp),
                                   d.get("perm"), shp, ncell)
            if m.ncell_pad > ncell:
                rad = rad.clone()
                rad[:ncell] = rows
            else:
                rad = rows
        else:
            ghosts = K.interp_cells(self.rad[l - 1], d["interp_cell"],
                                    d["interp_nb"], d["interp_sgn"].to(F64),
                                    shim, itype=1)
            blk = K._gather_uloc(rad, ghosts, d["stencil_src"], None, shim)
            rad = m1.block_update(rad, blk, dt_sub, dx_cgs, spec.c_red, nd,
                                  ng)
        self.rad[l] = rad

    def _chemistry(self, l, nH, T, dt_sub, spec):
        """One K9 substep of level ``l`` (N updated in place in the rows);
        returns the new T rows."""
        rad = self.rad[l]
        if self.full3:
            nHe = nH * (spec.y_he / (4.0 * max(1.0 - spec.y_he, 1e-10)))
            Nv = rad[:, ::1 + self.nd].t()
            x, h2, h3, Tn = chem_mod.chem_3ion(
                Nv, self.xion[l], self.xhe[l][:, 0], self.xhe[l][:, 1], T,
                nH, nHe, dt_sub, spec.c_red, spec.groups3, spec.otsa,
                heating=spec.heating, uv=self._uv)
            self.xhe[l] = torch.stack([h2, h3], dim=1)
        else:
            x, Tn = chem_mod.chem_gray(
                rad[:, 0], self.xion[l], T, nH, dt_sub, spec.c_red,
                spec.group, spec.otsa, heating=spec.heating, uv=self._uv)
        self.xion[l] = x
        return Tn

    def _restrict(self, sim):
        nd = self.nd
        for l in sorted(sim.levels(), reverse=True):
            if sim.tree.has(l + 1):
                d = sim.dev[l]
                args = (d["ref_cell"], d["son_oct"])
                self.rad[l] = K.restrict_upload(
                    self.rad[l], self.rad[l + 1], *args,
                    _Cols(nd, self.ng * (1 + nd)))
                self.xion[l] = K.restrict_upload(
                    self.xion[l][:, None], self.xion[l + 1][:, None], *args,
                    _Cols(nd, 1))[:, 0]
                if self.full3:
                    self.xhe[l] = K.restrict_upload(
                        self.xhe[l], self.xhe[l + 1], *args, _Cols(nd, 2))

    def advance(self, sim, dt_code: float):
        """Subcycled RT over one coarse step against the live gas;
        writes photoheated energy back into ``sim.u``.  Returns the
        substeps run."""
        nd = self.nd
        if sim.cosmo is not None:
            # supercomoving unit scales are aexp-dependent: refresh
            # (cf. the cooling-scale refresh in step_coarse)
            from ramses_tpu_torch.units import units as units_fn
            self.un = units_fn(self.params, cosmo=sim.cosmo,
                               aexp=sim.aexp_now())
        spec = self.spec
        lmax_used = max(sim.levels())
        dx_min_cgs = sim.dx(lmax_used) * self.un.scale_l
        dt_cgs = float(dt_code) * self.un.scale_t
        dt_c = m1.rt_courant_dt(dx_min_cgs, spec.c_red, spec.courant)
        nsub = max(1, int(math.ceil(dt_cgs / dt_c)))
        dt_sub = dt_cgs / nsub
        self._refresh_stellar_sources(sim)
        self._refresh_sink_sources(sim)
        spec = self.spec              # groups3 may have been refreshed
        self._refresh_uv(sim)

        nT = {l: self._gas_nT(sim, l) for l in sim.levels()}
        T = {l: nT[l][1] for l in sim.levels()}
        T0 = dict(T)

        # photon-budget accounting (rt_stats): source rates are photon
        # DENSITY rates [1/cm^3/s]; × cell volume × dt gives counts
        if self._src_info is not None:
            lsrc, _row, rate = self._src_info
            vol = (sim.dx(lsrc) * self.un.scale_l) ** nd
            frac = sum(g.frac for g in spec.groups3) if self.full3 else 1.0
            self._injected += rate * vol * dt_cgs * frac
        dev_src = []
        for srcmap in (self._star_src, self._sink_src):
            for l, (rows, dens) in srcmap.items():
                vol = (sim.dx(l) * self.un.scale_l) ** nd
                self._injected += float(np.sum(dens)) * vol * dt_cgs
                dev_src.append((l, torch.as_tensor(rows, dtype=torch.int64,
                                                   device=self.device),
                                torch.as_tensor(dens, dtype=F64,
                                                device=self.device)))

        for _ in range(nsub):
            self._add_sources(dt_sub, spec, dev_src)
            # transport, coarse→fine (every group in one launch a level)
            for l in sim.levels():
                self._transport(sim, l, dt_sub, spec)
            # chemistry per level (pointwise; leaves authoritative); the
            # JAX package's hierarchy runs it under rt_pp too
            for l in sim.levels():
                T[l] = self._chemistry(l, nT[l][0], T[l], dt_sub, spec)
            # restriction fine→coarse
            self._restrict(sim)
        self.substeps += nsub

        if spec.heating:
            # write the integrated ΔT back into the gas energy
            cfg = sim.cfg
            for l in sim.levels():
                u = sim.u[l]
                rho = torch.clamp(u[:, 0], min=cfg.smallr)
                dT2 = (T[l] - T0[l]) / self._mu(l)
                de = rho * dT2 / divisor(self.un.scale_T2, dT2) \
                    / divisor(cfg.gamma - 1.0, dT2)
                u = u.clone()
                u[:, cfg.ndim + 1] += de.to(u.dtype)
                sim.u[l] = u
            sim._dt_cache = None
        return nsub

    # ------------------------------------------------------------------
    def apply_migration(self, sim):
        """Carry rad/xion/xhe through a regrid by replaying the hierarchy's
        logged host prolongation maps (the MHD face-field pattern), then
        relocate the point source's cell."""
        nd = self.nd
        ncols = self.ng * (1 + nd)
        new = ({}, {}, {})
        old = (self.rad, self.xion, self.xhe if self.full3 else None)
        fresh = (self._fresh_rad, self._fresh_x, self._fresh_he)
        # xion migrates as one column, xhe as two
        as_rows = (lambda a: a, lambda a: a[:, None], lambda a: a)
        back = (lambda a: a, lambda a: a[:, 0], lambda a: a)
        ncol = (ncols, 1, 2)
        for l in sim.levels():
            ncp = sim.maps[l].ncell_pad
            info = sim._mig_log.get(l)
            for k in range(3 if self.full3 else 2):
                if info is None:
                    cur = old[k].get(l)
                    new[k][l] = (cur if cur is not None
                                 and cur.shape[0] == ncp else fresh[k](ncp))
                    continue
                copy_dst, copy_src, new_octs, f_cell, nb, ncell_pad = info
                prev = old[k].get(l)
                if prev is None:
                    prev = fresh[k](1)
                coarse = new[k][l - 1] if l - 1 in new[k] else old[k][l - 1]
                new[k][l] = back[k](sim._migrate_level(
                    as_rows[k](prev), as_rows[k](coarse), ncell_pad,
                    copy_dst, copy_src, new_octs, f_cell, nb,
                    cfg=_Cols(nd, ncol[k]), itype=1))
        self.rad, self.xion = new[0], new[1]
        self.xhe = new[2] if self.full3 else {}
        # the source cell may have moved levels/rows
        self._src_info = self._point_source(sim)

    def load_state(self, rad, xion, xhe=None, injected: float = 0.0):
        """Set every level's rows (numpy or tensors, e.g. from
        :func:`ramses_tpu_torch.convert.rt_amr_state_from`) and the
        injected-photon count."""
        def dev(a):
            return torch.as_tensor(np.array(a), dtype=F64,
                                   device=self.device)
        self.rad = {l: dev(a) for l, a in rad.items()}
        self.xion = {l: dev(a) for l, a in xion.items()}
        self.xhe = {l: dev(a) for l, a in (xhe or {}).items()}
        self._injected = float(injected)
