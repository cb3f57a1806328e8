"""RT ↔ hydro coupling on the uniform grid (PyTorch).

Port of ``ramses_tpu/rt/coupling.py``, the in-driver role of the
reference's ``rt_step`` call chain (``amr/amr_step.f90:594-672``: rho/T from
the hydro state → subcycled M1 transport + thermochemistry → photoheated
temperature written back into the gas energy).  Unit bridging follows
``amr/units.f90`` / ``rt/rt_init.f90``: the RT system runs in cgs, the gas
in user units.

The JAX package round-trips the gas through host numpy at every call; here
the density, the temperature and the energy write-back are f64 torch on
the gas's device, and nothing is fetched.  Where the JAX package's numpy
divides by a Python number the port divides by a 0-d tensor (on CUDA,
PyTorch multiplies by the reciprocal of a Python-number divisor).
"""

from __future__ import annotations

import torch

from ramses_tpu_torch.rt.chem import divisor
from ramses_tpu_torch.rt.driver import F64, RtSim, RtSpec
from ramses_tpu_torch.units import X_frac, mH


class RtCoupled:
    """Owns an :class:`RtSim` whose density/temperature track the gas."""

    def __init__(self, params, grid, un, u0):
        self.params = params
        self.grid = grid
        self.un = un
        spec = RtSpec.from_params(params)
        self.spec = spec
        x_frac = 1.0 - spec.y_he if spec.y_he > 0 else X_frac
        self.x_frac = x_frac
        dx_cgs = grid.dx * un.scale_l
        # the ICs' density as it is (no smallr floor), as the JAX package
        self.sim = RtSim(grid.shape, dx_cgs, spec, self._nH(u0[0].to(F64)),
                         T=self._gas_T(u0), device=u0.device)
        r = params.rt
        # photon-budget bookkeeping for rt_stats: total registered
        # source rate [photons/s] and cumulative injected count
        self._ndot_total = 0.0
        self._injected = 0.0
        if float(r.rt_ndot) > 0.0:
            # rt_src_pos is in box-fraction units → cgs position
            pos = [float(v) * dx_cgs * grid.shape[d]
                   for d, v in enumerate(r.rt_src_pos[:spec.ndim])]
            self.sim.point_source(pos, float(r.rt_ndot))
            self._ndot_total += float(r.rt_ndot)
        # rt_nsource point/beam list (rad_beams.nml usage): per-source
        # box-unit centres, photons/s rates, optional beam direction
        for k in range(int(r.rt_nsource)):
            stype = (r.rt_source_type[k]
                     if k < len(r.rt_source_type) else "point")
            if str(stype).strip("'\" ") != "point":
                raise NotImplementedError(
                    f"rt_source_type={stype!r}: only 'point' sources "
                    "are wired (shells/squares via &RT_REGIONS role)")
            cen = [r.rt_src_x_center, r.rt_src_y_center,
                   r.rt_src_z_center]
            pos = [(float(cen[d][k]) if k < len(cen[d]) else 0.0)
                   * dx_cgs * grid.shape[d] for d in range(spec.ndim)]
            uvw = [r.rt_u_source, r.rt_v_source, r.rt_w_source]
            direction = None
            if any(k < len(uvw[d]) and float(uvw[d][k]) != 0.0
                   for d in range(spec.ndim)):
                direction = [float(uvw[d][k]) if k < len(uvw[d]) else 0.0
                             for d in range(spec.ndim)]
            rate = (float(r.rt_n_source[k])
                    if k < len(r.rt_n_source) else 0.0)
            self.sim.point_source(pos, rate, direction=direction)
            self._ndot_total += rate

    # ------------------------------------------------------------------
    def rt_stats(self, sim=None) -> dict:
        """Photon-budget stats (the reference's ``output_rt_stats``
        role): live photon count vs cumulative injected."""
        tot = self.sim.photon_total()
        inj = float(self._injected)
        return {"photons": tot, "injected": inj,
                "ratio": (tot / inj) if inj > 0.0 else 0.0}

    def load_state(self, injected: float = 0.0, **state):
        """Set the RT state (:meth:`RtSim.load_state`'s arrays) and the
        injected-photon count, e.g. from
        :func:`ramses_tpu_torch.convert.rt_state_from`."""
        self.sim.load_state(**state)
        self._injected = float(injected)

    def _rho(self, u):
        return torch.clamp(u[0].to(F64), min=self.grid.cfg.smallr)

    def _nH(self, rho):
        return rho * self.un.scale_d * self.x_frac / divisor(mH, rho)

    def _mu(self):
        """Mean molecular weight from the current ion state."""
        x = self.sim.x
        y = self.spec.y_he
        if y > 0:
            denom = (1.0 - y) * (1.0 + x) + 0.25 * y * (
                1.0 + self.sim.xHe2 + 2.0 * self.sim.xHe3)
        else:
            denom = (1.0 + x)
        return 1.0 / torch.clamp(denom, min=1e-10)

    def _mom2(self, u):
        cfg = self.grid.cfg
        return sum(u[1 + d].to(F64) ** 2 for d in range(cfg.ndim))

    def _gas_T(self, u):
        """Temperature [K] from the conservative gas state (μ = 1, neutral
        H, before the RT state exists)."""
        cfg = self.grid.cfg
        rho = self._rho(u)
        eint = u[cfg.ndim + 1].to(F64) - 0.5 * self._mom2(u) / rho
        p = (cfg.gamma - 1.0) * torch.clamp(eint, min=1e-300)
        t2 = p / rho * self.un.scale_T2          # T/mu
        mu = self._mu() if hasattr(self, "sim") else 1.0   # neutral H
        return torch.clamp(t2 * mu, min=0.1)

    def advance(self, u, dt_code: float):
        """Advance RT by ``dt_code`` (user units) against the current
        gas and return the gas state with the photoheated energy, in the
        gas's dtype.  Returns ``u`` itself without heating."""
        cfg = self.grid.cfg
        un = self.un
        # refresh density + temperature from the (possibly moved) gas
        self.sim.nH = self._nH(self._rho(u))
        self.sim.T = self._gas_T(u)
        dt_cgs = float(dt_code) * un.scale_t
        self._injected += self._ndot_total * dt_cgs
        self.sim.advance(dt_cgs)
        if not self.spec.heating:
            return u
        # write the updated temperature back into the gas energy
        rho = self._rho(u)
        p_code = rho * (self.sim.T / self._mu()) / divisor(un.scale_T2, rho)
        e_new = (p_code / divisor(cfg.gamma - 1.0, rho)
                 + 0.5 * self._mom2(u) / rho)
        out = u.clone()
        out[cfg.ndim + 1] = e_new.to(u.dtype)
        return out
