"""Stellar objects from sinks and their supernova feedback, host numpy.

Port of ``ramses_tpu/pm/stellar.py`` (reference: ``pm/stellar_particle.f90``
make_stellar_from_sinks:1-84, create_stellar:89-186,
sample_powerlaw:234-264; ``pm/sink_sn_feedback.f90`` make_sn_stellar:1-296;
configured by &STELLAR_PARAMS, ``pm/read_sink_feedback_params.f90:15-21``).

Every ``stellar_msink_th`` of mass a sink accretes spawns one stellar
object whose mass is drawn from a power-law IMF on [imf_low, imf_high]
and whose lifetime follows ``lt_t0·exp(lt_a·(ln(lt_m0/m))^lt_b)``; when an
object outlives its lifetime it explodes, injecting ``sn_e_ref`` of
thermal energy into the cell that holds it at the finest covering level,
with the reference's saturation temperature cap (``Tsat``), then
disappears.  The objects are few and live on the host, like the sinks;
the draws come from the hierarchy's SF generator in the JAX package's
order, so a float64 run gives the same objects in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class StellarSpec:
    """&STELLAR_PARAMS subset."""
    enabled: bool = False
    stellar_msink_th: float = 0.0    # sink-mass quantum per object [code]
    imf_index: float = -2.35         # Salpeter by default
    imf_low: float = 8.0             # massive-star window [Msun-like]
    imf_high: float = 120.0
    lt_t0: float = 0.0               # lifetime fit [code time]
    lt_m0: float = 148.16            # fit mass scale
    lt_a: float = 0.238
    lt_b: float = 2.0
    sn_e_ref: float = 0.0            # SN energy [code]
    sn_direct: bool = False          # explode at birth (testing mode)
    Tsat: float = 1e50               # post-injection temperature cap
    # sink RT (HII) feedback parameters (pm/sink_feedback_parameters.f90:
    # 43-53), read by the radiative transfer (rt/amr.py)
    hii_t_myr: float = 0.0           # emitting lifetime [Myr]
    stf_k: float = 9.634642584812752e48   # photons/s
    stf_m0: float = 27.28098824280431     # Msun
    stf_a: float = 6.840015602892084
    stf_b: float = 4.353614230584390
    stf_c: float = 1.142166657042991
    fb_group: int = 0                # photon group receiving the flux

    @classmethod
    def from_params(cls, p) -> "StellarSpec":
        raw = p.raw.get("stellar_params", {}) if p.raw else {}

        def g(k, dflt):
            v = raw.get(k, dflt)
            return v[0] if isinstance(v, list) else v

        return cls(enabled=bool(raw),
                   stellar_msink_th=float(g("stellar_msink_th", 0.0)),
                   imf_index=float(g("imf_index", -2.35)),
                   imf_low=float(g("imf_low", 8.0)),
                   imf_high=float(g("imf_high", 120.0)),
                   lt_t0=float(g("lt_t0", 0.0)),
                   lt_m0=float(g("lt_m0", 148.16)),
                   lt_a=float(g("lt_a", 0.238)),
                   lt_b=float(g("lt_b", 2.0)),
                   sn_e_ref=float(g("sn_e_ref", 0.0)),
                   sn_direct=bool(g("sn_direct", False)),
                   Tsat=float(g("tsat", 1e50)),
                   hii_t_myr=float(g("hii_t", 0.0)),
                   stf_k=float(g("stf_k", cls.stf_k)),
                   stf_m0=float(g("stf_m0", cls.stf_m0)),
                   stf_a=float(g("stf_a", cls.stf_a)),
                   stf_b=float(g("stf_b", cls.stf_b)),
                   stf_c=float(g("stf_c", cls.stf_c)),
                   fb_group=int(g("feedback_photon_group", 1)) - 1)


def sample_powerlaw(rng: np.random.Generator, a: float, b: float,
                    alpha: float, n: int) -> np.ndarray:
    """n draws from p(x) ∝ x^alpha on [a, b] by inverse CDF
    (``sample_powerlaw``, stellar_particle.f90:234-264)."""
    u = rng.uniform(size=n)
    if abs(alpha + 1.0) < 1e-12:
        return a * (b / a) ** u
    p1 = alpha + 1.0
    return (a ** p1 + u * (b ** p1 - a ** p1)) ** (1.0 / p1)


def lifetime(m: np.ndarray, spec: StellarSpec) -> np.ndarray:
    """``lt_t0·exp(lt_a·(ln(lt_m0/m))^lt_b)`` (stellar_particle.f90:137)."""
    x = np.log(np.maximum(spec.lt_m0 / np.maximum(m, 1e-30), 1.0 + 1e-12))
    return spec.lt_t0 * np.exp(spec.lt_a * x ** spec.lt_b)


@dataclass
class StellarSet:
    """Host SoA of live stellar objects."""
    m: np.ndarray                    # IMF-sampled mass
    tform: np.ndarray
    tlife: np.ndarray
    x: np.ndarray                    # [n, ndim] (the sink position at birth)
    sink_idp: np.ndarray
    # persistent object ids (id_stellar), stable across SN removals
    idp: np.ndarray = None
    next_id: int = 1
    # per-sink accreted-mass accumulator toward the next quantum
    # (``dmfsink``), fed by the sink creation and accretion passes only,
    # so merger transfers are not counted as new accretion
    dmf: dict = field(default_factory=dict)

    @classmethod
    def empty(cls, ndim: int) -> "StellarSet":
        return cls(m=np.zeros(0), tform=np.zeros(0), tlife=np.zeros(0),
                   x=np.zeros((0, ndim)),
                   sink_idp=np.zeros(0, np.int64),
                   idp=np.zeros(0, np.int64))

    @property
    def n(self) -> int:
        return len(self.m)

    def add_accreted(self, sink_idp: int, dm: float):
        """Called by the sink passes for genuinely NEW mass (creation and
        gas accretion; merger transfers are excluded)."""
        self.dmf[int(sink_idp)] = self.dmf.get(int(sink_idp), 0.0) + dm


def make_stellar_from_sinks(sinks, stellar: StellarSet,
                            spec: StellarSpec,
                            rng: np.random.Generator, t: float):
    """Spawn one object per ``stellar_msink_th`` of NEW sink mass
    (make_stellar_from_sinks: the dmfsink accumulator loop)."""
    if spec.stellar_msink_th <= 0 or sinks.n == 0:
        return stellar
    live = {int(i) for i in sinks.idp}
    # drop accumulators of merged-away sinks (their already-credited
    # remainder dies with them, as in the reference's sink deletion)
    for sid in [k for k in stellar.dmf if k not in live]:
        del stellar.dmf[sid]
    for k in range(sinks.n):
        sid = int(sinks.idp[k])
        acc = stellar.dmf.get(sid, 0.0)
        nnew = int(acc / spec.stellar_msink_th)
        stellar.dmf[sid] = acc - nnew * spec.stellar_msink_th
        if nnew == 0:
            continue
        mnew = sample_powerlaw(rng, spec.imf_low, spec.imf_high,
                               spec.imf_index, nnew)
        tl = lifetime(mnew, spec)
        if spec.sn_direct:
            tl = np.zeros(nnew)
        stellar.m = np.concatenate([stellar.m, mnew])
        stellar.tform = np.concatenate([stellar.tform, np.full(nnew, t)])
        stellar.tlife = np.concatenate([stellar.tlife, tl])
        stellar.x = np.concatenate(
            [stellar.x, np.repeat(sinks.x[k:k + 1], nnew, axis=0)])
        stellar.sink_idp = np.concatenate(
            [stellar.sink_idp, np.full(nnew, sid, np.int64)])
        stellar.idp = np.concatenate(
            [stellar.idp,
             stellar.next_id + np.arange(nnew, dtype=np.int64)])
        stellar.next_id += nnew
    return stellar


def sn_from_stellar(sim, stellar: StellarSet, spec: StellarSpec):
    """Explode objects past their lifetime: inject ``sn_e_ref`` thermal
    energy into the containing cell at the finest covering level, with the
    ``Tsat`` cap of make_sn_stellar (sink_sn_feedback.f90:253-257); the
    object is then removed.  A level gets one fetch and one upload, and
    only where an object explodes."""
    from ramses_tpu_torch.pm.amr_physics import _host, _levels_of, _put
    from ramses_tpu_torch.pm.amr_physics import ngp_rows

    if stellar.n == 0 or spec.sn_e_ref <= 0:
        return stellar
    due = (sim.t - stellar.tform) >= stellar.tlife
    if not due.any():
        return stellar
    x = stellar.x[due]
    nd = sim.cfg.ndim
    gamma = float(sim.cfg.gamma)
    lv = _levels_of(sim, x)
    for l in sim.levels():
        sel = lv == l
        if not sel.any():
            continue
        rows = ngp_rows(sim.tree, x[sel], l, sim.boxlen, sim.bc_kinds)
        ok = rows >= 0
        if not ok.any():
            continue
        r = rows[ok]
        vol = sim.dx(l) ** nd
        u = _host(sim.u[l])
        # energy density, capped so the cell stays below Tsat in T2 units
        ed = np.full(len(r), spec.sn_e_ref / vol)
        if sim.units is not None and spec.Tsat < 1e49:
            dgas = np.maximum(u[r, 0], 1e-300)
            ed_lim = (spec.Tsat / sim.units.scale_T2 * dgas
                      / (gamma - 1.0))
            ed = np.minimum(ed, ed_lim)
        np.add.at(u[:, 1 + nd], r, ed)
        _put(sim, l, u)
    keep = ~due
    return StellarSet(m=stellar.m[keep], tform=stellar.tform[keep],
                      tlife=stellar.tlife[keep], x=stellar.x[keep],
                      sink_idp=stellar.sink_idp[keep],
                      idp=stellar.idp[keep], next_id=stellar.next_id,
                      dmf=stellar.dmf)
