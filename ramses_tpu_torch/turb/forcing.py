"""OU forcing field in spectral space (PyTorch).

Port of ``ramses_tpu/turb/forcing.py``: the OU update of
``turb/turb_next_field.f90``, the Helmholtz projection of
``turb/turb_force_utils.f90`` (``proj_op``: solenoidal (I - kk/k²) and
compressive kk/k² mixed by ``comp_frac``) and the power spectra of
``calc_power_spectrum:65-102`` ('parabolic' 1-(|k|-2)², 'power_law'
|k|⁻², 'konstandin' 2-|k|).  The state is the complex128 spectral field
``[ndim, *kshape]`` on the device (an ``rfftn`` layout); each update is

    f ← f·exp(-dt/T) + sqrt(1-exp(-2dt/T))·P(N(0,1) + i N(0,1))·amp

with P the projection, and the acceleration is ``irfftn`` of each
component, normalised to ``turb_rms``.

The normal draws come from a ``torch.Generator`` on the field's device,
seeded with ``turb_seed``: the same seed on the same device gives the same
field bit for bit.  The JAX package draws from a JAX PRNG key, which
torch cannot continue, so the two packages' realisations differ; the
tests inject the JAX draws (``draws=``) to compare the arithmetic.
``save``/``load`` round-trip the field and the generator's state through
``turb_fields.npz`` (``write_turb_fields.f90``); a file the JAX package
wrote (a key, no generator state) keeps its field and re-seeds the
generator from ``turb_seed``, with the JAX package's own warning for a
restart without the file.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class TurbSpec:
    """&TURB_PARAMS (turb/turb_parameters.f90:36-51)."""
    enabled: bool = False
    turb_type: int = 1            # 1 driven evolving, 3 decaying
    seed: int = 0
    comp_frac: float = 1.0 / 3.0  # compressive fraction
    turb_T: float = 1.0           # autocorrelation time [code]
    turb_Ndt: int = 100           # OU updates per autocorrelation time
    turb_rms: float = 1.0         # target rms acceleration
    turb_min_rho: float = 1e-50
    spectrum: str = "parabolic"
    kmax: float = 3.0             # driving modes |k| <= kmax (box units)

    @classmethod
    def from_params(cls, p) -> "TurbSpec":
        raw = p.raw.get("turb_params", {}) if p.raw else {}

        def g(k, dflt):
            v = raw.get(k, dflt)
            return v[0] if isinstance(v, list) else v

        return cls(enabled=bool(g("turb", False)),
                   turb_type=int(g("turb_type", 1)),
                   seed=int(g("turb_seed", 0)),
                   comp_frac=float(g("comp_frac", 1.0 / 3.0)),
                   turb_T=float(g("turb_t", 1.0)),
                   turb_Ndt=int(g("turb_ndt", 100)),
                   turb_rms=float(g("turb_rms", 1.0)),
                   turb_min_rho=float(g("turb_min_rho", 1e-50)),
                   spectrum=str(g("forcing_power_spectrum", "parabolic")))


def _kgrid(shape: Sequence[int]):
    """Integer wavenumber arrays for an rfftn layout (last axis halved)."""
    ndim = len(shape)
    ks = []
    for d in range(ndim - 1):
        ks.append(np.fft.fftfreq(shape[d]) * shape[d])
    ks.append(np.fft.rfftfreq(shape[-1]) * shape[-1])
    return np.meshgrid(*ks, indexing="ij")


def _power(kmag, spec: TurbSpec):
    if spec.spectrum == "parabolic":
        p = 1.0 - (kmag - 2.0) ** 2
    elif spec.spectrum == "power_law":
        with np.errstate(divide="ignore"):
            p = np.where(kmag > 0, kmag ** -2.0, 0.0)
    elif spec.spectrum == "konstandin":
        p = 2.0 - kmag
    else:
        raise ValueError(f"unknown forcing spectrum {spec.spectrum!r}")
    p = np.where((kmag >= 1.0 - 1e-9) & (kmag <= spec.kmax), p, 0.0)
    return np.maximum(p, 0.0)


class TurbForcing:
    """Driven-turbulence forcing field on an ``[n]*ndim`` grid, on
    ``device`` (CUDA unless the caller gives the CPU).

    ``draws``: optional list of ``(re, im)`` float arrays of the spectral
    field's shape, used in turn in place of the generator's normal draws
    (the spin-up first, then one pair an :meth:`update`), so that another
    package's draws can be replayed."""

    def __init__(self, shape: Sequence[int], spec: TurbSpec, device=None,
                 draws: Optional[list] = None):
        from ramses_tpu_torch.device import resolve_device
        self.shape = tuple(int(s) for s in shape)
        self.ndim = len(self.shape)
        self.spec = spec
        self.device = resolve_device(device)
        kk = _kgrid(self.shape)
        kmag = np.sqrt(sum(k ** 2 for k in kk))
        f64 = dict(dtype=torch.float64, device=self.device)
        self.amp = torch.as_tensor(np.sqrt(_power(kmag, spec)), **f64)
        kmag_safe = np.where(kmag > 0, kmag, 1.0)
        self.khat = [torch.as_tensor(k / kmag_safe, **f64) for k in kk]
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(spec.seed))
        self._draws = list(draws) if draws is not None else None
        # spin up to the stationary OU distribution (instant_turb)
        self.fhat = self._noise()

    def _normal_pair(self):
        if self._draws is not None:
            re, im = self._draws.pop(0)
            return (torch.tensor(np.asarray(re), dtype=torch.float64,
                                 device=self.device),
                    torch.tensor(np.asarray(im), dtype=torch.float64,
                                 device=self.device))
        shape = (self.ndim,) + tuple(self.amp.shape)
        re = torch.randn(shape, generator=self.gen, dtype=torch.float64,
                         device=self.device)
        im = torch.randn(shape, generator=self.gen, dtype=torch.float64,
                         device=self.device)
        return re, im

    def _noise(self):
        """Projected, amplitude-weighted random spectral field."""
        re, im = self._normal_pair()
        return self._project(torch.complex(re * self.amp, im * self.amp))

    def _project(self, f):
        """Helmholtz mix: (1-cf)·solenoidal + cf·compressive (``proj_op``,
        comp_frac weighting)."""
        cf = self.spec.comp_frac
        kdotf = sum(self.khat[d] * f[d] for d in range(self.ndim))
        comp = torch.stack([self.khat[d] * kdotf for d in range(self.ndim)])
        sol = f - comp
        return (1.0 - cf) * sol + cf * comp

    def update(self, dt: float):
        """OU step over ``dt`` (type 3 'decaying': no noise refresh)."""
        decay = float(np.exp(-dt / self.spec.turb_T))
        if self.spec.turb_type == 3:
            self.fhat = self.fhat * decay
            return
        noise = self._noise()
        self.fhat = self.fhat * decay + noise * float(
            np.sqrt(max(1.0 - decay ** 2, 0.0)))

    def acceleration(self):
        """Real-space acceleration ``[ndim, *shape]`` (float64),
        rms-normalised to ``turb_rms`` (``add_turb_forcing.f90``'s afac
        scaling)."""
        acc = torch.stack([torch.fft.irfftn(self.fhat[d], s=self.shape)
                           for d in range(self.ndim)])
        rms = torch.sqrt(torch.mean(torch.sum(acc ** 2, dim=0)))
        return acc * (self.spec.turb_rms / torch.clamp(rms, min=1e-300))

    # checkpoint (write_turb_fields.f90 / read_turb_fields.f90) ---------
    def save(self, path: str):
        """The field, the generator's state and its device type, and the
        grid shape, as ``.npz``."""
        np.savez(path, fhat=self.fhat.cpu().numpy(),
                 gen_state=self.gen.get_state().cpu().numpy(),
                 gen_device=np.asarray(self.device.type),
                 shape=np.asarray(self.shape))

    @classmethod
    def load(cls, path: str, spec: TurbSpec, device=None) -> "TurbForcing":
        """Restore :meth:`save`'s file; a file without a generator state
        of this device type (the JAX package's, which holds a JAX PRNG
        key) keeps its field, and the generator is a fresh forcing's,
        seeded from ``turb_seed``."""
        data = np.load(path)
        obj = cls(tuple(int(s) for s in data["shape"]), spec, device=device)
        obj.fhat = torch.as_tensor(np.asarray(data["fhat"],
                                              dtype=np.complex128),
                                   device=obj.device)
        if ("gen_state" in data.files
                and str(data["gen_device"]) == obj.device.type):
            obj.gen.set_state(torch.as_tensor(data["gen_state"]))
        else:
            # the generator stays as a fresh forcing leaves it (seeded,
            # past the spin-up draw), as the JAX package re-seeds without
            # the file
            warnings.warn(f"{path} holds no torch generator state for "
                          f"{obj.device.type}: the forcing keeps the saved "
                          "field, re-seeds from turb_seed and the restart "
                          "will not reproduce the original driving sequence")
        return obj


def apply_forcing(u, acc, dt, min_rho: float = 1e-50):
    """Momentum/energy kick from the acceleration field
    (``add_turb_forcing.f90``): Δ(ρv) = ρ a dt, ΔE = ½Δ(ρv)²/ρ; the
    acceleration is taken in the state's dtype."""
    ndim = acc.shape[0]
    acc = acc.to(u.dtype)
    rho = torch.clamp(u[0], min=min_rho)
    rows = [u[0]]
    de = torch.zeros_like(rho)
    for d in range(ndim):
        mom_old = u[1 + d]
        mom_new = mom_old + rho * acc[d] * dt
        de = de + 0.5 * (mom_new ** 2 - mom_old ** 2) / rho
        rows.append(mom_new)
    rows.append(u[1 + ndim] + de)
    return torch.cat([torch.stack(rows), u[2 + ndim:]])
