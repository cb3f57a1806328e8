"""Turbulence forcing (``turb/``): an Ornstein-Uhlenbeck process in
k-space with a solenoidal/compressive Helmholtz projection, applied as a
body acceleration (:mod:`ramses_tpu_torch.turb.forcing`)."""
