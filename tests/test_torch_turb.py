"""Turbulence forcing in the port (``ramses_tpu_torch.turb.forcing`` and the
uniform driver's wiring) against the JAX package's ``ramses_tpu.turb``, on
the CPU in f64.

The JAX package draws its normals from a JAX PRNG key, the port from a
``torch.Generator``; the comparisons replay the JAX draws through the
port's ``draws=`` (the spin-up, then one pair an update).

* ``TurbForcing``'s spin-up, ``update`` (driven and decaying) and
  ``acceleration`` on 2D and 3D grids: rtol 1e-12 / atol 1e-14 of the
  field's scale; ``apply_forcing``: rtol 1e-14;
* 2 chunks of the uniform driver on ``turb_driving.nml`` at 16³: the
  state at rtol 1e-10 / atol 1e-12;
* ``turb_fields.npz``: the port's dump restores the field and the
  generator (the restored run's next update is the straight run's, bit for
  bit); a JAX dump's file keeps its field and re-seeds, with a warning;
* the same seed gives the same bits twice, and the hierarchy refuses
  forcing by name;
* ``turb_driving.nml`` through ``python -m ramses_tpu_torch --device
  cpu`` at levelmin = levelmax = 4 (``tests/test_namelist_suite.py``'s
  shrink gives levelmax 5, a hierarchy the port refuses forcing on).
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.config import params_from_string as jparams  # noqa: E402
from ramses_tpu.driver import Simulation as JSimulation  # noqa: E402
from ramses_tpu.turb import forcing as JF  # noqa: E402

from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.config import params_from_string as pparams  # noqa: E402
from ramses_tpu_torch.convert import turb_from  # noqa: E402
from ramses_tpu_torch.driver import Simulation  # noqa: E402
from ramses_tpu_torch.turb import forcing as PF  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURB_NML = os.path.join(ROOT, "namelists", "turb_driving.nml")


def _text(level=4, nstepmax=4):
    txt = open(TURB_NML).read()
    txt = re.sub(r"levelmin=\d+", f"levelmin={level}", txt)
    txt = re.sub(r"levelmax=\d+", f"levelmax={level}", txt)
    # a later output time, so that nstepmax (not tout) ends the run
    txt = txt.replace("tout=0.25", "tout=4.0")
    return re.sub(r"nstepmax=\d+", f"nstepmax={nstepmax}", txt)


def _jax_draws(seed: int, kshape, n: int) -> list:
    """The JAX package's normal draws, in its order: the spin-up's, then
    one (re, im) pair for each of ``n - 1`` updates
    (``TurbForcing.__init__``/``update``'s key splits)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        kr, ki = jax.random.split(sub)
        out.append((np.asarray(jax.random.normal(kr, kshape)),
                    np.asarray(jax.random.normal(ki, kshape))))
    return out


def _rel_close(got, want, tol=1e-12):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=1e-14 * np.abs(want).max())


@pytest.mark.parametrize("shape,spectrum,ttype", [
    ((16, 16), "parabolic", 1), ((8, 12, 10), "parabolic", 1),
    ((12, 12, 12), "konstandin", 1), ((8, 8, 8), "power_law", 3)])
def test_forcing_field_matches_jax(shape, spectrum, ttype):
    spec = dict(enabled=True, turb_type=ttype, seed=5, comp_frac=0.3333,
                turb_T=0.5, turb_rms=1.3, spectrum=spectrum)
    jt = JF.TurbForcing(shape, JF.TurbSpec(**spec))
    kshape = (len(shape),) + tuple(jt.amp.shape)
    pt = PF.TurbForcing(shape, PF.TurbSpec(**spec), device="cpu",
                        draws=_jax_draws(5, kshape, 4))
    _rel_close(pt.fhat, jt.fhat)
    _rel_close(pt.acceleration(), jt.acceleration())
    for dt in (0.01, 0.2, 0.05):
        jt.update(dt)
        pt.update(dt)
        _rel_close(pt.fhat, jt.fhat)
    acc = pt.acceleration()
    _rel_close(acc, jt.acceleration())
    rms = float(torch.sqrt(torch.mean(torch.sum(acc ** 2, dim=0))))
    assert rms == pytest.approx(1.3, rel=1e-12)


def test_apply_forcing_matches_jax():
    rng = np.random.default_rng(4)
    u = rng.standard_normal((6, 8, 8, 8))
    u[0] = rng.uniform(0.0, 2.0, (8, 8, 8))          # some below min_rho
    u[4] = rng.uniform(5.0, 9.0, (8, 8, 8))
    acc = rng.standard_normal((3, 8, 8, 8))
    want = JF.apply_forcing(jnp.asarray(u), jnp.asarray(acc), 0.07, 0.1)
    got = PF.apply_forcing(torch.from_numpy(u), torch.from_numpy(acc), 0.07,
                           0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                               atol=0.0)
    assert torch.equal(got[5], torch.from_numpy(u[5]))


def _replayed(jsim, psim, nchunks):
    """The port sim's forcing replaced by one with the JAX sim's draws:
    its field at the start, then one update a chunk."""
    spec = psim.turb_spec
    kshape = tuple(jsim.turb.fhat.shape)
    psim.turb = PF.TurbForcing(psim.grid.shape, spec, device="cpu",
                               draws=_jax_draws(spec.seed, kshape,
                                                1 + nchunks))
    _rel_close(psim.turb.fhat, jsim.turb.fhat)


def test_uniform_driver_forcing_matches_jax():
    """turb_driving.nml at 16³, 4 steps in chunks of 2: one OU update and
    one kick a chunk, with the chunk's time."""
    jsim = JSimulation(jparams(_text(), ndim=3), dtype=jnp.float64)
    psim = Simulation(pparams(_text(), ndim=3), dtype=torch.float64,
                      device="cpu")
    assert psim.turb is not None
    _replayed(jsim, psim, 2)
    jsim.evolve(chunk=2)
    psim.evolve(chunk=2)
    assert psim.nstep == jsim.state.nstep == 4
    assert psim.t == pytest.approx(jsim.state.t, rel=1e-12)
    np.testing.assert_allclose(psim.state.u.numpy(),
                               np.asarray(jsim.state.u), rtol=1e-10,
                               atol=1e-12)
    _rel_close(psim.turb.fhat, jsim.turb.fhat)
    # forcing stirs the box from rest
    assert float(torch.abs(psim.state.u[1:4]).max()) > 0.0


def test_turb_fields_round_trip(tmp_path):
    p = pparams(_text(nstepmax=2), ndim=3)
    sim = Simulation(p, dtype=torch.float64, device="cpu")
    sim.evolve(chunk=1)
    out = sim.dump(1, str(tmp_path / "port"))
    assert os.path.exists(os.path.join(out, "turb_fields.npz"))
    back = Simulation.from_snapshot(p, out, dtype=torch.float64,
                                    device="cpu")
    assert torch.equal(back.turb.fhat, sim.turb.fhat)
    sim.turb.update(0.01)
    back.turb.update(0.01)
    assert torch.equal(back.turb.fhat, sim.turb.fhat)
    # a JAX dump's file (a PRNG key, no generator state): the field is
    # kept and the generator re-seeded, with a warning
    jsim = JSimulation(jparams(_text(nstepmax=2), ndim=3),
                       dtype=jnp.float64)
    jsim.evolve(chunk=1)
    jout = jsim.dump(1, str(tmp_path / "jax"))
    with pytest.warns(UserWarning, match="re-seeds from turb_seed"):
        jback = Simulation.from_snapshot(p, jout, dtype=torch.float64,
                                         device="cpu")
    _rel_close(jback.turb.fhat, jsim.turb.fhat, tol=0.0)
    fresh = PF.TurbForcing(jback.turb.shape, jback.turb_spec, device="cpu")
    jback.turb.update(0.01)
    fresh.fhat = torch.tensor(np.asarray(jsim.turb.fhat))
    fresh.update(0.01)
    assert torch.equal(jback.turb.fhat, fresh.fhat)
    # convert carries a JAX field across
    assert torch.equal(turb_from(jsim.turb, jback.turb_spec).fhat,
                       torch.tensor(np.asarray(jsim.turb.fhat)))


def test_same_seed_same_bits_and_hierarchy_refusal():
    p = pparams(_text(nstepmax=2), ndim=3)
    a = Simulation(p, dtype=torch.float64, device="cpu")
    b = Simulation(p, dtype=torch.float64, device="cpu")
    a.evolve(chunk=1)
    b.evolve(chunk=1)
    assert torch.equal(a.state.u, b.state.u)
    assert torch.equal(a.turb.fhat, b.turb.fhat)
    text = _text().replace("levelmax=4", "levelmax=5")
    with pytest.raises(NotImplementedError, match="turbulence forcing on "
                                                  "the hierarchy"):
        AmrSim(pparams(text, ndim=3), device="cpu")


def test_turb_driving_through_the_cli(tmp_path):
    nml = tmp_path / "turb_driving.nml"
    # the shipped output time, which the run reaches (and dumps at)
    nml.write_text(_text(nstepmax=200).replace("tout=4.0", "tout=0.25"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "ramses_tpu_torch", str(nml), "--device",
         "cpu"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("totals: ")
    assert os.path.exists(tmp_path / "output_00001" / "turb_fields.npz")
