"""The cooling solve's CUDA source (K6, ``ramses_tpu_torch/csrc/cooling.cu``)
built for the host CPU, against its plain versions.

The source is compiled with ``g++`` through the threaded stand-in of the
CUDA runtime of ``test_torch_muscl_host.py`` (each block's threads are
``std::thread``s, blocks in order) and called through the wrappers' own
``call`` (the march entry) and ``call_step`` (the fused entry).  Built with
``-ffp-contract=off`` (the card's build has ``-fmad=false``).

* the interleaved tables put every value where ``packed``'s ``[10, NBIN_N,
  NBIN_T]`` has it;
* the march against ``solve_cooling_ref`` on random cells over the tables'
  whole range: f64 per cell within rel 1e-10, f32 within rel 2e-5 of the
  plain f32 result, or in either ten times the plain result's own move
  when nH, T2 or dt change by a few ulps, with at most 0.1 % of the f32
  cells in that second form (K6's gates on the card).  The host's libm
  ``pow`` and ``log10`` differ from torch's in the last bit, and the
  march's decisions (done or not, which table bin) turn such a bit into a
  larger move at cells next to them;
* the fused entry against ``cooling_step`` on the CPU, on a dense state and
  on a hierarchy level's transposed rows, with the unit scales as a tensor
  and as the spec's numbers, with ``dt`` a number and a 0-d tensor, with
  extra energies, self-shielding, a T2max clip, a polytrope floor and a
  given per-cell floor: the E row's change held
  to the same gates relative to the new thermal energy (plus one ulp of E,
  the final add's rounding), every other row untouched.  The kernel
  multiplies by the reciprocal where the plain version divides by a Python
  number, as PyTorch's CUDA kernels do, so on the CPU the two part in the
  last bit before the march;
* ``fused_supports`` and the route ``cooling_step`` takes for what it
  leaves out (the ISM module alone); the fused entry refuses other layouts
  and dtypes.

Skips without ``g++``.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu_torch import kernels  # noqa: E402
from ramses_tpu_torch.hydro import cooling as pc  # noqa: E402
from ramses_tpu_torch.hydro.core import HydroStatic  # noqa: E402
from ramses_tpu_torch.units import Units  # noqa: E402

F64_REL, F32_REL, F32_SHARE = 1e-10, 2e-5, 1e-3
ISM = Units(scale_l=3.08e18, scale_t=3.15e13, scale_d=1.66e-24)


# The f32 functions the kernel calls, evaluated in f64 and rounded: the
# host libm's log10f is off by up to 2 ulp and torch's CPU f32 functions
# (SLEEF) by up to 1 ulp, each elsewhere, so the march would part at the
# cells next to its decisions for want of the same libm.  Both sides here
# round the f64 value (the ``rounded`` fixture for torch); on the card the
# kernel and torch call the same libdevice functions.
F32_LIBM = """
static inline float host_powf(float a, float b) {
  return (float)pow((double)a, (double)b);
}
static inline float host_log10f(float x) { return (float)log10((double)x); }
static inline float host_expf(float x) { return (float)exp((double)x); }
#define powf host_powf
#define log10f host_log10f
#define expf host_expf
"""


def _build(out):
    from tests.test_torch_muscl_host import LAUNCH, RUNTIME, _as_launch
    (out / "cuda_host.h").write_text(RUNTIME)
    src = (kernels.CSRC / "cooling.cu").read_text().replace(
        "#include <cuda_runtime.h>", '#include "cuda_host.h"\n' + F32_LIBM)
    src, n = LAUNCH.subn(_as_launch, src)
    assert n == 2 and "<<<" not in src
    (out / "cooling.cpp").write_text(src)
    lib = out / "libcooling_host.so"
    subprocess.run([shutil.which("g++"), "-std=c++20", "-O1", "-pthread",
                    "-ffp-contract=off", "-shared", "-fPIC", "-w", "-o",
                    str(lib), str(out / "cooling.cpp")], check=True,
                   capture_output=True)
    return pc.bind(ctypes.CDLL(str(lib)))


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return _build(tmp_path_factory.mktemp("cooling_host"))


@pytest.fixture
def rounded(monkeypatch):
    """torch on the CPU made to round as the kernel does: its f32 pow,
    log10 and exp evaluated in f64 and rounded, as the host build's are
    (``F32_LIBM``; torch's own part from the host libm's in the last bit at
    ~1.4 % of the march's 10^x), and a division by a Python number a
    multiplication by its reciprocal in the tensor's type, as PyTorch's
    CUDA kernels compute it (the CPU's divide).  The plain version's
    arithmetic stays as written."""
    div = torch.Tensor.__truediv__

    def truediv(a, b):
        if isinstance(b, (int, float)) and a.is_floating_point():
            one = torch.ones((), dtype=a.dtype)
            return a * div(one, torch.tensor(float(b), dtype=a.dtype))
        return div(a, b)
    monkeypatch.setattr(torch.Tensor, "__truediv__", truediv)
    for name in ("pow", "log10", "exp"):
        real = getattr(torch, name)

        def f(*a, _real=real):
            if any(torch.is_tensor(x) and x.dtype == torch.float32
                   for x in a):
                return _real(*[x.double() if torch.is_tensor(x) else x
                               for x in a]).float()
            return _real(*a)
        monkeypatch.setattr(torch, name, f)


@pytest.fixture(scope="module")
def tables():
    """The tables at z = 0 without UV, and at z = 3 with it."""
    return {"z0": pc.build_tables(), "uv": pc.build_tables(aexp=0.25,
                                                           J21=1.0)}


def test_interleaved_tables_hold_every_value_where_packed_has_it(tables):
    for dtype in (torch.float32, torch.float64):
        tabs = tables["uv"].packed(dtype)[0]            # [10, N, T]
        inter = tables["uv"].interleaved(dtype)         # [N, T-1, 20]
        assert inter.shape == (pc.NBIN_N, pc.NBIN_T - 1, 20)
        assert inter.is_contiguous() and inter.dtype == dtype
        q = inter.reshape(pc.NBIN_N, pc.NBIN_T - 1, 5, 4)
        for t in range(5):
            assert torch.equal(q[:, :, t, 0], tabs[t, :, :-1])
            assert torch.equal(q[:, :, t, 1], tabs[t, :, 1:])
            assert torch.equal(q[:, :, t, 2], tabs[5 + t, :, :-1])
            assert torch.equal(q[:, :, t, 3], tabs[5 + t, :, 1:])
        # one (i_nH, i_T2) run is 20 consecutive values, 16-byte aligned
        assert inter.stride() == ((pc.NBIN_T - 1) * 20, 20, 1)
        assert (20 * inter.element_size()) % 16 == 0
        assert tables["uv"].interleaved(dtype) is inter     # kept


def _cells(n, seed):
    rng = np.random.default_rng(seed)
    nH, T2 = 10 ** rng.uniform(-6, 4, n), 10 ** rng.uniform(1, 8.5, n)
    return [nH, T2, rng.uniform(0, 1, n),
            np.maximum(np.exp(-nH / 0.01), 1e-20)]


def _move(solve, args, want, cells, ks, ulp):
    """The largest relative move of ``want`` at ``cells`` when nH, T2 or
    dt (arguments 0, 1, 4) alone is scaled by 1 + k·ulp for each k of
    ``ks``."""
    moves = []
    for i in (0, 1, 4):
        for k in ks:
            a = list(args)
            a[i] = a[i] * (1 + k * ulp)
            moves.append((solve(*a) - want).abs().reshape(-1)[cells])
    return torch.stack(moves).amax(0) / want.reshape(-1)[cells].abs()


def _held(got, want, scale, move_of, dtype, slack=None):
    """Each cell's |got - want| / scale within the dtype's gate, or within
    ten times its conditioning move (``move_of(cells)``) plus ``slack``;
    in f32 at most 0.1 % of the cells in the second form."""
    rel = ((got - want).abs() / scale).reshape(-1)
    tol = F64_REL if dtype == torch.float64 else F32_REL
    bad = torch.nonzero(rel > tol).reshape(-1)
    if bad.numel():
        extra = 0.0 if slack is None else slack.reshape(-1)[bad]
        lim = torch.clamp(10 * move_of(bad), min=tol) + extra
        assert bool((rel[bad] <= lim).all()), (
            float(rel.max()), int(bad.numel()),
            float((rel[bad] / lim).max()))
    if dtype == torch.float32:
        assert bad.numel() <= F32_SHARE * rel.numel(), int(bad.numel())
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("key", ["z0", "uv"])
def test_march_host_build_matches_plain_version(host, tables, rounded,
                                                dtype, key):
    tabs = tables[key]
    t = [torch.tensor(a, dtype=dtype) for a in _cells(3000, 3)]
    dt = torch.tensor(3e15, dtype=dtype)
    got, it_k = pc.call(host, tabs, *t, dt, want_iters=True)
    want, it_p = pc.solve_cooling_ref(tabs, *t, dt, want_iters=True)
    f64 = dtype == torch.float64
    ks, ulp = (((1, -2, 4, -8, 16, -64), 1.1e-16) if f64
               else ((1, -1, 2, -2, 4, -4), 2.0 ** -23))

    def move(cells):
        return _move(lambda *a: pc.solve_cooling_ref(tabs, *a),
                     t + [dt], want, cells, ks, ulp)
    _held(got, want, want.abs(), move, dtype)
    assert it_k.dtype == torch.int32 and int(it_k.min()) >= 1
    assert int((it_k != it_p).sum()) <= 0.01 * it_k.numel()
    # numbers at stride 0 and a per-cell boost give the same bits
    a, _ = pc.call(host, tabs, t[0][:64], t[1][:64], 0.3, 1.0, dt)
    b, _ = pc.call(host, tabs, t[0][:64], t[1][:64],
                   torch.full((64,), 0.3, dtype=dtype),
                   torch.ones(64, dtype=dtype), dt)
    assert torch.equal(a, b)


def _state(shape, ndim, nener, seed, dtype):
    """A random conservative state ``[ndim + 2 + nener, *shape]``: rho over
    four decades, T2 from ~10 K to ~1e8 K in the ISM units, kinetic energy
    up to the thermal one, extra energies a fraction of it."""
    rng = np.random.default_rng(seed)
    rho = 10 ** rng.uniform(-2, 2, shape)
    T2 = 10 ** rng.uniform(1, 8, shape) / ISM.scale_T2
    eint = rho * T2 / (5.0 / 3.0 - 1.0)
    v = rng.standard_normal((ndim,) + shape)
    v *= np.sqrt(2.0 * eint * rng.random(shape) / rho
                 / np.maximum((v ** 2).sum(0), 1e-30))
    ekin = 0.5 * rho * (v ** 2).sum(0)
    e = [0.2 * eint * rng.random(shape) for _ in range(nener)]
    u = np.stack([rho] + [rho * v[d] for d in range(ndim)]
                 + [eint + ekin + sum(e)] + e)
    return torch.tensor(u, dtype=dtype)


def _spec(**kw):
    kw.pop("t2_floor", None)
    return pc.CoolingSpec(enabled=True, scale_T2=ISM.scale_T2,
                          scale_nH=ISM.scale_nH, scale_t=ISM.scale_t, **kw)


def _given_floor(opts, u):
    """A case's given floor (K, one a cell of ``u``, from the seed under
    ``opts["t2_floor"]``), or None."""
    if "t2_floor" not in opts:
        return None
    rng = np.random.default_rng(opts["t2_floor"])
    return torch.tensor(10 ** rng.uniform(1, 4, tuple(u.shape[1:])),
                        dtype=u.dtype, device=u.device)


# (ndim, nener, spec options, scales as a tensor, dt a 0-d tensor,
# a hierarchy level's transposed rows); the floors reach past T2 at a
# part of the cells, whose T2 then starts from T2_MIN
STEP = [(3, 0, {}, False, True, False),
        (3, 0, {}, True, True, True),
        (2, 2, dict(self_shielding=True, z_ave=0.5), False, False, False),
        (1, 1, dict(T2max=3e6), True, False, True),
        (3, 1, dict(z_ave=1.0), False, False, True),
        (3, 0, dict(floor_form="polytrope", T2_eos=1e3,
                    polytrope_index=1.4), True, True, True),
        (2, 1, dict(t2_floor=17, T2max=3e6), False, False, False)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim,nener,opts,tensor_scales,tensor_dt,rows",
                         STEP)
def test_fused_step_host_build_matches_cooling_step(host, tables, rounded,
                                                    dtype,
                                                    ndim, nener, opts,
                                                    tensor_scales, tensor_dt,
                                                    rows):
    tabs = tables["uv"]
    cfg = HydroStatic(ndim=ndim, gamma=5.0 / 3.0, nener=nener)
    spec = _spec(**opts)
    shape = {1: (997,), 2: (31, 29), 3: (9, 11, 13)}[ndim]
    u = _state(shape, ndim, nener, 7 * ndim + nener, dtype)
    if rows:
        # a level's rows [ncell, nvar], handed over as u[l].T
        u = u.reshape(u.shape[0], -1).t().contiguous().t()
    scales = (torch.tensor([0.9 * ISM.scale_T2, 1.1 * ISM.scale_nH,
                            ISM.scale_t], dtype=dtype)
              if tensor_scales else None)
    dt = torch.tensor(30.0, dtype=dtype) if tensor_dt else 30.0
    fl = _given_floor(opts, u)
    assert pc.fused_supports(spec)
    want = pc.cooling_step(u, tabs, spec, dt, cfg, fl, scales)
    assert torch.equal(want, pc.cooling_step_ref(u, tabs, spec, dt, cfg, fl,
                                                 scales))
    got = u.clone()
    pc.call_step(host, u, got, tabs, spec, dt, cfg, scales, t2_floor=fl)
    e = ndim + 1
    keep = [k for k in range(u.shape[0]) if k != e]
    assert torch.equal(got[keep], u[keep])
    # in place: the state's own E row rewritten, the same bits
    own = u.clone()
    pc.call_step(host, own, own, tabs, spec, dt, cfg, scales, t2_floor=fl)
    assert torch.equal(own, got)
    # the gate on the new thermal energy, through the march's inputs
    p = pc.cooling_inputs(u, spec, dt, cfg, fl, scales)
    march = [p["nH"], p["T2"], p["zsolar"], p["boost"], p["dt_s"]]
    T2n = pc.solve_cooling_ref(tabs, *march)
    eint = pc.cooling_energy(T2n, p, spec, cfg, scales)
    f64 = dtype == torch.float64
    ks, ulp = (((1, -2, 4, -8, 16, -64), 1.1e-16) if f64
               else ((1, -1, 2, -2, 4, -4), 2.0 ** -23))
    args = [a.reshape(-1) if torch.is_tensor(a) and a.dim() else a
            for a in march]

    def move(cells):
        def solve(*a):
            return pc.solve_cooling_ref(tabs, *a)
        return _move(solve, args, T2n.reshape(-1), cells, ks, ulp)
    ulp_e = torch.finfo(dtype).eps * want[e].abs() / eint.abs()
    _held(got[e], want[e], eint.abs(), move, dtype, slack=2 * ulp_e)


def test_fused_supports_and_the_route_of_what_it_leaves_out(tables,
                                                             monkeypatch):
    """``fused_supports`` by configuration, and ``cooling_step``'s route:
    the fused entry for everything but the ISM module on a device that is
    not the CPU (a meta tensor stands in for the card), floors included;
    the plain version for the ISM module, and always on a CPU tensor.  The
    fused entry raises on a layout, a dtype or an operand it does not
    take, before it reaches the kernel."""
    cfg = HydroStatic(ndim=3, gamma=5.0 / 3.0)
    spec = _spec()
    assert pc.fused_supports(spec)
    assert pc.fused_supports(_spec(floor_form="polytrope"))
    assert not pc.fused_supports(_spec(ism=True))

    taken = []
    monkeypatch.setattr(pc, "_fused_step",
                        lambda u, *a: taken.append("fused") or u)
    monkeypatch.setattr(pc, "cooling_step_ref",
                        lambda u, *a: taken.append("plain") or u)
    meta = torch.empty((5, 4, 4, 4), dtype=torch.float32, device="meta")
    u = torch.zeros((5, 4, 4, 4), dtype=torch.float32)
    tabs = tables["z0"]
    pc.cooling_step(meta, tabs, spec, 1.0, cfg)
    pc.cooling_step(meta, tabs, _spec(ism=True), 1.0, cfg)
    pc.cooling_step(meta, tabs, _spec(floor_form="isothermal"), 1.0, cfg)
    pc.cooling_step(meta, tabs, spec, 1.0, cfg,
                    t2_floor=torch.zeros(4, 4, 4, device="meta"))
    pc.cooling_step(u, tabs, spec, 1.0, cfg)
    assert taken == ["fused", "plain", "fused", "fused", "plain"]

    bad = {"strided": (u[:, :, :, ::2], {}),
           "f16": (u.to(torch.float16), {}),
           "dt f64": (u, dict(dt=torch.tensor(1.0, dtype=torch.float64))),
           "dt of 2": (u, dict(dt=torch.ones(2))),
           "scales f64": (u, dict(scales=torch.ones(3,
                                                    dtype=torch.float64))),
           "scales of 2": (u, dict(scales=torch.ones(2))),
           "scales a list": (u, dict(scales=[1.0, 1.0, 1.0])),
           "floor of 3": (u, dict(t2_floor=torch.ones(3)))}
    for name, (v, kw) in bad.items():
        kw = dict(dict(dt=1.0), **kw)
        dt = kw.pop("dt")
        with pytest.raises(ValueError):
            pc.call_step(None, v, v, tabs, spec, dt, cfg, **kw)
            raise AssertionError(name)
