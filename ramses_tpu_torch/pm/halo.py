"""Halo-analysis chain: clump membership, unbinding, merger trees.

The port's copy of ``ramses_tpu/pm/halo.py``, host numpy as there, with the
same files byte for byte.  Reference: ``pm/clump_merger.f90`` (clump
properties + output tables), ``pm/unbinding.f90:1-2296`` (iterative particle
unbinding against the clump's own potential), ``pm/merger_tree.f90:1-4312``
(progenitor / descendant links via shared particle IDs across snapshots).

All passes are host-side numpy over particle arrays — halos are few and
the per-clump work is O(members log members); the expensive part
(density deposition + watershed labelling) runs the watershed on the
device (:mod:`ramses_tpu_torch.pm.clumps`, K10).  The unbinding potential
uses the monopole (spherical mass-profile) approximation of the reference
(``unbinding.f90`` 'potential from the cumulative mass profile').
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


# ----------------------------------------------------------------------
# membership
# ----------------------------------------------------------------------

def particle_labels(x: np.ndarray, labels_grid: np.ndarray, dx: float,
                    boxlen: float) -> np.ndarray:
    """Clump label of each particle = label of its NGP cell on the
    dense labelled grid (-1 = unlabelled background)."""
    shape = labels_grid.shape
    nd = x.shape[1]
    idx = tuple(
        np.clip((np.mod(x[:, d], boxlen) / dx).astype(np.int64), 0,
                shape[d] - 1) for d in range(nd))
    return labels_grid[idx]


# ----------------------------------------------------------------------
# unbinding (pm/unbinding.f90)
# ----------------------------------------------------------------------

def _sphere_potential(r: np.ndarray, m: np.ndarray, G: float):
    """Monopole potential at each member's radius from the cumulative
    mass profile: phi(r_i) = -G [ M(<r_i)/r_i + sum_{r_j>r_i} m_j/r_j ]
    (the reference's spherical unbinding potential)."""
    order = np.argsort(r)
    rs = np.maximum(r[order], 1e-12)
    ms = m[order]
    mcum = np.cumsum(ms) - ms            # mass strictly inside r_i
    inv_term = np.cumsum((ms / rs)[::-1])[::-1] - ms / rs  # shells outside
    phi_sorted = -G * ((mcum + ms) / rs + inv_term)
    phi = np.empty_like(phi_sorted)
    phi[order] = phi_sorted
    return phi


def _binned_potential(r: np.ndarray, m: np.ndarray, G: float,
                      nbins: int, logbins: bool = True):
    """Monopole potential from a BINNED cumulative mass profile — the
    reference's ``nmassbins``/``logbins`` option set
    (``unbinding.f90`` compute_phi: the potential is tabulated on a
    radial mass-bin grid and particles interpolate), O(n) instead of
    the exact per-particle sort."""
    rmax = max(float(r.max()), 1e-12)
    rmin = max(float(r.min()), 1e-6 * rmax)
    if logbins:
        edges = np.geomspace(rmin, rmax, nbins + 1)
        edges[0] = 0.0
    else:
        edges = np.linspace(0.0, rmax, nbins + 1)
    ib = np.clip(np.searchsorted(edges, r, side="right") - 1, 0,
                 nbins - 1)
    mbin = np.bincount(ib, weights=m, minlength=nbins)
    rcen = 0.5 * (edges[1:] + np.maximum(edges[:-1], 1e-12 * rmax))
    mcum = np.cumsum(mbin)                       # mass inside bin edge
    # phi at bin centres: interior monopole + exterior shell sum
    shell = mbin / rcen
    outer = np.cumsum(shell[::-1])[::-1] - shell
    phi_bin = -G * (mcum / rcen + outer)
    return phi_bin[ib]


def unbind_clump(x: np.ndarray, v: np.ndarray, m: np.ndarray,
                 center: np.ndarray, boxlen: float, G: float = 1.0,
                 periodic: bool = True, max_iter: int = 10,
                 keep_frac_min: float = 0.0, saddle_pot: bool = False,
                 nmassbins: int = 0, logbins: bool = True):
    """Iterative unbinding of one clump's member particles.

    Returns a bool mask of BOUND members.  Each iteration recomputes
    the bulk velocity and the monopole potential from the currently
    bound set, then strips particles with
    ``0.5|v - vbulk|^2 + phi > phi_ref`` (``unbinding.f90`` iterative
    mode, ``:1400-1600``) until the bound set is stable.

    Reference option set: ``saddle_pot`` references the binding energy
    to the potential at the clump boundary instead of infinity (a
    particle energetic enough to reach the saddle surface counts as
    unbound — stricter); ``nmassbins``/``logbins`` switch the exact
    per-particle monopole to the reference's binned mass-profile
    potential.
    """
    n = len(m)
    bound = np.ones(n, dtype=bool)
    rel = x - center
    if periodic:
        rel = rel - boxlen * np.round(rel / boxlen)
    r = np.sqrt((rel ** 2).sum(axis=1))
    phi_ref = None
    for _ in range(max_iter):
        nb = bound.sum()
        if nb < 2:
            break
        mtot = m[bound].sum()
        vbulk = (v[bound] * m[bound, None]).sum(0) / mtot
        phi = np.zeros(n)
        if nmassbins >= 2:
            phi[bound] = _binned_potential(r[bound], m[bound], G,
                                           nmassbins, logbins)
        else:
            phi[bound] = _sphere_potential(r[bound], m[bound], G)
        if saddle_pot:
            # boundary reference FROZEN at the first iteration (the
            # reference's saddle surface does not shrink with the
            # bound set; a per-iteration max would strip the
            # outermost member forever and never converge)
            if phi_ref is None:
                phi_ref = float(phi[bound].max())
        else:
            phi_ref = 0.0
        ekin = 0.5 * ((v - vbulk) ** 2).sum(axis=1)
        new_bound = bound & (ekin + phi < phi_ref)
        if new_bound.sum() < max(2, int(keep_frac_min * n)):
            break                        # keep the last stable set
        if new_bound.sum() == nb:
            bound = new_bound
            break
        bound = new_bound
    return bound


# ----------------------------------------------------------------------
# clump catalogue with particle membership
# ----------------------------------------------------------------------

@dataclass
class Halo:
    """One halo/clump with particle membership (the clump_merger table
    row + the unbinding particle lists)."""
    index: int
    mass: float                  # bound mass
    npart: int
    pos: np.ndarray              # mass-weighted bound centre
    vel: np.ndarray              # bulk velocity
    ekin: float                  # internal kinetic energy (bulk removed)
    epot: float                  # monopole potential energy estimate
    ids: np.ndarray              # bound particle IDs, MOST BOUND FIRST
                                 # (the reference's nmost_bound tracer
                                 # ordering, merger_tree.f90)


def build_catalogue(x: np.ndarray, v: np.ndarray, m: np.ndarray,
                    ids: np.ndarray, plabels: np.ndarray, boxlen: float,
                    G: float = 1.0, periodic: bool = True,
                    unbind: bool = True,
                    npart_min: int = 10, saddle_pot: bool = False,
                    nmassbins: int = 0, logbins: bool = True) -> List[Halo]:
    """Halo catalogue from labelled particles (one entry per clump with
    >= ``npart_min`` bound members), heaviest first.  ``saddle_pot`` /
    ``nmassbins`` / ``logbins``: unbinding options (see
    :func:`unbind_clump`)."""
    halos: List[Halo] = []
    for lbl in np.unique(plabels[plabels >= 0]):
        sel = np.nonzero(plabels == lbl)[0]
        if len(sel) < npart_min:
            continue
        xs, vs, ms = x[sel], v[sel], m[sel]
        # provisional centre: mass-weighted with periodic unwrap about
        # the first member
        rel = xs - xs[0]
        if periodic:
            rel = rel - boxlen * np.round(rel / boxlen)
        center = xs[0] + (rel * ms[:, None]).sum(0) / ms.sum()
        if unbind:
            bound = unbind_clump(xs, vs, ms, center, boxlen, G, periodic,
                                 saddle_pot=saddle_pot,
                                 nmassbins=nmassbins, logbins=logbins)
        else:
            bound = np.ones(len(sel), dtype=bool)
        if bound.sum() < npart_min:
            continue
        xs, vs, ms = xs[bound], vs[bound], ms[bound]
        sid = ids[sel][bound]
        mtot = ms.sum()
        rel = xs - center
        if periodic:
            rel = rel - boxlen * np.round(rel / boxlen)
        pos = center + (rel * ms[:, None]).sum(0) / mtot
        if periodic:
            pos = np.mod(pos, boxlen)
        vel = (vs * ms[:, None]).sum(0) / mtot
        r = np.sqrt(((rel - (pos - center)) ** 2).sum(axis=1))
        phi = _sphere_potential(np.maximum(r, 1e-12), ms, G)
        ekin = float(0.5 * (ms * ((vs - vel) ** 2).sum(axis=1)).sum())
        epot = float(0.5 * (ms * phi).sum())
        # ids ordered most-bound-first: per-particle energy in the
        # halo frame (the reference picks its nmost_bound tree tracers
        # exactly this way, merger_tree.f90 most-bound lists)
        ebind = 0.5 * ((vs - vel) ** 2).sum(axis=1) + phi
        halos.append(Halo(index=int(lbl), mass=float(mtot),
                          npart=int(bound.sum()), pos=pos, vel=vel,
                          ekin=ekin, epot=epot,
                          ids=sid.astype(np.int64)[np.argsort(ebind)]))
    halos.sort(key=lambda h: -h.mass)
    return halos


def write_halo_table(halos: List[Halo], path: str):
    """``clump_masses.txt``-style ascii catalogue."""
    with open(path, "w") as f:
        f.write("# index npart mass x y z vx vy vz ekin epot 2T/|U|\n")
        for h in halos:
            p3 = list(h.pos) + [0.0] * (3 - len(h.pos))
            v3 = list(h.vel) + [0.0] * (3 - len(h.vel))
            vir = 2.0 * h.ekin / max(abs(h.epot), 1e-300)
            f.write(f"{h.index:8d} {h.npart:8d} {h.mass:14.6e} "
                    f"{p3[0]:12.6f} {p3[1]:12.6f} {p3[2]:12.6f} "
                    f"{v3[0]:12.5e} {v3[1]:12.5e} {v3[2]:12.5e} "
                    f"{h.ekin:12.5e} {h.epot:12.5e} {vir:8.3f}\n")


# ----------------------------------------------------------------------
# merger trees (pm/merger_tree.f90)
# ----------------------------------------------------------------------

@dataclass
class TreeLink:
    """One progenitor→descendant link."""
    desc: int                    # descendant halo index (later snapshot)
    prog: int                    # progenitor halo index (earlier)
    shared: int                  # shared tracer count
    main: bool                   # True: prog is desc's main progenitor
    frac: float = 0.0            # shared / progenitor tracer count
    snap_prog: int = -1          # progenitor snapshot (0-based); a gap
                                 # link has snap_prog < snap_desc - 1


def link_catalogues(progs: List[Halo], descs: List[Halo],
                    nmost_bound: int = 0, snap_prog: int = -1,
                    ) -> List[TreeLink]:
    """Progenitor/descendant links via shared particle IDs.

    The reference tracks the ``nmost_bound`` MOST BOUND particles per
    clump across snapshots and links by who holds them
    (``merger_tree.f90`` make_merger_tree); ``nmost_bound=0`` uses
    every bound particle.  Halo.ids are most-bound-first, so the
    tracer set is a prefix.  ``frac`` records the progenitor-fraction
    merit (shared / progenitor tracers); the main progenitor of a
    descendant is the one contributing the most shared tracers.
    """
    id2prog: Dict[int, int] = {}
    ntr: Dict[int, int] = {}
    for hp in progs:
        tr = hp.ids[:nmost_bound] if nmost_bound else hp.ids
        ntr[hp.index] = len(tr)
        for pid in tr:
            id2prog[int(pid)] = hp.index
    links: List[TreeLink] = []
    for hd in descs:
        counts: Dict[int, int] = {}
        for pid in hd.ids:
            pr = id2prog.get(int(pid))
            if pr is not None:
                counts[pr] = counts.get(pr, 0) + 1
        if not counts:
            continue
        main = max(counts, key=lambda k: counts[k])
        for pr, c in sorted(counts.items(), key=lambda kv: -kv[1]):
            links.append(TreeLink(desc=hd.index, prog=pr, shared=c,
                                  main=(pr == main),
                                  frac=c / max(ntr[pr], 1),
                                  snap_prog=snap_prog))
    return links


class MergerTree:
    """Accumulates catalogues over outputs and writes the tree table
    (``mergertree_txt`` output of ``merger_tree.f90``).

    ``max_gap``: a halo that drops out of the catalogue (below
    threshold, temporarily disrupted) stays a live progenitor
    candidate for up to ``max_gap`` later snapshots — the reference's
    past-merged-progenitor jumps (``merger_tree.f90`` 'jumpers'): a
    descendant with no progenitor in the previous catalogue is linked
    across the gap.  ``nmost_bound``: tracer count per halo (0 = all
    bound particles)."""

    def __init__(self, max_gap: int = 2, nmost_bound: int = 0):
        self.snapshots: List[Tuple[float, List[Halo]]] = []
        self.links: List[Tuple[int, List[TreeLink]]] = []
        self.max_gap = int(max_gap)
        self.nmost_bound = int(nmost_bound)
        # open progenitor pool: (snap_idx, Halo) not yet main-linked
        self._open: List[Tuple[int, Halo]] = []

    def add_snapshot(self, t: float, halos: List[Halo]):
        self.snapshots.append((t, halos))
        snap = len(self.snapshots) - 1
        if snap == 0:
            self._open = [(0, h) for h in halos]
            return
        prev = self.snapshots[-2][1]
        links = link_catalogues(prev, halos, self.nmost_bound,
                                snap_prog=snap - 1)
        # gap links: descendants with no progenitor in snap-1 search
        # the open pool of older snapshots, most recent first
        unmatched = [h for h in halos
                     if not any(l.desc == h.index for l in links)]
        pool = [(s, h) for s, h in self._open
                if s < snap - 1 and snap - s <= self.max_gap]
        pool.sort(key=lambda sh: -sh[0])
        for s in sorted({s for s, _ in pool}, reverse=True):
            if not unmatched:
                break
            cands = [h for ss, h in pool if ss == s]
            glinks = link_catalogues(cands, unmatched,
                                     self.nmost_bound, snap_prog=s)
            links.extend(glinks)
            matched = {l.desc for l in glinks}
            unmatched = [h for h in unmatched
                         if h.index not in matched]
        self.links.append((snap, links))
        # progenitors main-linked into this snapshot leave the pool;
        # everything else ages (and expires past max_gap); the new
        # catalogue joins the pool
        claimed = {(l.snap_prog, l.prog) for l in links if l.main}
        self._open = [(s, h) for s, h in self._open
                      if (s, h.index) not in claimed
                      and snap - s < self.max_gap]
        self._open.extend((snap, h) for h in halos)

    def progenitors(self, snap: int, halo_index: int) -> List[TreeLink]:
        """Links into ``halo_index`` of snapshot ``snap`` (1-based on
        the second snapshot onward)."""
        for s, links in self.links:
            if s == snap:
                return [l for l in links if l.desc == halo_index]
        return []

    def main_branch(self, snap: int, halo_index: int
                    ) -> List[Tuple[int, int]]:
        """Walk the main-progenitor branch back from (snap, halo):
        [(snap, index), (snap_prog, prog), ...] — the quantity merger
        trees exist to answer."""
        out = [(snap, halo_index)]
        s, h = snap, halo_index
        while True:
            ls = [l for l in self.progenitors(s, h) if l.main]
            if not ls:
                return out
            s, h = ls[0].snap_prog, ls[0].prog
            out.append((s, h))

    def write(self, path: str):
        with open(path, "w") as f:
            f.write("# snap desc_index prog_snap prog_index shared "
                    "frac main\n")
            for s, links in self.links:
                for l in links:
                    f.write(f"{s:6d} {l.desc:8d} {l.snap_prog:6d} "
                            f"{l.prog:8d} {l.shared:8d} {l.frac:8.4f} "
                            f"{int(l.main):2d}\n")
