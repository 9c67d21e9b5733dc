"""Virtual adsorption-site generation (host side, one-time preprocessing).

Ontop sites on surface atoms, bridge sites on Delaunay edge midpoints and
hollow sites at triangle centroids, all ``planar_distance`` above the mean
surface plane, with near-duplicate reduction; periodicity comes from
triangulating a 3x3 tiling and keeping home-cell simplices; with
``symm_reduce`` one representative of each symmetry orbit of sites is kept,
under the slab's in-plane space-group operations found numerically
(:func:`find_surface_symmetry_ops`). A copy of
``surface_sampling_tpu/structure/sites.py``.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay

from surface_sampling_tpu_torch.structure.atoms import Structure


def find_surface_symmetry_ops(slab: Structure, tol: float = 1e-3
                              ) -> list[tuple[np.ndarray, np.ndarray]]:
    """The slab's in-plane space-group operations, found numerically.

    Enumerates the integer 2x2 rotation / mirror parts W (entries -2..2,
    |det| = 1) that preserve the in-plane metric (W^T G W = G) and, for
    each, the fractional translations t that map the atoms onto themselves
    (species and z preserved). Returns the list of (W, t), t a fractional
    2-vector."""
    cell2d = slab.cell[:2, :2]
    G = cell2d @ cell2d.T
    frac = slab.scaled_positions[:, :2] % 1.0
    z = slab.positions[:, 2]
    species = slab.numbers

    ops: list[np.ndarray] = []
    rng = (-2, -1, 0, 1, 2)
    for a in rng:
        for b in rng:
            for c in rng:
                for d in rng:
                    W = np.array([[a, b], [c, d]], dtype=np.int64)
                    if abs(round(np.linalg.det(W))) != 1:
                        continue
                    if np.allclose(W.T @ G @ W, G, atol=tol * np.abs(G).max()):
                        ops.append(W)

    def maps_structure(W, t) -> bool:
        img = (frac @ W.T + t) % 1.0
        for i in range(len(frac)):
            d2 = img[i] - frac
            d2 -= np.round(d2)
            cart = d2 @ cell2d
            match = ((np.einsum("ij,ij->i", cart, cart) < tol**2)
                     & (np.abs(z - z[i]) < 1e-3) & (species == species[i]))
            if not match.any():
                return False
        return True

    found: list[tuple[np.ndarray, np.ndarray]] = []
    anchor = int(np.argmin(species))  # any deterministic anchor atom
    same = np.where((species == species[anchor]) & (np.abs(z - z[anchor]) < 1e-3))[0]
    for W in ops:
        for j in same:
            t = (frac[j] - frac[anchor] @ W.T) % 1.0
            if maps_structure(W, t) and not any(
                    np.array_equal(W, W2) and np.allclose(t, t2, atol=1e-4) for W2, t2 in found):
                found.append((W, t))
    return found


def symmetry_reduce_sites(slab: Structure, sites: np.ndarray, tol: float = 0.05) -> np.ndarray:
    """One representative (the first in order) of each symmetry orbit of
    adsorption sites under :func:`find_surface_symmetry_ops`."""
    if len(sites) == 0:
        return sites
    ops = find_surface_symmetry_ops(slab)
    cell2d = slab.cell[:2, :2]
    frac = np.linalg.solve(slab.cell.T, sites.T).T[:, :2] % 1.0
    kept: list[int] = []
    for i in range(len(sites)):
        dup = False
        for W, t in ops:
            img = (frac[i] @ W.T + t) % 1.0
            for j in kept:
                d = img - frac[j]
                d -= np.round(d)
                if np.linalg.norm(d @ cell2d) < tol and abs(sites[i, 2] - sites[j, 2]) < 1e-3:
                    dup = True
                    break
            if dup:
                break
        if not dup:
            kept.append(i)
    return sites[np.array(kept, dtype=int)]


def find_adsorption_sites(
    slab: Structure,
    site_types: tuple[str, ...] = ("ontop", "bridge", "hollow"),
    planar_distance: float = 2.0,
    surface_tol: float = 1.2,
    near_reduce: float = 0.01,
    no_obtuse_hollow: bool = True,
    put_inside: bool = True,
    symm_reduce: bool = False,
) -> dict[str, np.ndarray]:
    """Find adsorption sites above the top surface of a slab.

    Args:
        slab: the slab structure (surface normal along +z).
        site_types: which families to generate.
        planar_distance: height of the sites above the mean surface plane.
        surface_tol: atoms within this z-distance of the top atom count as
            surface atoms.
        near_reduce: fractional-coordinate duplicate threshold.
        no_obtuse_hollow: drop hollows of obtuse triangles.
        put_inside: wrap sites into the cell.
        symm_reduce: keep one site of each symmetry orbit in each family
            (:func:`symmetry_reduce_sites`).

    Returns:
        dict with per-family (n, 3) arrays plus "all" (their concatenation,
        near-reduced).
    """
    z = slab.positions[:, 2]
    surf_mask = (z.max() - z) < surface_tol
    surf_pos = slab.positions[surf_mask]
    if len(surf_pos) == 0:
        raise ValueError("no surface atoms found")
    cell2d = slab.cell[:2, :2]

    # tile 3x3 for periodic triangulation
    shifts = np.array([[i, j] for i in (-1, 0, 1) for j in (-1, 0, 1)], dtype=np.float64)
    cart_shifts = shifts @ cell2d
    tiled = (surf_pos[None, :, :2] + cart_shifts[:, None, :]).reshape(-1, 2)
    tiled_z = np.tile(surf_pos[:, 2], 9)

    sites: dict[str, list[np.ndarray]] = {t: [] for t in ("ontop", "bridge", "hollow")}
    for p, zz in zip(surf_pos[:, :2], surf_pos[:, 2]):
        sites["ontop"].append(np.array([p[0], p[1], zz]))

    if len(tiled) >= 3 and ("bridge" in site_types or "hollow" in site_types):
        simplices = Delaunay(tiled).simplices
        inv_cell = np.linalg.inv(cell2d)
        for simplex in simplices:
            pts = tiled[simplex]
            zs = tiled_z[simplex]
            centroid = pts.mean(axis=0)
            fc = centroid @ inv_cell
            # keep only home-cell simplices (dedup across images)
            if not np.all((fc >= -1e-9) & (fc < 1 - 1e-9)):
                continue
            for e0, e1 in ((0, 1), (1, 2), (0, 2)):
                mid = (pts[e0] + pts[e1]) / 2.0
                zmid = (zs[e0] + zs[e1]) / 2.0
                sites["bridge"].append(np.array([mid[0], mid[1], zmid]))
            if no_obtuse_hollow and _is_obtuse(pts):
                continue
            sites["hollow"].append(np.array([centroid[0], centroid[1], zs.mean()]))

    out: dict[str, np.ndarray] = {}
    plane_z = surf_pos[:, 2].mean()
    all_sites = []
    for fam in ("ontop", "bridge", "hollow"):
        if fam not in site_types:
            continue
        arr = np.array(sites[fam]).reshape(-1, 3)
        if len(arr):
            arr = arr.copy()
            arr[:, 2] = plane_z + planar_distance
            if put_inside:
                arr = _wrap_xy(arr, slab.cell)
            arr = _near_reduce(arr, slab.cell, near_reduce)
            if symm_reduce:
                arr = symmetry_reduce_sites(slab, arr)
        out[fam] = arr
        all_sites.append(arr)
    allarr = np.concatenate(all_sites) if all_sites else np.zeros((0, 3))
    out["all"] = _near_reduce(allarr, slab.cell, near_reduce) if len(allarr) else allarr
    return out


def _is_obtuse(pts2d: np.ndarray) -> bool:
    """True if the 2D triangle has an obtuse angle."""
    for i in range(3):
        a = pts2d[(i + 1) % 3] - pts2d[i]
        b = pts2d[(i + 2) % 3] - pts2d[i]
        if np.dot(a, b) < -1e-12:
            return True
    return False


def _wrap_xy(sites: np.ndarray, cell: np.ndarray) -> np.ndarray:
    frac = np.linalg.solve(cell.T, sites.T).T
    frac[:, :2] %= 1.0
    return frac @ cell


def _near_reduce(sites: np.ndarray, cell: np.ndarray, threshold: float) -> np.ndarray:
    """Remove near-duplicate sites (periodic fractional distance < threshold)."""
    if len(sites) == 0:
        return sites
    frac = np.linalg.solve(cell.T, sites.T).T
    keep: list[int] = []
    for i in range(len(frac)):
        dup = False
        for j in keep:
            d = frac[i] - frac[j]
            d[:2] -= np.round(d[:2])
            if np.linalg.norm(d) < threshold:
                dup = True
                break
        if not dup:
            keep.append(i)
    return sites[np.array(keep, dtype=int)]
