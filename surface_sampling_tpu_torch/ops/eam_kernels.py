"""The fused EAM pair pass: a CUDA kernel for Hopper, its plain PyTorch
version, and the energy-only potential built on it.

``eam_rho_ep`` replaces the Pallas TPU kernel of
``surface_sampling_tpu/ops/pallas_eam.py`` (``make_pallas_eam_energy`` ->
``batched_rho_ep``, inner ``kernel``). For chains C, slots N and a static
candidate table of M neighbours a slot (``core/static_neighbors.py``), per
pair (i, m) with j = slot_j[i, m]:

    r    = sqrt(max(|pos_i - (pos_j + shift[i, m])|^2, 1e-12))
    mask = valid[i, m] * alive_i * alive_j * (r < cutoff)
    rs   = r where mask else cutoff
    u    = (clip(rs, r_lo, r_hi) - mid) / half
    wall = 100 (q^2 + q^4),  q = 8 max(r_lo - rs, 0)
    rho_i = sum_m (cheb_rho(u) + wall) mask
    ep_i  = 1/2 sum_m (cheb_z2r(u) + wall) / rs mask

with cheb_* degree-24 Chebyshev series of one element's rho(r) and z2r(r)
fitted on the host to the exact LAMMPS splines over [r_lo, r_hi] (30,000
samples), evaluated by Clenshaw in float32. The embedding F(rho_i) and the
per-chain sum stay outside the kernel, in plain PyTorch, as in the JAX
package. The same plain math, :func:`cheb_rho_ep`, is the ``"cheb"`` mode of
``potentials.eam.make_eam_static``.

The TPU kernel forms the pair endpoints and the per-atom sum as dense 0/1
(N, N*M) matrix products on the MXU. The CUDA kernel
(``csrc/eam_rho_ep.cu``) evaluates the two series on live pairs only: a
warp stages one chain in shared memory, walks its alive centres, compacts
each one's live pairs (cheap passes of the j >= 0, alive and cutoff
tests) into a ring in shared memory, and evaluates them 32 at a time, the
pairs of several centres sharing a round; each centre's terms are summed
in ascending slot order and a fixed tree, so results repeat bitwise. A
dead pair's shift and a dead slot's position are never read. The
candidate table is read through L1. A wrapper takes the plain version for
CPU tensors and launches the kernel for CUDA tensors; there is no fallback
between the two. Energy only, as in the JAX package: there is no
backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from surface_sampling_tpu_torch.device import resolve_device
from surface_sampling_tpu_torch.ops.cuda_build import check_inputs, launch
from surface_sampling_tpu_torch.ops.splines import (
    lammps_spline_coeffs,
    spline_eval_np,
    spline_eval_rows,
)
from surface_sampling_tpu_torch.potentials.base import Potential

# the Chebyshev fits of the JAX package (pallas_eam.py, eam.py "cheb"):
# degree 24 on [R_LO, nr * dr] from N_FIT samples of the exact splines; the
# kernel is built for this degree
DEGREE = 24
R_LO = 0.8
N_FIT = 30000
# chains per block of the kernel (its warps take them in turn, a chain a warp)
CHAINS_PER_BLOCK = 16


def cheb_fit(table_1d: np.ndarray, dr: float, r_lo: float, r_hi: float,
             degree: int = DEGREE) -> np.ndarray:
    """(degree + 1,) Chebyshev coefficients (float64) of the LAMMPS spline
    of ``table_1d`` (grid spacing ``dr``), least squares on [r_lo, r_hi]."""
    xs = np.linspace(r_lo, r_hi, N_FIT)
    ys = spline_eval_np(lammps_spline_coeffs(table_1d), xs, dr)
    return np.polynomial.chebyshev.Chebyshev.fit(xs, ys, degree).coef


class ChebRange(NamedTuple):
    """The pair range of the Chebyshev path: cutoff and fit interval."""

    cutoff: float
    r_lo: float
    r_hi: float

    @property
    def mid(self) -> float:
        return 0.5 * (self.r_lo + self.r_hi)

    @property
    def half(self) -> float:
        return 0.5 * (self.r_hi - self.r_lo)


def clenshaw(coef: torch.Tensor, u: torch.Tensor, sel: torch.Tensor | None = None):
    """Chebyshev series at u in [-1, 1] by Clenshaw's recurrence (stable in
    float32, where a degree-24 power basis cancels catastrophically).
    ``coef`` is (T', D + 1); ``sel`` picks each query's row (None: T' == 1)."""
    D1 = coef.shape[1]
    c = coef[0] if sel is None else coef[sel].movedim(-1, 0)
    b1 = torch.zeros_like(u)
    b2 = torch.zeros_like(u)
    two_u = 2.0 * u
    for k in range(D1 - 1, 0, -1):
        b1, b2 = c[k] + two_u * b1 - b2, b1
    return c[0] + u * b1 - b2


def wall(rs: torch.Tensor, r_lo: float) -> torch.Tensor:
    """Quartic repulsion below the fit floor: 100 (q^2 + q^4), q = 8 (r_lo -
    r)+. Over-rejecting: at full overlap (r = 0) it reaches ~2.7e5 eV."""
    q = 8.0 * torch.clamp(r_lo - rs, min=0.0)
    q2 = q * q
    return 100.0 * (q2 + q2 * q2)


def cheb_rho_ep(positions, alive, slot_j, shift, valid, rho_coef, z2r_coef, rng: ChebRange,
                rho_sel=None, z2r_sel=None):
    """rho_i and the half pair sum ep_i (both (C, N)) of the Chebyshev
    path over a static candidate table, differentiable in ``positions``.

    Args:
        positions: (C, N, 3); alive: (C, N) bool.
        slot_j: (N, M) int64 neighbour slots; shift: (N, M, 3); valid:
            (N, M) bool.
        rho_coef, z2r_coef: (T', D + 1) Chebyshev rows; ``rho_sel`` /
            ``z2r_sel`` (C, N, M) pick a row per pair (None when T' == 1).
    """
    pj = positions[:, slot_j]                                   # (C, N, M, 3)
    disp = positions[:, :, None, :] - (pj + shift)
    r = torch.sqrt(torch.clamp((disp * disp).sum(dim=-1), min=1e-12))
    mask = valid & alive[:, :, None] & alive[:, slot_j] & (r < rng.cutoff)
    fmask = mask.to(r.dtype)
    rs = torch.where(mask, r, torch.full_like(r, rng.cutoff))
    u = (torch.clamp(rs, rng.r_lo, rng.r_hi) - rng.mid) / rng.half
    w = wall(rs, rng.r_lo)
    rho = ((clenshaw(rho_coef, u, rho_sel) + w) * fmask).sum(dim=2)
    phi = (clenshaw(z2r_coef, u, z2r_sel) + w) / rs * fmask
    return rho, 0.5 * phi.sum(dim=2)


# ----------------------------------------------------------------------
# Row 13: the kernel's operands, its plain version and its wrapper
# ----------------------------------------------------------------------
class EAMPairTable(NamedTuple):
    """A static candidate table staged for the pair pass."""

    slot_j: torch.Tensor      # (N, M) int64, for the plain gather
    shift: torch.Tensor       # (N, M, 3) f32
    valid: torch.Tensor       # (N, M) bool
    kernel_j: torch.Tensor    # (N, M) int32: slot_j where valid, else -1


def stage_pair_table(nbr_table, device) -> EAMPairTable:
    slot_j = np.asarray(nbr_table.slot_j, np.int64)
    valid = np.asarray(nbr_table.valid, bool)
    return EAMPairTable(
        slot_j=torch.as_tensor(slot_j, device=device),
        shift=torch.as_tensor(np.asarray(nbr_table.shift, np.float32), device=device),
        valid=torch.as_tensor(valid, device=device),
        kernel_j=torch.as_tensor(np.where(valid, slot_j, -1).astype(np.int32), device=device),
    )


class ChebEAM(NamedTuple):
    """One element's Chebyshev fits, staged: ``coef`` (2, D + 1) f32 (rho
    row 0, z2r row 1) and ``operand`` = coef, then cutoff, r_lo, r_hi, mid,
    half (the kernel's one constant array)."""

    coef: torch.Tensor
    operand: torch.Tensor
    rng: ChebRange


def stage_cheb(tables, device, r_lo: float = R_LO, degree: int = DEGREE) -> ChebEAM:
    """The Chebyshev fits of a single-element table set."""
    if len(tables.numbers) != 1:
        raise ValueError("the EAM kernel supports single-element tables")
    rng = ChebRange(float(tables.cutoff), float(r_lo), float(tables.nr * tables.dr))
    coef = np.stack([cheb_fit(tables.rhor[0], tables.dr, rng.r_lo, rng.r_hi, degree),
                     cheb_fit(tables.z2r[0, 0], tables.dr, rng.r_lo, rng.r_hi, degree)])
    coef_t = torch.as_tensor(coef, dtype=torch.float32, device=device)
    scal = torch.tensor([rng.cutoff, rng.r_lo, rng.r_hi, rng.mid, rng.half],
                        dtype=torch.float32, device=device)
    return ChebEAM(coef_t, torch.cat([coef_t.reshape(-1), scal]), rng)


def eam_rho_ep_plain(positions, alive_f, pairs: EAMPairTable, cheb: ChebEAM):
    """Plain PyTorch version of :func:`eam_rho_ep` (a gather and a Clenshaw
    loop; the JAX kernel's pair aliveness alive_i + alive_j > 1.5 is both
    alive for 0/1 floats)."""
    return cheb_rho_ep(positions, alive_f > 0.5, pairs.slot_j, pairs.shift, pairs.valid,
                       cheb.coef[0:1], cheb.coef[1:2], cheb.rng)


def eam_rho_ep(positions, alive_f, pairs: EAMPairTable, cheb: ChebEAM):
    """The fused EAM pair pass (module docstring), batched over chains.

    Args:
        positions: (C, N, 3) f32 slot positions.
        alive_f: (C, N) f32, 1.0 for alive slots, 0.0 for dead ones.
        pairs: the staged static candidate table (N, M).
        cheb: the element's staged Chebyshev fits.
    Returns:
        rho (C, N) and ep (C, N), f32.
    """
    name = "eam_rho_ep"
    C, N, _ = positions.shape
    M = pairs.slot_j.shape[1]
    dev = positions.device
    f32 = torch.float32
    check_inputs(name, dev, positions=(positions, f32, (C, N, 3)),
                 alive_f=(alive_f, f32, (C, N)), shift=(pairs.shift, f32, (N, M, 3)),
                 kernel_j=(pairs.kernel_j, torch.int32, (N, M)),
                 operand=(cheb.operand, f32, (2 * (DEGREE + 1) + 5,)))
    if torch.is_grad_enabled() and positions.requires_grad:
        raise NotImplementedError(f"{name} is energy only (no backward), as the JAX package's "
                                  "kernel: take forces from the Chebyshev path")
    if dev.type == "cpu":
        return eam_rho_ep_plain(positions, alive_f, pairs, cheb)
    rho = torch.empty((C, N), dtype=f32, device=dev)
    ep = torch.empty((C, N), dtype=f32, device=dev)
    launch(name, (positions, alive_f, pairs.kernel_j, pairs.shift, cheb.operand, rho, ep),
           (C, N, M, CHAINS_PER_BLOCK))
    eam_rho_ep.launches += 1
    return rho, ep


eam_rho_ep.launches = 0

WRAPPERS = (eam_rho_ep,)


def reset_launch_counts() -> None:
    eam_rho_ep.launches = 0


def launch_counts() -> dict[str, int]:
    return {"eam_rho_ep": eam_rho_ep.launches}


# ----------------------------------------------------------------------
# The energy-only potential over the kernel
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class EAMKernelPotential(Potential):
    """``Potential`` whose energy runs :func:`eam_rho_ep`; ``pairs`` and
    ``cheb`` are its staged operands."""

    pairs: EAMPairTable | None = None
    cheb: ChebEAM | None = None


def make_eam_kernel_potential(tables, nbr_table, r_lo: float = R_LO, degree: int = DEGREE,
                              device: str | torch.device = "cuda") -> EAMKernelPotential:
    """The fused kernel as a Potential: the counterpart of
    ``make_eam_pallas_potential`` (pallas_eam.py). Energy only: ``energy``
    raises when the positions require grad, so a relaxation cannot take
    silent zero forces from it; ``per_atom_energy`` is the Chebyshev path
    (``potentials.eam.make_eam_static(mode="cheb")``'s math), for
    Boltzmann-weighted proposals. Single-element tables only.

    Args:
        tables: ``potentials.eam.EAMTables`` of one element.
        nbr_table: the spec's ``StaticNeighborTable``; positions passed in
            must be slot-realized geometries of that spec.
        device: defaults to "cuda" (raises without a card); "cpu" runs the
            plain version.
    """
    if degree != DEGREE:
        raise ValueError(f"the EAM kernel is built for degree {DEGREE}, got {degree}")
    dev = resolve_device(device)
    cheb = stage_cheb(tables, dev, r_lo, degree)
    pairs = stage_pair_table(nbr_table, dev)
    frho_c = torch.as_tensor(lammps_spline_coeffs(tables.frho[0]), dtype=torch.float32,
                             device=dev)
    inv_drho = 1.0 / tables.drho

    def energy(positions, type_idx, alive, shifts_unused=None):
        alive_f = alive.to(torch.float32)
        rho, ep = eam_rho_ep(positions.contiguous(), alive_f, pairs, cheb)
        F = spline_eval_rows(frho_c, rho, inv_drho) * alive_f
        return (F + ep).sum(dim=1)

    def per_atom(positions, type_idx, alive, shifts_unused=None):
        rho, ep = cheb_rho_ep(positions, alive, pairs.slot_j, pairs.shift, pairs.valid,
                              cheb.coef[0:1], cheb.coef[1:2], cheb.rng)
        F = spline_eval_rows(frho_c, rho, inv_drho)
        return torch.where(alive, F, torch.zeros_like(F)) + ep

    return EAMKernelPotential(energy=energy, per_atom_energy=per_atom,
                              cutoff=float(tables.cutoff), name="eam-kernel", pairs=pairs,
                              cheb=cheb)
