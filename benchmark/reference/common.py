"""Shared pieces of the plain reference: the precision switch, the
realisation of an occupancy into atoms, the periodic edge list and the npz
weights.

Plain PyTorch in float32 on whatever device its inputs are on. Every matrix
product goes through :func:`mm`, which in the control's precision rounds
both operands to TF32 (10 mantissa bits, round to nearest) and then
multiplies in float32: the same numbers on the CPU and the card. TF32 is
switched off in PyTorch itself (:func:`strict_fp32`), so a float32 product
is a float32 product.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def strict_fp32() -> None:
    """float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero on the bit pattern."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Precision(NamedTuple):
    """``tf32``: the control's products, each operand rounded to TF32."""

    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b


FP32 = Precision(False)
TF32 = Precision(True)


def load_npz_tree(path, device) -> dict:
    """An npz of dotted keys as a flat dict of float32 tensors (keys
    ``__cfg__*`` left out)."""
    with np.load(path) as z:
        return {k: torch.as_tensor(np.asarray(z[k], np.float32), device=device)
                for k in z.files if not k.startswith("__cfg__")}


class Lattice(NamedTuple):
    """The sampled system: the slab's atoms, the sites and what each code
    puts on a site, on one device."""

    pristine_numbers: torch.Tensor   # (P,) int64
    pristine_positions: torch.Tensor  # (P, 3)
    frozen: torch.Tensor              # (P,) bool
    site_coords: torch.Tensor         # (S, 3)
    code_numbers: torch.Tensor        # (K+1, G) int64, 0 = no atom
    code_offsets: torch.Tensor        # (K+1, G, 3)
    cell: torch.Tensor                # (3, 3) rows are the lattice vectors
    pbc: tuple                        # periodic axes

    @property
    def n_sites(self) -> int:
        return self.site_coords.shape[0]

    @property
    def n_codes(self) -> int:
        return self.code_numbers.shape[0]


def load_lattice(path, device) -> Lattice:
    """A lattice npz (keys as :class:`Lattice`'s fields, ``pbc`` a bool
    array) on ``device``."""
    with np.load(path) as z:
        f32 = {k: torch.as_tensor(np.asarray(z[k], np.float32), device=device)
               for k in ("pristine_positions", "site_coords", "code_offsets", "cell")}
        return Lattice(
            pristine_numbers=torch.as_tensor(np.asarray(z["pristine_numbers"], np.int64),
                                             device=device),
            frozen=torch.as_tensor(np.asarray(z["frozen"], bool), device=device),
            code_numbers=torch.as_tensor(np.asarray(z["code_numbers"], np.int64), device=device),
            pbc=tuple(bool(x) for x in z["pbc"]), **f32)


def realise(lat: Lattice, site_state: torch.Tensor):
    """(C, N) atomic numbers (0 = no atom) and (C, N, 3) ideal positions
    of (C, S) occupancies: the slab, then each site's group of atoms at the
    site plus its code's offsets."""
    C = site_state.shape[0]
    ads_z = lat.code_numbers[site_state].reshape(C, -1)
    ads_pos = (lat.site_coords[None, :, None, :] + lat.code_offsets[site_state]).reshape(C, -1, 3)
    numbers = torch.cat([lat.pristine_numbers.expand(C, -1), ads_z], dim=1)
    positions = torch.cat([lat.pristine_positions.expand(C, -1, -1), ads_pos], dim=1)
    return numbers, positions


def image_shifts(cell: torch.Tensor, pbc, reach: float) -> torch.Tensor:
    """(K, 3) lattice translations that can bring two atoms of one cell
    within ``reach`` of each other (every translation n . cell with |n_i| up
    to ceil(reach / height_i) + 1 on a periodic axis)."""
    c = cell.double().cpu().numpy()
    vol = abs(np.linalg.det(c))
    heights = [vol / np.linalg.norm(np.cross(c[(i + 1) % 3], c[(i + 2) % 3])) for i in range(3)]
    nmax = [int(math.ceil(reach / heights[i])) + 1 if pbc[i] else 0 for i in range(3)]
    ns = [(a, b, d) for a in range(-nmax[0], nmax[0] + 1) for b in range(-nmax[1], nmax[1] + 1)
          for d in range(-nmax[2], nmax[2] + 1)]
    return torch.as_tensor(np.array(ns, np.float64) @ c, dtype=torch.float32, device=cell.device)


class EdgeList(NamedTuple):
    """Directed edges i -> j (j's image) under the cutoff among the atoms
    of a batch, flattened over chains: rows are chain * N + atom."""

    centre: torch.Tensor     # (E,) int64 row of i
    neighbour: torch.Tensor  # (E,) int64 row of j
    disp: torch.Tensor       # (E, 3) r_j + shift - r_i
    r: torch.Tensor          # (E,)
    count: torch.Tensor      # (C, N) edges of each centre
    n_rows: int


def edge_list(positions: torch.Tensor, alive: torch.Tensor, shifts: torch.Tensor,
              cutoff: float) -> EdgeList:
    """Every pair of alive atoms (and periodic images) closer than
    ``cutoff``, an atom never paired with itself in the home cell."""
    C, N, _ = positions.shape
    disp = (positions[:, None, :, None, :] + shifts[None, None, None, :, :]
            - positions[:, :, None, None, :])                       # (C, i, j, K, 3)
    zero = (shifts.abs().sum(-1) == 0)
    self_pair = torch.eye(N, dtype=torch.bool, device=positions.device)[:, :, None] & zero
    with torch.no_grad():
        ok = (((disp * disp).sum(-1) < cutoff * cutoff) & alive[:, :, None, None]
              & alive[:, None, :, None] & ~self_pair[None])
    c, i, j, k = torch.nonzero(ok, as_tuple=True)
    d = disp[c, i, j, k]
    # r of the selected pairs only: a zero distance elsewhere has no gradient
    return EdgeList(centre=c * N + i, neighbour=c * N + j, disp=d, r=torch.sqrt((d * d).sum(-1)),
                    count=ok.sum(dim=(2, 3)), n_rows=C * N)


def segment_sum(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """Sums of ``values`` rows by ``index`` into ``n`` rows."""
    out = torch.zeros((n,) + values.shape[1:], dtype=values.dtype, device=values.device)
    return out.index_add_(0, index, values)


def energy_bound(n_slots: int) -> float:
    """The engine's out-of-bounds energy: 1000 eV + 20 eV per slot."""
    return 1000.0 + 20.0 * n_slots
