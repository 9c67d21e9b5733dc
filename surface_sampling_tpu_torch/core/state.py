"""Device-side chain state and occupancy moves, batched over chains.

The counterpart of ``surface_sampling_tpu/core/state.py``. Every function
takes ``site_state`` of shape (C, S) — one row of adsorbate codes per
chain — and returns arrays with the same leading chain axis. Realized atom
arrays are gathers of ``site_state`` against the spec's template tables; a
move is one integer write per chain.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from surface_sampling_tpu_torch.core.spec import SurfaceSpec


class MCState(NamedTuple):
    """Markov state of a batch of chains (leading axis = chains).

    Attributes:
        site_state: (C, S) int64 adsorbate code per site (0 = empty).
        energy: (C,) cached surface energy of the current state.
        relaxed_positions: (C, N, 3) last accepted relaxed geometry (the
            ideal slot realization when relaxation is off).
    """

    site_state: torch.Tensor
    energy: torch.Tensor
    relaxed_positions: torch.Tensor


class DeviceSpec(NamedTuple):
    """Constant arrays of a SurfaceSpec, staged onto one device."""

    pristine_numbers: torch.Tensor     # (P,) int64
    pristine_positions: torch.Tensor   # (P, 3) f32
    frozen_pristine: torch.Tensor      # (P,) bool bulk atoms
    site_coords: torch.Tensor          # (S, 3) f32
    code_numbers: torch.Tensor         # (K+1, G) int64
    code_offsets: torch.Tensor         # (K+1, G, 3) f32
    code_natoms: torch.Tensor          # (K+1,) int64
    z_to_element: torch.Tensor         # (Zmax+2,) int64
    type_of_z: torch.Tensor            # (Zmax+2,) int64
    shifts: torch.Tensor               # (Kimg, 3) f32 periodic image shifts
    n_elements: int
    n_codes: int
    device: torch.device


def device_spec(spec: SurfaceSpec, device: torch.device) -> DeviceSpec:
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return DeviceSpec(
        pristine_numbers=i64(spec.pristine_numbers),
        pristine_positions=f32(spec.pristine_positions),
        frozen_pristine=torch.as_tensor(np.asarray(spec.frozen_pristine, bool), device=device),
        site_coords=f32(spec.site_coords),
        code_numbers=i64(spec.code_numbers),
        code_offsets=f32(spec.code_offsets),
        code_natoms=i64(spec.code_natoms),
        z_to_element=i64(spec.z_to_element),
        type_of_z=i64(spec.type_of_z),
        shifts=f32(spec.shifts),
        n_elements=len(spec.element_zs),
        n_codes=spec.n_codes,
        device=device,
    )


def realize_numbers(d: DeviceSpec, site_state: torch.Tensor) -> torch.Tensor:
    """(C, N) atomic numbers of all slots (0 = dead)."""
    C = site_state.shape[0]
    ads = d.code_numbers[site_state].reshape(C, -1)              # (C, S*G)
    return torch.cat([d.pristine_numbers.expand(C, -1), ads], dim=1)


def realize_positions(d: DeviceSpec, site_state: torch.Tensor) -> torch.Tensor:
    """(C, N, 3) ideal slot positions: site coordinate + group offset."""
    C = site_state.shape[0]
    ads = d.site_coords[None, :, None, :] + d.code_offsets[site_state]   # (C, S, G, 3)
    return torch.cat([d.pristine_positions.expand(C, -1, -1), ads.reshape(C, -1, 3)], dim=1)


def realize_alive(d: DeviceSpec, site_state: torch.Tensor) -> torch.Tensor:
    """(C, N) bool alive mask."""
    return realize_numbers(d, site_state) > 0


def realize_free_mask(d: DeviceSpec, site_state: torch.Tensor) -> torch.Tensor:
    """(C, N) bool: slots whose positions may relax (alive and not frozen
    bulk; the analog of ase FixAtoms)."""
    alive = realize_alive(d, site_state)
    frozen = torch.nn.functional.pad(d.frozen_pristine, (0, alive.shape[1] - d.frozen_pristine.shape[0]))
    return alive & ~frozen


def realize_type_idx(d: DeviceSpec, site_state: torch.Tensor) -> torch.Tensor:
    """(C, N) potential type index per slot (dead slots get type 0)."""
    return d.type_of_z[realize_numbers(d, site_state)]


def element_counts(d: DeviceSpec, site_state: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """(C, E) per-element atom counts (dead slots map to -1 and count
    nowhere)."""
    elem = d.z_to_element[realize_numbers(d, site_state)]         # (C, N)
    slots = torch.arange(d.n_elements, device=elem.device)
    return (elem[..., None] == slots).sum(dim=1).to(dtype)


def change_site(site_state: torch.Tensor, site_idx: torch.Tensor,
                new_code: torch.Tensor) -> torch.Tensor:
    """Copy of ``site_state`` with site ``site_idx[c]`` of chain c set to
    ``new_code[c]`` (0 = desorb)."""
    out = site_state.clone()
    out.scatter_(1, site_idx[:, None], new_code[:, None].to(out.dtype))
    return out


def exchange_sites(site_state: torch.Tensor, site1: torch.Tensor,
                   site2: torch.Tensor) -> torch.Tensor:
    """Copy of ``site_state`` with the codes of sites ``site1[c]`` and
    ``site2[c]`` of chain c swapped (the canonical move)."""
    c1 = torch.gather(site_state, 1, site1[:, None])
    c2 = torch.gather(site_state, 1, site2[:, None])
    out = site_state.clone()
    out.scatter_(1, site1[:, None], c2)
    out.scatter_(1, site2[:, None], c1)
    return out


def num_adsorbate_atoms(d: DeviceSpec, site_state: torch.Tensor) -> torch.Tensor:
    """(C,) adsorbed atoms per chain (atoms, not sites, so that groups
    count by their size)."""
    return d.code_natoms[site_state].sum(dim=1)


def num_occupied_sites(site_state: torch.Tensor) -> torch.Tensor:
    """(C,) number of occupied sites per chain."""
    return (site_state > 0).sum(dim=1)


def initial_state(d: DeviceSpec, site_state: torch.Tensor,
                  energy: float = 0.0) -> MCState:
    """Fresh MCState for a (C, S) batch of occupancies."""
    site_state = torch.as_tensor(site_state, dtype=torch.int64, device=d.device)
    C = site_state.shape[0]
    return MCState(
        site_state=site_state,
        energy=torch.full((C,), float(energy), dtype=torch.float32, device=d.device),
        relaxed_positions=realize_positions(d, site_state),
    )
