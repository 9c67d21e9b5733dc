"""ctypes bindings of the surfkit host library, with numpy versions.

The counterpart of ``surface_sampling_tpu/runtime/native.py``: three host
helpers that sit outside the device programs (a linked-cell neighbour
list, the minimum-image distance among selected atoms, a multi-frame XYZ
writer). ``csrc/surfkit.cpp`` is compiled with g++ at first use into the
package's ``_build/`` (listed in .gitignore), named by a hash of the source
and the flags, never into the package directory. Without a toolchain every
function takes its numpy version, which is also exported under its own
name (``cell_list_neighbors_numpy``, ``min_selected_distance_numpy``,
``write_xyz_frames_python``) as the reference the native code is held to.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent.parent
_SRC = Path(__file__).resolve().parent / "csrc" / "surfkit.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-fPIC", "-shared")
_lib = None
_tried = False


def lib_path() -> Path:
    """Where the library of this source and these flags is built."""
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsurfkit-{tag}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{id(out)}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        tmp.replace(out)
        return True
    except (OSError, subprocess.SubprocessError) as e:   # no g++, or it failed
        logger.warning("surfkit native build failed (%s); using the numpy versions", e)
        tmp.unlink(missing_ok=True)
        return False


def load_library():
    """Load (building it first if needed) the native library; None if it
    cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = lib_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        logger.warning("surfkit load failed: %s", e)
        return None
    c_d = ctypes.POINTER(ctypes.c_double)
    c_i32 = ctypes.POINTER(ctypes.c_int32)
    lib.sk_cell_list_neighbors.restype = ctypes.c_int64
    lib.sk_cell_list_neighbors.argtypes = [
        c_d, ctypes.c_int64, c_d, c_i32, ctypes.c_double, ctypes.c_int64,
        c_i32, c_d, c_i32,
    ]
    lib.sk_min_selected_distance.restype = ctypes.c_double
    lib.sk_min_selected_distance.argtypes = [
        c_d, ctypes.c_int64, c_d, c_i32, c_i32, ctypes.c_int64,
    ]
    lib.sk_write_xyz_frames.restype = ctypes.c_int32
    lib.sk_write_xyz_frames.argtypes = [
        ctypes.c_char_p, c_i32, c_d, c_d, ctypes.c_int64, ctypes.c_int64,
    ]
    _lib = lib
    return _lib


def _ptr_d(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ptr_i(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _neighbor_inputs(positions, cell, pbc):
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    cell = np.ascontiguousarray(cell, dtype=np.float64)
    pbc_arr = np.ascontiguousarray(np.asarray(pbc, dtype=np.int32))
    if positions.ndim != 2 or positions.shape[1] != 3 or cell.shape != (3, 3) \
            or pbc_arr.shape != (3,):
        raise ValueError("positions must be (N, 3), the cell 3x3 and pbc three flags")
    return positions, cell, pbc_arr


def cell_list_neighbors(
    positions: np.ndarray,
    cell: np.ndarray,
    cutoff: float,
    max_neighbors: int = 64,
    pbc=(True, True, True),
):
    """O(N) neighbour list on the host. Returns (nbr_idx (N, M) int32,
    nbr_disp (N, M, 3), nbr_count (N,), max_count). ``max_count`` may
    exceed ``max_neighbors``: it sizes a padded neighbour capacity."""
    positions, cell, pbc_arr = _neighbor_inputs(positions, cell, pbc)
    lib = load_library()
    if lib is None:
        return cell_list_neighbors_numpy(positions, cell, cutoff, max_neighbors, pbc)
    n = len(positions)
    nbr_idx = np.zeros((n, max_neighbors), dtype=np.int32)
    nbr_disp = np.zeros((n, max_neighbors, 3), dtype=np.float64)
    nbr_count = np.zeros(n, dtype=np.int32)
    max_count = lib.sk_cell_list_neighbors(
        _ptr_d(positions), n, _ptr_d(cell), _ptr_i(pbc_arr),
        float(cutoff), max_neighbors,
        _ptr_i(nbr_idx), _ptr_d(nbr_disp), _ptr_i(nbr_count),
    )
    return nbr_idx, nbr_disp, nbr_count, int(max_count)


def cell_list_neighbors_numpy(positions, cell, cutoff: float, max_neighbors: int = 64,
                              pbc=(True, True, True)):
    """:func:`cell_list_neighbors` by a dense image scan in numpy."""
    from surface_sampling_tpu_torch.ops.neighbors import pair_shifts

    positions, cell, _ = _neighbor_inputs(positions, cell, pbc)
    n = len(positions)
    nbr_idx = np.zeros((n, max_neighbors), dtype=np.int32)
    nbr_disp = np.zeros((n, max_neighbors, 3), dtype=np.float64)
    nbr_count = np.zeros(n, dtype=np.int32)
    shifts = pair_shifts(cell, cutoff, pbc=pbc)
    diff = positions[None, :, None, :] - (positions[None, None, :, :] + shifts[:, None, None, :])
    r2 = np.sum(diff * diff, axis=-1)
    mask = (r2 < cutoff**2) & (r2 > 1e-20)
    max_count = 0
    for i in range(n):
        ks, js = np.where(mask[:, i, :])
        cnt = len(js)
        max_count = max(max_count, cnt)
        m = min(cnt, max_neighbors)
        nbr_idx[i, :m] = js[:m]
        nbr_disp[i, :m] = diff[ks[:m], i, js[:m]]
        nbr_count[i] = m
    return nbr_idx, nbr_disp, nbr_count, int(max_count)


def _selected_inputs(positions, cell, selected_idx):
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    cell = np.ascontiguousarray(cell, dtype=np.float64)
    sel = np.ascontiguousarray(np.asarray(selected_idx, dtype=np.int32))
    if len(sel) and (sel.min() < 0 or sel.max() >= len(positions)):
        raise ValueError("selected_idx out of range")
    return positions, cell, sel


def min_selected_distance(positions, cell, selected_idx, pbc=(True, True, True)) -> float:
    """Minimum minimum-image distance among the selected atoms (1e30 for
    fewer than two)."""
    positions, cell, sel = _selected_inputs(positions, cell, selected_idx)
    lib = load_library()
    if lib is None:
        return min_selected_distance_numpy(positions, cell, sel, pbc)
    pbc_arr = np.ascontiguousarray(np.asarray(pbc, dtype=np.int32))
    return float(lib.sk_min_selected_distance(
        _ptr_d(positions), len(positions), _ptr_d(cell), _ptr_i(pbc_arr),
        _ptr_i(sel), len(sel)))


def min_selected_distance_numpy(positions, cell, selected_idx,
                                pbc=(True, True, True)) -> float:
    """:func:`min_selected_distance` in numpy."""
    positions, cell, sel = _selected_inputs(positions, cell, selected_idx)
    if len(sel) < 2:
        return 1e30
    p = positions[sel]
    diff = p[:, None, :] - p[None, :, :]
    frac = diff @ np.linalg.inv(cell)
    frac -= np.round(frac * np.asarray(pbc)) * np.asarray(pbc)
    d = np.linalg.norm(frac @ cell, axis=-1)
    iu = np.triu_indices(len(p), k=1)
    return float(d[iu].min())


def _frame_inputs(numbers, positions_frames, cell):
    numbers = np.ascontiguousarray(numbers, dtype=np.int32)
    frames = np.ascontiguousarray(positions_frames, dtype=np.float64)
    cell = np.ascontiguousarray(cell, dtype=np.float64)
    if frames.ndim == 2:
        frames = frames[None]
    if frames.ndim != 3 or frames.shape[1:] != (len(numbers), 3) or cell.shape != (3, 3):
        raise ValueError(f"frames {frames.shape} do not match {len(numbers)} atoms, or the "
                         f"cell {cell.shape} is not 3x3")
    return numbers, frames, cell


def write_xyz_frames(path, numbers, positions_frames, cell) -> None:
    """Multi-frame extended-XYZ trajectory of one composition (frames (T,
    N, 3) or one (N, 3))."""
    numbers, frames, cell = _frame_inputs(numbers, positions_frames, cell)
    lib = load_library()
    if lib is not None and lib.sk_write_xyz_frames(
            str(path).encode(), _ptr_i(numbers), _ptr_d(frames), _ptr_d(cell),
            frames.shape[0], frames.shape[1]) == 0:
        return
    write_xyz_frames_python(path, numbers, frames, cell)


def write_xyz_frames_python(path, numbers, positions_frames, cell) -> None:
    """:func:`write_xyz_frames` in Python: the same bytes."""
    from surface_sampling_tpu_torch.constants import SYMBOL_FROM_Z

    numbers, frames, cell = _frame_inputs(numbers, positions_frames, cell)
    with open(path, "w") as f:
        cellstr = " ".join(f"{x:.8f}" for x in cell.flatten())
        syms = [SYMBOL_FROM_Z[int(z)] for z in numbers]
        for frame in frames:
            f.write(f"{len(numbers)}\n")
            f.write(f'Lattice="{cellstr}" Properties=species:S:1:pos:R:3\n')
            for s, p in zip(syms, frame):
                f.write(f"{s} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f}\n")
