"""Relaxed supercells of the port (slice 4) against the JAX package on the
CPU: the banded message backward (row 9 of PERF.md's kernel table), the
banded reverse table, the banded differentiable trunk, and FIRE-relaxed
energies through it.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances:
- KERNEL_TOL (rtol 1e-6, atol 1e-5; tests/test_painn.py's rule) holds the
  plain banded backward to the JAX Pallas kernel in interpret mode with f32
  routing: the same f32 terms summed in another order, on a toy band with
  short sums.
- The banded and unbanded plain backwards are the same function on permuted
  rows; the halo fold adds a slot's two rows in another order, so the
  gradients agree to 1e-5 of their scale (exactly elsewhere).
- Energies and forces of the relaxed 3x3 cell are held to PR 2's 1e-3 eV
  and 1e-3 eV/A (tests/test_torch_relax.py); relaxed energies to 5e-3 eV
  and positions to 1e-3 A, the tolerance the JAX package holds its own two
  topology modes to (FIRE amplifies summation-order noise).

The toy band over 42 slots on a line is built with blocks of 8: the JAX
package launches its banded backward with half the forward's block
(``_bwd_block``) but hands it the window starts of the band's own blocks,
so only a band of 8-blocks (every production band from 496 slots up) has a
JAX reference there. JAX's general trunk on the CPU takes its gather path
and ignores the band, so whole-path parity compares the port's banded trunk
with JAX's unbanded one: the same function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu import systems as jsystems
from surface_sampling_tpu.core import MCMCRun as JMCMCRun
from surface_sampling_tpu.core import make_spec as j_make_spec
from surface_sampling_tpu.core import state as jstate
from surface_sampling_tpu.core.energy import RelaxConfig as JRelaxConfig
from surface_sampling_tpu.core.static_neighbors import (
    build_static_neighbor_table as j_build_table,
)
from surface_sampling_tpu.models.nn_calculator import make_painn_potential as j_make_potential
from surface_sampling_tpu.models.painn import PaiNNConfig as JPaiNNConfig
from surface_sampling_tpu.models.train import init_ensemble
from surface_sampling_tpu.ops import pallas_painn as pp
from surface_sampling_tpu.ops.banding import build_routing_band_for_spec as j_build_band
from surface_sampling_tpu.structure import Structure as JStructure
from surface_sampling_tpu_torch.core import state as tstate
from surface_sampling_tpu_torch.core.energy import RelaxConfig
from surface_sampling_tpu_torch.core.engine import MCMCRun
from surface_sampling_tpu_torch.core.spec import make_spec
from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
from surface_sampling_tpu_torch.models.nn_calculator import make_painn_potential
from surface_sampling_tpu_torch.models.painn import PaiNNConfig, with_halo
from surface_sampling_tpu_torch.models.weights import from_jax_params
from surface_sampling_tpu_torch.ops import painn_kernels as pk
from surface_sampling_tpu_torch.ops.banding import (
    banded_reverse_table,
    build_routing_band,
    build_routing_band_for_spec,
    stage_band,
)
from surface_sampling_tpu_torch.structure import Structure
from surface_sampling_tpu_torch.systems import srtio3_001_painn

KERNEL_TOL = dict(rtol=1e-6, atol=1e-5)
E_TOL = 1e-3            # eV and eV/A, port vs JAX, unrelaxed
E_TOL_RELAXED = 5e-3    # eV, port vs JAX after FIRE
POS_TOL_RELAXED = 1e-3  # A
C, K, F, R, M = 2, 2, 8, 8, 6
N_PAD = 48
BWD_NAMES = ("g_phi", "g_vcat", "g_rbf", "g_envm", "g_unit", "g_dw", "g_db")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in this module is many small tensor ops: with
    other test processes on the machine, torch's intra-op threads mostly
    wait on each other, so the module runs them on one thread (restored
    afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# Row 9 at toy size: a band of 8-blocks over 42 slots on a periodic line
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def toy_band():
    """42 slots 1 A apart on a 42 A periodic line, each slot's candidates
    its 12 nearest: n_pad 48 in blocks of 8, window 32, halo 16."""
    n = 42
    x = np.arange(n, dtype=np.float64)
    diff = (x[None, :] - x[:, None] + n / 2) % n - n / 2
    slot_j = np.argsort(np.abs(diff) + np.eye(n) * 1e9, axis=1)[:, :12].astype(np.int32)
    band = build_routing_band(np.stack([x, 0 * x, 0 * x], 1), slot_j,
                              np.ones_like(slot_j, bool), 8, N_PAD)
    assert (band.window, band.halo, band.n_blk, len(band.win_start)) == (32, 16, 8, 6)
    return band, slot_j


def _toy_case(band, slot_j, seed):
    """Sorted-order geometry of C chains over all 48 sorted rows (neighbour
    ranks among each centre's candidates, a third of the edges masked),
    features of the sorted slots and cotangents."""
    rng = np.random.default_rng(seed)
    perm = np.asarray(band.perm)
    cand = slot_j[np.minimum(np.tile(perm, (C, 1)), slot_j.shape[0] - 1)]
    pick = np.argsort(rng.random(cand.shape), axis=-1)[..., :M]      # M distinct candidates
    nbr = np.asarray(band.rank)[np.take_along_axis(cand, pick, axis=2)]

    def rn(*shape):
        return rng.normal(size=shape).astype(np.float32)

    envm = np.abs(rn(C, N_PAD * M))
    envm[rng.random(envm.shape) < 0.33] = 0.0
    # cotangents at a tenth of the features' scale keep every output, g_dw's
    # sum over all edges included, within a few units (KERNEL_TOL's atol)
    return dict(phi=rn(C, K, N_PAD, 3 * F), vcat=rn(C, K, N_PAD, 3 * F),
                rbf=rn(C, N_PAD * M, R), envm=envm,
                nbr=nbr.reshape(C, -1).astype(np.int32), unit=rn(C, 3, N_PAD, M),
                dw=rn(K, R, 3 * F), db=rn(K, 3 * F), gds=0.1 * rn(C, K, N_PAD, F),
                gdv=0.1 * rn(C, K, N_PAD, 3 * F))


def _ext(x, halo):
    return np.concatenate([x, x[:, :, :halo]], axis=2)


@pytest.mark.parametrize("want_dw", [True, False])
def test_banded_backward_plain_matches_pallas(toy_band, want_dw):
    """(a) painn_message_bwd_banded_plain against JAX
    _message_bwd_pallas_banded (interpret, f32 routing), two chains and two
    members per port call, each (chain, member) slice against one JAX
    call: the extended-row cotangents of phi and vcat, the edge cotangents
    summed over members, g_dw / g_db summed over chains, or None when not
    asked for."""
    band, slot_j = toy_band
    dband = stage_band(band, "cpu")
    x = _toy_case(band, slot_j, 0)
    phi_ext, vcat_ext = _ext(x["phi"], band.halo), _ext(x["vcat"], band.halo)
    got = pk.painn_message_bwd_banded_plain(
        *(torch.as_tensor(a) for a in (phi_ext, vcat_ext, x["rbf"], x["envm"], x["nbr"],
                                       x["unit"], x["dw"], x["db"], x["gds"], x["gdv"])),
        dband, want_dw=want_dw)
    want = {n: [] for n in BWD_NAMES}
    for c in range(C):
        per_k = []
        for k in range(K):
            gdv3 = x["gdv"][c, k].reshape(N_PAD, 3, F).transpose(1, 0, 2)
            per_k.append([np.asarray(a) for a in pp._message_bwd_pallas_banded(
                jnp.asarray(phi_ext[c, k]), jnp.asarray(vcat_ext[c, k]),
                jnp.asarray(x["rbf"][c]), jnp.asarray(x["envm"][c][:, None]),
                jnp.asarray(x["nbr"][c][:, None]), jnp.asarray(x["unit"][c]),
                jnp.asarray(x["dw"][k]), jnp.asarray(x["db"][k][None]),
                jnp.asarray(band.win_start), jnp.asarray(x["gds"][c, k]), jnp.asarray(gdv3),
                n_blk=band.n_blk, window=band.window, n_pad=N_PAD, routing="f32")])
        want["g_phi"].append([p[0] for p in per_k])
        want["g_vcat"].append([p[1] for p in per_k])
        want["g_rbf"].append(sum(p[2] for p in per_k))
        want["g_envm"].append(sum(p[3][:, 0] for p in per_k))
        want["g_unit"].append(sum(p[4] for p in per_k))
        want["g_dw"].append([p[5] for p in per_k])
        want["g_db"].append([p[6][0] for p in per_k])
    want = {n: np.asarray(v) for n, v in want.items()}
    want["g_dw"], want["g_db"] = want["g_dw"].sum(0), want["g_db"].sum(0)
    assert got[0].shape == (C, K, N_PAD + band.halo, 3 * F)
    for name, g in zip(BWD_NAMES, got):
        if name in ("g_dw", "g_db") and not want_dw:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name, **KERNEL_TOL)


def test_banded_autograd_equals_unbanded(toy_band):
    """(b) The gradients through painn_message_fused_banded (the autograd
    Function over the plain kernel) and with_halo, of phi, vcat, rbf, envm,
    unit, dw and db, equal the unbanded painn_message_fused gradients on
    the same geometry in slot order after un-permuting: a slot read as row r
    by one window and as row r + n_pad by another folds back onto one row.
    The forward is exact; the fold sums in another order (1e-5 of scale)."""
    band, slot_j = toy_band
    dband = stage_band(band, "cpu")
    x = _toy_case(band, slot_j, 1)
    assert (np.asarray(band.win_start) + band.window > N_PAD).any()   # windows wrap
    perm, ip = np.asarray(band.perm), np.asarray(band.inv_perm)

    def slot_order(a, axis):
        return np.take(a, ip, axis=axis)

    def per_edge(a):   # (C, n_pad*M, ...) sorted centre rows -> slot order
        return slot_order(a.reshape(C, N_PAD, M, *a.shape[2:]), 1).reshape(a.shape)

    banded = {n: torch.as_tensor(x[n]).requires_grad_(True)
              for n in ("phi", "vcat", "rbf", "envm", "unit", "dw", "db")}
    ds_b, dv_b = pk.painn_message_fused_banded(
        with_halo(banded["phi"], band.halo, 2), with_halo(banded["vcat"], band.halo, 2),
        banded["rbf"], banded["envm"], torch.as_tensor(x["nbr"]), banded["unit"], banded["dw"],
        banded["db"], dband)
    g_b = torch.autograd.grad((ds_b, dv_b), list(banded.values()),
                              (torch.as_tensor(x["gds"]), torch.as_tensor(x["gdv"])))
    slot = {"phi": slot_order(x["phi"], 2), "vcat": slot_order(x["vcat"], 2),
            "rbf": per_edge(x["rbf"]), "envm": per_edge(x["envm"]),
            "unit": slot_order(x["unit"], 2), "dw": x["dw"], "db": x["db"]}
    unbanded = {n: torch.as_tensor(v).requires_grad_(True) for n, v in slot.items()}
    nbr_u = per_edge(perm[x["nbr"]]).astype(np.int32)          # ranks -> slots
    ds_u, dv_u = pk.painn_message_fused(
        unbanded["phi"], unbanded["vcat"], unbanded["rbf"], unbanded["envm"],
        torch.as_tensor(nbr_u), unbanded["unit"], unbanded["dw"], unbanded["db"])
    g_u = torch.autograd.grad((ds_u, dv_u), list(unbanded.values()),
                              (torch.as_tensor(slot_order(x["gds"], 2)),
                               torch.as_tensor(slot_order(x["gdv"], 2))))
    assert torch.equal(ds_b[:, :, ip], ds_u) and torch.equal(dv_b[:, :, ip], dv_u)
    to_slot = {"phi": lambda a: slot_order(a, 2), "vcat": lambda a: slot_order(a, 2),
               "unit": lambda a: slot_order(a, 2), "rbf": per_edge, "envm": per_edge}
    for name, gb, gu in zip(banded, g_b, g_u):
        gb = to_slot.get(name, lambda a: a)(gb.numpy())
        np.testing.assert_allclose(gb, gu.numpy(), rtol=0,
                                   atol=1e-5 * float(gu.abs().max()), err_msg=name)


def test_banded_reverse_table_lists_selected_edges_by_extended_row(toy_band):
    """The banded reverse table lists every selected edge once, under the
    extended row its window reads, ascending, and its depth bound (the
    candidates' in-degree) truncates nothing."""
    band, slot_j = toy_band
    dband = stage_band(band, "cpu")
    x = _toy_case(band, slot_j, 2)
    sel = torch.as_tensor(x["envm"] != 0)
    depth = int(np.bincount(slot_j.reshape(-1)).max())
    rev = banded_reverse_table(torch.as_tensor(x["nbr"]), sel, dband, depth)
    assert rev.shape == (C, N_PAD + band.halo, depth)
    ws = np.repeat(np.asarray(band.win_start)[np.arange(N_PAD) // band.n_blk], M)
    want_row = ws + (x["nbr"] - ws) % N_PAD
    for c in range(C):
        r = rev[c].numpy()
        listed = np.sort(r[r >= 0])
        np.testing.assert_array_equal(listed, np.flatnonzero(x["envm"][c] != 0))
        for row in range(N_PAD + band.halo):
            ids = r[row][r[row] >= 0]
            assert (np.diff(ids) > 0).all() and (want_row[c, ids] == row).all()
    assert (rev[:, N_PAD:] >= 0).any()        # the halo rows are read


# ----------------------------------------------------------------------
# The relaxed 3x3 flagship: energy and forces through rows 7 and 9
# ----------------------------------------------------------------------
def test_relaxed_3x3_energy_and_forces_match_jax():
    """(c) The relaxed 3x3 supercell (1116 slots, relax table slack 0.6,
    one member) carries a routing band with n_pad 1120, and its energy and
    forces at one seeded physical occupancy (three adsorbates far apart)
    match JAX's energy_and_forces (its CPU gather path): 1e-3 eV and
    1e-3 eV/A; dead slots get zero force."""
    tsys = srtio3_001_painn(supercell=(3, 3), relax=RelaxConfig(), n_models=1, device="cpu")
    band = tsys.potential.band
    assert tsys.routing_band is not None and band.n_pad == 1120
    assert (band.window, band.halo, band.n_blk) == (656, 648, 8)
    S = tsys.spec.n_sites
    rng = np.random.default_rng(11)
    ss = np.zeros((1, S), np.int64)
    ss[0, rng.choice(S, 3, replace=False)] = [1, 2, 3]
    td, tss = tsys.run.d, torch.as_tensor(ss)
    alive = tstate.realize_alive(td, tss)
    te, tf = tsys.potential.energy_and_forces(
        tstate.realize_positions(td, tss), tstate.realize_type_idx(td, tss), alive)

    jsys = jsystems.srtio3_001_painn(supercell=(3, 3), relax=JRelaxConfig(), n_models=1)
    jd, js = jsys.run.d, jnp.asarray(ss[0], jnp.int32)
    je, jf = jax.jit(lambda p: jsys.potential.energy_and_forces(
        p, jstate.realize_type_idx(jd, js), jstate.realize_alive(jd, js), jd.shifts))(
        jstate.realize_positions(jd, js))
    assert abs(float(te[0]) - float(je)) <= E_TOL
    np.testing.assert_allclose(tf[0].numpy(), np.asarray(jf), rtol=0, atol=E_TOL)
    assert float(tf[0].abs().max()) > 1.0
    assert not tf[~alive].any()


# ----------------------------------------------------------------------
# The relaxed path through the band at toy size, against JAX
# ----------------------------------------------------------------------
TYPES = [22, 8, 38]
CFG = dict(feat_dim=16, n_rbf=6, cutoff=4.0, n_layers=2, readout_hidden=8, max_neighbors=10,
           excl_vol=True, sigma=1.2, power=8.0)


def toy_relax_spec(structure_cls, spec_fn):
    """21 Ti 2 A apart on a 42 A line with a site above each (the toy of
    tests/test_incremental.py): its relax table (slack 0.6) bands, n_pad 48
    in blocks of 16, window 40, halo 24."""
    rng = np.random.default_rng(5)
    xs = np.arange(21) * 2.0 + 0.3
    pos = np.stack([xs, np.full(21, 2.0), np.full(21, 5.0)], axis=1)
    pos[:, 1] += rng.uniform(-0.3, 0.3, 21)
    slab = structure_cls.from_symbols(["Ti"] * 21, pos, np.diag([42.0, 4.2, 16.0]))
    return spec_fn(slab, pos + np.array([0.7, 0.0, 1.9]), ["O", "Sr"], potential_numbers=TYPES,
                   cutoff=4.0, surface_name="toy_band")


def toy_relax_systems(relax_kw):
    """The toy with a random 2-member PaiNN in eV, relaxed by FIRE: the JAX
    (spec, run, potential) and the port's (spec, run, potential, table),
    the port's potential carrying the band."""
    jcfg = JPaiNNConfig(**CFG, pallas_routing="f32")
    jspec = toy_relax_spec(JStructure, j_make_spec)
    jnbr = j_build_table(jspec, jcfg.cutoff, relax_slack=0.6)
    params = init_ensemble(jax.random.PRNGKey(0), jcfg, 2)
    jpot = j_make_potential(params, jcfg, TYPES, units="eV", ensemble=True, static_nbr=jnbr,
                            routing_band=j_build_band(jspec, jnbr))
    jrun = JMCMCRun(jspec, jpot, relax=JRelaxConfig(**relax_kw))

    spec = toy_relax_spec(Structure, make_spec)
    nbr = build_static_neighbor_table(spec, CFG["cutoff"], relax_slack=0.6)
    band = build_routing_band_for_spec(spec, nbr)
    pot = make_painn_potential(from_jax_params(jax.tree.map(np.asarray, params), "cpu"),
                               PaiNNConfig(**CFG), TYPES, units="eV", static_nbr=nbr,
                               device="cpu", routing_band=band)
    run = MCMCRun(spec, pot, device="cpu", relax=RelaxConfig(**relax_kw))
    return (jspec, jrun, jpot), (spec, run, pot, nbr)


@pytest.mark.parametrize("refresh", ["once", "every_step"])
def test_relaxed_banded_toy_matches_jax(refresh):
    """The whole relaxed path through the band (edges with the banded
    reverse table, the banded trunk, row 9's plain version, FIRE, the
    fresh-edge energy): relaxed surface energies within 5e-3 eV and
    positions within 1e-3 A of JAX's, in both topology modes, for three
    occupancies; the band covers the relax table and something moved."""
    (jspec, jrun, _), (spec, run, pot, _) = toy_relax_systems(
        dict(steps=6, refresh_edges=refresh))
    band = pot.band
    assert band is not None and (band.window, band.halo, band.n_blk) == (40, 24, 16)
    ss = np.zeros((3, spec.n_sites), np.int64)
    ss[0, 2], ss[1, [3, 9]], ss[2, ::3] = 1, [1, 2], 2
    want = jax.jit(jax.vmap(jrun.state_energy_fn))(jnp.asarray(ss, jnp.int32))
    got = run.state_energy_fn(torch.as_tensor(ss))
    assert not got.oob.any() and not np.asarray(want.oob).any()
    np.testing.assert_allclose(got.surface_energy.numpy(), np.asarray(want.surface_energy),
                               rtol=0, atol=E_TOL_RELAXED)
    np.testing.assert_allclose(got.positions.numpy(), np.asarray(want.positions),
                               atol=POS_TOL_RELAXED)
    ideal = tstate.realize_positions(run.d, torch.as_tensor(ss))
    assert (got.positions - ideal).abs().max() > 1e-3
