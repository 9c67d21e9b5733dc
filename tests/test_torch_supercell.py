"""The port's supercell path against the JAX package on the CPU:
the tiled SrTiO3(001) slab, its routing band and recompute tables, the
banded static edges, and the plain versions of the three banded message
kernels.

Host tables are compared exactly. Geometry is held to 5e-5, the JAX static
payload's bf16 hi+lo rounding. The kernels' plain versions are held to the
JAX Pallas kernels in interpret mode with routing="f32" at rtol 1e-6,
atol 1e-5 (tests/test_painn.py's rule: the same f32 terms summed in another
order). Banded and unbanded plain versions compute the same sums in the
same order on permuted rows, so they agree to 1e-6 (exactly, in practice).
JAX is run only on host tables or at toy size: its interpret-mode kernels
are far too slow at supercell size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu import systems as jsystems
from surface_sampling_tpu.core import state as jstate
from surface_sampling_tpu.core.incremental import build_inc_tables as j_build_inc_tables
from surface_sampling_tpu.ops import pallas_painn as pp
from surface_sampling_tpu.ops.static_edges import build_static_edge_pack as j_build_pack
from surface_sampling_tpu.ops.static_edges import static_edge_geometry as j_edge_geometry
from surface_sampling_tpu_torch.core import state as tstate
from surface_sampling_tpu_torch.core.energy import RelaxConfig
from surface_sampling_tpu_torch.core.incremental import build_inc_tables, first_occurrence
from surface_sampling_tpu_torch.ops import painn_kernels as pk
from surface_sampling_tpu_torch.ops.banding import (
    build_routing_band,
    choose_message_block,
    stage_band,
)
from surface_sampling_tpu_torch.ops.static_edges import build_static_edge_pack, static_edge_geometry
from surface_sampling_tpu_torch.systems import srtio3_001_painn

KERNEL_TOL = dict(rtol=1e-6, atol=1e-5)
GEOM_ATOL = 5e-5


@pytest.fixture(scope="module")
def jsys():
    return jsystems.srtio3_001_painn(supercell=(2, 2), n_models=1, pallas_routing="f32")


@pytest.fixture(scope="module")
def tsys():
    return srtio3_001_painn(supercell=(2, 2), n_models=1, device="cpu")


def _random_states(spec, seed, n, empty_frac):
    rng = np.random.default_rng(seed)
    ss = rng.integers(0, spec.n_codes, (n, spec.n_sites))
    return np.where(rng.random(ss.shape) < empty_frac, 0, ss)


def test_supercell_spec_band_and_tables_match(jsys, tsys):
    """(a) The tiled slab gives the JAX package's 256 sites and static
    table, and the routing band and the per-layer recompute tables at 2x2
    equal JAX's exactly; every entry that JAX's dupmask keeps is the first
    occurrence of its block."""
    ja = jsys.potential.__dict__["inc_args"]
    js, ts = ja["spec"], tsys.spec
    assert (ts.n_pristine, ts.n_sites, ts.n_slots) == (240, 256, 496)
    for field in ("pristine_numbers", "pristine_positions", "cell", "frozen_pristine",
                  "site_coords", "code_numbers", "code_offsets"):
        np.testing.assert_array_equal(getattr(ts, field), getattr(js, field), err_msg=field)
    for a, b in zip(tsys.static_nbr[:3], ja["static_nbr"][:3]):
        np.testing.assert_array_equal(a, b)
    jb, tb = ja["band"], tsys.routing_band
    for field in ("perm", "inv_perm", "rank", "win_start"):
        np.testing.assert_array_equal(getattr(tb, field), getattr(jb, field), err_msg=field)
    assert (tb.window, tb.halo, tb.n_blk) == (jb.window, jb.halo, jb.n_blk) == (360, 352, 8)

    jt = j_build_inc_tables(js, ja["static_nbr"], jb, 3)
    tt = build_inc_tables(ts, tsys.static_nbr, tb, 3)
    assert tt.nb == jt.nb == (36, 62, 62)
    for tl, jl, dup in zip(tt.blocks, jt.blocks, jt.dupmask):
        np.testing.assert_array_equal(tl, jl)
        first = first_occurrence(torch.as_tensor(tl, dtype=torch.int64)).numpy()
        np.testing.assert_array_equal(first == np.arange(tl.shape[1]), dup == 1.0)


def test_banded_static_edges_match(jsys, tsys):
    """(b) The banded static edges of a sparse and an over-dense occupancy:
    natural-order edge mask, sorted-order neighbour ranks and the overflow
    flag exactly as JAX's; rbf, envelope and unit vectors to its payload
    rounding."""
    ja = jsys.potential.__dict__["inc_args"]
    jpack = j_build_pack(ja["spec"], ja["static_nbr"], ja["cfg"], band=ja["band"])
    ss = np.concatenate([_random_states(tsys.spec, 0, 1, 0.75),
                         _random_states(tsys.spec, 1, 1, 0.45)])
    alive = tstate.realize_alive(tsys.run.d, torch.as_tensor(ss))
    (rbf, envm, nbr, unit, n_pad), (r, mask, overflow) = static_edge_geometry(
        tsys.potential.static_edge_pack, alive)
    assert overflow.tolist() == [False, True]
    for c, s in enumerate(ss):
        mg, edges = j_edge_geometry(jpack, jstate.realize_alive(jsys.run.d,
                                                                jnp.asarray(s, jnp.int32)))
        assert n_pad == mg[4] == 496
        np.testing.assert_array_equal(mask[c].numpy(), np.asarray(edges[3]))
        assert bool(overflow[c]) == bool(edges[4])
        np.testing.assert_array_equal(nbr[c].numpy(), np.asarray(mg[2])[:, 0])
        np.testing.assert_allclose(rbf[c].numpy(), np.asarray(mg[0]), atol=GEOM_ATOL)
        np.testing.assert_allclose(envm[c].numpy(), np.asarray(mg[1])[:, 0], atol=GEOM_ATOL)
        np.testing.assert_allclose(unit[c].numpy(), np.asarray(mg[3]), atol=GEOM_ATOL)
        np.testing.assert_allclose(r[c].numpy(), np.asarray(edges[1]), atol=1e-4)


# ----------------------------------------------------------------------
# Kernels at toy size: a real band over a 1-D chain of 42 slots
# ----------------------------------------------------------------------
C, K, F, R, M, T = 2, 2, 8, 8, 6, 3


@pytest.fixture(scope="module")
def toy_band():
    """A band over 42 slots spaced 1 A along a 42 A periodic line, each
    slot's candidates the 12 nearest: n_pad 48, blocks of 16, W < n_pad and
    a halo."""
    n = 42
    x = np.arange(n, dtype=np.float64)
    centers = np.stack([x, np.zeros(n), np.zeros(n)], axis=1)
    diff = (x[None, :] - x[:, None] + n / 2) % n - n / 2
    order = np.argsort(np.abs(diff) + (np.arange(n) == np.arange(n)[:, None]) * 1e9, axis=1)
    slot_j = order[:, :12].astype(np.int32)
    band = build_routing_band(centers, slot_j, np.ones_like(slot_j, bool),
                              choose_message_block(48), 48)
    assert band is not None and band.halo > 0 and band.window < 48
    return band, slot_j


def _toy_geometry(rng, band, slot_j, n_rows, centre_slot):
    """Edge geometry of C chains over n_rows sorted centre rows whose slots
    are ``centre_slot`` (C, n_rows): M edges each, neighbour ranks drawn
    from the centre's candidates, a third of the edges masked."""
    cand = slot_j[np.minimum(centre_slot, slot_j.shape[0] - 1)]         # (C, n_rows, 12)
    pick = rng.integers(0, cand.shape[-1], (C, n_rows, M))
    nbr = np.take_along_axis(cand, pick, axis=2)
    nbr = np.asarray(band.rank)[nbr].reshape(C, n_rows * M).astype(np.int32)
    envm = np.abs(rng.normal(size=(C, n_rows * M))).astype(np.float32)
    envm[rng.random(envm.shape) < 0.33] = 0.0
    rbf = rng.normal(size=(C, n_rows * M, R)).astype(np.float32)
    unit = rng.normal(size=(C, 3, n_rows, M)).astype(np.float32)
    return rbf, envm, nbr, unit


def _ext(x, halo, axis):
    return np.concatenate([x, np.take(x, np.arange(halo), axis=axis)], axis=axis)


def _vcat(dv3):
    return np.concatenate([np.asarray(dv3[x]) for x in range(3)], axis=1)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_banded_kernels_plain_match_pallas(toy_band):
    """(c) The plain versions of rows 6-8 against the JAX banded Pallas
    kernels (interpret mode, f32 routing), two chains and two members per
    port call, each (chain, member) slice against one JAX call."""
    band, slot_j = toy_band
    dband = stage_band(band, "cpu")
    n_pad, n_blk, W, halo = 48, band.n_blk, band.window, band.halo
    rng = np.random.default_rng(0)
    perm = np.asarray(band.perm)
    rbf, envm, nbr, unit = _toy_geometry(rng, band, slot_j, n_pad, np.tile(perm, (C, 1)))
    ws = jnp.asarray(band.win_start)
    jargs = dict(n_blk=n_blk, window=W, n_pad=n_pad, routing="f32")

    # row 6: layer-1 message from the sorted, halo-extended species table
    species = rng.integers(0, T + 1, (C, n_pad)).astype(np.int32)
    philt8 = np.zeros((K, 8, 2 * F), np.float32)
    philt8[:, :T] = rng.normal(size=(K, T, 2 * F))
    philt = np.concatenate([philt8[:, :T], np.zeros((K, 1, 2 * F), np.float32)], axis=1)
    dw2 = rng.normal(size=(K, R, 2 * F)).astype(np.float32)
    db2 = rng.normal(size=(K, 2 * F)).astype(np.float32)
    sp_ext = _ext(species, halo, 1)
    ds, dv = pk.painn_message_l1_banded(*_t(sp_ext, philt, rbf, envm, nbr, unit, dw2, db2),
                                        dband)
    for c in range(C):
        sp8 = np.zeros((sp_ext.shape[1], 8), np.float32)
        live = sp_ext[c] < T
        sp8[np.arange(sp_ext.shape[1])[live], sp_ext[c][live]] = 1.0
        for k in range(K):
            ds_j, dv_j = pp.painn_message_l1_banded(
                jnp.asarray(sp8), jnp.asarray(philt8[k]), jnp.asarray(rbf[c]),
                jnp.asarray(envm[c][:, None]), jnp.asarray(nbr[c][:, None]),
                jnp.asarray(unit[c]), jnp.asarray(dw2[k]), jnp.asarray(db2[k][None]), ws,
                **jargs)
            np.testing.assert_allclose(ds[c, k].numpy(), np.asarray(ds_j), **KERNEL_TOL)
            np.testing.assert_allclose(dv[c, k].numpy(), _vcat(dv_j), **KERNEL_TOL)

    # row 7: general message over the full sorted cell
    phi = _ext(rng.normal(size=(C, K, n_pad, 3 * F)).astype(np.float32), halo, 2)
    vcat = _ext(rng.normal(size=(C, K, n_pad, 3 * F)).astype(np.float32), halo, 2)
    dw = rng.normal(size=(K, R, 3 * F)).astype(np.float32)
    db = rng.normal(size=(K, 3 * F)).astype(np.float32)
    ds, dv = pk.painn_message_fused_banded(*_t(phi, vcat, rbf, envm, nbr, unit, dw, db), dband)
    for c in range(C):
        for k in range(K):
            ds_j, dv_j = pp.painn_message_fused_banded(
                jnp.asarray(phi[c, k]), jnp.asarray(vcat[c, k]), jnp.asarray(rbf[c]),
                jnp.asarray(envm[c][:, None]), jnp.asarray(nbr[c][:, None]),
                jnp.asarray(unit[c]), jnp.asarray(dw[k]), jnp.asarray(db[k][None]), ws,
                n_blk, W, n_pad, "f32")
            np.testing.assert_allclose(ds[c, k].numpy(), np.asarray(ds_j), **KERNEL_TOL)
            np.testing.assert_allclose(dv[c, k].numpy(), _vcat(dv_j), **KERNEL_TOL)

    # row 8: two blocks per chain, another pair in each chain, one repeated
    blocks = np.array([[2, 0], [1, 1]])
    rows = (blocks[:, :, None] * n_blk + np.arange(n_blk)).reshape(C, -1)
    rbf_s, envm_s, nbr_s, unit_s = _toy_geometry(rng, band, slot_j, rows.shape[1], perm[rows])
    ws_sel = np.asarray(band.win_start)[blocks].astype(np.int32)
    ds, dv = pk.painn_message_subset(*_t(phi, vcat, rbf_s, envm_s, nbr_s, unit_s, dw, db,
                                         ws_sel), dband)
    assert ds.shape == (C, K, 2 * n_blk, F)
    for c in range(C):
        for k in range(K):
            ds_j, dv_j = pp.painn_message_subset(
                jnp.asarray(phi[c, k]), jnp.asarray(vcat[c, k]), jnp.asarray(rbf_s[c]),
                jnp.asarray(envm_s[c][:, None]), jnp.asarray(nbr_s[c][:, None]),
                jnp.asarray(unit_s[c]), jnp.asarray(dw[k]), jnp.asarray(db[k][None]),
                jnp.asarray(ws_sel[c]), **jargs)
            np.testing.assert_allclose(ds[c, k].numpy(), np.asarray(ds_j), **KERNEL_TOL)
            np.testing.assert_allclose(dv[c, k].numpy(), _vcat(dv_j), **KERNEL_TOL)


def test_band_contract_is_asserted(toy_band):
    """A selected edge outside its window is a band that does not cover the
    geometry: the plain versions refuse it."""
    band, slot_j = toy_band
    dband = stage_band(band, "cpu")
    rng = np.random.default_rng(1)
    rbf, envm, nbr, unit = _toy_geometry(rng, band, slot_j, 48,
                                         np.tile(np.asarray(band.perm), (C, 1)))
    s0 = int(band.win_start[0])
    nbr[0, 0] = (s0 + band.window) % 48                  # just past block 0's window
    envm[0, 0] = 1.0
    phi = torch.zeros((C, K, 48 + band.halo, 3 * F))
    with pytest.raises(AssertionError, match="outside its routing window"):
        pk.painn_message_fused_banded(phi, phi, *_t(rbf, envm, nbr, unit),
                                      torch.zeros((K, R, 3 * F)), torch.zeros((K, 3 * F)), dband)


def test_banded_plain_equals_unbanded_plain(tsys):
    """(d) On the 2x2 geometry of one occupancy, the banded plain messages
    (rows 6 and 7, sorted rows, rank neighbours) equal the unbanded ones
    (rows 1 and 2, natural rows, slot neighbours) after un-permuting, and
    the subset message (row 8) equals the full banded rows of its blocks:
    the same sums in the same order, asserted to 1e-6."""
    pot = tsys.potential
    pack_b = pot.static_edge_pack
    pack_u = build_static_edge_pack(tsys.spec, tsys.static_nbr, pot.cfg, "cpu")
    band = pack_b.band
    ss = torch.as_tensor(_random_states(tsys.spec, 2, 1, 0.75))
    alive = tstate.realize_alive(tsys.run.d, ss)
    gb, _ = static_edge_geometry(pack_b, alive)
    gu, _ = static_edge_geometry(pack_u, alive)
    p, ip = band.perm, band.inv_perm
    rw, params, cfg = pot.rw, pot.params, pot.cfg
    from surface_sampling_tpu_torch.models.painn import species_rows, with_halo

    species = species_rows(rw, cfg, tstate.realize_numbers(tsys.run.d, ss), 496)
    ds_b, dv_b = pk.painn_message_l1_banded(with_halo(species[:, p], band.halo, 1), rw["philt"],
                                            *gb[:4], rw["dw2"], rw["db2"], band)
    ds_u, dv_u = pk.painn_message_l1(species, rw["philt"], *gu[:4], rw["dw2"], rw["db2"])
    assert float((ds_b[:, :, ip] - ds_u).abs().max()) <= 1e-6
    assert float((dv_b[:, :, ip] - dv_u).abs().max()) <= 1e-6

    g = torch.Generator().manual_seed(0)
    phi, vcat = (torch.randn((1, 1, 496, 3 * cfg.feat_dim), generator=g) for _ in range(2))
    dw, db = rw["dw"][1], rw["db"][1]
    phi_ext, vcat_ext = with_halo(phi[:, :, p], band.halo, 2), with_halo(vcat[:, :, p], band.halo, 2)
    ds_b, dv_b = pk.painn_message_fused_banded(phi_ext, vcat_ext, *gb[:4], dw, db, band)
    ds_u, dv_u = pk.painn_message_fused(phi, vcat, *gu[:4], dw, db)
    assert float((ds_b[:, :, ip] - ds_u).abs().max()) <= 1e-6
    assert float((dv_b[:, :, ip] - dv_u).abs().max()) <= 1e-6

    blocks = torch.tensor([[5, 40, 5]])
    rows = (blocks[..., None] * band.n_blk + torch.arange(band.n_blk)).reshape(1, -1)
    M = gb[3].shape[-1]
    edges = (rows[..., None] * M + torch.arange(M)).reshape(1, -1)
    ds_s, dv_s = pk.painn_message_subset(
        phi_ext, vcat_ext, gb[0][:, edges[0]], gb[1][:, edges[0]], gb[2][:, edges[0]],
        gb[3][:, :, rows[0]].contiguous(), dw, db, band.win_start[blocks], band)
    assert float((ds_s - ds_b[:, :, rows[0]]).abs().max()) <= 1e-6
    assert float((dv_s - dv_b[:, :, rows[0]]).abs().max()) <= 1e-6


def test_supercell_nn_energy_is_extensive(tsys):
    """(h) Pristine 2x2 with one member: the per-atom network energies sum
    to 4 x the 1x1 cell's (rtol 1e-5), through the banded rigid trunk; and
    the rigid hook went through the band."""
    s1 = srtio3_001_painn(n_models=1, device="cpu")

    def nn_sum(s):
        d = s.run.d
        ss = torch.zeros((1, s.spec.n_sites), dtype=torch.int64)
        out = s.potential.rigid_outputs(tstate.realize_type_idx(d, ss),
                                        tstate.realize_alive(d, ss))
        return float(out["per_atom_energy"].sum())

    assert s1.potential.static_edge_pack.band is None and s1.routing_band is None
    assert tsys.potential.static_edge_pack.band is not None
    np.testing.assert_allclose(nn_sum(tsys), 4 * nn_sum(s1), rtol=1e-5)


def test_relaxed_supercell_raises():
    """(i) Relaxed supercells build: the 2x2 relax table (slack 0.6) is too
    wide for a band, by the JAX package's own rule, so its forces run the
    unbanded rows 2 and 4 and the delta engine, which needs a rigid banded
    system, raises for it; the 3x3 relax table bands, with the window and
    halo the JAX package's builders give it (656 and 648, n_pad 1120)."""
    from surface_sampling_tpu_torch.core.incremental import make_incremental_painn_from_system

    sys22 = srtio3_001_painn(supercell=(2, 2), relax=RelaxConfig(), n_models=1, device="cpu")
    assert sys22.routing_band is None and sys22.potential.band is None
    assert not hasattr(sys22.potential, "rigid_energy")
    with pytest.raises(ValueError, match="rigid banded"):
        make_incremental_painn_from_system(sys22)
    sys33 = srtio3_001_painn(supercell=(3, 3), relax=RelaxConfig(), n_models=1, device="cpu")
    band = sys33.potential.band
    assert (band.n_pad, band.window, band.halo, band.n_blk) == (1120, 656, 648, 8)
    assert sys33.routing_band is not None


def test_banded_messages_are_forward_only(toy_band, monkeypatch):
    """Row 7's backward is the banded message backward (row 9,
    painn_message_bwd_banded, asked for g_dw only when the weights need a
    gradient) and is once-differentiable: grad of grad raises. Row 8, the
    delta engine's subset message, stays forward only, as in the JAX
    package."""
    band, _ = toy_band
    dband = stage_band(band, "cpu")
    calls = []
    bwd = pk.painn_message_bwd_banded

    def recorded(*args, **kwargs):
        calls.append(kwargs["want_dw"])
        return bwd(*args, **kwargs)

    monkeypatch.setattr(pk, "painn_message_bwd_banded", recorded)
    rng = np.random.default_rng(3)
    phi = torch.as_tensor(rng.normal(size=(1, 1, 48 + band.halo, 3 * F)).astype(np.float32))
    phi.requires_grad_(True)
    geom = (torch.ones((1, 48 * M, R)), torch.ones((1, 48 * M)),
            torch.as_tensor(np.asarray(band.win_start)[np.arange(48 * M) // (M * band.n_blk)],
                            dtype=torch.int32)[None], torch.ones((1, 3, 48, M)))
    w = (torch.ones((1, R, 3 * F)), torch.ones((1, 3 * F)))
    ds, dv = pk.painn_message_fused_banded(phi, phi.detach(), *geom, *w, dband)
    (g,) = torch.autograd.grad(ds.sum() + dv.sum(), phi, create_graph=True)
    assert calls == [False] and g.shape == phi.shape and bool(g.abs().sum() > 0)
    with pytest.raises(RuntimeError, match="once-differentiable"):
        torch.autograd.grad(g.sum(), phi)
    # phi reaches this loss by another path too: the missing order must
    # still raise, not drop out of the sum
    with pytest.raises(RuntimeError, match="once-differentiable"):
        torch.autograd.grad(g.sum() + (phi ** 2).sum(), phi)
    with pytest.raises(NotImplementedError, match="forward only"):
        pk.painn_message_subset(phi, phi.detach(), *geom, *w, dband.win_start[None, :6], dband)
