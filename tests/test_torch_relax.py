"""Forces and relaxation of the port (slice 2) against the JAX package on
the CPU.

Inputs are made from a seed with numpy and handed to both packages. The
message backward runs the JAX Pallas kernel in interpret mode with f32
routing; the JAX flagship system runs its CPU gather path. Tolerances:
1e-4 on the backward cotangents (the same f32 terms summed in another
order, as the JAX package holds its own kernel to its reference),
1e-3 eV and 1e-3 eV/A on energies and forces of a ~460 eV system, and
5e-3 eV on relaxed energies, the tolerance the JAX package holds its own
two topology modes to: FIRE's 8-20 steps amplify summation-order noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu import systems as jsystems
from surface_sampling_tpu.core import relax as jrelax
from surface_sampling_tpu.core import state as jstate
from surface_sampling_tpu.core.energy import RelaxConfig as JRelaxConfig
from surface_sampling_tpu.core.static_neighbors import (
    build_static_neighbor_table as j_build_table,
)
from surface_sampling_tpu.ops import neighbors as jnb
from surface_sampling_tpu.ops import pallas_painn as pp
from surface_sampling_tpu_torch.core import relax as trelax
from surface_sampling_tpu_torch.core import state as tstate
from surface_sampling_tpu_torch.core.energy import RelaxConfig
from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
from surface_sampling_tpu_torch.ops import neighbors as tnb
from surface_sampling_tpu_torch.ops import painn_kernels as pk
from surface_sampling_tpu_torch.systems import srtio3_001_painn

BWD_TOL = dict(rtol=1e-4, atol=1e-4)
E_TOL = 1e-3          # eV and eV/A, port vs JAX, unrelaxed
E_TOL_RELAXED = 5e-3  # eV, port vs JAX after FIRE


@pytest.fixture(scope="module")
def tsys():
    return srtio3_001_painn(device="cpu")


def _entry_inputs(n_sites):
    """The compile entry point's inputs: one adsorbate, code 1 on site 0."""
    ss = np.zeros((1, n_sites), np.int64)
    ss[0, 0] = 1
    return ss


# ----------------------------------------------------------------------
# (a) the message backward
# ----------------------------------------------------------------------
C, K, N_PAD, F, M, R = 2, 2, 32, 16, 8, 8
E = N_PAD * M
BWD_NAMES = ("g_phi", "g_vcat", "g_rbf", "g_envm", "g_unit", "g_dw", "g_db")


def _bwd_inputs(seed):
    rng = np.random.default_rng(seed)

    def rn(*shape):
        return rng.normal(size=shape).astype(np.float32)

    envm = np.abs(rn(C, E))
    envm[rng.random((C, E)) < 0.33] = 0.0
    return dict(phi=rn(C, K, N_PAD, 3 * F), vcat=rn(C, K, N_PAD, 3 * F), rbf=rn(C, E, R),
                envm=envm, nbr=rng.integers(0, N_PAD, (C, E)).astype(np.int32),
                unit=rn(C, 3, N_PAD, M), dw=rn(K, R, 3 * F), db=rn(K, 3 * F),
                gds=rn(C, K, N_PAD, F), gdv=rn(C, K, N_PAD, 3 * F))


def _jax_bwd(x):
    """Stack per-(chain, member) JAX calls into the port's batched
    layout: edge cotangents summed over members, weight cotangents over
    chains."""
    out = {n: [] for n in BWD_NAMES}
    for c in range(C):
        per_k = []
        for k in range(K):
            gdv3 = x["gdv"][c, k].reshape(N_PAD, 3, F).transpose(1, 0, 2)
            per_k.append([np.asarray(a) for a in pp._message_bwd_pallas(
                jnp.asarray(x["phi"][c, k]), jnp.asarray(x["vcat"][c, k]),
                jnp.asarray(x["rbf"][c]), jnp.asarray(x["envm"][c][:, None]),
                jnp.asarray(x["nbr"][c][:, None]), jnp.asarray(x["unit"][c]),
                jnp.asarray(x["dw"][k]), jnp.asarray(x["db"][k][None]),
                jnp.asarray(x["gds"][c, k]), jnp.asarray(gdv3), n_blk=8, routing="f32")])
        out["g_phi"].append([p[0] for p in per_k])
        out["g_vcat"].append([p[1] for p in per_k])
        out["g_rbf"].append(sum(p[2] for p in per_k))
        out["g_envm"].append(sum(p[3][:, 0] for p in per_k))
        out["g_unit"].append(sum(p[4] for p in per_k))
        out["g_dw"].append([p[5] for p in per_k])
        out["g_db"].append([p[6][0] for p in per_k])
    out = {n: np.asarray(v) for n, v in out.items()}
    out["g_dw"] = out["g_dw"].sum(0)
    out["g_db"] = out["g_db"].sum(0)
    return out


@pytest.mark.parametrize("route", ["plain", "autograd"])
def test_message_backward_matches_pallas(route):
    """painn_message_bwd_plain, and the autograd backward through the
    plain forward, against JAX _message_bwd_pallas (interpret, f32)."""
    x = _bwd_inputs(4)
    want = _jax_bwd(x)
    t = {n: torch.as_tensor(v) for n, v in x.items()}
    fwd_args = ("phi", "vcat", "rbf", "envm", "unit", "dw", "db")
    if route == "plain":
        got = pk.painn_message_bwd_plain(*(t[n] for n in ("phi", "vcat", "rbf", "envm", "nbr",
                                                          "unit", "dw", "db", "gds", "gdv")))
    else:
        leaves = {n: t[n].clone().requires_grad_(True) for n in fwd_args}
        out = pk.painn_message_fused_plain(
            leaves["phi"], leaves["vcat"], leaves["rbf"], leaves["envm"], t["nbr"],
            leaves["unit"], leaves["dw"], leaves["db"])
        got = torch.autograd.grad(out, [leaves[n] for n in fwd_args], (t["gds"], t["gdv"]))
    for name, g in zip(BWD_NAMES, got):
        np.testing.assert_allclose(g.detach().numpy(), want[name], err_msg=name, **BWD_TOL)


def test_fused_backward_is_the_wrapper_and_once_differentiable():
    """The backward of painn_message_fused goes through painn_message_bwd
    (the plain version for CPU tensors: no launch counted) and asks for g_dw
    only when dw or db requires grad. The backward is itself differentiable
    once (its backward is painn_message_bwd2, here its plain version:
    grad-of-grad equals the plain forward's), and a third order raises."""
    x = {n: torch.as_tensor(v) for n, v in _bwd_inputs(5).items()}
    phi = x["phi"].clone().requires_grad_(True)
    rbf = x["rbf"].clone().requires_grad_(True)
    args = (phi, x["vcat"], rbf, x["envm"], x["nbr"], x["unit"], x["dw"], x["db"])
    ds, dv = pk.painn_message_fused(*args)
    g_phi, g_rbf = torch.autograd.grad((ds, dv), (phi, rbf), (x["gds"], x["gdv"]))
    want = pk.painn_message_bwd_plain(*(x[n] for n in ("phi", "vcat", "rbf", "envm", "nbr",
                                                       "unit", "dw", "db", "gds", "gdv")))
    torch.testing.assert_close(g_phi, want[0], rtol=0, atol=0)
    torch.testing.assert_close(g_rbf, want[2], rtol=0, atol=0)
    assert pk.painn_message_bwd.launches == 0
    ds, _ = pk.painn_message_fused(*args)
    (g,) = torch.autograd.grad(ds.sum(), phi, create_graph=True)
    (gg,) = torch.autograd.grad(g.sum(), rbf, create_graph=True)
    ds_ref, _ = pk.painn_message_fused_plain(*args)
    (g_ref,) = torch.autograd.grad(ds_ref.sum(), phi, create_graph=True)
    (gg_ref,) = torch.autograd.grad(g_ref.sum(), rbf)
    torch.testing.assert_close(gg, gg_ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(gg.sum(), phi)
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(gg.sum() + (phi ** 2).sum(), phi)


# ----------------------------------------------------------------------
# (b) the dynamic edge path over the relax table
# ----------------------------------------------------------------------
def test_table_edges_match_jax(tsys):
    """select_edge_topology / edges_from_topology / neighbor_list_from_table
    on the relax table (slack 0.6): the same edges in the same order, the
    same shifts and overflow flags, and geometry at displaced positions;
    the reverse table lists exactly the selected edges."""
    spec = tsys.spec
    jt = j_build_table(spec, 5.0, relax_slack=0.6)
    tt = build_static_neighbor_table(spec, 5.0, relax_slack=0.6)
    for a, b in zip(tt[:3], jt[:3]):
        np.testing.assert_array_equal(a, b)
    table = tnb.stage_candidate_table(tt, 5.0, 64, "cpu")
    rng = np.random.default_rng(7)
    ss = rng.integers(0, spec.n_codes, (3, spec.n_sites))
    ss = np.where(rng.random(ss.shape) < 0.8, 0, ss)
    ss = np.concatenate([ss, np.full((1, spec.n_sites), 3)])      # overflows
    d = tsys.run.d
    tss = torch.as_tensor(ss)
    pos = tstate.realize_positions(d, tss)
    alive = tstate.realize_alive(d, tss)
    pos2 = pos + torch.as_tensor(rng.normal(0, 0.05, pos.shape), dtype=pos.dtype)
    topo = tnb.select_edge_topology(pos, alive, table)
    moved = tnb.edges_from_topology(pos2, topo, 5.0)
    fresh = tnb.neighbor_list_from_table(pos2, alive, table)
    args = tuple(jnp.asarray(a) for a in (tt.slot_j, np.asarray(tt.shift, np.float32), tt.valid))
    assert topo.overflow.tolist() == [False, False, False, True]
    for c in range(len(ss)):
        jp, ja, jp2 = (jnp.asarray(a[c].numpy()) for a in (pos, alive, pos2))
        jtopo = jnb.select_edge_topology(jp, ja, *args, 5.0, 64)
        for name, a, b in zip(("nbr_j", "shift", "mask"), topo[:3], jtopo[:3]):
            np.testing.assert_array_equal(a[c].numpy(), np.asarray(b), err_msg=name)
        assert bool(topo.overflow[c]) == bool(jtopo[3])
        for got, want in ((moved, jnb.edges_from_topology(jp2, jtopo, 5.0)),
                          (fresh, jnb.neighbor_list_from_table(jp2, ja, *args, 5.0, 64))):
            np.testing.assert_array_equal(got.nbr_j[c].numpy(), np.asarray(want[2]))
            np.testing.assert_array_equal(got.mask[c].numpy(), np.asarray(want[3]))
            assert bool(got.overflow[c]) == bool(want[4])
            np.testing.assert_allclose(got.disp[c].numpy(), np.asarray(want[0]), atol=1e-5)
            np.testing.assert_allclose(got.r[c].numpy(), np.asarray(want[1]), atol=1e-5)
        rev = topo.rev[c].long()
        listed = np.sort(rev[rev >= 0].numpy())
        sel = np.flatnonzero(topo.mask[c].numpy().reshape(-1))
        np.testing.assert_array_equal(listed, sel)
        M_ = topo.nbr_j.shape[-1]
        for j in (0, 17, 80):
            ids = rev[j][rev[j] >= 0].numpy()
            assert (np.diff(ids) > 0).all()
            assert (topo.nbr_j[c].reshape(-1)[ids] == j).all() and len(ids) == int(
                ((topo.nbr_j[c] == j) & topo.mask[c]).sum())
            assert (ids // M_ < spec.n_pristine + spec.n_sites * spec.group_size).all()


def test_position_gather_backward_is_exact():
    """The reverse-table backward of the neighbor gather equals autograd's
    scatter-add."""
    rng = np.random.default_rng(8)
    Cc, N, Mm = 2, 20, 6
    nbr = torch.as_tensor(rng.integers(0, N, (Cc, N, Mm)))
    mask = torch.as_tensor(rng.random((Cc, N, Mm)) < 0.7)
    n_pad = tnb.padded_rows(N)
    pad = (0, 0, 0, n_pad - N)
    rev = tnb.reverse_table(torch.nn.functional.pad(nbr, pad).reshape(Cc, -1),
                            torch.nn.functional.pad(mask, pad).reshape(Cc, -1), n_pad)
    pos = torch.as_tensor(rng.normal(size=(Cc, N, 3)) * 3, dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(Cc, N, Mm, 3)), dtype=torch.float32)

    def loss(gather):
        p = pos.clone().requires_grad_(True)
        disp = p[:, :, None] - gather(p)
        disp = torch.where(mask[..., None], disp, torch.zeros_like(disp))
        return torch.autograd.grad((disp * w).sum(), p)[0]

    got = loss(lambda p: tnb._GatherRows.apply(p, nbr, rev))
    want = loss(lambda p: p[torch.arange(Cc)[:, None, None], nbr])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# (c) FIRE
# ----------------------------------------------------------------------
def _lj_torch(pos):
    diff = pos[:, :, None, :] - pos[:, None, :, :]
    n = pos.shape[1]
    iu = torch.triu_indices(n, n, 1)
    r2 = (diff * diff).sum(-1)[:, iu[0], iu[1]]
    inv6 = 1.0 / r2 ** 3
    return (4.0 * (inv6 * inv6 - inv6)).sum(-1)


def _lj_jax(pos):
    diff = pos[:, None, :] - pos[None, :, :]
    n = pos.shape[0]
    iu = np.triu_indices(n, 1)
    r2 = jnp.sum(diff * diff, axis=-1)[iu]
    inv6 = 1.0 / r2 ** 3
    return jnp.sum(4.0 * (inv6 * inv6 - inv6))


def test_fire_matches_jax_on_lennard_jones():
    """Two 5-atom Lennard-Jones clusters, one atom frozen: chain 0 starts
    from the ideal bipyramid and converges early (15 steps), chain 1 is
    perturbed and runs to the step limit.
    Positions, energies and per-chain step counts match the JAX FIRE."""
    rng = np.random.default_rng(9)
    a = 2.0 ** (1.0 / 6.0)
    base = np.array([[0, 0, 0], [a, 0, 0], [a / 2, a * np.sqrt(3) / 2, 0],
                     [a / 2, a * np.sqrt(3) / 6, a * np.sqrt(2 / 3)],
                     [a / 2, a * np.sqrt(3) / 6, -a * np.sqrt(2 / 3)]])
    pos0 = np.stack([base, base + rng.normal(0, 0.03, base.shape)]).astype(np.float32)
    free = np.ones((2, 5), bool)
    free[:, 0] = False
    cfg = trelax.FireConfig(steps=40, fmax=0.02)
    got = trelax.fire_relax(_lj_torch, torch.as_tensor(pos0), torch.as_tensor(free), cfg)
    jcfg = jrelax.FireConfig(steps=40, fmax=0.02)
    want = [jrelax.fire_relax(_lj_jax, jnp.asarray(pos0[c]), jnp.asarray(free[c]), jcfg)
            for c in range(2)]
    steps = [int(w.n_steps) for w in want]
    assert steps[0] < 40 and steps[1] == 40
    assert got.n_steps.tolist() == steps
    assert got.converged.tolist() == [bool(w.converged) for w in want]
    for c in range(2):
        np.testing.assert_allclose(got.positions[c].numpy(), np.asarray(want[c].positions),
                                   atol=2e-5)
        np.testing.assert_allclose(float(got.energy[c]), float(want[c].energy), atol=1e-4)
        np.testing.assert_array_equal(got.positions[c, 0].numpy(), pos0[c, 0])


def test_fire_guards_restore_nan_and_clamp_oob():
    """_finish: a NaN energy restores the start geometry and clamps to the
    bound; a force above MAX_FORCE_THRESHOLD is out of bounds."""
    pos0 = torch.zeros((2, 3, 3))
    pos = torch.ones((2, 3, 3))
    e = torch.tensor([float("nan"), -5.0])
    mf = torch.tensor([0.0, 2 * trelax.MAX_FORCE_THRESHOLD])
    res = trelax._finish(pos, e, mf, pos0, torch.tensor([3, 4]), trelax.FireConfig())
    bound = trelax.energy_threshold(3)
    assert res.oob.tolist() == [True, True]
    assert res.energy.tolist() == [bound, bound]
    assert torch.equal(res.positions[0], pos0[0]) and torch.equal(res.positions[1], pos[1])


# ----------------------------------------------------------------------
# (d) forces, (e) relaxed anchor, (f) relaxed energies
# ----------------------------------------------------------------------
def test_energy_and_forces_match_jax_at_entry_inputs(tsys):
    """energy_and_forces at the compile entry point's inputs against JAX
    pot.energy_and_forces (its CPU gather path): 1e-3 eV and 1e-3 eV/A;
    dead slots get zero force."""
    jsys = jsystems.srtio3_001_painn()
    jd = jsys.run.d
    ss = _entry_inputs(tsys.spec.n_sites)
    js = jnp.asarray(ss[0], jnp.int32)
    jpos = jstate.realize_positions(jd, js)
    je, jf = jax.jit(lambda p: jsys.potential.energy_and_forces(
        p, jstate.realize_type_idx(jd, js), jstate.realize_alive(jd, js), jd.shifts))(jpos)
    td, tss = tsys.run.d, torch.as_tensor(ss)
    alive = tstate.realize_alive(td, tss)
    te, tf = tsys.potential.energy_and_forces(
        tstate.realize_positions(td, tss), tstate.realize_type_idx(td, tss), alive)
    assert abs(float(te[0]) - float(je)) <= E_TOL
    np.testing.assert_allclose(tf[0].numpy(), np.asarray(jf), rtol=0, atol=E_TOL)
    assert float(tf[0].abs().max()) > 1.0
    assert not tf[~alive].any()


def test_relaxed_pristine_anchor():
    """FIRE-relaxed pristine surface energy (20 steps, fmax 0.01, three
    members): the tutorial's printed 12.471 eV."""
    sys_ = srtio3_001_painn(relax=RelaxConfig(), device="cpu")
    out = sys_.run.state_energy_fn(torch.zeros((1, sys_.spec.n_sites), dtype=torch.int64))
    assert not bool(out.oob[0])
    assert abs(float(out.surface_energy[0]) - 12.471) < 0.02


@pytest.mark.parametrize("refresh", ["once", "every_step"])
def test_relaxed_energies_match_jax(refresh):
    """One member, 8 FIRE steps, two states, both topology modes: relaxed
    potential and surface energies within 5e-3 eV of JAX, relaxed
    positions within 1e-3 A, the frozen bulk unmoved."""
    kw = dict(relax=JRelaxConfig(steps=8, refresh_edges=refresh), n_models=1)
    jsys = jsystems.srtio3_001_painn(**kw)
    tsys1 = srtio3_001_painn(relax=RelaxConfig(steps=8, refresh_edges=refresh), n_models=1,
                             device="cpu")
    ss = np.zeros((2, tsys1.spec.n_sites), np.int64)
    ss[0, 0] = 1
    ss[1, [3, 10]] = [2, 3]
    want = jax.jit(jax.vmap(jsys.run.state_energy_fn))(jnp.asarray(ss, jnp.int32))
    got = tsys1.run.state_energy_fn(torch.as_tensor(ss))
    assert not got.oob.any() and not np.asarray(want.oob).any()
    for a, b in ((got.potential_energy, want.potential_energy),
                 (got.surface_energy, want.surface_energy)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=E_TOL_RELAXED)
    np.testing.assert_allclose(got.positions.numpy(), np.asarray(want.positions), atol=1e-3)
    ideal = tstate.realize_positions(tsys1.run.d, torch.as_tensor(ss))
    frozen = torch.as_tensor(tsys1.spec.frozen_pristine)
    assert torch.equal(got.positions[:, :frozen.shape[0]][:, frozen],
                       ideal[:, :frozen.shape[0]][:, frozen])
    assert (got.positions - ideal).abs().max() > 1e-3


def test_free_mask_matches_jax(tsys):
    rng = np.random.default_rng(10)
    ss = np.where(rng.random((3, tsys.spec.n_sites)) < 0.6, 0,
                  rng.integers(0, tsys.spec.n_codes, (3, tsys.spec.n_sites)))
    jsys_d = jstate.device_spec(tsys.spec)
    want = np.stack([np.asarray(jstate.realize_free_mask(jsys_d, jnp.asarray(s, jnp.int32)))
                     for s in ss])
    got = tstate.realize_free_mask(tsys.run.d, torch.as_tensor(ss))
    np.testing.assert_array_equal(got.numpy(), want)


def test_relax_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(RelaxConfig)] == [
        f.name for f in dataclasses.fields(JRelaxConfig)]
    assert RelaxConfig() == RelaxConfig(**dataclasses.asdict(JRelaxConfig()))
