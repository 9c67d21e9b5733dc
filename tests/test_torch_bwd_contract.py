"""The dead-edge contracts of the message backward (rows 4 and 9) and of its
second order (row 5) are harmless.

The CUDA kernels of ``painn_message_bwd`` / ``painn_message_bwd_banded``
compute live edges only (envm != 0) and write g_envm = 0 on the others,
where the plain version (and the JAX package) give sum_{t,f} g_w * wpre.
That value never reaches a position: ``prepare_message_geometry`` builds
envm = envelope(d) * mask, which is zero on those edges through one of its
own factors, so the cotangent is multiplied by zero on its way back. These
tests pin that on the CPU with the plain backward: zeroing g_envm wherever
envm == 0 changes nothing downstream, bitwise.

- The 1x1 relaxed flagship (SrTiO3(001), 3 members, F = 128): the
  cotangents that rbf, envm and unit pass back to the edge displacements,
  distances and positions; and the forces of ``energy_and_forces``.
- A banded relaxed toy (21 Ti on a 42 A line, its relax table banded, a
  2-member PaiNN drawn from a seed): the forces through row 9's plain
  version.

Row 5's kernel computes the slots with envm != 0 or c_envm != 0 only and
writes d_envm = 0 on the others, where the plain version does not: the last
test takes a tiny force-loss training step with the plain row 5 and with its
d_envm zeroed there, and finds every parameter gradient bitwise the same.

Bitwise because both runs do the same operations in the same order on one
torch thread; only the zeros of the dead edges differ in sign at most.

One shell is the exception: just below the cutoff (within cutoff * 2^-12 /
pi, 3.9e-4 A at 5 A) the f32 envelope rounds to exactly 0 while its slope
does not, so there the dropped g_envm does reach the forces, by at most
|g_envm| x 2^-13 * pi / cutoff per pair. A third flagship case puts one
pair 1e-4 A inside the cutoff and holds the force difference within the
port's force tolerance.
"""

import numpy as np
import pytest
import torch

from surface_sampling_tpu_torch.core import state as st
from surface_sampling_tpu_torch.core.energy import RelaxConfig
from surface_sampling_tpu_torch.core.engine import MCMCRun
from surface_sampling_tpu_torch.core.spec import make_spec
from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
from surface_sampling_tpu_torch.models.nn_calculator import make_painn_potential
from surface_sampling_tpu_torch.models.painn import (
    PaiNNConfig,
    _cosine_envelope,
    init_ensemble,
    prepare_message_geometry,
)
from surface_sampling_tpu_torch.ops import painn_kernels as pk
from surface_sampling_tpu_torch.ops.banding import build_routing_band_for_spec
from surface_sampling_tpu_torch.structure import Structure
from surface_sampling_tpu_torch.systems import srtio3_001_painn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the comparison is bitwise, and the CPU's
    index accumulations are ordered only on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flagship():
    return srtio3_001_painn(relax=RelaxConfig(), device="cpu")


def _states(spec, n_chains: int, seed: int, empty: float = 0.75) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    ss = rng.integers(0, spec.n_codes, (n_chains, spec.n_sites))
    return torch.as_tensor(np.where(rng.random(ss.shape) < empty, 0, ss))


def _zero_dead_envm(backward):
    """``backward`` with its g_envm (output 3) zeroed wherever envm == 0,
    as the CUDA kernels write it; ``wrapped.zeroed`` counts the entries it
    changed."""

    def wrapped(*args, **kwargs):
        out = list(backward(*args, **kwargs))
        dead = args[3] == 0
        wrapped.zeroed += int((out[3][dead] != 0).sum())
        out[3] = torch.where(dead, torch.zeros_like(out[3]), out[3])
        return tuple(out)

    wrapped.zeroed = 0
    return wrapped


def _forces(pot, d, ss):
    return pot.energy_and_forces(st.realize_positions(d, ss), st.realize_type_idx(d, ss),
                                 st.realize_alive(d, ss))


def test_dead_edge_g_envm_never_reaches_the_geometry(flagship):
    """The plain row-4 cotangents of the relaxed flagship's geometry (two
    chains, positions displaced 0.05 A, layer-2 weights, seeded features
    and cotangents), passed back through prepare_message_geometry: the
    cotangents of the displacements, distances and positions are bitwise
    the same with g_envm zeroed on the dead edges, which it is not in the
    plain version."""
    pot, d, spec = flagship.potential, flagship.run.d, flagship.spec
    cfg, params = pot.cfg, pot.params
    rng = np.random.default_rng(4)
    ss = _states(spec, 2, seed=4)
    alive = st.realize_alive(d, ss)
    pos0 = st.realize_positions(d, ss)
    pos = (pos0 + torch.as_tensor(rng.normal(0, 0.05, tuple(pos0.shape)),
                                  dtype=pos0.dtype)).requires_grad_(True)
    edges = pot.edges_of(pos, pot.edge_topology(pos0, alive))
    rbf, envm, nbr, unit, n_pad, _ = prepare_message_geometry(cfg, edges)
    K, F = params["atom_embed"].shape[0], cfg.feat_dim
    mp = params["message"][1]
    dw = torch.nn.functional.pad(mp["dist_embed"]["w"], (0, 0, 0, rbf.shape[-1] - cfg.n_rbf))

    def rn(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    C = ss.shape[0]
    g = pk.painn_message_bwd_plain(rn(C, K, n_pad, 3 * F), rn(C, K, n_pad, 3 * F),
                                   rbf.detach(), envm.detach(), nbr, unit.detach(),
                                   dw.contiguous(), mp["dist_embed"]["b"], rn(C, K, n_pad, F),
                                   rn(C, K, n_pad, 3 * F), want_dw=False)
    g_rbf, g_envm, g_unit = g[2], g[3], g[4]
    dead = envm.detach() == 0
    assert bool(dead.any()) and bool((g_envm[dead] != 0).any())
    g_envm_zeroed = torch.where(dead, torch.zeros_like(g_envm), g_envm)

    def back(g_e):
        return torch.autograd.grad((rbf, envm, unit), (edges.disp, edges.r, pos),
                                   (g_rbf, g_e, g_unit), retain_graph=True, allow_unused=True)

    plain, zeroed = back(g_envm), back(g_envm_zeroed)
    for a, b in zip(plain, zeroed):
        assert a is not None and torch.equal(a, b)
    assert float(plain[2].abs().max()) > 0


def test_dead_edge_g_envm_leaves_flagship_forces_unchanged(flagship, monkeypatch):
    """energy_and_forces of the relaxed flagship (3 layers, row 4's plain
    version in each backward) for three seeded states: the forces are
    bitwise the same when row 4 returns g_envm = 0 on dead edges."""
    pot, d = flagship.potential, flagship.run.d
    ss = _states(flagship.spec, 3, seed=5)
    e_plain, f_plain = _forces(pot, d, ss)
    zeroing = _zero_dead_envm(pk.painn_message_bwd)
    monkeypatch.setattr(pk, "painn_message_bwd", zeroing)
    e_zero, f_zero = _forces(pot, d, ss)
    assert zeroing.zeroed > 0
    assert torch.equal(e_plain, e_zero)
    assert torch.equal(f_plain, f_zero)
    assert float(f_plain.abs().max()) > 0.1


# the port's force tolerance, card against the CPU (eV/A)
FORCE_TOL = 1e-3


def test_dead_edge_g_envm_in_the_cutoff_shell_stays_within_force_tolerance(flagship,
                                                                           monkeypatch):
    """The relaxed flagship with one pair moved to 1e-4 A inside the
    cutoff, where the f32 envelope is exactly 0 but its slope is not: the
    forces with g_envm zeroed on dead edges differ from the plain ones on
    that pair's two atoms only, and by less than FORCE_TOL."""
    pot, d = flagship.potential, flagship.run.d
    ss = _states(flagship.spec, 1, seed=6, empty=0.95)
    pos, types, alive = (st.realize_positions(d, ss), st.realize_type_idx(d, ss),
                         st.realize_alive(d, ss))
    rc = pot.cfg.cutoff
    topo = pot.edge_topology(pos, alive)
    edges = pot.edges_of(pos, topo)
    gap = torch.where(edges.mask, (edges.r - (rc - 1e-4)).abs(), torch.inf)
    c, i, k = np.unravel_index(int(gap.argmin()), tuple(gap.shape))
    assert float(gap[c, i, k]) < 0.01
    j = int(edges.nbr_j[c, i, k])
    # disp = pos_i - (pos_j + shift): move j along -disp to d = rc - 1e-4
    r = edges.r[c, i, k].double()
    pos = pos.clone()
    pos[c, j] = (pos[c, j].double()
                 - (rc - 1e-4 - r) * edges.disp[c, i, k].double() / r).to(pos.dtype)
    moved = pot.edges_of(pos, topo)
    shell = moved.mask & (moved.r < rc) & (_cosine_envelope(moved.r, rc) == 0)
    assert sorted(shell.nonzero()[:, 1].tolist()) == sorted([i, j])

    _, f_plain = pot.energy_and_forces(pos, types, alive)
    monkeypatch.setattr(pk, "painn_message_bwd", _zero_dead_envm(pk.painn_message_bwd))
    _, f_zero = pot.energy_and_forces(pos, types, alive)
    diff = (f_plain - f_zero).abs().amax(-1)[c]
    assert set((diff > 0).nonzero()[:, 0].tolist()) <= {i, j}
    assert float(diff.max()) < FORCE_TOL
    assert float(f_plain.abs().max()) > 0.1


TYPES = [22, 8, 38]
TOY_CFG = dict(feat_dim=16, n_rbf=6, cutoff=4.0, n_layers=2, readout_hidden=8, max_neighbors=10,
               excl_vol=True, sigma=1.2, power=8.0)


def _banded_toy():
    """21 Ti 2 A apart on a 42 A line with a site above each; its relax
    table (slack 0.6) bands (n_pad 48, blocks of 16). A 2-member PaiNN
    drawn from a seed, in eV."""
    rng = np.random.default_rng(5)
    xs = np.arange(21) * 2.0 + 0.3
    pos = np.stack([xs, np.full(21, 2.0), np.full(21, 5.0)], axis=1)
    pos[:, 1] += rng.uniform(-0.3, 0.3, 21)
    slab = Structure.from_symbols(["Ti"] * 21, pos, np.diag([42.0, 4.2, 16.0]))
    spec = make_spec(slab, pos + np.array([0.7, 0.0, 1.9]), ["O", "Sr"],
                     potential_numbers=TYPES, cutoff=4.0, surface_name="toy_band")
    cfg = PaiNNConfig(**TOY_CFG)
    nbr = build_static_neighbor_table(spec, cfg.cutoff, relax_slack=0.6)
    params = init_ensemble(torch.Generator().manual_seed(0), cfg, 2)
    pot = make_painn_potential(params, cfg, TYPES, units="eV", static_nbr=nbr, device="cpu",
                               routing_band=build_routing_band_for_spec(spec, nbr))
    return spec, MCMCRun(spec, pot, device="cpu", relax=RelaxConfig(steps=2)), pot


def test_dead_edge_g_envm_leaves_banded_forces_unchanged(monkeypatch):
    """The banded toy's forces through row 9's plain version (the band's
    window addressing, the halo fold) for three states: bitwise the same
    when row 9 returns g_envm = 0 on dead edges."""
    spec, run, pot = _banded_toy()
    assert pot.band is not None
    ss = np.zeros((3, spec.n_sites), np.int64)
    ss[0, 2], ss[1, [3, 9]], ss[2, ::3] = 1, [1, 2], 2
    ss = torch.as_tensor(ss)
    calls = []
    banded = pk.painn_message_bwd_banded

    def counted(*args, **kwargs):
        calls.append(1)
        return banded(*args, **kwargs)

    monkeypatch.setattr(pk, "painn_message_bwd_banded", counted)
    e_plain, f_plain = _forces(pot, run.d, ss)
    assert calls, "the banded backward did not run"
    zeroing = _zero_dead_envm(banded)
    monkeypatch.setattr(pk, "painn_message_bwd_banded", zeroing)
    e_zero, f_zero = _forces(pot, run.d, ss)
    assert zeroing.zeroed > 0
    assert torch.equal(e_plain, e_zero)
    assert torch.equal(f_plain, f_zero)
    assert float(f_plain.abs().max()) > 0


def _zero_dead_denvm(bwd2):
    """Row 5 (``painn_message_bwd2``) with its d_envm (output 3) zeroed on
    the slots where envm and c_envm (arguments 3 and 13) are both zero, as
    its CUDA kernel writes it; ``wrapped.zeroed`` counts the entries it
    changed."""

    def wrapped(*args, **kwargs):
        out = list(bwd2(*args, **kwargs))
        dead = (args[3] == 0) & (args[13] == 0)
        wrapped.zeroed += int((out[3][dead] != 0).sum())
        out[3] = torch.where(dead, torch.zeros_like(out[3]), out[3])
        return tuple(out)

    wrapped.zeroed = 0
    return wrapped


def test_dead_slot_d_envm_leaves_training_gradients_unchanged(monkeypatch):
    """One force-loss training step of a tiny 2-member PaiNN (F = 16, drawn
    from a seed) on two random periodic frames, row 5's plain version in
    the outer backward: every parameter gradient is bitwise the same when
    row 5 returns d_envm = 0 on the slots where envm and c_envm are both
    zero. That value flows only towards the positions, and training takes
    its gradient over the parameters alone."""
    from surface_sampling_tpu_torch.models import train as tr
    from surface_sampling_tpu_torch.models.painn import tree_leaves, tree_map

    cfg = PaiNNConfig(feat_dim=16, n_rbf=8, cutoff=4.0, n_layers=2, readout_hidden=8,
                      max_neighbors=12)
    params = init_ensemble(torch.Generator().manual_seed(7), cfg, 2)
    rng = np.random.default_rng(7)
    frames, energies, forces = [], [], []
    for n, box in ((7, 6.0), (9, 7.0)):
        numbers = np.asarray(([8, 22, 38] * n)[:n], np.int32)
        frames.append(Structure(numbers, rng.uniform(0, box, (n, 3)), np.eye(3) * box))
        energies.append(float(rng.normal()))
        forces.append(rng.normal(size=(n, 3)))
    batch = tr.batch_to_device(tr.pad_structures(frames, energies, forces, cfg.cutoff), "cpu")
    loss_fn = tr.make_loss_fn(cfg, tr.TrainConfig())

    def grads():
        leaves = [x.detach().clone().requires_grad_(True) for x in tree_leaves(params)]
        it = iter(leaves)
        loss = loss_fn(tree_map(lambda _: next(it), params), batch)
        return torch.autograd.grad(loss.sum(), leaves)

    plain = grads()
    zeroing = _zero_dead_denvm(pk.painn_message_bwd2)
    monkeypatch.setattr(pk, "painn_message_bwd2", zeroing)
    zeroed = grads()
    assert zeroing.zeroed > 0
    assert len(plain) == len(zeroed)
    assert all(torch.equal(a, b) for a, b in zip(plain, zeroed))
    assert max(float(g.abs().max()) for g in plain) > 0
