"""The port's dynamic-geometry delta (core/incremental.py,
``static_geometry="off"`` and code-dependent ``"auto"``) against the JAX
package's on the CPU.

The toys are tests/test_incremental.py's banded line (42 slots, blocks of 16,
two layers, two members), scored with the edges rebuilt over the candidate
table at every step, and the same line with a two-atom adsorbate (OH), whose
slot geometry is code-dependent, so that "auto" takes the dynamic path in
both packages. The JAX side runs under jit (its Pallas kernels in interpret
mode, f32 routing). Energies are held to E_TOL of
tests/test_torch_incremental.py (rtol 1e-5, atol 1e-4, the JAX package's rule
for delta vs full evaluation); replayed MC steps must take the same
decisions; the port's delta must equal its own full evaluation bitwise in
every layer's s and vcat (the rows are recomputed by the same functions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_incremental import CFG, E_TOL, N_MODELS, TYPES, _moves, _toy

from surface_sampling_tpu.core import make_spec as j_make_spec
from surface_sampling_tpu.core.incremental import (
    make_incremental_painn as j_make_incremental_painn,
)
from surface_sampling_tpu.core.incremental import (
    make_incremental_semigrand_step as j_make_incremental_step,
)
from surface_sampling_tpu.core.state import device_spec as j_device_spec
from surface_sampling_tpu.core.static_neighbors import (
    build_static_neighbor_table as j_build_table,
)
from surface_sampling_tpu.models.painn import PaiNNConfig as JPaiNNConfig
from surface_sampling_tpu.models.train import init_ensemble
from surface_sampling_tpu.ops.banding import build_routing_band_for_spec as j_build_band
from surface_sampling_tpu.structure import Structure as JStructure
from surface_sampling_tpu_torch.core.incremental import (
    make_incremental_painn,
    make_incremental_semigrand_step,
)
from surface_sampling_tpu_torch.core.spec import make_spec
from surface_sampling_tpu_torch.core.state import device_spec
from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
from surface_sampling_tpu_torch.models.nn_calculator import make_painn_potential
from surface_sampling_tpu_torch.models.painn import PaiNNConfig
from surface_sampling_tpu_torch.models.weights import from_jax_params
from surface_sampling_tpu_torch.ops.banding import build_routing_band_for_spec
from surface_sampling_tpu_torch.structure import Structure

TYPES_OH = [22, 8, 1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one torch thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_oh(structure_cls, spec_fn):
    """The line toy with O and OH adsorbates: mixed-offset groups make the
    slot geometry code-dependent."""
    rng = np.random.default_rng(5)
    xs = np.arange(21) * 2.0 + 0.3
    pos = np.stack([xs, np.full(21, 2.0), np.full(21, 5.0)], axis=1)
    pos[:, 1] += rng.uniform(-0.3, 0.3, 21)
    slab = structure_cls.from_symbols(["Ti"] * 21, pos, np.diag([42.0, 4.2, 16.0]))
    return spec_fn(slab, pos + np.array([0.7, 0.0, 1.9]), ["O", "HO"],
                   potential_numbers=TYPES_OH, cutoff=4.0, surface_name="toy_band_oh")


def _pair(toy_fn, types, static_geometry, port_spec_arg):
    """(JAX engine, port engine, spec) of one toy; the port's potential is
    built with the spec (static pack) or without it (edges over the table)."""
    jcfg = JPaiNNConfig(**CFG, pallas_routing="f32")
    jspec = toy_fn(JStructure, j_make_spec)
    jnbr = j_build_table(jspec, jcfg.cutoff, relax_slack=0.1)
    params = init_ensemble(jax.random.PRNGKey(0), jcfg, N_MODELS)
    jeng = j_make_incremental_painn(jspec, j_device_spec(jspec), params, jcfg, jnbr,
                                    j_build_band(jspec, jnbr), types, units="kcal/mol",
                                    static_geometry=static_geometry)
    spec = toy_fn(Structure, make_spec)
    nbr = build_static_neighbor_table(spec, CFG["cutoff"], relax_slack=0.1)
    band = build_routing_band_for_spec(spec, nbr)
    pot = make_painn_potential(from_jax_params(jax.tree.map(np.asarray, params), "cpu"),
                               PaiNNConfig(**CFG), types, units="kcal/mol", static_nbr=nbr,
                               spec=spec if port_spec_arg else None, device="cpu",
                               routing_band=band)
    d = device_spec(spec, torch.device("cpu"))
    eng = make_incremental_painn(spec, d, pot, nbr, band, static_geometry=static_geometry)
    return jeng, eng, spec


@pytest.fixture(scope="module")
def off():
    return _pair(_toy, TYPES, "off", True)


@pytest.fixture(scope="module")
def oh():
    return _pair(_toy_oh, TYPES_OH, "auto", False)


@pytest.mark.parametrize("system", ["off", "oh"])
def test_energy_full_and_delta_sequence_match_jax(off, oh, system):
    """energy_full, then one- and two-site deltas along tests/
    test_torch_incremental.py's move sequence, each from the previous
    caches, against JAX's dynamic path; each delta's layer caches equal
    bitwise to the port's own full evaluation of the trial state. Both
    packages take the dynamic path (empty phi caches)."""
    jeng, eng, spec = off if system == "off" else oh
    ss0 = np.random.default_rng(1).integers(0, spec.n_codes, spec.n_sites)
    jfull, jdelta = jax.jit(jeng.energy_full), jax.jit(jeng.delta)
    jse, jc, _ = jfull(jnp.asarray(ss0, jnp.int32))
    assert jc.phi.shape[-2] == 0
    se, caches, _ = eng.energy_full(torch.as_tensor(ss0)[None])
    assert caches.phi == () and len(caches.s) == 2
    np.testing.assert_allclose(float(se[0]), float(jse), **E_TOL)
    for trial, sites in _moves(spec, 1)[1]:
        sites2 = jnp.asarray(list(sites) * (2 // len(sites)), jnp.int32)
        jse, jc, _ = jdelta(jc, jnp.asarray(trial, jnp.int32), sites2)
        se, caches, oob = eng.delta(caches, torch.as_tensor(trial)[None],
                                    torch.as_tensor(sites)[None])
        np.testing.assert_allclose(float(se[0]), float(jse), **E_TOL, err_msg=str(sites))
        fresh, fc, _ = eng.energy_full(torch.as_tensor(trial)[None])
        for a, b in zip(caches.s + caches.vcat, fc.s + fc.vcat):
            assert torch.equal(a, b), sites
        # the readout's rows to 1e-6: the CPU's BLAS rounds a product's rows
        # by the product's row count (on the card the delta is bitwise its
        # full evaluation: chip_smoke.py's [inc-dynamic], the cuda tests)
        torch.testing.assert_close(caches.e_atom, fc.e_atom, rtol=1e-6, atol=0)
        torch.testing.assert_close(se, fresh, rtol=1e-6, atol=0)


def test_step_replays_jax_draws(off):
    """The semigrand step on the dynamic engine fed the JAX dynamic step's
    own draws: the same decisions and occupancies, energies within E_TOL."""
    jeng, eng, spec = off
    n_chains, n_steps, temp = 4, 6, 0.01
    S, n_codes = spec.n_sites, spec.n_codes
    jstep = jax.jit(jax.vmap(j_make_incremental_step(jeng), in_axes=(0, None)))

    def draws(key):
        _, k_site, k_code, k_acc = jax.random.split(key, 4)
        return (jax.random.randint(k_site, (), 0, S),
                jax.random.randint(k_code, (), 0, n_codes - 1),
                jax.random.uniform(k_acc, dtype=jnp.float32))

    ss0 = np.zeros((n_chains, S), np.int64)
    ss0[:, 2], ss0[:, 7] = 1, 2
    keys = jax.random.split(jax.random.PRNGKey(9), n_chains)
    jst = jax.vmap(jeng.init_state)(keys, jnp.asarray(ss0, jnp.int32))
    tst = eng.init_state(torch.as_tensor(ss0))
    np.testing.assert_allclose(tst.energy.numpy(), np.asarray(jst.energy), **E_TOL)
    step = make_incremental_semigrand_step(eng)
    accepted = []
    for _ in range(n_steps):
        site, u_code, u_acc = (torch.as_tensor(np.array(x)) for x in jax.vmap(draws)(jst.key))
        jst, jinfo = jstep(jst, jnp.asarray(temp, jnp.float32))
        tst, tinfo = step(tst, temp, site.long(), u_code.long(), u_acc)
        np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(jinfo.accepted))
        np.testing.assert_array_equal(tst.site_state.numpy(), np.asarray(jst.site_state))
        np.testing.assert_allclose(tst.energy.numpy(), np.asarray(jst.energy), **E_TOL)
        accepted.append(tinfo.accepted.numpy())
    accepted = np.stack(accepted)
    assert accepted.any() and not accepted.all()


def test_dynamic_equals_static_engine(off):
    """On a code-independent geometry the dynamic and the static delta
    score the same states: the start energies and a move sequence's within
    E_TOL (the static payload is built in float64 on the host, the dynamic
    edges in float32)."""
    _, dyn, spec = off
    _, sta, _ = _pair(_toy, TYPES, "auto", True)
    ss0 = torch.as_tensor(np.random.default_rng(2).integers(0, spec.n_codes, (3, spec.n_sites)))
    e_d, c_d, _ = dyn.energy_full(ss0)
    e_s, c_s, _ = sta.energy_full(ss0)
    assert c_d.phi == () and len(c_s.phi) == 2
    np.testing.assert_allclose(e_d.numpy(), e_s.numpy(), **E_TOL)
    site = torch.tensor([[4], [11], [19]])
    trial = ss0.clone()
    trial[torch.arange(3), site[:, 0]] = (trial[torch.arange(3), site[:, 0]] + 1) % spec.n_codes
    np.testing.assert_allclose(dyn.delta(c_d, trial, site)[0].numpy(),
                               sta.delta(c_s, trial, site)[0].numpy(), **E_TOL)
