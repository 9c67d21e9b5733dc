"""The facts the EAM pair-pass kernel (row 13) relies on, shown on the plain
version on the CPU.

``csrc/eam_rho_ep.cu`` evaluates its two Chebyshev series on live pairs
only: it tests j >= 0 and the two ends' aliveness before it reads a pair's
shift or the neighbour's position, skips dead centres without reading
their position, and sums each centre's terms in one order fixed by its own
live pairs. That is the same function only if

- a dead pair contributes nothing, whatever it holds: the plain version
  gives bitwise the same rho and ep when the shifts of the padding pairs
  (kernel_j == -1) and the positions of the dead slots are replaced by
  random finite values;
- and the JAX package's Pallas kernel (``make_pallas_eam_energy``'s
  ``batched_rho_ep``, interpret mode) agrees with the plain version with
  the dead values replaced, at the tolerance of ``tests/test_torch_eam.py``
  (rtol = atol = 1e-5).

The card tests (``tests/test_torch_cuda_kernels.py``) hold the kernel itself
to these on the GPU, with NaN in place of the random values. Cu(100) 2x2x2
(N = 32, M = 96) and Au(110) 2x2 (N = 24, M = 40), 70 seeded chains each,
on one torch thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.core.static_neighbors import (
    build_static_neighbor_table as j_build_table,
)
from surface_sampling_tpu.ops.pallas_eam import make_pallas_eam_energy
from surface_sampling_tpu.potentials import eam as jeam
from surface_sampling_tpu.systems import au110_eam as j_au110
from surface_sampling_tpu.systems import cu100_eam as j_cu100
from surface_sampling_tpu_torch.core.state import realize_alive, realize_positions
from surface_sampling_tpu_torch.ops import eam_kernels as ek
from surface_sampling_tpu_torch.potentials.eam import builtin_eam
from surface_sampling_tpu_torch.systems import au110_eam, cu100_eam

N_CHAINS = 70
TOL = dict(rtol=1e-5, atol=1e-5)
SYSTEMS = {"cu": (j_cu100, cu100_eam, "Cu_u3"), "au": (j_au110, au110_eam, "Au_u3")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the comparisons are bitwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_rho_ep(batched_energy):
    """The Pallas kernel's own ``batched_rho_ep``, a free variable of the
    ``batched_energy`` closure that ``make_pallas_eam_energy`` returns."""
    cells = dict(zip(batched_energy.__code__.co_freevars, batched_energy.__closure__))
    return cells["batched_rho_ep"].cell_contents


@pytest.fixture(scope="module", params=sorted(SYSTEMS))
def case(request):
    """The JAX kernel (interpret mode) and the port's staged operands over
    the same static table (0.05 A of slack), seeded occupancies (a site
    filled with probability 0.3), and the inputs with the dead values
    replaced by random finite ones."""
    j_system, system, name = SYSTEMS[request.param]
    jsys = j_system()
    nbr = j_build_table(jsys.spec, jeam.builtin_eam(name).cutoff, relax_slack=0.05)
    _, batched = make_pallas_eam_energy(jeam.builtin_eam(name), nbr, interpret=True)
    pot = ek.make_eam_kernel_potential(builtin_eam(name), nbr, device="cpu")
    tsys = system(device="cpu")
    d = tsys.run.d
    rng = np.random.default_rng(41)
    ss = torch.as_tensor((rng.random((N_CHAINS, tsys.spec.n_sites)) < 0.3).astype(np.int64))
    pos, alive_f = realize_positions(d, ss), realize_alive(d, ss).float()
    pairs = pot.pairs
    pad, dead = pairs.kernel_j < 0, alive_f == 0
    assert bool(pad.any()) and bool(dead.any())
    pairs_d = pairs._replace(shift=torch.where(
        pad[..., None], torch.as_tensor(10 * rng.normal(size=pairs.shift.shape),
                                        dtype=torch.float32), pairs.shift))
    pos_d = torch.where(dead[..., None], torch.as_tensor(
        10 * rng.normal(size=pos.shape), dtype=torch.float32), pos)
    assert not torch.equal(pairs_d.shift, pairs.shift) and not torch.equal(pos_d, pos)
    return dict(batched=batched, cheb=pot.cheb, clean=(pos, alive_f, pairs),
                dirty=(pos_d, alive_f, pairs_d))


def test_dead_pairs_leave_the_plain_pair_pass_unchanged(case):
    """Random finite shifts on the padding pairs and positions on the dead
    slots change no bit of the plain rho and ep (torch.equal)."""
    ref = ek.eam_rho_ep_plain(*case["clean"], case["cheb"])
    got = ek.eam_rho_ep_plain(*case["dirty"], case["cheb"])
    assert all(torch.equal(a, b) for a, b in zip(ref, got))


@pytest.mark.parametrize("dead_values", [False, True])
def test_plain_pair_pass_matches_pallas(case, dead_values):
    """Row 13's plain version against the JAX Pallas kernel in interpret
    mode on the same inputs, with the dead values as drawn or replaced."""
    pos, alive_f, pairs = case["dirty" if dead_values else "clean"]
    rho, ep = ek.eam_rho_ep_plain(pos, alive_f, pairs, case["cheb"])
    j_rho, j_ep = _jax_rho_ep(case["batched"])(jnp.asarray(pos.numpy()),
                                                 jnp.asarray(alive_f.numpy()))
    np.testing.assert_allclose(rho.numpy(), np.asarray(j_rho), **TOL)
    np.testing.assert_allclose(ep.numpy(), np.asarray(j_ep), **TOL)
