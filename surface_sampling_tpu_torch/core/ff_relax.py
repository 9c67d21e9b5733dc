"""Frozen-far-field ball relaxation MC, batched over chains.

The counterpart of ``surface_sampling_tpu/core/ff_relax.py``. The
warm-started ball engine (``core/local_relax.py``) still evaluates forces on
the whole cell at every FIRE iteration; this engine changes the relaxation
policy so that the descent itself is local. Per move:

  * the moved site's slots reset to their lattice template; the slots within
    ``hops`` candidate-adjacency hops form the relax ball, and its one-hop
    ring the frozen far field;
  * FIRE descends a local objective: the summed per-atom energies of the
    ball rows, computed by running the L message layers for the ball rows
    only, while every ring row's layer inputs stay frozen at the caches of
    the last accepted full evaluation (and its positions fixed);
  * the acceptance energy is a full-cell evaluation of the relaxed geometry
    (the evaluator of the full relaxed path), whose layer inputs become the
    chain's caches when the move is accepted.

The approximation lies only in which minimum the descent lands in, not in
the acceptance energy. Each chain moves its own site, so every chain has its
own subproblem rows (C, NSub). Where the JAX package routes neighbour
features through one-hot products on the TPU, the descent here gathers them,
and the gathers' backward (:class:`_BallRoute`) sums each ball row's
cotangents in the fixed order of a reverse table built once per move, with
no float atomics, so relaxed runs repeat bitwise on the card. The descent is
plain PyTorch; the acceptance pass runs the general trunk's kernels.

Refused, because they exist for the TPU's memory or its bf16 units: remat
(``use_remat=True``) and a bf16 descent (``descent_dtype="bf16"``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as tnf

from surface_sampling_tpu_torch.core.energy import (
    RelaxConfig,
    StateEnergy,
    identity_surface_energy,
)
from surface_sampling_tpu_torch.core.engine import make_sweep_record, run_sweeps
from surface_sampling_tpu_torch.core.events import (
    StepInfo,
    canonical_draws,
    hard_wall_accept,
    metropolis_accept,
    pick_exchange,
    propose_change,
    semigrand_draws,
)
from surface_sampling_tpu_torch.core.relax import FireConfig, energy_threshold, fire_relax
from surface_sampling_tpu_torch.core.state import (
    DeviceSpec,
    MCState,
    element_counts,
    exchange_sites,
    num_occupied_sites,
    realize_alive,
    realize_free_mask,
    realize_positions,
    realize_type_idx,
)
from surface_sampling_tpu_torch.models.painn import (
    _cosine_envelope,
    _dense,
    _rbf,
    painn_update,
    update_weights,
)
from surface_sampling_tpu_torch.utils.tracing import span


class FFTables(NamedTuple):
    """Host-built subproblem tables (numpy), the JAX package's.

    rows: (S, NSub) int32 slot ids of each site's subproblem, relax ball
        first (``n_ball`` rows), frozen ring after; padded by repeating the
        first entry. row_valid: (S, NSub) bool, False on padding.
    slot_j / slot_shift_idx / slot_valid: (N, M) the shared candidate table
        (the static table's), its shifts as indices into ``shifts_u``
        (Ku, 3).
    n_ball / n_sub: padded widths; ball_frac: mean |ball| / N.
    """

    rows: np.ndarray
    row_valid: np.ndarray
    slot_j: np.ndarray
    slot_shift_idx: np.ndarray
    slot_valid: np.ndarray
    shifts_u: np.ndarray
    n_ball: int
    n_sub: int
    ball_frac: float


def build_ff_tables(spec, static_nbr, hops: int = 1) -> FFTables:
    """Relax balls (``hops`` hops of the candidate adjacency around each
    site's slots) and their one-hop frozen rings. The candidate table is a
    geometric superset of every interaction, so the ring holds every row a
    ball row can touch."""
    P, S, G = spec.n_pristine, spec.n_sites, spec.group_size
    N = P + S * G
    slot_j = np.asarray(static_nbr.slot_j)
    valid = np.asarray(static_nbr.valid)
    M = slot_j.shape[1]
    adj = np.zeros((N, N), bool)
    rr = np.repeat(np.arange(N), M)
    ok = valid.reshape(-1)
    adj[rr[ok], slot_j.reshape(-1)[ok]] = True
    adj |= adj.T

    sh_flat = np.asarray(static_nbr.shift, np.float32).reshape(-1, 3)
    shifts_u, sh_inv = np.unique(sh_flat.round(6), axis=0, return_inverse=True)
    sh_idx_full = sh_inv.reshape(N, M).astype(np.int32)

    balls, rings = [], []
    for s in range(S):
        mask = np.zeros(N, bool)
        mask[P + s * G: P + (s + 1) * G] = True
        for _ in range(hops):
            mask = mask | adj[mask].any(axis=0)
        ring = adj[mask].any(axis=0) & ~mask
        balls.append(np.where(mask)[0])
        rings.append(np.where(ring)[0])
    NB = int(np.ceil(max(len(b) for b in balls) / 8.0) * 8)
    NR = int(np.ceil(max(len(r) for r in rings) / 8.0) * 8)
    NSub = NB + NR
    rows = np.zeros((S, NSub), np.int32)
    row_valid = np.zeros((S, NSub), bool)
    for s in range(S):
        b, r = balls[s], rings[s]
        rows[s, :len(b)] = b
        rows[s, NB:NB + len(r)] = r
        rows[s, len(b):NB] = b[0]
        rows[s, NB + len(r):] = b[0]
        row_valid[s, :len(b)] = True
        row_valid[s, NB:NB + len(r)] = True
    return FFTables(rows=rows, row_valid=row_valid, slot_j=slot_j.astype(np.int32),
                    slot_shift_idx=sh_idx_full, slot_valid=np.asarray(valid, bool),
                    shifts_u=shifts_u, n_ball=NB, n_sub=NSub,
                    ball_frac=float(np.mean([len(b) for b in balls]) / N))


def reverse_table(nbr: torch.Tensor, emask: torch.Tensor, n_ball: int) -> torch.Tensor:
    """(C, n_ball, D) flat edge ids of the live edges (``emask``) whose
    neighbour ``nbr`` (C, NB, M) is ball row j, in edge order; the id NB * M
    (a zero row) pads each list to the longest, D."""
    C = nbr.shape[0]
    E = nbr.shape[1] * nbr.shape[2]
    key = torch.where(emask & (nbr < n_ball), nbr, n_ball).reshape(C, E)
    sk, order = torch.sort(key, dim=1, stable=True)
    targets = torch.arange(n_ball, device=nbr.device).expand(C, n_ball).contiguous()
    start = torch.searchsorted(sk, targets)
    count = torch.searchsorted(sk, targets, right=True) - start
    D = max(int(count.max()), 1)
    k = torch.arange(D, device=nbr.device)
    pos = (start[..., None] + k).clamp(max=E - 1).reshape(C, -1)
    ids = order.gather(1, pos).view(C, n_ball, D)
    return torch.where(k < count[..., None], ids, torch.full_like(ids, E))


class _BallRoute(torch.autograd.Function):
    """Neighbour rows of the subproblem: y[c, k, e] = x[c, k, idx[c, e]] *
    mask[c, e] with x = [x_ball | x_ring] along rows. The ring is frozen (no
    gradient); a ball row's gradient is the sum of its edges' cotangents,
    gathered through the reverse table ``rev`` (C, NB, D) and summed over D
    in that fixed order (a scatter-add would use float atomics on the card,
    whose order varies between runs)."""

    @staticmethod
    def forward(ctx, x_ball, x_ring, idx, mask, rev):
        x = torch.cat([x_ball, x_ring], dim=2)
        C, K, _, W = x.shape
        E = idx.shape[1]
        ctx.save_for_backward(rev)
        ctx.ball_shape = x_ball.shape
        return x.gather(2, idx.view(C, 1, E, 1).expand(C, K, E, W)) * mask.view(C, 1, E, 1)

    @staticmethod
    def backward(ctx, dy):
        (rev,) = ctx.saved_tensors
        C, K, NB, W = ctx.ball_shape
        D = rev.shape[2]
        dy = torch.cat([dy, dy.new_zeros(C, K, 1, W)], dim=2)
        g = dy.gather(2, rev.view(C, 1, NB * D, 1).expand(C, K, NB * D, W))
        return g.view(C, K, NB, D, W).sum(dim=3), None, None, None, None


def make_ff_relax_eval(
    d: DeviceSpec,
    potential,
    surface_energy_fn: Callable | None = None,
    relax: RelaxConfig = RelaxConfig(),
    tables: FFTables | None = None,
    routing_precision: str = "default",
    use_remat: bool = False,
    use_split_router: bool = True,
    seat_tables: FFTables | None = None,
    descent_dtype: str = "auto",
) -> Callable:
    """Build ``evaluate(trial_ss (C, S), pos_prev (C, N, 3), caches, sites2
    (C, 2)) -> (StateEnergy, new_caches)``: the frozen-far-field counterpart
    of the local-relax evaluation. ``caches`` is ``(cache_s (C, K, L, N,
    F), cache_v (C, K, L, N, 3F))``, the layer inputs of each chain's last
    accepted full evaluation (vector features x-major, as everywhere in the
    port); ``sites2`` holds each chain's two moved sites, descended one after
    the other. ``evaluate.evaluate1(trial_ss, pos_prev, caches, site (C,))``
    descends one ball; ``evaluate.relax_ball`` and ``evaluate.finish``
    (positions, trial_ss) -> (StateEnergy, caches) are its parts.

    ``potential`` is a ``models.nn_calculator.PaiNNPotential``; its
    ``params``, ``cfg``, ``factor`` and ``comp_offset`` are the JAX
    package's ``ff_pack`` / ``ff_comp_offset`` hooks. ``routing_precision``
    ("default" or "highest") and ``use_split_router`` select TPU forms of the
    same float32 function and change nothing here; ``use_remat=True`` and
    ``descent_dtype="bf16"`` are refused (the port descends in float32 and
    keeps the residuals, which fit the card).
    """
    if use_remat:
        raise ValueError("use_remat is a TPU memory measure: the port keeps the descent's "
                         "residuals (use_remat=False)")
    if descent_dtype not in ("auto", "f32"):
        raise ValueError(f"descent_dtype must be 'auto' or 'f32' (the port descends in float32), "
                         f"got {descent_dtype!r}")
    if routing_precision not in ("default", "highest"):
        raise ValueError(f"routing_precision must be 'default' or 'highest', "
                         f"got {routing_precision!r}")
    if use_split_router not in (True, False):
        raise ValueError("use_split_router must be a bool")
    if tables is None:
        raise ValueError("tables required (build_ff_tables)")
    if not (hasattr(potential, "params") and hasattr(potential, "outputs")
            and hasattr(potential, "comp_offset") and "message" in potential.params):
        raise ValueError("ff_relax needs a PaiNN potential "
                         "(models.nn_calculator.make_painn_potential)")
    params, cfg, factor = potential.params, potential.cfg, potential.factor
    dev = d.device
    sfn = surface_energy_fn or identity_surface_energy
    fire_cfg = FireConfig(steps=relax.steps, fmax=relax.fmax, max_step=relax.max_step)
    P = d.pristine_positions.shape[0]
    G = d.code_offsets.shape[1]
    F, L = cfg.feat_dim, cfg.n_layers
    shifts_u = torch.as_tensor(np.asarray(tables.shifts_u, np.float32), device=dev)
    slot_j = torch.as_tensor(tables.slot_j, dtype=torch.int64, device=dev)
    slot_sh = torch.as_tensor(tables.slot_shift_idx, dtype=torch.int64, device=dev)
    slot_valid = torch.as_tensor(tables.slot_valid, device=dev)
    N = int(tables.slot_j.shape[0])
    Mc = int(tables.slot_j.shape[1])
    m_sel = min(int(cfg.max_neighbors), Mc)

    def stage(tbl: FFTables) -> dict:
        return dict(NB=tbl.n_ball, NSub=tbl.n_sub,
                    rows=torch.as_tensor(tbl.rows, dtype=torch.int64, device=dev),
                    rvalid=torch.as_tensor(tbl.row_valid, device=dev),
                    is_ball=torch.arange(tbl.n_sub, device=dev) < tbl.n_ball)

    T_main = stage(tables)
    T_seat = stage(seat_tables) if seat_tables is not None else None

    def phi_of(mp, s):
        return _dense(mp["inv_dense1"], tnf.silu(_dense(mp["inv_dense0"], s)))

    def relax_ball(pos0, trial_ss, caches, site, T=None):
        """FIRE-descend every chain's ball of ``site`` (C,) (table set
        ``T``, default the main ball); returns the full positions with the
        relaxed balls written back."""
        T = T_main if T is None else T
        NB, NSub = T["NB"], T["NSub"]
        cache_s, cache_v = caches
        C = trial_ss.shape[0]
        K = cache_s.shape[1]
        alive_full = realize_alive(d, trial_ss)
        numbers_full = potential.znums[realize_type_idx(d, trial_ss)] * alive_full.to(torch.int64)
        free_full = realize_free_mask(d, trial_ss)

        rows, rvalid = T["rows"][site], T["rvalid"][site]                  # (C, NSub)
        # global -> local row map of each chain (valid rows are unique; the
        # padding repeats write to the dropped column N)
        loc = torch.full((C, N + 1), -1, dtype=torch.int64, device=dev)
        loc.scatter_(1, torch.where(rvalid, rows, N),
                     torch.arange(NSub, device=dev).expand(C, NSub).contiguous())
        gball = rows[:, :NB]
        nbr = loc.gather(1, slot_j[gball].view(C, -1)).view(C, NB, Mc)
        nvalid = slot_valid[gball] & (nbr >= 0)
        nbr = torch.where(nvalid, nbr, torch.zeros_like(nbr))
        nshift = shifts_u[slot_sh[gball]]                                   # (C, NB, Mc, 3)

        def take(x, idx):
            """Rows ``idx`` (C, ...) of x (C, n, W)."""
            W = x.shape[-1]
            return x.gather(1, idx.reshape(C, -1, 1).expand(-1, -1, W)).view(*idx.shape, W)

        pos_sub0 = take(pos0, rows)                                         # (C, NSub, 3)
        alive_sub = alive_full.gather(1, rows) & rvalid
        numbers_sub = torch.where(alive_sub, numbers_full.gather(1, rows), 0)
        free_ball = free_full.gather(1, rows) & rvalid & T["is_ball"]
        alive_ball = alive_sub[:, :NB]
        emask = nvalid & alive_sub.gather(1, nbr.view(C, -1)).view(C, NB, Mc) & alive_ball[..., None]
        # topology once: the m_sel nearest live candidates at the start
        # geometry (stable sort: the lower index first among ties, as top_k)
        if m_sel < Mc:
            disp0 = take(pos_sub0, nbr) + nshift - pos_sub0[:, :NB, None, :]
            d0 = torch.sqrt(torch.clamp((disp0 * disp0).sum(-1), min=1e-12))
            score = torch.where(emask, -d0, torch.full_like(d0, -torch.inf))
            sel = torch.sort(score, dim=2, descending=True, stable=True).indices[..., :m_sel]
            nbr, emask = nbr.gather(2, sel), emask.gather(2, sel)
            nshift = nshift.gather(2, sel[..., None].expand(-1, -1, -1, 3))
        M = nbr.shape[2]
        idx = nbr.reshape(C, NB * M)
        maskf = emask.reshape(C, NB * M).to(pos0.dtype)
        rev = reverse_table(nbr, emask, NB)

        def route(x_ball, x_ring):
            """(C, K, NB, M, W) neighbour rows of [x_ball | x_ring]."""
            y = _BallRoute.apply(x_ball, x_ring, idx, maskf, rev)
            return y.view(C, x_ball.shape[1], NB, M, -1)

        # frozen layer inputs of the subproblem rows, and the per-move
        # constants: layer-1 phi of the fresh embeddings (v = 0 there), the
        # ring rows' phi of every later layer
        def sub_rows(cache):
            """(C, K, L, NSub, W) subproblem rows of a (C, K, L, N, W) cache."""
            W = cache.shape[-1]
            return cache.gather(3, rows[:, None, None, :, None].expand(C, K, L, NSub, W))

        cs, cv = sub_rows(cache_s), sub_rows(cache_v)
        z = torch.clamp(numbers_sub, 0, cfg.max_z - 1)
        s0 = (params["atom_embed"][:, z].transpose(0, 1)
              * alive_sub[:, None, :, None].to(pos0.dtype))                # (C, K, NSub, F)
        with torch.no_grad():
            phi0 = phi_of(params["message"][0], s0)
            phij0 = route(phi0[:, :, :NB], phi0[:, :, NB:])
            phi_ring = [None] + [phi_of(params["message"][li], cs[:, :, li, NB:])
                                 for li in range(1, L)]
        alive_bf = alive_ball.to(pos0.dtype)
        env_mask = emask.to(pos0.dtype)

        def local_energy(pos_sub):
            pos_j = route(pos_sub[:, None, :NB], pos_sub[:, None, NB:])[:, 0]
            disp = pos_j + nshift - pos_sub[:, :NB, None, :]
            dist = torch.sqrt(torch.clamp((disp * disp).sum(-1), min=1e-12))
            dist = torch.where(emask, dist, torch.full_like(dist, cfg.cutoff))
            disp = torch.where(emask[..., None], disp, torch.zeros_like(disp))
            unit = disp / torch.clamp(dist, min=1e-8)[..., None]
            rbf = _rbf(dist, cfg.n_rbf, cfg.cutoff)                         # (C, NB, M, R)
            env = (_cosine_envelope(dist, cfg.cutoff) * env_mask)[:, None, ..., None]
            s_ball = s0[:, :, :NB]
            vcat_ball = torch.zeros((C, K, NB, 3 * F), dtype=pos0.dtype, device=dev)
            for li, (mp, up) in enumerate(zip(params["message"], params["update"])):
                w = (torch.einsum("cnmr,kro->cknmo", rbf, mp["dist_embed"]["w"])
                     + mp["dist_embed"]["b"][None, :, None, None, :]) * env
                phij = phij0 if li == 0 else route(phi_of(mp, s_ball), phi_ring[li])
                inv = phij * w                                              # (C, K, NB, M, 3F)
                c_vv, c_s, c_unit = inv[..., :F], inv[..., F:2 * F], inv[..., 2 * F:]
                ds = c_s.sum(dim=3)
                dv = torch.einsum("cknmf,cnmx->cknxf", c_unit, unit)        # (C, K, NB, 3, F)
                if li > 0:
                    vj = route(vcat_ball, cv[:, :, li, NB:]).view(C, K, NB, M, 3, F)
                    dv = dv + (c_vv[..., None, :] * vj).sum(dim=3)
                s_ball, vcat_ball = painn_update(s_ball + ds, vcat_ball + dv.reshape(C, K, NB, -1),
                                                 *update_weights(up), alive_bf)
            h = tnf.silu(_dense(params["readout"]["dense0"], s_ball))
            e_atom = _dense(params["readout"]["dense1"], h)[..., 0] * alive_bf[:, None]
            e = e_atom.sum(dim=2).mean(dim=1)
            if cfg.excl_vol:
                r_pow = (cfg.sigma / torch.clamp(dist, min=1e-3)) ** cfg.power
                xmask = emask & (dist < cfg.cutoff)
                e = e + torch.where(xmask, r_pow, torch.zeros_like(r_pow)).sum(dim=(1, 2))
            return e * factor

        res = fire_relax(local_energy, pos_sub0, free_ball, fire_cfg)
        delta = torch.where(free_ball[..., None], res.positions - pos_sub0,
                            torch.zeros_like(pos_sub0))
        # add each ball row's move to its slot; padding rows (zero moves) go
        # to the dropped row N, so every index written is unique
        full = torch.zeros((C, N + 1, 3), dtype=pos0.dtype, device=dev)
        full.scatter_(1, torch.where(rvalid, rows, N)[..., None].expand(-1, -1, 3), delta)
        return pos0 + full[:, :N]

    def finish(pos, trial_ss):
        """Full-cell acceptance evaluation of ``pos`` and fresh caches (the
        general trunk on edges ranked at ``pos``: the evaluator the full
        relaxed path scores with)."""
        alive = realize_alive(d, trial_ss)
        type_idx = realize_type_idx(d, trial_ss)
        counts = element_counts(d, trial_ss, dtype=pos.dtype)
        e_bound = energy_threshold(pos.shape[1])
        with torch.no_grad():
            outs = potential.outputs(pos, type_idx, alive, collect_layers=True)
        e_pot = outs["energy"] * factor + potential.comp_offset(type_idx, alive)
        oob = (e_pot.abs() > e_bound) | torch.isnan(e_pot)
        bound = torch.full_like(e_pot, e_bound)
        e_pot = torch.where(oob, bound, e_pot)
        se = torch.where(oob, bound, sfn(e_pot, counts))
        st = StateEnergy(surface_energy=se, potential_energy=e_pot, positions=pos, oob=oob)
        return st, (outs["layer_s"], outs["layer_v"])

    def start_positions(trial_ss, pos_prev, sites2):
        """``pos_prev`` with the moved sites' slots reset to the trial code's
        lattice template."""
        lat = realize_positions(d, trial_ss)
        C = lat.shape[0]
        slots = (P + sites2.long()[:, :, None] * G
                 + torch.arange(G, device=dev)).reshape(C, -1, 1).expand(-1, -1, 3)
        return pos_prev.to(lat.dtype).scatter(1, slots, torch.gather(lat, 1, slots))

    def evaluate1(trial_ss, pos_prev, caches, site):
        site = site.long()
        pos0 = start_positions(trial_ss, pos_prev, torch.stack([site, site], dim=1))
        if T_seat is not None:
            pos0 = relax_ball(pos0, trial_ss, caches, site, T=T_seat)
        return finish(relax_ball(pos0, trial_ss, caches, site), trial_ss)

    def evaluate(trial_ss, pos_prev, caches, sites2):
        sites2 = sites2.long()
        pos0 = start_positions(trial_ss, pos_prev, sites2)
        if T_seat is not None:
            pos0 = relax_ball(pos0, trial_ss, caches, sites2[:, 0], T=T_seat)
            pos0 = relax_ball(pos0, trial_ss, caches, sites2[:, 1], T=T_seat)
        pos = relax_ball(pos0, trial_ss, caches, sites2[:, 0])
        pos = relax_ball(pos, trial_ss, caches, sites2[:, 1])
        return finish(pos, trial_ss)

    evaluate.evaluate1 = evaluate1
    evaluate.relax_ball = relax_ball
    evaluate.finish = finish
    return evaluate


class FFState(NamedTuple):
    """MC state of a batch of chains on the frozen-far-field engine."""

    site_state: torch.Tensor          # (C, S)
    energy: torch.Tensor              # (C,)
    relaxed_positions: torch.Tensor   # (C, N, 3)
    cache_s: torch.Tensor             # (C, K, L, N, F)
    cache_v: torch.Tensor             # (C, K, L, N, 3F) x-major


def make_ff_init(d: DeviceSpec, evaluate: Callable, full_state_energy: Callable) -> Callable:
    """``init(site_state (C, S)) -> FFState``: one full relaxed evaluation
    (``full_state_energy``, the relaxing ``MCMCRun``'s) seeds the positions,
    then the acceptance pass gives the energies and caches there."""

    def init(site_state):
        site_state = torch.as_tensor(site_state, dtype=torch.int64, device=d.device)
        e0 = full_state_energy(site_state)
        st, (cs, cv) = evaluate.finish(e0.positions, site_state)
        return FFState(site_state=site_state, energy=st.surface_energy,
                       relaxed_positions=st.positions, cache_s=cs, cache_v=cv)

    return init


def _select_state(accept, trial_ss, st: StateEnergy, caches, state: FFState) -> FFState:
    def pick(new, old):
        return torch.where(accept.view(-1, *([1] * (new.dim() - 1))), new, old)

    return FFState(site_state=pick(trial_ss, state.site_state),
                   energy=pick(st.surface_energy, state.energy),
                   relaxed_positions=pick(st.positions, state.relaxed_positions),
                   cache_s=pick(caches[0], state.cache_s), cache_v=pick(caches[1], state.cache_v))


def _ff_step(evaluate_fn, dist_accept, state: FFState, temp, trial_ss, moved, u_acc, valid=None):
    with span("mc.energy"):
        st, caches = evaluate_fn(trial_ss, state.relaxed_positions,
                                 (state.cache_s, state.cache_v), moved)
    temp = torch.as_tensor(temp, dtype=state.energy.dtype, device=trial_ss.device)
    accept = metropolis_accept(u_acc, state.energy, st.surface_energy, temp)
    if valid is not None:
        accept = accept & valid
    if dist_accept is not None:
        accept = accept & dist_accept(trial_ss)
    new = _select_state(accept, trial_ss, st, caches, state)
    return new, StepInfo(accepted=accept, energy=new.energy,
                         n_ads=num_occupied_sites(new.site_state), oob=st.oob)


def make_ff_semigrand_step(evaluate: Callable, criterion: str = "metropolis",
                           d: DeviceSpec | None = None, filter_distance: float = 1.5) -> Callable:
    """``step(state, temp, site, u_code, u_acc) -> (state, StepInfo)``: the
    semigrand Change step (``core.events.make_semigrand_step``'s draws, as
    tensors) with the trial state evaluated by one frozen-far-field ball
    descent; ``criterion="metropolis_distance"`` (with ``d``) adds the
    distance filter's hard wall."""
    dist_accept = hard_wall_accept(d, criterion, filter_distance)

    def step(state: FFState, temp, site, u_code, u_acc):
        trial_ss = propose_change(state.site_state, site, u_code)
        return _ff_step(evaluate.evaluate1, dist_accept, state, temp, trial_ss, site, u_acc)

    return step


def make_ff_canonical_step(evaluate: Callable, criterion: str = "metropolis",
                           d: DeviceSpec | None = None, filter_distance: float = 1.5) -> Callable:
    """``step(state, temp, g_types, g_site1, g_site2, u_acc) -> (state,
    StepInfo)``: the unweighted canonical Exchange step
    (``core.events.make_canonical_step``'s draws) with two sequential ball
    descents (the second sees the first's relaxed geometry, the far field
    frozen throughout). A chain with fewer than two codes present never
    accepts."""
    dist_accept = hard_wall_accept(d, criterion, filter_distance)

    def step(state: FFState, temp, g_types, g_site1, g_site2, u_acc):
        ss = state.site_state
        site1, site2, valid = pick_exchange(ss, g_types.shape[1], g_types, g_site1, g_site2)
        trial_ss = exchange_sites(ss, site1, site2)
        return _ff_step(evaluate, dist_accept, state, temp, trial_ss,
                        torch.stack([site1, site2], dim=1), u_acc, valid)

    return step


def make_ff_run(step_fn: Callable, sweep_size: int, n_sites: int, n_codes: int,
                canonical: bool = False, record_positions: bool = True) -> Callable:
    """``run(state, temps, generator, chain_block=None) -> (state,
    SweepRecord)`` over FF steps, with the draws and record schema of ``core.engine.make_run_fn``
    (``canonical`` for an exchange step's draws; the generator is
    continued in place; the caches ride the state)."""
    record = make_sweep_record(record_positions)
    draws = canonical_draws if canonical else semigrand_draws

    def run(state: FFState, temps, generator: torch.Generator, chain_block=None):
        return run_sweeps(step_fn, state, temps, generator, sweep_size, n_sites, n_codes, record,
                          draws, chain_block)

    return run


def make_ff_run_mcstate(evaluate: Callable, step_fn: Callable, sweep_size: int, n_sites: int,
                        n_codes: int, canonical: bool = False,
                        record_positions: bool = True) -> Callable:
    """``run(state: MCState, temps, generator) -> (MCState, SweepRecord)``:
    the run at an ``MCState`` boundary (site states, energies, relaxed
    positions), for chunked and resumed runs. The caches are rebuilt from
    the carried geometry at every chunk start (one acceptance pass), so a
    run cut into chunks that pass one generator along repeats one run
    bitwise."""
    inner = make_ff_run(step_fn, sweep_size, n_sites, n_codes, canonical, record_positions)

    def run(state: MCState, temps, generator: torch.Generator, chain_block=None):
        _, (cs, cv) = evaluate.finish(state.relaxed_positions, state.site_state)
        ff = FFState(site_state=state.site_state, energy=state.energy,
                     relaxed_positions=state.relaxed_positions, cache_s=cs, cache_v=cv)
        out, rec = inner(ff, temps, generator, chain_block)
        return MCState(site_state=out.site_state, energy=out.energy,
                       relaxed_positions=out.relaxed_positions), rec

    return run
