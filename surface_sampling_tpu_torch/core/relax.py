"""Structure relaxation inside the MC step: masked FIRE and L-BFGS,
batched over chains.

The counterpart of ``surface_sampling_tpu/core/relax.py`` (which replaces
the reference's per-move ASE optimizer, relax_steps=20, fmax=0.01):
``fire_relax``, ``fire_relax_traj`` (FIRE with frames) and ``lbfgs_relax``
(the JAX package's ``optax.lbfgs()`` with its zoom line search, written
here in PyTorch). The JAX package runs one ``lax.while_loop`` per chain under
``vmap``; here one Python loop advances every chain at once, and a chain
whose loop has ended (``i >= steps`` or ``max|F| < fmax``) keeps its carry
unchanged while the others go on, which is what the batched while loop
does. The loop ends when no chain is active, read back once per iteration.
Positions are detached between iterations, so no autograd graph spans the
loop. Frozen bulk atoms and dead slots enter through a force mask.

After relaxation an energy beyond the size-aware bound or a force above
``MAX_FORCE_THRESHOLD`` is out of bounds (energy clamped to the bound), and
a NaN energy or position restores the starting geometry.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

ENERGY_THRESHOLD = 1000.0           # eV
ENERGY_THRESHOLD_PER_ATOM = 20.0    # eV/atom added to it
MAX_FORCE_THRESHOLD = 1000.0        # eV/A


def energy_threshold(n_atoms) -> float:
    """Size-aware OOB energy bound: 1000 eV + 20 eV/atom."""
    return ENERGY_THRESHOLD + ENERGY_THRESHOLD_PER_ATOM * n_atoms


class FireConfig(NamedTuple):
    """FIRE hyperparameters (ASE defaults, matching the reference's use)."""

    steps: int = 20
    fmax: float = 0.01
    dt_start: float = 0.1
    dt_max: float = 1.0
    n_min: int = 5
    f_inc: float = 1.1
    f_dec: float = 0.5
    alpha_start: float = 0.1
    f_alpha: float = 0.99
    max_step: float = 0.2      # max total displacement norm per iteration


class RelaxResult(NamedTuple):
    positions: torch.Tensor    # (C, N, 3)
    energy: torch.Tensor       # (C,) post-relax potential energy (OOB-clamped)
    max_force: torch.Tensor    # (C,)
    converged: torch.Tensor    # (C,) bool
    oob: torch.Tensor          # (C,) bool, energy/force out of bounds or NaN
    n_steps: torch.Tensor      # (C,) int32 iterations each chain took


def _fnorm_max(f: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((f * f).sum(dim=2).amax(dim=1))


def _norm(x: torch.Tensor) -> torch.Tensor:
    """(C,) Euclidean norm over all of a chain's (N, 3) entries."""
    return torch.sqrt((x * x).sum(dim=(1, 2)))


def _sel(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Per chain: ``new`` where ``active`` (C,), else ``old``."""
    return torch.where(active.view(-1, *([1] * (new.dim() - 1))), new, old)


def _force_fn(energy_fn: Callable, fmask: torch.Tensor) -> Callable:
    """``force_of(pos) -> (energies (C,), masked forces (C, N, 3))`` by one
    backward pass of the chain-summed energy."""

    def force_of(pos):
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            e = energy_fn(p)
            (g,) = torch.autograd.grad(e.sum(), p)
        return e.detach(), -g * fmask

    return force_of


def _fire_move(pos, vel, dt, alpha, n_pos, f, fmask, cfg: FireConfig):
    """One FIRE iteration of every chain: the mixed velocity, the adapted
    time step and mixing, and the displacement capped at ``max_step``.
    Returns (positions, velocities, dt, alpha, n_pos) after the move."""
    vf = (f * vel).sum(dim=(1, 2))
    uphill = vf <= 0.0
    v_norm, f_norm = _norm(vel), _norm(f)
    scale = (v_norm / torch.clamp(f_norm, min=1e-30))[:, None, None]
    a3 = alpha[:, None, None]
    mixed = (1.0 - a3) * vel + a3 * f * scale
    vel_n = _sel(uphill, torch.zeros_like(vel), mixed)
    grow = ~uphill & (n_pos > cfg.n_min)
    dt_n = torch.where(grow, torch.clamp(dt * cfg.f_inc, max=cfg.dt_max), dt)
    alpha_n = torch.where(grow, alpha * cfg.f_alpha, alpha)
    dt_n = torch.where(uphill, dt_n * cfg.f_dec, dt_n)
    alpha_n = torch.where(uphill, torch.full_like(alpha_n, cfg.alpha_start), alpha_n)
    n_pos_n = torch.where(uphill, torch.zeros_like(n_pos), n_pos + 1)
    vel_n = vel_n + dt_n[:, None, None] * f
    dr = dt_n[:, None, None] * vel_n
    step = torch.clamp(cfg.max_step / torch.clamp(_norm(dr), min=1e-30), max=1.0)
    return pos + dr * step[:, None, None] * fmask, vel_n, dt_n, alpha_n, n_pos_n


def fire_relax(
    energy_fn: Callable[[torch.Tensor], torch.Tensor],
    positions0: torch.Tensor,
    free_mask: torch.Tensor,
    cfg: FireConfig = FireConfig(),
) -> RelaxResult:
    """Relax every chain of ``positions0`` under ``energy_fn`` with FIRE.

    Args:
        energy_fn: positions (C, N, 3) -> (C,) potential energies (already
            closed over species and alive masks), differentiable.
        positions0: (C, N, 3) starting geometries.
        free_mask: (C, N) bool, True for atoms allowed to move.
        cfg: FIRE hyperparameters.
    """
    dtype, dev = positions0.dtype, positions0.device
    C = positions0.shape[0]
    fmask = free_mask[..., None].to(dtype)
    positions0 = positions0.detach()

    force_of = _force_fn(energy_fn, fmask)
    pos = positions0
    vel = torch.zeros_like(pos)
    dt = torch.full((C,), cfg.dt_start, dtype=dtype, device=dev)
    alpha = torch.full((C,), cfg.alpha_start, dtype=dtype, device=dev)
    i = torch.zeros(C, dtype=torch.int32, device=dev)
    n_pos = torch.zeros(C, dtype=torch.int32, device=dev)
    e, f = force_of(pos)
    while True:
        active = (i < cfg.steps) & (_fnorm_max(f) >= cfg.fmax)
        if not bool(active.any()):
            break
        pos_n, vel_n, dt_n, alpha_n, n_pos_n = _fire_move(pos, vel, dt, alpha, n_pos, f, fmask,
                                                          cfg)
        e_n, f_n = force_of(pos_n)
        pos, vel, f = _sel(active, pos_n, pos), _sel(active, vel_n, vel), _sel(active, f_n, f)
        e, dt, alpha = _sel(active, e_n, e), _sel(active, dt_n, dt), _sel(active, alpha_n, alpha)
        n_pos, i = _sel(active, n_pos_n, n_pos), _sel(active, i + 1, i)
    return _finish(pos, e, _fnorm_max(f), positions0, i, cfg)


def _finish(pos, e, mf, positions0, i, cfg: FireConfig) -> RelaxResult:
    e_bound = torch.full_like(e, energy_threshold(pos.shape[1]))
    oob = (e.abs() > e_bound) | (mf > MAX_FORCE_THRESHOLD)
    e_out = torch.where(oob, e_bound, e)
    nan_guard = torch.isnan(e_out) | torch.isnan(pos).any(dim=(1, 2))
    e_out = torch.where(nan_guard, e_bound, e_out)
    pos = torch.where(nan_guard[:, None, None], positions0, pos)
    return RelaxResult(
        positions=pos,
        energy=e_out,
        max_force=mf,
        converged=mf < cfg.fmax,
        oob=oob | nan_guard,
        n_steps=i,
    )


def fire_relax_traj(
    energy_fn: Callable[[torch.Tensor], torch.Tensor],
    positions0: torch.Tensor,
    free_mask: torch.Tensor,
    cfg: FireConfig = FireConfig(),
    record_interval: int = 5,
):
    """FIRE with trajectory capture: exactly ``cfg.steps`` iterations (no
    early exit; a chain that has converged keeps its geometry, so later
    frames repeat it), recording every ``record_interval``-th.

    Returns (RelaxResult, frames (C, n_rec, N, 3), frame energies
    (C, n_rec)), frame k the positions after iteration k * record_interval
    + 1."""
    dtype, dev = positions0.dtype, positions0.device
    C = positions0.shape[0]
    fmask = free_mask[..., None].to(dtype)
    positions0 = positions0.detach()
    force_of = _force_fn(energy_fn, fmask)
    pos, vel = positions0, torch.zeros_like(positions0)
    dt = torch.full((C,), cfg.dt_start, dtype=dtype, device=dev)
    alpha = torch.full((C,), cfg.alpha_start, dtype=dtype, device=dev)
    n_pos = torch.zeros(C, dtype=torch.int32, device=dev)
    e, f = force_of(pos)
    frames, frame_e = [], []
    for it in range(cfg.steps):
        moving = _fnorm_max(f) >= cfg.fmax
        pos_n, vel_n, dt_n, alpha_n, n_pos_n = _fire_move(pos, vel, dt, alpha, n_pos, f, fmask,
                                                          cfg)
        e_n, f_n = force_of(pos_n)
        pos, vel, f = _sel(moving, pos_n, pos), _sel(moving, vel_n, vel), _sel(moving, f_n, f)
        e, dt, alpha = _sel(moving, e_n, e), _sel(moving, dt_n, dt), _sel(moving, alpha_n, alpha)
        n_pos = _sel(moving, n_pos_n, n_pos)
        if it % record_interval == 0:
            frames.append(pos)
            frame_e.append(e)
    steps = torch.full((C,), cfg.steps, dtype=torch.int32, device=dev)
    result = _finish(pos, e, _fnorm_max(f), positions0, steps, cfg)
    return result, torch.stack(frames, dim=1), torch.stack(frame_e, dim=1)


# ----------------------------------------------------------------------
# L-BFGS with a zoom line search
# ----------------------------------------------------------------------
# The defaults of the JAX package's optax.lbfgs() (optax 0.2.6): a memory
# of 10 pairs, the scaled initial preconditioner (the capped reciprocal
# gradient norm on the first iteration), and scale_by_zoom_linesearch with
# max_linesearch_steps=20, initial_guess_strategy="one" and its defaults
# (no step cap, tol 0, increase factor 2, slope_rtol 1e-4, curv_rtol 0.9,
# approx_dec_rtol 1e-6, stepsize_precision 1e-5).
LBFGS_MEMORY = 10
LS_MAX_STEPS = 20
LS_TOL = 0.0
LS_INCREASE = 2.0
LS_SLOPE_RTOL = 1e-4
LS_CURV_RTOL = 0.9
LS_APPROX_DEC_RTOL = 1e-6
LS_INTERVAL_THRESHOLD = 1e-5


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(C,) inner product of each chain's (N, 3) entries."""
    return (a * b).sum(dim=(1, 2))


def _nan_to_inf(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), torch.full_like(x, torch.inf), x)


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    """Armijo decrease error, relaxed by the approximate Wolfe test
    (Hager and Zhang), 0 where satisfied and inf where NaN."""
    err = value_step - value_init - LS_SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * LS_SLOPE_RTOL - 1.0) * slope_init
    delta_values = value_step - value_init - LS_APPROX_DEC_RTOL * value_init.abs()
    err = torch.minimum(torch.maximum(approx, delta_values), err)
    return _nan_to_inf(torch.clamp(err, min=0.0))


def _curvature_error(slope_step, slope_init):
    return _nan_to_inf(torch.clamp(slope_step.abs() - LS_CURV_RTOL * slope_init.abs(), min=0.0))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN when it has none)."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    x1, x2 = fb - fa - fpa * db, fc - fa - fpa * dc
    A = (dc ** 2 * x1 - db ** 2 * x2) / denom
    B = (-(dc ** 3) * x1 + db ** 3 * x2) / denom
    radical = B * B - 3.0 * A * fpa
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def zoom_linesearch(value_and_grad: Callable, params, updates, value, grad, running):
    """The zoom line search (Nocedal and Wright, algorithms 3.5 and 3.6, as
    optax 0.2.6 writes it) of every chain along its direction ``updates``
    from ``params`` (C, N, 3), with the value (C,) and gradient there.
    Each chain keeps its own search state; the chains not ``running`` (C,)
    and those whose search has ended keep theirs while the others go on,
    each iteration one batched ``value_and_grad`` of every chain.

    Returns (stepsize, value, grad, steps) of each chain: its accepted
    step, the value and gradient there, and its line-search iterations."""
    C = value.shape[0]
    f32 = dict(dtype=value.dtype, device=value.device)
    zero = torch.zeros(C, **f32)
    slope = _vdot(updates, grad)
    st = dict(count=torch.zeros(C, dtype=torch.int32, device=value.device),
              stepsize=zero, value=value, grad=grad, slope=slope,
              decrease_error=torch.full((C,), torch.inf, **f32),
              interval_found=torch.zeros(C, dtype=torch.bool, device=value.device),
              done=~running, failed=torch.zeros(C, dtype=torch.bool, device=value.device),
              low=zero, value_low=value, slope_low=slope, high=zero, value_high=value,
              slope_high=slope, cubic_ref=zero, value_cubic_ref=value,
              safe_stepsize=zero, safe_value=value, safe_grad=grad)
    value_init, slope_init = value, slope
    while True:
        live = ~(st["done"] | st["failed"])
        if not bool(live.any()):
            break
        count, low, high = st["count"], st["low"], st["high"]
        found = st["interval_found"]
        # the trial step: interval search (algorithm 3.5) or zoom (3.6)
        search_t = torch.where(count == 0, torch.ones_like(zero), LS_INCREASE * st["stepsize"])
        delta = (high - low).abs()
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        mid_c = _cubicmin(low, st["value_low"], st["slope_low"], high, st["value_high"],
                          st["cubic_ref"], st["value_cubic_ref"])
        use_c = (mid_c > left + 0.2 * delta) & (mid_c < right - 0.2 * delta)
        mid_q = _quadmin(low, st["value_low"], st["slope_low"], high, st["value_high"])
        use_q = ~use_c & (mid_q > left + 0.1 * delta) & (mid_q < right - 0.1 * delta)
        middle = torch.where(use_c, mid_c, st["cubic_ref"])
        middle = torch.where(use_q, mid_q, middle)
        middle = torch.where(~use_c & ~use_q, (low + high) / 2.0, middle)
        t = torch.where(found, middle, search_t)

        v, g = value_and_grad(params + t[:, None, None] * updates)
        s = _vdot(g, updates)
        dec = _decrease_error(t, v, s, value_init, slope_init)
        err = torch.maximum(dec, _curvature_error(s, slope_init))
        done = err <= LS_TOL
        last = count + 1 >= LS_MAX_STEPS
        safe_dec = dec <= LS_TOL

        # interval search: bracket [low, high] around an acceptable step
        high_new = (dec > 0.0) | ((v >= st["value"]) & (count > 0))
        low_new = (s >= 0.0) & ~high_new
        prev = (st["stepsize"], st["value"], st["slope"])
        s_low = [torch.where(low_new, a, b) for a, b in zip((t, v, s), prev)]
        s_high = [torch.where(low_new, a, b) for a, b in zip(prev, (t, v, s))]
        s_found = high_new | low_new | done
        s_safe = safe_dec

        # zoom: shrink the bracket around the trial step
        z_safe = safe_dec & (v < st["safe_value"])
        high_mid = (dec > 0.0) | (v >= st["value_low"])
        high_low = (s * (high - low) >= 0.0) & ~high_mid
        cur_low = (low, st["value_low"], st["slope_low"])
        cur_high = (high, st["value_high"], st["slope_high"])
        z_high = [torch.where(high_low, lo, torch.where(high_mid, m, hi))
                  for lo, m, hi in zip(cur_low, (t, v, s), cur_high)]
        z_low = [torch.where(~high_mid, m, lo) for m, lo in zip((t, v, s), cur_low)]
        moved = high_mid | high_low
        z_cubic = [torch.where(moved, hi, lo) for hi, lo in zip(cur_high[:2], cur_low[:2])]
        z_safe_step = torch.where(z_safe, t, st["safe_stepsize"])
        z_failed = (last | ((delta <= LS_INTERVAL_THRESHOLD) & (z_safe_step > 0.0))) & ~done

        safe = torch.where(found, z_safe, s_safe)
        new_low = [torch.where(found, z, a) for z, a in zip(z_low, s_low)]
        new_high = [torch.where(found, z, a) for z, a in zip(z_high, s_high)]
        new_cubic = [torch.where(found, z, a) for z, a in zip(z_cubic, s_low[:2])]
        new = dict(count=count + 1, stepsize=t, value=v, grad=g, slope=s, decrease_error=dec,
                   interval_found=torch.where(found, found, s_found), done=done,
                   failed=torch.where(found, z_failed, last & ~done),
                   low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
                   high=new_high[0], value_high=new_high[1], slope_high=new_high[2],
                   cubic_ref=new_cubic[0], value_cubic_ref=new_cubic[1],
                   safe_stepsize=torch.where(safe, t, st["safe_stepsize"]),
                   safe_value=torch.where(safe, v, st["safe_value"]),
                   safe_grad=_sel(safe, g, st["safe_grad"]))
        # a failed search falls back on its best step of sufficient decrease
        fallback = new["failed"] & ((new["safe_stepsize"] > 0.0)
                                    | torch.isinf(new["decrease_error"]))
        new["stepsize"] = torch.where(fallback, new["safe_stepsize"], new["stepsize"])
        new["value"] = torch.where(fallback, new["safe_value"], new["value"])
        new["grad"] = _sel(fallback, new["safe_grad"], new["grad"])
        st = {k: _sel(live, new[k], st[k]) for k in st}
    return st["stepsize"], st["value"], st["grad"], st["count"]


def lbfgs_relax(
    energy_fn: Callable[[torch.Tensor], torch.Tensor],
    positions0: torch.Tensor,
    free_mask: torch.Tensor,
    cfg: FireConfig = FireConfig(),
) -> RelaxResult:
    """L-BFGS relaxation of every chain: the JAX package's ``optax.lbfgs()``
    (memory 10, scaled initial preconditioner, zoom line search), written
    in PyTorch and batched over chains. Frozen atoms enter by optimizing
    the masked displacement delta (positions = positions0 + delta * free).
    Each chain keeps its own L-BFGS memory and line-search state; a chain
    whose loop has ended (``cfg.steps`` iterations, or max|F| < ``cfg.fmax``
    at the start of its previous iteration, the JAX loop's test) keeps its
    state while the others go on. The same out-of-bounds semantics as
    :func:`fire_relax`; ``n_steps`` counts L-BFGS iterations."""
    dtype, dev = positions0.dtype, positions0.device
    C = positions0.shape[0]
    m = LBFGS_MEMORY
    fmask = free_mask[..., None].to(dtype)
    positions0 = positions0.detach()

    def value_and_grad(delta):
        with torch.enable_grad():
            p = delta.detach().requires_grad_(True)
            e = energy_fn(positions0 + p * fmask)
            (g,) = torch.autograd.grad(e.sum(), p)
        return e.detach(), g

    def converged(g):
        return _fnorm_max(g * fmask) < cfg.fmax

    rows = torch.arange(C, device=dev)
    delta = torch.zeros_like(positions0)
    count = torch.zeros(C, dtype=torch.int64, device=dev)
    prev_params, prev_grad = torch.zeros_like(delta), torch.zeros_like(delta)
    mem_dw = torch.zeros((C, m, *delta.shape[1:]), dtype=dtype, device=dev)
    mem_du = torch.zeros_like(mem_dw)
    mem_rho = torch.zeros((C, m), dtype=dtype, device=dev)
    i = torch.zeros(C, dtype=torch.int32, device=dev)
    # the value and gradient the next iteration starts from: the last line
    # search's at the point it accepted (optax.value_and_grad_from_state)
    ls_value, ls_grad = value_and_grad(delta)
    g_prev = ls_grad
    while True:
        active = (i < cfg.steps) & ~converged(g_prev)
        if not bool(active.any()):
            break
        fresh = ~torch.isfinite(ls_value)
        if bool((fresh & active).any()):
            v_f, g_f = value_and_grad(delta)
            ls_value, ls_grad = torch.where(fresh, v_f, ls_value), _sel(fresh, g_f, ls_grad)
        v, g = ls_value, ls_grad

        # memory update with the last step, then the two-loop product
        first = count == 0
        dp = torch.where(first[:, None, None], 0.0, delta - prev_params)
        du = torch.where(first[:, None, None], 0.0, g - prev_grad)
        dot = _vdot(du, dp)
        weight = torch.where(first | (dot == 0.0), 0.0, 1.0 / dot)
        slot = (count - 1) % m
        mem_dw_n, mem_du_n, mem_rho_n = mem_dw.clone(), mem_du.clone(), mem_rho.clone()
        mem_dw_n[rows, slot], mem_du_n[rows, slot], mem_rho_n[rows, slot] = dp, du, weight
        den = _vdot(du, du)
        scale = torch.where(den > 0.0, dot / den, 1.0)
        capped = torch.clamp(1.0 / torch.sqrt(_vdot(g, g)), max=1.0)
        scale = torch.where(first, capped, scale)
        order = (count[:, None] + torch.arange(m, device=dev)) % m          # (C, m)
        vec, alphas = g, []
        for j in reversed(range(m)):
            idx = order[:, j]
            a = mem_rho_n[rows, idx] * _vdot(mem_dw_n[rows, idx], vec)
            vec = vec + (-a)[:, None, None] * mem_du_n[rows, idx]
            alphas.append(a)
        vec = scale[:, None, None] * vec
        for j, a in zip(range(m), reversed(alphas)):
            idx = order[:, j]
            b = mem_rho_n[rows, idx] * _vdot(mem_du_n[rows, idx], vec)
            vec = vec + (a - b)[:, None, None] * mem_dw_n[rows, idx]
        direction = -vec

        lr, v_ls, g_ls, _ = zoom_linesearch(value_and_grad, delta, direction, v, g, active)
        delta_n = delta + lr[:, None, None] * direction
        mem_dw, mem_du, mem_rho = (_sel(active, mem_dw_n, mem_dw), _sel(active, mem_du_n, mem_du),
                                   _sel(active, mem_rho_n, mem_rho))
        prev_params, prev_grad = _sel(active, delta, prev_params), _sel(active, g, prev_grad)
        count = torch.where(active, count + 1, count)
        delta = _sel(active, delta_n, delta)
        ls_value, ls_grad = torch.where(active, v_ls, ls_value), _sel(active, g_ls, ls_grad)
        g_prev = _sel(active, g, g_prev)
        i = torch.where(active, i + 1, i)
    pos = positions0 + delta * fmask
    e, g_final = value_and_grad(delta)
    return _finish(pos, e, _fnorm_max(g_final * fmask), positions0, i, cfg)
