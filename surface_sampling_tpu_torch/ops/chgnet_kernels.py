"""The CHGNet atom-graph convolution: CUDA kernels for Hopper, their plain
PyTorch versions and launch counters.

Each op replaces a Pallas TPU kernel of
``surface_sampling_tpu/ops/pallas_chgnet.py``:

    chgnet_conv          the fused atom conv of every layer (replaces
                         ``chgnet_conv_fused`` / ``_conv_kernel``), a
                         ``torch.autograd.Function`` whose backward launches
                         ``chgnet_conv_bwd``, differentiable twice (the
                         second order in plain PyTorch, as the JAX
                         package's is XLA)
    chgnet_conv_banded   the same with neighbour rows read through a
                         supercell's routing band (replaces
                         ``chgnet_conv_fused_banded`` /
                         ``_conv_kernel_banded``), forward only
    chgnet_conv_bwd      its backward, for forces and relaxation (replaces
                         ``_conv_bwd_pallas`` / ``_conv_bwd_kernel``)

The function, per edge e = (i, m) with neighbour j = nbr[e]:

    pre    = ai2[i] + aj2[j] + be[e] @ w2                 (2F,) core | gate
    h0     = silu(pre)
    core   = silu(LN_c(h0[:F] @ wc1 + bc1))
    gate   = sigmoid(LN_g(h0[F:] @ wg1 + bg1))
    agg[i] = sum_m core * gate * bw[e] * maskf[e]

where ai2 / aj2 are the per-atom pre-activations of the centre and
neighbour thirds of the gated MLP's first layer (its biases folded into
ai2), and LN a LayerNorm with gain row 0 and bias row 1 of lnc / lng. The
JAX package multiplies h0 by zero-extended (2F, F) second-layer weights (a
TPU lane-layout device); here wc1 and wg1 are the live (F, F) halves.

Every op is batched over chains C on the leading axis: ai2 / aj2
(C, n_pad, 2F), be / bw (C, E, F), maskf (C, E), nbr (C, E) int32 with
E = n_pad * M; the weights carry no chain axis (CHGNet is one model). A
wrapper takes the plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device; there is no fallback between the two.
The kernels (``csrc/chgnet_conv*.cu``) are built at first use
(``ops/cuda_build.py``).

Limits of the kernels, refused before a launch (``_check_kernel``):

- F = 64 (``KERNEL_F``): the kernels are built for one width, that of every
  CHGNet checkpoint the repo loads (the weights are staged in tensor-core
  fragment order for it).
- M at most 256 slots a centre (``KERNEL_MAX_M``): the slot lists, ballots
  and tile sums of a centre are sized by a compile-time capacity, built
  twice, 128 (every system of the repo; ``lamno3_001_chgnet`` defaults to
  M = 96) and 256; the C entries pick the smaller one that holds M.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tnf

from surface_sampling_tpu_torch.ops.banding import (
    DeviceBand,
    assert_in_window,
    edge_window_starts,
    window_rows,
)
from surface_sampling_tpu_torch.ops.cuda_build import check_inputs, launch
from surface_sampling_tpu_torch.ops.neighbors import _GatherRows
from surface_sampling_tpu_torch.ops.painn_kernels import _first_order_only

# the kernels' width: one checkpoint's atom features (F = 64)
KERNEL_F = 64
# slots a centre the kernels take: the larger of the two slot-list
# capacities they are built with (csrc/chgnet_conv.cuh, capacity_for)
KERNEL_MAX_M = 256
# chains: the grid limit of row 12's neighbour pass (a block per row and chain)
MAX_CHAINS = 65535
# edges per block of the weight-gradient pass (also sizes its partial sums)
WGRAD_EDGES_PER_BLOCK = 2048
GRAD_NAMES = ("g_ai2", "g_aj2", "g_be", "g_bw", "g_w2", "g_wc1", "g_wg1", "g_bc1", "g_bg1",
              "g_lnc", "g_lng")


def layer_norm(p: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with gain p[0] and bias p[1]."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p[0] + p[1]


def _conv_of_rows(ai2, ajr, be, bw, maskf, w2, wc1, wg1, bc1, bg1, lnc, lng):
    """The conv from each edge's neighbour row ajr (C, E, 2F)."""
    C, n_pad, F2 = ai2.shape
    F = F2 // 2
    M = be.shape[1] // n_pad
    h0 = tnf.silu(ai2.repeat_interleave(M, dim=1) + ajr + be @ w2)
    core = tnf.silu(layer_norm(lnc, h0[..., :F] @ wc1 + bc1))
    gate = torch.sigmoid(layer_norm(lng, h0[..., F:] @ wg1 + bg1))
    msg = core * gate * bw * maskf[..., None]
    return msg.reshape(C, n_pad, M, F).sum(dim=2)


def _gather_rows(table, row):
    C, E = row.shape
    return torch.gather(table, 1, row.long()[..., None].expand(C, E, table.shape[-1]))


def chgnet_conv_plain(ai2, aj2, be, bw, maskf, nbr, w2, wc1, wg1, bc1, bg1, lnc, lng):
    """Plain PyTorch version of :func:`chgnet_conv` (the JAX package's
    ``_conv_ref``, batched over chains)."""
    return _conv_of_rows(ai2, _gather_rows(aj2, nbr), be, bw, maskf, w2, wc1, wg1, bc1, bg1,
                         lnc, lng)


def _check_conv(name, ai2, n_tab, be, bw, maskf, nbr, weights, aj2):
    C, n_pad, F2 = ai2.shape
    F = F2 // 2
    E = be.shape[1]
    f32 = torch.float32
    w2, wc1, wg1, bc1, bg1, lnc, lng = weights
    check_inputs(name, ai2.device,
                 ai2=(ai2, f32, (C, n_pad, F2)), aj2=(aj2, f32, (C, n_tab, F2)),
                 be=(be, f32, (C, E, F)), bw=(bw, f32, (C, E, F)), maskf=(maskf, f32, (C, E)),
                 nbr=(nbr, torch.int32, (C, E)), w2=(w2, f32, (F, F2)), wc1=(wc1, f32, (F, F)),
                 wg1=(wg1, f32, (F, F)), bc1=(bc1, f32, (F,)), bg1=(bg1, f32, (F,)),
                 lnc=(lnc, f32, (2, F)), lng=(lng, f32, (2, F)))
    if E % n_pad:
        raise ValueError(f"{name}: {E} edges are not M per each of {n_pad} rows")


def _check_kernel(name, C, n_pad, M, F, *tensors):
    """What the kernels take, refused before a launch: F = 64, at most
    KERNEL_MAX_M slots a centre, at most MAX_CHAINS chains, fewer than 2^31
    (chain, centre) items, and tensors that start on a 16-byte boundary
    (rows are read and written as 16-byte vectors)."""
    if F != KERNEL_F:
        raise ValueError(f"{name}: the kernel is built for F = {KERNEL_F}, got {F}")
    if M > KERNEL_MAX_M:
        raise ValueError(f"{name}: M={M} slots a centre, the kernel takes at most "
                         f"KERNEL_MAX_M = {KERNEL_MAX_M}")
    if C > MAX_CHAINS:
        raise ValueError(f"{name}: C={C} must be at most {MAX_CHAINS} (grid limit)")
    if C * n_pad >= 2 ** 31:
        raise ValueError(f"{name}: {C} x {n_pad} (chain, centre) items exceed the work list")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: every row tensor must start on a 16-byte boundary")


def _n_sm(dev) -> int:
    """The card's SMs: the kernels size their grids by it (a few resident
    blocks an SM, each staging the weights once, walking a work list)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _conv_forward(ai2, aj2, be, bw, maskf, nbr, *weights):
    name = "chgnet_conv"
    C, n_pad, F2 = ai2.shape
    _check_conv(name, ai2, n_pad, be, bw, maskf, nbr, weights, aj2)
    if ai2.device.type == "cpu":
        return chgnet_conv_plain(ai2, aj2, be, bw, maskf, nbr, *weights)
    M = be.shape[1] // n_pad
    _check_kernel(name, C, n_pad, M, F2 // 2, ai2, aj2, be, bw)
    agg = torch.empty((C, n_pad, F2 // 2), dtype=torch.float32, device=ai2.device)
    launch(name, (ai2, aj2, be, bw, maskf, nbr, *weights, agg),
           (C, n_pad, M, F2 // 2, _n_sm(ai2.device)))
    chgnet_conv.launches += 1
    return agg


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ai2, aj2, be, bw, maskf, nbr, w2, wc1, wg1, bc1, bg1, lnc, lng, rev):
        ctx.save_for_backward(ai2, aj2, be, bw, maskf, nbr, w2, wc1, wg1, bc1, bg1, lnc, lng)
        ctx.rev = rev
        return _conv_forward(ai2, aj2, be, bw, maskf, nbr, w2, wc1, wg1, bc1, bg1, lnc, lng)

    @staticmethod
    def backward(ctx, gagg):
        need = ctx.needs_input_grad
        g = _ConvBwd.apply(*ctx.saved_tensors, gagg.contiguous(), ctx.rev, any(need[6:13]))
        g_in = (*need[:4], *need[6:13])
        g = [x if n else None for x, n in zip(g, g_in)]
        return (*g[:4], None, None, *g[4:], None)


def _conv_routed(ai2, aj2, be, bw, maskf, nbr, rev, *weights):
    """:func:`chgnet_conv_plain` with the neighbour rows gathered through
    the reverse table ``rev`` (``ops.neighbors._GatherRows``), whose
    backward sums each row's incoming edges in the table's fixed order
    instead of a float scatter-add with atomics; a plain gather when
    ``rev`` is None (the CPU, where the scatter is sequential)."""
    if rev is None:
        ajr = _gather_rows(aj2, nbr)
    else:
        C, n_pad = ai2.shape[:2]
        nbr_j = nbr.long().reshape(C, n_pad, -1)
        ajr = _GatherRows.apply(aj2, nbr_j, rev).reshape(C, -1, aj2.shape[-1])
    return _conv_of_rows(ai2, ajr, be, bw, maskf, *weights)


class _ConvBwd(torch.autograd.Function):
    """:func:`chgnet_conv_bwd` as a differentiable op: the backward of
    ``_Conv``, and under ``create_graph`` a node of the outer graph whose
    backward is the double VJP of the plain conv (the JAX package's
    ``_conv_bwd_op``: its first order is the fused kernel, its second order
    XLA's double VJP of ``_conv_ref``), in plain PyTorch. The neighbour
    gather of that double VJP sums its cotangents through ``rev`` in a
    fixed order (:func:`_conv_routed`), so that a force-loss gradient
    repeats bitwise on the card. ``maskf`` and ``nbr`` get no gradient; the
    weight cotangents are outputs only when ``want_weights``. Differentiable
    twice in all: a third order raises."""

    @staticmethod
    def forward(ctx, ai2, aj2, be, bw, maskf, nbr, w2, wc1, wg1, bc1, bg1, lnc, lng, gagg, rev,
                want_weights):
        ctx.save_for_backward(ai2, aj2, be, bw, maskf, nbr, w2, wc1, wg1, bc1, bg1, lnc, lng,
                              gagg)
        ctx.rev = rev
        ctx.set_materialize_grads(False)
        return chgnet_conv_bwd(ai2, aj2, be, bw, maskf, nbr, w2, wc1, wg1, bc1, bg1, lnc, lng,
                               gagg, rev=rev, want_weights=want_weights)

    @staticmethod
    def backward(ctx, *cts):
        saved = ctx.saved_tensors
        maskf, nbr = saved[4], saved[5]
        diff = (*saved[:4], *saved[6:])                  # the 11 inputs of the conv, gagg
        need = ctx.needs_input_grad
        need_in = (*need[:4], *need[6:14])
        outs = [k for k, ct in enumerate(cts) if ct is not None]
        wrt = [k for k, n in enumerate(need_in) if n]
        res = [None] * len(diff)
        if outs and wrt:
            with torch.enable_grad():
                xs = [t.detach().requires_grad_(True) for t in diff]
                agg = _conv_routed(*xs[:4], maskf, nbr, ctx.rev, *xs[4:11])
                g = torch.autograd.grad(agg, [xs[k] for k in outs], xs[11], create_graph=True)
                got = torch.autograd.grad(g, [xs[k] for k in wrt], [cts[k] for k in outs],
                                          allow_unused=True)
            for k, x in zip(wrt, got):
                res[k] = None if x is None else x.detach()
        res = _first_order_only(
            res, (*saved, *cts),
            "chgnet_conv is differentiable twice: the double VJP of its backward has no VJP")
        return (*res[:4], None, None, *res[4:], None, None)


def chgnet_conv(ai2, aj2, be, bw, maskf, nbr, w2, wc1, wg1, bc1, bg1, lnc, lng, rev=None):
    """The fused CHGNet atom conv (module docstring), batched over chains,
    differentiable in every float input but ``maskf``.

    Args:
        ai2, aj2: (C, n_pad, 2F) f32 centre / neighbour pre-activations.
        be, bw: (C, E, F) f32 bond embeddings and bond weights per edge.
        maskf: (C, E) f32 edge mask (0 kills dead and padded edges).
        nbr: (C, E) int32 neighbour row of every edge.
        w2: (F, 2F); wc1, wg1: (F, F); bc1, bg1: (F,); lnc, lng: (2, F).
        rev: (C, n_pad, D) int32 reverse-neighbour table of the edges
            (``ops.neighbors.reverse_table``, the ``rev`` of the edges) for
            the backward; the kernel needs it, the plain version on the CPU
            does not.
    Returns:
        agg (C, n_pad, F).

    The backward launches :func:`chgnet_conv_bwd` (the plain version on
    the CPU), and is differentiable in turn (``_ConvBwd``): force-loss
    training differentiates the forces, whose second order is the double
    VJP of the plain conv, as in the JAX package.
    """
    return _Conv.apply(ai2, aj2, be, bw, maskf, nbr, w2, wc1, wg1, bc1, bg1, lnc, lng, rev)


chgnet_conv.launches = 0


# ----------------------------------------------------------------------
# Banded conv (supercells): rows in the routing band's sorted order
# ----------------------------------------------------------------------
def chgnet_conv_banded_plain(ai2, aj2_ext, be, bw, maskf, nbr, w2, wc1, wg1, bc1, bg1, lnc,
                             lng, band: DeviceBand):
    """Plain PyTorch version of :func:`chgnet_conv_banded`."""
    M = be.shape[1] // ai2.shape[1]
    row, inwin = window_rows(nbr, edge_window_starts(band, M)[None], band)
    assert_in_window(maskf != 0, inwin)
    ajr = _gather_rows(aj2_ext, row) * inwin[..., None]
    return _conv_of_rows(ai2, ajr, be, bw, maskf, w2, wc1, wg1, bc1, bg1, lnc, lng)


def chgnet_conv_banded(ai2, aj2_ext, be, bw, maskf, nbr, w2, wc1, wg1, bc1, bg1, lnc, lng,
                       band: DeviceBand):
    """The CHGNet atom conv of a supercell (:func:`chgnet_conv`'s math) with
    the neighbour's row read through the routing band's window: for sorted
    centre i, s = band.win_start[i // band.n_blk] and the neighbour of rank
    r is row s + ((r - s) mod n_pad) of the halo-extended table; a rank
    outside [s, s + W) reads zeros. Forward only, as in the JAX package (the
    rigid MC path): inputs that require grad raise.

    Args:
        ai2: (C, n_pad, 2F) in sorted order; aj2_ext: (C, n_pad + halo, 2F)
            sorted with the halo appended.
        be, bw (C, E, F), maskf (C, E): sorted-order edges; nbr (C, E) int32
            sorted ranks.
        w2 .. lng: as in :func:`chgnet_conv`.
        band: the ``ops.banding.DeviceBand``.
    Returns:
        agg (C, n_pad, F) in sorted order.
    """
    name = "chgnet_conv_banded"
    weights = (w2, wc1, wg1, bc1, bg1, lnc, lng)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (ai2, aj2_ext, be, bw, *weights)):
        raise NotImplementedError(f"{name} is forward only, as the JAX package's banded conv: "
                                  "forces of a supercell run the unbanded conv")
    C, n_pad, F2 = ai2.shape
    if n_pad != band.n_pad:
        raise ValueError(f"{name}: {n_pad} centre rows, the band covers {band.n_pad}")
    n_ext = band.n_pad + band.halo
    _check_conv(name, ai2, n_ext, be, bw, maskf, nbr, weights, aj2_ext)
    check_inputs(name, ai2.device,
                 win_start=(band.win_start, torch.int32, (n_pad // band.n_blk,)))
    if ai2.device.type == "cpu":
        return chgnet_conv_banded_plain(ai2, aj2_ext, be, bw, maskf, nbr, *weights, band)
    M = be.shape[1] // n_pad
    _check_kernel(name, C, n_pad, M, F2 // 2, ai2, aj2_ext, be, bw)
    agg = torch.empty((C, n_pad, F2 // 2), dtype=torch.float32, device=ai2.device)
    launch(name, (ai2, aj2_ext, be, bw, maskf, nbr, *weights, band.win_start, agg),
           (C, n_pad, n_ext, M, F2 // 2, _n_sm(ai2.device), band.n_blk, band.window))
    chgnet_conv_banded.launches += 1
    return agg


chgnet_conv_banded.launches = 0


# ----------------------------------------------------------------------
# Backward
# ----------------------------------------------------------------------
def chgnet_conv_bwd_plain(ai2, aj2, be, bw, maskf, nbr, w2, wc1, wg1, bc1, bg1, lnc, lng, gagg,
                          want_weights=True):
    """Plain PyTorch version of :func:`chgnet_conv_bwd`: the VJP of
    :func:`chgnet_conv_plain` by autograd (the JAX package's ``jax.vjp``
    of ``_conv_ref``)."""
    weights = (w2, wc1, wg1, bc1, bg1, lnc, lng)
    diff = (ai2, aj2, be, bw) + (weights if want_weights else ())
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(True) for t in diff]
        w = xs[4:] if want_weights else weights
        out = chgnet_conv_plain(xs[0], xs[1], xs[2], xs[3], maskf, nbr, *w)
        g = torch.autograd.grad(out, xs, gagg)
    return tuple(g) + ((None,) * 7 if not want_weights else ())


def chgnet_conv_bwd(ai2, aj2, be, bw, maskf, nbr, w2, wc1, wg1, bc1, bg1, lnc, lng, gagg,
                    rev=None, want_weights=False):
    """Cotangents of every float input of :func:`chgnet_conv` but maskf,
    batched over chains.

    Args:
        ai2 .. lng: the forward's inputs.
        gagg: (C, n_pad, F) cotangent of agg.
        rev: (C, n_pad, D) int32 reverse-neighbour table: row j lists the
            ids of the edges whose neighbour is j, ascending, then -1
            (``ops.neighbors.reverse_table``). Edges left out must have
            maskf == 0; it may also list masked edges (the kernel skips
            them).
            Required on the card, unused by the plain version.
        want_weights: also return the seven weight cotangents (summed over
            every edge and chain); else they are None and that pass of the
            kernel does not run.
    Returns:
        g_ai2, g_aj2 (C, n_pad, 2F), g_be, g_bw (C, E, F), then g_w2 (F, 2F),
        g_wc1, g_wg1 (F, F), g_bc1, g_bg1 (F,), g_lnc, g_lng (2, F) or Nones.
    """
    name = "chgnet_conv_bwd"
    weights = (w2, wc1, wg1, bc1, bg1, lnc, lng)
    C, n_pad, F2 = ai2.shape
    F = F2 // 2
    E = be.shape[1]
    M = E // n_pad
    dev = ai2.device
    _check_conv(name, ai2, n_pad, be, bw, maskf, nbr, weights, aj2)
    check_inputs(name, dev, gagg=(gagg, torch.float32, (C, n_pad, F)))
    if dev.type == "cpu":
        return chgnet_conv_bwd_plain(ai2, aj2, be, bw, maskf, nbr, *weights, gagg,
                                     want_weights=want_weights)
    _check_kernel(name, C, n_pad, M, F, ai2, aj2, be, bw, gagg)
    if rev is None:
        raise ValueError(f"{name}: the kernel needs the edges' reverse table rev")
    D = rev.shape[-1]
    check_inputs(name, dev, rev=(rev, torch.int32, (C, n_pad, D)))
    f32 = torch.float32
    g_ai2, g_aj2 = torch.empty_like(ai2), torch.empty_like(aj2)
    g_be, g_bw = torch.empty_like(be), torch.empty_like(bw)
    dpre = torch.empty((C, E, F2), dtype=f32, device=dev)   # written for live edges only
    h0 = dh = lnpart = wpart = None
    if want_weights:
        n_wblk = -(-(C * E) // WGRAD_EDGES_PER_BLOCK)
        h0, dh = torch.empty_like(dpre), torch.empty_like(dpre)
        lnpart = torch.empty((C * n_pad, 4 * F), dtype=f32, device=dev)   # per centre
        wpart = torch.empty((n_wblk, F * F2 + 2 * F * F + 2 * F), dtype=f32, device=dev)
    launch(name, (ai2, aj2, be, bw, maskf, nbr, *weights, gagg, rev, g_ai2, g_aj2, g_be, g_bw,
                  dpre, h0, dh, lnpart, wpart),
           (C, n_pad, M, F, D, int(want_weights), _n_sm(dev), WGRAD_EDGES_PER_BLOCK))
    chgnet_conv_bwd.launches += 1
    if not want_weights:
        return g_ai2, g_aj2, g_be, g_bw, *(None,) * 7
    chgnet_conv_bwd.weight_launches += 1
    ln = lnpart.sum(dim=0)                      # per-centre partials, one fixed order
    w = wpart.sum(dim=0)
    sizes = (F * F2, F * F, F * F, F, F)
    g_w2, g_wc1, g_wg1, g_bc1, g_bg1 = torch.split(w, sizes)
    return (g_ai2, g_aj2, g_be, g_bw, g_w2.reshape(F, F2), g_wc1.reshape(F, F),
            g_wg1.reshape(F, F), g_bc1, g_bg1, ln[:2 * F].reshape(2, F), ln[2 * F:].reshape(2, F))


chgnet_conv_bwd.launches = 0
chgnet_conv_bwd.weight_launches = 0   # launches that also computed the weight cotangents


WRAPPERS = (chgnet_conv, chgnet_conv_banded, chgnet_conv_bwd)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    chgnet_conv_bwd.weight_launches = 0


def launch_counts() -> dict[str, int]:
    counts = {fn.__name__: fn.launches for fn in WRAPPERS}
    counts["chgnet_conv_bwd.weights"] = chgnet_conv_bwd.weight_launches
    return counts
