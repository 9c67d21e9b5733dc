"""The PaiNN blocks of the MC and relaxation paths: CUDA kernels for
Hopper, their plain PyTorch versions, launch counters, and the build.

Each block replaces a Pallas TPU kernel of
``surface_sampling_tpu/ops/pallas_painn.py``:

    painn_message_l1     layer-1 message from a per-species phi table
                         (replaces ``painn_message_l1`` / ``_msg_kernel_l1``)
    painn_message_fused  general message, layers 2+
                         (replaces ``painn_message_fused`` / ``_msg_kernel``)
    painn_update_fused   update block, every layer
                         (replaces ``painn_update_fused`` / ``_upd_kernel``)
    painn_message_bwd    backward of the general message, for forces and
                         relaxation (replaces ``_message_bwd_pallas`` /
                         ``_msg_bwd_kernel``); ``painn_message_fused`` is a
                         ``torch.autograd.Function`` whose backward
                         launches it
    painn_message_bwd2   the VJP of painn_message_bwd, for force-loss
                         training (replaces ``_message_bwd2_pallas`` /
                         ``_msg_bwd2_kernel``); the message backward is a
                         ``torch.autograd.Function`` whose backward
                         launches it, so ``painn_message_fused`` can be
                         differentiated twice
    painn_message_l1_banded     the layer-1 message of a supercell, neighbour
                                rows read through the routing band's window
                                (replaces ``painn_message_l1_banded``)
    painn_message_fused_banded  the general message of a supercell
                                (replaces ``_message_pallas_banded``), a
                                ``torch.autograd.Function`` whose backward
                                launches
    painn_message_bwd_banded    its backward, for forces and relaxation of
                                supercells (replaces
                                ``_message_bwd_pallas_banded``)
    painn_message_subset        the banded general message over selected
                                blocks of centres, per chain: the delta
                                engine's hot op, forward only (replaces
                                ``painn_message_subset``)

Every function is batched over chains C and ensemble members K in one
call: edge geometry is indexed by chain (rbf (C, E, R), envm and nbr
(C, E), unit (C, 3, n_pad, M), E = n_pad * M), weights by member, and
features by both ((C, K, n_pad, .)). Vector features and the dv outputs
are x-major rows of width 3F, [x | y | z], the JAX kernels' ``vcat``
layout (their dv (3, n_pad, F) concatenated along features).

The banded blocks take the tables of a supercell in the routing band's
sorted order (``ops/banding.py``): features extended by the band's halo
((C, K, n_pad + halo, .)), neighbour indices as sorted ranks, and the band
(a ``DeviceBand``) for the window starts and width.

A wrapper takes the plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device; there is no fallback between the two.
The kernels are built from ``csrc/<name>.cu`` (and the ``csrc/*.cuh``
headers they share) at first use and bound with ctypes through a plain C
interface (``ops/cuda_build.py``).
"""

from __future__ import annotations

import torch

from surface_sampling_tpu_torch.ops.banding import (
    assert_in_window,
    banded_reverse_table,
    edge_window_starts,
    window_rows,
)
from surface_sampling_tpu_torch.ops.cuda_build import _lib
from surface_sampling_tpu_torch.ops.cuda_build import check_inputs as _check
from surface_sampling_tpu_torch.ops.cuda_build import launch as _launch
from surface_sampling_tpu_torch.ops.neighbors import reverse_table


def _check_grid(name: str, C: int, K: int, R: int | None = None) -> None:
    if C > 65535 or K > 65535:
        raise ValueError(f"{name}: C={C} and K={K} must each be at most 65535 (grid limit)")
    if R is not None and R not in (8, 16, 24, 32):
        raise ValueError(f"{name}: the radial width must be 8, 16, 24 or 32, got {R}")


# ----------------------------------------------------------------------
# Layer-1 message
# ----------------------------------------------------------------------
def _message_l1_of_species(sp_j, philt, rbf, envm, unit, dw2, db2):
    """Layer-1 message from each edge's neighbour species sp_j (C, E). A
    dead edge (envm == 0) contributes zero whatever its rbf and unit vector
    hold, NaN included, as in the kernels, which never read them."""
    C, E, _ = rbf.shape
    K, _, F2 = philt.shape
    F = F2 // 2
    n_pad, M = unit.shape[2], unit.shape[3]
    live = envm != 0
    rbf = torch.where(live[..., None], rbf, 0.0)
    unit = torch.where(live.reshape(C, 1, n_pad, M), unit, 0.0)
    w = (torch.matmul(rbf[:, None], dw2) + db2[None, :, None, :]) * envm[:, None, :, None]
    phij = philt[:, sp_j.long()].transpose(0, 1)                    # (C, K, E, 2F)
    inv = phij * w
    c_s = inv[..., :F].reshape(C, K, n_pad, M, F)
    c_u = inv[..., F:].reshape(C, K, n_pad, M, F)
    ds = c_s.sum(dim=3)
    dv = torch.einsum("ckimf,cxim->ckixf", c_u, unit).reshape(C, K, n_pad, 3 * F)
    return ds, dv


def painn_message_l1_plain(species, philt, rbf, envm, nbr, unit, dw2, db2):
    """Plain PyTorch version of :func:`painn_message_l1`."""
    sp_j = torch.gather(species, 1, nbr.long())                     # (C, E)
    return _message_l1_of_species(sp_j, philt, rbf, envm, unit, dw2, db2)


def painn_message_l1(species, philt, rbf, envm, nbr, unit, dw2, db2):
    """Layer-1 PaiNN message, batched over chains and members.

    At layer 1, v == 0 (the vv channels and the v_j term vanish) and s is
    the alive-masked atom embedding, so phi_j is one of a few per-species
    rows. Per edge e = (i, m) with neighbor j = nbr[e]:

        w   = (rbf[e] @ dw2 + db2) * envm[e]                 (2F,)  s | unit
        c   = philt[species[j]] * w
        ds_i   = sum_m c_s
        dv_i,x = sum_m c_unit * unit[x, i, m]

    Args:
        species: (C, n_pad) int32 row of ``philt`` per slot (T = dead/pad).
        philt: (K, T+1, 2F) f32 layer-1 phi per species, s|unit channels;
            row T zero.
        rbf: (C, E, R) f32; envm, nbr: (C, E) f32 / int32;
        unit: (C, 3, n_pad, M) f32.
        dw2, db2: (K, R, 2F), (K, 2F) f32 dist_embed weights, s|unit channels.
    Returns:
        ds (C, K, n_pad, F), dv (C, K, n_pad, 3F) x-major.

    The kernel (``csrc/painn_message_l1.cu``) is row 6's species-binned body
    on an identity band: it bins each centre's live edges (envm != 0) by
    their neighbour's species, once for all members, and multiplies each
    bin by the member's filter columns, every sum in one fixed order; it
    never reads a dead edge's rbf, unit vector or neighbour index. A centre
    gets bitwise what :func:`painn_message_l1_banded` gives it on
    ``ops.banding.identity_band``. It takes R of 8, 16 or 24 and at most 32
    species rows (:func:`_check_layer1_kernel`), refused before a launch.
    """
    C, E, R = rbf.shape
    K, T1, F2 = philt.shape
    F = F2 // 2
    n_pad = species.shape[1]
    M = E // n_pad
    f32, i32 = torch.float32, torch.int32
    dev = rbf.device
    _check("painn_message_l1", dev,
           species=(species, i32, (C, n_pad)), philt=(philt, f32, (K, T1, F2)),
           rbf=(rbf, f32, (C, n_pad * M, R)), envm=(envm, f32, (C, E)),
           nbr=(nbr, i32, (C, E)), unit=(unit, f32, (C, 3, n_pad, M)),
           dw2=(dw2, f32, (K, R, F2)), db2=(db2, f32, (K, F2)))
    if dev.type == "cpu":
        return painn_message_l1_plain(species, philt, rbf, envm, nbr, unit, dw2, db2)
    _check_layer1_kernel("painn_message_l1", C, K, R, T1)
    ds = torch.empty((C, K, n_pad, F), dtype=f32, device=dev)
    dv = torch.empty((C, K, n_pad, 3 * F), dtype=f32, device=dev)
    _launch("painn_message_l1",
            (species, philt, rbf, envm, nbr, unit, dw2, db2, ds, dv),
            (C, K, n_pad, M, R, F, T1))
    painn_message_l1.launches += 1
    return ds, dv


painn_message_l1.launches = 0


# ----------------------------------------------------------------------
# General message (layers 2+)
# ----------------------------------------------------------------------
def _message_of_rows(phij, vj, rbf, envm, unit, dw, db):
    """General message from each edge's neighbour rows phij, vj
    (C, K, E, 3F)."""
    C, K, E, F3 = phij.shape
    F = F3 // 3
    n_pad, M = unit.shape[2], unit.shape[3]
    w = (torch.matmul(rbf[:, None], dw) + db[None, :, None, :]) * envm[:, None, :, None]
    inv = phij * w
    c_vv = inv[..., :F].reshape(C, K, n_pad, M, F)
    c_s = inv[..., F:2 * F].reshape(C, K, n_pad, M, F)
    c_u = inv[..., 2 * F:].reshape(C, K, n_pad, M, F)
    ds = c_s.sum(dim=3)
    dv = [
        (c_u * unit[:, None, x, :, :, None]
         + c_vv * vj[..., x * F:(x + 1) * F].reshape(C, K, n_pad, M, F)).sum(dim=3)
        for x in range(3)
    ]
    return ds, torch.cat(dv, dim=-1)


def painn_message_fused_plain(phi, vcat, rbf, envm, nbr, unit, dw, db):
    """Plain PyTorch version of :func:`painn_message_fused`."""
    C, K, _, F3 = phi.shape
    idx = nbr.long()[:, None, :, None].expand(C, K, nbr.shape[1], F3)
    return _message_of_rows(torch.gather(phi, 2, idx), torch.gather(vcat, 2, idx),
                            rbf, envm, unit, dw, db)


def painn_message_fused(phi, vcat, rbf, envm, nbr, unit, dw, db, rev=None):
    """General PaiNN message block, batched over chains and members,
    differentiable in every float input. Per edge e = (i, m) with neighbor
    j = nbr[e]:

        w   = (rbf[e] @ dw + db) * envm[e]                   (3F,) vv | s | unit
        c   = phi[j] * w
        ds_i   = sum_m c_s
        dv_i,x = sum_m (c_unit * unit[x, i, m] + c_vv * v_j,x)

    Args:
        phi: (C, K, n_pad, 3F) f32 per-atom filter features.
        vcat: (C, K, n_pad, 3F) f32 vector features, x-major.
        rbf, envm, nbr, unit: edge geometry as in :func:`painn_message_l1`.
        dw, db: (K, R, 3F), (K, 3F) f32 dist_embed weights.
        rev: optional (C, n_pad, D) int32 reverse-neighbor table of the
            edges (``ops.neighbors.reverse_table``) for the backward; built
            from ``nbr`` and ``envm != 0`` when a backward needs it and it
            is not given.
    Returns:
        ds (C, K, n_pad, F), dv (C, K, n_pad, 3F) x-major.

    The backward launches :func:`painn_message_bwd` (the plain version on
    the CPU) through ``_MessageBwd``, whose own backward launches
    :func:`painn_message_bwd2`: the block is twice differentiable, as
    force-loss training needs (grad over parameters of a loss holding
    F = -dE/dx). A third order raises.

    The kernel (``csrc/painn_message_fused.cu``) is the banded message's
    body on an identity band: it sums each centre's live edges (envm != 0)
    only, in one fixed order, giving a centre the bits
    :func:`painn_message_fused_banded` gives it on an identity band; a dead
    edge's rbf, unit and nbr are never read. It takes R of 8, 16 or 24 and
    F a multiple of 16 (:func:`_check_banded_kernel`), refused before a
    launch.
    """
    return _MessageFused.apply(phi, vcat, rbf, envm, nbr, unit, dw, db, rev)


def _message_fused_forward(phi, vcat, rbf, envm, nbr, unit, dw, db):
    C, K, n_pad, F3 = phi.shape
    F = F3 // 3
    E, R = rbf.shape[1], rbf.shape[2]
    M = E // n_pad
    f32, i32 = torch.float32, torch.int32
    dev = phi.device
    _check("painn_message_fused", dev,
           phi=(phi, f32, (C, K, n_pad, F3)), vcat=(vcat, f32, (C, K, n_pad, F3)),
           rbf=(rbf, f32, (C, n_pad * M, R)), envm=(envm, f32, (C, E)),
           nbr=(nbr, i32, (C, E)), unit=(unit, f32, (C, 3, n_pad, M)),
           dw=(dw, f32, (K, R, F3)), db=(db, f32, (K, F3)))
    if dev.type == "cpu":
        return painn_message_fused_plain(phi, vcat, rbf, envm, nbr, unit, dw, db)
    _check_banded_kernel("painn_message_fused", C, K, R, F, phi, vcat, rbf, db)
    ds = torch.empty((C, K, n_pad, F), dtype=f32, device=dev)
    dv = torch.empty((C, K, n_pad, F3), dtype=f32, device=dev)
    _launch("painn_message_fused",
            (phi, vcat, rbf, envm, nbr, unit, dw, db, ds, dv),
            (C, K, n_pad, M, R, F))
    painn_message_fused.launches += 1
    return ds, dv


class _MessageFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, phi, vcat, rbf, envm, nbr, unit, dw, db, rev):
        ctx.save_for_backward(phi, vcat, rbf, envm, nbr, unit, dw, db)
        ctx.rev = rev
        return _message_fused_forward(phi, vcat, rbf, envm, nbr, unit, dw, db)

    @staticmethod
    def backward(ctx, gds, gdv):
        need = ctx.needs_input_grad
        g = _MessageBwd.apply(*ctx.saved_tensors, gds.contiguous(), gdv.contiguous(), ctx.rev,
                              need[6] or need[7])
        g_phi, g_vcat, g_rbf, g_envm, g_unit, g_dw, g_db = (
            x if n else None for x, n in zip(g, (*need[:4], need[5], need[6], need[7])))
        return g_phi, g_vcat, g_rbf, g_envm, None, g_unit, g_dw, g_db, None


class _MessageBwd(torch.autograd.Function):
    """:func:`painn_message_bwd` as a differentiable op: the backward of
    ``_MessageFused``, and under ``create_graph`` a node of the outer graph
    whose backward launches :func:`painn_message_bwd2` (the JAX package's
    ``_message_bwd_op``). Cotangents of outputs nobody consumed arrive as
    None: the c_dw / c_db of force-loss training, which lets the second-order
    kernel skip their terms. The reverse table ``rev`` serves both orders,
    so an edge it leaves out must have envm == 0 and, in the second order,
    a zero cotangent of g_envm too (see :func:`painn_message_bwd2`)."""

    @staticmethod
    def forward(ctx, phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv, rev, want_dw):
        ctx.save_for_backward(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv)
        ctx.rev = rev
        ctx.set_materialize_grads(False)
        return painn_message_bwd(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv, rev=rev,
                                 want_dw=want_dw)

    @staticmethod
    def backward(ctx, cphi, cvcat, crbf, cenvm, cunit, cdw, cdb):
        phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv = ctx.saved_tensors

        def given(ct, like):
            return torch.zeros_like(like) if ct is None else ct.contiguous()

        with torch.no_grad():
            d = painn_message_bwd2(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv,
                                   given(cphi, phi), given(cvcat, vcat), given(crbf, rbf),
                                   given(cenvm, envm), given(cunit, unit),
                                   None if cdw is None else cdw.contiguous(),
                                   None if cdb is None else cdb.contiguous(), rev=ctx.rev)
        need = ctx.needs_input_grad
        d = tuple(x if n else None for x, n in zip(d, (*need[:4], need[5], *need[6:10])))
        dphi, dvcat, drbf, denvm, dunit, ddw, ddb, dgds, dgdv = _first_order_only(
            d, (*ctx.saved_tensors, cphi, cvcat, crbf, cenvm, cunit, cdw, cdb),
            "painn_message_bwd is differentiable once: its backward, painn_message_bwd2, "
            "has no VJP (nor has the JAX package's _message_bwd2_pallas)")
        return dphi, dvcat, drbf, denvm, None, dunit, ddw, ddb, dgds, dgdv, None, None


painn_message_fused.launches = 0


# ----------------------------------------------------------------------
# Backward of the general message
# ----------------------------------------------------------------------
def _message_bwd_of_rows(phi, vcat, row, inwin, rbf, envm, unit, dw, db, gds, gdv, want_dw):
    """Cotangents of the general message from explicit (C, K, E, 3F)
    per-edge tensors: edge e reads its neighbour from ``row[e]`` of the
    (C, K, n_tab, 3F) tables and its centre's cotangents from row e // M
    of gds / gdv. ``inwin`` (C, E) bool, or None: an edge outside its
    routing window reads zeros and scatters nothing. The neighbour
    cotangents are scattered by ``scatter_add_`` (no reverse table)."""
    C, K, _, F3 = phi.shape
    F = F3 // 3
    E = rbf.shape[1]
    n_pad, M = unit.shape[2], unit.shape[3]
    wpre = torch.matmul(rbf[:, None], dw) + db[None, :, None, :]     # (C, K, E, 3F)
    env = envm[:, None, :, None]
    w = wpre * env
    idx = row[:, None, :, None].expand(C, K, E, F3)
    phij = torch.gather(phi, 2, idx)
    vj = torch.gather(vcat, 2, idx)
    if inwin is not None:
        phij, vj = phij * inwin[:, None, :, None], vj * inwin[:, None, :, None]
    vj = vj.reshape(C, K, E, 3, F)
    gdv_e = gdv.repeat_interleave(M, dim=2).reshape(C, K, E, 3, F)  # center row per edge
    gds_e = gds.repeat_interleave(M, dim=2)
    u = unit.reshape(C, 3, E).transpose(1, 2)[:, None, :, :, None]   # (C, 1, E, 3, 1)
    g_inv = torch.cat([(gdv_e * vj).sum(3), gds_e, (gdv_e * u).sum(3)], dim=-1)
    g_w = g_inv * phij
    gwe = g_w * env
    c_u = phij[..., 2 * F:] * w[..., 2 * F:]
    c_vv = phij[..., :F] * w[..., :F]
    to_phi = g_inv * w
    to_vcat = (gdv_e * c_vv[..., None, :]).reshape(C, K, E, F3)
    if inwin is not None:
        to_phi = to_phi * inwin[:, None, :, None]
    g_phi = torch.zeros_like(phi).scatter_add_(2, idx, to_phi)
    g_vcat = torch.zeros_like(vcat).scatter_add_(2, idx, to_vcat)
    g_rbf = torch.matmul(gwe, dw.transpose(1, 2)).sum(1)             # (C, E, R)
    g_envm = (g_w * wpre).sum(dim=(1, 3))
    g_unit = (gdv_e * c_u[..., None, :]).sum(dim=(1, 4))             # (C, E, 3)
    g_unit = g_unit.transpose(1, 2).reshape(C, 3, n_pad, M)
    if not want_dw:
        return g_phi, g_vcat, g_rbf, g_envm, g_unit, None, None
    g_dw = torch.einsum("cer,ckef->krf", rbf, gwe)
    return g_phi, g_vcat, g_rbf, g_envm, g_unit, g_dw, gwe.sum(dim=(0, 2))


def painn_message_bwd_plain(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv,
                            want_dw=True):
    """Plain PyTorch version of :func:`painn_message_bwd`: the same
    cotangents from explicit (C, K, E, 3F) per-edge tensors, with the
    neighbor cotangents scattered by ``scatter_add_`` (it needs no reverse
    table)."""
    return _message_bwd_of_rows(phi, vcat, nbr.long(), None, rbf, envm, unit, dw, db, gds,
                                gdv, want_dw)


def _check_bwd_kernel(name, C, K, R, F):
    """Limits of rows 4 and 9: the radial width is 8, 16 or 24 (a whole
    number of the tensor-core step, and the widths the kernels are built
    for), the channels a whole number of the neighbour kernel's 16-channel
    tile. A block whose shared memory does not fit is refused by the
    launch itself."""
    _check_grid(name, C, K, R)
    if R > 24:
        raise ValueError(f"{name}: the radial width must be 8, 16 or 24, got {R}")
    if F % 16:
        raise ValueError(f"{name}: F={F} must be a multiple of 16 (the kernel's channel tile)")


def _launch_bwd(name, fn, ins, rev, ints, want_dw):
    """Allocate the cotangents of a message backward (g_phi / g_vcat shaped
    as the tables ins[0] / ins[1]), launch ``name`` on ``ins`` and the
    reverse table, and sum the g_dw / g_db partials of its blocks in one
    fixed order. ``fn`` is the wrapper whose launches are counted."""
    phi, vcat, rbf, envm, _, unit = ins[:6]
    C, K, _, F3 = phi.shape
    R = rbf.shape[2]
    n_pad = unit.shape[2]
    g = (torch.empty_like(phi), torch.empty_like(vcat), torch.empty_like(rbf),
         torch.empty_like(envm), torch.empty_like(unit))
    part = (torch.empty((C * n_pad, K, R + 1, F3), dtype=torch.float32, device=phi.device)
            if want_dw else None)
    _launch(name, (*ins, rev, *g, part), ints)
    fn.launches += 1
    if not want_dw:
        return (*g, None, None)
    fn.dw_launches += 1
    gdw = part.sum(dim=0)                       # per-block partials, one fixed order
    return (*g, gdw[:, :R].contiguous(), gdw[:, R].contiguous())


def painn_message_bwd(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv,
                      rev=None, want_dw=False):
    """Cotangents of every float input of :func:`painn_message_fused`,
    batched over chains and members.

    Args:
        phi .. db: the forward's inputs.
        gds: (C, K, n_pad, F), gdv: (C, K, n_pad, 3F) x-major, cotangents of
            ds and dv.
        rev: (C, n_pad, D) int32 reverse-neighbor table: row j lists the
            ids of the edges whose neighbor is j, ascending, then -1
            (``ops.neighbors.reverse_table``). Edges left out must have
            envm == 0. None builds it from ``nbr`` and ``envm != 0``.
        want_dw: also return g_dw (K, R, 3F) and g_db (K, 3F); else those
            two are None and that part of the kernel does not run.
    Returns:
        (g_phi, g_vcat) (C, K, n_pad, 3F), g_rbf (C, E, R), g_envm (C, E),
        g_unit (C, 3, n_pad, M), g_dw, g_db. The edge cotangents sum over
        the members: rbf, envm and unit carry no member axis.

    Dead-edge contract: the kernel computes the edges with envm != 0 only
    and gives exact zeros in g_rbf, g_unit and g_envm on the others. The
    plain version (as the JAX package) gives zeros for the first two too
    but sum_{t,f} g_w * wpre for g_envm there; that value never reaches a
    position, since envm = envelope * mask is zero through its own factors
    (``tests/test_torch_bwd_contract.py``, ROADMAP Queue 3). One shell is
    the exception: within cutoff * 2^-12 / pi below the cutoff (3.9e-4 A
    at 5 A) the f32 envelope rounds to exactly 0 while its slope is up to
    2^-13 * pi / cutoff (7.7e-5 per A at 5 A), so for an edge there the
    kernel drops at most |g_envm| x 7.7e-5 eV/A from the forces that the
    plain version keeps.

    The kernel takes R of 8, 16 or 24 and F a multiple of 16; a block
    whose shared memory (M edge slots, a reverse table D wide) does not
    fit is refused at the launch.
    """
    C, K, n_pad, F3 = phi.shape
    F = F3 // 3
    E, R = rbf.shape[1], rbf.shape[2]
    M = E // n_pad
    f32, i32 = torch.float32, torch.int32
    dev = phi.device
    _check("painn_message_bwd", dev,
           phi=(phi, f32, (C, K, n_pad, F3)), vcat=(vcat, f32, (C, K, n_pad, F3)),
           rbf=(rbf, f32, (C, n_pad * M, R)), envm=(envm, f32, (C, E)),
           nbr=(nbr, i32, (C, E)), unit=(unit, f32, (C, 3, n_pad, M)),
           dw=(dw, f32, (K, R, F3)), db=(db, f32, (K, F3)),
           gds=(gds, f32, (C, K, n_pad, F)), gdv=(gdv, f32, (C, K, n_pad, F3)))
    if dev.type == "cpu":
        return painn_message_bwd_plain(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv,
                                       want_dw=want_dw)
    _check_bwd_kernel("painn_message_bwd", C, K, R, F)
    if rev is None:
        rev = reverse_table(nbr, envm != 0, n_pad)
    D = rev.shape[-1]
    _check("painn_message_bwd", dev, rev=(rev, i32, (C, n_pad, D)))
    return _launch_bwd("painn_message_bwd", painn_message_bwd,
                       (phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv),
                       rev, (C, K, n_pad, M, R, F, D, int(want_dw)), want_dw)


painn_message_bwd.launches = 0
painn_message_bwd.dw_launches = 0   # launches that also computed g_dw / g_db


# ----------------------------------------------------------------------
# Second-order backward of the general message
# ----------------------------------------------------------------------
def painn_message_bwd2_plain(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv,
                             cphi, cvcat, crbf, cenvm, cunit, cdw=None, cdb=None):
    """Plain PyTorch version of :func:`painn_message_bwd2`: the VJP of
    :func:`painn_message_bwd_plain` taken by ``torch.autograd.grad``,
    independent of the kernel's hand derivation. Every term is kept: a None
    c_dw / c_db counts as zeros."""
    with torch.enable_grad():
        x = [t.detach().requires_grad_(True)
             for t in (phi, vcat, rbf, envm, unit, dw, db, gds, gdv)]
        p, v, r, e, u, w, b, gs, gv = x
        outs = painn_message_bwd_plain(p, v, r, e, nbr, u, w, b, gs, gv, want_dw=True)
        cots = (cphi, cvcat, crbf, cenvm, cunit,
                torch.zeros_like(dw) if cdw is None else cdw,
                torch.zeros_like(db) if cdb is None else cdb)
        d = torch.autograd.grad(outs, x, cots, allow_unused=True)
    dphi, dvcat, drbf, denvm, dunit, ddw, ddb, dgds, dgdv = (
        torch.zeros_like(t) if g is None else g for g, t in zip(d, x))
    return dphi, dvcat, drbf, denvm, dunit, ddw, ddb, dgds, dgdv


def painn_message_bwd2(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv,
                       cphi, cvcat, crbf, cenvm, cunit, cdw=None, cdb=None, rev=None):
    """Second-order backward of the general message: the VJP of
    :func:`painn_message_bwd`, batched over chains and members.

    With B(phi, vcat, rbf, envm, unit, dw, db; gds, gdv) the seven
    cotangents of :func:`painn_message_bwd`, this returns the gradient of
    <c, B> over B's ten float inputs, for cotangents c of B's outputs.

    Args:
        phi .. gdv: the backward's inputs (:func:`painn_message_bwd`).
        cphi, cvcat: (C, K, n_pad, 3F), cotangents of g_phi and g_vcat
            (cvcat x-major).
        crbf (C, E, R), cenvm (C, E), cunit (C, 3, n_pad, M): cotangents of
            the member-summed edge cotangents.
        cdw (K, R, 3F), cdb (K, 3F): cotangents of g_dw and g_db, or None.
            When both are None or zero, the kernel skips their terms
            (rbf . c_dw and c_db of G, Z . c_dw of d_rbf): force-loss
            training never consumes g_dw, so they arrive as None there.
        rev: (C, n_pad, D) int32 reverse table (``ops.neighbors.reverse_table``).
            An edge left out must have envm == 0 AND cenvm == 0: at such an
            edge the neighbour terms reduce to cenvm * wpre * (...), which
            vanish only with cenvm. Training meets this (the cotangent of
            g_envm passes back through envm = envelope * mask). None builds
            it from ``nbr`` and ``(envm != 0) | (cenvm != 0)``.
    Returns:
        dphi, dvcat (C, K, n_pad, 3F), drbf (C, E, R), denvm (C, E), dunit
        (C, 3, n_pad, M) summed over the members, ddw (K, R, 3F), ddb
        (K, 3F) summed over the chains, dgds (C, K, n_pad, F), dgdv
        (C, K, n_pad, 3F) x-major.

    Dead-slot contract (as :func:`painn_message_bwd`'s): the kernel computes
    the slots with envm != 0 or cenvm != 0 only and writes exact zeros to
    drbf, dunit and denvm on the others. The plain version gives zeros for
    the first two but sum_{t,f} (A_t wpre_t + g_t P_t G_t) for denvm there;
    that value reaches only envm's inputs, the positions, and force-loss
    training takes its gradient over the parameters alone
    (``tests/test_torch_bwd_contract.py``, ROADMAP Queue 3).

    The kernel (``csrc/painn_message_bwd2.cu``) takes R of 8, 16 or 24 and
    F a multiple of 16 (refused before a launch). Its centre kernel runs a
    fixed grid (``painn_message_bwd2_blocks()`` of the library, two blocks
    an SM), each block writing one d_dw / d_db partial over a contiguous
    range of (chain, centre) rows; the partials are summed here in block
    order, so the bits of ddw / ddb depend on the card's SM count.
    """
    C, K, n_pad, F3 = phi.shape
    F = F3 // 3
    E, R = rbf.shape[1], rbf.shape[2]
    M = E // n_pad
    f32, i32 = torch.float32, torch.int32
    dev = phi.device
    feat, edge = (C, K, n_pad, F3), (C, E)
    _check("painn_message_bwd2", dev,
           phi=(phi, f32, feat), vcat=(vcat, f32, feat), rbf=(rbf, f32, (C, n_pad * M, R)),
           envm=(envm, f32, edge), nbr=(nbr, i32, edge), unit=(unit, f32, (C, 3, n_pad, M)),
           dw=(dw, f32, (K, R, F3)), db=(db, f32, (K, F3)), gds=(gds, f32, (C, K, n_pad, F)),
           gdv=(gdv, f32, feat), cphi=(cphi, f32, feat), cvcat=(cvcat, f32, feat),
           crbf=(crbf, f32, (C, E, R)), cenvm=(cenvm, f32, edge),
           cunit=(cunit, f32, (C, 3, n_pad, M)))
    for name, t, shape in (("cdw", cdw, (K, R, F3)), ("cdb", cdb, (K, F3))):
        if t is not None:
            _check("painn_message_bwd2", dev, **{name: (t, f32, shape)})
    if dev.type == "cpu":
        return painn_message_bwd2_plain(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv,
                                        cphi, cvcat, crbf, cenvm, cunit, cdw, cdb)
    _check_bwd_kernel("painn_message_bwd2", C, K, R, F)
    has_cdw = any(t is not None and bool(t.any()) for t in (cdw, cdb))
    if has_cdw:
        cdw = torch.zeros_like(dw) if cdw is None else cdw
        cdb = torch.zeros_like(db) if cdb is None else cdb
    else:
        cdw = cdb = None
    if rev is None:
        rev = reverse_table(nbr, (envm != 0) | (cenvm != 0), n_pad)
    D = rev.shape[-1]
    _check("painn_message_bwd2", dev, rev=(rev, i32, (C, n_pad, D)))
    d = (torch.empty_like(phi), torch.empty_like(vcat), torch.empty_like(rbf),
         torch.empty_like(envm), torch.empty_like(unit), torch.empty_like(gds),
         torch.empty_like(gdv))
    with torch.cuda.device(dev):
        n_part = _lib("painn_message_bwd2").painn_message_bwd2_blocks()
    part = torch.empty((n_part, K, R + 1, F3), dtype=f32, device=dev)
    _launch("painn_message_bwd2",
            (phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv, cphi, cvcat, crbf, cenvm,
             cunit, cdw, cdb, rev, *d, part),
            (C, K, n_pad, M, R, F, D, int(has_cdw)))
    painn_message_bwd2.launches += 1
    painn_message_bwd2.cdw_launches += int(has_cdw)
    dphi, dvcat, drbf, denvm, dunit, dgds, dgdv = d
    ddw = part.sum(dim=0)                       # the blocks' partials, in block order
    return (dphi, dvcat, drbf, denvm, dunit, ddw[:, :R].contiguous(), ddw[:, R].contiguous(),
            dgds, dgdv)


painn_message_bwd2.launches = 0
painn_message_bwd2.cdw_launches = 0   # launches that also ran the c_dw / c_db terms


# ----------------------------------------------------------------------
# Banded messages (supercells): rows in the routing band's sorted order
# ----------------------------------------------------------------------
def _edge_starts(ws_rows, M):
    """Window start of every edge from the start of each centre row."""
    return ws_rows.long().repeat_interleave(M, dim=-1)


def _gather_window_rows(table, row, inwin):
    """(C, K, E, W) neighbour rows of a (C, K, n_ext, W) table, zero
    outside the window."""
    C, K, _, W = table.shape
    idx = row[:, None, :, None].expand(C, K, row.shape[1], W)
    return torch.gather(table, 2, idx) * inwin[:, None, :, None]


def painn_message_l1_banded_plain(species_ext, philt, rbf, envm, nbr, unit, dw2, db2, band):
    """Plain PyTorch version of :func:`painn_message_l1_banded`."""
    row, inwin = window_rows(nbr, edge_window_starts(band, unit.shape[3])[None], band)
    assert_in_window(envm != 0, inwin)
    sp_j = torch.where(inwin, torch.gather(species_ext, 1, row), philt.shape[1] - 1)
    return _message_l1_of_species(sp_j, philt, rbf, envm, unit, dw2, db2)


def painn_message_l1_banded(species_ext, philt, rbf, envm, nbr, unit, dw2, db2, band):
    """Layer-1 PaiNN message of a supercell (:func:`painn_message_l1`'s
    math) with the neighbour's species read through the routing band's
    window: for sorted centre i, s = band.win_start[i // band.n_blk] and the
    neighbour of rank r is row s + ((r - s) mod n_pad) of the extended
    species table.

    Args:
        species_ext: (C, n_pad + halo) int32 row of ``philt`` per sorted
            slot, the halo appended (T = dead/pad).
        philt, dw2, db2: as in :func:`painn_message_l1`.
        rbf (C, E, R), envm (C, E), unit (C, 3, n_pad, M): sorted-order
            geometry; nbr (C, E) int32 sorted ranks.
        band: the ``ops.banding.DeviceBand`` the tables were built for.
    Returns:
        ds (C, K, n_pad, F), dv (C, K, n_pad, 3F), in sorted order.

    The kernel (``csrc/painn_message_l1_banded.cu``) reassociates each
    centre's sum per species: it bins the centre's live edges (envm != 0)
    by their neighbour's species, once for all members, and multiplies
    each bin by the member's filter columns, every sum in one fixed order;
    it never reads a dead edge's rbf, unit vector or species. It takes R of
    8, 16 or 24 and at most 32 species rows (:func:`_check_layer1_kernel`),
    refused before a launch.
    """
    C, E, R = rbf.shape
    K, T1, F2 = philt.shape
    F = F2 // 2
    n_pad, M = unit.shape[2], unit.shape[3]
    n_ext = n_pad + band.halo
    f32, i32 = torch.float32, torch.int32
    dev = rbf.device
    _check("painn_message_l1_banded", dev,
           species_ext=(species_ext, i32, (C, n_ext)), philt=(philt, f32, (K, T1, F2)),
           rbf=(rbf, f32, (C, n_pad * M, R)), envm=(envm, f32, (C, E)),
           nbr=(nbr, i32, (C, E)), unit=(unit, f32, (C, 3, n_pad, M)),
           dw2=(dw2, f32, (K, R, F2)), db2=(db2, f32, (K, F2)),
           win_start=(band.win_start, i32, (n_pad // band.n_blk,)))
    if dev.type == "cpu":
        return painn_message_l1_banded_plain(species_ext, philt, rbf, envm, nbr, unit, dw2,
                                             db2, band)
    _check_layer1_kernel("painn_message_l1_banded", C, K, R, T1)
    ds = torch.empty((C, K, n_pad, F), dtype=f32, device=dev)
    dv = torch.empty((C, K, n_pad, 3 * F), dtype=f32, device=dev)
    _launch("painn_message_l1_banded",
            (species_ext, philt, rbf, envm, nbr, unit, dw2, db2, band.win_start, ds, dv),
            (C, K, n_pad, n_ext, M, R, F, T1, band.n_blk, band.window))
    painn_message_l1_banded.launches += 1
    return ds, dv


painn_message_l1_banded.launches = 0


def _banded_message_plain(phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, ws_edge, band):
    row, inwin = window_rows(nbr, ws_edge, band)
    assert_in_window(envm != 0, inwin)
    return _message_of_rows(_gather_window_rows(phi_ext, row, inwin),
                            _gather_window_rows(vcat_ext, row, inwin),
                            rbf, envm, unit, dw, db)


def _check_banded(name, phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, ws, ws_shape, band,
                  n_rows):
    """Every input of a banded general message over n_rows centre rows on
    phi_ext's device, of its dtype and shape, and contiguous."""
    C, K, n_ext, F3 = phi_ext.shape
    R, M = rbf.shape[2], unit.shape[3]
    f32, i32 = torch.float32, torch.int32
    _check(name, phi_ext.device,
           phi_ext=(phi_ext, f32, (C, K, band.n_pad + band.halo, F3)),
           vcat_ext=(vcat_ext, f32, (C, K, n_ext, F3)),
           rbf=(rbf, f32, (C, n_rows * M, R)), envm=(envm, f32, (C, n_rows * M)),
           nbr=(nbr, i32, (C, n_rows * M)), unit=(unit, f32, (C, 3, n_rows, M)),
           dw=(dw, f32, (K, R, F3)), db=(db, f32, (K, F3)), ws=(ws, i32, ws_shape))


def _check_layer1_kernel(name, C, K, R, T1):
    """Limits of row 6: the radial width is 8, 16 or 24 (the widths the
    kernel is built for), and the species rows (the zero row included) fit
    its 32-bit mask of the species present at a centre."""
    _check_grid(name, C, K, R)
    if R > 24:
        raise ValueError(f"{name}: the radial width must be 8, 16 or 24, got {R}")
    if T1 > 32:
        raise ValueError(f"{name}: {T1} species rows exceed the kernel's 32")


def _check_banded_kernel(name, C, K, R, F, *tables):
    """Limits of rows 2, 7 and 8: the radial width is 8, 16 or 24 (a whole
    number of the tensor-core step, and the widths the kernel is built for),
    the channels a whole number of the kernel's 16-channel slice, and every
    table it reads 16 bytes at a time (phi, vcat, rbf, db) 16-byte aligned.
    A block whose shared memory does not fit is refused by the launch
    itself."""
    _check_grid(name, C, K, R)
    if R > 24:
        raise ValueError(f"{name}: the radial width must be 8, 16 or 24, got {R}")
    if F % 16:
        raise ValueError(f"{name}: F={F} must be a multiple of 16 (the kernel's channel slice)")
    if any(t.data_ptr() % 16 for t in tables):
        raise ValueError(f"{name}: phi, vcat, rbf and db must start on a 16-byte boundary")


def _launch_banded(name, phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, ws, n_rows, ints):
    """Allocate the outputs of a banded general message over n_rows centre
    rows and launch ``name`` (its C entry's int arguments are ``ints``)."""
    C, K, _, F3 = phi_ext.shape
    _check_banded_kernel(name, C, K, rbf.shape[2], F3 // 3, phi_ext, vcat_ext, rbf, db)
    ds = torch.empty((C, K, n_rows, F3 // 3), dtype=torch.float32, device=phi_ext.device)
    dv = torch.empty((C, K, n_rows, F3), dtype=torch.float32, device=phi_ext.device)
    _launch(name, (phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, ws, ds, dv), ints)
    return ds, dv


def painn_message_fused_banded_plain(phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, band):
    """Plain PyTorch version of :func:`painn_message_fused_banded`."""
    return _banded_message_plain(phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db,
                                 edge_window_starts(band, unit.shape[3])[None], band)


def painn_message_fused_banded(phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, band,
                               rev=None):
    """General PaiNN message of a supercell (:func:`painn_message_fused`'s
    math), neighbour rows read through the routing band's window,
    differentiable in every float input.

    Args:
        phi_ext, vcat_ext: (C, K, n_pad + halo, 3F) f32 features in sorted
            order with the band's halo appended.
        rbf (C, E, R), envm (C, E), unit (C, 3, n_pad, M): sorted-order
            geometry; nbr (C, E) int32 sorted ranks.
        dw, db: (K, R, 3F), (K, 3F) dist_embed weights.
        band: the ``ops.banding.DeviceBand``.
        rev: optional (C, n_pad + halo, D) int32 reverse table of the edges
            keyed by extended row (``ops.banding.banded_reverse_table``)
            for the backward; built from ``nbr`` and ``envm != 0`` when a
            backward needs it and it is not given.
    Returns:
        ds (C, K, n_pad, F), dv (C, K, n_pad, 3F), in sorted order.

    The backward launches :func:`painn_message_bwd_banded` (the plain
    version on the CPU); the cotangents of the halo rows are returned as
    rows of their own, and fold back onto their slots through the
    concatenation that built the halo. Once-differentiable: differentiating
    its backward raises, as the JAX package's banded backward has no VJP.

    The kernel (``csrc/painn_message_banded.cuh``) sums each centre's live
    edges (envm != 0) only, in one fixed order, so a centre gets the same
    bits here as in :func:`painn_message_subset`; it takes R of 8, 16 or 24
    and F a multiple of 16.
    """
    return _MessageFusedBanded.apply(phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, band, rev)


def _message_fused_banded_forward(phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, band):
    name = "painn_message_fused_banded"
    C, K, n_ext, F3 = phi_ext.shape
    n_pad, M, R = unit.shape[2], unit.shape[3], rbf.shape[2]
    _check_banded(name, phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, band.win_start,
                  (n_pad // band.n_blk,), band, n_pad)
    if phi_ext.device.type == "cpu":
        return painn_message_fused_banded_plain(phi_ext, vcat_ext, rbf, envm, nbr, unit, dw,
                                                db, band)
    out = _launch_banded(name, phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db,
                         band.win_start, n_pad,
                         (C, K, n_pad, n_ext, M, R, F3 // 3, band.n_blk, band.window))
    painn_message_fused_banded.launches += 1
    return out


class _MessageFusedBanded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, band, rev):
        ctx.save_for_backward(phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db)
        ctx.band, ctx.rev = band, rev
        return _message_fused_banded_forward(phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db,
                                             band)

    @staticmethod
    def backward(ctx, gds, gdv):
        need = ctx.needs_input_grad
        with torch.no_grad():
            g = painn_message_bwd_banded(*ctx.saved_tensors, gds.contiguous(),
                                         gdv.contiguous(), ctx.band, rev=ctx.rev,
                                         want_dw=need[6] or need[7])
        g = tuple(x if n else None for x, n in zip(g, (*need[:4], need[5], need[6], need[7])))
        g_phi, g_vcat, g_rbf, g_envm, g_unit, g_dw, g_db = _first_order_only(
            g, (*ctx.saved_tensors, gds, gdv),
            "painn_message_fused_banded is once-differentiable: its backward "
            "(painn_message_bwd_banded) has no second order. Force-loss training runs "
            "the unbanded painn_message_fused, whose second order is painn_message_bwd2")
        return g_phi, g_vcat, g_rbf, g_envm, None, g_unit, g_dw, g_db, None, None


def _first_order_only(results, sources, message: str):
    """A backward's ``results`` (computed under ``no_grad``) that raise
    ``RuntimeError(message)`` when differentiated. Under ``create_graph``
    they are tied to every ``sources`` tensor that requires grad, so any
    derivative through them reaches the error. ``once_differentiable`` ties
    its error node to nothing: ``torch.autograd.grad`` over chosen inputs
    prunes it and silently drops the missing order."""
    links = [t for t in sources if t is not None and t.requires_grad]
    if not (torch.is_grad_enabled() and links):
        return results
    return _FirstOrderOnly.apply(message, results, *links)


class _FirstOrderOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, message, results, *links):
        ctx.message = message
        return tuple(None if r is None else r.clone() for r in results)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(ctx.message)


painn_message_fused_banded.launches = 0


def painn_message_bwd_banded_plain(phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, gds, gdv,
                                   band, want_dw=True):
    """Plain PyTorch version of :func:`painn_message_bwd_banded`."""
    row, inwin = window_rows(nbr, edge_window_starts(band, unit.shape[3])[None], band)
    assert_in_window(envm != 0, inwin)
    return _message_bwd_of_rows(phi_ext, vcat_ext, row, inwin, rbf, envm, unit, dw, db, gds,
                                gdv, want_dw)


def painn_message_bwd_banded(phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, gds, gdv, band,
                             rev=None, want_dw=False):
    """Cotangents of every float input of :func:`painn_message_fused_banded`
    (:func:`painn_message_bwd`'s math with the neighbour rows read through
    the routing band's window), batched over chains and members.

    Args:
        phi_ext .. db, band: the forward's inputs (sorted order, tables
            extended by the halo).
        gds: (C, K, n_pad, F), gdv: (C, K, n_pad, 3F) x-major, cotangents of
            ds and dv (sorted order).
        rev: (C, n_pad + halo, D) int32 reverse table keyed by extended
            row (``ops.banding.banded_reverse_table``). Edges left out must
            have envm == 0. None builds it from ``nbr`` and ``envm != 0``.
        want_dw: also return g_dw (K, R, 3F) and g_db (K, 3F).
    Returns:
        (g_phi_ext, g_vcat_ext) (C, K, n_pad + halo, 3F): each extended
        row's own cotangent (a halo row and its slot are summed by the
        caller's fold); g_rbf (C, E, R), g_envm (C, E), g_unit
        (C, 3, n_pad, M) summed over the members; g_dw, g_db.

    The dead-edge contract and the kernel's limits are those of
    :func:`painn_message_bwd`.
    """
    name = "painn_message_bwd_banded"
    C, K, n_ext, F3 = phi_ext.shape
    F = F3 // 3
    n_pad, M, R = unit.shape[2], unit.shape[3], rbf.shape[2]
    f32, i32 = torch.float32, torch.int32
    dev = phi_ext.device
    _check_banded(name, phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, band.win_start,
                  (n_pad // band.n_blk,), band, n_pad)
    _check(name, dev, gds=(gds, f32, (C, K, n_pad, F)), gdv=(gdv, f32, (C, K, n_pad, F3)))
    if dev.type == "cpu":
        return painn_message_bwd_banded_plain(phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db,
                                              gds, gdv, band, want_dw=want_dw)
    _check_bwd_kernel(name, C, K, R, F)
    if rev is None:
        rev = banded_reverse_table(nbr, envm != 0, band, None)
    D = rev.shape[-1]
    _check(name, dev, rev=(rev, i32, (C, n_ext, D)))
    return _launch_bwd(name, painn_message_bwd_banded,
                       (phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, gds, gdv,
                        band.win_start),
                       rev, (C, K, n_pad, n_ext, M, R, F, D, band.n_blk, band.window,
                             int(want_dw)), want_dw)


painn_message_bwd_banded.launches = 0
painn_message_bwd_banded.dw_launches = 0   # launches that also computed g_dw / g_db


def painn_message_subset_plain(phi_ext, vcat_ext, rbf_sel, envm_sel, nbr_sel, unit_sel, dw,
                               db, ws_sel, band):
    """Plain PyTorch version of :func:`painn_message_subset`."""
    M = unit_sel.shape[3]
    return _banded_message_plain(phi_ext, vcat_ext, rbf_sel, envm_sel, nbr_sel, unit_sel, dw,
                                 db, _edge_starts(ws_sel, band.n_blk * M), band)


def painn_message_subset(phi_ext, vcat_ext, rbf_sel, envm_sel, nbr_sel, unit_sel, dw, db,
                         ws_sel, band):
    """The banded general message over NB selected blocks of n_blk sorted
    centres per chain (a move's hop ball): the delta engine's hot op. It
    is forward only, as the TPU kernel is (it has no VJP): inputs that
    require grad raise.

    Args:
        phi_ext, vcat_ext: (C, K, n_pad + halo, 3F) full sorted tables with
            the halo appended.
        rbf_sel (C, NB*n_blk*M, R), envm_sel and nbr_sel (C, NB*n_blk*M),
            unit_sel (C, 3, NB*n_blk, M): the selected blocks' geometry,
            gathered in compact block order (nbr_sel: sorted ranks).
        dw, db: (K, R, 3F), (K, 3F).
        ws_sel: (C, NB) int32 window start of each chain's selected block
            (``band.win_start[blocks]``).
        band: the ``ops.banding.DeviceBand``.
    Returns:
        compact ds (C, K, NB*n_blk, F), dv (C, K, NB*n_blk, 3F).

    A centre's outputs are bitwise those of :func:`painn_message_fused_banded`
    on the same rows (the delta engine mixes the two); the kernel's limits
    are that function's.
    """
    name = "painn_message_subset"
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (phi_ext, vcat_ext, rbf_sel, envm_sel, unit_sel, dw, db)):
        raise NotImplementedError(f"{name} is forward only: the delta engine's subset message "
                                  "has no backward, in the JAX package either")
    C, K, n_ext, F3 = phi_ext.shape
    n_rows, M, R = unit_sel.shape[2], unit_sel.shape[3], rbf_sel.shape[2]
    if n_rows % band.n_blk:
        raise ValueError(f"{name}: {n_rows} compact rows are not whole blocks of {band.n_blk}")
    _check_banded(name, phi_ext, vcat_ext, rbf_sel, envm_sel, nbr_sel, unit_sel, dw, db,
                  ws_sel, (C, n_rows // band.n_blk), band, n_rows)
    if phi_ext.device.type == "cpu":
        return painn_message_subset_plain(phi_ext, vcat_ext, rbf_sel, envm_sel, nbr_sel,
                                          unit_sel, dw, db, ws_sel, band)
    out = _launch_banded(name, phi_ext, vcat_ext, rbf_sel, envm_sel, nbr_sel, unit_sel, dw,
                         db, ws_sel, n_rows,
                         (C, K, n_rows, band.n_pad, n_ext, M, R, F3 // 3, band.n_blk,
                          band.window))
    painn_message_subset.launches += 1
    return out


painn_message_subset.launches = 0


# ----------------------------------------------------------------------
# Update block
# ----------------------------------------------------------------------
def painn_update_fused_plain(s, vcat, u, v, w0, b0, w1, b1, alive):
    """Plain PyTorch version of :func:`painn_update_fused`: the update of
    the general trunk, ``models.painn.painn_update``."""
    from surface_sampling_tpu_torch.models.painn import painn_update

    return painn_update(s, vcat, u, v, w0, b0, w1, b1, alive)


def painn_update_fused(s, vcat, u, v, w0, b0, w1, b1, alive):
    """PaiNN update block over padded rows, batched over chains and members:

        Uv_x = v_x @ u,  Vv_x = v_x @ v                 per axis x
        a    = silu([s, |Vv|] @ w0 + b0) @ w1 + b1      split a_vv | a_sv | a_ss
        s'   = (s + a_sv * <Uv, Vv> + a_ss) * alive
        v'_x = (v_x + a_vv * Uv_x) * alive

    with |Vv| = sqrt(sum_x Vv_x^2 + 1e-16).

    Args:
        s: (C, K, n_pad, F) f32; vcat: (C, K, n_pad, 3F) f32 x-major.
        u, v: (K, F, F); w0: (K, 2F, F); b0: (K, F); w1: (K, F, 3F);
            b1: (K, 3F) f32 update weights of the layer.
        alive: (C, n_pad) f32 mask (0 on dead and padded rows).
    Returns:
        s' (C, K, n_pad, F), vcat' (C, K, n_pad, 3F).

    The kernel (``csrc/painn_update_fused.cu``) computes the alive rows
    (alive != 0) only, packed into tiles across chains, with its products
    on the tensor cores at f32 accuracy, and writes exact zeros to the
    others: a dead row's s and vcat are never read. It takes F a multiple
    of 16 up to 256 and 16-byte aligned row tables
    (:func:`_check_update_kernel`), refused before a launch.
    """
    C, K, n_pad, F = s.shape
    f32 = torch.float32
    dev = s.device
    _check("painn_update_fused", dev,
           s=(s, f32, (C, K, n_pad, F)), vcat=(vcat, f32, (C, K, n_pad, 3 * F)),
           u=(u, f32, (K, F, F)), v=(v, f32, (K, F, F)), w0=(w0, f32, (K, 2 * F, F)),
           b0=(b0, f32, (K, F)), w1=(w1, f32, (K, F, 3 * F)), b1=(b1, f32, (K, 3 * F)),
           alive=(alive, f32, (C, n_pad)))
    if dev.type == "cpu":
        return painn_update_fused_plain(s, vcat, u, v, w0, b0, w1, b1, alive)
    _check_update_kernel(C, n_pad, F, s, vcat, u, v, w0, w1, alive)
    s_out = torch.empty_like(s)
    v_out = torch.empty_like(vcat)
    work = torch.empty(C * n_pad + 1, dtype=torch.int32, device=dev)   # the alive rows' list
    _launch("painn_update_fused",
            (s, vcat, u, v, w0, b0, w1, b1, alive, work, s_out, v_out),
            (C, K, n_pad, F))
    painn_update_fused.launches += 1
    return s_out, v_out


painn_update_fused.launches = 0


def _check_update_kernel(C, n_pad, F, *tables):
    """Limits of row 3: F a multiple of 16 up to 256 (a warp a 16-channel
    slice, at most 16 warps), the C x n_pad rows numbered by 32-bit ints in
    its list of alive rows, and the tables it reads 16 bytes at a time (s,
    vcat, u, v, w0, w1, alive) 16-byte aligned. A block whose shared memory
    does not fit is refused by the launch itself."""
    if C * n_pad >= 2 ** 31 - 1:
        raise ValueError(f"painn_update_fused: C x n_pad = {C * n_pad} rows exceed the kernel's "
                         "32-bit row numbers")
    if F % 16 or not 16 <= F <= 256:
        raise ValueError(f"painn_update_fused: F={F} must be a multiple of 16 up to 256 "
                         "(the kernel's 16-channel warp slices)")
    if any(t.data_ptr() % 16 for t in tables):
        raise ValueError("painn_update_fused: s, vcat, u, v, w0, w1 and alive must start on a "
                         "16-byte boundary")


WRAPPERS = (painn_message_l1, painn_message_fused, painn_update_fused, painn_message_bwd,
            painn_message_l1_banded, painn_message_fused_banded, painn_message_subset,
            painn_message_bwd_banded, painn_message_bwd2)
PLAIN = {
    painn_message_l1: painn_message_l1_plain,
    painn_message_fused: painn_message_fused_plain,
    painn_update_fused: painn_update_fused_plain,
    painn_message_bwd: painn_message_bwd_plain,
    painn_message_l1_banded: painn_message_l1_banded_plain,
    painn_message_fused_banded: painn_message_fused_banded_plain,
    painn_message_subset: painn_message_subset_plain,
    painn_message_bwd_banded: painn_message_bwd_banded_plain,
    painn_message_bwd2: painn_message_bwd2_plain,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    painn_message_bwd.dw_launches = painn_message_bwd_banded.dw_launches = 0
    painn_message_bwd2.cdw_launches = 0


def launch_counts() -> dict[str, int]:
    counts = {fn.__name__: fn.launches for fn in WRAPPERS}
    counts["painn_message_bwd.g_dw"] = painn_message_bwd.dw_launches
    counts["painn_message_bwd_banded.g_dw"] = painn_message_bwd_banded.dw_launches
    counts["painn_message_bwd2.c_dw"] = painn_message_bwd2.cdw_launches
    return counts
