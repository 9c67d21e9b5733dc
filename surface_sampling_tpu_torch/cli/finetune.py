"""Fine-tune (or train from scratch) a PaiNN, CHGNet or MACE potential from
a labelled dataset, on the card.

The port's counterpart of the JAX package's ``sst-finetune``:

    python -m surface_sampling_tpu_torch.cli.finetune --data labelled.json \\
        --family painn|chgnet|mace --out run_ft [--init model.npz | \\
        --config cfg.json] [--epochs 100] [--lr 1e-3] [--magmom-weight 0.5] \\
        [--ensemble 3] [--mesh N] [--device cuda|cpu]

Outputs in --out: ``model.npz`` (or ``model_01..K.npz`` with --ensemble K,
PaiNN only), in the family's checkpoint layout, which both packages load
(``models.weights.load_painn_npz`` / ``load_chgnet_npz``,
``models.mace.load_mace_npz``), ``history.csv`` (per-epoch train loss),
``metrics.json`` (final train / val / test losses and the training time)
and ``settings.json`` (the arguments). ``--magmom-weight`` > 0 trains
CHGNet's magmom head on the frames that carry magmom labels.
``--device`` defaults to the card; ``cpu`` runs the plain PyTorch path.

``--mesh N`` runs the data-parallel sharded train step
(``parallel/training.py``) over a world of N ranks, one card each: launch
it under ``torchrun --nproc-per-node N`` (N must equal the world size;
rank 0 writes the outputs). ``--mesh 1`` without a launcher makes a world
of one itself (NCCL on the card, gloo with ``--device cpu``) and ends it
at the close. Every batch's frame count must divide N: a ragged tail batch
is dropped, as in the JAX package.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from surface_sampling_tpu_torch.device import resolve_device
from surface_sampling_tpu_torch.models import chgnet, mace, painn
from surface_sampling_tpu_torch.models.dataset import get_train_val_test_loader
from surface_sampling_tpu_torch.models.train import (
    TrainConfig,
    batch_to_device,
    make_loss_fn,
    train_painn,
)
from surface_sampling_tpu_torch.models.weights import (
    from_jax_params,
    load_chgnet_npz,
    load_painn_npz,
    save_chgnet_npz,
    save_painn_npz,
)
from surface_sampling_tpu_torch.parallel.mesh import chain_mesh
from surface_sampling_tpu_torch.parallel.training import train_sharded


class Family(NamedTuple):
    """What the CLI needs of a model family."""

    init: Callable          # init(generator, cfg) -> params
    apply_fn: Callable | None   # models.train.make_loss_fn's apply_fn
    save: Callable          # save(path, params, cfg)
    load: Callable          # load(path) -> (tree of numpy arrays, cfg)
    cfg_cls: type
    cutoff: Callable        # cutoff(cfg) -> the neighbour cutoff
    tpu_keys: tuple         # the JAX configuration's TPU execution choices


FAMILIES = {
    "painn": Family(painn.init_painn, None, save_painn_npz, load_painn_npz, painn.PaiNNConfig,
                    lambda c: c.cutoff, ("message_mode", "pallas_routing")),
    "chgnet": Family(chgnet.init_chgnet, chgnet.chgnet_apply_structures, save_chgnet_npz,
                     load_chgnet_npz, chgnet.CHGNetConfig, lambda c: c.atom_graph_cutoff,
                     ("conv_mode", "pallas_routing")),
    "mace": Family(mace.init_mace, mace.mace_apply, mace.save_mace_npz, mace.load_mace_npz,
                   mace.MACEConfig, lambda c: c.cutoff, ()),
}


def _epoch_loss(loss_fn, params: dict, batches, device) -> float:
    """Mean over batches of the member-mean loss; nan without batches."""
    if not batches:
        return float("nan")
    losses = (loss_fn(params, batch_to_device(b, device), create_graph=False).detach()
              for b in batches)
    return sum(float(x.mean()) for x in losses) / len(batches)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", required=True,
                    help="labelled dataset: JSON list / npz / MPtrj shard dir")
    ap.add_argument("--family", choices=["painn", "chgnet", "mace"], default="painn")
    ap.add_argument("--init", default=None, help="checkpoint npz to fine-tune from")
    ap.add_argument("--config", default=None,
                    help="JSON of the family's config kwargs for a fresh model (ignored with "
                         "--init)")
    ap.add_argument("--out", default="finetune_out")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--energy-weight", type=float, default=0.05)
    ap.add_argument("--force-weight", type=float, default=0.95)
    ap.add_argument("--magmom-weight", type=float, default=0.0,
                    help="> 0 trains CHGNet's magmom head on the frames with magmom labels")
    ap.add_argument("--grad-clip", type=float, default=10.0)
    ap.add_argument("--train-ratio", type=float, default=0.8)
    ap.add_argument("--val-ratio", type=float, default=0.1)
    ap.add_argument("--ensemble", type=int, default=1,
                    help="train K independently initialised members (PaiNN)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="data-parallel ranks (one card each; N > 1 under torchrun)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.epochs < 1:
        raise SystemExit("--epochs must be >= 1")
    ensemble = args.ensemble > 1
    if args.mesh > 0 and ensemble:
        raise SystemExit("--mesh currently shards the data axis; drop --ensemble or --mesh")
    device = resolve_device(args.device)
    made = _join_world(args.mesh, device) if args.mesh > 0 else None
    try:
        _run(args, device, ensemble)
    finally:
        if made is not None:
            dist.destroy_process_group()
        if made:
            shutil.rmtree(made, ignore_errors=True)


def _join_world(n: int, device: torch.device) -> str | None:
    """The world of ``--mesh n``: the caller's, if one is initialised; else
    the launcher's (torchrun's environment) or, for n = 1 without a
    launcher, a world of one over a FileStore in a temporary directory,
    both initialised here (NCCL on the card, gloo on the CPU). Returns the
    directory to remove ("" for the launcher's world) when the world was
    made here and must be ended, else None."""
    if dist.is_initialized():
        world, made = dist.get_world_size(), None
    elif "WORLD_SIZE" in os.environ:
        world, made = int(os.environ["WORLD_SIZE"]), ""
    elif n == 1:
        world, made = 1, tempfile.mkdtemp(prefix="finetune_world_")
    else:
        raise SystemExit(f"--mesh {n} needs a world of {n} ranks: launch with "
                         f"torchrun --nproc-per-node {n}")
    if world != n:
        raise SystemExit(f"--mesh {n} but the launcher started {world} ranks")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if made == "":
        dist.init_process_group(backend)
    elif made is not None:
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(made, "store"), 1),
                                rank=0, world_size=1)
    return made


def _run(args, device: torch.device, ensemble: bool) -> None:
    fam = FAMILIES[args.family]
    mesh = chain_mesh(args.mesh, device=device) if args.mesh > 0 else None
    if mesh is not None:
        device = mesh.device
    if args.init:
        if ensemble:
            raise SystemExit("--ensemble trains fresh members; it cannot combine with "
                             "--init (one checkpoint)")
        tree, cfg = fam.load(args.init)
        params = from_jax_params(tree, device)
    else:
        if ensemble and args.family != "painn":
            raise SystemExit("--ensemble > 1 is the PaiNN-ensemble path")
        cfg_kw = json.loads(Path(args.config).read_text()) if args.config else {}
        for tpu_key in fam.tpu_keys:
            cfg_kw.pop(tpu_key, None)
        cfg = fam.cfg_cls(**cfg_kw)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = (painn.init_ensemble(gen, cfg, args.ensemble) if ensemble
                  else fam.init(gen, cfg))

    tcfg = TrainConfig(learning_rate=args.lr, energy_weight=args.energy_weight,
                       force_weight=args.force_weight, magmom_weight=args.magmom_weight,
                       epochs=args.epochs, grad_clip=args.grad_clip)
    train, val, test = get_train_val_test_loader(
        args.data, fam.cutoff(cfg), batch_size=args.batch_size, train_ratio=args.train_ratio,
        val_ratio=args.val_ratio, seed=args.seed)
    if not train:
        raise SystemExit(f"no training frames found in {args.data}")

    writer = mesh is None or dist.get_rank() == 0
    out = Path(args.out)
    if writer:
        out.mkdir(parents=True, exist_ok=True)
        (out / "settings.json").write_text(json.dumps(vars(args), indent=2, default=str))

    t0 = time.perf_counter()
    if mesh is not None:
        full = [b for b in train if len(b.positions) % args.mesh == 0]
        if len(full) < len(train) and writer:
            dropped = sum(len(b.positions) for b in train) - sum(len(b.positions) for b in full)
            print(f"--mesh {args.mesh}: dropping the ragged tail batch ({dropped} frames; "
                  f"sizes must divide the mesh: pick --batch-size as a multiple of {args.mesh})")
        if not full:
            raise SystemExit(f"--mesh {args.mesh} left no full batches; lower --mesh or "
                             f"raise the frame count / --batch-size")
        params, history = train_sharded(params, cfg, full, tcfg, mesh, apply_fn=fam.apply_fn)
    else:
        params, history = train_painn(params, cfg, train, tcfg, ensemble=ensemble,
                                      apply_fn=fam.apply_fn)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if not writer:
        return

    loss_fn = make_loss_fn(cfg, tcfg, fam.apply_fn)
    stacked = params if ensemble else painn.stack_members([params])
    val_loss = _epoch_loss(loss_fn, stacked, val, device)
    test_loss = _epoch_loss(loss_fn, stacked, test, device)

    with (out / "history.csv").open("w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["epoch", "train_loss"])
        for i, h in enumerate(history):
            w.writerow([i, h])
    (out / "metrics.json").write_text(json.dumps({
        "final_train_loss": history[-1], "val_loss": val_loss, "test_loss": test_loss,
        "epochs": args.epochs, "train_seconds": round(dt, 2), "device": str(device),
    }, indent=2, default=str))
    if ensemble:
        for i in range(args.ensemble):
            save_painn_npz(out / f"model_{i + 1:02d}.npz", params, cfg, member=i)
    else:
        fam.save(out / "model.npz", params, cfg)

    print(f"Trained {args.family} for {args.epochs} epochs in {dt:.1f} s on {device}; final train "
          f"loss {history[-1]:.6f}, val {val_loss:.6f}, test {test_loss:.6f}")
    print(f"Output folder: {out}")


if __name__ == "__main__":
    main()
