"""Neural potentials: PaiNN ensembles (rigid and general forward), CHGNet
and MACE, their potentials and weights.

The names of the JAX package's ``models/__init__`` are exported lazily (a
module ``__getattr__``): the ops modules import ``models.painn``, and the
potentials import the ops modules, so an eager import here would be
circular."""

from importlib import import_module

_EXPORTS = {
    "CHGNetConfig": "chgnet",
    "chgnet_apply": "chgnet",
    "init_chgnet": "chgnet",
    "ensemble_apply": "ensemble",
    "ensemble_forces_std": "ensemble",
    "stack_params": "ensemble",
    "MACEConfig": "mace",
    "init_mace": "mace",
    "mace_apply": "mace",
    "make_mace_potential": "mace",
    "make_chgnet_potential": "nn_calculator",
    "make_painn_potential": "nn_calculator",
    "PaiNNConfig": "painn",
    "init_painn": "painn",
    "painn_apply": "painn",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(f"{__name__}.{_EXPORTS[name]}"), name)
