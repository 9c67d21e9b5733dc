"""Batches of chains: chain states, parallel tempering and population
annealing over the chain batch axis."""

from surface_sampling_tpu_torch.parallel.chains import (
    chain_states,
    incremental_chain_states,
    make_chain_run,
    relaxed_chain_states,
)
from surface_sampling_tpu_torch.parallel.population import (
    PARecord,
    make_population_annealing_run,
    systematic_resample,
)
from surface_sampling_tpu_torch.parallel.tempering import (
    TemperRecord,
    make_tempered_run,
    swap_phase,
    take_chains,
    temperature_ladder,
)

__all__ = [
    "PARecord",
    "TemperRecord",
    "chain_states",
    "incremental_chain_states",
    "make_chain_run",
    "make_population_annealing_run",
    "relaxed_chain_states",
    "swap_phase",
    "systematic_resample",
    "take_chains",
    "temperature_ladder",
    "make_tempered_run",
]
