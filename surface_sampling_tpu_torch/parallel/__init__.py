"""Batches of chains: chain states, sharding over a rank mesh, parallel
tempering and population annealing over the chain batch axis, and sharded
fine-tuning."""

from surface_sampling_tpu_torch.parallel.chains import (
    chain_block,
    chain_states,
    gather_chain_states,
    incremental_chain_states,
    make_chain_run,
    make_ensemble_sharded_energy,
    make_hierarchical_chain_run,
    make_sharded_chain_run,
    relaxed_chain_states,
    shard_chain_states,
)
from surface_sampling_tpu_torch.parallel.mesh import (
    RankMesh,
    chain_ensemble_mesh,
    chain_mesh,
    pod_mesh,
    spawn_ranks,
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
from surface_sampling_tpu_torch.parallel.training import (
    make_ensemble_sharded_train_step,
    make_sharded_train_step,
    train_sharded,
)

__all__ = [
    "PARecord",
    "RankMesh",
    "TemperRecord",
    "chain_block",
    "chain_ensemble_mesh",
    "chain_mesh",
    "chain_states",
    "gather_chain_states",
    "incremental_chain_states",
    "make_chain_run",
    "make_ensemble_sharded_energy",
    "make_ensemble_sharded_train_step",
    "make_hierarchical_chain_run",
    "make_population_annealing_run",
    "make_sharded_chain_run",
    "make_sharded_train_step",
    "make_tempered_run",
    "pod_mesh",
    "relaxed_chain_states",
    "shard_chain_states",
    "spawn_ranks",
    "swap_phase",
    "systematic_resample",
    "take_chains",
    "temperature_ladder",
    "train_sharded",
]
