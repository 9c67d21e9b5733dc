"""Default model cutoffs and sampling settings (a copy of
``surface_sampling_tpu/cli/default_settings.py``)."""

DEFAULT_CUTOFFS = {
    "chgnet": 6.0,
    "mace": 5.0,
    "painn": 5.0,
    "nff": 5.0,
}

DEFAULT_SAMPLING_SETTINGS = {
    "total_sweeps": 100,
    "sweep_size": 20,
    "start_temp": 1.0,
    "perform_annealing": True,
    "alpha": 0.99,
    "canonical": False,
    "num_ads_atoms": 0,
    "n_chains": 1,
}
