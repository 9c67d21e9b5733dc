"""Classical potentials: the Potential API, pair potentials and EAM."""
