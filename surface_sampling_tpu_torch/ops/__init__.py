"""Host-side geometry and the PaiNN kernels with their plain versions."""
