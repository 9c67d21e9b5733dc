"""Device kernels (PyTorch's and the port's, no copies) per MC step of the
traced sweeps of a relaxed cell (a step: a FIRE relaxation of every
chain's trial and its fresh score)."""

from benchmark.work.readers import launches_per_step as read  # noqa: F401
