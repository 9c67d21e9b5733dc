"""Device kernels (PyTorch's and the port's, no copies) per MC step of the
traced sweeps of a cell whose host paces the step."""

from benchmark.work.readers import launches_per_step as read  # noqa: F401
