"""Device kernels (PyTorch's and the port's, no copies) per MC step of the
traced sweeps of a device-bound cell."""

from benchmark.work.readers import launches_per_step as read  # noqa: F401
