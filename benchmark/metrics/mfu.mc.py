"""The whole step's share of the H100's dense TF32 peak (495 TFLOP/s, 700
W): the model's operations as the cell's algorithm runs them (from the
occupancies each traced step evaluated) over the traced sweeps' wall time."""

from benchmark.work.readers import mfu as read  # noqa: F401
