"""Core MC machinery: spec, state, energies, step and engine, batched over chains."""
