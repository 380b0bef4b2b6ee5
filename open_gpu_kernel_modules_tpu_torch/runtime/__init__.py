"""Bindings to the native tpurm core that the port needs (its own copies)."""
