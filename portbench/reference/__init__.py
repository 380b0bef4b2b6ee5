"""Plain float32 references that decide a run's ``correct``.

They import neither JAX nor anything of the port, and take only the weights
and tokens the benchmark made."""
