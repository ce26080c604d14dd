"""See the package docstring of mtn_tpu_torch."""
