"""See the package docstring of tpu_orc_torch."""
