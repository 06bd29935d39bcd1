"""Part of the chap_tpu_torch port; see the package docstring."""
