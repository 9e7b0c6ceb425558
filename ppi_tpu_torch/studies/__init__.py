"""Measurement scripts of the port, one question each (``python -m
ppi_tpu_torch.studies.<name>``)."""
