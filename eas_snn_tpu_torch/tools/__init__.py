"""Command-line entry points of the port (``python -m
eas_snn_tpu_torch.tools.<name>``)."""
