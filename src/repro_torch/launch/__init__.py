"""Entry points of the model stack (``python -m repro_torch.launch.serve``)."""
