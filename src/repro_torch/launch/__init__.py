"""Launchers of the port: the assessment CLI (``python -m
repro_torch.launch.assess``) and model serving (``python -m
repro_torch.launch.serve``)."""
