"""repro_torch — the RDF quality-assessment framework on PyTorch and CUDA.

A port of the ``repro`` package (JAX) to an NVIDIA H100: the same planes,
planner, metrics and reports, with the assessment scan run by hand-written
CUDA kernels (``repro_torch.kernels``). Entry points take ``device``
(default ``"cuda"``); ``device="cpu"`` runs the kernels' plain torch
versions instead. Start at ``repro_torch.qa``.
"""
