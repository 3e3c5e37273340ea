"""Host-side data pipeline of the port (numpy): the neighbor sampler of
the sampled GNN shapes, a copy of ``repro.data.sampler``."""
