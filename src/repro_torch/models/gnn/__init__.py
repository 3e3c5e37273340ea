"""GNN substrate of the port (``common``); the GNN models come with the
GNN slice."""
