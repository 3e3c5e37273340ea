"""Model zoo of the port: the LM transformers and DIN (serving), and the
GNN family (``models.gnn``, trained)."""
