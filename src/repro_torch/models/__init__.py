"""Model zoo of the port: the LM transformers and DIN (serving), and the
GNN substrate DIN shares."""
