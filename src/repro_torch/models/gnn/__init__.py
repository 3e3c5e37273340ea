"""The GNN family of the port: GatedGCN, DimeNet, EquiformerV2 (with the
Wigner rotations of ``wigner``) and GraphCast, on the segment-op substrate
of ``common`` that DIN shares."""
