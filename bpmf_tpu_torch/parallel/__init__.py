"""The multi-device layer: the mesh of ranks (mesh), starting them (launch),
item layouts (partition) and half-sweeps (spmd)."""
