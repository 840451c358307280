"""Mesh arrays by kind, built here in numpy from a frozen copy of the
port's recipe; ``fembench/meshes/<kind>.py`` has ``arrays(mesh_cfg)``.
Both the port and the plain reference are given these arrays."""
