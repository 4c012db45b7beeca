"""Logical-axis sharding of the port: meshes, rules and plans."""
