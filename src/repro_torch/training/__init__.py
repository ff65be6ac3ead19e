"""Training step factory of the port (one device, or sharded over a mesh of
rank processes)."""
