"""Training step factory of the port (one device)."""
