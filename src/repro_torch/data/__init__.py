"""Deterministic, stateless data pipeline (a copy of ``repro.data``)."""
