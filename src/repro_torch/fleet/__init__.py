"""``repro_torch.fleet`` — the port of ``repro.fleet``.

Only :mod:`~repro_torch.fleet.records` so far (the failure records the
serving layer shares with the fleet); the controller, worker and fault
injector are ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

from repro_torch.fleet import records

__all__ = ["records"]
