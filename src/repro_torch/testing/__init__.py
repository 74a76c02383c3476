"""Test-support utilities shipped with the library (fault injection)."""

from repro_torch.testing.faults import FaultPlan, InjectedFault

__all__ = ["FaultPlan", "InjectedFault"]
