"""Test utilities of the port: the serving plane's fault injector
(``faults.py``), counterpart of ``gofr_tpu/testutil``."""

from __future__ import annotations

from .faults import FAULT_POINTS, FaultInjector, InjectedFault, fault_snapshot

__all__ = ["FAULT_POINTS", "FaultInjector", "InjectedFault", "fault_snapshot"]
