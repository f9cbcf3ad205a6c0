"""Fault types the serving engine recognises (the error class of
repro/serving/faults.py; the seeded FaultSchedule chaos layer itself waits
for a later slice)."""

from __future__ import annotations


class KernelFaultError(RuntimeError):
    """A kernel dispatch failure raised by a fault hook, tagged with the
    registry key the engine should quarantine.  Real CUDA errors are not
    KernelFaultErrors and are never caught by the engine."""

    def __init__(self, key: str, message: str = "injected kernel fault"):
        super().__init__(f"{message}: {key}")
        self.key = key
