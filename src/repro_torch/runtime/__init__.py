"""Runtime: ``fault_tolerance`` (step watchdog, retries, straggler stats)."""
