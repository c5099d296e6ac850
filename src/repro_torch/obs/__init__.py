"""Observability helpers of the port (only ``timers.percentile`` so far)."""
