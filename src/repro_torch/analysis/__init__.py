"""Dry-run analysis: the roofline arithmetic, the report's tables and a
count of a step's FLOPs, bytes and peak memory on fake tensors.
Counterpart of ``repro/analysis``."""
