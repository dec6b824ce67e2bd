"""Launchers: the serving and training entry points and the train step.
Counterpart of ``repro/launch``; the dry-runs wait for their slice
(ROADMAP.md §1 item 6) and the mesh for multi-card meshes (item 7)."""
