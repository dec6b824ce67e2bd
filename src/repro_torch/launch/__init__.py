"""Launchers: the serving entry point.  Counterpart of ``repro/launch``;
the training launcher and the dry-runs wait for their slices (ROADMAP.md
§1 items 7.5 and 7.6)."""
