"""Launchers: the serving and training entry points, the train step, the
dry runs (``dryrun``, ``dryrun_spmv``) and the mesh.  Counterpart of
``repro/launch``; meshes over distinct cards wait for ROADMAP.md §1
item 7."""
