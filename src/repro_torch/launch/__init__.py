"""Launchers: the serving and training entry points, the train step, the
dry runs (``dryrun``, ``dryrun_spmv``) and the mesh.  Counterpart of
``repro/launch``.  ``Server(mesh=)`` and ``TrainLoop(mesh=)`` run on a
process mesh; the ``main`` entry points and the recurrent and
encoder-decoder kinds on a mesh wait for ROADMAP.md §1 item 7."""
