"""Launchers: the serving and training entry points, the train step, the
dry runs (``dryrun``, ``dryrun_spmv``) and the mesh.  Counterpart of
``repro/launch``.  ``Server(mesh=)`` and ``TrainLoop(mesh=)`` run on a
process mesh, every arch as on one device (neither runs the
encoder-decoder, whose step builders serve and train it there too);
started by ``torchrun``, the ``main`` entry points run on
``mesh.make_local_mesh(world=)``."""
