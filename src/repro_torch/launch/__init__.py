"""Launchers of the port: serving (``serve``) and training (``train``), the
device meshes they can run over (``mesh``) and every model input as
``meta`` tensors (``specs``)."""
