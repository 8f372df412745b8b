"""Launchers of the port: serving (``serve``) and training (``train``), and
the device meshes they can run over (``mesh``)."""
