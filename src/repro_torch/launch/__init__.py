"""Launchers of the port: serving (``serve``) and training (``train``), the
device meshes they can run over (``mesh``), every model input as ``meta``
tensors (``specs``), and the dry run that counts one step of any (arch x
shape x production mesh) on a fake process group (``dryrun``, fanned out
over subprocesses by ``sweep``)."""
