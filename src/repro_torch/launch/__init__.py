"""Launchers of the port: the batched serving loop (`serve`), the zoo's
training loop (`train`), the host and production meshes (`mesh`), the step
builders (`steps`) and the multi-pod dry run (`dryrun`)."""
