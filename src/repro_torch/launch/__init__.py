"""Launchers of the port: the batched serving loop (`serve`), the zoo's
training loop (`train`) and the host mesh (`mesh`)."""
