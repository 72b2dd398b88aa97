"""Launchers of the port: the batched serving loop."""
