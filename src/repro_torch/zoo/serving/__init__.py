"""Serving steps of the zoo port: prefill and decode."""
