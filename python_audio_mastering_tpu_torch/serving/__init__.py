"""Serving layer of the port: the blob stores of the cloud engine."""
