"""Chunked streaming execution."""
