"""Subpackage: ingest."""
