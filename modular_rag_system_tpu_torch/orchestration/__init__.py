"""Subpackage: orchestration."""
