"""Notebook exploration widgets, built from the port only."""
