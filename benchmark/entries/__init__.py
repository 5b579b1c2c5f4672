"""Entries a cell's window can drive, one module each, found by name."""
