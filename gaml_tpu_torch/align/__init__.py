"""Aligner with the port's device backend."""
