"""Workload generators (numpy, placed on a torch device)."""
