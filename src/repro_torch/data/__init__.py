"""Workload generators (numpy, placed on a torch device) and the LM
training data pipeline (``pipeline.py``)."""
