"""Sharding rules and meshes (``parallel/sharding.py``) and pipeline
stages over a "stage" mesh axis (``parallel/pipeline.py``)."""
