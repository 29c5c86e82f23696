"""Parallelism of the port: the device mesh (``mesh.py``) and ring attention
over its ``sp`` axis (``ring.py``)."""
