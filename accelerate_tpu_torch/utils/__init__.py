"""Helpers of the port: devices (``device.py``), parameter trees (``tree.py``),
batch placement (``transfer.py``), seeding (``random.py``) and the
mixed-precision names (``dataclasses.py``)."""
