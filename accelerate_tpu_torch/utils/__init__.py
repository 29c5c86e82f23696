"""Device helpers of the port (``device.py``)."""
