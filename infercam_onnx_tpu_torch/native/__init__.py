"""Host native code of the port: the libjpeg shim (``native/jpeg.py``)."""
