"""The plain reference that decides `correct`: plain PyTorch and NumPy, a
frozen copy of the port's plain encode paths and its Python CABAC
serializer, importing nothing of the port (`wavefront2.py` for the
wavefront2 configurations, `wavefront_v1.py` for the v1 ones)."""
