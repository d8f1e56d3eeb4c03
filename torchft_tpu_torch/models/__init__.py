"""Models of the port: the Llama-3 family (``models/llama.py``)."""
