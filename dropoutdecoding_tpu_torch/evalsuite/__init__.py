"""Self-contained evaluation suite of the port: a copy of
``dropoutdecoding_tpu/evalsuite`` (COCO index, CHAIR, THRONE, the caption
metrics), held against the original function by function by
``tests/test_torch_evalsuite.py``."""
