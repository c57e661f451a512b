"""Multi-device develops: a ('batch', 'spatial') mesh of devices, run as one
process with one thread per mesh position (``mesh.py``, ``shard.py``)."""
