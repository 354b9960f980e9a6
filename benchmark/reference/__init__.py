"""The benchmark's plain reference (``model.py``)."""
