"""The benchmark's general machinery (see `benchmark/__init__.py`)."""
