"""The application driver and its live viewer."""
