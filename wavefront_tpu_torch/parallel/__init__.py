"""Pixel-range frames over several devices."""
