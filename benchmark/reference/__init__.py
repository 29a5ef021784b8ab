"""The plain reference that decides `correct`.

Plain NumPy and PyTorch only: nothing here imports the program
(`wavefront_tpu_torch`), the JAX package or JAX.  From the raw inputs (the
block assets under `assets/` and a configuration's sizes) it works out
again what the program derives from them: the terrain (`world.py`), the
light set and its BVH (`lights.py`), the entity triangles and the camera
basis (`world.py`), and renders the sampled pixels of a frame with a
vectorized float64 path tracer (`render.py`) that follows the upstream
renderer's radiometric model draw for draw.
"""
