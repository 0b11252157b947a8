"""The plain reference that decides a run's ``correct``.

Plain PyTorch and NumPy, frozen: it imports nothing of the renderer and
reads the configuration's raw files (the asset, the scene) itself.
"""
