"""Mesh and runtime of the distributed layer (port of ``easydgl_tpu.core``).
"""
