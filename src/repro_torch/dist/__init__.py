"""Single-device counterparts of ``repro.dist`` (the mesh waits for
multi-GPU)."""
